"""LiteFlowNet's convolution epilogue: the bias add and leaky ReLU after a
convolution (kernel B18), ``csrc/conv_epilogue.cu``.

B18 is the counterpart of what Flax's ``nn.Conv(dtype=bfloat16)`` puts
after its convolution in transflow_tpu/flow/estimators/liteflownet.py:60
``_conv``, and of :47 ``_leaky`` after it: jnp code there, with no Pallas
source. As ``ops/lfn_heads.py`` has, three functions: ``*_plain``, the
plain PyTorch version; ``*_cuda``, which launches the hand-written kernel
and counts its launches; and the dispatcher, which sends CPU tensors to
the first and CUDA tensors to the second, with no fallback between them.

``conv_epilogue(y, bias, leaky)``: ``y`` is the (N, C, H, W) output of
``F.conv2d`` in bfloat16 or float32, channels_last or contiguous NCHW
(the two layouts the convolutions return), ``bias`` the (C,) float32
parameter. In y's dtype it computes ``out = round(y + round(bias))``, the
sum in float32, then with ``leaky`` ``out >= 0 ? out : round(out *
round(0.1))`` (``leaky_relu``); the result is (N, H, W, C) contiguous. The
kernel writes a channels_last ``y`` in place.

``leaky_relu(x)`` is JAX's ``nn.leaky_relu(x, 0.1)``: JAX multiplies by
the weak-typed slope converted to x's dtype, 0.10009765625 in bfloat16,
where ``F.leaky_relu(x, 0.1)`` multiplies by ``0.1f`` and differs by one
bfloat16 ulp in about a tenth of the negative values.
"""
import functools

import torch
import torch.nn.functional as F

from .._device import DTYPE_CODES, cuda_stream, dispatch, launch

CHANNELS_LAST, NCHW = "channels_last", "nchw"
# the bias table of the kernel's shared memory
MAX_CHANNELS = 1024


@functools.cache
def leaky_slope(dtype: torch.dtype) -> float:
    """0.1 rounded to ``dtype``, as JAX converts its weak-typed slope."""
    return torch.tensor(0.1, dtype=dtype).item()


def leaky_relu(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """JAX's ``nn.leaky_relu(x, 0.1)``: ``x >= 0 ? x : round(x * slope)``
    with the slope rounded to x's dtype (``leaky_slope``). torch's
    ``x > 0`` test gives the same result: ``-0.0 * slope`` is -0.0."""
    return F.leaky_relu(x, leaky_slope(x.dtype), inplace=inplace)


def layout(y: torch.Tensor, bias: torch.Tensor, name: str) -> str:
    """``y``'s layout, ``CHANNELS_LAST`` or ``NCHW``; raise unless ``y`` is
    a non-empty (N, C, H, W) float32 or bfloat16 tensor in one of them and
    ``bias`` holds its C float32 values."""
    if y.dim() != 4 or y.numel() == 0 or y.dtype not in DTYPE_CODES:
        raise ValueError(f"{name} needs a non-empty (N, C, H, W) float32 or "
                         f"bfloat16 tensor, got {tuple(y.shape)} {y.dtype}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (y.shape[1],):
        raise ValueError(f"{name} needs a float32 bias of {y.shape[1]} "
                         f"values, got {tuple(bias.shape)} {bias.dtype}")
    if y.permute(0, 2, 3, 1).is_contiguous():
        return CHANNELS_LAST
    if y.is_contiguous():
        return NCHW
    raise ValueError(f"{name} needs a channels_last or contiguous NCHW "
                     f"tensor, got strides {y.stride()}")


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        leaky: bool) -> torch.Tensor:
    """Plain version: the bias rounded to y's dtype, added in y's dtype
    (torch adds in float32 and rounds once, as XLA does), then
    ``leaky_relu``; a new (N, H, W, C) contiguous tensor."""
    layout(y, bias, "conv_epilogue_plain")
    out = (y.permute(0, 2, 3, 1) + bias.to(y.dtype)).contiguous()
    return leaky_relu(out, inplace=True) if leaky else out


def conv_epilogue_cuda(y: torch.Tensor, bias: torch.Tensor,
                       leaky: bool) -> torch.Tensor:
    """Launch B18 on ``y`` (written in place where it is channels_last)
    and its float32 bias, read in place, on one CUDA device; returns the
    (N, H, W, C) contiguous result. ``conv_epilogue_cuda.launches`` counts
    launches."""
    kind = layout(y, bias, "conv_epilogue_cuda")
    if not (y.is_cuda and bias.device == y.device):
        raise ValueError("conv_epilogue_cuda needs tensors on one CUDA "
                         f"device, got {y.device} and {bias.device}")
    if not bias.is_contiguous() or y.shape[1] > MAX_CHANNELS:
        raise ValueError("conv_epilogue_cuda needs a contiguous bias of at "
                         f"most {MAX_CHANNELS} channels")
    n, c, h, w = y.shape
    out = (y.permute(0, 2, 3, 1) if kind == CHANNELS_LAST else
           torch.empty((n, h, w, c), dtype=y.dtype, device=y.device))
    launch(y.device, "transflow_conv_epilogue", y.data_ptr(),
           DTYPE_CODES[y.dtype], bias.data_ptr(), out.data_ptr(), n, h * w,
           c, int(kind == NCHW), int(leaky), cuda_stream(y))
    conv_epilogue_cuda.launches += 1
    return out


conv_epilogue_cuda.launches = 0


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor,
                  leaky: bool) -> torch.Tensor:
    """Dispatcher: CPU tensors take the plain version, CUDA tensors the
    kernel; there is no fallback between the two."""
    return dispatch("conv_epilogue", conv_epilogue_plain, conv_epilogue_cuda,
                    y, bias)(y, bias, leaky)

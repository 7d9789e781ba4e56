"""Cost-volume correlation (FlowNet-style 7x7 window).

Counterpart of transflow_tpu/ops/correlation.py and
transflow_tpu/ops/pallas_correlation.py. ``correlation7x7`` is the plain
PyTorch version; ``correlation7x7_cuda`` launches the hand-written kernel in
``csrc/correlation.cu``; ``correlation`` picks one by the tensors' device.
All three keep the JAX layout: (H, W, C) x (H, W, C) -> (ceil(H/s),
ceil(W/s), 49) float32.
"""
import torch
import torch.nn.functional as F

from .._device import DTYPE_CODES, cuda_stream, kernel_library

WINDOW = 7
MAX_DISP = 3


def _stage_dtype(x: torch.Tensor) -> torch.Tensor:
    """Each operand is read in its own dtype: bf16 stays bf16, anything
    else is read as f32 (pallas_correlation.py::_stage_dtype). The math is
    f32 either way."""
    return x if x.dtype in (torch.bfloat16, torch.float32) else x.float()


def correlation7x7(f1: torch.Tensor, f2: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """Plain version: 49 shifted products with a channel mean.

    out[y, x, (dy+3)*7+(dx+3)] =
        mean_c f1[y*s, x*s, c] * f2[y*s + dy*s, x*s + dx*s, c]
    with zero padding outside the frame, computed in f32."""
    h, w, _ = f1.shape
    pad = MAX_DISP * stride
    f1s = _stage_dtype(f1)[::stride, ::stride].float()
    f2p = F.pad(_stage_dtype(f2).float(), (0, 0, pad, pad, pad, pad))
    outs = []
    for dy in range(-MAX_DISP, MAX_DISP + 1):
        for dx in range(-MAX_DISP, MAX_DISP + 1):
            y0, x0 = pad + dy * stride, pad + dx * stride
            shifted = f2p[y0:y0 + h:stride, x0:x0 + w:stride]
            outs.append((f1s * shifted).mean(dim=-1))
    return torch.stack(outs, dim=-1)


def correlation7x7_cuda(f1: torch.Tensor, f2: torch.Tensor,
                        stride: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel on (H, W, C) CUDA tensors, contiguous, each
    float32 or bfloat16. ``correlation7x7_cuda.launches`` counts launches."""
    if not (f1.is_cuda and f2.is_cuda) or f1.device != f2.device:
        raise ValueError("correlation7x7_cuda needs both operands on one "
                         f"CUDA device, got {f1.device} and {f2.device}")
    if f1.dim() != 3 or f1.shape != f2.shape:
        raise ValueError("correlation7x7_cuda needs two (H, W, C) tensors "
                         f"of one shape, got {tuple(f1.shape)} and "
                         f"{tuple(f2.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    f1, f2 = _stage_dtype(f1), _stage_dtype(f2)
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation7x7_cuda needs contiguous (H, W, C) "
                         "operands")
    h, w, c = f1.shape
    out = torch.empty((-(-h // stride), -(-w // stride), WINDOW * WINDOW),
                      dtype=torch.float32, device=f1.device)
    with torch.cuda.device(f1.device):
        kernel_library().call(
            "transflow_corr7x7", f1.data_ptr(), DTYPE_CODES[f1.dtype],
            f2.data_ptr(), DTYPE_CODES[f2.dtype], out.data_ptr(), h, w, c,
            stride, cuda_stream(f1))
    correlation7x7_cuda.launches += 1
    return out


correlation7x7_cuda.launches = 0


def check_kernel(kernel: str | None) -> None:
    """Refuse every correlation override but None (the device dispatch)."""
    if kernel == "pallas_halo":
        raise NotImplementedError(
            "corr_kernel='pallas_halo' (sharded correlation) is not ported "
            "yet: ROADMAP Queue 1, item 12 (multi-GPU)")
    if kernel is not None:
        raise ValueError(f"correlation kernel must be None, got {kernel!r}")


def correlation(f1: torch.Tensor, f2: torch.Tensor, stride: int = 1,
                kernel: str | None = None) -> torch.Tensor:
    """Dispatcher: CPU tensors take the plain version, CUDA tensors the
    kernel; there is no fallback between the two.

    ``kernel``: only None is ported. 'pallas_halo' (the H-sharded kernel
    with a halo exchange) waits for the multi-GPU work (ROADMAP Queue 1,
    item 12)."""
    check_kernel(kernel)
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation7x7(f1, f2, stride)
    if f1.is_cuda:
        return correlation7x7_cuda(f1, f2, stride)
    raise ValueError(f"correlation has no path for device {f1.device}")

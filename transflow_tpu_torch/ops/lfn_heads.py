"""LiteFlowNet's two head loops: the phase upsampler (kernel B16) and the
regularization's softmax tap apply (kernel B17), ``csrc/lfn_heads.cu``.

B16 is the counterpart of transflow_tpu/flow/estimators/liteflownet.py:220
``_upsample2x_phases``; B17 of the same file's ``Regularization`` from the
distance convolution on (:420-448, the fused apply). Both are jnp code
there, with no Pallas source. Each kernel has three functions, as
``ops/warp.py``'s have: ``*_plain``, the plain PyTorch version;
``*_cuda``, which launches the hand-written kernel and counts its
launches; and the dispatcher, which sends CPU tensors to the first and
CUDA tensors to the second, with no fallback between them. The two agree
bit for bit: the plain versions round each product and sum in the
kernels' order.

``upsample2x_phases(x, weight)``: torch's ``ConvTranspose2d(k=4, s=2,
p=1, groups=C, bias=False)`` on an (h, w, C) float32 or bfloat16 tensor
with (C, 1, 4, 4) float32 taps, as the JAX function's exact phase
decomposition; (2h, 2w, C) out in x's dtype.

``reg_apply(dist, flow, wx, bx, wy, by)``: the softmax over the S*S taps
of the (H, W, S*S) distances (float32 or bfloat16), then the tap-by-tap
multiply-accumulate of the (H, W, 2) flow's S x S neighbourhood (zero
outside the frame) with the scale convolutions' taps ``wx``, ``wy`` (S*S
float32 values each, any shape) and biases ``bx``, ``by`` (one float32
each), divided by the softmax's sum; (H, W, 2) float32 out.
"""
import math

import torch
import torch.nn.functional as F

from .._device import DTYPE_CODES, check_cuda, cuda_stream, dispatch, launch

# the tap windows the regularization has (S = 3, 5, 7)
REG_SIZES = (3, 5, 7)


def upsample2x_phases_plain(x: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """Plain version: each output parity phase (r, s) is four
    shift-multiply-accumulates of the half-res plane, summed in f32 in the
    JAX order; reads and output keep x's dtype (bf16 or f32)."""
    h, w, c = x.shape
    out_dtype = x.dtype if x.dtype in (torch.bfloat16, torch.float32) \
        else torch.float32
    x = x.to(out_dtype)
    # (4, 4, C) taps, flipped: the transposed conv as a correlation
    rhs = weight[:, 0].permute(1, 2, 0).flip(0, 1).float()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    rows = []
    for r in (0, 1):
        cols = []
        for s in (0, 1):
            acc = None
            for ki, di in ((r, r - 1), (r + 2, r)):
                for kj, dj in ((s, s - 1), (s + 2, s)):
                    term = rhs[ki, kj] * xp[di + 1:di + 1 + h,
                                            dj + 1:dj + 1 + w]
                    acc = term if acc is None else acc + term
            cols.append(acc)
        rows.append(torch.stack(cols, dim=2))      # (h, w, 2s, c)
    out = torch.stack(rows, dim=1)                 # (h, 2r, w, 2s, c)
    return out.reshape(2 * h, 2 * w, c).to(out_dtype)


def upsample2x_phases_cuda(x: torch.Tensor,
                           weight: torch.Tensor) -> torch.Tensor:
    """Launch B16 on a contiguous (h, w, C) float32 or bfloat16 tensor and
    its contiguous (C, 1, 4, 4) float32 taps, read in place, on one CUDA
    device. ``upsample2x_phases_cuda.launches`` counts launches."""
    if x.dim() != 3 or x.numel() == 0 or \
            tuple(weight.shape) != (x.shape[2], 1, 4, 4):
        raise ValueError("upsample2x_phases_cuda needs a non-empty (h, w, C) "
                         "tensor and (C, 1, 4, 4) taps, got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if x.dtype not in DTYPE_CODES or weight.dtype != torch.float32:
        raise ValueError("upsample2x_phases_cuda needs a float32 or bfloat16 "
                         f"tensor and float32 taps, got {x.dtype} and "
                         f"{weight.dtype}")
    check_cuda("upsample2x_phases_cuda", x, weight)
    h, w, c = x.shape
    out = torch.empty((2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    launch(x.device, "transflow_upsample2x_phases", x.data_ptr(),
           DTYPE_CODES[x.dtype], weight.data_ptr(), out.data_ptr(), h, w, c,
           cuda_stream(x))
    upsample2x_phases_cuda.launches += 1
    return out


upsample2x_phases_cuda.launches = 0


def upsample2x_phases(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Dispatcher: CPU tensors take the plain version, CUDA tensors the
    kernel; there is no fallback between the two."""
    return dispatch("upsample2x_phases", upsample2x_phases_plain,
                    upsample2x_phases_cuda, x, weight)(x, weight)


def reg_apply_plain(dist: torch.Tensor, flow: torch.Tensor,
                    wx: torch.Tensor, bx: torch.Tensor, wy: torch.Tensor,
                    by: torch.Tensor) -> torch.Tensor:
    """Plain version: the JAX module's ops in its order, but the softmax's
    sum taken tap by tap in ascending order (``sum(dim=-1)`` leaves the
    order to the backend)."""
    taps = dist.shape[-1]
    size = math.isqrt(taps)
    h, w = flow.shape[0], flow.shape[1]
    dist = -torch.square(dist.float())
    dist = torch.exp(dist - dist.amax(dim=-1, keepdim=True))
    total = dist[..., 0]
    for k in range(1, taps):
        total = total + dist[..., k]
    divisor = (1.0 / total)[..., None]
    wx, wy = wx.reshape(-1), wy.reshape(-1)
    bx, by = bx.reshape(()), by.reshape(())
    pad = (size - 1) // 2
    px = F.pad(flow[..., 0], (pad, pad, pad, pad))
    py = F.pad(flow[..., 1], (pad, pad, pad, pad))
    acc_x = torch.zeros((h, w), dtype=torch.float32, device=flow.device)
    acc_y = torch.zeros_like(acc_x)
    k = 0
    for dy in range(size):
        for dx in range(size):
            d = dist[..., k]
            acc_x = acc_x + (wx[k] * d) * px[dy:dy + h, dx:dx + w]
            acc_y = acc_y + (wy[k] * d) * py[dy:dy + h, dx:dx + w]
            k += 1
    scale_x = (acc_x + bx)[..., None]
    scale_y = (acc_y + by)[..., None]
    return torch.cat([scale_x * divisor, scale_y * divisor], dim=-1)


def reg_apply_cuda(dist: torch.Tensor, flow: torch.Tensor, wx: torch.Tensor,
                   bx: torch.Tensor, wy: torch.Tensor,
                   by: torch.Tensor) -> torch.Tensor:
    """Launch B17 on contiguous (H, W, S*S) distances and an (H, W, 2)
    flow, each float32 or bfloat16, with S in ``REG_SIZES``, and the
    contiguous float32 taps (S*S values each) and biases (one value each),
    read in place, all on one CUDA device.
    ``reg_apply_cuda.launches`` counts launches."""
    taps = dist.shape[-1] if dist.dim() == 3 else 0
    size = math.isqrt(taps)
    if dist.dim() != 3 or size not in REG_SIZES or size * size != taps or \
            tuple(flow.shape) != (*dist.shape[:2], 2) or dist.numel() == 0:
        raise ValueError("reg_apply_cuda needs non-empty (H, W, S*S) "
                         f"distances with S in {REG_SIZES} and an (H, W, 2) "
                         f"flow, got {tuple(dist.shape)} and "
                         f"{tuple(flow.shape)}")
    if dist.dtype not in DTYPE_CODES or flow.dtype not in DTYPE_CODES:
        raise ValueError("reg_apply_cuda needs float32 or bfloat16 distances "
                         f"and flow, got {dist.dtype} and {flow.dtype}")
    params = (wx, bx, wy, by)
    if any(p.dtype != torch.float32 for p in params) or \
            (wx.numel(), bx.numel(), wy.numel(), by.numel()) != \
            (taps, 1, taps, 1):
        raise ValueError(f"reg_apply_cuda needs float32 taps of {taps} "
                         "values and biases of one, got "
                         f"{[(p.dtype, p.numel()) for p in params]}")
    check_cuda("reg_apply_cuda", dist, flow, *params)
    h, w = flow.shape[:2]
    out = torch.empty((h, w, 2), dtype=torch.float32, device=dist.device)
    launch(dist.device, "transflow_reg_apply", dist.data_ptr(),
           DTYPE_CODES[dist.dtype], flow.data_ptr(), DTYPE_CODES[flow.dtype],
           wx.data_ptr(), bx.data_ptr(), wy.data_ptr(), by.data_ptr(),
           out.data_ptr(), h, w, size, cuda_stream(dist))
    reg_apply_cuda.launches += 1
    return out


reg_apply_cuda.launches = 0


def reg_apply(dist: torch.Tensor, flow: torch.Tensor, wx: torch.Tensor,
              bx: torch.Tensor, wy: torch.Tensor,
              by: torch.Tensor) -> torch.Tensor:
    """Dispatcher: CPU tensors take the plain version, CUDA tensors the
    kernel; there is no fallback between the two."""
    return dispatch("reg_apply", reg_apply_plain, reg_apply_cuda, dist, flow,
                    wx, bx, wy, by)(dist, flow, wx, bx, wy, by)

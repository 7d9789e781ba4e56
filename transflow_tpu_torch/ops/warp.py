"""Bounded-displacement bilinear backwarp (kernel A3).

Counterpart of transflow_tpu/ops/pallas_warp.py. ``bounded_backwarp_plain``
is the plain PyTorch version; ``bounded_backwarp_cuda`` launches the
hand-written kernel in ``csrc/bounded_warp.cu``; ``bounded_backwarp`` picks
one by the tensors' device. All three take an (H, W, C) image in any float
dtype and an (H, W, 2) flow in pixels (x, y), and return (H, W, C) float32.

Semantics (the JAX function's): the image is rounded to bf16 and read as
zero outside the frame; each axis's displacement floor is clamped to
``[-bound, bound]`` while its fraction is kept; weights and sums are f32,
the four taps added in the Pallas kernel's (dy, dx) order. Within the bound
this is the reference's grid_sample with per-tap 'zeros' padding, not the
clamped-anchor edge rule of the exact ``liteflownet.backwarp``.
"""
import torch

from .._device import DTYPE_CODES, cuda_stream, launch


def bounded_backwarp_plain(image: torch.Tensor, flow: torch.Tensor,
                           bound: int) -> torch.Tensor:
    """Plain version: four gathers from the zero-padded bf16 image."""
    h, w, c = image.shape
    pad = bound + 1
    img = torch.nn.functional.pad(
        image.to(torch.bfloat16).float(), (0, 0, pad, pad, pad, pad))
    flat = img.reshape(-1, c)
    wp = w + 2 * pad
    fx = flow[..., 0].float()
    fy = flow[..., 1].float()
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    wx = fx - x0f
    wy = fy - y0f
    # clamped floors, kept fractions
    x0 = x0f.clamp(-bound, bound).to(torch.int64)
    y0 = y0f.clamp(-bound, bound).to(torch.int64)
    ii = torch.arange(h, device=image.device)[:, None]
    jj = torch.arange(w, device=image.device)[None, :]
    base = (ii + y0 + pad) * wp + (jj + x0 + pad)
    weights = ((1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx)
    out = torch.zeros((h, w, c), dtype=torch.float32, device=image.device)
    for tap, weight in zip((0, 1, wp, wp + 1), weights):
        out = out + flat[base + tap] * weight[..., None]
    return out


def bounded_backwarp_cuda(image: torch.Tensor, flow: torch.Tensor,
                          bound: int) -> torch.Tensor:
    """Launch the CUDA kernel on an (H, W, C) float32 or bfloat16 image and
    an (H, W, 2) float32 flow, both contiguous on one CUDA device.
    ``bounded_backwarp_cuda.launches`` counts launches."""
    if not (image.is_cuda and flow.is_cuda) or image.device != flow.device:
        raise ValueError("bounded_backwarp_cuda needs image and flow on one "
                         f"CUDA device, got {image.device} and {flow.device}")
    if image.dim() != 3 or tuple(flow.shape) != (*image.shape[:2], 2):
        raise ValueError("bounded_backwarp_cuda needs an (H, W, C) image and "
                         f"an (H, W, 2) flow, got {tuple(image.shape)} and "
                         f"{tuple(flow.shape)}")
    if bound < 0:
        raise ValueError(f"bound must be >= 0, got {bound}")
    if image.dtype not in DTYPE_CODES:
        image = image.float()
    flow = flow.float()
    if not (image.is_contiguous() and flow.is_contiguous()):
        raise ValueError("bounded_backwarp_cuda needs contiguous image and "
                         "flow")
    h, w, c = image.shape
    out = torch.empty((h, w, c), dtype=torch.float32, device=image.device)
    launch(image.device, "transflow_bounded_backwarp", image.data_ptr(),
           DTYPE_CODES[image.dtype], flow.data_ptr(), out.data_ptr(), h, w,
           c, int(bound), cuda_stream(image))
    bounded_backwarp_cuda.launches += 1
    return out


bounded_backwarp_cuda.launches = 0


def bounded_backwarp(image: torch.Tensor, flow: torch.Tensor,
                     bound: int) -> torch.Tensor:
    """Dispatcher: CPU tensors take the plain version, CUDA tensors the
    kernel; there is no fallback between the two."""
    if image.device.type == "cpu" and flow.device.type == "cpu":
        return bounded_backwarp_plain(image, flow, bound)
    if image.is_cuda:
        return bounded_backwarp_cuda(image, flow, bound)
    raise ValueError(f"bounded_backwarp has no path for device "
                     f"{image.device}")

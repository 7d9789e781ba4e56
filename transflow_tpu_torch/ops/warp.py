"""LiteFlowNet's two bilinear backwarps: the bounded-displacement one
(kernel A3, ``csrc/bounded_warp.cu``) and the exact one (kernel B7,
``csrc/exact_backwarp.cu``).

A3 is the counterpart of transflow_tpu/ops/pallas_warp.py.
``bounded_backwarp_plain`` is the plain PyTorch version;
``bounded_backwarp_cuda`` launches the hand-written kernel;
``bounded_backwarp`` picks one by the tensors' device. All three take an
(H, W, C) image in any float dtype and an (H, W, 2) flow in pixels (x, y),
and return (H, W, C) float32.

Semantics (the JAX function's): the image is rounded to bf16 and read as
zero outside the frame; each axis's displacement floor is clamped to
``[-bound, bound]`` while its fraction is kept; weights and sums are f32,
the four taps added in the Pallas kernel's (dy, dx) order. Within the bound
this is the reference's grid_sample with per-tap 'zeros' padding, not the
clamped-anchor edge rule of the exact backwarp.

B7 is the exact path of transflow_tpu/flow/estimators/liteflownet.py:106
``backwarp`` (jnp ops, no Pallas kernel): ``exact_backwarp_plain`` (its
ops in its order), ``exact_backwarp_cuda`` and the dispatcher
``exact_backwarp``. They take an (H, W, C) float32 or bfloat16 image, read
in its own dtype, and an (H, W, 2) flow; the four taps are read at the
clamped anchor (on the low edges the +1 taps fall back to the anchor's),
the in-bounds masks come from the raw float floors, and each tap is
multiplied by its x weight, then its y weight, then its mask.
"""
import torch

from .._device import DTYPE_CODES, cuda_stream, dispatch, launch


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


def exact_backwarp_plain(image: torch.Tensor,
                         flow: torch.Tensor) -> torch.Tensor:
    """Plain version: the JAX function's ops in its order, the four taps
    fetched by one gather from the image beside its three shifts."""
    h, w, c = image.shape
    zrow = image.new_zeros((1, w, c))
    zcol = image.new_zeros((h, 1, c))
    right = torch.cat([image[:, 1:], zcol], dim=1)
    down = torch.cat([image[1:], zrow], dim=0)
    downright = torch.cat([right[1:], zrow], dim=0)
    v4 = torch.cat([image, right, down, downright], dim=-1)
    yy = torch.arange(h, dtype=torch.float32, device=image.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=image.device)[None, :]
    sx = xx + flow[..., 0]
    sy = yy + flow[..., 1]
    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    wx = (sx - x0f)[..., None]
    wy = (sy - y0f)[..., None]
    x0 = x0f.clamp(-1, w).long()
    y0 = y0f.clamp(-1, h).long()
    g = v4[y0.clamp(0, h - 1), x0.clamp(0, w - 1)]
    t00, t01, t10, t11 = g.split(c, dim=-1)
    mx = (x0 < 0)[..., None]
    my = (y0 < 0)[..., None]
    t01e = torch.where(mx, t00, t01)
    t10e = torch.where(my, t00, t10)
    t11e = torch.where(mx & my, t00,
                       torch.where(mx, t10, torch.where(my, t01, t11)))

    def inb(xi, yi):
        return (((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))
                .float()[..., None])

    return (t00 * (1 - wx) * (1 - wy) * inb(x0f, y0f)
            + t01e * wx * (1 - wy) * inb(x0f + 1, y0f)
            + t10e * (1 - wx) * wy * inb(x0f, y0f + 1)
            + t11e * wx * wy * inb(x0f + 1, y0f + 1))


def exact_backwarp_cuda(image: torch.Tensor,
                        flow: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on an (H, W, C) float32 or bfloat16 image
    whose channels are contiguous and whose pixels lie ``stride(1) >= C``
    elements apart (rows ``W`` pixels apart: the 3-channel half of a
    6-channel pair is read in place) and an (H, W, 2) float32 or bfloat16
    flow (widened exactly), on one CUDA device.
    ``exact_backwarp_cuda.launches`` counts launches."""
    if image.dim() != 3 or tuple(flow.shape) != (*image.shape[:2], 2) \
            or image.numel() == 0:
        raise ValueError("exact_backwarp_cuda needs a non-empty (H, W, C) "
                         "image and an (H, W, 2) flow, got "
                         f"{tuple(image.shape)} and {tuple(flow.shape)}")
    if image.dtype not in DTYPE_CODES or \
            flow.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("exact_backwarp_cuda needs a float32 or bfloat16 "
                         f"image and flow, got {image.dtype} and "
                         f"{flow.dtype}")
    h, w, c = image.shape
    pixel_stride = image.stride(1)
    if image.stride(2) != 1 or pixel_stride < c or \
            image.stride(0) != pixel_stride * w:
        raise ValueError("exact_backwarp_cuda needs contiguous channels and "
                         "rows of W pixels, got strides "
                         f"{image.stride()} for {tuple(image.shape)}")
    if not (image.is_cuda and flow.is_cuda) or image.device != flow.device:
        raise ValueError("exact_backwarp_cuda needs image and flow on one "
                         f"CUDA device, got {image.device} and {flow.device}")
    flow = flow.float().contiguous()
    out = torch.empty((h, w, c), dtype=torch.float32, device=image.device)
    launch(image.device, "transflow_exact_backwarp", image.data_ptr(),
           DTYPE_CODES[image.dtype], pixel_stride, flow.data_ptr(),
           out.data_ptr(), h, w, c, cuda_stream(image))
    exact_backwarp_cuda.launches += 1
    return out


exact_backwarp_cuda.launches = 0


def exact_backwarp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Dispatcher: CPU tensors take the plain version, CUDA tensors the
    kernel; there is no fallback between the two."""
    return dispatch("exact_backwarp", exact_backwarp_plain,
                    exact_backwarp_cuda, image, flow)(image, flow)

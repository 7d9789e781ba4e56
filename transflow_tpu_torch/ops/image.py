"""Device-side image primitives the ported slice uses: bilinear resize with
torch's own semantics, and the integer-factor flow upscale.

Counterpart of transflow_tpu/ops/image.py (``torch_bilinear_resize``,
``upscale_flow``); the rest of that module waits for the Farneback slice.
"""
import torch
import torch.nn.functional as F


def torch_bilinear_resize(image: torch.Tensor, new_h: int,
                          new_w: int) -> torch.Tensor:
    """Bilinear resize of an (H, W) or (H, W, C) image, computed in f32.

    ``F.interpolate(mode='bilinear', align_corners=False, antialias=False)``
    is exactly what the JAX function of this name emulates: four neighbours
    at half-pixel centres, edges clamped, no anti-aliasing on downscale."""
    squeeze = image.dim() == 2
    if squeeze:
        image = image[..., None]
    image = image.float()
    if (new_h, new_w) == tuple(image.shape[:2]):
        out = image
    else:
        out = F.interpolate(image.permute(2, 0, 1)[None], size=(new_h, new_w),
                            mode="bilinear", align_corners=False,
                            antialias=False)[0].permute(1, 2, 0).contiguous()
    return out[..., 0] if squeeze else out


def upscale_flow(flow: torch.Tensor, width_factor: int,
                 height_factor: int) -> torch.Tensor:
    """Integer-factor kron upscale that also scales vector magnitudes.

    Parity reference: transflow/utils.py:417-418 (upscale_array)."""
    scaled = flow * torch.tensor([width_factor, height_factor],
                                 dtype=flow.dtype, device=flow.device)
    out = scaled.repeat_interleave(height_factor, dim=0)
    return out.repeat_interleave(width_factor, dim=1)

"""Bounded-displacement bilinear sampling, one axis at a time.

Counterpart of transflow_tpu/ops/select_warp.py: the same semantics, not
its shift-select form (a TPU workaround for gathers). Here each axis pass is
one ``torch.gather`` of the two taps. For one axis of ``n`` samples and a
displacement ``d``:

- ``d`` is clipped to ``[-r, r]`` with ``r = min(radius, n - 1)``;
- the anchor ``floor(i + d)`` is clamped to ``[0, n - 1]``, the weight is
  the fraction of the unclamped position;
- the +1 tap is clamped to the edge.

The 2-D warp runs rows first, then columns on the row-warped
intermediate: the column taps ``j0`` and ``j0 + 1`` of output ``(i, j)``
each carry the row warp made with ``dy[i, j0]`` and ``dy[i, j0 + 1]``, not
``dy[i, j]``.
"""
import torch

__all__ = ["shift_select_warp", "axis_warp"]


def axis_warp(p: torch.Tensor, disp: torch.Tensor, radius: int,
              axis: int) -> torch.Tensor:
    """Bilinear warp of ``p`` (H, W, C) by ``disp`` (H, W) along ``axis``
    (0 rows, 1 columns); returns float32."""
    n = p.shape[axis]
    r = min(radius, n - 1)
    base = torch.arange(n, device=p.device, dtype=torch.float32)
    base = base[:, None] if axis == 0 else base[None, :]
    s = base + disp.clamp(-r, r)
    s0f = torch.floor(s)
    w = (s - s0f)[..., None]
    s0 = s0f.long().clamp(0, n - 1)
    s1 = (s0 + 1).clamp(max=n - 1)
    sel0 = torch.gather(p, axis, s0[..., None].expand(p.shape))
    sel1 = torch.gather(p, axis, s1[..., None].expand(p.shape))
    return sel0 * (1 - w) + sel1 * w


def shift_select_warp(image: torch.Tensor, dy: torch.Tensor,
                      dx: torch.Tensor, radius: int) -> torch.Tensor:
    """Sample ``image`` (H, W, C) at ``(i + dy, j + dx)`` with each
    displacement clamped to the radius: rows first, then columns."""
    rows = axis_warp(image, dy, radius, axis=0)
    return axis_warp(rows, dx, radius, axis=1)

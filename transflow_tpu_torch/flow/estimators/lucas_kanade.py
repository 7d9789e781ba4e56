"""Dense pyramidal Lucas-Kanade optical flow in PyTorch.

Counterpart of transflow_tpu/flow/estimators/lucas_kanade.py (transflow's
flow/methods/lukas_kanade.py tracks every ``step``-th pixel with
cv2.calcOpticalFlowPyrLK; the JAX package solves the windowed 2x2 system
densely at every pixel, then subsamples and repeats to macroblocks):

1. a pyramid of ``downsample2x`` levels (kernel B14,
   ``ops/pyramid.py``: one launch a level for both images), which stops
   once a level's short side is below twice the window;
2. per level, coarsest first: the flow resized up (``bilinear_resize``,
   times 2), Scharr derivatives of the first image, the structure tensor
   (kernel B12 in its tensor mode), then ``iters`` updates, each the warp
   and products (kernel B11, ``lk_warp_products``) and the window sums
   and solve (kernel B12, ``lk_window_solve``);
3. with ``step`` > 1, every ``step``-th flow vector repeated over its
   ``step`` x ``step`` block.

The derivatives and the flow's resize stay PyTorch (``F.conv2d`` with
TF32 off, ``F.interpolate``), as the JAX package leaves them to XLA
outside any kernel. On a CPU tensor every step runs the plain versions; on
a CUDA tensor the three kernels run.
"""
import numpy as np
import torch

from ...ops.image import bilinear_resize, separable_correlate
from ...ops.lucas_kanade import (lk_structure_tensor, lk_warp_products,
                                 lk_window_solve)
from ...ops.pyramid import downsample2x

__all__ = ["lucas_kanade"]

# cv2's Scharr derivative over 32 and its smoothing, the JAX module's taps
SCHARR = np.asarray([-3.0, 0.0, 3.0], np.float32) / 32.0
SCHARR_SMOOTH = np.asarray([3.0, 10.0, 3.0], np.float32)
EPS = 0.01


def _scharr(image: torch.Tensor, axis: int) -> torch.Tensor:
    d = separable_correlate(image, SCHARR, axis=axis)
    return separable_correlate(d, SCHARR_SMOOTH, axis=1 - axis)


def _lk_level(prev: torch.Tensor, nxt: torch.Tensor, flow: torch.Tensor,
              win_size: int, iters: int) -> torch.Tensor:
    ix = _scharr(prev, axis=1)
    iy = _scharr(prev, axis=0)
    tensor = lk_structure_tensor(ix, iy, win_size)
    for _ in range(iters):
        planes = lk_warp_products(prev, nxt, ix, iy, flow)
        flow = lk_window_solve(planes, tensor, flow, win_size, EPS)
    return flow


def lucas_kanade(prev_gray, next_gray, *, win_size: int = 15,
                 max_level: int = 2, step: int = 1,
                 iters: int = 10) -> torch.Tensor:
    """Estimate the (H, W, 2) float32 flow between two (H, W) uint8
    grayscale frames, on their device."""
    prev_gray = torch.as_tensor(prev_gray)
    next_gray = torch.as_tensor(next_gray, device=prev_gray.device)
    h, w = prev_gray.shape
    pyr_prev = [prev_gray.float().contiguous()]
    pyr_next = [next_gray.float().contiguous()]
    for _ in range(max_level):
        if min(pyr_prev[-1].shape) < 2 * win_size:
            break
        prev, nxt = downsample2x((pyr_prev[-1], pyr_next[-1]))
        pyr_prev.append(prev)
        pyr_next.append(nxt)
    flow = torch.zeros((*pyr_prev[-1].shape, 2), dtype=torch.float32,
                       device=prev_gray.device)
    for level in range(len(pyr_prev) - 1, -1, -1):
        lh, lw = pyr_prev[level].shape
        if tuple(flow.shape[:2]) != (lh, lw):
            flow = 2.0 * bilinear_resize(flow, lh, lw)
        flow = _lk_level(pyr_prev[level], pyr_next[level], flow, win_size,
                         iters)
    if step > 1:
        sampled = flow[::step, ::step]
        sh, sw = sampled.shape[:2]
        # each sample over its step x step block (a view, then one copy)
        flow = sampled[:, None, :, None].expand(sh, step, sw, step, 2)
        flow = flow.reshape(sh * step, sw * step, 2)[:h, :w]
    return flow

"""Dense pyramidal Lucas-Kanade optical flow in PyTorch.

Counterpart of transflow_tpu/flow/estimators/lucas_kanade.py (transflow's
flow/methods/lukas_kanade.py tracks every ``step``-th pixel with
cv2.calcOpticalFlowPyrLK; the JAX package solves the windowed 2x2 system
densely at every pixel, then subsamples and repeats to macroblocks):

1. the pyramid (kernel B14, ``ops/pyramid.py::lk_pyramid``): both uint8
   frames cast to float32, then ``downsample2x`` levels until a level's
   short side is below twice the window, every level of both frames in
   one launch (one more for each two levels beyond the second);
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
from ...ops.pyramid import lk_pyramid

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
    pyramid = lk_pyramid(prev_gray.contiguous(), next_gray.contiguous(),
                         win_size, max_level)
    flow = torch.zeros((*pyramid[-1][0].shape, 2), dtype=torch.float32,
                       device=prev_gray.device)
    for level in range(len(pyramid) - 1, -1, -1):
        prev, nxt = pyramid[level]
        lh, lw = prev.shape
        if tuple(flow.shape[:2]) != (lh, lw):
            flow = 2.0 * bilinear_resize(flow, lh, lw)
        flow = _lk_level(prev, nxt, flow, win_size, iters)
    if step > 1:
        sampled = flow[::step, ::step]
        sh, sw = sampled.shape[:2]
        # each sample over its step x step block (a view, then one copy)
        flow = sampled[:, None, :, None].expand(sh, step, sw, step, 2)
        flow = flow.reshape(sh * step, sw * step, 2)[:h, :w]
    return flow

"""Farneback dense optical flow (polynomial expansion) in PyTorch.

Counterpart of transflow_tpu/flow/estimators/farneback.py, the default
estimator (transflow's cv2.calcOpticalFlowFarneback with the fb_* hyper-
parameters):

1. per level, the quadratic polynomial expansion of both images (kernel
   B1, ``ops/farneback.py::poly_expansion_pair``: one launch per level);
2. ``iterations`` displacement updates: image 2's coefficients warped to
   x + d and the normal equations (kernel B2a, ``update_equations``), then
   the window aggregation and the 2x2 solve (kernel B2b,
   ``aggregate_solve``);
3. a coarse-to-fine pyramid with any ``pyr_scale``: each level below L0
   (and the ``downscale`` pre-resize) is the full-resolution images
   blurred and resized (kernel B8, ``ops/pyramid.py::pyramid_levels``:
   every level of both images in one launch, made before the
   coarse-to-fine loop; the pre-resize is a launch of its own);
4. the flow's resize between levels times the ratio of their scales (and
   a warm start's, and the ``downscale`` upscale to full size: kernel
   B15, ``ops/pyramid.py::resize_flow``).

On a CPU tensor every step runs the plain versions; on a CUDA tensor the
five kernels run.
"""
import os

import torch

from ...ops.farneback import (aggregate_solve, poly_expansion,
                               poly_expansion_pair, update_equations)
from ...ops import pyramid

__all__ = ["farneback", "launches_per_frame", "poly_expansion",
           "OPTFLOW_USE_INITIAL_FLOW", "OPTFLOW_FARNEBACK_GAUSSIAN"]

OPTFLOW_USE_INITIAL_FLOW = 4  # cv2 flag value
OPTFLOW_FARNEBACK_GAUSSIAN = 256  # cv2 flag value


def _storage_dtype(device) -> torch.dtype:
    """Dtype of the materialised planes: bf16 on the card, float32 on the
    CPU, as the JAX package stores bf16 on accelerators. Sums, the lerp
    weights, the displacement algebra, the solve and the flow stay float32.
    ``TRANSFLOW_FARNEBACK_BF16=0`` forces float32 everywhere."""
    if os.environ.get("TRANSFLOW_FARNEBACK_BF16", "1") == "0":
        return torch.float32
    return torch.float32 if torch.device(device).type == "cpu" \
        else torch.bfloat16


def _update_flow(poly1: torch.Tensor, poly2: torch.Tensor, flow: torch.Tensor,
                 winsize: int, use_gaussian: bool,
                 select_radius: int = 0) -> torch.Tensor:
    """One displacement update at one level: B2a then B2b.

    ``poly1``, ``poly2``: the (H, W, 5) coefficient stacks of both images
    in the storage dtype; image 2's stack is sampled as it is (the JAX
    package's tap pack is a workaround for the TPU's gather)."""
    planes = update_equations(poly1, poly2, flow, select_radius)
    return aggregate_solve(planes, flow, winsize, use_gaussian)


def _level_shapes(h: int, w: int, pyr_scale: float, levels: int,
                  poly_n: int) -> list[tuple[int, int, float]]:
    """The pyramid's (height, width, scale), finest first: sizes rounded,
    levels kept while above the poly_n expansion window."""
    shapes = []
    for k in range(levels + 1):
        scale = pyr_scale ** k
        lh, lw = int(round(h * scale)), int(round(w * scale))
        if min(lh, lw) <= 2 * poly_n + 1:
            break
        shapes.append((lh, lw, scale))
    return shapes


def launches_per_frame(height: int, width: int, *, pyr_scale: float = 0.5,
                       levels: int = 3, iterations: int = 3, poly_n: int = 5,
                       downscale: int = 1, flags: int = 0, **_
                       ) -> tuple[int, int, int, int, int]:
    """(B1, B2a, B2b, B8, B15) launches of ``farneback`` on a height x
    width frame with these arguments and a ``prev_flow`` (the other
    estimator arguments change none): one B1 a level (both images),
    ``iterations`` B2a and B2b a level, B8's ``ops/pyramid.py::launches``
    for the levels below L0 (one for all of them, both images, and one
    more where a level takes the deep route) and for the ``downscale`` > 1
    pre-resize, and one B15 a change of level, one for the ``downscale``
    upscale to full size, and with OPTFLOW_USE_INITIAL_FLOW one for the
    warm start (and one for its ``downscale`` pre-resize)."""
    downscale = int(downscale)
    h = int(round(height / downscale))
    w = int(round(width / downscale))
    shapes = _level_shapes(h, w, pyr_scale, levels, poly_n)
    b8 = pyramid.launches(h, w, _pyramid_levels(shapes))
    if downscale > 1:
        b8 += pyramid.launches(height, width, _pre_resize(downscale, h, w))
    n = len(shapes)
    warm = bool(flags & OPTFLOW_USE_INITIAL_FLOW)
    b15 = n - 1 + (downscale > 1) + warm * (1 + (downscale > 1))
    return n, iterations * n, iterations * n, b8, b15


def _pyramid_levels(level_shapes) -> list[tuple[float, int, int]]:
    """The (sigma, lh, lw) of each level below L0: the blur of scale s is
    (1 / s - 1) / 2."""
    return [((1.0 / scale - 1.0) * 0.5, lh, lw)
            for lh, lw, scale in level_shapes if scale != 1.0]


def _pre_resize(downscale: int, h: int, w: int
                ) -> list[tuple[float, int, int]]:
    """The ``downscale`` pre-resize to (h, w) as a pyramid level, by the
    same anti-alias rule."""
    return [((downscale - 1) * 0.5, h, w)]


def farneback(prev_gray, next_gray, prev_flow=None, *, pyr_scale: float = 0.5,
              levels: int = 3, winsize: int = 15, iterations: int = 3,
              poly_n: int = 5, poly_sigma: float = 1.2, flags: int = 0,
              downscale: int = 1, select_warp: int = 0) -> torch.Tensor:
    """Estimate the (H, W, 2) float32 flow between two (H, W) uint8
    grayscale frames, on their device.

    Arguments mirror cv2.calcOpticalFlowFarneback; ``prev_flow`` is honoured
    only with OPTFLOW_USE_INITIAL_FLOW, like OpenCV. ``downscale`` runs the
    estimator at 1/downscale resolution and upsamples the flow (magnitudes
    rescaled); ``select_warp`` > 0 samples image 2 by the two-pass warp with
    that displacement radius (``ops/select_warp.py``), 0 by the exact
    clamped-anchor bilinear sample."""
    prev_gray = torch.as_tensor(prev_gray)
    next_gray = torch.as_tensor(next_gray, device=prev_gray.device)
    h, w = prev_gray.shape
    sdt = _storage_dtype(prev_gray.device)
    # uint8 -> bf16 is exact (integers <= 256)
    prev = prev_gray.to(sdt)
    nxt = next_gray.to(sdt)
    use_gaussian = bool(flags & OPTFLOW_FARNEBACK_GAUSSIAN)

    downscale = int(downscale)
    full_h, full_w = h, w
    if downscale > 1:
        h = int(round(full_h / downscale))
        w = int(round(full_w / downscale))
        if min(h, w) <= 2 * poly_n + 1:
            raise ValueError(
                f"downscale={downscale} reduces {full_h}x{full_w} below the "
                f"poly_n={poly_n} expansion window; lower fb_downscale")
        prev, nxt = pyramid.pyramid_levels((prev, nxt),
                                           _pre_resize(downscale, h, w))[0]
        if flags & OPTFLOW_USE_INITIAL_FLOW and prev_flow is not None:
            prev_flow = pyramid.resize_flow(
                torch.as_tensor(prev_flow, device=prev.device).float()
                .contiguous(), h, w, 1.0 / downscale)

    # level sizes, coarsest last; drop levels that get degenerate
    level_shapes = _level_shapes(h, w, pyr_scale, levels, poly_n)
    # every level below L0 of both images, before the coarse-to-fine loop
    below = _pyramid_levels(level_shapes)
    made = iter(pyramid.pyramid_levels((prev, nxt), below) if below else ())
    images = [(prev, nxt) if scale == 1.0 else next(made)
              for _, _, scale in level_shapes]

    lh, lw, scale = level_shapes[-1]
    if flags & OPTFLOW_USE_INITIAL_FLOW and prev_flow is not None:
        flow = torch.as_tensor(prev_flow, device=prev.device).float()
        flow = pyramid.resize_flow(flow.contiguous(), lh, lw, scale)
    else:
        flow = torch.zeros((lh, lw, 2), dtype=torch.float32,
                           device=prev.device)

    for k in range(len(level_shapes) - 1, -1, -1):
        lh, lw, scale = level_shapes[k]
        if tuple(flow.shape[:2]) != (lh, lw):
            prev_scale = level_shapes[k + 1][2]
            flow = pyramid.resize_flow(flow, lh, lw, scale / prev_scale)
        img1, img2 = images[k]
        poly1, poly2 = poly_expansion_pair(img1, img2, poly_n, poly_sigma,
                                           sdt)
        for _ in range(iterations):
            flow = _update_flow(poly1, poly2, flow, winsize, use_gaussian,
                                select_warp)
    if downscale > 1:
        flow = pyramid.resize_flow(flow, full_h, full_w, float(downscale))
    return flow

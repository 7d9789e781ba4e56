"""Farneback's dense optical flow (cv2.calcOpticalFlowFarneback's method),
in plain PyTorch: the reference of the ``farneback`` estimator.

Per level of a coarse-to-fine pyramid, the quadratic polynomial expansion
of both images, then ``iterations`` updates of the displacement: image 2's
coefficients sampled at x + d, the normal equations, their sum over a box
window and the 2x2 solve. The pyramid's levels are the full-resolution
images blurred by ``(1 / s - 1) / 2`` and resized by JAX's linear resize;
the flow moves between levels by the same resize times the ratio of
scales.

Precision: the configuration states where values are rounded to
``storage`` (the images, the correlations, the coefficients and the
equations' planes); sums, weights, the algebra, the solve and the flow are
float32. ``coeffs`` is applied to each image's coefficient stack as it is
made: the identity for the stated precision, a rounding to a lower one for
the control; the check also runs it with every plane in float32, the gap
that the stated storage opens.
"""
import functools

import numpy as np
import torch

from .image import (bilinear_sample_clamped, gaussian_kernel_1d,
                    ordered_correlate, resize_axis, resize_flow,
                    rounded_taps)


@functools.lru_cache(maxsize=None)
def poly_exp_consts(n: int, sigma: float):
    """The Gaussian-weighted basis' 1-D kernels (g, g x, g x^2) and the
    inverse Gram matrix of the 2-D fit, in float64 rounded to float32."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    xx, yy = np.meshgrid(x, x)
    w = np.outer(g, g)
    basis = np.stack([np.ones_like(xx), xx, yy, xx ** 2, yy ** 2, xx * yy])
    gram = np.einsum("kij,lij,ij->kl", basis, basis, w)
    ginv = np.linalg.inv(gram)
    return (g.astype(np.float32), (g * x).astype(np.float32),
            (g * x * x).astype(np.float32), ginv.astype(np.float32))


def poly_expansion(image: torch.Tensor, n: int, sigma: float,
                   storage: torch.dtype) -> torch.Tensor:
    """(H, W) image -> (H, W, 5) ``[bx, by, axx, ayy, axy]`` in ``storage``:
    three vertical and six horizontal correlations (symmetric padding,
    taps rounded to ``storage``), the fit's 6-term dot products, ``axy``
    halved."""
    g, xg, xxg, ginv = poly_exp_consts(n, sigma)
    g, xg, xxg = (rounded_taps(k, storage) for k in (g, xg, xxg))
    f = image.to(storage).float()

    def corr(x, taps, dim):
        return ordered_correlate(x, taps, dim, "symmetric").to(storage).float()

    fy0, fy1, fy2 = (corr(f, taps, 0) for taps in (g, xg, xxg))
    moments = (corr(fy0, g, 1), corr(fy0, xg, 1), corr(fy1, g, 1),
               corr(fy0, xxg, 1), corr(fy2, g, 1), corr(fy1, xg, 1))
    coeffs = []
    for k in range(1, 6):
        acc = moments[0] * float(ginv[k, 0])
        for m in range(1, 6):
            acc = acc + moments[m] * float(ginv[k, m])
        coeffs.append(acc.to(storage))
    coeffs[4] = coeffs[4] * 0.5
    return torch.stack(coeffs, dim=-1)


def update_equations(poly1: torch.Tensor, poly2: torch.Tensor,
                     flow: torch.Tensor) -> torch.Tensor:
    """The (6, H, W) planes ``[g11, g12, g22, h1, h2, inb]`` (each times
    the in-frame test of the sample position), in the stacks' dtype."""
    h, w = flow.shape[:2]
    yy = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=flow.device, dtype=torch.float32)[None, :]
    dx = flow[..., 0]
    dy = flow[..., 1]
    sx = xx + dx
    sy = yy + dy
    p2w = bilinear_sample_clamped(poly2, sy, sx)
    bx1, by1, axx1, ayy1, axy1 = poly1.unbind(-1)
    bx2, by2, axx2, ayy2, axy2 = p2w.unbind(-1)
    inb = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)).float()
    a11 = 0.5 * (axx1 + axx2)
    a22 = 0.5 * (ayy1 + ayy2)
    a12 = 0.5 * (axy1 + axy2)
    db_x = -0.5 * (bx2 - bx1) + (a11 * dx + a12 * dy)
    db_y = -0.5 * (by2 - by1) + (a12 * dx + a22 * dy)
    g11 = a11 * a11 + a12 * a12
    g12 = a11 * a12 + a12 * a22
    g22 = a12 * a12 + a22 * a22
    h1 = a11 * db_x + a12 * db_y
    h2 = a12 * db_x + a22 * db_y
    return torch.stack([g11 * inb, g12 * inb, g22 * inb, h1 * inb, h2 * inb,
                        inb]).to(poly1.dtype)


def aggregate_solve(planes: torch.Tensor, flow: torch.Tensor,
                    winsize: int) -> torch.Tensor:
    """Box sums of the planes over ``winsize`` (zero padding; the vertical
    sum rounded to the planes' dtype), then ``A d = b`` solved per pixel
    where ``det > 1e-9`` and the window's weight is positive; elsewhere
    the flow stays."""
    ones = (1.0,) * winsize
    tmp = ordered_correlate(planes.float(), ones, 1, "constant")
    tmp = tmp.to(planes.dtype).float()
    g11, g12, g22, h1, h2, weight = ordered_correlate(tmp, ones, 2,
                                                      "constant")
    det = g11 * g22 - g12 * g12
    ok = (det > 1e-9) & (weight > 0)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    new_dx = (g22 * h1 - g12 * h2) * inv_det
    new_dy = (g11 * h2 - g12 * h1) * inv_det
    new = torch.stack([new_dx, new_dy], dim=-1)
    return torch.where(ok[..., None], new, flow)


def _level_shapes(h: int, w: int, pyr_scale: float, levels: int,
                  poly_n: int) -> list[tuple[int, int, float]]:
    shapes = []
    for k in range(levels + 1):
        scale = pyr_scale ** k
        lh, lw = int(round(h * scale)), int(round(w * scale))
        if min(lh, lw) <= 2 * poly_n + 1:
            break
        shapes.append((lh, lw, scale))
    return shapes


def pyramid_level(image: torch.Tensor, sigma: float, lh: int,
                  lw: int) -> torch.Tensor:
    """The (H, W) image blurred by ``sigma`` (radius ``int(3 sigma +
    0.5)``, symmetric padding; a bf16 image meets bf16-rounded taps in the
    first pass) and resized to (lh, lw) by JAX's anti-aliased linear
    resize, in float32: the vertical blur, the row resize, the horizontal
    blur, the column resize."""
    k = gaussian_kernel_1d(sigma, int(3.0 * sigma + 0.5))
    first = rounded_taps(k, torch.bfloat16 if image.dtype == torch.bfloat16
                         else torch.float32)
    second = k.tolist()
    rows = resize_axis(ordered_correlate(image.float(), first, 0,
                                         "symmetric"), lh, 0)
    return resize_axis(ordered_correlate(rows, second, 1, "symmetric"), lw, 1)


def estimate(left: torch.Tensor, right: torch.Tensor, cv_config: dict,
             storage: torch.dtype, coeffs=None) -> torch.Tensor:
    """The (H, W, 2) float32 flow from the (H, W) uint8 ``left`` to
    ``right`` under ``cv_config`` (cv2's flags 0: no initial flow, the box
    window; ``fb_downscale`` 1, ``fb_select_warp`` 0)."""
    if (cv_config.get("fb_flags", 0) != 0
            or cv_config.get("fb_downscale", 1) != 1
            or cv_config.get("fb_select_warp", 0) != 0):
        raise NotImplementedError("the reference covers fb_flags 0, "
                                  "fb_downscale 1 and fb_select_warp 0")
    coeffs = coeffs or (lambda stack: stack)
    pyr_scale = cv_config.get("fb_pyr_scale", 0.5)
    levels = int(cv_config.get("fb_levels", 3))
    winsize = int(cv_config.get("fb_winsize", 15))
    iterations = int(cv_config.get("fb_iterations", 3))
    poly_n = int(cv_config.get("fb_poly_n", 5))
    poly_sigma = cv_config.get("fb_poly_sigma", 1.2)
    h, w = left.shape
    prev = left.to(storage)
    nxt = right.to(storage)
    shapes = _level_shapes(h, w, pyr_scale, levels, poly_n)
    images = []
    for lh, lw, scale in shapes:
        if scale == 1.0:
            images.append((prev, nxt))
        else:
            sigma = (1.0 / scale - 1.0) * 0.5
            images.append((pyramid_level(prev, sigma, lh, lw),
                           pyramid_level(nxt, sigma, lh, lw)))
    lh, lw, _ = shapes[-1]
    flow = torch.zeros((lh, lw, 2), dtype=torch.float32, device=left.device)
    for k in range(len(shapes) - 1, -1, -1):
        lh, lw, scale = shapes[k]
        if tuple(flow.shape[:2]) != (lh, lw):
            flow = resize_flow(flow, lh, lw, scale / shapes[k + 1][2])
        img1, img2 = images[k]
        poly1 = coeffs(poly_expansion(img1, poly_n, poly_sigma, storage))
        poly2 = coeffs(poly_expansion(img2, poly_n, poly_sigma, storage))
        for _ in range(iterations):
            planes = update_equations(poly1, poly2, flow)
            flow = aggregate_solve(planes, flow, winsize)
    return flow


def flow(prev: torch.Tensor, cur: torch.Tensor, cv_config: dict,
         direction: str, precision: dict, variant: str = "stated",
         net=None) -> torch.Tensor:
    """The raw flow of the frame pair (``prev``, ``cur``), (H, W) uint8,
    as the estimator pairs them for ``direction``: forward estimates from
    ``prev`` to ``cur``, backward from ``cur`` to ``prev``. ``variant``:
    ``"stated"`` stores the planes in the configuration's
    ``precision["storage"]``, ``"float32"`` in float32, ``"control"`` as
    stated with the coefficient stacks rounded as ``precision["control"]``
    says."""
    storage = getattr(torch, precision["storage"])
    coeffs = None
    if variant == "float32":
        storage = torch.float32
    elif variant == "control":
        if precision["control"] != "coefficients_float8_e4m3fn":
            raise ValueError(f"unknown control {precision['control']!r}")
        from .image import fp8_round
        coeffs = fp8_round
    left, right = (prev, cur) if direction == "forward" else (cur, prev)
    return estimate(left, right, cv_config, storage, coeffs)

"""Farneback's hot loops: kernels B1 (polynomial expansion), B2a (warp and
normal equations) and B2b (aggregation and solve).

Counterpart of transflow_tpu/flow/estimators/farneback.py's
``poly_expansion`` and ``_update_flow``, which XLA compiles from jnp ops
(there is no Pallas source). Each kernel has three functions: ``*_plain``,
the plain PyTorch version; ``*_cuda``, which launches the hand-written
kernel of ``csrc/farneback.cu`` and counts its launches; and the
dispatcher, which sends CPU tensors to the first and CUDA tensors to the
second, with no fallback between them. ``poly_expansion_pair`` runs B1 on
both images of a level: one launch on the card, two calls of
``poly_expansion_plain`` on the CPU.

The plain versions compute what the JAX functions compute, with the same
rounding points to the storage dtype (bf16 or float32), and add every sum
in a fixed order with each product and sum rounded to float32: the order
the kernels use, so a kernel and its plain version agree bit for bit. The
JAX package leaves the order to XLA.

Layouts: the five coefficient planes of an image are one (H, W, 5) stack
``[bx, by, axx, ayy, axy]``; the six normal-equation planes are one (6, H,
W) stack ``[g11, g12, g22, h1, h2, inb]``; flows are (H, W, 2) float32
``(dx, dy)``.
"""
import ctypes
import functools

import numpy as np
import torch

from .._device import (DTYPE_CODES, check_cuda, cuda_stream, dispatch,
                       launch)
from .image import (bilinear_sample_packed, gaussian_kernel_1d,
                    ordered_correlate, prepack_bilinear_taps, rounded_taps)
from .select_warp import shift_select_warp

# what the kernels take (csrc/farneback.cu: kMaxPolyN, kMaxWinTaps)
MAX_POLY_N = 12
MAX_WINDOW_TAPS = 63


@functools.lru_cache(maxsize=None)
def poly_exp_consts(n: int, sigma: float):
    """1-D basis kernels and the inverse Gram matrix for the weighted LS fit
    (numpy, float64 math rounded to float32; the JAX function's)."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    # basis over the 2-D window: [1, x, y, x^2, y^2, xy]
    xx, yy = np.meshgrid(x, x)  # yy varies along rows
    w = np.outer(g, g)
    basis = np.stack([np.ones_like(xx), xx, yy, xx ** 2, yy ** 2, xx * yy])
    gram = np.einsum("kij,lij,ij->kl", basis, basis, w)
    ginv = np.linalg.inv(gram)
    return (g.astype(np.float32), (g * x).astype(np.float32),
            (g * x * x).astype(np.float32), ginv.astype(np.float32))


def _check_flow(name: str, flow: torch.Tensor, h: int, w: int) -> None:
    if tuple(flow.shape) != (h, w, 2) or flow.dtype != torch.float32:
        raise ValueError(f"{name} needs an ({h}, {w}, 2) float32 flow, got "
                         f"{tuple(flow.shape)} {flow.dtype}")


# ---------------------------------------------------------------------------
# B1: polynomial expansion
# ---------------------------------------------------------------------------

def poly_expansion_plain(image: torch.Tensor, n: int, sigma: float,
                         storage: torch.dtype) -> torch.Tensor:
    """(H, W) image -> (H, W, 5) ``[bx, by, axx, ayy, axy]`` in ``storage``.

    The image is rounded to ``storage``; the three vertical and six
    horizontal correlations (symmetric padding, taps rounded to
    ``storage``) and the fit (``moments @ ginv.T``, float32) are each
    rounded to ``storage``; ``axy`` is halved there."""
    g, xg, xxg, ginv = poly_exp_consts(n, sigma)
    g, xg, xxg = (rounded_taps(k, storage).tolist() for k in (g, xg, xxg))
    f = image.to(storage).float()

    def corr(x, taps, dim):
        return ordered_correlate(x, taps, dim, "symmetric").to(storage).float()

    fy0, fy1, fy2 = (corr(f, taps, 0) for taps in (g, xg, xxg))
    # [m00, m10, m01, m20, m02, m11]: w*f, w*x*f, w*y*f, w*x^2*f, ...
    moments = (corr(fy0, g, 1), corr(fy0, xg, 1), corr(fy1, g, 1),
               corr(fy0, xxg, 1), corr(fy2, g, 1), corr(fy1, xg, 1))
    coeffs = []
    for k in range(1, 6):          # [c, bx, by, axx, ayy, axy] without c
        acc = moments[0] * float(ginv[k, 0])
        for m in range(1, 6):
            acc = acc + moments[m] * float(ginv[k, m])
        coeffs.append(acc.to(storage))
    coeffs[4] = coeffs[4] * 0.5
    return torch.stack(coeffs, dim=-1)


@functools.lru_cache(maxsize=None)
def _poly_params(n: int, sigma: float, storage: torch.dtype) -> np.ndarray:
    """The kernel's constants: the three tap rows rounded to ``storage``,
    then the 36 entries of ``ginv`` (float32, contiguous)."""
    g, xg, xxg, ginv = poly_exp_consts(n, sigma)
    taps = [rounded_taps(k, storage).numpy() for k in (g, xg, xxg)]
    return np.ascontiguousarray(np.concatenate(taps + [ginv.ravel()]),
                                np.float32)


def _poly_launch(images, n: int, sigma: float,
                 storage: torch.dtype) -> list[torch.Tensor]:
    """One launch of kernel B1 over one or two contiguous (H, W) images of
    one shape and dtype (float32 or bf16) on one CUDA device; counted on
    ``poly_expansion_cuda.launches``."""
    check_cuda("poly_expansion_cuda", *images)
    image = images[0]
    if image.dim() != 2 or image.dtype not in DTYPE_CODES or any(
            t.shape != image.shape or t.dtype != image.dtype
            for t in images):
        raise ValueError("poly_expansion_cuda needs (H, W) float32 or bf16 "
                         "images of one shape and dtype, got "
                         f"{[(tuple(t.shape), t.dtype) for t in images]}")
    if storage not in DTYPE_CODES:
        raise ValueError(f"storage must be float32 or bf16, got {storage}")
    if not 1 <= n <= MAX_POLY_N:
        raise ValueError(f"poly_n must be in [1, {MAX_POLY_N}], got {n}")
    h, w = image.shape
    params = _poly_params(n, float(sigma), storage).ctypes.data_as(
        ctypes.c_void_p)
    outs = [torch.empty((h, w, 5), dtype=storage, device=image.device)
            for _ in images]
    if len(images) == 1:
        launch(image.device, "transflow_poly_expansion", image.data_ptr(),
               DTYPE_CODES[image.dtype], outs[0].data_ptr(),
               DTYPE_CODES[storage], h, w, n, params, cuda_stream(image))
    else:
        launch(image.device, "transflow_poly_expansion_pair",
               images[0].data_ptr(), images[1].data_ptr(),
               DTYPE_CODES[image.dtype], outs[0].data_ptr(),
               outs[1].data_ptr(), DTYPE_CODES[storage], h, w, n, params,
               cuda_stream(image))
    poly_expansion_cuda.launches += 1
    return outs


def poly_expansion_cuda(image: torch.Tensor, n: int, sigma: float,
                        storage: torch.dtype) -> torch.Tensor:
    """Launch kernel B1 on a contiguous (H, W) float32 or bf16 image on a
    CUDA device. ``poly_expansion_cuda.launches`` counts launches."""
    return _poly_launch([image], n, sigma, storage)[0]


poly_expansion_cuda.launches = 0


def poly_expansion(image: torch.Tensor, n: int, sigma: float,
                   storage: torch.dtype = torch.float32) -> torch.Tensor:
    """Dispatcher of B1 by the image's device."""
    fn = dispatch("poly_expansion", poly_expansion_plain,
                  poly_expansion_cuda, image)
    return fn(image, n, sigma, storage)


def poly_expansion_pair_plain(image1: torch.Tensor, image2: torch.Tensor,
                              n: int, sigma: float, storage: torch.dtype
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both images of a level through ``poly_expansion_plain``."""
    return (poly_expansion_plain(image1, n, sigma, storage),
            poly_expansion_plain(image2, n, sigma, storage))


def poly_expansion_pair_cuda(image1: torch.Tensor, image2: torch.Tensor,
                             n: int, sigma: float, storage: torch.dtype
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B1 on both images of a level (one shape and dtype) in one
    launch, counted once on ``poly_expansion_cuda.launches``."""
    return tuple(_poly_launch([image1, image2], n, sigma, storage))


def poly_expansion_pair(image1: torch.Tensor, image2: torch.Tensor, n: int,
                        sigma: float, storage: torch.dtype = torch.float32
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher of B1 over both images of a level by their device."""
    fn = dispatch("poly_expansion_pair", poly_expansion_pair_plain,
                  poly_expansion_pair_cuda, image1, image2)
    return fn(image1, image2, n, sigma, storage)


# ---------------------------------------------------------------------------
# B2a: warp of image 2's coefficients and the normal equations
# ---------------------------------------------------------------------------

def update_equations_plain(poly1: torch.Tensor, poly2: torch.Tensor,
                           flow: torch.Tensor,
                           select_radius: int = 0) -> torch.Tensor:
    """(H, W, 5) stacks of both images and the (H, W, 2) flow -> (6, H, W)
    ``[g11, g12, g22, h1, h2, inb]`` (each times ``inb``) in the stacks'
    dtype.

    Image 2's planes are sampled at ``(i + dy, j + dx)``: with the
    clamped-anchor bilinear rule (``bilinear_sample_packed``), or with
    ``select_radius`` > 0 the two-pass clamped warp (``shift_select_warp``).
    ``inb`` comes from the unclamped position in both modes."""
    h, w = flow.shape[:2]
    yy = torch.arange(h, device=flow.device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=flow.device, dtype=torch.float32)[None, :]
    dx = flow[..., 0]
    dy = flow[..., 1]
    sx = xx + dx
    sy = yy + dy
    if select_radius > 0:
        p2w = shift_select_warp(poly2, dy, dx, select_radius)
    else:
        p2w = bilinear_sample_packed(prepack_bilinear_taps(poly2), sy, sx)
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


def update_equations_cuda(poly1: torch.Tensor, poly2: torch.Tensor,
                          flow: torch.Tensor,
                          select_radius: int = 0) -> torch.Tensor:
    """Launch kernel B2a on contiguous (H, W, 5) float32 or bf16 stacks of
    one dtype and an (H, W, 2) float32 flow on one CUDA device.
    ``update_equations_cuda.launches`` counts launches."""
    check_cuda("update_equations_cuda", poly1, poly2, flow)
    h, w = flow.shape[:2]
    if (tuple(poly1.shape) != (h, w, 5) or poly2.shape != poly1.shape
            or poly1.dtype not in DTYPE_CODES or poly2.dtype != poly1.dtype):
        raise ValueError("update_equations_cuda needs two (H, W, 5) stacks "
                         "of one dtype, float32 or bf16, got "
                         f"{tuple(poly1.shape)} {poly1.dtype} and "
                         f"{tuple(poly2.shape)} {poly2.dtype}")
    _check_flow("update_equations_cuda", flow, h, w)
    if select_radius < 0:
        raise ValueError(f"select_radius must be >= 0, got {select_radius}")
    planes = torch.empty((6, h, w), dtype=poly1.dtype, device=flow.device)
    launch(flow.device, "transflow_update_equations", poly1.data_ptr(),
           poly2.data_ptr(), DTYPE_CODES[poly1.dtype], flow.data_ptr(),
           planes.data_ptr(), h, w, int(select_radius), cuda_stream(flow))
    update_equations_cuda.launches += 1
    return planes


update_equations_cuda.launches = 0


def update_equations(poly1: torch.Tensor, poly2: torch.Tensor,
                     flow: torch.Tensor,
                     select_radius: int = 0) -> torch.Tensor:
    """Dispatcher of B2a by the tensors' device."""
    fn = dispatch("update_equations", update_equations_plain,
                  update_equations_cuda, poly1, poly2, flow)
    return fn(poly1, poly2, flow, select_radius)


# ---------------------------------------------------------------------------
# B2b: window aggregation and the 2x2 solve
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def window_taps(winsize: int, use_gaussian: bool, storage: torch.dtype):
    """(vertical taps, horizontal taps, pad mode) of the aggregation.

    Box: ``winsize`` ones, zero padding. Gaussian (``flags & 256``):
    ``gaussian_kernel_1d(0.3 * winsize, winsize // 2)`` with symmetric
    padding, the vertical taps rounded to ``storage`` (they meet the
    planes), the horizontal ones float32 (they meet a float32 sum)."""
    if use_gaussian:
        k = gaussian_kernel_1d(winsize * 0.3, winsize // 2)
        return (tuple(rounded_taps(k, storage).tolist()),
                tuple(k.tolist()), "symmetric")
    ones = (1.0,) * winsize
    return ones, ones, "constant"


def aggregate_solve_plain(planes: torch.Tensor, flow: torch.Tensor,
                          winsize: int, use_gaussian: bool) -> torch.Tensor:
    """(6, H, W) planes and the (H, W, 2) flow -> the new (H, W, 2) float32
    flow.

    Each plane is summed over the window (box: the vertical sum rounded to
    the planes' dtype before the horizontal one; Gaussian: not rounded),
    then ``A d = b`` is solved per pixel where ``det > 1e-9`` and the
    window's weight is positive; elsewhere the flow stays."""
    vtaps, htaps, mode = window_taps(winsize, use_gaussian, planes.dtype)
    tmp = ordered_correlate(planes.float(), vtaps, 1, mode)
    if not use_gaussian:
        tmp = tmp.to(planes.dtype).float()
    g11, g12, g22, h1, h2, weight = ordered_correlate(tmp, htaps, 2, mode)
    det = g11 * g22 - g12 * g12
    ok = (det > 1e-9) & (weight > 0)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    new_dx = (g22 * h1 - g12 * h2) * inv_det
    new_dy = (g11 * h2 - g12 * h1) * inv_det
    new = torch.stack([new_dx, new_dy], dim=-1)
    return torch.where(ok[..., None], new, flow)


@functools.lru_cache(maxsize=None)
def _window_params(winsize: int, use_gaussian: bool, storage: torch.dtype):
    """(vertical taps, horizontal taps) as contiguous float32 arrays, and
    whether the padding is symmetric."""
    vtaps, htaps, mode = window_taps(winsize, use_gaussian, storage)
    return (np.asarray(vtaps, np.float32), np.asarray(htaps, np.float32),
            mode == "symmetric")


def aggregate_solve_cuda(planes: torch.Tensor, flow: torch.Tensor,
                         winsize: int, use_gaussian: bool) -> torch.Tensor:
    """Launch kernel B2b on contiguous (6, H, W) float32 or bf16 planes and
    an (H, W, 2) float32 flow on one CUDA device.
    ``aggregate_solve_cuda.launches`` counts launches."""
    check_cuda("aggregate_solve_cuda", planes, flow)
    if planes.dim() != 3 or planes.shape[0] != 6 or \
            planes.dtype not in DTYPE_CODES:
        raise ValueError("aggregate_solve_cuda needs (6, H, W) float32 or "
                         f"bf16 planes, got {tuple(planes.shape)} "
                         f"{planes.dtype}")
    h, w = planes.shape[1:]
    _check_flow("aggregate_solve_cuda", flow, h, w)
    vtaps, htaps, symmetric = _window_params(int(winsize), bool(use_gaussian),
                                             planes.dtype)
    if not 1 <= len(vtaps) <= MAX_WINDOW_TAPS:
        raise ValueError(f"the window takes {len(vtaps)} taps; the kernel "
                         f"takes 1 to {MAX_WINDOW_TAPS}")
    out = torch.empty((h, w, 2), dtype=torch.float32, device=flow.device)
    launch(flow.device, "transflow_aggregate_solve", planes.data_ptr(),
           DTYPE_CODES[planes.dtype], flow.data_ptr(), out.data_ptr(), h, w,
           len(vtaps), int(symmetric), int(not use_gaussian),
           vtaps.ctypes.data_as(ctypes.c_void_p),
           htaps.ctypes.data_as(ctypes.c_void_p), cuda_stream(flow))
    aggregate_solve_cuda.launches += 1
    return out


aggregate_solve_cuda.launches = 0


def aggregate_solve(planes: torch.Tensor, flow: torch.Tensor, winsize: int,
                    use_gaussian: bool) -> torch.Tensor:
    """Dispatcher of B2b by the tensors' device."""
    fn = dispatch("aggregate_solve", aggregate_solve_plain,
                  aggregate_solve_cuda, planes, flow)
    return fn(planes, flow, winsize, use_gaussian)

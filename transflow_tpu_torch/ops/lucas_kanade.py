"""Lucas-Kanade's hot loops: kernels B13 (the Scharr derivatives), B11
(warp and products) and B12 (window sums and the 2x2 solve).

Counterpart of transflow_tpu/flow/estimators/lucas_kanade.py's
``_lk_level``, which XLA compiles from jnp ops (there is no Pallas
source). As in ``ops/farneback.py``, each kernel has a plain PyTorch
version (``*_plain``), a wrapper that launches the hand-written kernel of
``csrc/lucas_kanade.cu`` and counts its launches (``*_cuda``), and a
dispatcher by device with no fallback between the two.

- B13 ``lk_scharr``: both Scharr derivatives of a level (``_scharr(image,
  1)`` and ``_scharr(image, 0)``): the taps ``[-3, 0, 3] / 32`` along the
  derivative's axis, then ``[3, 10, 3]`` along the other, each pass with
  numpy's symmetric padding of width 1 (the edge sample repeats).
- B11 ``lk_warp_products``: ``nxt`` sampled at ``(y + v, x + u)`` by the
  clamped-anchor bilinear rule (the JAX package's
  ``bilinear_sample_packed`` on the raw image: its tap pack is a TPU
  workaround), ``it = warped - prev``, and the planes ``ix * it`` and
  ``iy * it``.
- B12 ``lk_window_solve``: the zero-padded box sums of those planes, then
  ``du = (g22 * b1 - g12 * b2) * inv_det`` and ``dv`` with ``b = -sums``,
  zeroed where ``du^2 + dv^2 < eps^2``, added to the flow. The same
  kernel makes the structure tensor once per level
  (``lk_structure_tensor``): the box sums of ``ix * ix``, ``ix * iy`` and
  ``iy * iy`` and ``inv_det``, counted on B12's launches.

The plain versions add every sum in the kernels' order (``ordered_
correlate``: the vertical sum of the window's rows in order, then the
horizontal one) with every product and sum rounded to float32, so a kernel
and its plain version agree bit for bit.

Layouts: (H, W) float32 images and derivatives (B13 returns ``ix`` and
``iy`` as the two planes of one (2, H, W) buffer); the products are one (2,
H, W) stack ``[ix * it, iy * it]``; the structure tensor one (4, H, W)
stack ``[g11, g12, g22, inv_det]``; flows (H, W, 2) float32 ``(u, v)``.
"""
import numpy as np
import torch

from .._device import check_cuda, cuda_stream, dispatch, launch
from .image import ordered_correlate

# cv2's Scharr derivative over 32 and its smoothing, the JAX module's
# float32 taps (exact in float32: the kernel's literals)
SCHARR = tuple((np.asarray([-3.0, 0.0, 3.0], np.float32) / 32.0).tolist())
SCHARR_SMOOTH = (3.0, 10.0, 3.0)
# the window sizes the kernel takes (csrc/lucas_kanade.cu: kMaxTaps)
MAX_WINDOW = 63
# the JAX function's thresholds, compared in float32
DET_MIN = float(np.float32(1e-6))


def small_step(eps: float) -> float:
    """``eps * eps`` as the JAX function compares a float32 plane with it."""
    return float(np.float32(eps * eps))


def _check_planes(name: str, **tensors) -> None:
    for label, (t, shape) in tensors.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} needs a {shape} float32 {label}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _check_window(name: str, win: int) -> None:
    if not 1 <= win <= MAX_WINDOW:
        raise ValueError(f"{name}: the kernel takes windows of 1 to "
                         f"{MAX_WINDOW} pixels, got {win}")


# ---------------------------------------------------------------------------
# B13: the Scharr derivatives
# ---------------------------------------------------------------------------

def lk_scharr_plain(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(ix, iy) of an (H, W) float32 image: ``SCHARR`` along the axis of the
    derivative, then ``SCHARR_SMOOTH`` along the other, each pass padded
    symmetrically (``ordered_correlate``: the products in tap order, the
    zero tap's included, each rounded)."""
    ix = ordered_correlate(ordered_correlate(image, SCHARR, 1, "symmetric"),
                           SCHARR_SMOOTH, 0, "symmetric")
    iy = ordered_correlate(ordered_correlate(image, SCHARR, 0, "symmetric"),
                           SCHARR_SMOOTH, 1, "symmetric")
    return ix, iy


def lk_scharr_cuda(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B13 on a contiguous (H, W) float32 image on a CUDA
    device: both derivatives in one launch, the planes of one new (2, H, W)
    buffer. ``lk_scharr_cuda.launches`` counts launches."""
    check_cuda("lk_scharr_cuda", image)
    if image.dim() != 2 or image.dtype != torch.float32:
        raise ValueError(f"lk_scharr_cuda needs an (H, W) float32 image, "
                         f"got {tuple(image.shape)} {image.dtype}")
    h, w = image.shape
    out = torch.empty((2, h, w), dtype=torch.float32, device=image.device)
    launch(image.device, "transflow_lk_scharr", image.data_ptr(),
           out[0].data_ptr(), out[1].data_ptr(), h, w, cuda_stream(image))
    lk_scharr_cuda.launches += 1
    return out[0], out[1]


lk_scharr_cuda.launches = 0


def lk_scharr(image: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher of B13 by the image's device."""
    fn = dispatch("lk_scharr", lk_scharr_plain, lk_scharr_cuda, image)
    return fn(image)


# ---------------------------------------------------------------------------
# B11: the warp of the second image and the products
# ---------------------------------------------------------------------------

def _sample(image: torch.Tensor, yy: torch.Tensor,
            xx: torch.Tensor) -> torch.Tensor:
    """``image`` (H, W) at float (yy, xx): the anchor ``floor`` clamped to
    the frame (in float, so a huge or infinite coordinate saturates as the
    kernel's conversion does; NaN anchors at 0), the weights from the
    unclamped coordinate, the +1 taps edge-replicated, rows' x lerp
    first."""
    h, w = image.shape
    y0f = torch.floor(yy)
    x0f = torch.floor(xx)
    wy = yy - y0f
    wx = xx - x0f
    y0 = torch.nan_to_num(y0f.clamp(0, h - 1), nan=0.0).long()
    x0 = torch.nan_to_num(x0f.clamp(0, w - 1), nan=0.0).long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    top = image[y0, x0] * (1 - wx) + image[y0, x1] * wx
    bot = image[y1, x0] * (1 - wx) + image[y1, x1] * wx
    return top * (1 - wy) + bot * wy


def lk_warp_products_plain(prev: torch.Tensor, nxt: torch.Tensor,
                           ix: torch.Tensor, iy: torch.Tensor,
                           flow: torch.Tensor) -> torch.Tensor:
    """(H, W) images and derivatives of ``prev`` and the (H, W, 2) flow ->
    the (2, H, W) planes ``[ix * it, iy * it]``, ``it = warped - prev``."""
    h, w = prev.shape
    yy = torch.arange(h, dtype=torch.float32, device=prev.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=prev.device)[None, :]
    warped = _sample(nxt, yy + flow[..., 1], xx + flow[..., 0])
    it = warped - prev
    return torch.stack([ix * it, iy * it])


def lk_warp_products_cuda(prev: torch.Tensor, nxt: torch.Tensor,
                          ix: torch.Tensor, iy: torch.Tensor,
                          flow: torch.Tensor) -> torch.Tensor:
    """Launch kernel B11 on contiguous float32 tensors on one CUDA device.
    ``lk_warp_products_cuda.launches`` counts launches."""
    check_cuda("lk_warp_products_cuda", prev, nxt, ix, iy, flow)
    h, w = prev.shape
    _check_planes("lk_warp_products_cuda", prev=(prev, (h, w)),
                  nxt=(nxt, (h, w)), ix=(ix, (h, w)), iy=(iy, (h, w)),
                  flow=(flow, (h, w, 2)))
    out = torch.empty((2, h, w), dtype=torch.float32, device=prev.device)
    launch(prev.device, "transflow_lk_warp_products", prev.data_ptr(),
           nxt.data_ptr(), ix.data_ptr(), iy.data_ptr(), flow.data_ptr(),
           out.data_ptr(), h, w, cuda_stream(prev))
    lk_warp_products_cuda.launches += 1
    return out


lk_warp_products_cuda.launches = 0


def lk_warp_products(prev: torch.Tensor, nxt: torch.Tensor,
                     ix: torch.Tensor, iy: torch.Tensor,
                     flow: torch.Tensor) -> torch.Tensor:
    """Dispatcher of B11 by the tensors' device."""
    fn = dispatch("lk_warp_products", lk_warp_products_plain,
                  lk_warp_products_cuda, prev, nxt, ix, iy, flow)
    return fn(prev, nxt, ix, iy, flow)


# ---------------------------------------------------------------------------
# B12: the window sums and the solve (and, once per level, the tensor)
# ---------------------------------------------------------------------------

def _box(planes: torch.Tensor, win: int) -> torch.Tensor:
    """The zero-padded ``win`` x ``win`` box sums of (P, H, W) planes: the
    vertical sum in row order, then the horizontal one in column order."""
    ones = (1.0,) * win
    return ordered_correlate(ordered_correlate(planes, ones, 1, "constant"),
                             ones, 2, "constant")


def lk_structure_tensor_plain(ix: torch.Tensor, iy: torch.Tensor,
                              win: int) -> torch.Tensor:
    """The (4, H, W) ``[g11, g12, g22, inv_det]`` of the (H, W) derivatives:
    the box sums of their products, ``det = g11 * g22 - g12 * g12`` and
    ``inv_det = 1 / det`` where ``det > 1e-6``, else 0."""
    g11, g12, g22 = _box(torch.stack([ix * ix, ix * iy, iy * iy]), win)
    det = g11 * g22 - g12 * g12
    valid = det > DET_MIN
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    return torch.stack([g11, g12, g22, inv_det])


def lk_structure_tensor_cuda(ix: torch.Tensor, iy: torch.Tensor,
                             win: int) -> torch.Tensor:
    """Launch kernel B12 in its tensor mode on contiguous (H, W) float32
    derivatives on one CUDA device; counted on
    ``lk_window_solve_cuda.launches`` (the same kernel)."""
    check_cuda("lk_structure_tensor_cuda", ix, iy)
    h, w = ix.shape
    _check_planes("lk_structure_tensor_cuda", ix=(ix, (h, w)),
                  iy=(iy, (h, w)))
    _check_window("lk_structure_tensor_cuda", win)
    out = torch.empty((4, h, w), dtype=torch.float32, device=ix.device)
    launch(ix.device, "transflow_lk_structure_tensor", ix.data_ptr(),
           iy.data_ptr(), out.data_ptr(), h, w, int(win), DET_MIN,
           cuda_stream(ix))
    lk_window_solve_cuda.launches += 1
    return out


def lk_structure_tensor(ix: torch.Tensor, iy: torch.Tensor,
                        win: int) -> torch.Tensor:
    """Dispatcher of B12's tensor mode by the tensors' device."""
    fn = dispatch("lk_structure_tensor", lk_structure_tensor_plain,
                  lk_structure_tensor_cuda, ix, iy)
    return fn(ix, iy, win)


def lk_window_solve_plain(planes: torch.Tensor, tensor: torch.Tensor,
                          flow: torch.Tensor, win: int,
                          eps: float) -> torch.Tensor:
    """The (2, H, W) products, the (4, H, W) structure tensor and the (H,
    W, 2) flow -> the updated flow: ``b = -box(planes)``, the 2x2 solve
    times ``inv_det``, steps with ``du^2 + dv^2 < eps^2`` set to 0."""
    s1, s2 = _box(planes, win)
    b1, b2 = -s1, -s2
    g11, g12, g22, inv_det = tensor.unbind(0)
    du = (g22 * b1 - g12 * b2) * inv_det
    dv = (g11 * b2 - g12 * b1) * inv_det
    small = (du * du + dv * dv) < small_step(eps)
    du = torch.where(small, 0.0, du)
    dv = torch.where(small, 0.0, dv)
    return flow + torch.stack([du, dv], dim=-1)


def lk_window_solve_cuda(planes: torch.Tensor, tensor: torch.Tensor,
                         flow: torch.Tensor, win: int,
                         eps: float) -> torch.Tensor:
    """Launch kernel B12 on contiguous float32 tensors on one CUDA device.
    ``lk_window_solve_cuda.launches`` counts launches (with the tensor
    mode's)."""
    check_cuda("lk_window_solve_cuda", planes, tensor, flow)
    h, w = flow.shape[:2]
    _check_planes("lk_window_solve_cuda", planes=(planes, (2, h, w)),
                  tensor=(tensor, (4, h, w)), flow=(flow, (h, w, 2)))
    _check_window("lk_window_solve_cuda", win)
    out = torch.empty_like(flow)
    launch(flow.device, "transflow_lk_window_solve", planes.data_ptr(),
           tensor.data_ptr(), flow.data_ptr(), out.data_ptr(), h, w,
           int(win), small_step(eps), cuda_stream(flow))
    lk_window_solve_cuda.launches += 1
    return out


lk_window_solve_cuda.launches = 0


def lk_window_solve(planes: torch.Tensor, tensor: torch.Tensor,
                    flow: torch.Tensor, win: int, eps: float) -> torch.Tensor:
    """Dispatcher of B12 by the tensors' device."""
    fn = dispatch("lk_window_solve", lk_window_solve_plain,
                  lk_window_solve_cuda, planes, tensor, flow)
    return fn(planes, tensor, flow, win, eps)

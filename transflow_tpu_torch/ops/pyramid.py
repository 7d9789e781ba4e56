"""The image pyramids' level construction: kernels B8 (Farneback's
blur-and-resize level) and B14 (Lucas-Kanade's reduce), the two modes of
one CUDA kernel (``csrc/pyramid.cu``).

Counterpart of jnp code that XLA fuses (there is no Pallas source):

- B8 ``pyramid_level``: transflow_tpu/flow/estimators/farneback.py:243-248
  (each level) and :211-213 (the ``fb_downscale`` pre-resize),
  ``jax.image.resize(gaussian_blur(img, sigma), (lh, lw), "linear")``: a
  separable Gaussian blur of the full-resolution image with numpy's
  symmetric padding (radius ``int(3 * sigma + 0.5)``, axis 0 first; a
  bf16 image meets taps rounded to bf16, the float32 first pass meets
  float32 taps), then JAX's anti-aliased linear resize to (lh, lw);
- B14 ``downsample2x``: transflow_tpu/ops/image.py:234, the 5-tap binomial
  ``[1, 4, 6, 4, 1] / 16`` along each axis with symmetric padding, then
  ``[::2, ::2]`` (an odd size rounds up).

As in ``ops/farneback.py``, each has a plain PyTorch version (``*_plain``),
a wrapper that launches the hand-written kernel and counts its launches
(``*_cuda``), and a dispatcher by device with no fallback between the two.
Each takes one or two (H, W) images of one shape and dtype (both images of
a level in one launch, ``blockIdx.z``) and returns a tuple of float32
images.

The four passes of B8 are linear and each acts along one axis, so any
order that keeps each axis's blur before its resize computes the same
function; the port takes the one that does the least work: the vertical
blur (the frame's rows' axis: a bf16 frame meets bf16-rounded taps, as in
JAX), the row resize, the horizontal blur (at the level's height), the
column resize. Each resize adds ``out[i] = sum_k w[i, k] * in[start[i] +
k]`` over the output's band of ``K`` weights (``resize_weights``). The
plain versions add every sum in that order from its first term, each
product and sum rounded to float32 (``ordered_correlate`` for the blurs),
which is the kernel's order: a kernel and its plain version agree bit for
bit. XLA leaves the order to itself.
"""
import functools

import numpy as np
import torch

from .._device import DTYPE_CODES, check_cuda, cuda_stream, dispatch, launch
from .image import gaussian_kernel_1d, ordered_correlate, rounded_taps

# B14's taps, the JAX function's float32 constants
REDUCE_TAPS = tuple((np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
                     / np.float32(16.0)).tolist())
# csrc/pyramid.cu: B8's threads a block (a tile's segment columns), its
# tiles' most output rows and columns; the H100's SMs and the shared
# memory a block may hold there
THREADS = 256
MAX_TILE_H = 8
MAX_TILE_W = 128
SMS = 132
SMEM_MAX = 232448


def blur_radius(sigma: float) -> int:
    """The Gaussian's radius in the JAX package: ``int(3 * sigma + 0.5)``."""
    return int(3.0 * sigma + 0.5)


@functools.lru_cache(maxsize=None)
def gaussian_taps(sigma: float, dtype: torch.dtype) -> tuple[tuple, tuple]:
    """(first-pass taps, second-pass taps) of the blur of a ``dtype``
    image, as float32 values: ``gaussian_kernel_1d(sigma, radius)``, the
    first pass's rounded to bf16 for a bf16 image. Computed once per
    sigma and dtype."""
    k = gaussian_kernel_1d(sigma, blur_radius(sigma))
    first = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    return tuple(rounded_taps(k, first).tolist()), tuple(k.tolist())


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """JAX's linear resize of ``in_size`` samples to ``out_size`` as bands:
    (starts, int32 (out,); weights, float32 (out, K)).

    ``jax.image.resize(..., "linear")``'s weights
    (``jax/_src/image/scale.py::compute_weight_mat``) in float32, as XLA
    compiles them on the CPU: ``sample = (i + 0.5) * inv - 0.5`` with ``inv
    = 1 / scale`` rounded to float32; the triangle ``max(0, 1 - |sample -
    j| * r)`` with ``r`` the float32 reciprocal of ``max(inv, 1)``
    (anti-aliased on a downscale), one rounding (a fused multiply-add);
    divided by its sum over ``j`` (added in ascending order); 0 where that
    sum is below ``1000 * eps`` or the sample lies outside ``[-0.5, in -
    0.5]``. Output ``i`` reads inputs ``starts[i] + k`` for ``k < K``, a
    band that holds its nonzero weights (0 elsewhere) and lies inside the
    input: a band that would pass the last input starts earlier, so no
    index is clamped and every output adds K terms. An equal size gives
    the identity (JAX skips such an axis). The fused multiply-add is exact
    in float64 (a product of two float32 values, a sum that keeps its
    bits) before its one rounding to float32. Measured against JAX's
    jitted weights in tests/test_torch_pyramid.py."""
    f32, f64 = np.float32, np.float64
    if in_size < 1 or out_size < 1:
        raise ValueError(f"resize sizes must be positive, got {in_size} -> "
                         f"{out_size}")
    inv_scale = 1.0 / (out_size / in_size)
    recip = f64(f32(1) / f32(max(inv_scale, 1.0)))
    half = np.arange(out_size, dtype=f32) + f32(0.5)
    sample = half * f32(inv_scale) - f32(0.5)
    # the band's candidates: every j within a kernel width of the sample
    width = int(np.ceil(max(inv_scale, 1.0))) + 1
    lo = np.floor(sample).astype(np.int64) - width
    cand = lo[:, None] + np.arange(2 * width + 2)[None, :]
    valid = (cand >= 0) & (cand < in_size)
    dist = np.abs(sample[:, None] - cand.astype(f32)).astype(f64)
    w = np.maximum(f32(0), (1.0 - dist * recip).astype(f32))
    w = np.where(valid, w, f32(0)).astype(f32)
    total = np.zeros(out_size, f32)
    for k in range(w.shape[1]):
        total = total + w[:, k]
    keep = np.abs(total) > f32(1000 * np.finfo(np.float32).eps)
    w = np.where(keep[:, None],
                 w / np.where(total != 0, total, f32(1))[:, None],
                 f32(0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[:, None], w, f32(0))
    nonzero = w != 0
    first = np.where(nonzero.any(axis=1), nonzero.argmax(axis=1), 0)
    last = np.where(nonzero.any(axis=1),
                    w.shape[1] - 1 - nonzero[:, ::-1].argmax(axis=1), 0)
    taps = int((last - first).max()) + 1
    starts = np.clip(lo + first, 0, in_size - taps)
    cols = (starts - lo)[:, None] + np.arange(taps)[None, :]
    inner = (cols >= 0) & (cols < w.shape[1])
    weights = np.where(inner, w[np.arange(out_size)[:, None],
                                np.clip(cols, 0, w.shape[1] - 1)], f32(0))
    if np.any(np.diff(starts) < 0):
        raise AssertionError("resize bands must start in ascending order")
    return starts.astype(np.int32), np.ascontiguousarray(weights, f32)


@functools.lru_cache(maxsize=None)
def _plain_bands(in_size: int, out_size: int, device: torch.device):
    """The plain resize's K index vectors (int64) and its weights (float32
    (out, K)) on ``device``, made once."""
    starts, weights = resize_weights(in_size, out_size)
    index = [torch.from_numpy(starts.astype(np.int64) + k).to(device)
             for k in range(weights.shape[1])]
    return index, torch.from_numpy(weights).to(device)


def _resize_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """``x`` resized along ``dim`` by the bands of ``resize_weights``: the
    band's products added in order from the first, each rounded."""
    index, weights = _plain_bands(x.shape[dim], out_size, x.device)
    shape = (-1, 1) if dim == 0 else (1, -1)
    acc = x.index_select(dim, index[0]) * weights[:, 0].reshape(shape)
    for k in range(1, len(index)):
        acc = acc + x.index_select(dim, index[k]) * weights[:, k].reshape(
            shape)
    return acc


def _check_images(name: str, images) -> None:
    first = images[0]
    if not 1 <= len(images) <= 2 or first.dim() != 2 or any(
            t.shape != first.shape or t.dtype != first.dtype
            for t in images):
        raise ValueError(f"{name} needs one or two (H, W) images of one "
                         "shape and dtype, got "
                         f"{[(tuple(t.shape), t.dtype) for t in images]}")


@functools.lru_cache(maxsize=None)
def _reduce_taps_on(device: torch.device) -> torch.Tensor:
    """B14's taps on ``device``, copied there once: a copy from host
    memory on every call would make the host wait for the card."""
    return torch.tensor(REDUCE_TAPS, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# B8: Farneback's pyramid level
# ---------------------------------------------------------------------------

def pyramid_level_plain(images, sigma: float, lh: int, lw: int
                        ) -> tuple[torch.Tensor, ...]:
    """Each (H, W) float32 or bf16 image blurred by ``sigma`` and resized
    to (lh, lw) float32: the vertical blur, the row resize, the horizontal
    blur, the column resize."""
    _check_images("pyramid_level_plain", images)
    first, second = gaussian_taps(float(sigma), images[0].dtype)
    outs = []
    for x in images:
        rows = _resize_axis(ordered_correlate(x.float(), first, 0,
                                              "symmetric"), lh, 0)
        outs.append(_resize_axis(ordered_correlate(rows, second, 1,
                                                   "symmetric"), lw, 1))
    return tuple(outs)


def _span(starts: np.ndarray, taps: int, tile: int) -> int:
    """The most inputs a tile of ``tile`` consecutive outputs reads."""
    s = starts.astype(np.int64)
    last = s[np.minimum(np.arange(0, len(s), tile) + tile, len(s)) - 1]
    return int((last - s[::tile]).max()) + taps


@functools.lru_cache(maxsize=None)
def _taps_on(sigma: float, dtype: torch.dtype, device: torch.device
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``gaussian_taps`` as float32 tensors on ``device``, copied there
    once."""
    return tuple(torch.tensor(t, dtype=torch.float32, device=device)
                 for t in gaussian_taps(sigma, dtype))


@functools.lru_cache(maxsize=None)
def _bands_on(in_size: int, out_size: int, device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``resize_weights`` as int32 starts and float32 (out, K) weights on
    ``device``, copied there once."""
    starts, weights = resize_weights(in_size, out_size)
    return (torch.from_numpy(starts).to(device),
            torch.from_numpy(weights).to(device))


@functools.lru_cache(maxsize=None)
def level_plan(h: int, w: int, lh: int, lw: int, radius: int,
               images: int = 2) -> tuple[int, int, int, int, int]:
    """(tile rows, tile columns, the most segment columns and the most
    blurred columns a tile reads, shared bytes) of B8's launch over
    ``images`` images: the widest tile whose segment (its outputs' column
    bands and the blur's margin) fits the block's 256 threads, else one
    column; 8 rows, fewer where the grid would give the H100's SMs fewer
    than two blocks each. Shared memory holds the tile's rows of the
    segment and of the blurred columns, the taps and the tile's bands;
    raises where that exceeds the H100's."""
    ys, wy = resize_weights(h, lh)
    xs, wx = resize_weights(w, lw)
    tile_w = 1
    for tw in range(min(lw, MAX_TILE_W), 1, -1):
        if _span(xs, wx.shape[1], tw) + 2 * radius <= THREADS:
            tile_w = tw
            break
    tile_h = MAX_TILE_H
    while tile_h > 1 and (-(-lw // tile_w) * -(-lh // tile_h) * images
                          < 2 * SMS):
        tile_h //= 2
    cols = _span(xs, wx.shape[1], tile_w)
    seg = cols + 2 * radius
    # csrc/pyramid.cu::level_smem_floats
    nbytes = 4 * (tile_h * (seg + cols) + 2 * (2 * radius + 1)
                  + tile_h * (wy.shape[1] + 1) + tile_w * (wx.shape[1] + 1))
    if nbytes > SMEM_MAX:
        raise ValueError(
            f"pyramid_level_cuda: a {h}x{w} -> {lh}x{lw} level of blur "
            f"radius {radius} needs {nbytes} bytes of shared memory a "
            f"block; the kernel takes at most {SMEM_MAX}")
    return tile_h, tile_w, seg, cols, nbytes


def pyramid_level_cuda(images, sigma: float, lh: int, lw: int
                       ) -> tuple[torch.Tensor, ...]:
    """Kernel B8 on one or two contiguous (H, W) float32 or bf16 images of
    one shape and dtype on one CUDA device, in one launch;
    ``pyramid_level_cuda.launches`` counts launches."""
    _check_images("pyramid_level_cuda", images)
    check_cuda("pyramid_level_cuda", *images)
    image = images[0]
    if image.dtype not in DTYPE_CODES:
        raise ValueError(f"pyramid_level_cuda needs float32 or bf16 images, "
                         f"got {image.dtype}")
    if lh < 1 or lw < 1:
        raise ValueError(f"pyramid_level_cuda: bad level size {lh}x{lw}")
    h, w = image.shape
    radius = blur_radius(float(sigma))
    tile_h, tile_w, seg, cols, nbytes = level_plan(h, w, lh, lw, radius,
                                                   len(images))
    device = image.device
    vtaps, htaps = _taps_on(float(sigma), image.dtype, device)
    ystart, yweights = _bands_on(h, lh, device)
    xstart, xweights = _bands_on(w, lw, device)
    outs = [torch.empty((lh, lw), dtype=torch.float32, device=device)
            for _ in images]
    src = [t.data_ptr() for t in images] + [0] * (2 - len(images))
    dst = [t.data_ptr() for t in outs] + [0] * (2 - len(images))
    launch(device, "transflow_pyramid_level", src[0], src[1], len(images),
           DTYPE_CODES[image.dtype], dst[0], dst[1], h, w, lh, lw,
           vtaps.data_ptr(), htaps.data_ptr(), radius, ystart.data_ptr(),
           yweights.data_ptr(), yweights.shape[1], xstart.data_ptr(),
           xweights.data_ptr(), xweights.shape[1], tile_h, tile_w, seg,
           cols, nbytes, cuda_stream(image))
    pyramid_level_cuda.launches += 1
    return tuple(outs)


pyramid_level_cuda.launches = 0


def pyramid_level(images, sigma: float, lh: int, lw: int
                  ) -> tuple[torch.Tensor, ...]:
    """Dispatcher of B8 by the images' device."""
    fn = dispatch("pyramid_level", pyramid_level_plain, pyramid_level_cuda,
                  *images)
    return fn(images, sigma, lh, lw)


# ---------------------------------------------------------------------------
# B14: Lucas-Kanade's reduce
# ---------------------------------------------------------------------------

def downsample2x_plain(images) -> tuple[torch.Tensor, ...]:
    """Each (H, W) image blurred by ``REDUCE_TAPS`` along each axis
    (symmetric padding, float32) and decimated (``[::2, ::2]``)."""
    _check_images("downsample2x_plain", images)
    outs = []
    for x in images:
        tmp = ordered_correlate(x.float(), REDUCE_TAPS, 0, "symmetric")
        blurred = ordered_correlate(tmp, REDUCE_TAPS, 1, "symmetric")
        outs.append(blurred[::2, ::2].contiguous())
    return tuple(outs)


def downsample2x_cuda(images) -> tuple[torch.Tensor, ...]:
    """Kernel B14 on one or two contiguous (H, W) float32 images of one
    shape on one CUDA device, in one launch; counted on
    ``downsample2x_cuda.launches``."""
    _check_images("downsample2x_cuda", images)
    check_cuda("downsample2x_cuda", *images)
    image = images[0]
    if image.dtype != torch.float32:
        raise ValueError(f"downsample2x_cuda needs float32 images, got "
                         f"{image.dtype}")
    h, w = image.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    taps = _reduce_taps_on(image.device)
    outs = [torch.empty((oh, ow), dtype=torch.float32, device=image.device)
            for _ in images]
    src = [t.data_ptr() for t in images] + [0] * (2 - len(images))
    dst = [t.data_ptr() for t in outs] + [0] * (2 - len(images))
    launch(image.device, "transflow_pyramid_reduce", src[0], src[1],
           len(images), dst[0], dst[1], h, w, taps.data_ptr(),
           cuda_stream(image))
    downsample2x_cuda.launches += 1
    return tuple(outs)


downsample2x_cuda.launches = 0


def downsample2x(images) -> tuple[torch.Tensor, ...]:
    """Dispatcher of B14 by the images' device."""
    fn = dispatch("downsample2x", downsample2x_plain, downsample2x_cuda,
                  *images)
    return fn(images)

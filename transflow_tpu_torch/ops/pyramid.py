"""The image pyramids' level construction: kernels B8 (Farneback's
blur-and-resize pyramid), B14 (Lucas-Kanade's pyramid) and B15 (a flow's
resize between levels), in one CUDA source (``csrc/pyramid.cu``).

Counterpart of jnp code that XLA fuses (there is no Pallas source):

- B8 ``pyramid_levels``: transflow_tpu/flow/estimators/farneback.py:
  243-248 (each level) and :211-213 (the ``fb_downscale`` pre-resize),
  ``jax.image.resize(gaussian_blur(img, sigma), (lh, lw), "linear")``: a
  separable Gaussian blur of the full-resolution image with numpy's
  symmetric padding (radius ``int(3 * sigma + 0.5)``, axis 0 first; a
  bf16 image meets taps rounded to bf16, the float32 first pass meets
  float32 taps), then JAX's anti-aliased linear resize to (lh, lw); every
  level of one or two images in one launch (a list of tuples, one a
  level);
- B14 ``lk_pyramid``: transflow_tpu/flow/estimators/lucas_kanade.py:71-78,
  both uint8 frames cast to float32, then transflow_tpu/ops/image.py:234
  ``downsample2x`` (the 5-tap binomial ``[1, 4, 6, 4, 1] / 16`` along
  each axis with symmetric padding, then ``[::2, ::2]``: an odd size
  rounds up) while a level's short side is at least twice the window:
  every level of both frames, the casts included, in one launch (a list
  of (prev, next) tuples, one a level); ``downsample2x``, one reduce of
  one or two float32 images, is the same kernel;
- B15 ``resize_flow``: ``jax.image.resize(flow, (lh, lw, 2), "bilinear")
  * scale`` at transflow_tpu/flow/estimators/farneback.py:216-218, :232,
  :241-242, :267-268 and lucas_kanade.py:84: an (h, w, 2) float32 flow
  resized by JAX's linear bands (``resize_weights``, anti-aliased on a
  downscale) along H, then along W, then times the scale rounded to
  float32 (JAX's weak-typed Python float); an axis of equal size is
  skipped, as JAX skips it.

As in ``ops/farneback.py``, each has a plain PyTorch version (``*_plain``),
a wrapper that launches the hand-written kernel and counts its launches
(``*_cuda``), and a dispatcher by device with no fallback between the two.
Each returns float32 images.

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
bit. XLA leaves the order to itself: its resize of a flow is a dot
product per axis that accumulates with fused multiply-adds, in an axis
order einsum picks by cost, so B15 lies within a few float32 ulps of the
result's largest value of JAX's at whole ratios
(tests/test_torch_flow_resize.py).
"""
import functools
import typing

import numpy as np
import torch

from .._device import DTYPE_CODES, check_cuda, cuda_stream, dispatch, launch
from .image import gaussian_kernel_1d, ordered_correlate, rounded_taps

# B14's taps, the JAX function's float32 constants (the kernel's literals:
# 0.0625, 0.25, 0.375, exact), its reduces a launch (csrc/pyramid.cu:
# kLkMaxDown) and its sources' dtype codes
REDUCE_TAPS = tuple((np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32)
                     / np.float32(16.0)).tolist())
LK_MAX_DOWN = 2
LK_CODES = {torch.float32: 0, torch.uint8: 2}
# csrc/pyramid.cu: B8's threads a block (a tile's segment columns), its
# tiles' most output columns, the tile heights a plan weighs, the sums a
# whole level's column makes from a slab of staged rows, its levels a
# launch and its kinds of level (a whole level; a deep level's rows, then
# its columns); the H100's SMs, the shared memory a block may hold there,
# the most a plan gives a tile where it can choose (three blocks an SM,
# as B8's registers allow) and the most a whole level's tile may take
# (two blocks an SM)
THREADS = 256
MAX_TILE_W = 128
TILE_HEIGHTS = tuple(range(12, 0, -1))
WHOLE_SLAB = 16
MAX_LEVELS = 24
FIELDS = 23
WHOLE, ROWS, COLUMNS = 0, 1, 2
SMS = 132
SMEM_MAX = 232448
SMEM_TARGET = 64 * 1024
SMEM_WHOLE = 96 * 1024


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
    # the weights along ``dim``, broadcast over every other axis
    shape = [1] * x.dim()
    shape[dim] = -1
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


def pyramid_levels_plain(images, levels) -> list[tuple[torch.Tensor, ...]]:
    """``pyramid_level_plain`` of the images at each (sigma, lh, lw) of
    ``levels``: a list of tuples, one a level."""
    return [pyramid_level_plain(images, sigma, lh, lw)
            for sigma, lh, lw in levels]


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


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def layout_bytes(kind: int, itemsize: int, radius: int, ky: int, kx: int,
                 tile_h: int, tile_w: int, seg: int, stage_rows: int) -> int:
    """The shared bytes of a B8 tile (csrc/pyramid.cu::level_layout): the
    ring of ``stage_rows`` staged input rows of the segment (or the
    blurred rows, whichever is larger), the ring of the segment's last ky
    + 7 vertical sums (whole runs of 8; a whole level's), the segment's
    rows, the taps, the tile's row bands and its column bands' starts."""
    v = 16 // itemsize
    taps = 2 * radius + 1
    cols = 0 if kind == ROWS else seg - 2 * radius
    stage = 0 if kind == COLUMNS else (
        stage_rows * ((seg + v - 1) // v * v + v) * itemsize)
    blurred = 0 if kind == ROWS else tile_h * -(-cols // 4) * 4 * 4
    nbytes = _align16(max(stage, blurred)) + _align16(
        tile_h * -(-(seg + 7) // 4) * 4 * 4)
    if kind == WHOLE:
        nbytes += _align16(-(-(ky + 7) // 8) * 8 * -(-seg // 4) * 4 * 4)
    if kind != COLUMNS:
        nbytes += (_align16(taps * 4) + _align16(tile_h * 4)
                   + _align16(tile_h * ky * 4))
    if kind != ROWS:
        nbytes += _align16(taps * 4) + _align16(tile_w * 4)
    return nbytes


def _raise_smem(h: int, w: int, lh: int, lw: int, radius: int,
                nbytes: int):
    raise ValueError(
        f"pyramid_levels_cuda: a {h}x{w} -> {lh}x{lw} level of blur "
        f"radius {radius} needs {nbytes} bytes of shared memory a block; "
        f"the kernel takes at most {SMEM_MAX}")


def _stage_rows(full: int, slab: int, radius: int) -> int:
    """The ring of staged rows for a tile of ``full`` vertical sums made a
    ``slab`` at a time: its rows and the blur's margin where one slab
    makes them all, else two slabs and the margin (the next slab's rows
    are copied while one is summed), whole groups of 8."""
    rows = slab + 2 * radius if slab >= full else 2 * slab + 2 * radius
    return -(-rows // 8) * 8


@functools.lru_cache(maxsize=None)
def _whole_tile(h: int, w: int, lh: int, lw: int, radius: int,
                itemsize: int) -> tuple[int, ...] | None:
    """A ``WHOLE`` entry: the widest tile (at most ``MAX_TILE_W`` columns)
    whose segment fits the block's threads; its sums in one slab, or
    ``WHOLE_SLAB`` at a time where one slab's rows do not fit
    (``_stage_rows``); of the heights in ``TILE_HEIGHTS`` that fit
    ``SMEM_TARGET``, the one that makes the fewest vertical sums an
    output row (a thread makes them 8 at a time), the tallest of equals;
    else one row within ``SMEM_WHOLE``; None where no tile does."""
    ys, wy = resize_weights(h, lh)
    xs, wx = resize_weights(w, lw)
    ky, kx = wy.shape[1], wx.shape[1]
    if kx + 2 * radius > THREADS:
        return None
    tile_w = next(tw for tw in range(min(lw, MAX_TILE_W), 0, -1)
                  if _span(xs, kx, tw) + 2 * radius <= THREADS)
    seg = _span(xs, kx, tile_w) + 2 * radius
    tiles = []
    for th in sorted(TILE_HEIGHTS, reverse=True):
        full = -(-_span(ys, ky, th) // 8) * 8
        for slab in (full, min(full, WHOLE_SLAB)):
            rows = _stage_rows(full, slab, radius)
            nbytes = layout_bytes(WHOLE, itemsize, radius, ky, kx, th,
                                  tile_w, seg, rows)
            if nbytes <= SMEM_TARGET:
                break
        if nbytes <= SMEM_TARGET or th == 1 and not tiles \
                and nbytes <= SMEM_WHOLE:
            tiles.append((full / th, -th, slab, rows, nbytes))
    if not tiles:
        return None
    _, th, slab, rows, nbytes = min(tiles)
    return WHOLE, -th, tile_w, seg, slab, rows, nbytes


def is_deep(h: int, w: int, lh: int, lw: int, radius: int) -> bool:
    """Whether a level of an (h, w) frame takes the deep route: no
    ``WHOLE`` tile of float32 values fits (its one-column segment exceeds
    the block's threads, or one output row's input rows exceed a stage
    within ``SMEM_WHOLE``). Whatever the frame's dtype, so that the
    launches of a pyramid depend on its shapes alone."""
    return _whole_tile(h, w, lh, lw, radius, 4) is None


@functools.lru_cache(maxsize=None)
def level_plan(h: int, w: int, lh: int, lw: int, radius: int,
               itemsize: int) -> tuple[tuple[int, ...], ...]:
    """B8's entries for one level of an (h, w) frame of ``itemsize``-byte
    values: ((kind, tile rows, tile columns, the most segment columns a
    tile reads, slab, staged rows, shared bytes), ...).

    A level that is not deep (``is_deep``) is one ``WHOLE`` entry
    (``_whole_tile``). A deep level is a ``ROWS`` entry (256 frame columns
    a block, the tallest tile that still gives every SM a block, the
    largest slab whose ring of staged rows fits ``SMEM_MAX``: its bands
    are long; its own launch, before the pyramid's)
    and a ``COLUMNS`` entry (the widest tile within ``SMEM_TARGET``).
    Raises where a tile exceeds the H100's shared memory."""
    if not is_deep(h, w, lh, lw, radius):
        return (_whole_tile(h, w, lh, lw, radius, itemsize),)
    ys, wy = resize_weights(h, lh)
    xs, wx = resize_weights(w, lw)
    ky, kx = wy.shape[1], wx.shape[1]
    tile_w = min(THREADS, w)
    th = next((t for t in (8, 4, 2) if t <= lh
               and -(-w // tile_w) * -(-lh // t) * 2 >= SMS), 1)
    full = -(-_span(ys, ky, th) // 8) * 8

    def rows_bytes(slab):
        return layout_bytes(ROWS, itemsize, radius, ky, 0, th, tile_w,
                            tile_w, _stage_rows(full, slab, radius))
    slab = next((s for s in range(full, 0, -8)
                 if rows_bytes(s) <= SMEM_MAX), 8)
    if rows_bytes(slab) > SMEM_MAX:
        _raise_smem(h, w, lh, lw, radius, rows_bytes(slab))
    rows = (ROWS, th, tile_w, tile_w, slab, _stage_rows(full, slab, radius),
            rows_bytes(slab))
    th = min(8, lh)
    for tw in range(min(lw, MAX_TILE_W), 0, -1):
        seg = _span(xs, kx, tw) + 2 * radius
        nbytes = layout_bytes(COLUMNS, itemsize, radius, 0, kx, th, tw, seg,
                              0)
        if nbytes <= SMEM_TARGET:
            break
    if nbytes > SMEM_MAX:
        _raise_smem(h, w, lh, lw, radius, nbytes)
    return rows, (COLUMNS, th, tw, seg, 0, 0, nbytes)


def launches(h: int, w: int, levels) -> int:
    """B8's launches for ``levels`` ((sigma, lh, lw), ...) of an (h, w)
    frame: none for no level; one for up to ``MAX_LEVELS`` levels, and one
    before it where a level is deep (``is_deep``)."""
    deep = sum(is_deep(h, w, lh, lw, blur_radius(float(sigma)))
               for sigma, lh, lw in levels)
    return -(-len(levels) // MAX_LEVELS) + -(-deep // MAX_LEVELS)


def _aligned(floats: int) -> int:
    """``floats`` rounded up to 64 (256 bytes, the allocator's alignment)."""
    return -(-floats // 64) * 64


@functools.lru_cache(maxsize=None)
def _launch_plan(h: int, w: int, dtype: torch.dtype, device: torch.device,
                 levels: tuple, images: int):
    """B8's launches on ``images`` (h, w) images of ``dtype`` on ``device``
    at ``levels``, made once: (launches, shapes, out floats, scratch
    floats). Each launch is (int64 table of ``FIELDS`` a level whose first
    four fields, the sources' and destinations' pointers, are left 0;
    those fields as slots of the call's pointers (0: none, 1 and 2: the
    images, 3: the outputs' buffer, 4: the scratch's) and as byte offsets
    from them; levels; shared bytes): the deep levels' rows first, then
    every level with the largest blur (the longest tiles) first.
    ``shapes`` holds each level's (lh, lw) and its images' offsets in the
    outputs' buffer."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    pad = [(0, 0)] * (2 - images)
    src = [(1 + k, 0) for k in range(images)] + pad
    shapes, rows, whole = [], [], []
    n_out = n_tmp = 0
    for sigma, lh, lw in levels:
        if lh < 1 or lw < 1:
            raise ValueError(f"pyramid_levels_cuda: bad level size "
                             f"{lh}x{lw}")
        radius = blur_radius(float(sigma))
        plan = level_plan(h, w, lh, lw, radius, itemsize)
        vtaps, htaps = _taps_on(float(sigma), dtype, device)
        ystart, yweights = _bands_on(h, lh, device)
        xstart, xweights = _bands_on(w, lw, device)
        common = [vtaps.data_ptr(), htaps.data_ptr(), ystart.data_ptr(),
                  yweights.data_ptr(), xstart.data_ptr(),
                  xweights.data_ptr()]
        bands = [radius, yweights.shape[1], xweights.shape[1]]
        offsets = [n_out + k * _aligned(lh * lw) for k in range(images)]
        n_out += images * _aligned(lh * lw)
        shapes.append((lh, lw, offsets))
        dst = [(3, 4 * o) for o in offsets] + pad
        if len(plan) == 2:  # a deep level: its rows, then its columns
            tmp = [(4, 4 * (n_tmp + k * _aligned(lh * w)))
                   for k in range(images)] + pad
            n_tmp += images * _aligned(lh * w)
            kind, *tile, nbytes = plan[0]
            rows.append((src + tmp, [*common, kind, h, w, lh, w, *bands,
                                     *tile], nbytes, radius))
            kind, *tile, nbytes = plan[1]
            whole.append((tmp + dst, [*common, kind, lh, w, lh, lw, *bands,
                                      *tile], nbytes, radius))
        else:
            kind, *tile, nbytes = plan[0]
            whole.append((src + dst, [*common, kind, h, w, lh, lw, *bands,
                                      *tile], nbytes, radius))
    whole.sort(key=lambda entry: -entry[3])
    launches = []
    for entries in (rows, whole):
        for k in range(0, len(entries), MAX_LEVELS):
            group = entries[k:k + MAX_LEVELS]
            table = np.asarray([[0] * 4 + e[1] for e in group], np.int64)
            slots = np.asarray([[slot for slot, _ in e[0]] for e in group])
            bytes_ = np.asarray([[off for _, off in e[0]] for e in group],
                                np.int64)
            launches.append((table, slots, bytes_, len(group),
                             max(e[2] for e in group)))
    return launches, shapes, n_out, n_tmp


def level_tables(images, levels):
    """(levels, scratch, launches) of B8 on ``images`` at ``levels``
    ((sigma, lh, lw), ...): the new float32 outputs, a tuple a level (views
    of one buffer); the deep levels' (lh, W) float32 rows, which must
    outlive the launches (None without a deep level); and each launch's (int64 table of ``FIELDS`` a
    level, levels, shared bytes) for ``transflow_pyramid_levels``
    (``_launch_plan``)."""
    image = images[0]
    launches, shapes, n_out, n_tmp = _launch_plan(
        *image.shape, image.dtype, image.device,
        tuple(tuple(level) for level in levels), len(images))
    out = torch.empty(n_out, dtype=torch.float32, device=image.device)
    scratch = torch.empty(n_tmp, dtype=torch.float32,
                          device=image.device) if n_tmp else None
    pointers = np.asarray([0, *(t.data_ptr() for t in images),
                           *[0] * (2 - len(images)), out.data_ptr(),
                           0 if scratch is None else scratch.data_ptr()],
                          np.int64)
    tables = []
    for table, slots, offsets, n, nbytes in launches:
        table = table.copy()
        table[:, :4] = pointers[slots] + offsets
        tables.append((table, n, nbytes))
    outs = [tuple(out.as_strided((lh, lw), (lw, 1), o) for o in offsets)
            for lh, lw, offsets in shapes]
    return outs, scratch, tables


def pyramid_levels_cuda(images, levels) -> list[tuple[torch.Tensor, ...]]:
    """Kernel B8 on one or two contiguous (H, W) float32 or bf16 images of
    one shape and dtype on one CUDA device: every level of ``levels``
    ((sigma, lh, lw), ...) in one launch (``launches``: one more before it
    for the deep levels' rows); ``pyramid_levels_cuda.launches`` counts
    launches."""
    _check_images("pyramid_levels_cuda", images)
    check_cuda("pyramid_levels_cuda", *images)
    image = images[0]
    if image.dtype not in DTYPE_CODES:
        raise ValueError(f"pyramid_levels_cuda needs float32 or bf16 "
                         f"images, got {image.dtype}")
    outs, _scratch, launches = level_tables(images, levels)
    for table, n, nbytes in launches:
        launch(image.device, "transflow_pyramid_levels", table.ctypes.data,
               n, len(images), DTYPE_CODES[image.dtype], nbytes,
               cuda_stream(image))
        pyramid_levels_cuda.launches += 1
    return outs


pyramid_levels_cuda.launches = 0


def pyramid_levels(images, levels) -> list[tuple[torch.Tensor, ...]]:
    """Dispatcher of B8 by the images' device: each level of ``levels``
    ((sigma, lh, lw), ...) of one or two images, a tuple a level."""
    fn = dispatch("pyramid_levels", pyramid_levels_plain, pyramid_levels_cuda,
                  *images)
    return fn(images, levels)


# ---------------------------------------------------------------------------
# B14: Lucas-Kanade's pyramid
# ---------------------------------------------------------------------------

def lk_shapes(h: int, w: int, win_size: int, max_level: int
              ) -> list[tuple[int, int]]:
    """The (h, w) of each level of Lucas-Kanade's pyramid of an (h, w)
    frame, L0 first: a level below the last while that one's short side
    is at least twice the window, at most ``max_level`` of them, each
    rounded up (transflow_tpu/flow/estimators/lucas_kanade.py:74-78)."""
    shapes = [(h, w)]
    for _ in range(max_level):
        if min(shapes[-1]) < 2 * win_size:
            break
        lh, lw = shapes[-1]
        shapes.append(((lh + 1) // 2, (lw + 1) // 2))
    return shapes


def lk_launches(levels: int) -> int:
    """B14's launches for a pyramid of ``levels`` levels (L0 included):
    one for the frames' float32 copies and up to ``LK_MAX_DOWN`` reduces,
    one more for each further ``LK_MAX_DOWN``."""
    return 1 + max(0, -(-(levels - 1 - LK_MAX_DOWN) // LK_MAX_DOWN))


def _check_frames(name: str, prev: torch.Tensor, nxt: torch.Tensor) -> None:
    if prev.dim() != 2 or prev.shape != nxt.shape or prev.dtype != \
            torch.uint8 or nxt.dtype != torch.uint8 or \
            prev.device != nxt.device:
        raise ValueError(f"{name} needs two (H, W) uint8 frames of one "
                         f"shape on one device, got {tuple(prev.shape)} "
                         f"{prev.dtype} on {prev.device} and "
                         f"{tuple(nxt.shape)} {nxt.dtype} on {nxt.device}")


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


def lk_pyramid_plain(prev: torch.Tensor, nxt: torch.Tensor, win_size: int,
                     max_level: int) -> list[tuple[torch.Tensor, ...]]:
    """Lucas-Kanade's pyramid of two (H, W) uint8 frames: their float32
    casts (L0), then ``downsample2x_plain`` of both at each level of
    ``lk_shapes``; a (prev, next) tuple a level, L0 first."""
    _check_frames("lk_pyramid_plain", prev, nxt)
    levels = [(prev.float().contiguous(), nxt.float().contiguous())]
    for _ in lk_shapes(*prev.shape, win_size, max_level)[1:]:
        levels.append(downsample2x_plain(levels[-1]))
    return levels


def _lk_table(levels) -> np.ndarray:
    """``transflow_lk_pyramid``'s table: image k's level l at [2 l + k]
    (``levels`` a tuple of images a level, the launch's source first), 0
    where a launch writes no level."""
    table = np.zeros(2 * (LK_MAX_DOWN + 1), np.int64)
    for l, images in enumerate(levels):
        for k, t in enumerate(images):
            table[2 * l + k] = t.data_ptr()
    return table


@functools.lru_cache(maxsize=None)
def _lk_plan(shapes: tuple) -> tuple[int, tuple]:
    """The floats of one buffer that holds every level of both frames
    (``shapes``, L0 first) and each level's (prev, next) offsets in it,
    each 256-byte aligned (``_aligned``)."""
    offsets, n = [], 0
    for lh, lw in shapes:
        offsets.append((n, n + _aligned(lh * lw)))
        n += 2 * _aligned(lh * lw)
    return n, tuple(offsets)


def _lk_launch(device: torch.device, src, code: int, levels, stream: int
               ) -> None:
    """One ``transflow_lk_pyramid`` launch on ``src`` (one or two images of
    dtype ``code``, 0 float32 or 2 uint8): ``levels`` the outputs, a tuple
    a level (the source's float32 copy first, None for a float32 source),
    up to ``LK_MAX_DOWN`` reduces below it."""
    h, w = src[0].shape
    table = _lk_table([() if images is None else images
                       for images in levels])
    launch(device, "transflow_lk_pyramid", src[0].data_ptr(),
           src[-1].data_ptr() if len(src) == 2 else 0, len(src), code,
           table.ctypes.data, h, w, len(levels) - 1, stream)


def lk_pyramid_cuda(prev: torch.Tensor, nxt: torch.Tensor, win_size: int,
                    max_level: int) -> list[tuple[torch.Tensor, ...]]:
    """Kernel B14 on two contiguous (H, W) uint8 frames on one CUDA
    device: every level of ``lk_pyramid_plain``, L0's float32 casts
    included, in ``lk_launches`` launches (one up to ``LK_MAX_DOWN``
    levels below L0), views of one new buffer; counted on
    ``lk_pyramid_cuda.launches``."""
    _check_frames("lk_pyramid_cuda", prev, nxt)
    check_cuda("lk_pyramid_cuda", prev, nxt)
    shapes = tuple(lk_shapes(*prev.shape, win_size, max_level))
    n, offsets = _lk_plan(shapes)
    out = torch.empty(n, dtype=torch.float32, device=prev.device)
    levels = [tuple(out.as_strided((lh, lw), (lw, 1), o) for o in level)
              for (lh, lw), level in zip(shapes, offsets)]
    stream = cuda_stream(prev)
    src, code, first = (prev, nxt), LK_CODES[torch.uint8], 0
    while True:
        last = min(first + LK_MAX_DOWN, len(levels) - 1)
        _lk_launch(prev.device, src, code,
                   [None if code == LK_CODES[torch.float32] else levels[0],
                    *levels[first + 1:last + 1]], stream)
        lk_pyramid_cuda.launches += 1
        if last == len(levels) - 1:
            return levels
        src, code, first = levels[last], LK_CODES[torch.float32], last


lk_pyramid_cuda.launches = 0


def lk_pyramid(prev: torch.Tensor, nxt: torch.Tensor, win_size: int,
               max_level: int) -> list[tuple[torch.Tensor, ...]]:
    """Dispatcher of B14 by the frames' device: Lucas-Kanade's pyramid of
    two (H, W) uint8 frames, a (prev, next) float32 tuple a level, L0
    first."""
    fn = dispatch("lk_pyramid", lk_pyramid_plain, lk_pyramid_cuda, prev, nxt)
    return fn(prev, nxt, win_size, max_level)


def downsample2x_cuda(images) -> tuple[torch.Tensor, ...]:
    """Kernel B14 on one or two contiguous (H, W) float32 images of one
    shape on one CUDA device: one reduce, in one launch; counted on
    ``downsample2x_cuda.launches``."""
    _check_images("downsample2x_cuda", images)
    check_cuda("downsample2x_cuda", *images)
    image = images[0]
    if image.dtype != torch.float32:
        raise ValueError(f"downsample2x_cuda needs float32 images, got "
                         f"{image.dtype}")
    h, w = image.shape
    outs = tuple(torch.empty(((h + 1) // 2, (w + 1) // 2),
                             dtype=torch.float32, device=image.device)
                 for _ in images)
    _lk_launch(image.device, tuple(images), LK_CODES[torch.float32],
               [None, outs], cuda_stream(image))
    downsample2x_cuda.launches += 1
    return outs


downsample2x_cuda.launches = 0


def downsample2x(images) -> tuple[torch.Tensor, ...]:
    """Dispatcher of B14's one reduce by the images' device."""
    fn = dispatch("downsample2x", downsample2x_plain, downsample2x_cuda,
                  *images)
    return fn(images)


# ---------------------------------------------------------------------------
# B15: a flow's resize between levels, times a scale
# ---------------------------------------------------------------------------

def _check_flow(name: str, flow: torch.Tensor, lh: int, lw: int) -> None:
    if flow.dim() != 3 or flow.shape[2] != 2 or \
            flow.dtype != torch.float32 or lh < 1 or lw < 1:
        raise ValueError(f"{name} needs an (h, w, 2) float32 flow and a "
                         f"positive size, got {tuple(flow.shape)} "
                         f"{flow.dtype} -> ({lh}, {lw})")


# csrc/pyramid.cu: B15's tiles a plan weighs, the tallest first (a width
# a power of two, a thread two adjacent outputs); the blocks its grid
# should reach, near two an SM (fewer leave SMs idle; more, smaller tiles
# pay each block's fixed latency more often: PERF.md §6, B15); the
# shared bytes a block may hold without an opt-in; the narrower one-row
# tiles of a downscale whose bands fit no other
RESIZE_TILES = ((32, 128), (32, 64), (16, 128), (16, 64), (8, 128), (8, 64),
                (4, 128), (4, 64), (2, 128), (2, 64), (1, 128), (1, 64))
RESIZE_BLOCKS = 240
RESIZE_SMEM = 48 * 1024
RESIZE_NARROW = (32, 16, 8, 4, 2)


class ResizePlan(typing.NamedTuple):
    """B15's tile (``resize_plan``): a block's output rows and columns; the
    input rows it stages (``resize_extent``), of which ``slab`` at once;
    the input columns it stages (even); its shared bytes."""
    tile_h: int
    tile_w: int
    row_lead: int
    rows: int
    slab: int
    col_lead: int
    pitch: int
    smem: int

    @property
    def args(self) -> tuple[int, ...]:
        """The plan as ``transflow_flow_resize_tiled`` takes it."""
        return self[:7]


def resize_bytes(ky: int, kx: int, tile_h: int, tile_w: int, slab: int,
                 pitch: int) -> int:
    """The shared bytes of a B15 block (csrc/pyramid.cu:
    ``resize_band_words``): its rows' and columns' band starts (int32) and
    weights (float32), 16-byte aligned; ``slab`` staged input rows and
    ``tile_h`` rows of vertical sums, ``pitch`` float2 each."""
    return _align16(4 * (tile_h * (1 + ky) + tile_w * (1 + kx))) + \
        8 * pitch * (slab + tile_h)


def _resize_place(t0: np.ndarray, n: int, m: int) -> np.ndarray:
    """Outputs ``t0``'s place along an axis of ``n`` inputs and ``m``
    outputs, as csrc/pyramid.cu::resize_first computes it: t0 times n / m,
    each rounded to float32, truncated."""
    ratio = np.float32(n) / np.float32(m)
    return np.trunc(t0.astype(np.float32) * ratio).astype(np.int64)


def resize_extent(starts: np.ndarray, taps: int, n: int, tile: int,
                  even: bool) -> tuple[int, int]:
    """(lead, span) of B15's staged inputs along an axis of ``n`` inputs
    for tiles of ``tile`` outputs: the least lead and span (even where
    ``even``) that give every tile every band it reads, where a tile
    stages ``span`` inputs from ``lead`` before its place
    (``_resize_place``), from at least 0 (an even column where ``even``)
    and at most ``n - span`` (csrc/pyramid.cu::resize_first): no band's
    start is loaded before the copies."""
    m = len(starts)
    t0 = np.arange(0, m, tile)
    s = starts.astype(np.int64)
    end = s[np.minimum(t0 + tile, m) - 1] + taps
    place = _resize_place(t0, n, m)
    lead = max(0, int((place - s[t0]).max()))
    begin = np.maximum(place - lead, 0)
    if even:
        begin &= ~1
    # the clamp to n - span moves a first input only down, to an end of n
    span = int((end - begin).max())
    return lead, span + span % 2 if even else span


@functools.lru_cache(maxsize=None)
def resize_plan(h: int, w: int, lh: int, lw: int) -> ResizePlan:
    """B15's tile for a resize of (h, w) to (lh, lw): the first of
    ``RESIZE_TILES`` whose bands, staged inputs and vertical sums fit
    ``RESIZE_SMEM`` and whose grid reaches ``RESIZE_BLOCKS`` blocks, else
    the fitting one with the most blocks; where none fits, one row of
    ``RESIZE_NARROW`` columns, the narrowest staging its input rows a slab
    at a time (a downscale by a few hundred). Raises where not even one
    input row of that tile fits."""
    ystart, yweights = resize_weights(h, lh)
    xstart, xweights = resize_weights(w, lw)
    ky, kx = yweights.shape[1], xweights.shape[1]

    def plan(tile_h, tile_w):
        row_lead, rows = resize_extent(ystart, ky, h, tile_h, False)
        col_lead, pitch = resize_extent(xstart, kx, w, tile_w, True)
        return ResizePlan(tile_h, tile_w, row_lead, rows, rows, col_lead,
                          pitch, resize_bytes(ky, kx, tile_h, tile_w, rows,
                                              pitch))

    fits = [p for p in (plan(*tile) for tile in RESIZE_TILES)
            if p.smem <= RESIZE_SMEM]
    if fits:
        blocks = [-(-lh // p.tile_h) * -(-lw // p.tile_w) for p in fits]
        enough = [p for p, n in zip(fits, blocks) if n >= RESIZE_BLOCKS]
        return enough[0] if enough else fits[blocks.index(max(blocks))]
    for tile_w in RESIZE_NARROW:
        narrow = plan(1, tile_w)
        if narrow.smem <= RESIZE_SMEM:
            return narrow
    pitch = narrow.pitch
    slab = (RESIZE_SMEM - resize_bytes(ky, kx, 1, narrow.tile_w, 0, pitch)
            ) // (8 * pitch)
    if slab < 1:
        raise ValueError(f"resize_flow: {w} -> {lw} columns leave no room "
                         f"for an input row in {RESIZE_SMEM} bytes of "
                         "shared memory")
    return narrow._replace(slab=slab, smem=resize_bytes(
        ky, kx, 1, narrow.tile_w, slab, pitch))


def resize_flow_plain(flow: torch.Tensor, lh: int, lw: int,
                      scale: float) -> torch.Tensor:
    """The (h, w, 2) float32 ``flow`` resized to (lh, lw) by the bands of
    ``resize_weights`` along H, then along W (an axis of equal size
    skipped), then times ``scale`` rounded to float32; (lh, lw, 2)
    float32."""
    _check_flow("resize_flow_plain", flow, lh, lw)
    h, w = flow.shape[:2]
    out = flow if lh == h else _resize_axis(flow, lh, 0)
    out = out if lw == w else _resize_axis(out, lw, 1)
    return out * float(np.float32(scale))


def resize_flow_cuda(flow: torch.Tensor, lh: int, lw: int,
                     scale: float) -> torch.Tensor:
    """Launch kernel B15 on a contiguous (h, w, 2) float32 flow on a CUDA
    device: the resize and the scale in one launch of ``resize_plan``'s
    tiles, into a new contiguous (lh, lw, 2) flow;
    ``resize_flow_cuda.launches`` counts launches. The bands are copied to
    the card once per size (``_bands_on``)."""
    _check_flow("resize_flow_cuda", flow, lh, lw)
    check_cuda("resize_flow_cuda", flow)
    h, w = flow.shape[:2]
    plan = resize_plan(h, w, lh, lw)
    ystart, yweights = _bands_on(h, lh, flow.device)
    xstart, xweights = _bands_on(w, lw, flow.device)
    out = torch.empty((lh, lw, 2), dtype=torch.float32, device=flow.device)
    launch(flow.device, "transflow_flow_resize_tiled", flow.data_ptr(),
           ystart.data_ptr(), yweights.data_ptr(), xstart.data_ptr(),
           xweights.data_ptr(), out.data_ptr(), h, w, lh, lw,
           yweights.shape[1], xweights.shape[1], float(np.float32(scale)),
           *plan.args, cuda_stream(flow))
    resize_flow_cuda.launches += 1
    return out


resize_flow_cuda.launches = 0


def resize_flow(flow: torch.Tensor, lh: int, lw: int,
                scale: float) -> torch.Tensor:
    """Dispatcher of B15 by the flow's device: ``jax.image.resize(flow,
    (lh, lw, 2), "bilinear") * scale``."""
    fn = dispatch("resize_flow", resize_flow_plain, resize_flow_cuda, flow)
    return fn(flow, lh, lw, scale)

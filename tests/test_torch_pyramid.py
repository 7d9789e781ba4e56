"""The image pyramids' level construction (kernels B8 and B14's plain
versions, ``transflow_tpu_torch/ops/pyramid.py``) against the JAX
package's, on the CPU.

The same seeded numpy images go through JAX on the CPU (``jax.image.resize``
of ``gaussian_blur``, and ``downsample2x``) and through the port's plain
versions, which the estimators run on CPU tensors; on the card the kernels
equal these plain versions bit for bit (tests/test_torch_cuda.py).
"""
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_flow_ops import shifted_pair
from transflow_tpu.ops import image as jimage
from transflow_tpu_torch.ops import image, pyramid

fb = importlib.import_module("transflow_tpu_torch.flow.estimators.farneback")
lke = importlib.import_module(
    "transflow_tpu_torch.flow.estimators.lucas_kanade")

BF16, F32 = torch.bfloat16, torch.float32
JAX_DTYPE = {BF16: jnp.bfloat16, F32: jnp.float32}
SHAPES = [(96, 144), (135, 240), (67, 121)]
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "assets", "configs")


def _jax_weights(in_size: int, out_size: int) -> np.ndarray:
    """JAX's (in, out) weight matrix: one-hot columns through
    ``jax.image.resize(..., "linear")`` (each output is one weight times 1
    plus zeros, so the matrix comes out exact)."""
    eye = jnp.eye(in_size, dtype=jnp.float32)
    return np.asarray(jax.image.resize(eye, (out_size, in_size),
                                       "linear")).T


def _dense(in_size: int, out_size: int) -> np.ndarray:
    starts, weights = pyramid.resize_weights(in_size, out_size)
    dense = np.zeros((in_size, out_size), np.float32)
    for i in range(out_size):
        for k in range(weights.shape[1]):
            dense[min(starts[i] + k, in_size - 1), i] += weights[i, k]
    return dense


# (in, out, bound on |port - JAX|): whole ratios bit-equal; elsewhere XLA
# fuses the sample position's multiply-add in some of its loops, which
# moves a weight by up to one float32 ulp of the position (measured 2.2e-6
# at 144 -> 115 and 3.8e-6 on the upscale 68 -> 135; <= 3e-8 at the
# others)
RESIZES = [(96, 48, 0.0), (1080, 540, 0.0), (1920, 240, 0.0),
           (1080, 17, 5e-9), (135, 68, 3e-8), (96, 77, 3e-8),
           (1080, 864, 6e-8), (144, 115, 2.5e-6), (68, 135, 4e-6),
           (37, 37, 0.0)]


@pytest.mark.parametrize("in_size,out_size,tol", RESIZES,
                         ids=[f"{a}->{b}" for a, b, _ in RESIZES])
def test_resize_weights_match_jax(in_size, out_size, tol):
    """``resize_weights`` is JAX's linear resize matrix as bands: bit-equal
    at whole ratios and at an equal size (the identity), within ``tol``
    elsewhere; the bands start in ascending order and each output's
    weights sum to 1 within float32 rounding."""
    starts, weights = pyramid.resize_weights(in_size, out_size)
    assert starts.dtype == np.int32 and weights.dtype == np.float32
    assert weights.shape[0] == out_size and np.all(np.diff(starts) >= 0)
    assert starts.min() >= 0 and starts.max() <= in_size - 1
    got, want = _dense(in_size, out_size), _jax_weights(in_size, out_size)
    if tol == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(weights.sum(axis=1), 1.0, rtol=0, atol=2e-6)


# (name, scale): Farneback's levels at pyr_scale 0.5 (fb_downscale 2, 4
# and 8 resize the frame to the same sizes with the same sigmas), and the
# first level at fb_pyr_scale 0.8 (sizes no whole ratio gives)
LEVELS = [("L1", 0.5), ("L2", 0.25), ("L3", 0.125), ("pyr_scale 0.8", 0.8)]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("level,scale", LEVELS, ids=[n for n, _ in LEVELS])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pyramid_level_plain_matches_jax(shape, level, scale, dtype):
    """B8's plain version on both images of a level against
    ``jax.image.resize(gaussian_blur(x, sigma), (lh, lw), "linear")``:
    within 5e-7 of the largest value (the blur) plus 6e-5 on [0, 255] (the
    resize), plus, where XLA's weights move (the non-whole ratios of
    ``test_resize_weights_match_jax``), the largest value times the most
    any output's weights differ from JAX's (summed |difference| over its
    band, along each axis; 0 at whole ratios). Each image of the pair
    equals its level alone."""
    h, w = shape
    lh, lw = int(round(h * scale)), int(round(w * scale))
    sigma = (1.0 / scale - 1.0) * 0.5
    rng = np.random.default_rng(5)
    xs = [rng.uniform(0, 255, shape).astype(np.float32) for _ in range(2)]
    if dtype == BF16:  # the card's frame: integers, exact in bf16
        xs = [np.round(x) for x in xs]
    images = [torch.from_numpy(x).to(dtype) for x in xs]
    got = pyramid.pyramid_level_plain(images, sigma, lh, lw)
    assert len(got) == 2
    moved = sum(np.abs(_dense(n, m) - _jax_weights(n, m)).sum(axis=0).max()
                for n, m in ((h, lh), (w, lw)))
    for x, t, out in zip(xs, images, got):
        assert out.dtype == F32 and out.shape == (lh, lw)
        want = np.asarray(jax.image.resize(
            jimage.gaussian_blur(jnp.asarray(x).astype(JAX_DTYPE[dtype]),
                                 sigma), (lh, lw), "linear"))
        top = np.abs(want).max()
        np.testing.assert_allclose(out.numpy(), want, rtol=0,
                                   atol=5e-7 * top + 6e-5 + top * moved)
        assert torch.equal(out, pyramid.pyramid_level_plain((t,), sigma, lh,
                                                            lw)[0])


@pytest.mark.parametrize("shape", SHAPES + [(7, 5), (30, 31)], ids=str)
def test_downsample2x_plain_matches_jax(shape):
    """B14's plain version on both images against JAX's ``downsample2x``:
    within 4e-7 of the largest value on float images; an odd size rounds
    up; ``ops/image.py::downsample2x`` (the JAX name) is the same
    function."""
    rng = np.random.default_rng(6)
    xs = [rng.uniform(0, 255, shape).astype(np.float32) for _ in range(2)]
    got = pyramid.downsample2x_plain([torch.from_numpy(x) for x in xs])
    for x, out in zip(xs, got):
        want = np.asarray(jimage.downsample2x(jnp.asarray(x)))
        assert out.shape == want.shape == ((shape[0] + 1) // 2,
                                           (shape[1] + 1) // 2)
        assert out.is_contiguous() and out.dtype == F32
        np.testing.assert_allclose(out.numpy(), want, rtol=0,
                                   atol=4e-7 * np.abs(want).max())
        assert torch.equal(image.downsample2x(torch.from_numpy(x)), out)


@pytest.mark.parametrize("settings,per_frame", [
    ({}, (4, 12, 12, 1)),
    ({"downscale": 2}, (4, 12, 12, 2)),
    ({"downscale": 8, "levels": 1}, (2, 6, 6, 2)),
    ({"pyr_scale": 0.8}, (4, 12, 12, 1)),
    ({"levels": 8}, (7, 21, 21, 2)),
    ({"levels": 8, "pyr_scale": 0.1}, (2, 6, 6, 1))],
    ids=["defaults", "downscale 2", "downscale 8", "pyr_scale 0.8",
         "levels 8", "pyr_scale 0.1"])
def test_launch_rule_at_1080p(settings, per_frame):
    """``launches_per_frame`` at 1080x1920: (B1, B2a, B2b, B8), B8 one for
    every level below L0, one more where a level is deep (fb_levels 8's
    deepest, radius 95) and one for the ``downscale`` pre-resize."""
    assert fb.launches_per_frame(1080, 1920, **settings) == per_frame


@pytest.mark.parametrize("settings", [dict(downscale=3, pyr_scale=0.8),
                                      dict(levels=8, pyr_scale=0.6)],
                         ids=["downscale 3 pyr_scale 0.8", "levels 8"])
def test_launch_rule_counts_calls(settings, monkeypatch):
    """Farneback calls B8 (its plain version here) as often as
    ``launches_per_frame`` says (no level of a 90x160 frame is deep), both
    images a call: the pre-resize, then every level below L0 in one
    call."""
    calls = []
    plain = pyramid.pyramid_levels_plain

    def counted(images, levels):
        calls.append((len(images), len(levels)))
        return plain(images, levels)

    monkeypatch.setattr(pyramid, "pyramid_levels_plain", counted)
    a, b = shifted_pair(90, 160, dx=1, dy=1)
    fb.farneback(torch.from_numpy(a), torch.from_numpy(b), **settings)
    h, w = (round(n / settings.get("downscale", 1)) for n in (90, 160))
    below = len(fb._level_shapes(h, w, settings["pyr_scale"],
                                 settings.get("levels", 3), 5)) - 1
    want = [(2, 1)] * ("downscale" in settings) + [(2, below)]
    assert calls == want
    assert len(calls) == fb.launches_per_frame(90, 160, **settings)[3]


@pytest.mark.parametrize("h,w,pyr_scale,levels", [
    (96, 144, 0.5, 3), (67, 121, 0.8, 4), (135, 240, 0.5, 2)], ids=str)
def test_pyramid_levels_plain_equals_each_level(h, w, pyr_scale, levels):
    """``pyramid_levels_plain`` (B8's plain version, every level in one
    call) is ``pyramid_level_plain`` at each level, bit for bit, in bf16
    and float32."""
    rng = np.random.default_rng(8)
    below = fb._pyramid_levels(fb._level_shapes(h, w, pyr_scale, levels, 5))
    for dtype in (BF16, F32):
        images = [torch.from_numpy(np.round(rng.uniform(0, 255, (h, w)))
                                   .astype(np.float32)).to(dtype)
                  for _ in range(2)]
        got = pyramid.pyramid_levels_plain(images, below)
        assert len(got) == len(below)
        for (sigma, lh, lw), outs in zip(below, got):
            want = pyramid.pyramid_level_plain(images, sigma, lh, lw)
            assert all(torch.equal(a, b) for a, b in zip(outs, want))


# (name, pyr_scale, levels, the deep levels' indices below L0) at 1080p
PLANS = [("defaults", 0.5, 3, []), ("pyr_scale 0.8", 0.8, 3, []),
         ("levels 8", 0.5, 8, [3, 4, 5]), ("pyr_scale 0.1", 0.1, 8, [])]


@pytest.mark.parametrize("name,pyr_scale,levels,deep", PLANS,
                         ids=[p[0] for p in PLANS])
def test_pyramid_plan_at_1080p(name, pyr_scale, levels, deep):
    """B8's plan of a 1080p pyramid: every level one ``WHOLE`` entry (a
    segment of at most 256 columns, a thread each; at most 16 rows; a
    slab a multiple of 8 and a ring of staged rows that holds it and the
    blur's margin; within ``SMEM_TARGET``, or one row within
    ``SMEM_WHOLE``) except the deep ones,
    which are a ``ROWS`` entry (256 frame columns a block) and a
    ``COLUMNS`` entry within the H100's shared memory; one launch, one
    more where a level is deep; the table ``level_tables`` would pass,
    ``FIELDS`` int64 a level, the rows first, then the largest blur."""
    below = fb._pyramid_levels(fb._level_shapes(1080, 1920, pyr_scale,
                                                levels, 5))
    for itemsize in (2, 4):
        for k, (sigma, lh, lw) in enumerate(below):
            radius = pyramid.blur_radius(sigma)
            plan = pyramid.level_plan(1080, 1920, lh, lw, radius, itemsize)
            assert pyramid.is_deep(1080, 1920, lh, lw, radius) == (k in deep)
            for kind, th, tw, seg, slab, rows, nbytes in plan:
                assert 1 <= th <= 16 and tw >= 1
                assert nbytes == pyramid.layout_bytes(
                    kind, itemsize, radius, *(
                        pyramid.resize_weights(n, m)[1].shape[1]
                        for n, m in ((1080, lh), (1920, lw))), th, tw, seg,
                    rows) <= pyramid.SMEM_MAX
                if kind != pyramid.COLUMNS:
                    assert slab % 8 == 0 and seg <= pyramid.THREADS
                    assert rows % 8 == 0 and rows >= slab + 2 * radius
            kinds = [entry[0] for entry in plan]
            if k in deep:
                assert kinds == [pyramid.ROWS, pyramid.COLUMNS]
                assert plan[0][2] == plan[0][3] == pyramid.THREADS
            else:
                assert kinds == [pyramid.WHOLE]
                assert plan[0][6] <= pyramid.SMEM_TARGET or (
                    plan[0][1] == 1 and plan[0][6] <= pyramid.SMEM_WHOLE)
    assert pyramid.launches(1080, 1920, below) == 1 + bool(deep)
    x = torch.zeros((1080, 1920), dtype=BF16)
    outs, scratch, launches = pyramid.level_tables((x, x), below)
    assert (0 if scratch is None else scratch.numel()) == sum(
        2 * pyramid._aligned(below[k][1] * 1920) for k in deep)
    assert [[t.shape for t in level] for level in outs] == [
        [(lh, lw)] * 2 for _, lh, lw in below]
    assert [n for _, n, _ in launches] == [len(deep)] * bool(deep) + [
        len(below)]
    table = launches[-1][0]
    assert table.shape == (len(below), pyramid.FIELDS)
    radii = [pyramid.blur_radius(s) for s, _, _ in below]
    assert list(table[:, 15]) == sorted(radii, reverse=True)


def test_lucas_kanade_reduces_both_images_a_launch(monkeypatch):
    """Lucas-Kanade makes its whole pyramid, both frames' casts included,
    in one ``lk_pyramid`` call a frame pair (its plain version here), on
    the uint8 frames; chip_smoke's rule counts 1 B14 launch a frame of
    ``lukas-kanade.json`` at 1080p."""
    import chip_smoke
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    calls = []
    plain = pyramid.lk_pyramid_plain

    def counted(prev, nxt, win_size, max_level):
        calls.append((prev.dtype, nxt.dtype, win_size, max_level))
        return plain(prev, nxt, win_size, max_level)

    monkeypatch.setattr(pyramid, "lk_pyramid_plain", counted)
    a, b = shifted_pair(96, 128, dx=1, dy=1)
    lke.lucas_kanade(torch.from_numpy(a), torch.from_numpy(b), max_level=2)
    assert calls == [(torch.uint8, torch.uint8, 15, 2)]
    config = CvFlowConfig.from_file(os.path.join(CONFIGS,
                                                 "lukas-kanade.json"))
    row = chip_smoke.h_per_frame(config, 1080, 1920)
    assert row[chip_smoke.KERNEL_NAMES.index("B14")] == 1


def _jax_lk_pyramid(a, b, win_size, max_level):
    """JAX's pyramid (transflow_tpu/flow/estimators/lucas_kanade.py:71-78):
    ``astype(float32)``, then jitted ``downsample2x`` of each image while
    the last level's short side is at least twice the window."""
    down = jax.jit(jimage.downsample2x)
    pyr = [(jnp.asarray(a).astype(jnp.float32),
            jnp.asarray(b).astype(jnp.float32))]
    for _ in range(max_level):
        if min(pyr[-1][0].shape) < 2 * win_size:
            break
        pyr.append(tuple(down(x) for x in pyr[-1]))
    return [tuple(np.asarray(x) for x in level) for level in pyr]


@pytest.mark.parametrize("win_size", [4, 15])
@pytest.mark.parametrize("max_level", range(5))
@pytest.mark.parametrize("shape", [(37, 53), (64, 96), (96, 128)], ids=str)
def test_lk_pyramid_plain_matches_jax(shape, max_level, win_size):
    """B14's plain version (the frames' float32 casts, then
    ``downsample2x_plain`` of both at each level) against the JAX package's
    cast and ``downsample2x`` chain on seeded uint8 frames, odd and even
    sizes, with windows that stop the pyramid early: the same levels,
    float32 and contiguous, shaped as ``lk_shapes`` says. L0-L2 are
    bit-equal: every product and sum there is exact in float32 (integers,
    then multiples of 1/256, then of 1/65536, within 24 bits), so any
    order of addition gives the same bits. Below L2 a value needs more
    bits and XLA's convolution adds in its own order: within 4e-7 of the
    largest value, ``test_downsample2x_plain_matches_jax``'s bound
    (measured: 1 ulp)."""
    rng = np.random.default_rng(sum(shape) + max_level)
    a, b = (rng.integers(0, 256, shape, dtype=np.uint8) for _ in "ab")
    got = pyramid.lk_pyramid(torch.from_numpy(a), torch.from_numpy(b),
                             win_size, max_level)
    want = _jax_lk_pyramid(a, b, win_size, max_level)
    shapes = pyramid.lk_shapes(*shape, win_size, max_level)
    assert len(got) == len(want) == len(shapes)
    for k, (level, expected, lshape) in enumerate(zip(got, want, shapes)):
        assert len(level) == 2
        for out, ref in zip(level, expected):
            assert out.dtype == F32 and out.is_contiguous()
            assert tuple(out.shape) == ref.shape == lshape
            if k <= 2:
                np.testing.assert_array_equal(out.numpy(), ref)
            else:
                np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                           atol=4e-7 * np.abs(ref).max())


@pytest.mark.parametrize("shape,win_size,max_level,levels,launches", [
    ((1080, 1920), 15, 2, 3, 1), ((1080, 1920), 15, 0, 1, 1),
    ((1080, 1920), 15, 4, 5, 2), ((1080, 1920), 300, 4, 2, 1),
    ((37, 53), 4, 4, 4, 2), ((7, 5), 1, 8, 4, 2), ((64, 64), 15, 3, 3, 1)],
    ids=str)
def test_lk_launch_rule(shape, win_size, max_level, levels, launches):
    """``lk_shapes``' levels (the estimator's stop rule) and B14's launches
    for them: one up to two levels below L0, one more for each two
    beyond; ``lk_pyramid_plain`` makes as many levels."""
    shapes = pyramid.lk_shapes(*shape, win_size, max_level)
    assert len(shapes) == levels and shapes[0] == shape
    for (h, w), (lh, lw) in zip(shapes, shapes[1:]):
        assert (lh, lw) == ((h + 1) // 2, (w + 1) // 2)
        assert min(h, w) >= 2 * win_size
    assert pyramid.lk_launches(levels) == launches
    if shape[0] < 100:
        x = torch.zeros(shape, dtype=torch.uint8)
        assert len(pyramid.lk_pyramid_plain(x, x, win_size,
                                            max_level)) == levels


def test_reduce_taps_are_the_kernels_literals():
    """B14's kernel multiplies by the literals 0.0625, 0.25 and 0.375: the
    JAX function's float32 taps, exactly."""
    assert pyramid.REDUCE_TAPS == (0.0625, 0.25, 0.375, 0.25, 0.0625)
    assert np.array_equal(np.float32(pyramid.REDUCE_TAPS), np.asarray(
        jnp.asarray([1.0, 4.0, 6.0, 4.0, 1.0], dtype=jnp.float32) / 16.0))


def test_lk_pyramid_refuses_misuse():
    """B14's pyramid takes two (H, W) uint8 frames of one shape: float
    frames, mismatched shapes and a 3-D frame raise, on the CPU as through
    the wrapper."""
    x = torch.zeros((16, 24), dtype=torch.uint8)
    for prev, nxt in ((x.float(), x.float()), (x, x[:, :20]),
                      (x[None], x[None]), (x, x.to(torch.int16))):
        for fn in (pyramid.lk_pyramid, pyramid.lk_pyramid_plain,
                   pyramid.lk_pyramid_cuda):
            with pytest.raises(ValueError, match="uint8 frames"):
                fn(prev, nxt, 4, 2)


def test_level_plan_narrows_deep_levels():
    """B8's tiles: at cv2's default levels of a 1080p bf16 frame, the
    height of at most ``TILE_HEIGHTS``' tallest that makes the fewest
    vertical sums an output row within ``SMEM_TARGET`` (11 rows at L1 and
    L2, 9 at L3) and a segment of at most 256 columns, a thread each, the
    sums in one slab where its rows fit (L1, L2), else ``WHOLE_SLAB`` at a
    time through a ring of two slabs' rows and the blur's margin (L3);
    fb_levels 8's deepest
    level (radius 95, whose one-column segment is 318 columns) takes the
    deep route: its rows 256 frame columns a block, as many rows a slab as
    the H100's shared memory holds, its columns a tile within
    ``SMEM_TARGET``; a level whose tile exceeds the H100's shared memory
    raises with the bytes it needs."""
    for (lh, lw, sigma), height in zip(((540, 960, 0.5), (270, 480, 1.5),
                                        (135, 240, 3.5)), (11, 11, 9)):
        radius = pyramid.blur_radius(sigma)
        (entry,) = pyramid.level_plan(1080, 1920, lh, lw, radius, 2)
        kind, tile_h, tile_w, seg, slab, rows, nbytes = entry
        assert kind == pyramid.WHOLE and tile_h == height
        assert seg <= pyramid.THREADS and nbytes <= pyramid.SMEM_TARGET
        ys, wy = pyramid.resize_weights(1080, lh)
        full = -(-pyramid._span(ys, wy.shape[1], tile_h) // 8) * 8
        assert slab == (full if sigma < 3 else pyramid.WHOLE_SLAB)
        assert rows == pyramid._stage_rows(full, slab, radius)
    radius = pyramid.blur_radius(31.5)
    assert radius == 95
    rows, columns = pyramid.level_plan(1080, 1920, 17, 30, radius, 2)
    kx = pyramid.resize_weights(1920, 30)[1].shape[1]
    assert kx + 2 * radius == 318 > pyramid.THREADS
    assert rows[:4] == (pyramid.ROWS, 2, 256, 256)
    ys, wy = pyramid.resize_weights(1080, 17)
    full = -(-pyramid._span(ys, wy.shape[1], 2) // 8) * 8
    assert rows[6] <= pyramid.SMEM_MAX
    assert rows[4] == full or pyramid.layout_bytes(
        pyramid.ROWS, 2, radius, wy.shape[1], 0, 2, 256, 256,
        pyramid._stage_rows(full, rows[4] + 8, radius)) > pyramid.SMEM_MAX
    assert columns[0] == pyramid.COLUMNS and columns[3] >= kx + 2 * radius
    assert columns[6] <= pyramid.SMEM_TARGET
    with pytest.raises(ValueError, match="bytes of shared memory"):
        pyramid.level_plan(16, 60000, 16, 12, 60000, 4)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only (no plain path hides
    in them, no launch is counted); the dispatchers send CPU tensors to
    the plain versions."""
    x = torch.zeros((16, 24))
    with pytest.raises(ValueError, match="CUDA"):
        pyramid.pyramid_levels_cuda((x, x), [(0.5, 8, 12)])
    with pytest.raises(ValueError, match="CUDA"):
        pyramid.downsample2x_cuda((x,))
    frame = torch.zeros((16, 24), dtype=torch.uint8)
    before = pyramid.lk_pyramid_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        pyramid.lk_pyramid_cuda(frame, frame, 4, 2)
    assert pyramid.lk_pyramid_cuda.launches == before
    assert pyramid.pyramid_levels((x, x), [(0.5, 8, 12)])[0][1].shape == (
        8, 12)
    assert pyramid.downsample2x((x,))[0].shape == (8, 12)
    assert [level[1].shape for level in pyramid.lk_pyramid(
        frame, frame, 5, 2)] == [(16, 24), (8, 12)]

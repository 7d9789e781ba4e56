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
    ({}, (4, 12, 12, 3)),
    ({"downscale": 2}, (4, 12, 12, 4)),
    ({"downscale": 8, "levels": 1}, (2, 6, 6, 2)),
    ({"pyr_scale": 0.8}, (4, 12, 12, 3)),
    ({"levels": 8}, (7, 21, 21, 6)),
    ({"levels": 8, "pyr_scale": 0.1}, (2, 6, 6, 1))],
    ids=["defaults", "downscale 2", "downscale 8", "pyr_scale 0.8",
         "levels 8", "pyr_scale 0.1"])
def test_launch_rule_at_1080p(settings, per_frame):
    """``launches_per_frame`` at 1080x1920: (B1, B2a, B2b, B8), B8 one a
    level below L0 and one for the ``downscale`` pre-resize."""
    assert fb.launches_per_frame(1080, 1920, **settings) == per_frame


@pytest.mark.parametrize("settings", [dict(downscale=3, pyr_scale=0.8),
                                      dict(levels=8, pyr_scale=0.6)],
                         ids=["downscale 3 pyr_scale 0.8", "levels 8"])
def test_launch_rule_counts_calls(settings, monkeypatch):
    """Farneback calls B8 (its plain version here) as often as
    ``launches_per_frame`` says, both images a call."""
    calls = []
    plain = pyramid.pyramid_level_plain

    def counted(images, *args):
        calls.append(len(images))
        return plain(images, *args)

    monkeypatch.setattr(pyramid, "pyramid_level_plain", counted)
    a, b = shifted_pair(90, 160, dx=1, dy=1)
    fb.farneback(torch.from_numpy(a), torch.from_numpy(b), **settings)
    assert calls == [2] * fb.launches_per_frame(90, 160, **settings)[3]


def test_lucas_kanade_reduces_both_images_a_launch(monkeypatch):
    """Lucas-Kanade calls B14 once a level below L0 with both images;
    chip_smoke's rule counts 2 a frame of ``lukas-kanade.json`` at
    1080p."""
    import chip_smoke
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    calls = []
    plain = pyramid.downsample2x_plain

    def counted(images):
        calls.append(len(images))
        return plain(images)

    monkeypatch.setattr(pyramid, "downsample2x_plain", counted)
    a, b = shifted_pair(96, 128, dx=1, dy=1)
    lke.lucas_kanade(torch.from_numpy(a), torch.from_numpy(b), max_level=2)
    assert calls == [2, 2]
    config = CvFlowConfig.from_file(os.path.join(CONFIGS,
                                                 "lukas-kanade.json"))
    row = chip_smoke.h_per_frame(config, 1080, 1920)
    assert row[chip_smoke.KERNEL_NAMES.index("B14")] == 2


def test_level_plan_narrows_deep_levels():
    """B8's tile: 8 output rows and a segment of at most 256 columns (a
    thread each) within 48 KB of shared memory at cv2's default levels of
    a 1080p frame; fb_levels 8's deepest level (radius 95) one output
    column whose segment (318 columns) its threads walk in turns, within
    the H100's shared memory; a level whose tile exceeds it raises with
    the bytes it needs."""
    for lh, lw, sigma in ((540, 960, 0.5), (270, 480, 1.5),
                          (135, 240, 3.5)):
        tile_h, tile_w, seg, cols, nbytes = pyramid.level_plan(
            1080, 1920, lh, lw, pyramid.blur_radius(sigma))
        assert tile_h == 8 and seg <= pyramid.THREADS
        assert nbytes <= 48 * 1024
    radius = pyramid.blur_radius(31.5)
    assert radius == 95
    tile_h, tile_w, seg, cols, nbytes = pyramid.level_plan(1080, 1920, 17,
                                                           30, radius)
    assert tile_w == 1 and seg == cols + 2 * radius > pyramid.THREADS
    assert 4 * tile_h * (seg + cols) < nbytes <= pyramid.SMEM_MAX
    with pytest.raises(ValueError, match="bytes of shared memory"):
        pyramid.level_plan(16, 60000, 16, 12, 60000)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers take CUDA tensors only (no plain path hides
    in them); the dispatchers send CPU tensors to the plain versions."""
    x = torch.zeros((16, 24))
    with pytest.raises(ValueError, match="CUDA"):
        pyramid.pyramid_level_cuda((x, x), 0.5, 8, 12)
    with pytest.raises(ValueError, match="CUDA"):
        pyramid.downsample2x_cuda((x,))
    assert pyramid.pyramid_level((x, x), 0.5, 8, 12)[1].shape == (8, 12)
    assert pyramid.downsample2x((x,))[0].shape == (8, 12)

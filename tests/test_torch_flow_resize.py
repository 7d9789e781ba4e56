"""A flow's resize between levels times a scale (kernel B15's plain
version, ``transflow_tpu_torch/ops/pyramid.py::resize_flow_plain``)
against ``jax.image.resize(flow, (lh, lw, 2), "bilinear") * s``, on the
CPU, at the shapes and scales of the estimators' five call sites.

The port resizes by ``resize_weights``' bands along H, then along W, each
product and sum rounded, then multiplies by the scale rounded to float32.
XLA takes each axis as a dot product that accumulates with fused
multiply-adds, in an axis order einsum picks by cost, so the two differ
by float32 roundings: at most 2 ulps of the result's largest value at
the whole ratios below (``WHOLE_ULPS`` allows 4). Where the ratio is not
whole
JAX's own weights move (tests/test_torch_pyramid.py::
test_resize_weights_match_jax), and the bar adds the largest input value
times the scale times the most any output's weights move, summed over
both axes (measured 6.2e-5 against a bar of 1.1e-4 at 34x61 -> 67x121).
On the card B15 equals the plain version bit for bit
(tests/test_torch_cuda.py).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_cuda import RESIZE_CASES
from test_torch_pyramid import _dense, _jax_weights
from transflow_tpu_torch.ops import pyramid

fb = importlib.import_module("transflow_tpu_torch.flow.estimators.farneback")

# ulps of the result's largest value a whole ratio may differ by
WHOLE_ULPS = 4
# (name, (h, w), (lh, lw), scale): Farneback's last level change at
# pyr_scale 0.5 on a 96x144 frame (the fast preset's x2 upscale to full
# size has the same shapes) and at 0.8, the fastest preset's x4, the
# pre-resizes of a warm start (1 / 2, 1 / 4), Lucas-Kanade's level changes
# on a 67x121 frame (not whole: 34 -> 67), and a warm start of equal size
CASES = [("flagship and fast x2", (48, 72), (96, 144), 2.0),
         ("pyr_scale 0.8", (77, 115), (96, 144), 1.25),
         ("fastest x4", (24, 36), (96, 144), 4.0),
         ("downscale 1/2", (96, 144), (48, 72), 0.5),
         ("downscale 1/4", (96, 144), (24, 36), 0.25),
         ("lk 17x31", (17, 31), (34, 61), 2.0),
         ("lk 34x61", (34, 61), (67, 121), 2.0),
         ("equal size", (24, 36), (24, 36), 0.5)]


def _flow(shape, seed: int = 7) -> np.ndarray:
    return (4 * np.random.default_rng(seed).standard_normal((*shape, 2))
            ).astype(np.float32)


def _jax_resize(flow: np.ndarray, lh: int, lw: int, s: float) -> np.ndarray:
    return np.asarray(jax.jit(
        lambda f: jax.image.resize(f, (lh, lw, 2), "bilinear") * s)(flow))


def _moved(n: int, m: int) -> float:
    """The most any output's weights differ from JAX's, summed over its
    band (0 at whole ratios and at an equal size)."""
    if n == m:
        return 0.0
    return float(np.abs(_dense(n, m) - _jax_weights(n, m)).sum(axis=0).max())


@pytest.mark.parametrize("name,src,dst,scale", CASES,
                         ids=[c[0] for c in CASES])
def test_resize_flow_plain_matches_jax(name, src, dst, scale):
    """Within ``WHOLE_ULPS`` ulps of the largest value of JAX's result,
    plus, where JAX's weights move, the largest input value times the
    scale times their summed move along each axis; an equal size is the
    flow times the scale exactly, as JAX skips the resize."""
    flow = _flow(src)
    (h, w), (lh, lw) = src, dst
    got = pyramid.resize_flow_plain(torch.from_numpy(flow), lh, lw, scale)
    want = _jax_resize(flow, lh, lw, scale)
    assert got.shape == want.shape == (lh, lw, 2) and got.is_contiguous()
    if (h, w) == (lh, lw):
        np.testing.assert_array_equal(got.numpy(), want)
        return
    bar = WHOLE_ULPS * np.spacing(np.abs(want).max()) + \
        np.abs(flow).max() * scale * (_moved(h, lh) + _moved(w, lw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=bar)


def test_resize_flow_plain_rounds_the_scale_to_float32():
    """The scale is rounded to float32 before the product, as JAX's
    weak-typed Python float is: 0.1 gives ``round(x * float32(0.1))``."""
    flow = _flow((8, 10))
    got = pyramid.resize_flow_plain(torch.from_numpy(flow), 8, 10, 0.1)
    np.testing.assert_array_equal(got.numpy(), flow * np.float32(0.1))
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_resize(flow, 8, 10, 0.1))


def test_resize_flow_plain_is_each_axis_in_turn():
    """The plain version is ``_resize_axis`` along H, then W, on the flow's
    own axes (each channel resized alone gives the same values)."""
    flow = torch.from_numpy(_flow((17, 31)))
    got = pyramid.resize_flow_plain(flow, 34, 61, 1.0)
    for c in range(2):
        plane = pyramid._resize_axis(pyramid._resize_axis(
            flow[..., c], 34, 0), 61, 1)
        assert torch.equal(got[..., c], plane)


def test_resize_flow_dispatch_and_checks(monkeypatch):
    """CPU flows take the plain version (the kernel's wrapper is never
    called); a flow on another device has no path; a flow that is not
    (h, w, 2) float32, or a size below 1, raises; the wrapper refuses a
    CPU flow before any launch."""
    def refuse(*args):
        raise AssertionError("the kernel's wrapper ran on a CPU tensor")

    monkeypatch.setattr(pyramid, "resize_flow_cuda", refuse)
    flow = torch.from_numpy(_flow((6, 8)))
    assert torch.equal(pyramid.resize_flow(flow, 12, 16, 2.0),
                       pyramid.resize_flow_plain(flow, 12, 16, 2.0))
    with pytest.raises(ValueError, match="no path for device meta"):
        pyramid.resize_flow(torch.zeros((4, 6, 2), device="meta"), 8, 12,
                            2.0)
    for bad, size in ((flow[..., 0], (12, 16)), (flow.double(), (12, 16)),
                      (flow, (0, 16))):
        with pytest.raises(ValueError, match="float32 flow"):
            pyramid.resize_flow_plain(bad, *size, 2.0)
    monkeypatch.undo()
    before = pyramid.resize_flow_cuda.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        pyramid.resize_flow_cuda(flow, 12, 16, 2.0)
    assert pyramid.resize_flow_cuda.launches == before


@pytest.mark.parametrize("settings", [
    {"downscale": 2}, {"pyr_scale": 0.8}, {"downscale": 4, "flags": 4}],
    ids=["fast", "pyr_scale 0.8", "warm fastest"])
def test_farneback_resizes_through_b15(settings, monkeypatch):
    """Farneback resizes its flow through ``resize_flow`` alone, with the
    JAX sites' scales (each level's ratio, ``downscale`` and its inverse),
    as often as ``launches_per_frame`` says, and stays within the
    estimator's 60 dB of JAX (tests/test_torch_farneback.py; its
    ``E2E_CASES`` hold the other presets to JAX)."""
    from test_torch_farneback import _flow_psnr, _jax, _warped_pair
    calls = []
    plain = pyramid.resize_flow_plain

    def counted(flow, lh, lw, scale):
        calls.append((tuple(flow.shape[:2]), (lh, lw), scale))
        return plain(flow, lh, lw, scale)

    monkeypatch.setattr(pyramid, "resize_flow_plain", counted)
    a, b, _ = _warped_pair(96, 144, seed=5)
    prev = _flow((96, 144), seed=8) / 2
    got = fb.farneback(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(prev), **settings).numpy()
    assert len(calls) == fb.launches_per_frame(96, 144, **settings)[4]
    down = settings.get("downscale", 1)
    if down > 1:
        assert calls[-1] == ((round(96 / down), round(144 / down)),
                             (96, 144), float(down))
    if settings.get("flags"):
        assert calls[0] == ((96, 144), calls[-1][0], 1.0 / down)
    assert _flow_psnr(got, _jax(a, b, prev, **settings)) >= 60.0


def _level_changes() -> list[tuple[int, int, int, int]]:
    """(h, w, lh, lw) of every resize the estimators make on a 1080x1920
    and an odd 721x1283 frame: Farneback's level changes at
    ``fb_pyr_scale`` 0.5 and 0.8 (cv2's 3 levels), a warm start to the
    coarsest level, ``fb_downscale`` 2 and 4's pre-resize of the warm
    start and upscale to full size, and ``lukas-kanade.json``'s level
    changes."""
    changes = set()
    for full_h, full_w in ((1080, 1920), (721, 1283)):
        for down, scales in ((1, (0.5, 0.8)), (2, (0.5,)), (4, (0.5,))):
            h, w = round(full_h / down), round(full_w / down)
            for pyr_scale in scales:
                shapes = fb._level_shapes(h, w, pyr_scale, 3, 5)
                changes.add((h, w, *shapes[-1][:2]))
                changes.update((*a[:2], *b[:2])
                               for a, b in zip(shapes[1:], shapes))
            if down > 1:
                changes.update({(full_h, full_w, h, w),
                                (h, w, full_h, full_w)})
        levels = pyramid.lk_shapes(full_h, full_w, 15, 2)
        changes.update((*a, *b) for a, b in zip(levels[1:], levels))
    return sorted(changes)


PLAN_CASES = sorted({(*src, *dst) for src, dst, _ in RESIZE_CASES}
                    | set(_level_changes()))


def _staged(t0: int, n: int, m: int, lead: int, span: int,
            even: bool) -> tuple[int, int]:
    """The first input and the count B15's tile from output ``t0`` stages
    along an axis, as csrc/pyramid.cu::resize_first and the kernel
    compute them (the place in float32: t0 times n / m)."""
    place = int(np.float32(t0) * (np.float32(n) / np.float32(m)))
    first = max(place - lead, 0)
    first = min(first - first % 2 if even else first, max(n - span, 0))
    return first, min(span, n - first)


@pytest.mark.parametrize("h,w,lh,lw", PLAN_CASES, ids=str)
def test_resize_plan_stages_every_band(h, w, lh, lw):
    """B15's tile plan (``resize_plan``): every output's row band lies in
    the input rows its tile stages (a slab at a time) and its column band
    in the columns staged from an even column, all inside the flow, the
    column count even where the width is (16-byte pairs); the shared
    bytes stay within ``RESIZE_SMEM``; a tile that does not stage its rows
    at once is one output row."""
    plan = pyramid.resize_plan(h, w, lh, lw)
    ystart, yweights = pyramid.resize_weights(h, lh)
    xstart, xweights = pyramid.resize_weights(w, lw)
    ky, kx = yweights.shape[1], xweights.shape[1]
    assert (plan.tile_h, plan.tile_w) in pyramid.RESIZE_TILES or (
        plan.tile_h == 1 and plan.tile_w in pyramid.RESIZE_NARROW)
    assert plan.smem == pyramid.resize_bytes(
        ky, kx, plan.tile_h, plan.tile_w, plan.slab, plan.pitch) <= \
        pyramid.RESIZE_SMEM
    assert plan.pitch % 2 == 0 and 1 <= plan.slab <= plan.rows
    assert plan.slab == plan.rows or plan.tile_h == 1
    for i0 in range(0, lh, plan.tile_h):
        first, count = _staged(i0, h, lh, plan.row_lead, plan.rows, False)
        bands = ystart[i0:i0 + plan.tile_h].astype(np.int64)
        assert 0 <= first <= bands.min() and bands.max() + ky <= first + \
            count <= h
    for j0 in range(0, lw, plan.tile_w):
        first, count = _staged(j0, w, lw, plan.col_lead, plan.pitch, True)
        bands = xstart[j0:j0 + plan.tile_w].astype(np.int64)
        assert first % 2 == 0 or w % 2
        assert 0 <= first <= bands.min() and bands.max() + kx <= first + \
            count <= w
        assert count % 2 == 0 or w % 2


def test_resize_plan_fills_the_card_within_the_budget():
    """The flagship's L1->L0 and ``fastest``'s 4x take a 32 x 128 tile
    (510 blocks), its smaller level changes smaller tiles for at least
    ``RESIZE_BLOCKS`` blocks, ``fb_pyr_scale`` 0.8's wider bands a 32 x 64
    one; the warm start's 4- and 8-tap downscales shrink the tile to fit
    ``RESIZE_SMEM``; a downscale by 120 stages its input rows a slab at a
    time on a one-output-row tile; a resize whose one input row does not
    fit raises."""
    assert pyramid.resize_plan(540, 960, 1080, 1920)[:2] == (32, 128)
    assert pyramid.resize_plan(270, 480, 1080, 1920)[:2] == (32, 128)
    assert pyramid.resize_plan(864, 1536, 1080, 1920)[:2] == (32, 64)
    assert pyramid.resize_plan(270, 480, 540, 960)[:2] == (32, 64)
    assert pyramid.resize_plan(135, 240, 270, 480)[:2] == (8, 64)
    assert pyramid.resize_plan(1080, 1920, 540, 960)[:2] == (8, 64)
    assert pyramid.resize_plan(1080, 1920, 270, 480)[:2] == (2, 64)
    plan = pyramid.resize_plan(1080, 1920, 9, 16)
    assert plan.tile_h == 1 and plan.slab < plan.rows
    with pytest.raises(ValueError, match="no room"):
        pyramid.resize_plan(8, 9000, 4, 1)

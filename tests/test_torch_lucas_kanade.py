"""The port's Lucas-Kanade (kernels B11 and B12's plain versions, the
pyramid, the estimator) against the JAX package's, on the CPU.

The same seeded numpy frames go through ``jax.jit`` on the CPU and through
the port. The flows are held within 1e-4 of JAX's: the port rounds every
product, XLA fuses some into FMAs and takes the Scharr and box sums in its
own order (measured within 4e-6 on a pan and on unrelated frames).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_flow_ops import shifted_pair
from transflow_tpu.ops import image as jimage
from transflow_tpu_torch.flow.estimators import get_estimator
from transflow_tpu_torch.flow.estimators.lucas_kanade import lucas_kanade
from transflow_tpu_torch.ops import image
from transflow_tpu_torch.ops import lucas_kanade as lk

jlk_module = importlib.import_module(
    "transflow_tpu.flow.estimators.lucas_kanade")
jax_lucas_kanade = jlk_module.lucas_kanade
LK_ESTIMATOR = importlib.import_module(
    "transflow_tpu_torch.flow.estimators.lucas_kanade")

SHAPES = [(96, 128), (135, 241)]
FLOW_TOL = 1e-4


def _port(a, b, **kwargs):
    return lucas_kanade(torch.from_numpy(a), torch.from_numpy(b),
                        **kwargs).numpy()


def _jax(a, b, **kwargs):
    return np.asarray(jax_lucas_kanade(jnp.asarray(a), jnp.asarray(b),
                                       **kwargs))


# ---------------------------------------------------------------------------
# the pyramid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES + [(7, 5), (30, 31)], ids=str)
def test_downsample2x_matches_jax(shape):
    """On integer images the blur is exact: bit-equal; on the level below
    (multiples of 1/256, still exact) too; an odd size rounds up."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape).astype(np.float32)
    down = jax.jit(jimage.downsample2x)
    got = image.downsample2x(torch.from_numpy(img))
    want = np.asarray(down(img))
    assert got.shape == want.shape == ((shape[0] + 1) // 2,
                                       (shape[1] + 1) // 2)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    if min(want.shape) > 1:
        np.testing.assert_array_equal(image.downsample2x(got).numpy(),
                                      np.asarray(down(want)))


def test_level_shapes_stop_like_jax(monkeypatch):
    """The pyramid stops once a level's short side is below twice the
    window: 64x64 at window 15 keeps levels 64, 32 and 16 of max_level 3
    (16 < 30 ends it)."""
    a, b = shifted_pair(64, 64, dx=1, dy=0)
    calls = []
    plain = lk.lk_structure_tensor_plain

    def counted(ix, iy, win):
        calls.append(tuple(ix.shape))
        return plain(ix, iy, win)

    monkeypatch.setattr(LK_ESTIMATOR, "lk_structure_tensor", counted)
    got = _port(a, b, max_level=3)
    assert calls == [(16, 16), (32, 32), (64, 64)]
    np.testing.assert_allclose(got, _jax(a, b, max_level=3), atol=FLOW_TOL)


# ---------------------------------------------------------------------------
# B11 and B12
# ---------------------------------------------------------------------------

def _planes(shape, seed=1):
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, shape).astype(np.float32)
    nxt = rng.integers(0, 256, shape).astype(np.float32)
    ix = rng.standard_normal(shape).astype(np.float32) * 20
    iy = rng.standard_normal(shape).astype(np.float32) * 20
    return prev, nxt, ix, iy


@jax.jit
def _jax_products(prev, nxt, ix, iy, flow):
    """lucas_kanade.py:50-54: the warp and the two products."""
    h, w = prev.shape
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    warped = jimage.bilinear_sample_packed(
        jimage.prepack_bilinear_taps(nxt), yy + flow[..., 1],
        xx + flow[..., 0])[..., 0]
    it = warped - prev
    return jnp.stack([ix * it, iy * it])


@pytest.mark.parametrize("flows", ["small", "beyond", "inf-nan"])
@pytest.mark.parametrize("shape", [(33, 47), (96, 128)], ids=str)
def test_warp_products_match_jax(shape, flows):
    """Flows within the frame, far beyond it (1e20: the anchor saturates
    at the edge, as XLA's conversion does) and with inf and NaN entries
    (NaN where JAX's are NaN)."""
    prev, nxt, ix, iy = _planes(shape)
    rng = np.random.default_rng(2)
    flow = (rng.standard_normal((*shape, 2)) * 3).astype(np.float32)
    if flows == "beyond":
        flow[::3] *= 1e20
        flow[1::3] = -flow[1::3] * 1e6
    elif flows == "inf-nan":
        flow.reshape(-1)[::7] = np.nan
        flow.reshape(-1)[3::11] = np.inf
        flow.reshape(-1)[5::13] = -np.inf
    got = lk.lk_warp_products(*map(torch.from_numpy,
                                   (prev, nxt, ix, iy, flow))).numpy()
    want = np.asarray(_jax_products(prev, nxt, ix, iy, flow))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    if flows == "inf-nan":
        assert np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("win", [15, 4, 31, 63])
@pytest.mark.parametrize("shape", [(33, 47), (5, 3)], ids=str)
def test_structure_tensor_and_solve_match_jax(shape, win):
    """B12's two modes against lucas_kanade.py:36-42 and :53-60, on the
    Scharr derivatives of a smooth image and the products of a pan."""
    a, b = shifted_pair(*shape, dx=2, dy=1, seed=3)
    prev, nxt = a.astype(np.float32), b.astype(np.float32)
    ix, iy = (d.numpy() for d in lk.lk_scharr(torch.from_numpy(prev)))
    flow = np.zeros((*shape, 2), np.float32)
    prods = lk.lk_warp_products(*map(torch.from_numpy,
                                     (prev, nxt, ix, iy, flow))).numpy()

    @jax.jit
    def jax_level(ix, iy, prods, flow):
        box = jimage.box_filter
        g11, g12, g22 = (box(ix * ix, win), box(ix * iy, win),
                         box(iy * iy, win))
        det = g11 * g22 - g12 * g12
        valid = det > 1e-6
        inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)
        b1, b2 = -box(prods[0], win), -box(prods[1], win)
        du = (g22 * b1 - g12 * b2) * inv_det
        dv = (g11 * b2 - g12 * b1) * inv_det
        small = (du * du + dv * dv) < 0.01 * 0.01
        du = jnp.where(small, 0.0, du)
        dv = jnp.where(small, 0.0, dv)
        return (jnp.stack([g11, g12, g22, inv_det]),
                flow + jnp.stack([du, dv], axis=-1))

    tensor = lk.lk_structure_tensor(torch.from_numpy(ix),
                                    torch.from_numpy(iy), win)
    got = lk.lk_window_solve(torch.from_numpy(prods), tensor,
                             torch.from_numpy(flow), win, 0.01)
    want_tensor, want = map(np.asarray, jax_level(ix, iy, prods, flow))
    # the window sums in two orders: a few ulp of the largest sum
    scale = np.abs(want_tensor[:3]).max()
    np.testing.assert_allclose(tensor.numpy()[:3], want_tensor[:3],
                               rtol=1e-5, atol=1e-6 * scale)
    np.testing.assert_allclose(tensor.numpy()[3], want_tensor[3],
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_flat_image_has_no_valid_solve():
    """A flat image: every gradient 0, det 0, inv_det 0 everywhere, and the
    flow stays 0 on both sides."""
    flat = np.full((64, 80), 117, np.uint8)
    zero = torch.zeros((64, 80))
    tensor = lk.lk_structure_tensor(zero, zero, 15)
    assert not tensor.any()
    got = _port(flat, flat)
    assert not got.any()
    np.testing.assert_array_equal(got, _jax(flat, flat))
    # a flat first image and a textured second: still no valid solve
    tex, _ = shifted_pair(64, 80)
    np.testing.assert_array_equal(_port(flat, tex), _jax(flat, tex))


def test_dispatch_by_device():
    t = torch.zeros((4, 6), device="meta")
    flow = torch.zeros((4, 6, 2), device="meta")
    with pytest.raises(ValueError, match="no path for device meta"):
        lk.lk_warp_products(t, t, t, t, flow)
    with pytest.raises(ValueError, match="no path for device meta"):
        lk.lk_structure_tensor(t, t, 15)
    with pytest.raises(ValueError, match="no path for device meta"):
        lk.lk_window_solve(torch.zeros((2, 4, 6), device="meta"),
                           torch.zeros((4, 4, 6), device="meta"), flow, 15,
                           0.01)
    assert get_estimator("lukas-kanade") is lucas_kanade


# ---------------------------------------------------------------------------
# the estimator against JAX
# ---------------------------------------------------------------------------

CASES = {"defaults": {}, "step-4": dict(step=4), "step-16": dict(step=16),
         "level-0": dict(max_level=0), "level-3": dict(max_level=3),
         "window-7": dict(win_size=7, iters=4)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_lucas_kanade_matches_jax_on_a_pan(shape, case):
    a, b = shifted_pair(*shape, dx=3, dy=2)
    got = _port(a, b, **CASES[case])
    want = _jax(a, b, **CASES[case])
    assert got.shape == want.shape == (*shape, 2)
    np.testing.assert_allclose(got, want, atol=FLOW_TOL, rtol=0)
    assert np.abs(want).max() > 1.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_lucas_kanade_matches_jax_on_unrelated_frames(shape):
    """Two crops of different textures: flows up to tens of px."""
    a, _ = shifted_pair(*shape, seed=5)
    b, _ = shifted_pair(*shape, seed=6)
    got = _port(a, b)
    want = _jax(a, b)
    np.testing.assert_allclose(got, want, atol=FLOW_TOL, rtol=0)
    assert np.abs(want).max() > 5.0


# ---------------------------------------------------------------------------
# the JAX package's own bars, on the port
# ---------------------------------------------------------------------------

def test_lucas_kanade_translation():
    """tests/test_flow_ops.py::test_lucas_kanade_translation."""
    a, b = shifted_pair(96, 128, dx=3, dy=2)
    flow = _port(a, b, win_size=15, max_level=2)
    interior = flow[20:-20, 20:-20]
    assert abs(np.median(interior[..., 0]) - 3) < 0.5
    assert abs(np.median(interior[..., 1]) - 2) < 0.5


def test_lucas_kanade_step():
    """tests/test_flow_ops.py::test_lucas_kanade_step: macroblocks."""
    a, b = shifted_pair(64, 64, dx=1, dy=0)
    flow = _port(a, b, win_size=15, max_level=1, step=16)
    assert flow.shape == (64, 64, 2)
    block = flow[0:16, 0:16]
    assert np.all(block == block[0, 0])

"""The port's Farneback against the JAX package's, on the CPU.

The same seeded numpy inputs go through each JAX function (eager or
jitted on the CPU, as tests/test_flow_ops.py runs it) and through its port
(on CPU tensors the plain versions of kernels B1, B2a and B2b). The port
also meets the JAX package's quality bars against cv2 goldens made here
(the port never imports cv2), on tests/test_flow_ops.py's image pairs.
"""
import importlib
import json
import os

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax
import jax.numpy as jnp

from test_flow_ops import _warped_pair, shifted_pair
from transflow_tpu.ops import image as jimage
from transflow_tpu.ops import select_warp as jselect
from transflow_tpu_torch.flow.estimators import get_estimator
from transflow_tpu_torch.ops import farneback as ops_fb
from transflow_tpu_torch.ops import image, select_warp

# the estimators packages rebind ``farneback`` to the function: go
# through importlib for the module objects
jfb = importlib.import_module("transflow_tpu.flow.estimators.farneback")
fb = importlib.import_module("transflow_tpu_torch.flow.estimators.farneback")

BF16, F32 = torch.bfloat16, torch.float32
JAX_DTYPE = {BF16: jnp.bfloat16, F32: jnp.float32}
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "assets", "configs")


def _flow_psnr(flow, ref):
    """tests/test_flow_ops.py::_flow_psnr: PSNR at an 8 px peak (inf where
    the flows are equal)."""
    mse = float(np.mean((np.asarray(flow) - np.asarray(ref)) ** 2))
    return 10 * np.log10(8.0 ** 2 / mse) if mse else np.inf


def _cv2_flow(a, b, iterations=3):
    import cv2
    return cv2.calcOpticalFlowFarneback(a, b, None, 0.5, 3, 15, iterations,
                                        5, 1.2, 0)


def _port(a, b, prev_flow=None, **kwargs):
    prev_flow = None if prev_flow is None else torch.from_numpy(prev_flow)
    return fb.farneback(torch.from_numpy(a), torch.from_numpy(b), prev_flow,
                        **kwargs).numpy()


def _jax(a, b, prev_flow=None, **kwargs):
    prev_flow = None if prev_flow is None else jnp.asarray(prev_flow)
    return np.asarray(jfb.farneback(jnp.asarray(a), jnp.asarray(b), prev_flow,
                                    **kwargs))


@pytest.fixture
def bf16_storage(monkeypatch):
    """bf16 planes on both sides (each package's accelerator default): the
    JAX trace cache is emptied before and after, so no trace of either
    storage dtype reaches another test."""
    monkeypatch.setattr(jfb, "_storage_dtype", lambda: jnp.bfloat16)
    monkeypatch.setattr(fb, "_storage_dtype", lambda device: BF16)
    jfb.farneback.clear_cache()
    yield
    jfb.farneback.clear_cache()


# ---------------------------------------------------------------------------
# ops/image.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("pad", [0, 1, 4, 11, 23])
def test_symmetric_pad_is_numpys(n, pad):
    x = torch.arange(n)
    got = image.pad_axis(x, 0, pad, pad + 1, "symmetric")
    np.testing.assert_array_equal(
        got.numpy(), np.pad(np.arange(n), (pad, pad + 1), mode="symmetric"))


# pyramid shapes of a 64x96 frame, and an odd one
SHAPES = [(64, 96), (32, 48), (67, 121)]


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["symmetric", "constant"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_separable_correlate_matches_jax(shape, axis, mode, dtype):
    """float32 sums in two orders (XLA's and cuDNN's or oneDNN's): within
    4e-7 of the largest output (measured <= 2.1e-7); bf16 inputs meet
    bf16 taps, exact products."""
    x = np.random.default_rng(0).uniform(0, 255, shape).astype(np.float32)
    k = np.asarray(jimage.gaussian_kernel_1d(1.5, 5))
    got = image.separable_correlate(torch.from_numpy(x).to(dtype), k, axis,
                                    mode)
    want = np.asarray(jimage.separable_correlate(
        jnp.asarray(x).astype(JAX_DTYPE[dtype]), k, axis, mode))
    assert got.dtype == F32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4e-7 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_box_and_gaussian_blur_match_jax(shape, dtype):
    """Box sums of 15 (bf16: the vertical sum rounded to bf16, measured
    equal) and the pyramid's blur (sigma 3.5, radius 11): within 5e-7 of
    the largest output (measured <= 3.2e-7)."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, shape).astype(np.float32)
    tx, jx = torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(
        JAX_DTYPE[dtype])
    for got, want in ((image.box_filter(tx, 15), jimage.box_filter(jx, 15)),
                      (image.gaussian_blur(tx, 3.5),
                       jimage.gaussian_blur(jx, 3.5))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=5e-7 * np.abs(want).max())
    np.testing.assert_allclose(image.gaussian_kernel_1d(4.5, 7).numpy(),
                               np.asarray(jimage.gaussian_kernel_1d(4.5, 7)),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("src,dst", [((64, 96), (32, 48)),
                                     ((135, 240), (68, 120)),
                                     ((270, 480), (135, 240)),
                                     ((540, 960), (270, 480)),
                                     ((67, 121), (34, 60))], ids=str)
def test_antialiased_resize_matches_jax_linear(src, dst):
    """``bilinear_resize`` is ``jax.image.resize(..., "linear")``, which
    anti-aliases on a downscale: within 6e-5 on [0, 255] images (measured
    <= 4.6e-5); torch's resize without anti-aliasing is ~100 away."""
    x = np.random.default_rng(2).uniform(0, 255, src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "linear"))
    got = image.bilinear_resize(torch.from_numpy(x), *dst)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=6e-5)
    plain = image.torch_bilinear_resize(torch.from_numpy(x), *dst)
    assert np.abs(plain.numpy() - want).max() > 1.0


@pytest.mark.parametrize("src,dst", [((34, 60), (68, 120)),
                                     ((68, 120), (135, 240)),
                                     ((24, 32), (96, 128)),
                                     ((67, 121), (135, 241))], ids=str)
def test_flow_upsample_matches_jax_bilinear(src, dst):
    """Flows between levels: ``jax.image.resize(..., "bilinear")`` upsamples
    as ``bilinear_resize`` does, within 4e-6 on flows of |v| <= 14
    (measured <= 1.9e-6, also where the factor is not whole)."""
    flow = (4 * np.random.default_rng(3).standard_normal((*src, 2))
            ).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(flow), (*dst, 2),
                                              "bilinear"))
    got = image.bilinear_resize(torch.from_numpy(flow), *dst)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=4e-6)


def _naive_sample(img, yy, xx):
    """tests/test_flow_ops.py::TestBilinearSample._naive: clamped anchors,
    unclamped weights, each product rounded."""
    h, w = img.shape[:2]
    y0 = np.floor(yy)
    x0 = np.floor(xx)
    wy = (yy - y0).astype(np.float32)
    wx = (xx - x0).astype(np.float32)
    y0 = np.clip(y0.astype(np.int32), 0, h - 1)
    x0 = np.clip(x0.astype(np.int32), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    if img.ndim == 3:
        wy, wx = wy[..., None], wx[..., None]
    top = img[y0, x0] * (1 - wx) + img[y0, x1] * wx
    bot = img[y1, x0] * (1 - wx) + img[y1, x1] * wx
    return top * (1 - wy) + bot * wy


@pytest.mark.parametrize("shape", [(23, 31), (23, 31, 5), (1, 7), (9, 1, 3)],
                         ids=str)
def test_bilinear_sample_matches_jax(shape):
    """f32, coordinates in range, sub-pixel and far outside: bit-equal to
    JAX's CPU run (eager: each product rounded, as the port rounds it) and
    to the naive four-gather rule; the packed form equals the one-shot."""
    rng = np.random.default_rng(4)
    h, w = shape[:2]
    img = rng.standard_normal(shape).astype(np.float32)
    yy = rng.uniform(-2 * h, 3 * h, (h, w)).astype(np.float32)
    xx = rng.uniform(-2 * w, 3 * w, (h, w)).astype(np.float32)
    args = (torch.from_numpy(img), torch.from_numpy(yy), torch.from_numpy(xx))
    got = image.bilinear_sample(*args).numpy()
    want = np.asarray(jimage.bilinear_sample(jnp.asarray(img),
                                             jnp.asarray(yy),
                                             jnp.asarray(xx)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _naive_sample(img, yy, xx))
    packed = image.bilinear_sample_packed(image.prepack_bilinear_taps(args[0]),
                                          args[1], args[2])
    np.testing.assert_array_equal(packed.numpy().reshape(got.shape), got)


def _select_fields(rng, h, w, r):
    """(name, dy, dx): the cases of tests/test_flow_ops.py's shift-select
    test, and fields whose dy varies along the columns."""
    yield from ((f"pan{dy0},{dx0}", np.full((h, w), dy0, np.float32),
                 np.full((h, w), dx0, np.float32))
                for dy0, dx0 in [(2.3, -4.7), (-r, r), (5.99, -0.01),
                                 (0.0, 0.0), (3.0 * r, -3.0 * r)])
    yield ("rows-constant",
           np.tile(rng.uniform(-r, r, (h, 1)).astype(np.float32), (1, w)),
           rng.uniform(-r, r, (h, w)).astype(np.float32))
    yield ("dy-varies-along-columns",
           rng.uniform(-r, r, (h, w)).astype(np.float32),
           rng.uniform(-1.5 * r, 1.5 * r, (h, w)).astype(np.float32))


@pytest.mark.parametrize("shape,radius", [((37, 53), 6), ((5, 4), 16)],
                         ids=["37x53-r6", "5x4-r16"])
def test_shift_select_warp_matches_jax(shape, radius):
    """The port's two 1-D gathers against JAX's shift-select form, within
    2 ulp of 1 (measured <= 2.4e-7: XLA's CPU backend fuses the lerps'
    multiply-adds). Where dy varies along the columns the two-pass result
    is not the joint bilinear sample: each column tap carries its own
    column's row warp, as in JAX."""
    rng = np.random.default_rng(5)
    h, w = shape
    img = rng.standard_normal((h, w, 5)).astype(np.float32)
    for name, dy, dx in _select_fields(rng, h, w, radius):
        got = select_warp.shift_select_warp(
            torch.from_numpy(img), torch.from_numpy(dy), torch.from_numpy(dx),
            radius).numpy()
        want = np.asarray(jselect.shift_select_warp(
            jnp.asarray(img), jnp.asarray(dy), jnp.asarray(dx), radius))
        np.testing.assert_allclose(got, want, rtol=0, atol=4.8e-7,
                                   err_msg=name)
    # the column pass reads the row warp of its own columns: a joint
    # sample at dy[i, j] misses it
    ry, rx = min(radius, h - 1), min(radius, w - 1)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    joint = _naive_sample(img, yy + dy.clip(-ry, ry), xx + dx.clip(-rx, rx))
    assert np.abs(got - joint).max() > 1e-3


# ---------------------------------------------------------------------------
# kernels B1, B2a, B2b (plain versions) and the estimator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(48, 64), (21, 37)], ids=str)
def test_poly_expansion_matches_jax(shape, storage):
    """B1's plain version against JAX's ``poly_expansion(storage=...)``.
    f32: two orders of the fit's sums, within 3e-6 of each plane's largest
    value (measured <= 1.2e-6); bf16: the rounding points are the same and
    the sums of exact bf16 products land on the same bf16 values (measured
    equal), within one bf16 ulp of the plane's largest value."""
    x = np.random.default_rng(6).uniform(0, 255, shape).astype(np.float32)
    got = ops_fb.poly_expansion(torch.from_numpy(x), 5, 1.2, storage)
    want = np.stack([np.asarray(p, np.float32) for p in jfb.poly_expansion(
        jnp.asarray(x), 5, 1.2, storage=JAX_DTYPE[storage])], axis=-1)
    assert got.dtype == storage and got.shape == (*shape, 5)
    scale = np.abs(want).max(axis=(0, 1))
    rel = 3e-6 if storage == F32 else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * scale.max())
    for k in range(5):
        np.testing.assert_array_less(
            np.abs(got[..., k].float().numpy() - want[..., k]),
            rel * scale[k] + 1e-30)


@pytest.mark.parametrize("storage", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [5, 7])
def test_poly_expansion_pair_matches_plain_and_jax(n, storage):
    """``poly_expansion_pair`` (kernel B1 on both images of a level in one
    launch on the card) on the CPU: two ``poly_expansion_plain`` calls, bit
    for bit, and JAX's ``poly_expansion`` of each image under
    test_poly_expansion_matches_jax's bars."""
    rng = np.random.default_rng(9)
    imgs = [rng.uniform(0, 255, (29, 43)).astype(np.float32)
            for _ in range(2)]
    got = ops_fb.poly_expansion_pair(*map(torch.from_numpy, imgs), n, 1.2,
                                     storage)
    rel = 3e-6 if storage == F32 else 2.0 ** -8
    for x, out in zip(imgs, got):
        plain = ops_fb.poly_expansion_plain(torch.from_numpy(x), n, 1.2,
                                            storage)
        assert out.dtype == storage and torch.equal(out, plain)
        want = np.stack([np.asarray(p, np.float32) for p in jfb.poly_expansion(
            jnp.asarray(x), n, 1.2, storage=JAX_DTYPE[storage])], axis=-1)
        scale = np.abs(want).max(axis=(0, 1))
        for k in range(5):
            np.testing.assert_array_less(
                np.abs(out[..., k].float().numpy() - want[..., k]),
                rel * scale[k] + 1e-30)


def _fma32(a, b, c):
    """float32 ``fma(a, b, c)``, rounded once: the float64 product of two
    float32 values is exact and TwoSum gives the float64 sum's error. A
    float32 midpoint is a float64 value, so the float64 sum lies on the
    same side of it as the exact one, and rounding it to float32 is right
    except where it lies on a midpoint and the error is not 0: there the
    error's sign picks the neighbour."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b
    c64 = c.astype(np.float64)
    s = p + c64
    z = s - p
    err = (p - (s - z)) + (c64 - z)
    r = s.astype(np.float32)
    q = np.nextafter(r, np.where(s > r, np.float32(np.inf),
                                 np.float32(-np.inf)))
    tie = (s != r) & (s == (r.astype(np.float64) + q) / 2) & (err != 0)
    return np.where(tie, np.where(err > 0, np.maximum(r, q),
                                  np.minimum(r, q)), r)


def test_fma32_rounds_once():
    """``_fma32`` keeps what a rounded product loses ((1 + 2^-12)^2 - 1
    keeps its 2^-24), and where the float64 sum lies on a float32 midpoint
    it rounds the exact sum, not the float64 one."""
    a = np.float32(1 + 2.0 ** -12)
    assert _fma32(a, a, -1) == np.float32(2.0 ** -11 + 2.0 ** -24)
    assert np.float32(a * a) - np.float32(1) == np.float32(2.0 ** -11)
    # (1 + 2^-23) + (1 + 2^-23)(2^-24 - 2^-47): 2^-70 below the midpoint
    # of 1 + 2^-23 and 1 + 2^-22, where float64 lands
    a, b = np.float32(1 + 2.0 ** -23), np.float32(2.0 ** -24 - 2.0 ** -47)
    assert _fma32(a, b, a) == a
    assert np.float32(np.float64(a) * np.float64(b) + np.float64(a)) == \
        np.float32(1 + 2.0 ** -22)


def _fma_correlate(x, taps, axis, storage):
    """``ops/image.py::ordered_correlate`` (symmetric padding) with every
    product added by ``_fma32``, rounded to ``storage`` as B1 rounds it."""
    n = x.shape[axis]
    lo = (len(taps) - 1) // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (lo, len(taps) - 1 - lo)
    padded = np.pad(x, pad, mode="symmetric")
    take = lambda k: np.take(padded, np.arange(k, k + n), axis=axis)
    acc = (take(0) * np.float32(taps[0])).astype(np.float32)
    for k in range(1, len(taps)):
        acc = _fma32(take(k), np.full_like(acc, taps[k]), acc)
    return torch.from_numpy(acc).to(storage).float().numpy()


@pytest.mark.parametrize("n", [5, 7])
def test_bf16_products_make_fma_exact(n):
    """The premise of the kernels' fused multiply-adds in bf16 storage: B1
    whose nine correlations add each product by an exactly emulated fused
    multiply-add (``_fma32``) equals ``poly_expansion_plain``, which rounds
    each product, bit for bit on seeded images: bf16 values times bf16
    taps are exact in float32. In float32 storage the same swap changes
    the result, so the kernels keep rounded products there."""
    rng = np.random.default_rng(10)
    x = ndi.gaussian_filter(rng.uniform(0, 255, (40, 52)), 1.0).astype(
        np.float32)
    g, xg, xxg, ginv = ops_fb.poly_exp_consts(n, 1.2)
    for storage, exact in ((BF16, True), (F32, False)):
        taps = [image.rounded_taps(k, storage).numpy() for k in (g, xg, xxg)]
        f = torch.from_numpy(x).to(storage).float().numpy()
        fy = [_fma_correlate(f, t, 0, storage) for t in taps]
        moments = [_fma_correlate(fy[i], taps[t], 1, storage)
                   for i, t in ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0),
                                (1, 1))]
        coeffs = []
        for k in range(1, 6):   # the fit: bf16 moments times f32 ginv
            acc = moments[0] * np.float32(ginv[k, 0])
            for m in range(1, 6):
                acc = (acc + moments[m] * np.float32(ginv[k, m])).astype(
                    np.float32)
            coeffs.append(torch.from_numpy(acc).to(storage))
        coeffs[4] = coeffs[4] * 0.5
        got = torch.stack(coeffs, dim=-1)
        want = ops_fb.poly_expansion_plain(torch.from_numpy(x), n, 1.2,
                                           storage)
        assert torch.equal(got, want) == exact, storage


def _poly_pair(rng, h, w, storage):
    """Coefficient stacks of two related images, in ``storage``."""
    a = ndi.gaussian_filter(rng.uniform(0, 255, (h + 8, w + 8)), 2.0)
    img1 = a[4:4 + h, 4:4 + w].astype(np.float32)
    img2 = a[2:2 + h, 5:5 + w].astype(np.float32)
    return tuple(ops_fb.poly_expansion(torch.from_numpy(x), 5, 1.2, storage)
                 for x in (img1, img2))


def _update_flow_pair(poly1, poly2, flow, storage, gaussian, radius):
    """One displacement update (B2a then B2b) by the port and by JAX's
    ``_update_flow`` on the same coefficient planes and (H, W, 2) numpy
    flow: JAX gets its tap pack (radius 0) or the raw stack, the port the
    raw stack. Returns (port, JAX) flows."""
    got = fb._update_flow(poly1, poly2, torch.from_numpy(flow), 15, gaussian,
                          radius)
    jdt = JAX_DTYPE[storage]
    jpoly1 = tuple(jnp.asarray(poly1[..., k].float().numpy()).astype(jdt)
                   for k in range(5))
    jstack = jnp.asarray(poly2.float().numpy()).astype(jdt)
    jpack = jstack if radius else jimage.prepack_bilinear_taps(jstack)
    want = np.asarray(jfb._update_flow(jpoly1, jpack, jnp.asarray(flow), 15,
                                       gaussian, storage=jdt,
                                       select_radius=radius))
    assert got.dtype == F32 and got.shape == flow.shape
    assert np.isfinite(got.numpy()).all()
    return got.numpy(), want


@pytest.mark.parametrize("radius", [0, 16])
@pytest.mark.parametrize("gaussian", [False, True], ids=["box", "gaussian"])
@pytest.mark.parametrize("storage", [F32, BF16], ids=["f32", "bf16"])
def test_update_flow_matches_jax(storage, gaussian, radius):
    """One displacement update against JAX's on the same coefficient
    planes. f32: within 60 dB PSNR of the 8 px peak (measured 142-147 dB);
    bf16: the same bar (measured equal with the box, 142-144 dB with the
    Gaussian)."""
    rng = np.random.default_rng(7)
    h, w = 40, 56
    poly1, poly2 = _poly_pair(rng, h, w, storage)
    flow = (1.5 * rng.standard_normal((h, w, 2))).astype(np.float32)
    flow[:3] = 30.0  # some samples far outside the frame
    got, want = _update_flow_pair(poly1, poly2, flow, storage, gaussian,
                                  radius)
    assert _flow_psnr(got, want) >= 60.0
    assert not np.array_equal(got, flow)


def _b2a_flow(kind: str, h: int, w: int, rng) -> np.ndarray:
    """tests/test_torch_cuda.py's edge flows for kernel B2a, in numpy:
    none; the Engine's 3 px pan; samples just inside and just outside each
    edge of the frame; every sample on the stack's last pixel pair; every
    sample far off the frame."""
    pos = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    size = np.array([w, h], np.float64)
    if kind == "zero":
        flow = np.zeros((h, w, 2))
    elif kind == "pan":
        flow = np.full((h, w, 2), 3.0)
    elif kind == "edges":
        # targets -0.5, 0.25, S - 1.25, S - 0.75 and S + 2 on an axis of S
        k = rng.integers(0, 5, (h, w, 2))
        offset = np.array([-0.5, 0.25, -1.25, -0.75, 2.0])
        flow = offset[k] + (k >= 2) * size - pos
    elif kind == "corner":
        flow = size - np.array([1.5, 1.25]) - pos
    else:
        flow = rng.choice([-1.0, 1.0], (h, w, 2)) * (size + [5.5, 7.25])
    return np.ascontiguousarray(flow, np.float32)


@pytest.mark.parametrize("kind", ["zero", "pan", "edges", "corner", "far"])
@pytest.mark.parametrize("storage", [F32, BF16], ids=["f32", "bf16"])
def test_update_flow_matches_jax_on_edge_flows(storage, kind):
    """The plain B2a, which the kernel is held to bit for bit on the card,
    meets JAX's update on the flows that test the kernel's edges, at select
    radius 0 and 16 with the box: the same 60 dB bar. Off the frame every
    sample has zero weight and both keep the flow."""
    rng = np.random.default_rng(11)
    h, w = 40, 56
    poly1, poly2 = _poly_pair(rng, h, w, storage)
    flow = _b2a_flow(kind, h, w, rng)
    for radius in (0, 16):
        got, want = _update_flow_pair(poly1, poly2, flow, storage, False,
                                      radius)
        assert _flow_psnr(got, want) >= 60.0
        assert np.array_equal(got, flow) == (kind == "far")


E2E_CASES = {
    "defaults": {},
    "gaussian": dict(flags=256),
    "initial-flow": dict(flags=4),
    "downscale-2": dict(downscale=2),
    "downscale-4-it2": dict(downscale=4, iterations=2),
    "select-warp-16": dict(select_warp=16),
}


def _e2e(case, **extra):
    kwargs = E2E_CASES[case]
    a, b, _ = _warped_pair(96, 144, seed=5)
    prev = None
    if kwargs.get("flags") == 4:
        prev = (2 * np.random.default_rng(8).standard_normal((96, 144, 2))
                ).astype(np.float32)
    got = _port(a, b, prev, **kwargs, **extra)
    want = _jax(a, b, prev, **kwargs, **extra)
    assert got.shape == (96, 144, 2) and np.isfinite(got).all()
    return _flow_psnr(got, want)


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_farneback_matches_jax_f32(case):
    """f32 storage on both sides: >= 60 dB at an 8 px peak (measured
    139-147 dB at 96x144: the same arithmetic up to summation order)."""
    assert _e2e(case) >= 60.0


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_farneback_matches_jax_bf16(case, bf16_storage):
    """bf16 planes forced on both sides: >= 60 dB (measured 88-157 dB: a
    sum rounding to the neighbouring bf16 value moves the flow a little;
    the JAX package's own bf16 bar against cv2 is 40 dB). ``iterations=5``
    keeps the JAX trace apart from every f32 one."""
    assert _e2e(case, **({} if "iterations" in E2E_CASES[case]
                         else dict(iterations=5))) >= 60.0


def test_downscale_below_window_raises():
    with pytest.raises(ValueError, match="downscale"):
        fb.farneback(torch.zeros((24, 24), dtype=torch.uint8),
                     torch.zeros((24, 24), dtype=torch.uint8), downscale=4)


def test_translation_and_warm_start():
    """A 3, 2 px pan is found; the warm start is honoured only with flag 4
    (tests/test_flow_ops.py's translation and flag checks)."""
    a, b = shifted_pair(96, 128, dx=3, dy=2)
    flow = _port(a, b)
    interior = flow[20:-20, 20:-20]
    assert abs(np.median(interior[..., 0]) - 3) < 0.6
    assert abs(np.median(interior[..., 1]) - 2) < 0.6
    a, b = shifted_pair(64, 96, dx=2, dy=0)
    prev = np.full((64, 96, 2), 2.0, np.float32)
    warm = _port(a, b, prev, flags=fb.OPTFLOW_USE_INITIAL_FLOW)
    cold = _port(a, b, prev)
    assert not np.array_equal(warm, cold)
    assert abs(np.median(warm[16:-16, 16:-16, 0]) - 2) < 0.7


@pytest.mark.parametrize("case", ["downscale-2", "downscale-4-it2"])
def test_downscale_resizes_no_unused_prev_flow(case, monkeypatch):
    """Without flag 4 the warm start is unused, so a ``prev_flow`` given
    with ``downscale`` > 1 is not resized (no ``bilinear_resize`` of a
    full-size flow); the flow equals the one without ``prev_flow`` and
    meets the bar against JAX's ``farneback``, which receives it."""
    a, b, _ = _warped_pair(96, 144, seed=5)
    prev = (2 * np.random.default_rng(8).standard_normal((96, 144, 2))
            ).astype(np.float32)
    kwargs = E2E_CASES[case]
    resized = []
    plain_resize = fb.bilinear_resize

    def counted(x, h, w):
        resized.append(tuple(x.shape))
        return plain_resize(x, h, w)

    monkeypatch.setattr(fb, "bilinear_resize", counted)
    got = _port(a, b, prev, **kwargs)
    assert (96, 144, 2) not in resized
    without = len(resized)
    resized.clear()
    assert np.array_equal(got, _port(a, b, **kwargs))
    assert len(resized) == without
    assert _flow_psnr(got, _jax(a, b, prev, **kwargs)) >= 60.0


def test_get_estimator_returns_the_port():
    """The three classic methods resolve to the port's functions."""
    from transflow_tpu_torch.flow.estimators import (horn_schunck,
                                                     lucas_kanade)
    assert get_estimator("farneback") is fb.farneback
    assert get_estimator("horn-schunck") is horn_schunck.horn_schunck
    assert get_estimator("lukas-kanade") is lucas_kanade.lucas_kanade
    assert fb.farneback.__module__.startswith("transflow_tpu_torch.")
    assert horn_schunck.horn_schunck.__module__.startswith(
        "transflow_tpu_torch.")
    assert lucas_kanade.lucas_kanade.__module__.startswith(
        "transflow_tpu_torch.")


# ---------------------------------------------------------------------------
# the JAX package's quality bars against cv2
# ---------------------------------------------------------------------------

def test_bf16_quality_against_cv2(monkeypatch):
    """bf16 planes, as on the card: >= 40 dB against cv2
    (tests/test_flow_ops.py::test_farneback_bf16_storage_parity)."""
    monkeypatch.setattr(fb, "_storage_dtype", lambda device: BF16)
    a, b = shifted_pair(120, 160, dx=3, dy=2)
    assert _flow_psnr(_port(a, b, iterations=4),
                      _cv2_flow(a, b, iterations=4)) >= 40.0


def test_fast_presets_quality():
    """The fast/fastest floors of tests/test_flow_ops.py
    (test_fast_presets_psnr_guard), with the presets' own files."""
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    a, b, gt = _warped_pair()
    ref = _cv2_flow(a, b)
    floors = {"fast.json": (27.0, 26.0), "fastest.json": (19.5, 19.0)}
    for name, (floor_cv2, floor_gt) in floors.items():
        with open(os.path.join(CONFIGS, name), encoding="utf8") as file:
            kwargs = CvFlowConfig(**json.load(file)).estimator_kwargs()
        assert kwargs["downscale"] > 1, name
        flow = _port(a, b, **kwargs)
        assert _flow_psnr(flow, ref) >= floor_cv2, name
        assert _flow_psnr(flow, gt) >= floor_gt, name


def test_select_warp_quality():
    """tests/test_flow_ops.py::test_farneback_select_warp_quality: >= 34 dB
    against cv2, >= 30 against the true flow, >= 43 against the gather
    path."""
    a, b, gt = _warped_pair()
    sel = _port(a, b, select_warp=16)
    assert _flow_psnr(sel, _cv2_flow(a, b)) >= 34.0
    assert _flow_psnr(sel, gt) >= 30.0
    assert _flow_psnr(sel, _port(a, b)) >= 43.0


@pytest.mark.parametrize("settings", [{}, dict(fb_downscale=2),
                                      dict(fb_downscale=4, fb_iterations=2),
                                      dict(fb_levels=5, fb_pyr_scale=0.7)],
                         ids=["defaults", "fast", "fastest", "deep"])
def test_chip_smoke_launch_rule(settings, monkeypatch):
    """The estimator's launches per frame of each kernel
    (``launches_per_frame``, the count chip_smoke and the bench assert on
    the card) equal the calls the estimator makes, here to the kernels'
    plain versions (B1: one call per level for both images; B8: one for
    every level below L0 and one for the ``fb_downscale`` pre-resize, both
    images a call; no level of a 90x160 frame is deep), and are 4, 12, 12,
    1 at 1080p defaults."""
    import chip_smoke
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    from transflow_tpu_torch.ops import pyramid
    calls = {name: 0 for name in ("poly_expansion_pair", "update_equations",
                                  "aggregate_solve", "pyramid_levels")}
    for name in calls:
        module = pyramid if name == "pyramid_levels" else ops_fb
        plain = getattr(module, f"{name}_plain")

        def counted(*args, _name=name, _plain=plain):
            calls[_name] += 1
            return _plain(*args)

        monkeypatch.setattr(module, f"{name}_plain", counted)
    config = CvFlowConfig(**settings)
    a, b = shifted_pair(90, 160, dx=1, dy=1)
    kwargs = config.estimator_kwargs()
    fb.farneback(torch.from_numpy(a), torch.from_numpy(b), **kwargs)
    assert tuple(calls.values()) == fb.launches_per_frame(90, 160, **kwargs)
    assert fb.launches_per_frame(1080, 1920,
                                 **CvFlowConfig().estimator_kwargs()) == \
        chip_smoke.FB_DEFAULT_PER_FRAME == (4, 12, 12, 1)


def test_chip_smoke_captures_engine_b2a_inputs(monkeypatch):
    """chip_smoke's ``engine_b2a_inputs`` (what ``--against`` times B2a on)
    records the 12 inputs of one Engine frame over ``CvFlowConfig()``,
    coarse level first, and leaves the estimator as it was;
    ``one_row_warps`` reads 1 on a pan and about 0 on scattered flows."""
    import chip_smoke as cs
    from transflow_tpu_torch.flow.estimators import farneback as estimator
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    h, w = 96, 128
    monkeypatch.setattr(cs, "HEIGHT", h)
    monkeypatch.setattr(cs, "WIDTH", w)
    frames = cs.gray_frames(15, h, w, "cpu")
    pixmap = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (h, w, 3), dtype=np.uint8))
    run = cs.run_engine("cpu", frames, pixmap, CvFlowConfig())
    update = estimator.update_equations
    inputs = cs.engine_b2a_inputs(run)
    assert estimator.update_equations is update
    assert [tuple(f.shape) for _, _, f in inputs] == [
        (h >> k, w >> k, 2) for k in (3, 2, 1, 0) for _ in range(3)]
    assert all(p1.shape == p2.shape == (*f.shape[:2], 5)
               for p1, p2, f in inputs)
    assert cs.one_row_warps(cs.pan_flow(h, w + 5, "cpu")) == 1.0
    rng = np.random.default_rng(1)
    scattered = torch.from_numpy(
        6 * rng.standard_normal((h, w, 2)).astype(np.float32))
    assert cs.one_row_warps(scattered) < 0.05

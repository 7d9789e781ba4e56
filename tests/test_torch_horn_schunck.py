"""The port's Horn-Schunck (kernels B9 and B10's plain versions, the
estimator) against the JAX package's, on the CPU.

The same seeded numpy frames go through ``jax.jit`` on the CPU and through
the port. B9's planes equal the JAX function's bit for bit (the blur and
the stencils are exact; ``denom``'s two multiply-adds are fused on both
sides). The flows are held within 1e-5 of JAX's: the port rounds every
product of the loop body, XLA fuses some into FMAs and sums the 3x3
average in its own order (measured within 3e-6 at flows below 50 px).
"""
import fractions
import functools
import importlib
import json
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_flow_ops import shifted_pair
from transflow_tpu.ops import image as jimage
from transflow_tpu_torch.flow.estimators import get_estimator
from transflow_tpu_torch.flow.estimators.horn_schunck import (
    horn_schunck, horn_schunck_counted)
from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
from transflow_tpu_torch.ops import horn_schunck as hs
from transflow_tpu_torch.ops import image

jhs_module = importlib.import_module(
    "transflow_tpu.flow.estimators.horn_schunck")
jax_horn_schunck = jhs_module.horn_schunck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "assets", "configs")
PRESETS = ("horn-schunck.json", "horn-schunck-diverge.json",
           "horn-schunck-smooth-inertia.json")
SHAPES = [(96, 128), (135, 241)]
FLOW_TOL = 1e-5


def _preset(name: str) -> dict:
    with open(os.path.join(CONFIGS, name), encoding="utf8") as file:
        return CvFlowConfig(**json.load(file)).estimator_kwargs()


def _random_pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.integers(0, 256, shape, dtype=np.uint8))


def _port(a, b, prev=None, **kwargs):
    flow, iters = horn_schunck_counted(
        torch.from_numpy(a), torch.from_numpy(b),
        None if prev is None else torch.from_numpy(prev), **kwargs)
    return flow.numpy(), int(iters)


def _jax(a, b, prev=None, **kwargs):
    return np.array(jax_horn_schunck(
        jnp.asarray(a), jnp.asarray(b),
        None if prev is None else jnp.asarray(prev), **kwargs))


def _assert_flows_close(got, want, tol=FLOW_TOL):
    assert got.shape == want.shape and got.dtype == np.float32
    # beyond ~100 px a float32 ulp outgrows 1e-5: there the bar is 4 ulp
    # of the JAX value (horn-schunck-diverge's flows reach thousands)
    np.testing.assert_allclose(got, want, atol=tol, rtol=2.0 ** -21)


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 7])
@pytest.mark.parametrize("pads", [(2, 2), (0, 3), (5, 9)], ids=str)
def test_reflect_pad_is_numpys(n, pads):
    x = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    got = image.pad_axis(torch.from_numpy(x), 0, *pads, "reflect")
    np.testing.assert_array_equal(
        got.numpy(), np.pad(x, (pads, (0, 0)), mode="reflect"))


@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("shape", [(96, 128), (135, 241)], ids=str)
def test_separable_correlate_modes_match_jax(shape, mode):
    img = np.random.default_rng(1).integers(0, 256, shape).astype(np.float32)
    for axis in (0, 1):
        got = image.separable_correlate(torch.from_numpy(img), hs.K5, axis,
                                        mode)
        want = jax.jit(lambda x: jimage.separable_correlate(
            x, hs.K5, axis, mode))(img)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kernel", ["x", "y", "t", "avg", "3x4"])
@pytest.mark.parametrize("shape", [(96, 128), (135, 241)], ids=str)
def test_correlate2d_reflect_matches_jax(shape, kernel):
    """Integer images and the stencils (exact sums): bit-equal; the 3x3
    average and a 3x4 kernel add in the library's order on each side."""
    k = {"x": hs.X_KERNEL, "y": hs.Y_KERNEL, "t": hs.T_KERNEL,
         "avg": hs.AVG_KERNEL,
         "3x4": np.arange(12, dtype=np.float32).reshape(3, 4) / 7}[kernel]
    img = np.random.default_rng(2).integers(0, 256, shape).astype(np.float32)
    got = image.correlate2d_reflect(torch.from_numpy(img), k).numpy()
    want = np.asarray(jax.jit(
        lambda x: jimage.correlate2d_reflect(x, k))(img))
    if kernel in ("x", "y", "t"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def _fma_exact(a, b, c) -> np.float32:
    """The float32 nearest a * b + c (ties to even), from exact rationals."""
    exact = fractions.Fraction(float(a)) * fractions.Fraction(float(b)) \
        + fractions.Fraction(float(c))
    mid = np.float32(float(exact))
    lo = np.nextafter(mid, np.float32(-np.inf))
    hi = np.nextafter(mid, np.float32(np.inf))
    best = min((lo, mid, hi), key=lambda v: (
        abs(fractions.Fraction(float(v)) - exact),
        int(np.array(v).view(np.int32)) & 1))
    return np.float32(best)


def test_fma_f32_rounds_once():
    """``fma_f32`` against exact rational arithmetic, on random operands
    and on sums built to sit at a float32 rounding tie after the float64
    rounding (where rounding twice would be wrong)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(300).astype(np.float32) * 300
    b = rng.standard_normal(300).astype(np.float32) * 300
    c = rng.standard_normal(300).astype(np.float32) * 1e-3
    # a * b = 1 + 2^-24 exactly (a tie between two float32), c a hair
    # above or below: once rounded the sum leaves the tie
    a[:4] = np.float32(1 + 2.0 ** -12)
    b[:4] = np.float32(1 + 2.0 ** -12)
    c[:4] = np.float32([2.0 ** -70, -(2.0 ** -70), 2.0 ** -60, 0.0])
    got = hs.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# B9 and B10
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=2)
def _jax_planes(prev, nxt, alpha2):
    """The JAX function's pre-pass, as horn_schunck.py:45-56 writes it."""
    a = jhs_module._blur5(prev.astype(jnp.float32))
    b = jhs_module._blur5(nxt.astype(jnp.float32))
    corr = jimage.correlate2d_reflect
    ex = corr(a, jhs_module._X_KERNEL) + corr(b, jhs_module._X_KERNEL)
    ey = corr(a, jhs_module._Y_KERNEL) + corr(b, jhs_module._Y_KERNEL)
    et = corr(b, jhs_module._T_KERNEL) - corr(a, jhs_module._T_KERNEL)
    return jnp.stack([ex, ey, et, alpha2 + ex ** 2 + ey ** 2])


@pytest.mark.parametrize("alpha", [1.0, 0.01, 10.0])
@pytest.mark.parametrize("shape", SHAPES + [(1, 1), (2, 5), (7, 4)],
                         ids=str)
def test_derivatives_equal_jax(shape, alpha):
    a, b = _random_pair(shape)
    planes, control = hs.hs_derivatives(torch.from_numpy(a),
                                        torch.from_numpy(b), alpha)
    assert planes.dtype == torch.float32 and planes.shape == (4, *shape)
    assert control.tolist() == [0] * hs.CONTROL_WORDS
    # alpha ** 2 enters as the JAX function's weak-typed Python float
    want = np.asarray(_jax_planes(a, b, alpha ** 2))
    assert np.array_equal(planes.numpy(), want)


def test_derivatives_equal_the_jax_flow_of_one_step():
    """From zero the first step is ``-ex * et / denom``: with B9's planes
    it equals the JAX function's one-iteration flow bit for bit."""
    a, b = _random_pair((96, 128), seed=5)
    planes, _ = hs.hs_derivatives(torch.from_numpy(a), torch.from_numpy(b),
                                  1.0)
    ex, ey, et, denom = planes.numpy()
    c = et / denom
    want = _jax(a, b, max_iters=1, delta=None)
    np.testing.assert_array_equal(-(ex * c), want[..., 0])
    np.testing.assert_array_equal(-(ey * c), want[..., 1])


def test_iterate_copies_through_once_stopped():
    a, b = _random_pair((24, 40))
    planes, control = hs.hs_derivatives(torch.from_numpy(a),
                                        torch.from_numpy(b), 1.0)
    flow = torch.randn((24, 40, 2))
    control[0] = 1
    out = hs.hs_iterate(planes, flow, control, 1.0)
    assert torch.equal(out, flow) and out.data_ptr() != flow.data_ptr()
    assert control.tolist() == [1, 0, 0, 0]


def test_dispatch_by_device():
    a = torch.zeros((4, 6), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no path for device meta"):
        hs.hs_derivatives(a, a, 1.0)
    planes = torch.zeros((4, 4, 6), device="meta")
    flow = torch.zeros((4, 6, 2), device="meta")
    control = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no path for device meta"):
        hs.hs_iterate(planes, flow, control, 1.0)
    assert get_estimator("horn-schunck") is horn_schunck


# ---------------------------------------------------------------------------
# the kernels' tiling, emulated on the host (no card): every output pixel
# has one owner, every staged value a read needs is written
# ---------------------------------------------------------------------------

KERNEL_SOURCE = os.path.join(REPO, "transflow_tpu_torch", "csrc",
                             "horn_schunck.cu")
TILING_SHAPES = [(1, 1), (7, 5), (37, 45), (135, 241), (17, 33), (15, 31),
                 (33, 65), (100, 200), (1080, 1919)]


def _kernel_constants() -> dict:
    """The ``constexpr int`` constants of csrc/horn_schunck.cu, evaluated in
    order (C's integer division)."""
    with open(KERNEL_SOURCE, encoding="utf8") as file:
        text = file.read()
    values = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", text):
        values[name] = eval(expr.replace("/", "//"), {}, dict(values))
    return values


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@pytest.mark.parametrize("shape", TILING_SHAPES, ids=str)
def test_iterate_tiling_owns_every_pixel_once(shape):
    """B10: block b walks tiles b, b + kIterBlocks, ...; in tile n (row
    n / tiles_x, column n % tiles_x of tiles) thread tid's row r owns pixel
    (ty * kIterH + tid / 32 * kIterRows + r, tx * 32 + tid % 32). Every
    pixel of the frame has exactly one owner, and the blocks, one partial
    sum each, are the count ``transflow_hs_iterate_partials`` gives the
    wrapper (``iterate_blocks``: one a tile up to kIterBlocks)."""
    k = _kernel_constants()
    h, w = shape
    assert k["kIterH"] == k["kWarps"] * k["kIterRows"]
    tiles_x = _ceil(w, k["kIterW"])
    tiles = tiles_x * _ceil(h, k["kIterH"])
    blocks = min(tiles, k["kIterBlocks"])
    owners = np.zeros(shape, np.int64)
    tid = np.arange(k["kThreads"])
    walked = []
    for b in range(blocks):
        for n in range(b, tiles, blocks):
            walked.append(n)
            ty, tx = divmod(n, tiles_x)
            j = tx * k["kIterW"] + tid % k["kWarp"]
            r0 = ty * k["kIterH"] + tid // k["kWarp"] * k["kIterRows"]
            for r in range(k["kIterRows"]):
                keep = (j < w) & (r0 + r < h)
                np.add.at(owners, (r0[keep] + r, j[keep]), 1)
    assert (owners == 1).all()
    assert sorted(walked) == list(range(tiles))
    assert blocks <= k["kIterBlocks"] and (blocks == tiles
                                           or blocks == k["kIterBlocks"])


@pytest.mark.parametrize("shape", TILING_SHAPES, ids=str)
def test_derivatives_tiling_owns_every_pixel_once(shape):
    """B9: each block's vertical tasks write every staged vertical sum its
    horizontal pass reads (columns min(j0 + q, W - 1) - j0 + 2 + k), the
    horizontal pass every blurred value the stencils read, and the
    stencils' threads (four columns in two rows each) own every pixel of
    the frame exactly once."""
    k = _kernel_constants()
    h, w = shape
    owners = np.zeros(shape, np.int64)
    tid = np.arange(k["kThreads"])
    vert = np.zeros((k["kBlurH"], k["kVertW"]), np.int64)
    for t in tid[tid < k["kGroups"] * k["kStrips"]]:
        g, t0 = t % k["kGroups"], t // k["kGroups"] * k["kStripRows"]
        vert[t0:t0 + k["kStripRows"], 4 * g:4 * g + 4] += 1
    assert (vert == 1).all()
    for by in range(_ceil(h, k["kDerivH"])):
        for bx in range(_ceil(w, k["kDerivW"])):
            i0, j0 = by * k["kDerivH"], bx * k["kDerivW"]
            q = np.arange(k["kBlurW"])
            taps = (np.minimum(j0 + q, w - 1) - j0 + k["kVertLo"] - 2)[:, None] \
                + np.arange(5)
            assert taps.min() >= 0 and taps.max() < k["kVertW"]
            # the stencils read blurred columns q0 .. q0 + 4, rows t, t + 1
            q0 = 4 * (tid % 16)
            assert q0.max() + 4 < k["kBlurW"] <= k["kVertW"]
            assert k["kDerivH"] < k["kBlurH"]
            for t in range(k["kDerivH"]):
                rows = tid[tid // 16 == t % (k["kThreads"] // 16)]
                if i0 + t >= h:
                    continue
                for c in range(4):
                    j = j0 + q0[rows] + c
                    np.add.at(owners, (i0 + t, j[j < w]), 1)
    assert (owners == 1).all()


# ---------------------------------------------------------------------------
# the estimator against JAX
# ---------------------------------------------------------------------------

CASES = {
    "defaults": {},
    "delta-none-50": dict(max_iters=50, delta=None),
    **{name[:-5]: _preset(name) for name in PRESETS},
}


@pytest.mark.parametrize("warm", ["prev-none", "prev-flow"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_horn_schunck_matches_jax(shape, case, warm):
    kwargs = CASES[case]
    a, b = shifted_pair(*shape, dx=3, dy=2)
    prev = None
    if warm == "prev-flow":
        # the JAX flow of the pair before: the warm start an Engine gives
        c, _ = shifted_pair(*shape, dx=1, dy=-2, seed=4)
        prev = _jax(c, a, **kwargs)
    got, iters = _port(a, b, prev, **kwargs)
    want = _jax(a, b, prev, **kwargs)
    # horn-schunck-diverge's alpha 0.01 divides the step by denom >= 1e-4:
    # a rounding of its numerator, whose products the two sides fuse and
    # round differently, grows up to 1e4 times there (measured 2.4e-5 at
    # 1 of 65070 pixels from a warm start); 1e-5 everywhere else
    tol = 1e-4 if kwargs.get("alpha") == 0.01 and prev is not None \
        else FLOW_TOL
    _assert_flows_close(got, want, tol)
    assert np.abs(want).max() > 1.0
    assert 1 <= iters <= kwargs.get("max_iters", 3)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_unrelated_frames_match_jax(shape):
    a, b = _random_pair(shape, seed=7)
    got, _ = _port(a, b)
    _assert_flows_close(got, _jax(a, b))


def test_static_pair_stops_after_one_iteration():
    """A static pair's first step is 0: its norm 0 < delta, so the loop
    stops after one iteration, on both sides."""
    a, _ = shifted_pair(96, 128)
    got, iters = _port(a, a, max_iters=5)
    assert iters == 1
    np.testing.assert_array_equal(got, _jax(a, a, max_iters=5))
    assert not got.any()


def _jax_norms(a, b, n):
    """The JAX loop's step norms ``||u_k - u_(k-1)||`` for k = 1..n."""
    flows = [np.zeros(a.shape, np.float32)] + [
        _jax(a, b, max_iters=k, delta=None)[..., 0] for k in range(1, n + 1)]
    return [float(np.sqrt(np.sum(np.square(flows[k] - flows[k - 1]))))
            for k in range(1, n + 1)]


def test_delta_between_two_norms_stops_where_jax_does():
    a, b = shifted_pair(96, 128, dx=3, dy=2)
    norms = _jax_norms(a, b, 4)
    assert norms[1] > norms[2]
    delta = float(np.sqrt(norms[1] * norms[2]))    # between steps 2 and 3
    got, iters = _port(a, b, max_iters=10, delta=delta)
    assert iters == 3
    want = _jax(a, b, max_iters=10, delta=delta)
    np.testing.assert_array_equal(want, _jax(a, b, max_iters=3, delta=None))
    _assert_flows_close(got, want)


@pytest.mark.parametrize("delta", [None, 0.0])
def test_delta_none_and_zero_never_stop(delta):
    a, _ = shifted_pair(48, 64)
    got, iters = _port(a, a, max_iters=4, delta=delta)
    assert iters == 4
    _assert_flows_close(got, _jax(a, a, max_iters=4, delta=delta))


def test_zero_iterations_return_the_warm_start():
    a, b = _random_pair((20, 30))
    prev = np.random.default_rng(1).standard_normal((20, 30, 2)) \
        .astype(np.float32)
    got, iters = _port(a, b, prev, max_iters=0, decay=0.5)
    assert iters == 0
    np.testing.assert_array_equal(got, _jax(a, b, prev, max_iters=0,
                                            decay=0.5))


def test_zero_decay_keeps_negative_zeros():
    """``decay * prev_flow`` with decay 0 keeps the sign of zero, as the
    JAX function's float32 product does."""
    a, b = _random_pair((12, 16))
    prev = -np.ones((12, 16, 2), np.float32)
    got, _ = _port(a, b, prev, max_iters=0, decay=0.0)
    assert np.signbit(got).all()
    np.testing.assert_array_equal(np.signbit(got), np.signbit(
        _jax(a, b, prev, max_iters=0, decay=0.0)))


# ---------------------------------------------------------------------------
# the JAX package's own bars, on the port
# ---------------------------------------------------------------------------

def test_horn_schunck_vs_oracle():
    """tests/test_flow_ops.py's scipy oracle of the reference formula
    (transflow/flow/methods/horn_schunck.py), interior within 0.05."""
    import cv2
    import scipy.ndimage
    a8, b8 = shifted_pair(48, 64, dx=1, dy=1)
    a = cv2.GaussianBlur(a8.astype(np.float32), (5, 5), 0)
    b = cv2.GaussianBlur(b8.astype(np.float32), (5, 5), 0)
    u = np.zeros(a.shape)
    v = np.zeros(a.shape)
    xk = np.array([[1, -1], [1, -1]]) * 0.25
    yk = np.array([[1, 1], [-1, -1]]) * 0.25
    tk = np.ones((2, 2)) * 0.25
    avg = np.array([[1, 2, 1], [2, 0, 2], [1, 2, 1]]) / 12
    ex = scipy.ndimage.convolve(a, xk) + scipy.ndimage.convolve(b, xk)
    ey = scipy.ndimage.convolve(a, yk) + scipy.ndimage.convolve(b, yk)
    et = scipy.ndimage.convolve(b, tk) - scipy.ndimage.convolve(a, tk)
    alpha, iters, delta = 1.0, 3, 1.0
    for _ in range(iters):
        u_avg = scipy.ndimage.convolve(u, avg)
        v_avg = scipy.ndimage.convolve(v, avg)
        c = (ex * u_avg + ey * v_avg + et) / (alpha ** 2 + ex ** 2
                                              + ey ** 2)
        prev = u
        u = u_avg - ex * c
        v = v_avg - ey * c
        if np.linalg.norm(u - prev, 2) < delta:
            break
    expected = np.stack([u, v], axis=-1).astype(np.float32)
    got = horn_schunck(torch.from_numpy(a8), torch.from_numpy(b8),
                       alpha=1.0, max_iters=3, decay=0.0, delta=1.0).numpy()
    np.testing.assert_allclose(got[4:-4, 4:-4], expected[4:-4, 4:-4],
                               atol=0.05)


def test_reference_psnr_setting_renders_like_jax(tmp_path):
    """tests/test_reference_parity.py::TestHornSchunckPSNR's setting (hs
    iterations 3, alpha 1, decay 0, delta 1, backward) through both CLIs
    over a netpbm sequence: >= 40 dB PSNR between their frames, the bar
    that class holds the JAX package to against the upstream reference
    (which this comparison does not need)."""
    from transflow_tpu import cli as jcli
    from transflow_tpu_torch import cli
    from transflow_tpu_torch.utils.imageio import read_netpbm, write_netpbm
    seq = tmp_path / "seq"
    seq.mkdir()
    big, _ = shifted_pair(72, 96, dx=0, dy=0, seed=2)
    for i in range(6):
        write_netpbm(str(seq / f"{i:04d}.pgm"),
                     big[i:i + 48, 2 * i:2 * i + 64])
    cfg = tmp_path / "hs.json"
    cfg.write_text(json.dumps({"method": "horn-schunck", "hs_iterations": 3,
                               "hs_alpha": 1.0, "hs_decay": 0.0,
                               "hs_delta": 1.0}))
    frames = {}
    for name, run in (("port", lambda argv: cli.main(argv, device="cpu")),
                      ("jax", jcli.main)):
        out = tmp_path / name
        out.mkdir()
        run([str(seq / "%04d.pgm"), "-c", str(cfg), "-d", "backward",
             "-p", "noise", "--seed", "0", "-o", str(out / "%04d.ppm"),
             "--no-exec", "--overwrite"])
        frames[name] = np.stack([read_netpbm(str(p))
                                 for p in sorted(out.glob("*.ppm"))])
    assert frames["port"].shape == frames["jax"].shape == (5, 48, 64, 3)
    mse = np.mean((frames["port"].astype(np.float64) - frames["jax"]) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 40.0

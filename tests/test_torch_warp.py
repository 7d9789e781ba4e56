"""The port's bounded backwarp (kernel A3) and its route through
LiteFlowNet, against the JAX package on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as its own tests do.
XLA's CPU backend fuses the kernel's ``out += sub * weight`` into one
multiply-add; the port (its plain version and its CUDA kernel alike) rounds
the product before the add, in the same order. So the two agree bit for bit
where the bilinear weights are 0 or 1 (integer and half-integer flows) and
otherwise within a few ulps: ``WARP_TOL`` = 1e-6 on images of |values| < 3.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transflow_tpu.flow.estimators import liteflownet as jlfn
from transflow_tpu.ops.pallas_warp import bounded_backwarp as jax_bounded
from transflow_tpu_torch.flow.estimators import liteflownet as lfn
from transflow_tpu_torch.ops import warp
from transflow_tpu_torch.ops.warp import (bounded_backwarp,
                                          bounded_backwarp_cuda,
                                          bounded_backwarp_plain)

WARP_TOL = 1e-6
# f32 network on both sides (tests/test_torch_liteflownet.py's bar)
NET_TOL = 1e-3
FLOWS = ("within", "beyond", "shift", "integer")


def _image(shape, seed):
    rng = np.random.default_rng(seed)
    return np.clip(0.6 * rng.standard_normal(shape), -2.9, 2.9) \
        .astype(np.float32)


def _flow(kind, hw, bound, seed):
    rng = np.random.default_rng(seed)
    if kind == "within":     # floors in [-bound, bound - 1]
        flow = bound * (2 * rng.random(hw + (2,)) - 1)
    elif kind == "beyond":   # a fifth of the pixels far outside the bound
        flow = bound * (2 * rng.random(hw + (2,)) - 1)
        far = rng.random(hw) < 0.2
        flow[far] = (3 * bound * rng.standard_normal((far.sum(), 2)))
    elif kind == "shift":    # uniform shift off the frame edge
        flow = np.full(hw + (2,), -2.5)
    else:                    # integer taps, some beyond the bound
        flow = rng.integers(-bound - 2, bound + 3, hw + (2,))
    return flow.astype(np.float32)


@pytest.mark.parametrize("kind", FLOWS)
@pytest.mark.parametrize("bound", [3, 8])
@pytest.mark.parametrize("shape", [(24, 40, 16), (37, 130, 24)], ids=str)
def test_plain_matches_jax_kernel(shape, bound, kind):
    image = _image(shape, bound)
    flow = _flow(kind, shape[:2], bound, bound + 100)
    want = np.asarray(jax_bounded(jnp.asarray(image), jnp.asarray(flow),
                                  bound, interpret=True))
    got = bounded_backwarp_plain(torch.from_numpy(image),
                                 torch.from_numpy(flow), bound)
    assert got.dtype == torch.float32 and got.shape == shape
    if kind in ("shift", "integer"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=WARP_TOL, rtol=0)


def test_plain_stages_bf16():
    """A bf16 image and the same values in f32 warp alike: the image is
    rounded to bf16 before the taps are read."""
    image = torch.from_numpy(_image((16, 20, 16), 1))
    flow = torch.from_numpy(_flow("beyond", (16, 20), 4, 2))
    from_f32 = bounded_backwarp_plain(image, flow, 4)
    from_bf16 = bounded_backwarp_plain(image.to(torch.bfloat16), flow, 4)
    assert torch.equal(from_f32, from_bf16)
    want = np.asarray(jax_bounded(jnp.asarray(image.numpy()),
                                  jnp.asarray(flow.numpy()), 4,
                                  interpret=True))
    np.testing.assert_allclose(from_bf16.numpy(), want, atol=WARP_TOL,
                               rtol=0)


def test_dispatch_by_device():
    image = torch.zeros((4, 6, 16))
    flow = torch.zeros((4, 6, 2))
    before = bounded_backwarp_cuda.launches
    assert torch.equal(bounded_backwarp(image, flow, 3),
                       bounded_backwarp_plain(image, flow, 3))
    assert bounded_backwarp_cuda.launches == before
    with pytest.raises(ValueError, match="no path for device"):
        bounded_backwarp(image.to("meta"), flow.to("meta"), 3)
    with pytest.raises(ValueError, match="CUDA device"):
        bounded_backwarp_cuda(image, flow, 3)


@pytest.mark.parametrize("case", ["narrow", "unbounded", "bounded"])
def test_backwarp_routing(case, monkeypatch):
    """A bound is honoured from 16 channels up; bound=None and narrower
    images take the exact gather."""
    calls = []
    monkeypatch.setattr(warp, "bounded_backwarp_plain",
                        lambda *a: calls.append(a[2]) or
                        bounded_backwarp_plain(*a))
    channels = 8 if case == "narrow" else 16
    image = _image((16, 32, channels), 3)
    flow = np.full((16, 32, 2), 9.25, np.float32)
    bound = None if case == "unbounded" else 2
    got = lfn.backwarp(torch.from_numpy(image), torch.from_numpy(flow),
                       bound=bound)
    want = np.asarray(jlfn.backwarp(jnp.asarray(image), jnp.asarray(flow),
                                    bound=bound))
    exact = lfn.backwarp(torch.from_numpy(image), torch.from_numpy(flow))
    np.testing.assert_allclose(got.numpy(), want, atol=WARP_TOL, rtol=0)
    if case == "bounded":
        assert calls == [2]
        assert not torch.allclose(got, exact)   # the clamp ran
    else:
        assert calls == []
        assert torch.equal(got, exact)


def test_backwarp_kernel_names(monkeypatch):
    image = torch.ones((16, 32, 16))
    flow = torch.zeros((16, 32, 2))
    monkeypatch.delenv(lfn.WARP_KERNEL_ENV, raising=False)
    with pytest.raises(ValueError, match="mxu"):
        lfn.backwarp(image, flow, bound=4, kernel="mxu")
    monkeypatch.setenv(lfn.WARP_KERNEL_ENV, "mxu")
    with pytest.raises(ValueError, match="'select'"):
        lfn.backwarp(image, flow, bound=4)
    assert torch.equal(lfn.backwarp(image, flow, bound=4, kernel="select"),
                       bounded_backwarp_plain(image, flow, 4))


@pytest.mark.parametrize("env,base", [(None, None), ("16", None),
                                      ("16", 8), ("16", 0), (None, 5)],
                         ids=str)
def test_warp_bound_matches_jax(monkeypatch, env, base):
    if env is None:
        monkeypatch.delenv(lfn.WARP_BOUND_ENV, raising=False)
    else:
        monkeypatch.setenv(lfn.WARP_BOUND_ENV, env)
    for level in (2, 3, 4, 5, 6):
        assert lfn._warp_bound(level, base) == jlfn._warp_bound(level, base)


@pytest.mark.parametrize("env,base,match", [
    (None, -16, ">= 0"), ("-4", None, ">= 0"), ("16px", None, "WARP_BOUND")],
    ids=["negative", "negative-env", "not-integer"])
def test_warp_bound_errors_match_jax(monkeypatch, env, base, match):
    if env is None:
        monkeypatch.delenv(lfn.WARP_BOUND_ENV, raising=False)
    else:
        monkeypatch.setenv(lfn.WARP_BOUND_ENV, env)
    with pytest.raises(ValueError, match=match) as got:
        lfn._warp_bound(2, base)
    with pytest.raises(ValueError) as want:
        jlfn._warp_bound(2, base)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def nets():
    """The JAX package's random weights and the port's network on them."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlfn, "_CACHE", {})
        mp.delenv(jlfn.WEIGHTS_ENV, raising=False)
        variables = jlfn._get_variables(None, True, as_numpy=True)
    net = lfn.LiteFlowNet()
    net.load_state_dict(lfn.params_from_jax(variables))
    return variables, net.eval().requires_grad_(False)


def _pair(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 8, w + 8, 3), dtype=np.uint8)
    return base[4:4 + h, 4:4 + w], base[:h, 2:2 + w]


@pytest.fixture
def fresh_jax_traces():
    """The JAX network's jitted entry keeps its traces for the life of the
    process, and the JAX package's own tests count the kernel calls that a
    new trace makes (tests/test_pallas_warp.py): leave no trace behind."""
    yield
    jlfn._run.clear_cache()


def test_liteflownet_bounded_matches_jax(nets, monkeypatch,
                                         fresh_jax_traces):
    """``liteflownet(warp_bound=8)`` at 64x96 in f32: 9 bounded warps per
    frame with the per-level bounds of ``_warp_bound`` ([8, 4, 3, 3, 3]
    for levels 2-6), and flows within the network bar of JAX's."""
    variables, net = nets
    monkeypatch.delenv("TRANSFLOW_LITEFLOWNET_BF16", raising=False)
    monkeypatch.delenv(lfn.WARP_BOUND_ENV, raising=False)
    monkeypatch.delenv(lfn.WARP_KERNEL_ENV, raising=False)
    calls = []
    monkeypatch.setattr(warp, "bounded_backwarp_plain",
                        lambda *a: calls.append(a[2]) or
                        bounded_backwarp_plain(*a))
    a, b = _pair(64, 96, 5)
    want = np.asarray(jlfn.liteflownet(a, b, params=variables, warp_bound=8))
    got = lfn.liteflownet(torch.from_numpy(a), torch.from_numpy(b), net=net,
                          warp_bound=8)
    # subpixel6, then matching and subpixel at levels 5, 4, 3, 2
    assert calls == [3, 3, 3, 3, 3, 4, 4, 8, 8]
    assert got.shape == want.shape == (64, 96, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=NET_TOL, rtol=NET_TOL)
    calls.clear()
    lfn.liteflownet(torch.from_numpy(a), torch.from_numpy(b), net=net,
                    warp_bound=0)
    assert calls == []          # 0: the exact gather


def test_liteflownet_env_bound_per_call(nets, monkeypatch):
    """The env fallback is read on each call, as in JAX."""
    _, net = nets
    calls = []
    monkeypatch.setattr(warp, "bounded_backwarp_plain",
                        lambda *a: calls.append(a[2]) or
                        bounded_backwarp_plain(*a))
    monkeypatch.delenv(lfn.WARP_BOUND_ENV, raising=False)
    img = torch.zeros((64, 96), dtype=torch.uint8)
    lfn.liteflownet(img, img, net=net)
    assert calls == []
    monkeypatch.setenv(lfn.WARP_BOUND_ENV, "16")
    lfn.liteflownet(img, img, net=net)
    assert max(calls) == 16 and min(calls) == 3 and len(calls) == 9


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,bound", [((34, 60, 8), 3),
                                         ((136, 240, 4), 4)], ids=str)
def test_grid_sample_yardstick_is_a3(shape, bound, dtype):
    """chip_smoke's library yardstick for A3, ``F.grid_sample`` on the
    bf16-rounded image, computes A3's function within the bound, within
    its stated tolerance; the other corner convention lies well outside
    it."""
    import chip_smoke
    h, w, c = shape
    image = torch.from_numpy(_image(shape, 21)).to(dtype)
    flow = torch.from_numpy(_flow("within", (h, w), bound, 22))
    want = bounded_backwarp_plain(image, flow, bound)
    got = chip_smoke.grid_sample_warp(image, flow)()[0].permute(1, 2, 0)
    tol = chip_smoke.grid_sample_tol(image, h, w)
    assert (got - want).abs().max().item() <= tol
    nchw = image.to(torch.bfloat16).float().permute(2, 0, 1)[None]
    ys = torch.arange(h, dtype=torch.float32)[:, None]
    xs = torch.arange(w, dtype=torch.float32)[None, :]
    grid = torch.stack([(xs + flow[..., 0]) * (2 / (w - 1)) - 1,
                        (ys + flow[..., 1]) * (2 / (h - 1)) - 1], -1)[None]
    other = torch.nn.functional.grid_sample(
        nchw, grid, mode="bilinear", padding_mode="zeros",
        align_corners=False)[0].permute(1, 2, 0)
    assert (other - want).abs().max().item() > 100 * tol

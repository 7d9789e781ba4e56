"""The port's LiteFlowNet against the JAX package's, on the CPU in f32.

Weights: the JAX random branch (both packages draw the same leaves), and
the synthetic sniklaus state of tests/test_liteflownet.py, whose output of
the reference torch network is committed as a golden.
"""
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from transflow_tpu.flow.estimators import liteflownet as jlfn
from transflow_tpu.ops.image import torch_bilinear_resize as jax_resize
from transflow_tpu_torch.flow.estimators import liteflownet as lfn
from transflow_tpu_torch.ops.image import torch_bilinear_resize

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
# the JAX package's bar for the assembled network against the reference
# torch net (tests/test_liteflownet_parity.py:246-247): f32 on both sides,
# summation orders differ through ~40 layers
NET_TOL = 1e-3


@pytest.fixture(scope="module")
def jax_variables():
    """The JAX package's random weights (its TRANSFLOW_LITEFLOWNET_RANDOM
    branch), drawn into an empty cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlfn, "_CACHE", {})
        mp.delenv(jlfn.WEIGHTS_ENV, raising=False)
        return jlfn._get_variables(None, True, as_numpy=True)


@pytest.fixture(scope="module")
def port_net(jax_variables):
    net = lfn.LiteFlowNet()
    net.load_state_dict(lfn.params_from_jax(jax_variables))
    return net.eval().requires_grad_(False)


@pytest.fixture(autouse=True)
def _f32(monkeypatch):
    monkeypatch.delenv("TRANSFLOW_LITEFLOWNET_BF16", raising=False)


def test_params_from_jax_round_trips_every_leaf(jax_variables):
    state = lfn.params_from_jax(jax_variables)
    leaves = jax.tree_util.tree_flatten_with_path(jax_variables["params"])[0]
    assert len(leaves) == len(state)
    for path, leaf in leaves:
        names = [p.key for p in path]
        key = ".".join(names[:-1] + [
            "weight" if names[-1] == "kernel" else names[-1]])
        if names[-1].endswith("_kernel"):
            key = ".".join(names)
            back = state[key][:, 0].permute(1, 2, 0)
        elif names[-1] == "kernel":
            back = state[key].permute(2, 3, 1, 0)
        else:
            back = state[key]
        np.testing.assert_array_equal(back.numpy(), np.asarray(leaf),
                                      err_msg=key)


def test_random_params_match_jax_random_branch(jax_variables):
    want = lfn.params_from_jax(jax_variables)
    got = lfn.random_params(0)
    assert list(got) == list(want) or set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_backwarp_matches_jax(dtype):
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.standard_normal((20, 30, 5))
                             .astype(np.float32)).to(dtype)
    flow = rng.uniform(-8, 8, (20, 30, 2)).astype(np.float32)
    flow[::3, ::4] = np.round(flow[::3, ::4])       # exact taps
    flow[0, :, 1] = -40.0                           # deep out of bounds
    want = jlfn.backwarp(
        jnp.asarray(image.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(flow))
    got = lfn.backwarp(image, torch.from_numpy(flow))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_phase_upsampler_matches_jax_and_conv_transpose(dtype):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((7, 9, 3))
                         .astype(np.float32)).to(dtype)
    weight = torch.from_numpy(rng.standard_normal((3, 1, 4, 4))
                              .astype(np.float32))
    got = lfn._upsample2x_phases(x, weight)
    want = jlfn._upsample2x_phases(
        jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(weight[:, 0].permute(1, 2, 0).numpy()))
    assert got.dtype == dtype and got.shape == (14, 18, 3)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-6, rtol=0)
    if dtype == torch.float32:
        deconv = F.conv_transpose2d(x.permute(2, 0, 1)[None], weight,
                                    stride=2, padding=1, groups=3)
        np.testing.assert_allclose(got.numpy(),
                                   deconv[0].permute(1, 2, 0).numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [((16, 24, 3), (32, 48)),
                                     ((16, 24, 6), (8, 12)),
                                     ((50, 70, 3), (64, 96)),
                                     ((64, 96, 2), (50, 70)),
                                     ((23, 31), (64, 64))], ids=str)
def test_bilinear_resize_matches_jax(src, dst):
    """F.interpolate(bilinear, align_corners=False, antialias=False) has the
    semantics the JAX package's torch_bilinear_resize emulates."""
    x = np.random.default_rng(2).standard_normal(src).astype(np.float32)
    got = torch_bilinear_resize(torch.from_numpy(x), *dst)
    want = np.asarray(jax_resize(jnp.asarray(x), *dst))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def _frames(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 4, w + 4, 3), dtype=np.uint8)
    return base[2:2 + h, 2:2 + w], base[:h, 1:1 + w]


def test_full_network_matches_jax(jax_variables, port_net):
    a, b = _frames(64, 96, 3)
    img1 = a.astype(np.float32) / 255.0
    img2 = b.astype(np.float32) / 255.0
    want = np.asarray(jlfn._run(jax_variables, jnp.asarray(img1),
                                jnp.asarray(img2)))
    got = port_net(torch.from_numpy(img1), torch.from_numpy(img2))
    assert got.shape == want.shape == (32, 48, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=NET_TOL,
                               rtol=NET_TOL)


@pytest.mark.parametrize("h,w", [(64, 96), (70, 90)])
def test_estimator_entry_matches_jax(jax_variables, port_net, h, w):
    """BGR flip, /255, resize to /32, resize back, magnitude rescale."""
    a, b = _frames(h, w, 4)
    want = np.asarray(jlfn.liteflownet(a, b, params=jax_variables))
    got = lfn.liteflownet(torch.from_numpy(a), torch.from_numpy(b),
                          net=port_net)
    assert got.shape == want.shape == (h, w, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=NET_TOL,
                               rtol=NET_TOL)


@pytest.fixture(scope="module")
def golden():
    from test_liteflownet import build_random_state, state_checksum
    data = np.load(os.path.join(FIXTURES, "liteflownet_fullnet_golden.npz"))
    state = build_random_state()
    assert state_checksum(state) == bytes(data["state_sha256"]).hex()
    return data, state


def test_matches_reference_net_golden(golden):
    """The port on the synthetic sniklaus state against the reference
    torch network's committed outputs: the assembled net and the
    estimate() entry on a non-/32 uint8 pair."""
    data, state = golden
    net = lfn.LiteFlowNet()
    net.load_state_dict(lfn.params_from_torch_state(state))
    net.eval().requires_grad_(False)
    flow = net(torch.from_numpy(data["fullnet_img1"]),
               torch.from_numpy(data["fullnet_img2"]))
    np.testing.assert_allclose(flow.numpy(), data["fullnet_flow"],
                               atol=NET_TOL, rtol=NET_TOL)
    flow = lfn.liteflownet(torch.from_numpy(data["estimate_frame1"]),
                           torch.from_numpy(data["estimate_frame2"]),
                           net=net)
    np.testing.assert_allclose(flow.numpy(), data["estimate_flow"],
                               atol=NET_TOL, rtol=NET_TOL)


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_checkpoint_loader(golden, tmp_path, monkeypatch, legacy):
    """TRANSFLOW_LITEFLOWNET_WEIGHTS: a torch.save'd sniklaus state dict
    ('module' prefixes, as published) loads with weights_only."""
    _, state = golden
    path = str(tmp_path / "network-default.pytorch")
    torch.save({k.replace("net", "module"): torch.from_numpy(v)
                for k, v in state.items()}, path,
               _use_new_zipfile_serialization=not legacy)
    want = lfn.params_from_torch_state(state)
    got = lfn.load_torch_weights(path)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    monkeypatch.setenv(lfn.WEIGHTS_ENV, path)
    net = lfn.get_weights(device="cpu")
    for key, value in net.state_dict().items():
        assert torch.equal(value, want[key]), key


def test_get_weights_needs_a_source(monkeypatch):
    monkeypatch.delenv(lfn.WEIGHTS_ENV, raising=False)
    monkeypatch.delenv(lfn.RANDOM_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match="network-default"):
        lfn.get_weights(device="cpu")
    monkeypatch.setenv(lfn.RANDOM_ENV, "1")
    net = lfn.get_weights(device="cpu")
    assert torch.equal(net.features.one0.weight,
                       lfn.random_params(0)["features.one0.weight"])


def test_compute_dtype(monkeypatch):
    assert lfn._compute_dtype("cpu") == torch.float32
    assert lfn._compute_dtype(torch.device("cuda", 0)) == torch.bfloat16
    monkeypatch.setenv("TRANSFLOW_LITEFLOWNET_BF16", "0")
    assert lfn._compute_dtype("cuda") == torch.float32


def test_unported_options_raise(port_net):
    """Overrides are checked before the network runs: 'pallas_halo' needs
    a mesh, and an unknown correlation kernel is refused."""
    a = torch.zeros(32, 32, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="needs a mesh"):
        lfn.liteflownet(a, a, net=port_net, corr_kernel="pallas_halo")
    with pytest.raises(ValueError, match="must be"):
        lfn.liteflownet(a, a, net=port_net, corr_kernel="cuda")


def test_bf16_conv_bias_order_matches_flax():
    """The conv is rounded to bf16, then the bias is added in bf16, as in
    Flax's ``nn.Conv(dtype=bfloat16)``. The case tells the orders apart: a
    1x1 conv whose exact f32 sum 1 + 2^-8 lies half-way between two bf16
    values (it rounds to even, 1.0) and a bias of 2^-9, which rounds back
    to 1.0 when added after the rounding, and up to 1 + 2^-7 when added
    before it."""
    import flax.linen as nn
    x = np.array([[[[1.0, 1.0]]]], np.float32)         # (N, H, W, 2)
    w = np.array([1.0, 2.0 ** -8], np.float32)
    b = np.array([2.0 ** -9], np.float32)
    flax_conv = nn.Conv(1, (1, 1), dtype=jnp.bfloat16,
                        param_dtype=jnp.float32)
    want = flax_conv.apply(
        {"params": {"kernel": jnp.asarray(w.reshape(1, 1, 2, 1)),
                    "bias": jnp.asarray(b)}}, jnp.asarray(x))
    conv = lfn._Conv(2, 1, 1, pad=0)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.reshape(1, 2, 1, 1)))
        conv.bias.copy_(torch.from_numpy(b))
        got = conv(torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert got.item() == 1.0
    rounded_once = torch.tensor(1 + 2.0 ** -8 + 2.0 ** -9).bfloat16()
    assert rounded_once.item() == 1 + 2.0 ** -7

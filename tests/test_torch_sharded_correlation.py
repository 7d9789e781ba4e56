"""The port's H-sharded correlation (kernel A2) against the JAX package's.

The JAX side runs ``sharded_pallas_correlation7x7`` as its own tests do:
on the 8-device virtual CPU mesh of tests/conftest.py, in interpret mode.
The port runs the same inputs over ``SpaceMesh(["cpu"] * n)``: real
shards and a real halo exchange, each shard's band computation in its
plain version (the CUDA band kernel is held to A1 on the card by
tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transflow_tpu.flow.estimators import liteflownet as jlfn
from transflow_tpu.ops.pallas_correlation import (
    pallas_correlation7x7, sharded_ok as jax_sharded_ok,
    sharded_pallas_correlation7x7)
from transflow_tpu.parallel.mesh import make_space_mesh as jax_space_mesh
from transflow_tpu_torch.flow.estimators import liteflownet as lfn
from transflow_tpu_torch.ops import correlation as corr
from transflow_tpu_torch.parallel import SpaceMesh

# the JAX package's own bar for the sharded kernel against the unsharded
# one (tests/test_sharded_correlation.py:47), where both sides share one
# arithmetic. The plain version sums the channels in another order than
# the Pallas kernel in interpret mode, which moves a value by up to one
# f32 ulp (2.4e-7 where |out| >= 2): hence 2 ulp relative beside it. Within
# the port, sharded and unsharded are bit-equal.
ATOL = 2e-7
RTOL = 2.0 ** -22
# f32 network on both sides (tests/test_torch_liteflownet.py's bar)
NET_TOL = 1e-3


def _pair(shape, seed, t1=np.float32, t2=np.float32):
    """Seeded (torch f1, torch f2, jax f1, jax f2) in the given dtypes."""
    rng = np.random.default_rng(seed)
    out = []
    for dtype in (t1, t2):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out.append(x.bfloat16() if dtype == "bf16" else x)
    jax_ops = [jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
        for x in out]
    return out + jax_ops


@pytest.fixture
def count_bands(monkeypatch):
    """Counts the shards' band computations (the plain version, on CPU
    shards)."""
    calls = []
    plain = corr.correlation7x7_band
    monkeypatch.setattr(corr, "correlation7x7_band",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    return calls


@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("stride,h", [(1, 64), (2, 128)])
def test_sharded_matches_jax(stride, h, c, count_bands):
    f1, f2, j1, j2 = _pair((h, 48, c), 1)
    want = np.asarray(sharded_pallas_correlation7x7(
        j1, j2, jax_space_mesh(4), stride=stride, interpret=True))
    got = corr.sharded_correlation7x7(f1, f2, SpaceMesh(["cpu"] * 4), stride)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert count_bands == [(h // 4, 48, c)] * 4
    # and the unsharded plain version, bit for bit
    np.testing.assert_array_equal(
        got.numpy(), corr.correlation7x7(f1, f2, stride).numpy())


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_other_shard_counts(n):
    f1, f2, j1, j2 = _pair((64, 40, 8), 2)
    want = np.asarray(sharded_pallas_correlation7x7(
        j1, j2, jax_space_mesh(n), stride=1, interpret=True))
    got = corr.sharded_correlation7x7(f1, f2, SpaceMesh(["cpu"] * n), 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(),
                                  corr.correlation7x7(f1, f2, 1).numpy())


@pytest.mark.parametrize("pair", [("bf16", np.float32), ("bf16", "bf16")],
                         ids=["bf16/f32", "bf16/bf16"])
def test_mixed_dtype_staging(pair):
    """Each operand stages in its own dtype; the exchanged rows keep f2's."""
    f1, f2, j1, j2 = _pair((64, 48, 16), 3, *pair)
    want = np.asarray(pallas_correlation7x7(j1, j2, stride=1,
                                            interpret=True))
    got = corr.sharded_correlation7x7(f1, f2, SpaceMesh(["cpu"] * 4), 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_edge_rows_get_zero_halo():
    """A constant f2 everywhere: the first and last shards' edge rows must
    see the frame's zero padding, not wrapped rows (bit-equal)."""
    f1 = torch.ones((64, 48, 16))
    f2 = torch.full((64, 48, 16), 7.0)
    want = np.asarray(pallas_correlation7x7(
        jnp.asarray(f1.numpy()), jnp.asarray(f2.numpy()), stride=1,
        interpret=True))
    got = corr.sharded_correlation7x7(f1, f2, SpaceMesh(["cpu"] * 4), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 10, 0] == 0.0 and got[-1, 10, 48] == 0.0


def test_band_plain_version():
    """``correlation7x7_band`` reads f2 through its row window: a buffer
    that holds f2 with zero rows around it (row0 > 0), or with fewer rows
    above than the window reaches, gives ``correlation7x7`` bit for bit."""
    f1, f2, _, _ = _pair((20, 16, 4), 4)
    for stride in (1, 2):
        full = corr.correlation7x7(f1, f2, stride).numpy()
        pad = 3 * stride
        zeros = torch.zeros((pad, 16, 4))
        for buf, row0 in ((f2, 0), (torch.cat([zeros, f2, zeros]), pad),
                          (torch.cat([zeros[:2], f2]), 2)):
            np.testing.assert_array_equal(
                corr.correlation7x7_band(f1, buf, stride, row0).numpy(),
                full)


@pytest.mark.parametrize("h", range(8, 200, 4))
def test_sharded_ok_matches_jax_and_keeps_even_rows(h):
    """The shape rule is JAX's, and at stride 2 it only admits shards that
    start on an even global row."""
    for n in (1, 2, 3, 4, 8):
        for stride in (1, 2):
            ok = corr.sharded_ok(h, n, stride)
            assert ok == jax_sharded_ok(h, n, stride)
            if ok and stride == 2:
                assert all((i * (h // n)) % 2 == 0 for i in range(n))


def test_pallas_halo_dispatch_and_fallback(count_bands):
    mesh = SpaceMesh(["cpu"] * 4)
    f1, f2, j1, j2 = _pair((64, 48, 16), 5)
    want = np.asarray(pallas_correlation7x7(j1, j2, stride=1,
                                            interpret=True))
    got = corr.correlation(f1, f2, 1, kernel="pallas_halo", mesh=mesh)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert len(count_bands) == 4
    # H=20 does not shard over 4: the unsharded correlation, by shape
    f1s, f2s, _, _ = _pair((20, 48, 16), 6)
    assert not corr.sharded_ok(20, 4, 1)
    got = corr.correlation(f1s, f2s, 1, kernel="pallas_halo", mesh=mesh)
    np.testing.assert_array_equal(got.numpy(),
                                  corr.correlation7x7(f1s, f2s, 1).numpy())
    assert len(count_bands) == 4


def test_pallas_halo_requires_mesh():
    f1, _, _, _ = _pair((16, 24, 8), 9)
    with pytest.raises(ValueError, match="mesh"):
        corr.correlation(f1, f1, kernel="pallas_halo")


def test_sharded_entry_rejects_indivisible():
    f1, _, _, _ = _pair((20, 48, 16), 10)
    with pytest.raises(ValueError, match="shard"):
        corr.sharded_correlation7x7(f1, f1, SpaceMesh(["cpu"] * 4), 1)
    with pytest.raises(ValueError, match="shard"):   # shards below 8 rows
        corr.sharded_correlation7x7(f1[:12], f1[:12], SpaceMesh(["cpu"] * 2),
                                    1)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The correlation kernel runs on CUDA tensors only: no CPU
    fallback."""
    f = torch.zeros(8, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        corr.correlation7x7_cuda(f, f, 1)


@pytest.fixture(scope="module")
def jax_variables():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlfn, "_CACHE", {})
        mp.delenv(jlfn.WEIGHTS_ENV, raising=False)
        return jlfn._get_variables(None, True, as_numpy=True)


def test_liteflownet_corr_mesh_matches_jax(jax_variables, count_bands,
                                           monkeypatch):
    """The network with the --mesh correlation config against JAX's same
    call at 64x96 over 2 shards: level 2 (H=32, stride 2) rides the
    sharded computation, the coarser levels the unsharded one. The band
    count guards against a silent all-levels fallback."""
    monkeypatch.delenv("TRANSFLOW_LITEFLOWNET_BF16", raising=False)
    net = lfn.LiteFlowNet()
    net.load_state_dict(lfn.params_from_jax(jax_variables))
    net.eval().requires_grad_(False)
    rng = np.random.default_rng(11)
    prev = rng.integers(0, 256, (64, 96), np.uint8)
    nxt = np.roll(prev, 2, axis=1)
    want = np.asarray(jlfn.liteflownet(
        prev, nxt, params=jax_variables, corr_kernel="pallas_halo",
        corr_mesh=jax_space_mesh(2)))
    got = lfn.liteflownet(torch.from_numpy(prev), torch.from_numpy(nxt),
                          net=net, corr_kernel="pallas_halo",
                          corr_mesh=SpaceMesh(["cpu"] * 2))
    assert got.shape == want.shape == (64, 96, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=NET_TOL, rtol=NET_TOL)
    assert count_bands == [(16, 48, 64)] * 2


@pytest.mark.parametrize("pair", [("bf16", np.float32), ("bf16", "bf16")],
                         ids=["bf16/f32", "bf16/bf16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("edge", ["first", "middle", "last", "alone"])
def test_segments_plain_equals_band(edge, stride, pair):
    """``correlation7x7_segments`` (the CPU twin of the kernel's sharded
    entry) equals ``correlation7x7_band`` over the concatenated band bit
    for bit; an absent halo stands for the frame's zero rows."""
    pad = 3 * stride
    f1, f2, _, _ = _pair((16, 24, 8), 12, *pair)
    _, halo, _, _ = _pair((2 * pad, 24, 8), 13, *pair)
    top = None if edge in ("first", "alone") else halo[:pad]
    bottom = None if edge in ("last", "alone") else halo[pad:]
    zeros = torch.zeros((pad, 24, 8), dtype=f2.dtype)
    band = torch.cat([zeros if top is None else top, f2,
                      zeros if bottom is None else bottom])
    got = corr.correlation7x7_segments(f1, top, f2, bottom, stride)
    np.testing.assert_array_equal(
        got.numpy(), corr.correlation7x7_band(f1, band, stride, pad).numpy())


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("stride", [1, 2])
def test_shard_descriptors(n, stride):
    """The sharded entry's descriptors: each shard's f1 rows, its own f2
    rows and its neighbours' 3s halo rows as views of the operands (read
    in place: no copy, no zero rows; none at the frame's edges), and its
    first output row."""
    h, w, c = 16 * n * stride, 10, 8
    pad, rows, out_rows = 3 * stride, h // n, h // n // stride
    f1 = torch.zeros((h, w, c), dtype=torch.bfloat16)
    f2 = torch.zeros((h, w, c))
    out = torch.empty((h // stride, w // stride, 49))
    shards = corr.shard_segments(f1, f2, SpaceMesh(["cpu"] * n), stride)
    table = corr.shard_table(shards, out, [s.out_row0 for s in shards])
    assert len(shards) == n and len(table) == 9 * n
    f1_row, f2_row = w * c * 2, w * c * 4
    out_row = (w // stride) * 49 * 4
    for i, s in enumerate(shards):
        top = (f2.data_ptr() + (i * rows - pad) * f2_row, pad) if i else (0, 0)
        bottom = ((f2.data_ptr() + (i + 1) * rows * f2_row, pad)
                  if i < n - 1 else (0, 0))
        assert s.out_row0 == i * out_rows
        assert table[9 * i:9 * i + 9] == [
            f1.data_ptr() + i * rows * f1_row, rows, *top,
            f2.data_ptr() + i * rows * f2_row, rows, *bottom,
            out.data_ptr() + i * out_rows * out_row]
    # ``one_card_table`` gives the same descriptors from addresses alone
    assert corr.one_card_table(f1, f2, out, n, stride) == table


def test_sharded_launch_refuses_cpu_tensors():
    """The sharded entry runs on CUDA tensors only: no CPU fallback."""
    f = torch.zeros(32, 8, 4)
    shards = corr.shard_segments(f, f, SpaceMesh(["cpu"] * 2), 1)
    with pytest.raises(ValueError, match="CUDA"):
        corr._launch_shards(shards, torch.empty(32, 8, 49), [0, 16], 1)

"""LiteFlowNet's head loops in the port (kernels B16 and B17's plain
versions and dispatchers, ``ops/lfn_heads.py``) against the JAX package on
the CPU.

B16's plain version is the JAX function's phase decomposition op for op:
it is held to ``jlfn._upsample2x_phases`` within ``UP_TOL`` = 1e-6 (f32
products and sums in one order on both sides; the bf16 results round the
same f32 sums). B17's plain version is the JAX module's fused apply with
the softmax's sum taken tap by tap: the port's ``Regularization`` at each
level is held to JAX's ``Regularization(lvl)`` with the same weights
within ``REG_TOL`` = 1e-5, the JAX package's own bar between its two apply
paths (tests/test_liteflownet.py:289), the convolutions summing in other
orders; and ``reg_apply_plain`` to a float64 numpy version of the formula
within ``F64_TOL`` = 1e-5 (float32 rounding of up to 49 terms a sum, of
outputs of |values| < 10).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transflow_tpu.flow.estimators import liteflownet as jlfn
from transflow_tpu_torch.flow.estimators import liteflownet as lfn
from transflow_tpu_torch.ops import lfn_heads
from transflow_tpu_torch.ops.lfn_heads import (reg_apply, reg_apply_cuda,
                                               reg_apply_plain,
                                               upsample2x_phases,
                                               upsample2x_phases_cuda,
                                               upsample2x_phases_plain)

UP_TOL = 1e-6
REG_TOL = 1e-5
F64_TOL = 1e-5
BF16, F32 = torch.bfloat16, torch.float32
# (h, w, C, dtype): the flow (C=2, f32) and the cost volume (C=49) on odd
# and even shapes; then the card tests' edges of the kernel's tiling, where
# this plain version is their reference: a single row, a single column,
# one pixel, C of 1, 3 and 64
UP_CASES = [(7, 9, 2, F32), (8, 12, 2, F32), (5, 6, 49, BF16),
            (9, 11, 49, BF16), (6, 7, 49, F32), (4, 10, 2, BF16),
            (1, 9, 49, F32), (7, 1, 3, BF16), (1, 1, 2, F32),
            (13, 17, 1, F32), (5, 9, 64, BF16)]


def _upsample_inputs(h, w, c, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((h, w, c))
                         .astype(np.float32)).to(dtype)
    weight = torch.from_numpy(rng.standard_normal((c, 1, 4, 4))
                              .astype(np.float32))
    return x, weight


@pytest.mark.parametrize("case", UP_CASES, ids=str)
def test_upsample_plain_matches_jax(case):
    h, w, c, dtype = case
    x, weight = _upsample_inputs(h, w, c, dtype, h * w + c)
    got = upsample2x_phases_plain(x, weight)
    jx = jnp.asarray(x.float().numpy())
    if dtype == BF16:
        jx = jx.astype(jnp.bfloat16)
    want = jlfn._upsample2x_phases(
        jx, jnp.asarray(weight[:, 0].permute(1, 2, 0).numpy()))
    assert got.dtype == dtype and got.shape == (2 * h, 2 * w, c)
    assert want.dtype == jx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=UP_TOL, rtol=0)


def _reg_inputs(h, w, size, dist_dtype, flow_dtype, seed):
    """Distances of |values| up to ~3 (some taps far below the largest),
    a flow of +-8 px with whole values on a third of the pixels, and the
    scale convolutions' parameters in the module's shapes."""
    rng = np.random.default_rng(seed)
    taps = size * size
    dist = torch.from_numpy((1.2 * rng.standard_normal((h, w, taps)))
                            .astype(np.float32)).to(dist_dtype)
    flow = rng.uniform(-8, 8, (h, w, 2))
    flow[::3] = np.round(flow[::3])
    flow = torch.from_numpy(flow.astype(np.float32)).to(flow_dtype)
    params = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              for shape in ((1, taps, 1, 1), (1,), (1, taps, 1, 1), (1,))]
    return dist, flow, params


def _reg_f64(dist, flow, wx, bx, wy, by):
    """B17's formula in float64 numpy: softmax over the taps, the tap
    apply over the zero-padded flow, the bias, the division."""
    d = -np.square(dist.double().numpy())
    e = np.exp(d - d.max(axis=-1, keepdims=True))
    h, w, taps = d.shape
    size = int(round(taps ** 0.5))
    pad = (size - 1) // 2
    f = np.pad(flow.double().numpy(), ((pad, pad), (pad, pad), (0, 0)))
    out = np.zeros((h, w, 2))
    for k in range(taps):
        dy, dx = divmod(k, size)
        tap = f[dy:dy + h, dx:dx + w]
        out[..., 0] += wx.reshape(-1)[k].item() * e[..., k] * tap[..., 0]
        out[..., 1] += wy.reshape(-1)[k].item() * e[..., k] * tap[..., 1]
    out[..., 0] += bx.item()
    out[..., 1] += by.item()
    return out / e.sum(axis=-1, keepdims=True)


@pytest.mark.parametrize("flow_dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dist_dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("size,shape", [(3, (9, 13)), (5, (12, 17)),
                                        (7, (11, 20)), (7, (3, 2)),
                                        (7, (9, 33)), (5, (10, 65)),
                                        (3, (1, 33)), (5, (31, 1))],
                         ids=str)
def test_reg_apply_plain_matches_float64(size, shape, dist_dtype,
                                         flow_dtype):
    dist, flow, params = _reg_inputs(*shape, size, dist_dtype, flow_dtype,
                                     size + shape[1])
    got = reg_apply_plain(dist, flow, *params)
    assert got.dtype == F32 and got.shape == (*shape, 2)
    np.testing.assert_allclose(got.numpy(), _reg_f64(dist, flow, *params),
                               atol=F64_TOL, rtol=F64_TOL)


def test_reg_apply_plain_keeps_a_nan():
    """A NaN distance makes its pixel's softmax NaN (``amax`` keeps it),
    and that pixel alone: the flow taps carry no distance."""
    dist, flow, params = _reg_inputs(8, 9, 5, F32, F32, 1)
    dist[3, 4, 7] = float("nan")
    got = reg_apply_plain(dist, flow, *params)
    nan = torch.isnan(got).any(dim=-1)
    assert nan[3, 4] and nan.sum() == 1


def test_reg_apply_plain_zero_bias_and_zero_flow_give_zero():
    """``acc`` starts from +0.0 as JAX's ``zeros`` do: a zero flow with
    zero biases gives +0.0 everywhere, whatever the taps' signs."""
    dist, _, params = _reg_inputs(6, 7, 3, F32, F32, 2)
    params[1].zero_()
    params[3].zero_()
    got = reg_apply_plain(dist, torch.zeros((6, 7, 2)), *params)
    assert torch.equal(got, torch.zeros_like(got))
    assert not torch.signbit(got).any()


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


@pytest.mark.parametrize("lvl", [2, 3, 4, 5, 6])
def test_regularization_matches_jax(jax_variables, port_net, lvl,
                                    monkeypatch):
    """The port's ``Regularization`` (the tap apply through ``reg_apply``
    and, on the CPU, its plain version) against JAX's module with the
    same weights, on seeded 24x40 inputs: images in [0, 1), features and
    a flow of a few pixels."""
    monkeypatch.delenv("TRANSFLOW_LITEFLOWNET_BF16", raising=False)
    calls = []
    monkeypatch.setattr(lfn_heads, "reg_apply_plain",
                        lambda *a: calls.append(a[0].shape)
                        or reg_apply_plain(*a))
    rng = np.random.default_rng(lvl)
    h, w = 24, 40
    img1, img2 = (rng.random((h, w, 3)).astype(np.float32)
                  for _ in range(2))
    feat1 = rng.standard_normal((h, w, lfn._FEAT_CH[lvl])).astype(np.float32)
    flow = rng.uniform(-3, 3, (h, w, 2)).astype(np.float32)
    want = np.asarray(jlfn.Regularization(lvl).apply(
        {"params": jax_variables["params"][f"regularization{lvl}"]},
        *map(jnp.asarray, (img1, img2, feat1, flow))))
    module = getattr(port_net, f"regularization{lvl}")
    with torch.no_grad():
        got = module(*map(torch.from_numpy, (img1, img2, feat1, flow)),
                     torch.float32)
    taps = lfn._KERNEL[lvl] ** 2
    assert calls == [(h, w, taps)]
    assert got.shape == want.shape == (h, w, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=REG_TOL,
                               rtol=REG_TOL)


def test_network_takes_each_head_through_its_dispatcher(port_net,
                                                        monkeypatch):
    """One forward runs 6 phase upsamples (the flow at levels 5-2, the
    cost volume at 3 and 2) and 5 tap applies (one a level): on the CPU
    the plain versions, as many times as the card launches B16 and B17."""
    calls = {"up": [], "reg": []}
    monkeypatch.setattr(lfn_heads, "upsample2x_phases_plain",
                        lambda x, wt: calls["up"].append(tuple(x.shape))
                        or upsample2x_phases_plain(x, wt))
    monkeypatch.setattr(lfn_heads, "reg_apply_plain",
                        lambda *a: calls["reg"].append(tuple(a[0].shape))
                        or reg_apply_plain(*a))
    rng = np.random.default_rng(9)
    i1, i2 = (torch.from_numpy(rng.random((64, 96, 3)).astype(np.float32))
              for _ in range(2))
    before = (upsample2x_phases_cuda.launches, reg_apply_cuda.launches)
    with torch.no_grad():
        port_net(i1, i2)
    assert calls["up"] == [(2, 3, 2), (4, 6, 2), (8, 12, 2), (8, 12, 49),
                           (16, 24, 2), (16, 24, 49)]
    assert calls["reg"] == [(2, 3, 9), (4, 6, 9), (8, 12, 25), (16, 24, 25),
                            (32, 48, 49)]
    assert (upsample2x_phases_cuda.launches,
            reg_apply_cuda.launches) == before


def test_dispatch_by_device():
    x, weight = _upsample_inputs(5, 7, 2, F32, 4)
    dist, flow, params = _reg_inputs(5, 7, 3, F32, F32, 5)
    before = (upsample2x_phases_cuda.launches, reg_apply_cuda.launches)
    assert torch.equal(upsample2x_phases(x, weight),
                       upsample2x_phases_plain(x, weight))
    assert torch.equal(reg_apply(dist, flow, *params),
                       reg_apply_plain(dist, flow, *params))
    assert (upsample2x_phases_cuda.launches,
            reg_apply_cuda.launches) == before
    with pytest.raises(ValueError, match="no path for device"):
        upsample2x_phases(x.to("meta"), weight.to("meta"))
    with pytest.raises(ValueError, match="no path for device"):
        reg_apply(dist.to("meta"), flow.to("meta"),
                  *(p.to("meta") for p in params))


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("rank", r"\(h, w, C\)"),
    ("empty", "non-empty"),
    ("taps shape", r"\(C, 1, 4, 4\)"),
    ("dtype", "float32 or bfloat16"),
    ("taps dtype", "float32 taps"),
])
def test_upsample_cuda_refuses_misuse(case, match):
    """The wrapper raises before any launch: on CPU tensors (it never runs
    the plain version) and on shapes or dtypes the kernel does not take."""
    x, weight = torch.zeros((4, 5, 3)), torch.zeros((3, 1, 4, 4))
    if case == "rank":
        x = torch.zeros((4, 5))
    elif case == "empty":
        x = torch.zeros((0, 5, 3))
    elif case == "taps shape":
        weight = torch.zeros((3, 4, 4))
    elif case == "dtype":
        x = x.half()
    elif case == "taps dtype":
        weight = weight.double()
    before = upsample2x_phases_cuda.launches
    with pytest.raises(ValueError, match=match):
        upsample2x_phases_cuda(x, weight)
    assert upsample2x_phases_cuda.launches == before


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("window", r"S in \(3, 5, 7\)"),
    ("not square", r"S in \(3, 5, 7\)"),
    ("flow shape", r"\(H, W, 2\) flow"),
    ("empty", "non-empty"),
    ("dtype", "float32 or bfloat16"),
    ("flow dtype", "float32 or bfloat16"),
    ("taps", "taps of 9 values"),
    ("bias", "biases of one"),
    ("taps dtype", "float32 taps"),
])
def test_reg_apply_cuda_refuses_misuse(case, match):
    dist, flow = torch.zeros((4, 5, 9)), torch.zeros((4, 5, 2))
    wx, bx, wy, by = (torch.zeros((1, 9, 1, 1)), torch.zeros(1),
                      torch.zeros((1, 9, 1, 1)), torch.zeros(1))
    if case == "window":
        dist = torch.zeros((4, 5, 81))
    elif case == "not square":
        dist = torch.zeros((4, 5, 10))
    elif case == "flow shape":
        flow = torch.zeros((4, 6, 2))
    elif case == "empty":
        dist, flow = torch.zeros((0, 5, 9)), torch.zeros((0, 5, 2))
    elif case == "dtype":
        dist = dist.half()
    elif case == "flow dtype":
        flow = flow.double()
    elif case == "taps":
        wy = torch.zeros(8)
    elif case == "bias":
        bx = torch.zeros(2)
    elif case == "taps dtype":
        wx = wx.double()
    before = reg_apply_cuda.launches
    with pytest.raises(ValueError, match=match):
        reg_apply_cuda(dist, flow, wx, bx, wy, by)
    assert reg_apply_cuda.launches == before

"""LiteFlowNet's convolution epilogue in the port (kernel B18's plain
version and dispatcher, ``ops/conv_epilogue.py``, and ``_Conv``) against
the JAX package's Flax convolution and ``nn.leaky_relu`` on the CPU.

The epilogue's arithmetic is exact to define: the bias rounded to the
dtype, one rounded add, and JAX's leaky ReLU, whose weak-typed slope 0.1
is converted to x's dtype (0.10009765625 in bfloat16) before the one
rounded product. So the plain version is held to JAX bit for bit.

One difference is not the port's to follow: XLA's CPU backend flushes
subnormal inputs and results to zero (it runs with denormals-are-zero and
flush-to-zero), where torch on the CPU, cuDNN and the port's kernels keep
IEEE subnormals. Values of either side that are subnormal are compared
after flushing them to a zero of their sign (``_bits``), and the port
is shown to keep them (``test_leaky_keeps_subnormals``).

A whole convolution is held to Flax's ``nn.Conv(dtype=bfloat16)`` bit for
bit on a 1x1 convolution whose sums are exact, and within ``CONV_ULPS``
bfloat16 ulps of the float32 convolution's magnitude on a 3x3 one, where
the two backends sum the 3 x 3 x C products in other orders before the
rounding to bfloat16.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
import jax.numpy as jnp

from transflow_tpu_torch.flow.estimators import liteflownet as lfn
from transflow_tpu_torch.ops import conv_epilogue as ce
from transflow_tpu_torch.ops.conv_epilogue import (conv_epilogue,
                                                   conv_epilogue_cuda,
                                                   conv_epilogue_plain,
                                                   leaky_relu)

BF16, F32 = torch.bfloat16, torch.float32
JNP = {BF16: jnp.bfloat16, F32: jnp.float32}
TINY = np.finfo(np.float32).tiny        # the least normal, in both dtypes
CONV_ULPS = 2
SPECIALS = [0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 3e38, -3e38,
            TINY, -TINY, -1.2e-38, -2 * TINY, 1e-40, -1e-40, -3e-39,
            -1e-45, 5e-39]


def _values(n, seed):
    """``n`` seeded values over most of the exponent range (products with
    the slope reach the subnormals), then the special ones."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-130, 126, n))
    return np.concatenate([x, SPECIALS]).astype(np.float32)


def _bits(t: torch.Tensor) -> np.ndarray:
    """The values as float32 (bfloat16 widens exactly), NaN as one
    pattern, subnormals flushed to a zero of their sign."""
    a = t.float().numpy().copy()
    sub = (a != 0) & (np.abs(a) < TINY)
    a[sub] = np.copysign(0.0, a[sub])
    a[np.isnan(a)] = np.nan
    return a.view(np.uint32)


def _jax(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_leaky_matches_flax(dtype):
    """``_leaky``, ``leaky_relu`` (the epilogue's) and the plain epilogue
    with a bias of -0.0 (an add that leaves every value as it is) against
    ``flax.linen.leaky_relu(x, 0.1)`` on 2^20 values and the special
    ones, bit for bit. In bfloat16 ``F.leaky_relu(x, 0.1)`` differs in
    ~10 % of them, one ulp each."""
    x = torch.from_numpy(_values(1 << 20, 1)).to(dtype)
    want = _bits(_jax(fnn.leaky_relu(jnp.asarray(x.float().numpy())
                                        .astype(JNP[dtype]), 0.1)))
    y = x.reshape(1, -1, 1, 1)
    epilogue = conv_epilogue_plain(y, torch.full((y.shape[1],), -0.0),
                                   leaky=True)
    for got in (lfn._leaky(x), leaky_relu(x), epilogue.reshape(-1)):
        assert got.dtype == dtype
        np.testing.assert_array_equal(_bits(got), want)


def test_the_slope_is_rounded_to_the_dtype():
    """-1.125 * 0.10009765625 = -0.11260986328125 rounds to -0.11279296875
    in bfloat16; -1.125 * 0.1f = -0.1125 to -0.1123046875."""
    assert ce.leaky_slope(BF16) == 0.10009765625
    assert ce.leaky_slope(F32) == np.float32(0.1)
    x = torch.tensor([-1.125], dtype=BF16)
    assert leaky_relu(x).item() == -0.11279296875
    assert F.leaky_relu(x, 0.1).item() == -0.1123046875


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_leaky_keeps_subnormals(dtype):
    """Where XLA's CPU backend flushes, the port keeps IEEE subnormals: a
    negative subnormal times the slope is the float32 product rounded to
    the dtype, and a normal value whose product is subnormal stays
    non-zero."""
    x = torch.tensor([-3e-39, -1.2e-38], dtype=dtype)
    got = leaky_relu(x)
    want = (x.float() * ce.leaky_slope(dtype)).to(dtype)
    assert torch.equal(got, want)
    assert (got < 0).all()


LAYOUTS = ["channels_last", "nchw"]


def _conv_output(n, c, h, w, dtype, layout, seed):
    """A seeded (N, C, H, W) ``dtype`` tensor in ``layout`` with values
    over 2^-30..2^30, some exact zeros of both signs, infinities and NaN;
    and an f32 bias of C values with a +0.0, a -0.0 and a tiny one."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((n, h, w, c))
         * np.exp2(rng.integers(-30, 30, (n, h, w, c)))).astype(np.float32)
    flat = y.reshape(-1)
    flat[::97] = 0.0
    flat[5::97] = -0.0
    flat[11::1001] = np.inf
    flat[13::1001] = -np.inf
    flat[17::1001] = np.nan
    bias = (rng.standard_normal(c) * np.exp2(rng.integers(-20, 20, c))
            ).astype(np.float32)
    bias[0], bias[1], bias[2] = 0.0, -0.0, 1e-30
    nhwc = torch.from_numpy(y).to(dtype)
    nchw = nhwc.permute(0, 3, 1, 2)
    if layout == "nchw":
        nchw = nchw.contiguous()
    return nchw, torch.from_numpy(bias)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("leaky", [True, False], ids=["leaky", "linear"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_conv_epilogue_plain_matches_jax(dtype, leaky, layout):
    """The same rounded convolution output and f32 bias through JAX's
    ``y + bias.astype(dtype)`` (Flax's order) then ``nn.leaky_relu``, and
    through ``conv_epilogue_plain`` from either layout: bit for bit, the
    result (N, H, W, C) contiguous and the input left as it was."""
    y, bias = _conv_output(2, 9, 33, 65, dtype, layout, 2)
    before = y.clone()
    got = conv_epilogue_plain(y, bias, leaky)
    jy = jnp.asarray(y.permute(0, 2, 3, 1).float().numpy()).astype(JNP[dtype])
    want = jy + jnp.asarray(bias.numpy()).astype(JNP[dtype])
    if leaky:
        want = fnn.leaky_relu(want, 0.1)
    assert got.dtype == dtype and got.shape == (2, 33, 65, 9)
    assert got.is_contiguous()
    np.testing.assert_array_equal(_bits(got), _bits(_jax(want)))
    np.testing.assert_array_equal(_bits(y), _bits(before))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dispatcher_takes_the_plain_version_on_the_cpu(layout):
    y, bias = _conv_output(1, 25, 8, 12, BF16, layout, 3)
    before = conv_epilogue_cuda.launches
    got = conv_epilogue(y, bias, True)
    assert conv_epilogue_cuda.launches == before
    np.testing.assert_array_equal(_bits(got),
                                  _bits(conv_epilogue_plain(y, bias, True)))
    assert ce.layout(y, bias, "test") == layout


def test_conv_epilogue_refuses_misuse():
    y = torch.zeros((1, 4, 5, 6), dtype=BF16)
    bias = torch.zeros(4)
    for fn in (conv_epilogue_plain, conv_epilogue_cuda, conv_epilogue):
        with pytest.raises(ValueError, match="channels_last or contiguous"):
            fn(y.transpose(2, 3), bias, True)       # a third stride pattern
        with pytest.raises(ValueError, match="bias of 4"):
            fn(y, torch.zeros(5), True)
        with pytest.raises(ValueError, match="bias of 4"):
            fn(y, bias.double(), True)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(y.half(), bias, True)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fn(y[0], bias, True)
        with pytest.raises(ValueError, match="non-empty"):
            fn(y[:0], bias, True)
    with pytest.raises(ValueError, match="CUDA device"):
        conv_epilogue_cuda(y, bias, True)


def _flax_conv(x, w, b, kernel, pad, leaky):
    conv = fnn.Conv(w.shape[-1], (kernel, kernel), padding=((pad, pad),) * 2,
                    dtype=jnp.bfloat16, param_dtype=jnp.float32)
    y = conv.apply({"params": {"kernel": jnp.asarray(w),
                               "bias": jnp.asarray(b)}}, jnp.asarray(x))
    return _jax(fnn.leaky_relu(y, 0.1) if leaky else y)


def _port_conv(x, w, b, kernel, leaky):
    conv = lfn._Conv(w.shape[2], w.shape[3], kernel)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(b))
        return conv(torch.from_numpy(x), BF16, leaky=leaky)


@pytest.mark.parametrize("leaky", [True, False], ids=["leaky", "linear"])
def test_1x1_conv_matches_flax_exactly(leaky):
    """A 1x1 convolution in bfloat16 whose products and sums are exact in
    float32 (small dyadic values): ``_Conv`` with its epilogue equals
    Flax's ``nn.Conv(dtype=bfloat16)`` and ``nn.leaky_relu`` bit for bit,
    the conv outputs rounding to bfloat16 at 9 significant bits and more."""
    rng = np.random.default_rng(4)
    x = (rng.integers(-255, 256, (2, 7, 9, 16)) / 64).astype(np.float32)
    w = (rng.integers(-255, 256, (1, 1, 16, 24)) / 128).astype(np.float32)
    b = (rng.standard_normal(24) * 4).astype(np.float32)
    got = _port_conv(x, w, b, 1, leaky)
    want = _flax_conv(x, w, b, 1, 0, leaky)
    assert got.dtype == BF16 and got.shape == (2, 7, 9, 24)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("leaky", [True, False], ids=["leaky", "linear"])
def test_3x3_conv_matches_flax(leaky):
    """A 3x3 convolution of 40 channels in bfloat16 against Flax's: the
    two backends sum 360 float32 products in other orders, so a value may
    round to the neighbouring bfloat16 before the bias: within
    ``CONV_ULPS`` bfloat16 ulps (2^-7 relative) of the float32
    convolution's magnitude there, and equal elsewhere."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 12, 15, 40)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 40, 32))).astype(np.float32)
    b = (0.5 * rng.standard_normal(32)).astype(np.float32)
    got = _port_conv(x, w, b, 3, leaky).float().numpy()
    want = _flax_conv(x, w, b, 3, 1, leaky).float().numpy()
    xb = torch.from_numpy(x).bfloat16().float().permute(0, 3, 1, 2)
    wb = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).bfloat16().float()
    exact = F.conv2d(xb.double(), wb.double(), padding=1).permute(0, 2, 3, 1)
    tol = CONV_ULPS * 2.0 ** -7 * np.abs(exact.numpy()) + 1e-30
    assert np.all(np.abs(got - want) <= tol)
    assert np.mean(got == want) > 0.9


def test_weight_cast_once_and_again_after_a_reload():
    """In bfloat16 the weight is cast at the first forward only; a reload
    (``load_state_dict``, an in-place copy) casts the new weight, and the
    output follows it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    conv = lfn._Conv(4, 6, 3)
    shape = tuple(conv.weight.shape)

    class WeightCasts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.casts = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._to_copy.default and \
                    tuple(args[0].shape) == shape:
                self.casts += 1
            return func(*args, **(kwargs or {}))

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((8, 9, 4)).astype(np.float32))

    def state():
        return {"weight": torch.from_numpy(rng.standard_normal(shape)
                                           .astype(np.float32)),
                "bias": torch.from_numpy(rng.standard_normal(6)
                                         .astype(np.float32))}

    def want(s):
        y = F.conv2d(x.bfloat16().permute(2, 0, 1)[None],
                     s["weight"].bfloat16(), padding=1)
        return conv_epilogue_plain(y, s["bias"], True)[0]

    first = state()
    conv.load_state_dict(first)
    counts = []
    for _ in range(2):
        with WeightCasts() as mode:
            out = conv(x, BF16, leaky=True)
        counts.append(mode.casts)
        assert torch.equal(out, want(first))
    assert counts == [1, 0]
    second = state()
    conv.load_state_dict(second)
    with WeightCasts() as mode:
        out = conv(x, BF16, leaky=True)
    assert mode.casts == 1 and torch.equal(out, want(second))
    with torch.no_grad():
        conv.weight.copy_(first["weight"])
        conv.bias.copy_(first["bias"])
    assert torch.equal(conv(x, BF16, leaky=True), want(first))
    # float32 needs no copy at all
    assert conv.weight_as(F32) is conv.weight

"""Lucas-Kanade's Scharr derivatives (kernel B13's plain version,
``transflow_tpu_torch/ops/lucas_kanade.py::lk_scharr_plain``) against the
JAX package's ``_scharr``, on the CPU.

The same seeded numpy frames go through the port's pyramid and through
``jax.jit`` of ``_scharr(x, 1)`` and ``_scharr(x, 0)`` on the CPU. The taps
(``[-3, 0, 3] / 32`` and ``[3, 10, 3]``) are exact in float32 and the
levels are sums of few bits, so every product and sum of both sides is
exact or rounds alike: measured bit-equal at L0-L2 of 64x96 and 67x121
pyramids of random and panned frames, and on one-row and one-column
levels. On the card B13 equals the plain version bit for bit
(tests/test_torch_cuda.py).
"""
import importlib

import numpy as np
import pytest
import torch

import jax

from test_flow_ops import shifted_pair
from transflow_tpu_torch.flow.estimators.lucas_kanade import lucas_kanade
from transflow_tpu_torch.ops import lucas_kanade as lk
from transflow_tpu_torch.ops import pyramid

jlk = importlib.import_module("transflow_tpu.flow.estimators.lucas_kanade")
jax_scharr = jax.jit(lambda x: (jlk._scharr(x, 1), jlk._scharr(x, 0)))


def _frames(shape, kind: str):
    if kind == "pan":
        return shifted_pair(*shape, dx=3, dy=2)
    rng = np.random.default_rng(shape[0] * shape[1])
    return tuple(rng.integers(0, 256, shape, dtype=np.uint8) for _ in "ab")


@pytest.mark.parametrize("kind", ["random", "pan"])
@pytest.mark.parametrize("shape", [(64, 96), (67, 121)], ids=str)
def test_lk_scharr_plain_matches_jax_at_each_level(shape, kind):
    """L0-L2 of Lucas-Kanade's pyramid (window 3, so that two levels lie
    below L0): ix and iy bit-equal to JAX's ``_scharr``."""
    a, b = _frames(shape, kind)
    levels = pyramid.lk_pyramid_plain(torch.from_numpy(a),
                                      torch.from_numpy(b), 3, 2)
    assert len(levels) == 3
    for x, _ in levels:
        ix, iy = lk.lk_scharr_plain(x)
        want_x, want_y = map(np.asarray, jax_scharr(x.numpy()))
        np.testing.assert_array_equal(ix.numpy(), want_x)
        np.testing.assert_array_equal(iy.numpy(), want_y)
        assert np.abs(want_x).max() > 1.0


@pytest.mark.parametrize("shape", [(1, 1), (1, 7), (7, 1), (2, 3)],
                         ids=str)
def test_lk_scharr_plain_clamps_tiny_levels(shape):
    """A level of one row or column pads by repeating its edge: along that
    axis the derivative is 0, bit-equal to JAX."""
    x = np.random.default_rng(1).integers(0, 256, shape).astype(np.float32)
    ix, iy = lk.lk_scharr_plain(torch.from_numpy(x))
    want_x, want_y = map(np.asarray, jax_scharr(x))
    np.testing.assert_array_equal(ix.numpy(), want_x)
    np.testing.assert_array_equal(iy.numpy(), want_y)
    if shape[0] == 1:
        assert not iy.any()
    if shape[1] == 1:
        assert not ix.any()


def test_lk_scharr_dispatches_by_device(monkeypatch):
    """CPU tensors take the plain version (the kernel's wrapper is never
    called); a tensor on another device has no path."""
    def refuse(image):
        raise AssertionError("the kernel's wrapper ran on a CPU tensor")

    monkeypatch.setattr(lk, "lk_scharr_cuda", refuse)
    x = torch.from_numpy(np.random.default_rng(2).random((9, 11),
                                                         np.float32))
    got = lk.lk_scharr(x)
    want = lk.lk_scharr_plain(x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="no path for device meta"):
        lk.lk_scharr(torch.zeros((4, 6), device="meta"))


def test_lk_scharr_cuda_refuses_cpu_tensors():
    """The wrapper launches on CUDA tensors only; a CPU image raises before
    any launch."""
    before = lk.lk_scharr_cuda.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        lk.lk_scharr_cuda(torch.zeros((4, 6)))
    assert lk.lk_scharr_cuda.launches == before


def test_lucas_kanade_calls_b13_once_a_level(monkeypatch):
    """The estimator takes its derivatives from ``lk_scharr``, one call a
    level (here its plain version), and stays within the module's 1e-4 of
    JAX (tests/test_torch_lucas_kanade.py) on a 67x121 pan."""
    from test_torch_lucas_kanade import FLOW_TOL, _jax
    calls = []
    plain = lk.lk_scharr_plain

    def counted(image):
        calls.append(tuple(image.shape))
        return plain(image)

    monkeypatch.setattr(lk, "lk_scharr_plain", counted)
    a, b = shifted_pair(67, 121, dx=3, dy=2)
    got = lucas_kanade(torch.from_numpy(a), torch.from_numpy(b),
                       win_size=7).numpy()
    assert calls == [(17, 31), (34, 61), (67, 121)]
    np.testing.assert_allclose(got, _jax(a, b, win_size=7), atol=FLOW_TOL,
                               rtol=0)

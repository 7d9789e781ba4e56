"""The port's 7x7 correlation against the JAX package's.

The plain PyTorch version (what the dispatcher runs on CPU tensors) is held
to the Pallas kernel in interpret mode and to the XLA formulation, on the
same numpy inputs. The CUDA kernel is held to the plain version on the
card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transflow_tpu.ops.correlation import correlation7x7 as jax_corr
from transflow_tpu.ops.pallas_correlation import pallas_correlation7x7
from transflow_tpu_torch.ops.correlation import (check_kernel, correlation,
                                                 correlation7x7,
                                                 correlation7x7_cuda)

SHAPES = [(16, 24, 8, 1), (32, 48, 16, 2), (4, 6, 192, 1)]
BF16, F32 = torch.bfloat16, torch.float32
# f32 math on both sides in another summation order; bf16 operands are
# exact in f32, so the JAX package's own bars apply
# (tests/test_liteflownet.py:216,232)
ATOL = {(F32, F32): 1e-5, (BF16, BF16): 1e-6, (BF16, F32): 1e-6}


def _operands(shape, t1, t2, seed=0):
    """Seeded numpy operands, rounded to each operand's dtype, as
    (torch f1, torch f2, jax f1, jax f2)."""
    h, w, c, _ = shape
    rng = np.random.default_rng(seed)
    out = []
    for dtype in (t1, t2):
        x = torch.from_numpy(rng.standard_normal((h, w, c))
                             .astype(np.float32)).to(dtype)
        out.append(x)
    jax_ops = [jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == BF16 else jnp.float32) for x in out]
    return out + jax_ops


@pytest.mark.parametrize("pair", list(ATOL), ids=lambda p: "/".join(
    str(t)[6:] for t in p))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_pallas_interpret(shape, pair):
    f1, f2, j1, j2 = _operands(shape, *pair)
    stride = shape[3]
    want = np.asarray(pallas_correlation7x7(j1, j2, stride=stride,
                                            interpret=True))
    for fn in (correlation7x7, correlation):
        got = fn(f1, f2, stride)
        assert got.dtype == torch.float32
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL[pair],
                                   rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_xla_formulation(shape):
    f1, f2, j1, j2 = _operands(shape, F32, F32, seed=1)
    stride = shape[3]
    want = np.asarray(jax_corr(j1, j2, stride=stride))
    np.testing.assert_allclose(correlation7x7(f1, f2, stride).numpy(), want,
                               atol=1e-5, rtol=0)


def test_odd_sizes_stride2_take_ceil():
    """f1[::2] keeps ceil(H/2) rows, as in the Pallas wrapper."""
    f1, f2, j1, j2 = _operands((9, 11, 4, 2), F32, F32, seed=2)
    want = np.asarray(pallas_correlation7x7(j1, j2, stride=2,
                                            interpret=True))
    got = correlation7x7(f1, f2, 2)
    assert got.shape == want.shape == (5, 6, 49)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_unported_overrides_raise():
    """JAX's checks of an override: an unknown name, and 'pallas_halo'
    without a mesh that has a 'space' axis, raise ValueError."""
    for kernel in (None, "xla", "pallas"):
        check_kernel(kernel)
    with pytest.raises(ValueError, match="must be"):
        check_kernel("mxu")
    with pytest.raises(ValueError, match="needs a mesh"):
        check_kernel("pallas_halo")

    class StreamOnly:
        shape = {"stream": 2}

    with pytest.raises(ValueError, match="'space'"):
        check_kernel("pallas_halo", StreamOnly())
    f = torch.zeros(4, 4, 2)
    with pytest.raises(ValueError, match="needs a mesh"):
        correlation(f, f, kernel="pallas_halo")


def test_no_cpu_path_for_other_devices():
    """Only CPU tensors take the plain version; the kernel wrapper refuses
    anything but CUDA tensors instead of falling back."""
    f = torch.zeros(4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="no path"):
        correlation(f, f)
    with pytest.raises(ValueError, match="CUDA"):
        correlation7x7_cuda(torch.zeros(4, 4, 2), torch.zeros(4, 4, 2))

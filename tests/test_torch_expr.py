"""The port's expression evaluator against the JAX package's, in float32.

The JAX package's ``numpy``/``np`` are ``jax.numpy`` and its ``math``
sends a call with an array argument there (``_MathShim``), so an
expression over the Engine's float32 ``t`` computes in float32, and a
``numpy`` call on a Python float rounds it to float32 first. The port
evaluates on torch the same way: a numpy scalar enters as a 0-d float32
CPU tensor. Exact agreement with XLA's transcendental functions is not
reachable (torch's and XLA's float32 ``sin`` are different polynomials),
so the gap is measured in float32 units in the last place (ulps) and held
to the bounds below. Before the repair the port evaluated ``np.sin(t)`` in
float64 and missed JAX's float32 at 19,171 of 20,001 values of ``t``.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transflow_tpu.utils import expr as jexpr
from transflow_tpu_torch.utils import expr

T_GRID = np.linspace(0.01, 300.0, 2001).astype(np.float32)
# ulps between torch's and XLA's float32 functions on the CPU, measured
# over T_GRID: sin/cos/sqrt at most 1; exp(t/7) at most 1 where both
# divide exactly (XLA's jit turns t/7 into t*(1/7), which rounds
# differently, so the comparison is with JAX's eager evaluation); hypot
# up to 4 (XLA scales its arguments, torch does not). The expressions
# keep clear of cancellation, which turns one ulp of a term into many of
# a result near zero.
ULP_BOUNDS = {
    "np.sin(t)": 1, "numpy.exp(t/7)": 1, "np.sqrt(t)": 1,
    "math.sin(t)": 1, "0.5*t": 0, "math.cos(t) * 2 + 3 + 0.1 * t": 2,
    "np.arctan2(np.sin(t), np.cos(t))": 2, "np.log(1 + t)": 1,
    "np.floor(t / 3) + np.round(t * 4) / 4": 0,
    "np.minimum(np.maximum(t - 2, 0.5), 4)": 0,
    "np.clip(t, 1, 2.5) ** 2": 0,
    "np.where(t > 100, np.tanh(t / 50), np.hypot(t, 1))": 4,
}


def ulps(a, b) -> np.ndarray:
    """Distance in float32 ulps (sign-magnitude made monotonic)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return np.abs(a - b)


def _jax_scalar(fn, t):
    """JAX's value of ``fn`` at a float32 ``t`` outside jit."""
    return np.float32(fn(jnp.float32(t)))


@pytest.mark.parametrize("text", list(ULP_BOUNDS))
def test_float32_t_within_ulps_of_jax(text):
    """The Engine passes ``t`` as ``np.float32``: every result is float32
    and within the stated ulps of JAX's float32 value."""
    got_fn = expr.parse_expression(text)
    want_fn = jexpr.parse_expression(text)
    got = np.array([got_fn(t) for t in T_GRID[::4]], np.float32)
    want = np.array([_jax_scalar(want_fn, t) for t in T_GRID[::4]])
    out = got_fn(T_GRID[7])
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert out.device.type == "cpu"
    assert ulps(got, want).max() <= ULP_BOUNDS[text], text


T_SPAN = np.linspace(0.01, 300.0, 20001)
NUMPY_F64 = {"np.sin(t)": np.sin, "numpy.exp(t/7)": lambda t: np.exp(t / 7),
             "np.sqrt(t)": np.sqrt}


@pytest.mark.parametrize("text", list(NUMPY_F64))
def test_numpy_on_python_float_rounds_to_float32(text):
    """``jnp`` rounds a Python float to float32 before the call: the
    port's ``numpy`` namespace does too. Over 20,001 values of ``t`` in
    [0.01, 300] the port is within 1 ulp of JAX (measured: 1,083, 1,936
    and 139 values 1 ulp apart for sin, exp(t/7) and sqrt); float64, as
    the port computed before, missed JAX's float32 at 19,171, 17,837 and
    2,564 of them."""
    got_fn = expr.parse_expression(text)
    want_fn = jexpr.parse_expression(text)
    ts = [float(t) for t in T_SPAN]
    got = np.array([got_fn(t) for t in ts], np.float32)
    want = np.array([np.float32(want_fn(t)) for t in ts])
    assert ulps(got, want).max() <= ULP_BOUNDS[text]
    f64 = np.array([NUMPY_F64[text](t) for t in ts])
    assert (f64.astype(np.float32) != want).sum() > 2 * (got != want).sum()


@pytest.mark.parametrize("text", ["0.5 * t", "t > 1 and t < 2",
                                  "math.sin(t) > 0.5",
                                  "abs(round(t, 1) - 2.5) <= 0.05"])
def test_python_float_with_math_stays_float64(text):
    """``math`` on Python numbers is Python's math, as ``_MathShim``'s
    (the lock 'skip' expressions of ``t``)."""
    got_fn, want_fn = (expr.parse_expression(text),
                       jexpr.parse_expression(text))
    for t in np.linspace(0.0, 4.0, 41):
        got, want = got_fn(float(t)), want_fn(float(t))
        assert type(got) is type(want) and got == want, (text, t)


def test_math_on_float32_dispatches_like_jax_in_jit():
    """Inside the JAX Engine's jit ``t`` is a float32 tracer, so
    ``math.sin(t)`` is ``jnp.sin``: float32, within 1 ulp of the jitted
    JAX value over the grid."""
    fn = jexpr.parse_expression("math.sin(t) * 3")
    jitted = np.asarray(jax.vmap(jax.jit(fn))(jnp.asarray(T_GRID)))
    got = np.array([expr.parse_expression("math.sin(t) * 3")(t)
                    for t in T_GRID], np.float32)
    assert ulps(got, jitted).max() <= 2


ARRAY_EXPRESSIONS = {
    "r": 0, "a + 0.1 * t": 0, "r * np.sin(a) + 13": 2,
    "np.clip(r, 0.5, 3) * 2": 0, "np.where(r > 2, r, 0)": 0,
    "np.arctan2(np.sin(a), np.cos(a))": 2, "np.hypot(r, 1)": 4,
    "np.minimum(r, 2) + np.maximum(a, 0)": 0, "np.floor(r) + np.round(a)": 0,
    "np.sqrt(r) + np.exp(-r)": 2, "np.log(1 + r) * math.pi": 2,
    "math.cos(a) * r": 2, "np.abs(a) ** 2": 0,
}


@pytest.mark.parametrize("text", list(ARRAY_EXPRESSIONS))
def test_array_expressions_within_ulps_of_jax(text):
    """The polar filter's (t, r, a) over (H, W) float32 arrays: the port's
    tensors against ``jnp``'s arrays, within the stated ulps."""
    rng = np.random.default_rng(0)
    r = (rng.random((24, 32)) * 6).astype(np.float32)
    a = ((rng.random((24, 32)) - 0.5) * 2 * np.pi).astype(np.float32)
    t = np.float32(1.7)
    variables = ("t", "r", "a")
    got = expr.parse_expression(text, variables)(t, torch.from_numpy(r),
                                                 torch.from_numpy(a))
    want = jexpr.parse_expression(text, variables)(jnp.float32(t),
                                                   jnp.asarray(r),
                                                   jnp.asarray(a))
    assert got.dtype == torch.float32 and tuple(got.shape) == r.shape
    assert ulps(got.numpy(), np.asarray(want)).max() \
        <= ARRAY_EXPRESSIONS[text], text


@pytest.mark.parametrize("text", ["np.array(t)", "numpy.linalg(t)",
                                  "np.float32(t)"])
def test_unmapped_names_raise_naming_themselves(text):
    with pytest.raises(AttributeError, match=text.split("(")[0]):
        expr.parse_expression(text)(1.0)


def test_math_without_torch_counterpart_is_pythons():
    """A ``math`` name torch has no counterpart for is Python's, as
    ``_MathShim`` returns ``math``'s where ``jnp`` has none."""
    assert expr.parse_expression("math.factorial(t)")(4) == math.factorial(4)


def test_constants_match_jax():
    for text in ("np.pi", "numpy.e", "math.tau", "np.inf", "pi * 2", "e"):
        assert expr.parse_expression(text)(0.0) == \
            jexpr.parse_expression(text)(0.0), text

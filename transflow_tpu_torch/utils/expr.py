"""Safe user-expression evaluator.

Counterpart of transflow_tpu/utils/expr.py: the same AST whitelist, names
and modules, and the same arithmetic. The JAX package's ``numpy``/``np``
namespaces are ``jax.numpy`` and its ``math`` sends a call with an array
argument to ``jax.numpy`` (``_MathShim``), so a call on a float32 value
(the Engine's ``t``, the polar filter's ``r`` and ``a``) computes in
float32, and a ``numpy`` call on a Python float rounds it to float32
first. Here both dispatch to torch the same way (``_TorchNamespace``): an
expression of host values computes on 0-d float32 CPU tensors, so it
adds no host sync; a number beside an (H, W) tensor on the card is
filled there, with no copy from the host. ``math`` on Python numbers
alone is Python's ``math``.

A numpy float argument (the Engine passes ``t`` as ``np.float32``) enters
the expression as a 0-d float32 tensor, so ``0.5 * t`` rounds as JAX's
weak-typed float32 product does.
"""
import ast
import math
import numbers
import random
from typing import Callable, Sequence

import numpy as np
import torch

_ALLOWED_NODES = (
    ast.Expression, ast.Constant, ast.Name, ast.Load,
    ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.IfExp,
    ast.Call, ast.Attribute, ast.Tuple, ast.List, ast.Subscript, ast.Slice,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd, ast.Not, ast.Invert,
    ast.And, ast.Or, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.BitAnd, ast.BitOr, ast.BitXor, ast.LShift, ast.RShift,
)

_MODULES = {"math", "numpy", "np", "random"}
_BUILTINS = {"abs": abs, "min": min, "max": max, "round": round,
             "float": float, "int": int, "bool": bool, "len": len,
             "pi": math.pi, "e": math.e}

# jax.numpy's names (and math's) -> torch's
_TORCH_FUNCTIONS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "asin": torch.asin, "arccos": torch.acos,
    "acos": torch.acos, "arctan": torch.atan, "atan": torch.atan,
    "arctan2": torch.atan2, "atan2": torch.atan2, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "exp": torch.exp,
    "expm1": torch.expm1, "log": torch.log, "log2": torch.log2,
    "log10": torch.log10, "log1p": torch.log1p, "sqrt": torch.sqrt,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "trunc": torch.trunc, "abs": torch.abs, "absolute": torch.abs,
    "fabs": torch.abs, "sign": torch.sign, "clip": torch.clamp,
    "minimum": torch.minimum, "maximum": torch.maximum,
    "where": torch.where, "hypot": torch.hypot, "power": torch.pow,
    "pow": torch.pow, "square": torch.square, "mod": torch.remainder,
    "fmod": torch.fmod, "radians": torch.deg2rad, "deg2rad": torch.deg2rad,
    "degrees": torch.rad2deg, "rad2deg": torch.rad2deg,
    "copysign": torch.copysign,
}
_CONSTANTS = {"pi": math.pi, "e": math.e, "tau": math.tau, "inf": math.inf,
              "nan": math.nan}


def _is_array(value) -> bool:
    return isinstance(value, (torch.Tensor, np.ndarray, np.generic))


def _as_tensor(value, device: torch.device) -> torch.Tensor:
    """``value`` as a tensor on ``device``: a Python or numpy scalar in
    float32 (int32, bool), as ``jnp`` takes it, filled there without a
    host-to-device copy; a float numpy array in float32."""
    if isinstance(value, torch.Tensor):
        return value
    if isinstance(value, np.ndarray) and value.ndim:
        out = torch.from_numpy(value)
        return (out.float() if out.is_floating_point() else out).to(device)
    if isinstance(value, (np.generic, np.ndarray)):
        value = value.item()
    if isinstance(value, bool):
        dtype = torch.bool
    elif isinstance(value, numbers.Integral):
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.full((), value, dtype=dtype, device=device)


def _torch_call(fn, args, kwargs):
    """``fn`` over ``args`` as tensors on the device of the first tensor
    among them (the CPU when there is none)."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  torch.device("cpu"))
    return fn(*(_as_tensor(a, device) for a in args),
              **{k: _as_tensor(v, device) for k, v in kwargs.items()})


class _TorchNamespace:
    """``numpy``/``np`` (``with_math=False``: every call in float32 on
    tensors, as ``jnp``) or ``math`` (``with_math=True``: Python's math for
    Python numbers, torch where an argument is a tensor or a numpy value,
    as ``_MathShim``). A name with no torch counterpart raises."""

    def __init__(self, label: str, with_math: bool):
        self._label = label
        self._with_math = with_math

    def __getattr__(self, name):
        if name in _CONSTANTS:
            return _CONSTANTS[name]
        fn = _TORCH_FUNCTIONS.get(name)
        math_fn = getattr(math, name, None) if self._with_math else None
        if fn is None:
            if math_fn is not None:
                return math_fn
            raise AttributeError(
                f"{self._label}.{name} is not available in expressions")

        def call(*args, **kwargs):
            if math_fn is not None and not any(
                    _is_array(a) for a in (*args, *kwargs.values())):
                return math_fn(*args, **kwargs)
            return _torch_call(fn, args, kwargs)

        call.__name__ = name
        return call


def _true_divide(a, b):
    """``a / b``, rounded once as ``jnp``'s division is: torch computes a
    number over a tensor as the tensor's reciprocal times the number."""
    if isinstance(b, torch.Tensor) and not isinstance(a, torch.Tensor):
        a = _as_tensor(a, b.device)
    return a / b


class _ExactDivision(ast.NodeTransformer):
    """Turns every ``x / y`` into ``_true_divide(x, y)``, after the
    whitelist: an expression cannot name ``_true_divide`` itself."""

    def visit_BinOp(self, node):
        node = self.generic_visit(node)
        if not isinstance(node.op, ast.Div):
            return node
        return ast.copy_location(ast.Call(
            func=ast.Name("_true_divide", ast.Load()),
            args=[node.left, node.right], keywords=[]), node)


_GLOBALS = {
    # no builtins: the AST whitelist admits only the names below
    "__builtins__": {},
    "_true_divide": _true_divide,
    "math": _TorchNamespace("math", with_math=True),
    "numpy": _TorchNamespace("numpy", with_math=False),
    "np": _TorchNamespace("np", with_math=False),
    "random": random,
    **_BUILTINS,
}


def _validate(tree: ast.AST, variables: Sequence[str]):
    allowed_names = set(variables) | _MODULES | set(_BUILTINS)
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(
                f"Expression uses disallowed syntax: {type(node).__name__}")
        if isinstance(node, ast.Name) and node.id not in allowed_names:
            raise ValueError(f"Unknown name in expression: {node.id!r}")
        if isinstance(node, ast.Attribute):
            if node.attr.startswith("_"):
                raise ValueError("Private attribute access is not allowed")
            if not (isinstance(node.value, ast.Name)
                    and node.value.id in _MODULES):
                raise ValueError(
                    "Attribute access is only allowed on math/numpy/random")


def parse_expression(expr_string: str,
                     variables: Sequence[str] = ("t",)) -> Callable:
    """Compile a user expression into a callable of ``variables``:
    ``parse_expression("0.5 * t")(2.0) == 1.0``. A variable may be a
    Python number, a numpy scalar (a 0-d float32 tensor inside the
    expression) or a tensor (the polar filter's ``r`` and ``a``)."""
    tree = ast.parse(expr_string, mode="eval")
    _validate(tree, variables)
    tree = ast.fix_missing_locations(_ExactDivision().visit(tree))
    code = compile(tree, "<transflow-expression>", "eval")

    def fn(*args):
        if len(args) != len(variables):
            raise TypeError(
                f"Expression takes {len(variables)} arguments, got {len(args)}")
        scope = {name: (_as_tensor(value, torch.device("cpu"))
                        if isinstance(value, (np.generic, np.ndarray))
                        else value)
                 for name, value in zip(variables, args)}
        return eval(code, _GLOBALS, scope)  # noqa: S307 — AST-whitelisted above

    fn.__doc__ = f"user expression: {expr_string!r} over {tuple(variables)}"
    return fn


def parse_lock_intervals(expr_string: str) -> tuple[tuple[float, float], ...]:
    """Parse a lock 'stay' expression: a list of (start, duration) couples.

    Parity reference: transflow/flow/sources/source.py:134-138 (an ``eval`` of
    the bracketed string); here it is ``ast.literal_eval``-based.
    """
    text = expr_string.strip()
    if "(" not in text:
        text = f"({text})"
    value = ast.literal_eval(f"[{text},]")
    out = []
    for couple in value:
        if not (isinstance(couple, tuple) and len(couple) == 2):
            raise ValueError(
                f"Lock expression items must be (start, duration): {couple!r}")
        out.append((float(couple[0]), float(couple[1])))
    return tuple(out)

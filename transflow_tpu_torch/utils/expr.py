"""Safe user-expression evaluator, for host scalars.

Counterpart of transflow_tpu/utils/expr.py: the same AST whitelist, names
and modules. Expressions are evaluated on host scalars (the lock 'skip'
expression of ``t``), with ``math`` and ``numpy`` as the namespaces. Array
arguments, which the polar flow filter passes, raise: filters are not
ported yet.
"""
import ast
import math
import numbers
import random
from typing import Callable, Sequence

import numpy as np

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

_GLOBALS = {
    # no builtins: the AST whitelist admits only the names below
    "__builtins__": {},
    "math": math,
    "numpy": np,
    "np": np,
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
    """Compile a user expression into a callable of ``variables``, each a
    host scalar: ``parse_expression("0.5 * t")(2.0) == 1.0``."""
    tree = ast.parse(expr_string, mode="eval")
    _validate(tree, variables)
    code = compile(tree, "<transflow-expression>", "eval")

    def fn(*args):
        if len(args) != len(variables):
            raise TypeError(
                f"Expression takes {len(variables)} arguments, got {len(args)}")
        if not all(isinstance(a, numbers.Number) for a in args):
            raise NotImplementedError(
                "expressions over arrays (the polar flow filter's r and a) "
                "are not ported yet: ROADMAP Queue 1, item 6 (flow "
                "post-processing)")
        scope = dict(zip(variables, args))
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

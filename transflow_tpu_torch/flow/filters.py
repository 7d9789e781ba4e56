"""Time-parameterized flow filters (scale / threshold / clip / polar).

Counterpart of transflow_tpu/flow/filters.py (parity reference:
transflow/flow/filters.py:15-87). A filter is a function ``flow, t ->
flow`` on an (H, W, 2) float32 tensor; its expressions are compiled once
(``utils/expr.py``) and evaluate in float32 as the JAX Engine's do. The
norms are ``torch.linalg.vector_norm``, which rounds as ``jnp.linalg.norm``
does on XLA's CPU backend.
"""
import torch

from ..utils import parse_expression


def iter_specs(filters_string: str | None) -> list[tuple[str, tuple]]:
    """Split 'name=expr;name=expr:expr;...' into (name, args) pairs."""
    if filters_string is None:
        return []
    specs = []
    for part in filters_string.strip().split(";"):
        if not part.strip():
            continue
        eq = part.index("=")
        specs.append((part[:eq].strip(),
                      tuple(part[eq + 1:].strip().split(":"))))
    return specs


def static_clip_bound(filters_string: str | None) -> float | None:
    """The constant displacement bound after the whole filter chain, else
    None: a trailing ``clip=K`` with a numeric K (a later ``threshold``
    keeps it, since it only zeroes vectors; ``scale`` and ``polar`` can
    amplify, and a time-varying K gives no static bound)."""
    bound = None
    for name, args in iter_specs(filters_string):
        if name == "clip":
            try:
                bound = float(args[0])
            except ValueError:
                bound = None
        elif name == "threshold":
            continue
        else:
            bound = None
    return bound


class FlowFilter:

    def __call__(self, flow, t):
        raise NotImplementedError

    @classmethod
    def from_args(cls, name: str, args: tuple) -> "FlowFilter":
        registry = {"scale": (ScaleFilter, 1), "threshold": (ThresholdFilter, 1),
                    "clip": (ClipFilter, 1), "polar": (PolarFilter, 2)}
        if name not in registry:
            raise ValueError(f"Unknown flow filter {name!r}")
        filter_cls, arity = registry[name]
        if len(args) != arity:
            raise ValueError(
                f"Filter {name} takes {arity} argument(s), got {len(args)}")
        return filter_cls(*args)

    @classmethod
    def parse_many(cls, filters_string: str | None) -> list["FlowFilter"]:
        """Parse 'name=expr;name=expr:expr;...' into filter objects.

        Parity: transflow/flow/sources/source.py:142-150."""
        return [cls.from_args(name, args)
                for name, args in iter_specs(filters_string)]


def _norm(flow: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(flow, dim=-1)


class ScaleFilter(FlowFilter):
    """flow *= expr(t)"""

    def __init__(self, expr: str):
        self.expr = parse_expression(expr)

    def __call__(self, flow, t):
        return flow * self.expr(t)


class ThresholdFilter(FlowFilter):
    """Zero out vectors with L2 norm <= expr(t)."""

    def __init__(self, expr: str):
        self.expr = parse_expression(expr)

    def __call__(self, flow, t):
        below = _norm(flow) <= self.expr(t)
        return torch.where(below[..., None], torch.zeros_like(flow), flow)


class ClipFilter(FlowFilter):
    """Rescale vectors with norm >= expr(t) down to that norm."""

    def __init__(self, expr: str):
        self.expr = parse_expression(expr)

    def __call__(self, flow, t):
        norm = _norm(flow)
        threshold = self.expr(t)
        safe = torch.where(norm > 0, norm, torch.ones_like(norm))
        # a tensor over a tensor: torch takes a number over a tensor as
        # the reciprocal times the number, which rounds twice
        ratio = torch.as_tensor(threshold, dtype=torch.float32) / safe
        factor = torch.where(norm >= threshold, ratio, torch.ones_like(norm))
        return flow * factor[..., None]


class PolarFilter(FlowFilter):
    """Remap (radius, angle) through two expressions of (t, r, a)."""

    def __init__(self, expr_radius: str, expr_theta: str):
        self.expr_radius = parse_expression(expr_radius, ("t", "r", "a"))
        self.expr_theta = parse_expression(expr_theta, ("t", "r", "a"))

    def __call__(self, flow, t):
        radius = _norm(flow)
        theta = torch.atan2(flow[..., 1], flow[..., 0])
        new_radius = self.expr_radius(t, radius, theta)
        new_theta = self.expr_theta(t, radius, theta)
        if not isinstance(new_theta, torch.Tensor):
            # a constant angle, in float32 as jnp takes it
            new_theta = torch.full_like(radius, new_theta)
        return torch.stack([new_radius * torch.cos(new_theta),
                            new_radius * torch.sin(new_theta)], dim=-1)

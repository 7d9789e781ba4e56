"""The import guard: no module of JAX, of Flax or of the JAX package may
be loaded in the process that reports a result.

Names are compared by their top-level part (before the first dot), whole:
``transflow_tpu_torch`` is the port and passes, ``transflow_tpu`` is the
JAX package and does not.
"""
import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "transflow_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(name for name in names
                  if name.split(".", 1)[0] in FORBIDDEN)

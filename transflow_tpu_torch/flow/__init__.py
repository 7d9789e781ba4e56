"""Flow subsystem of the port: estimators, sources, merge and
post-processing.

``Direction`` and ``LockMode`` are the JAX package's own enums: their
module imports no JAX.
"""
from transflow_tpu.flow import Direction, LockMode

__all__ = ["Direction", "LockMode"]

"""Flow subsystem of the port: estimators, merge and post-processing.

``Direction`` is the JAX package's own enum: its module imports no JAX.
"""
from transflow_tpu.flow import Direction

__all__ = ["Direction"]

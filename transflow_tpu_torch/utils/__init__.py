"""Host helpers the port re-declares from transflow_tpu.utils (which
imports JAX)."""
from .colors import parse_color
from .expr import parse_expression, parse_lock_intervals
from .misc import parse_size, parse_timestamp

__all__ = ["parse_color", "parse_expression", "parse_lock_intervals",
           "parse_size", "parse_timestamp"]

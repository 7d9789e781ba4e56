"""Host helpers the port re-declares from transflow_tpu.utils (which
imports JAX)."""
from .colors import parse_color
from .expr import parse_expression, parse_lock_intervals
from .masks import load_bool_mask, load_float_mask
from .misc import find_unique_path, parse_size, parse_timestamp, startfile

__all__ = ["parse_color", "parse_expression", "parse_lock_intervals",
           "load_bool_mask", "load_float_mask",
           "find_unique_path", "parse_size", "parse_timestamp", "startfile"]

"""Host helpers the port re-declares from transflow_tpu.utils (which
imports JAX)."""
from .colors import parse_color

__all__ = ["parse_color"]

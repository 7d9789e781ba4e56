"""Pixmap sources of the port (counterpart of transflow_tpu/pixmap)."""
from .base import PixmapSource

__all__ = ["PixmapSource"]

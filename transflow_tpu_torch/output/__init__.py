"""Outputs of the port (counterpart of transflow_tpu/output)."""
from .archive import NumpyArchiveOutput, ZipOutput
from .video_output import VideoOutput

__all__ = ["VideoOutput", "NumpyArchiveOutput", "ZipOutput"]

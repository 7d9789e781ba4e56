"""Pixmap source base + factory routing.

Counterpart of transflow_tpu/pixmap/base.py, the same routing and
alteration overlay: a still keyword goes to ``still.py``, an existing file
with an extension of ``IMAGE_EXTS`` to ``ImagePixmapSource``, anything
else to ``VideoPixmapSource`` (so a single ``.ppm``, which is not in
``IMAGE_EXTS``, is a one-frame video, as there). Images are read by
``utils/imageio.py``.
"""
import os
import re

import numpy as np

from ..utils.imageio import PIL_EXTS

# the still-image extensions (PIL's), as in the JAX package
IMAGE_EXTS = PIL_EXTS

_STILL_RE = re.compile(
    r"^(color:[a-z0-9\(\)#, ]+|color|#?[0-9a-f]{6}|noise|bwnoise|cnoise"
    r"|gradient|first)$")


class PixmapSource:
    """Iterator of (H, W, 3|4) uint8 frames."""

    def __init__(self, alteration_path: str | None = None,
                 length: int | None = None):
        self.alteration_path = alteration_path
        self.width: int | None = None
        self.height: int | None = None
        self.framerate: float | None = None
        self.length = length
        self._alter_mask = None
        self._alter_rgb = None

    # -- lifecycle ------------------------------------------------------

    def open(self):
        return self

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()

    def close(self):
        pass

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        raise NotImplementedError

    # -- alteration -----------------------------------------------------

    def load_alteration(self):
        if self.alteration_path is None:
            return
        from ..utils.imageio import imread
        arr = imread(self.alteration_path)
        if arr.ndim != 3:
            raise ValueError("Alteration image must be RGB(A)")
        if arr.shape[2] < 4:
            alpha = np.ones((*arr.shape[:2], 1), dtype=np.uint8)
            arr = np.concatenate([arr[..., :3], alpha], axis=2)
        self._alter_mask = arr[..., 3] != 0
        self._alter_rgb = arr[..., :3]

    def alter(self, frame: np.ndarray) -> np.ndarray:
        if self._alter_mask is None:
            return frame
        h, w = self._alter_mask.shape
        region = frame[:h, :w, :3]
        mask = self._alter_mask[:region.shape[0], :region.shape[1]]
        region[mask] = self._alter_rgb[:region.shape[0],
                                       :region.shape[1]][mask]
        return frame

    # -- factory --------------------------------------------------------

    @classmethod
    def from_args(cls,
                  path: str,
                  size: tuple[int, int],
                  seek: int | None = None,
                  seed: int | None = None,
                  seek_time: float | None = None,
                  alteration_path: str | None = None,
                  repeat: int = 1,
                  flow_path: str | None = None) -> "PixmapSource":
        from . import still as st
        ext = os.path.splitext(path)[1]
        match = _STILL_RE.match(path.lower().strip())
        if match is not None:
            width, height = size
            kind = match.group(1)
            if kind == "color":
                return st.ColorPixmapSource(width, height, seed=seed,
                                            alteration_path=alteration_path)
            if kind.startswith("color:"):
                return st.ColorPixmapSource(
                    width, height, kind.split(":", 1)[1], seed=seed,
                    alteration_path=alteration_path)
            if re.match(r"#?[0-9a-f]{6}$", kind):
                return st.ColorPixmapSource(width, height, kind, seed=seed,
                                            alteration_path=alteration_path)
            if kind == "noise":
                return st.NoisePixmapSource(width, height, seed,
                                            alteration_path)
            if kind == "bwnoise":
                return st.BwNoisePixmapSource(width, height, seed,
                                              alteration_path)
            if kind == "cnoise":
                return st.ColoredNoisePixmapSource(width, height, seed,
                                                   alteration_path)
            if kind == "gradient":
                return st.GradientPixmapSource(width, height, seed)
            if kind == "first":
                if flow_path is None:
                    raise ValueError("'first' pixmap needs a flow path")
                return st.VideoStillPixmapSource(flow_path, alteration_path)
            raise ValueError(f"Unknown still pixmap {kind!r}")
        if os.path.isfile(path) and ext.lower() in IMAGE_EXTS:
            return st.ImagePixmapSource(path, alteration_path)
        from .video import VideoPixmapSource
        return VideoPixmapSource(path, seek, seek_time, alteration_path,
                                 repeat)

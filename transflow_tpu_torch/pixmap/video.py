"""Video pixmap source: an image sequence or a video file read frame by
frame, with seek, repeat and alteration.

Counterpart of transflow_tpu/pixmap/video.py. It reads through
``utils/imageio.py``: an image sequence in numpy (the frame count, frame
rate and pixels of ``cv2.VideoCapture``), a video file through
``cv2.VideoCapture`` itself, as the JAX source does.
"""
import warnings

import numpy as np

from ..utils.imageio import open_sequence
from .base import PixmapSource


class VideoPixmapSource(PixmapSource):

    def __init__(self, path: str, seek: int | None = None,
                 seek_time: float | None = None,
                 alteration_path: str | None = None, repeat: int = 1):
        super().__init__(alteration_path)
        self.path = path
        self.capture = None
        self.seek = seek
        self.seek_time = seek_time
        self.repeat = repeat
        self.loop_index = 1

    @property
    def is_constant(self) -> bool:
        return False

    def rewind(self):
        """Back to the first frame, then ``seek`` frames on."""
        assert self.capture is not None
        self.capture.pos = 0 if self.seek is None else self.seek

    def open(self):
        self.load_alteration()
        self.capture = open_sequence(self.path)
        self.width = self.capture.width
        self.height = self.capture.height
        self.framerate = round(self.capture.fps)
        frame_count = self.capture.count or 0
        if self.repeat > 0 and frame_count > 0:
            self.length = frame_count * self.repeat
        if self.seek_time is not None:
            self.seek = int(self.seek_time * self.framerate)
            if self.length is not None:
                self.length -= self.seek * self.repeat
        self.rewind()
        return self

    def __next__(self) -> np.ndarray:
        assert self.capture is not None
        if not self.capture.is_opened():
            warnings.warn("Pixmap capture is not opened")
            raise StopIteration
        while True:
            frame = self.capture.read()
            if frame is not None:
                break
            if self.repeat == 0 or self.loop_index < self.repeat:
                self.loop_index += 1
                self.rewind()
                continue
            raise StopIteration
        return self.alter(frame)  # a fresh array per read

    def close(self):
        if self.capture is not None:
            self.capture.close()

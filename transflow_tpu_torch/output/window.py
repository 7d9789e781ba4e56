"""Live preview window (``cv2.imshow``) with an optional pixel HUD.

Counterpart of transflow_tpu/output/window.py. It needs a display: where
there is none, ``open`` raises a ``RuntimeError``; cv2 is imported when the
window opens, and where it is missing that raises an ``ImportError``
naming it. The Pipeline opens and feeds it on the main thread.
"""
import os

import numpy as np

from ..utils.misc import require
from .video_output import VideoOutput


class WindowOutput(VideoOutput):

    WINDOW_NAME = "transflow-tpu"

    def __init__(self, width: int, height: int, framerate: float,
                 show_hud: bool = False):
        super().__init__(width, height, framerate)
        self.show_hud = show_hud
        self.mouse_pos = (0, 0)
        self.last_frame = None
        self._cv2 = None

    def open(self):
        if os.environ.get("DISPLAY") is None and os.name != "nt":
            raise RuntimeError(
                "Window output needs a display; use -o to write to a file "
                "or mjpeg:PORT for a network preview")
        cv2 = self._cv2 = require("cv2", "the preview window")
        cv2.namedWindow(self.WINDOW_NAME, cv2.WINDOW_AUTOSIZE)
        if self.show_hud:
            cv2.setMouseCallback(self.WINDOW_NAME, self._on_mouse)
        return self

    def _on_mouse(self, event, x, y, flags, param):
        self.mouse_pos = (x, y)

    def feed(self, frame):
        cv2 = self._cv2
        frame = np.asarray(frame, dtype=np.uint8)
        self.last_frame = frame
        bgr = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
        if self.show_hud:
            x, y = self.mouse_pos
            if 0 <= y < frame.shape[0] and 0 <= x < frame.shape[1]:
                r, g, b = frame[y, x]
                cv2.putText(bgr, f"({x},{y}) rgb=({r},{g},{b})", (8, 20),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1)
        cv2.imshow(self.WINDOW_NAME, bgr)
        cv2.waitKey(1)

    def close(self):
        cv2 = self._cv2
        if cv2 is None:
            return
        try:
            cv2.destroyWindow(self.WINDOW_NAME)
        except cv2.error:
            pass

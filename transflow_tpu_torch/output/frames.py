"""Image-sequence output ('%d'-template paths).

Counterpart of transflow_tpu/output/frames.py, with the counter resumed
from a checkpoint (``initial_counter``). Frames are written by
``utils/imageio.py``: netpbm (``%04d.ppm``) in numpy, other extensions
through PIL.
"""
import os

from ..utils.imageio import imwrite
from .video_output import VideoOutput


class FramesOutput(VideoOutput):

    def __init__(self, template: str, width: int, height: int,
                 framerate: float, initial_counter: int = 0):
        super().__init__(width, height, framerate)
        self.template = template
        self.counter = initial_counter
        self.output_path = template

    def open(self):
        directory = os.path.dirname(self.template)
        if directory:
            os.makedirs(directory, exist_ok=True)
        return self

    def feed(self, frame):
        imwrite(self.template % self.counter, frame)
        self.counter += 1

"""Encoded video file output.

Counterpart of transflow_tpu/output/encoded.py's ``ffmpeg`` pipe: raw
rgb24 frames piped into an ``ffmpeg`` process, where the machine has the
binary. The JAX package's other writers (its native libav and IO writers,
``cv2.VideoWriter``) are not ported: without ``ffmpeg`` the output raises
``NotImplementedError`` naming ROADMAP Queue 1 item 14.2.
"""
import shutil
import subprocess

import numpy as np

from ..utils import find_unique_path, startfile
from ..utils.imageio import CODECS_NOT_PORTED
from .video_output import VideoOutput


class EncodedVideoOutput(VideoOutput):

    def __init__(self, path: str, width: int, height: int, framerate: float,
                 vcodec: str = "h264", execute: bool = False,
                 replace: bool = False):
        super().__init__(width, height, framerate)
        self.output_path = path if replace else find_unique_path(path)
        self.vcodec = vcodec
        self.execute = execute
        self.process: subprocess.Popen | None = None

    def open(self):
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is None:
            raise NotImplementedError(
                f"writing the video {self.output_path!r} needs an ffmpeg "
                f"binary; the other encoders are {CODECS_NOT_PORTED}")
        self.process = subprocess.Popen(
            [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
             "-s", f"{self.width}x{self.height}",
             "-r", str(self.framerate), "-i", "-",
             "-pix_fmt", "yuv420p", "-vcodec", self.vcodec,
             "-loglevel", "error", self.output_path],
            stdin=subprocess.PIPE)
        return self

    def feed(self, frame):
        self.process.stdin.write(np.asarray(frame, dtype=np.uint8).tobytes())

    def close(self):
        if self.process is not None:
            self.process.stdin.close()
            self.process.wait()
            self.process = None
            if self.execute and self.output_path:
                startfile(self.output_path)

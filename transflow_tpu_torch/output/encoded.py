"""Encoded video file output.

Counterpart of transflow_tpu/output/encoded.py. Writer chain, in the JAX
package's order, of the writers that need no cv2:

1. the libav writer (``av_native.H264Writer``): a real libx264/libx265
   encode through the FFmpeg shared libraries and the repo's prebuilt
   shim, for the vcodecs in ``av_native.ENCODERS``;
2. raw rgb24 frames piped into an ``ffmpeg`` process, where the machine
   has the binary.

The JAX package's other writers (its native IO writer and
``cv2.VideoWriter``) need cv2: where neither writer above opens, the
output raises ``NotImplementedError`` naming ROADMAP Queue 1 item 14.2.
"""
import logging
import shutil
import subprocess

import numpy as np

from .. import av_native
from ..utils import find_unique_path, startfile
from ..utils.imageio import CODECS_NOT_PORTED
from .video_output import VideoOutput

logger = logging.getLogger(__name__)


class EncodedVideoOutput(VideoOutput):

    def __init__(self, path: str, width: int, height: int, framerate: float,
                 vcodec: str = "h264", execute: bool = False,
                 replace: bool = False):
        super().__init__(width, height, framerate)
        self.output_path = path if replace else find_unique_path(path)
        self.vcodec = vcodec
        self.execute = execute
        self.process: subprocess.Popen | None = None
        self.libav: av_native.H264Writer | None = None

    def open(self):
        libav_error = f"no libav encoder for vcodec {self.vcodec!r}"
        if self.vcodec in av_native.ENCODERS:
            try:
                self.libav = av_native.H264Writer(
                    self.output_path, self.width, self.height,
                    self.framerate, codec=self.vcodec)
                return self
            except RuntimeError as err:  # no shim, or no such encoder
                libav_error = str(err)
                logger.debug("libav writer unavailable: %s", err)
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is None:
            raise NotImplementedError(
                f"writing the video {self.output_path!r} needs the libav "
                f"writer ({libav_error}) or an ffmpeg binary; the other "
                f"encoders are {CODECS_NOT_PORTED}")
        self.process = subprocess.Popen(
            [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
             "-s", f"{self.width}x{self.height}",
             "-r", str(self.framerate), "-i", "-",
             "-pix_fmt", "yuv420p", "-vcodec", self.vcodec,
             "-loglevel", "error", self.output_path],
            stdin=subprocess.PIPE)
        return self

    def feed(self, frame):
        frame = np.asarray(frame, dtype=np.uint8)
        if self.libav is not None:
            self.libav.feed(frame)
        else:
            self.process.stdin.write(frame.tobytes())

    def close(self):
        closed = self.libav is not None or self.process is not None
        if self.libav is not None:
            self.libav.close()
            self.libav = None
        if self.process is not None:
            self.process.stdin.close()
            self.process.wait()
            self.process = None
        if closed and self.execute and self.output_path:
            startfile(self.output_path)

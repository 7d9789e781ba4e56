"""Encoded video file output.

Counterpart of transflow_tpu/output/encoded.py, with its writer chain in
its order, best first:

1. the libav writer (``av_native.H264Writer``): a real libx264/libx265
   encode through the FFmpeg shared libraries and the repo's prebuilt
   shim, for the vcodecs in ``av_native.ENCODERS``;
2. the native IO writer (``native.NativeWriter``, native/transflow_io.cpp):
   OpenCV's encoders on a C++ thread with no GIL, with the vcodec's
   FOURCC;
3. raw rgb24 frames piped into an ``ffmpeg`` process, where the machine
   has the binary;
4. ``cv2.VideoWriter`` with the vcodec's FOURCC, then ``mp4v``.

Where none opens, ``open`` raises a ``RuntimeError`` (an ``ImportError``
naming cv2 where the last rung cannot even import it), with the reasons
of the rungs before it.
"""
import logging
import shutil
import subprocess

import numpy as np

from ..utils import find_unique_path, startfile
from ..utils.misc import require
from .video_output import VideoOutput

logger = logging.getLogger(__name__)

_FOURCC = {
    "h264": "avc1",
    "h265": "hev1",
    "hevc": "hev1",
    "mp4v": "mp4v",
    "mjpeg": "MJPG",
    "vp9": "VP90",
}


class EncodedVideoOutput(VideoOutput):

    def __init__(self, path: str, width: int, height: int, framerate: float,
                 vcodec: str = "h264", execute: bool = False,
                 replace: bool = False):
        super().__init__(width, height, framerate)
        self.output_path = path if replace else find_unique_path(path)
        self.vcodec = vcodec
        self.execute = execute
        self.process: subprocess.Popen | None = None
        self.writer = None
        self.native = None
        self.libav = None
        self.opened_by: str | None = None  # the rung that opened

    def open(self):
        skipped = []  # why each rung before the one that opens did not
        try:
            from ..av_native import ENCODERS, H264Writer
            if self.vcodec in ENCODERS:
                self.libav = H264Writer(
                    self.output_path, self.width, self.height,
                    self.framerate, codec=self.vcodec)
                self.opened_by = "libav"
                return self
            skipped.append(f"libav: no encoder for {self.vcodec!r}")
        except Exception as err:  # noqa: BLE001 — the next rung
            skipped.append(f"libav: {err}")
            logger.debug("libav writer unavailable", exc_info=True)
        self.libav = None
        try:
            from ..native import NativeWriter, is_available, load_error
            if is_available():
                self.native = NativeWriter(
                    self.output_path, self.width, self.height,
                    self.framerate,
                    fourcc=_FOURCC.get(self.vcodec, "mp4v"))
                self.opened_by = "native IO"
                return self
            skipped.append(f"native IO: {load_error()}")
        except Exception as err:  # noqa: BLE001 — the next rung
            skipped.append(f"native IO: {err}")
            logger.debug("native writer unavailable", exc_info=True)
        self.native = None
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is not None:
            self.process = subprocess.Popen(
                [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", "rgb24",
                 "-s", f"{self.width}x{self.height}",
                 "-r", str(self.framerate), "-i", "-",
                 "-pix_fmt", "yuv420p", "-vcodec", self.vcodec,
                 "-loglevel", "error", self.output_path],
                stdin=subprocess.PIPE)
            self.opened_by = "ffmpeg"
            return self
        skipped.append("ffmpeg: no binary on PATH")
        cv2 = require("cv2", f"writing the video {self.output_path!r} "
                         f"({'; '.join(skipped)})")
        code = _FOURCC.get(self.vcodec, "mp4v")
        self.writer = cv2.VideoWriter(
            self.output_path, cv2.VideoWriter_fourcc(*code), self.framerate,
            (self.width, self.height))
        if not self.writer.isOpened():
            # last-resort codec
            code = "mp4v"
            self.writer = cv2.VideoWriter(
                self.output_path, cv2.VideoWriter_fourcc(*"mp4v"),
                self.framerate, (self.width, self.height))
        if not self.writer.isOpened():
            self.writer = None
            raise RuntimeError(
                f"Could not open video writer for {self.output_path!r} "
                f"({'; '.join(skipped)}; cv2.VideoWriter: no encoder)")
        self.opened_by = f"cv2.VideoWriter ({code})"
        return self

    def feed(self, frame):
        frame = np.asarray(frame, dtype=np.uint8)
        if self.libav is not None:
            self.libav.feed(frame)
        elif self.native is not None:
            self.native.feed(frame)
        elif self.process is not None:
            self.process.stdin.write(frame.tobytes())
        else:
            import cv2
            self.writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    def close(self):
        opened = any(w is not None for w in (self.libav, self.native,
                                              self.process, self.writer))
        if self.libav is not None:
            self.libav.close()
            self.libav = None
        if self.native is not None:
            self.native.close()
            self.native = None
        if self.process is not None:
            self.process.stdin.close()
            self.process.wait()
            self.process = None
        if self.writer is not None:
            self.writer.release()
            self.writer = None
        if opened and self.execute and self.output_path:
            startfile(self.output_path)

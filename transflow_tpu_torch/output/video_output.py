"""Output router + base class.

Counterpart of transflow_tpu/output/video_output.py, the same routing: a
'%d' template -> image sequence (``frames.py``), another path -> encoded
video file (``encoded.py``: the libav shim's encoder, else an ``ffmpeg``
binary). The preview window (path None) and the MJPEG server
('mjpeg[:port[:host]]') need codecs or a display the port does not have
yet: they raise, naming ROADMAP Queue 1 item 14.2.
"""
import re

from ..utils.imageio import CODECS_NOT_PORTED

_MJPEG_RE = re.compile(r"^mjpeg(:\d+(:[a-z0-9.\-]+)?)?$", re.IGNORECASE)


class VideoOutput:
    """Consumes (H, W, 3) uint8 RGB frames."""

    def __init__(self, width: int, height: int, framerate: float):
        self.width = width
        self.height = height
        self.framerate = framerate
        self.output_path: str | None = None

    def open(self):
        return self

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self.close()

    def feed(self, frame):
        raise NotImplementedError

    def close(self):
        pass

    @classmethod
    def from_args(cls,
                  path: str | None,
                  width: int,
                  height: int,
                  framerate: float,
                  vcodec: str = "h264",
                  execute: bool = False,
                  replace: bool = False,
                  initial_counter: int = 0) -> "VideoOutput":
        if path is None:
            raise NotImplementedError(
                f"the preview window (no -o, or -O) is {CODECS_NOT_PORTED}")
        if _MJPEG_RE.match(path):
            raise NotImplementedError(
                f"the MJPEG output {path!r} is {CODECS_NOT_PORTED}")
        if re.search(r"%\d*d", path):
            from .frames import FramesOutput
            return FramesOutput(path, width, height, framerate,
                                initial_counter)
        from .encoded import EncodedVideoOutput
        return EncodedVideoOutput(path, width, height, framerate, vcodec,
                                  execute, replace)

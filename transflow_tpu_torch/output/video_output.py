"""Output router + base class.

Counterpart of transflow_tpu/output/video_output.py, the same routing:
path None -> the preview window (``window.py``), 'mjpeg[:port[:host]]' ->
the MJPEG server (``mjpeg.py``), a '%d' template -> image sequence
(``frames.py``), another path -> encoded video file (``encoded.py``).
"""
import re

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
            from .window import WindowOutput
            return WindowOutput(width, height, framerate)
        if _MJPEG_RE.match(path):
            from .mjpeg import MjpegOutput
            port, host = 8080, None
            parts = path.split(":")
            if len(parts) >= 2:
                port = int(parts[1])
            if len(parts) >= 3:
                host = parts[2]
            return MjpegOutput(width, height, framerate, port=port, host=host)
        if re.search(r"%\d*d", path):
            from .frames import FramesOutput
            return FramesOutput(path, width, height, framerate,
                                initial_counter)
        from .encoded import EncodedVideoOutput
        return EncodedVideoOutput(path, width, height, framerate, vcodec,
                                  execute, replace)

"""Image and video reading and writing of the port: what the JAX package
asks of cv2 and PIL on the render path (``flow/sources/cv.py``,
``pixmap/``, ``output/frames.py``, ``pipeline.py``).

- Binary PGM (P5) and PPM (P6) at maxval 255 are read and written in
  numpy; other netpbm forms raise.
- Other image extensions go to PIL, imported inside the function that
  needs it, as the JAX package does.
- A printf-pattern image sequence (``frames/%04d.pgm``) opens as
  ``cv2.VideoCapture`` opens it (through FFmpeg's image2 demuxer): the
  first index that exists among 0-4, the count of consecutive files from
  there, and a frame rate of 25. A single image file is a one-frame video
  of unknown length, as there.
- ``rgb_to_gray`` is cv2's ``COLOR_BGR2GRAY`` in its fixed point, and
  ``resize_nearest`` is ``cv2.resize(..., INTER_NEAREST)`` as an index
  map.

Video containers, camera indexes (all digits) and streams open through
``cv2.VideoCapture`` (``VideoSequence``), as the JAX package opens them;
cv2 is imported there, and where it is missing the open raises an
``ImportError`` that names it.
"""
import os
import re

import numpy as np

from .misc import require

NETPBM_EXTS = {".pgm", ".ppm", ".pnm"}
# still-image extensions read by PIL (also the pixmap router's)
PIL_EXTS = {".jpg", ".jpeg", ".png", ".webp", ".bmp", ".ico", ".tiff"}
IMAGE_EXTS = NETPBM_EXTS | PIL_EXTS
# what cv2.VideoCapture reports for an image sequence
SEQUENCE_FPS = 25.0
# FFmpeg's image2 looks for a sequence's first file among these indexes
FIRST_INDEXES = range(5)

_PATTERN_RE = re.compile(r"%0?\d*d")
_WHITESPACE = b" \t\r\n\v\f"
# cv2's BGR2GRAY weights for R, G and B, in 1/2^15 (ITU-R BT.601)
_GRAY_WEIGHTS = (9798, 19235, 3735)


# ---------------------------------------------------------------------------
# netpbm
# ---------------------------------------------------------------------------

def read_netpbm(path: str) -> np.ndarray:
    """A binary PGM as (H, W) or PPM as (H, W, 3) RGB uint8, writable."""
    with open(path, "rb") as file:
        data = bytearray(os.fstat(file.fileno()).st_size)
        file.readinto(data)
    magic = bytes(data[:2])
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: not a binary PGM or PPM (magic {magic!r})")
    pos, fields = 2, []
    while len(fields) < 3:
        char = bytes(data[pos:pos + 1])
        if not char:
            raise ValueError(f"{path}: truncated netpbm header")
        if char in _WHITESPACE:
            pos += 1
        elif char == b"#":
            end = data.find(b"\n", pos)
            pos = len(data) if end < 0 else end + 1
        else:
            end = pos
            while data[end:end + 1].isdigit():
                end += 1
            if end == pos:
                raise ValueError(f"{path}: bad netpbm header at byte {pos}")
            fields.append(int(data[pos:end]))
            pos = end
    width, height, maxval = fields
    if maxval != 255:
        raise ValueError(f"{path}: maxval {maxval}; only 255 is read")
    pos += 1  # the single whitespace after maxval
    channels = 1 if magic == b"P5" else 3
    count = width * height * channels
    if len(data) - pos < count:
        raise ValueError(f"{path}: truncated netpbm data")
    array = np.frombuffer(data, np.uint8, count=count, offset=pos)
    return array.reshape((height, width) if channels == 1
                         else (height, width, 3))


def write_netpbm(path: str, array: np.ndarray) -> None:
    """Write (H, W) gray as a binary PGM, (H, W, 3) RGB as a binary PPM
    (a .pgm path takes RGB as its gray)."""
    array = np.asarray(array, dtype=np.uint8)
    if array.ndim == 3 and array.shape[2] == 1:
        array = array[..., 0]
    if array.ndim == 3 and os.path.splitext(path)[1].lower() == ".pgm":
        array = rgb_to_gray(array[..., :3])
    if array.ndim == 3 and array.shape[2] != 3:
        raise ValueError(f"{path}: netpbm takes gray or RGB, not "
                         f"{array.shape[2]} channels")
    magic = "P5" if array.ndim == 2 else "P6"
    height, width = array.shape[:2]
    with open(path, "wb") as file:
        file.write(f"{magic}\n{width} {height}\n255\n".encode())
        np.ascontiguousarray(array).tofile(file)


# ---------------------------------------------------------------------------
# any image
# ---------------------------------------------------------------------------

def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def imread(path: str) -> np.ndarray:
    """An image as its file holds it: (H, W) gray, (H, W, 3) RGB or (H, W,
    4) RGBA uint8 (netpbm here, anything else through PIL, as
    ``np.asarray(PIL.Image.open(path))``)."""
    if _ext(path) in NETPBM_EXTS:
        return read_netpbm(path)
    import PIL.Image
    with PIL.Image.open(path) as image:
        return np.asarray(image).copy()


def imwrite(path: str, array: np.ndarray) -> None:
    """Write an RGB(A) or gray uint8 image (netpbm here, else PIL)."""
    if _ext(path) in NETPBM_EXTS:
        write_netpbm(path, array)
        return
    import PIL.Image
    PIL.Image.fromarray(np.asarray(array, dtype=np.uint8)).save(path)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) RGB uint8 -> (...) gray as cv2's ``COLOR_BGR2GRAY`` gives
    it for the same pixels: ``(9798 R + 19235 G + 3735 B + 2^14) >> 15``."""
    rgb = np.asarray(rgb)
    wr, wg, wb = _GRAY_WEIGHTS
    acc = rgb[..., 0] * np.int32(wr)
    acc += rgb[..., 1] * np.int32(wg)
    acc += rgb[..., 2] * np.int32(wb)
    acc += 1 << 14
    return (acc >> 15).astype(np.uint8)


def to_gray(image: np.ndarray) -> np.ndarray:
    """An image of ``imread`` as (H, W) gray, as cv2 decodes it to BGR and
    converts (a gray file is its own gray; alpha is dropped)."""
    return image if image.ndim == 2 else rgb_to_gray(image[..., :3])


def to_rgb(image: np.ndarray) -> np.ndarray:
    """An image of ``imread`` as (H, W, 3) RGB (gray repeated, alpha
    dropped), as cv2 decodes it to BGR and converts to RGB."""
    if image.ndim == 2:
        return np.repeat(image[..., None], 3, axis=2)
    return image[..., :3]


def resize_nearest(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(image, (width, height), interpolation=INTER_NEAREST)``:
    output pixel (y, x) reads source pixel (floor(y * fy), floor(x * fx)),
    where f is 1 / (output size / source size) in double, clamped to the
    last row and column."""
    src_h, src_w = image.shape[:2]
    fy = 1.0 / (height / src_h)
    fx = 1.0 / (width / src_w)
    rows = np.minimum(np.floor(np.arange(height) * fy).astype(np.int64),
                      src_h - 1)
    cols = np.minimum(np.floor(np.arange(width) * fx).astype(np.int64),
                      src_w - 1)
    return image[rows[:, None], cols[None, :]]


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------

class ImageSequence:
    """A printf-pattern image sequence, or one image file, read frame by
    frame as ``cv2.VideoCapture`` reads it: ``count`` frames (None for a
    single file, whose length cv2 does not report), ``framerate`` 25,
    ``width`` and ``height`` of the first frame, and a settable position
    ``pos`` (the next frame read)."""

    fps = framerate = SEQUENCE_FPS

    def __init__(self, path: str):
        self.path = path
        self.pos = 0
        self._closed = False
        self.first = 0
        self.count: int | None = None
        if _PATTERN_RE.search(path):
            first = next((i for i in FIRST_INDEXES
                          if os.path.isfile(path % i)), None)
            if first is None:
                raise FileNotFoundError(
                    f"no file of the sequence {path!r} at an index in "
                    f"{FIRST_INDEXES.start}-{FIRST_INDEXES.stop - 1}")
            count = 0
            while os.path.isfile(path % (first + count)):
                count += 1
            self.first, self.count = first, count
        elif not os.path.isfile(path):
            raise FileNotFoundError(f"no such image {path!r}")
        self.height, self.width = imread(self._file(0)).shape[:2]

    def _file(self, index: int) -> str:
        if self.count is None:
            return self.path
        return self.path % (self.first + index)

    def read(self, gray: bool = False) -> np.ndarray | None:
        """The next frame as (H, W) gray or (H, W, 3) RGB, or None past
        the last one."""
        if self.pos >= (1 if self.count is None else self.count):
            return None
        image = imread(self._file(self.pos))
        self.pos += 1
        return to_gray(image) if gray else to_rgb(image)

    def seek_frame(self, index: int) -> bool:
        """Set ``pos`` to ``index`` (always lands)."""
        self.pos = index
        return True

    def is_opened(self) -> bool:
        return not self._closed

    def close(self) -> None:
        self._closed = True


class VideoSequence:
    """A video file, a camera (``path`` all digits: its index) or a stream
    read through ``cv2.VideoCapture``, with ``ImageSequence``'s interface:
    ``count`` is ``CAP_PROP_FRAME_COUNT`` (-1 or 0 for a camera),
    ``framerate`` ``CAP_PROP_FPS`` or 30 (``fps`` the reported value),
    ``width`` and ``height`` the capture's after a ``size`` request, and
    ``pos`` the frames read since the last rewind. Setting ``pos``
    rewinds as the JAX sources do: ``CAP_PROP_POS_MSEC`` to 0, then that
    many frames read and dropped."""

    def __init__(self, path: str, size: tuple[int, int] | None = None):
        cv2 = require("cv2", f"reading the video {path!r}")
        self.path = path
        self._cv2 = cv2
        self.capture = cv2.VideoCapture(
            int(path) if re.fullmatch(r"\d+", path) else path)
        if not self.capture.isOpened():
            raise FileNotFoundError(f"Could not open the video {path!r}")
        if size is not None:
            self.capture.set(cv2.CAP_PROP_FRAME_WIDTH, size[0])
            self.capture.set(cv2.CAP_PROP_FRAME_HEIGHT, size[1])
        self.width = int(self.capture.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.capture.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self.capture.get(cv2.CAP_PROP_FPS))
        self.framerate = self.fps or 30.0
        self.count = int(self.capture.get(cv2.CAP_PROP_FRAME_COUNT))
        self._pos = 0

    @property
    def pos(self) -> int:
        return self._pos

    @pos.setter
    def pos(self, index: int) -> None:
        self.capture.set(self._cv2.CAP_PROP_POS_MSEC, 0)
        for _ in range(index):
            self.capture.read()
        self._pos = index

    def seek_frame(self, index: int) -> bool:
        """Seek the container to frame ``index`` (``CAP_PROP_POS_FRAMES``);
        False where the capture reports another position after it."""
        cv2 = self._cv2
        self.capture.set(cv2.CAP_PROP_POS_FRAMES, index)
        if int(self.capture.get(cv2.CAP_PROP_POS_FRAMES)) != index:
            return False
        self._pos = index
        return True

    def read(self, gray: bool = False) -> np.ndarray | None:
        """The next frame as (H, W) gray or (H, W, 3) RGB, converted from
        the decoded BGR by ``cv2.cvtColor``, or None at the end."""
        success, frame = self.capture.read()
        if not success or frame is None:
            return None
        self._pos += 1
        cv2 = self._cv2
        return cv2.cvtColor(
            frame, cv2.COLOR_BGR2GRAY if gray else cv2.COLOR_BGR2RGB)

    def is_opened(self) -> bool:
        return self.capture.isOpened()

    def close(self) -> None:
        self.capture.release()


def open_sequence(path: str, size: tuple[int, int] | None = None
                  ) -> "ImageSequence | VideoSequence":
    """An ``ImageSequence`` over ``path`` where it is a printf pattern or a
    file with an image extension; else a ``VideoSequence`` (a video file,
    a camera index or a stream), which asks ``size`` of the capture."""
    if _PATTERN_RE.search(path) or _ext(path) in IMAGE_EXTS:
        return ImageSequence(path)
    return VideoSequence(path, size)

"""ctypes binding of the repo's prebuilt libav shim (native/transflow_av.cpp).

Counterpart of transflow_tpu/av_native.py, the port's own copy: direct
FFmpeg-library access on a machine with neither an ``ffmpeg`` binary nor
PyAV.

* ``MvReader``: motion-vector export decode, the backend of ``--mv``
  (``flow/sources/mv.py``). The shim hands back the decoder's raw
  ``AVMotionVector`` side-data records; numpy reads them in place through
  :data:`MV_DTYPE`.
* ``H264Writer``: libx264 encode (rgb24 in, yuv420p out, the container
  from the path), the first writer of ``-o x.mp4``
  (``output/encoded.py``), and the maker of the bf=0/refs=1 streams the
  MV source needs.

The library is loaded as it is committed, never built: ``make`` would
need FFmpeg's headers, which no machine of the port is known to have.
Where it does not load (no FFmpeg shared libraries), ``is_available()``
is False and ``load_error()`` says why.
"""
import ctypes
import os
import threading

import numpy as np

LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "libtransflow_av.so")
_lock = threading.Lock()
_state: dict = {}  # "lib" (a ctypes.CDLL or None) and "error" once loaded

# libavutil/motion_vector.h AVMotionVector, x86-64 layout: the uint64 flags
# field aligns to 8, padding the 14 leading bytes to 16; trailing pad takes
# the struct to 40. The shim reports sizeof(AVMotionVector) and MvReader
# asserts it matches, so an ABI drift fails loudly instead of misparsing.
MV_DTYPE = np.dtype({
    "names": ["source", "w", "h", "src_x", "src_y", "dst_x", "dst_y",
              "flags", "motion_x", "motion_y", "motion_scale"],
    "formats": ["<i4", "u1", "u1", "<i2", "<i2", "<i2", "<i2",
                "<u8", "<i4", "<i4", "<u2"],
    "offsets": [0, 4, 5, 6, 8, 10, 12, 16, 24, 28, 32],
    "itemsize": 40,
})


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Every C entry's argtypes and restype (transflow_av.cpp)."""
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.tfav_dec_open.restype = ctypes.c_void_p
    lib.tfav_dec_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.tfav_dec_error.restype = ctypes.c_char_p
    lib.tfav_dec_error.argtypes = [ctypes.c_void_p]
    lib.tfav_dec_info.restype = ctypes.c_int
    lib.tfav_dec_info.argtypes = [
        ctypes.c_void_p, c_int_p, c_int_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64)]
    lib.tfav_dec_next.restype = ctypes.c_int
    lib.tfav_dec_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        c_int_p, c_int_p]
    lib.tfav_dec_rewind.restype = ctypes.c_int
    lib.tfav_dec_rewind.argtypes = [ctypes.c_void_p]
    lib.tfav_dec_close.restype = None
    lib.tfav_dec_close.argtypes = [ctypes.c_void_p]
    lib.tfav_enc_open.restype = ctypes.c_void_p
    lib.tfav_enc_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p]
    lib.tfav_enc_error.restype = ctypes.c_char_p
    lib.tfav_enc_error.argtypes = [ctypes.c_void_p]
    lib.tfav_enc_write.restype = ctypes.c_int
    lib.tfav_enc_write.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint8)]
    lib.tfav_enc_close.restype = ctypes.c_int
    lib.tfav_enc_close.argtypes = [ctypes.c_void_p]
    return lib


def _load() -> ctypes.CDLL | None:
    """The shim, loaded once per process; None where it does not load."""
    with _lock:
        if "lib" not in _state:
            try:
                _state["lib"] = _declare(ctypes.CDLL(LIB_PATH))
                _state["error"] = None
            except OSError as err:
                _state["lib"] = None
                _state["error"] = str(err)
        return _state["lib"]


def is_available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    """The ``OSError`` text of a failed load, None where the shim loads."""
    _load()
    return _state.get("error")


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native libav library unavailable: "
                           f"{_state.get('error')}")
    return lib


class MvReader:
    """Sequential decode of a video's motion-vector side data.

    ``next()`` returns one frame's records as a numpy recarray over
    :data:`MV_DTYPE` (fields source, w, h, src_x, src_y, dst_x, dst_y,
    flags, motion_x, motion_y, motion_scale, as PyAV's MotionVector
    names them), an empty array for a frame without side data, or None at
    the end of the stream."""

    def __init__(self, path: str, format: str | None = None):
        lib = _require()
        self._lib = lib
        self._handle = lib.tfav_dec_open(
            str(path).encode(), format.encode() if format else None)
        err = lib.tfav_dec_error(self._handle)
        if err:
            message = err.decode()
            lib.tfav_dec_close(self._handle)
            self._handle = None
            raise FileNotFoundError(f"Could not open {path!r}: {message}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        count = ctypes.c_int64()
        lib.tfav_dec_info(self._handle, ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(fps), ctypes.byref(count))
        self.width, self.height = w.value, h.value
        self.fps = fps.value
        self.frame_count = count.value  # 0: the container does not know

    def next(self) -> np.recarray | None:
        data = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_int()
        rec = ctypes.c_int()
        status = self._lib.tfav_dec_next(
            self._handle, ctypes.byref(data), ctypes.byref(n),
            ctypes.byref(rec))
        if status == 0:
            return None
        if status < 0:
            err = self._lib.tfav_dec_error(self._handle)
            raise RuntimeError("native decode failed: "
                               + (err.decode() if err else str(status)))
        if rec.value != MV_DTYPE.itemsize:
            raise RuntimeError(
                f"AVMotionVector ABI drift: sizeof={rec.value}, "
                f"dtype={MV_DTYPE.itemsize}; update MV_DTYPE for this libav")
        if n.value == 0 or not data:
            return np.recarray(0, dtype=MV_DTYPE)
        raw = ctypes.string_at(data, n.value * rec.value)  # copy out
        return np.frombuffer(raw, dtype=MV_DTYPE).view(np.recarray)

    def rewind(self):
        if self._lib.tfav_dec_rewind(self._handle) < 0:
            err = self._lib.tfav_dec_error(self._handle)
            raise RuntimeError("native rewind failed: "
                               + (err.decode() if err else "?"))

    def close(self):
        if self._handle:
            self._lib.tfav_dec_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# user-facing vcodec names -> libavcodec encoder names
ENCODERS = {"h264": "libx264", "libx264": "libx264",
            "h265": "libx265", "hevc": "libx265", "libx265": "libx265"}


class H264Writer:
    """Real-codec video writer: rgb24 frames in, the muxer picked from the
    path, the encoder from ``codec`` (libx264 by default; libx265 works
    too).

    ``max_b_frames=0, refs=1`` (the defaults) make streams whose motion
    vectors the MV flow source accepts (every record's source == -1: no
    bidirectional prediction)."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 gop: int = 0, max_b_frames: int = 0, refs: int = 1,
                 crf: int = 18, preset: str = "fast",
                 codec: str = "libx264"):
        lib = _require()
        self._lib = lib
        self.width, self.height = width, height
        self._handle = lib.tfav_enc_open(
            str(path).encode(), ENCODERS.get(codec, codec).encode(),
            width, height, fps, gop, max_b_frames, refs, crf,
            preset.encode())
        err = lib.tfav_enc_error(self._handle)
        if err:
            message = err.decode()
            lib.tfav_enc_close(self._handle)
            self._handle = None
            raise RuntimeError(f"Could not open H264 writer for "
                               f"{path!r}: {message}")

    def feed(self, rgb: np.ndarray):
        if rgb.shape != (self.height, self.width, 3):
            raise ValueError(f"expected {(self.height, self.width, 3)}, "
                             f"got {rgb.shape}")
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        ptr = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if self._lib.tfav_enc_write(self._handle, ptr) < 0:
            err = self._lib.tfav_enc_error(self._handle)
            raise RuntimeError("native encode failed: "
                               + (err.decode() if err else "?"))

    def close(self):
        if self._handle:
            status = self._lib.tfav_enc_close(self._handle)
            self._handle = None
            if status < 0:
                raise RuntimeError(f"native encoder close failed ({status})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

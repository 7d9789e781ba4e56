"""ctypes binding of the repo's native host IO runtime
(native/transflow_io.cpp).

Counterpart of transflow_tpu/native.py, the port's own copy, with the same
C signatures: OpenCV decode, resize and color conversion (``NativeReader``)
and encode (``NativeWriter``) run on native threads with no GIL and hand
frames over through bounded ring buffers; ``display`` shows a frame in an
OpenCV window and returns the key pressed.

The library is ``native/libtransflow_io.so`` as it is committed. Where that
file is missing, ``native/transflow_io.cpp`` is built with
``native/Makefile``'s flags into the package's git-ignored ``_build/``
(``native/`` is never written). Where it neither loads nor builds (no
OpenCV shared libraries), ``is_available()`` is False, ``load_error()``
says why, and every entry raises a ``RuntimeError`` naming the library.
"""
import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_ROOT, "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libtransflow_io.so")
SOURCE = os.path.join(NATIVE_DIR, "transflow_io.cpp")
BUILD_PATH = os.path.join(_ROOT, "transflow_tpu_torch", "_build",
                          "libtransflow_io.so")
# native/Makefile's CXXFLAGS and its OpenCV flags
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-Wall", "-fPIC"]
_lock = threading.Lock()
_state: dict = {}  # "lib" (a ctypes.CDLL or None) and "error" once loaded


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Every C entry's argtypes and restype (transflow_io.cpp)."""
    lib.tfio_reader_open.restype = ctypes.c_void_p
    lib.tfio_reader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.tfio_reader_meta.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64)]
    lib.tfio_reader_next.restype = ctypes.c_int
    lib.tfio_reader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int]
    lib.tfio_reader_close.argtypes = [ctypes.c_void_p]
    lib.tfio_writer_open.restype = ctypes.c_void_p
    lib.tfio_writer_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_char_p]
    lib.tfio_writer_feed.restype = ctypes.c_int
    lib.tfio_writer_feed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.tfio_writer_close.argtypes = [ctypes.c_void_p]
    lib.tfio_display.restype = ctypes.c_int
    lib.tfio_display.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    return lib


def _build() -> str:
    """``native/transflow_io.cpp`` built into ``BUILD_PATH``, as
    ``native/Makefile`` builds it; raises ``OSError`` where it cannot."""
    try:
        opencv = subprocess.run(
            ["pkg-config", "--cflags", "--libs", "opencv4"],
            capture_output=True, text=True, check=True, timeout=60)
        os.makedirs(os.path.dirname(BUILD_PATH), exist_ok=True)
        subprocess.run(
            [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", SOURCE,
             *opencv.stdout.split(), "-o", BUILD_PATH],
            capture_output=True, text=True, check=True, timeout=300)
    except subprocess.CalledProcessError as err:
        raise OSError(f"building {SOURCE} failed: {err.cmd[0]}: "
                      f"{err.stderr.strip()[-400:]}") from err
    except (FileNotFoundError, subprocess.TimeoutExpired) as err:
        raise OSError(f"building {SOURCE} failed: {err}") from err
    return BUILD_PATH


def _load() -> ctypes.CDLL | None:
    """The library, loaded (or built) once per process; None where it
    neither loads nor builds."""
    with _lock:
        if "lib" not in _state:
            try:
                path = LIB_PATH
                if not os.path.isfile(path):
                    path = (BUILD_PATH if os.path.isfile(BUILD_PATH)
                            else _build())
                _state["lib"] = _declare(ctypes.CDLL(path))
                _state["error"] = None
            except OSError as err:
                _state["lib"] = None
                _state["error"] = str(err)
        return _state["lib"]


def is_available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    """Why the library did not load, None where it loads."""
    _load()
    return _state.get("error")


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native IO library (native/libtransflow_io.so, "
                           f"OpenCV) unavailable: {_state.get('error')}")
    return lib


class NativeReader:
    """Background-decoded frame stream (file or camera)."""

    def __init__(self, path: str | int, width: int = 0, height: int = 0,
                 gray: bool = False, skip_frames: int = 0):
        lib = _require()
        self._lib = lib
        camera = path if isinstance(path, int) else -1
        encoded = b"" if isinstance(path, int) else str(path).encode()
        self._handle = lib.tfio_reader_open(encoded, camera, width, height,
                                            int(gray), skip_frames)
        if not self._handle:
            raise FileNotFoundError(f"Could not open {path!r}")
        w = ctypes.c_int()
        h = ctypes.c_int()
        fps = ctypes.c_double()
        count = ctypes.c_int64()
        lib.tfio_reader_meta(self._handle, ctypes.byref(w), ctypes.byref(h),
                             ctypes.byref(fps), ctypes.byref(count))
        self.width, self.height = w.value, h.value
        self.fps = fps.value or 30.0
        self.frame_count = count.value
        self.gray = gray
        self._buffer = np.empty(
            (self.height, self.width) if gray
            else (self.height, self.width, 3), dtype=np.uint8)

    def read(self, timeout_ms: int = 10000):
        """Next frame as a numpy array (copy), or None at end of stream."""
        ptr = self._buffer.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        status = self._lib.tfio_reader_next(
            self._handle, ptr, self._buffer.nbytes, timeout_ms)
        if status == -1:
            return None
        if status == 0:
            raise TimeoutError("native reader timed out")
        if status < 0:
            raise RuntimeError(f"native reader error {status}")
        return self._buffer.copy()

    def __iter__(self):
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def close(self):
        if self._handle:
            self._lib.tfio_reader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeWriter:
    """Background-encoded RGB video writer."""

    def __init__(self, path: str, width: int, height: int, fps: float,
                 fourcc: str = "MJPG"):
        lib = _require()
        self._lib = lib
        self._handle = lib.tfio_writer_open(
            str(path).encode(), width, height, fps, fourcc.encode()[:4])
        if not self._handle:
            raise RuntimeError(f"Could not open writer for {path!r}")

    def feed(self, rgb: np.ndarray):
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        ptr = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        if not self._lib.tfio_writer_feed(self._handle, ptr, rgb.nbytes):
            raise RuntimeError("native writer rejected frame")

    def close(self):
        if self._handle:
            self._lib.tfio_writer_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def display(window: str, rgb: np.ndarray, wait_ms: int = 1) -> int:
    """Show a frame in a native window; returns the pressed key or -1."""
    lib = _require()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    ptr = rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    return lib.tfio_display(window.encode(), ptr, rgb.shape[1], rgb.shape[0],
                            wait_ms)

"""The port's video and camera routes against the JAX package's, on the
CPU with the same numpy-seeded inputs: the cv2-decoded flow and pixmap
sources, the headline command with a video, the encoder chain rung by
rung, the native IO runtime, the preview window (under a cv2 whose
HighGUI calls are recorded), the MJPEG output, the realtime tool and the
webcam probe."""
import contextlib
import ctypes
import http.client
import io
import os
import re
import shutil
import socket
import subprocess
import sys

import cv2
import numpy as np
import pytest

from test_torch_tools import EXTRA, HighGuiStub
from transflow_tpu import av_native as jav
from transflow_tpu import cli as jcli
from transflow_tpu import native as jnative
from transflow_tpu.flow.sources import cv as jcv
from transflow_tpu.output import encoded as jencoded
from transflow_tpu.output import mjpeg as jmjpeg
from transflow_tpu.output import window as jwindow
from transflow_tpu.pixmap.video import VideoPixmapSource as JaxVideoPixmap
from transflow_tpu_torch import av_native, cli, native
from transflow_tpu_torch.flow.sources import cv
from transflow_tpu_torch.output import encoded, mjpeg, window
from transflow_tpu_torch.pixmap.video import VideoPixmapSource
from transflow_tpu_torch.utils.imageio import imwrite, read_netpbm

H, W = 48, 64
FRAMES = 12        # 11 flows
FPS = 10.0
PAN = 2            # px per frame along x
SEED = 0
TIMEOUT = 10       # seconds for any socket wait
# tests/test_torch_pipeline.py's bars for the CLI against the JAX CLI
FLOW_PSNR = 60.0
FRAME_SHARE = 0.01


def _texture(rng, h, w):
    """A smooth random texture (the Farneback pan needs structure)."""
    from scipy import ndimage
    rgb = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w, 3)),
                                  (1.5, 1.5, 0))
    return rgb.astype(np.uint8)


def write_clip(path, frames=FRAMES, h=H, w=W, fps=FPS, seed=SEED):
    """An MJPG .avi of a texture panned ``PAN`` px a frame, written by
    ``cv2.VideoWriter``; returns the RGB frames written."""
    rng = np.random.default_rng(seed)
    canvas = _texture(rng, h, w + PAN * frames)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                             (w, h))
    rgb = [canvas[:, PAN * i:PAN * i + w] for i in range(frames)]
    for frame in rgb:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    return rgb


def read_video(path):
    """Every frame of ``path`` as cv2 decodes it (BGR)."""
    capture = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return np.stack(frames)


def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("codecs") / "clip.avi"
    write_clip(path)
    return str(path)


# ---------------------------------------------------------------------------
# the cv2-decoded sources
# ---------------------------------------------------------------------------

def _items(source):
    source.open()
    items = [(np.asarray(item.array),
              None if item.prime is None else np.asarray(item.prime))
             for item in source]
    source.close()
    return source.length, source.framerate, items


def _assert_items_equal(got, want):
    assert got[:2] == want[:2]
    assert len(got[2]) == len(want[2]) > 0
    for (frame, prime), (jframe, jprime) in zip(got[2], want[2]):
        np.testing.assert_array_equal(frame, jframe)
        assert (prime is None) == (jprime is None)
        if prime is not None:
            np.testing.assert_array_equal(prime, jprime)


@pytest.mark.parametrize("method,kwargs", [
    ("farneback", {}),
    ("liteflownet", {}),
    ("farneback", {"seek_time": 0.3, "duration_time": 0.5}),
    ("farneback", {"repeat": 3}),
    ("horn-schunck", {"size": (32, 24)}),
], ids=["gray", "rgb", "seek", "repeat", "size"])
def test_cv_flow_source_matches_jax(clip, method, kwargs):
    """Gray frames (RGB for LiteFlowNet) with their primes, the length and
    the frame rate of the JAX source, through seeks and repeats."""
    got = _items(cv.CvFlowSource(clip, cv.CvFlowConfig(method=method),
                                 **kwargs))
    want = _items(jcv.CvFlowSource(clip, jcv.CvFlowConfig(method=method),
                                   **kwargs))
    _assert_items_equal(got, want)
    assert got[2][0][0].ndim == (3 if method == "liteflownet" else 2)


def test_cv_flow_source_fast_seek(tmp_path):
    """A rewind beyond ``FAST_SEEK_THRESHOLD`` seeks the container (and
    checks where it landed), as the JAX source does: the same items."""
    path = tmp_path / "long.avi"
    count = cv.CvFlowSource.FAST_SEEK_THRESHOLD + 10
    write_clip(path, frames=count, h=16, w=24)
    start = count - 5
    kwargs = dict(seek_time=start / FPS)
    got = cv.CvFlowSource(str(path), **kwargs)
    want = jcv.CvFlowSource(str(path), **kwargs)
    assert got.FAST_SEEK_THRESHOLD == want.FAST_SEEK_THRESHOLD == 300
    got_items, want_items = _items(got), _items(want)
    assert got.start_frame == want.start_frame == start
    _assert_items_equal(got_items, want_items)
    assert got.capture.pos == count


def test_cv_flow_source_resizes_nearest(clip, monkeypatch):
    """A frame of another size than the capture reports is resized
    nearest, as the JAX source's ``cv2.resize(INTER_NEAREST)``."""
    from transflow_tpu_torch.utils import imageio
    real = imageio.VideoSequence.read

    def shrunk(self, gray=False):
        frame = real(self, gray)
        return None if frame is None else frame[::2, ::3]

    monkeypatch.setattr(imageio.VideoSequence, "read", shrunk)
    items = _items(cv.CvFlowSource(clip))[2]
    want = [cv2.resize(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)[::2, ::3],
                       (W, H), interpolation=cv2.INTER_NEAREST)
            for f in read_video(clip)]
    np.testing.assert_array_equal(items[0][1], want[0])
    np.testing.assert_array_equal(items[-1][0], want[-1])


@pytest.mark.parametrize("kwargs", [
    {}, {"seek": 3}, {"repeat": 2}, {"seek_time": 0.2, "repeat": 3},
    {"repeat": 0}], ids=["plain", "seek", "repeat", "seek_time", "forever"])
def test_video_pixmap_matches_jax(clip, kwargs):
    """RGB frames, length and frame rate of the JAX pixmap source, through
    its rewinds (``repeat=0`` loops: its first 30 frames)."""
    got, want = VideoPixmapSource(clip, **kwargs), JaxVideoPixmap(clip,
                                                                  **kwargs)
    got.open()
    want.open()
    assert (got.length, got.framerate) == (want.length, want.framerate)
    n = 30 if want.length is None else want.length + 1
    frames = [[next(src, None) for _ in range(n)] for src in (got, want)]
    assert sum(f is not None for f in frames[0]) > 0
    for frame, jframe in zip(*frames):
        assert (frame is None) == (jframe is None)
        if frame is not None:
            np.testing.assert_array_equal(frame, jframe)
    got.close()
    want.close()
    with pytest.warns(UserWarning, match="not opened"):
        assert next(got, None) is None


def test_first_frame_pixmap_of_a_video(clip):
    """``-p first`` takes the video's first frame, as in the JAX
    package."""
    from transflow_tpu.pixmap.base import PixmapSource as JaxPixmapSource
    from transflow_tpu_torch.pixmap.base import PixmapSource
    got = PixmapSource.from_args("first", (W, H), flow_path=clip).open()
    want = JaxPixmapSource.from_args("first", (W, H), flow_path=clip).open()
    np.testing.assert_array_equal(next(got), next(want))


# ---------------------------------------------------------------------------
# the headline command with a video
# ---------------------------------------------------------------------------

def _flows(path):
    import zipfile
    with zipfile.ZipFile(path) as archive:
        names = sorted(n for n in archive.namelist() if n.endswith(".npy"))
        return np.stack([np.load(io.BytesIO(archive.read(n)))
                         for n in names])


@pytest.fixture(scope="module")
def headline(clip, tmp_path_factory):
    """``clip.avi -p still.png -o out.mp4 -F`` and ``-o %04d.png`` through
    both CLIs: the frames and flows of each."""
    root = tmp_path_factory.mktemp("headline")
    still = str(root / "still.png")
    imwrite(still, np.random.default_rng(1).integers(0, 256, (H, W, 3),
                                                     np.uint8))
    runs = {}
    for package in ("jax", "port"):
        (root / package).mkdir()
        mp4 = str(root / package / "out.mp4")
        png = str(root / package / "%04d.png")
        for out, extra in ((mp4, ["-F"]), (png, [])):
            argv = [clip, "-p", still, "--seed", str(SEED), "-r", "random",
                    "0.05", "-o", out, *extra, "--no-exec", "--overwrite"]
            if package == "jax":
                jcli.main(argv)
            else:
                cli.main(argv, device="cpu")
        pngs = sorted((root / package).glob("*.png"))
        runs[package] = (read_video(mp4), _flows(root / package /
                                                 "out.flow.zip"),
                         np.stack([cv2.imread(str(p)) for p in pngs]))
    return runs


def test_headline_command_meets_jax_bars(headline):
    (mp4, flows, pngs), (jmp4, jflows, jpngs) = (headline["port"],
                                                 headline["jax"])
    assert mp4.shape == jmp4.shape == pngs.shape == (FRAMES - 1, H, W, 3)
    assert flows.shape == jflows.shape == (FRAMES - 1, H, W, 2)
    assert np.abs(jflows).max() > 1.0
    for k in range(FRAMES - 1):
        mse = float(np.mean((flows[k] - jflows[k]) ** 2))
        assert mse == 0 or 10 * np.log10(64.0 / mse) >= FLOW_PSNR, k
        for got, want in ((pngs, jpngs), (mp4, jmp4)):
            assert (got[k] != want[k]).any(axis=-1).mean() <= FRAME_SHARE, k


def test_headline_command_finds_the_pan(headline):
    flows = headline["port"][1][:, 8:-8, 8:-8]
    medians = np.median(flows.reshape(len(flows), -1, 2), axis=1)
    np.testing.assert_allclose(medians[:, 0], PAN, atol=0.5)
    np.testing.assert_allclose(medians[:, 1], 0.0, atol=0.5)


# ---------------------------------------------------------------------------
# the encoder chain, rung by rung
# ---------------------------------------------------------------------------

FAKE_FFMPEG = """#!/bin/sh
# a stand-in for ffmpeg: its arguments, then the piped raw frames
for last; do :; done
echo "$@" > "$last.argv"
cat > "$last"
"""


def _no_libav(*args, **kwargs):
    raise RuntimeError("libav forced away")


def _force(monkeypatch, tmp_path, rung):
    """Monkeypatch away the rungs before ``rung`` in both packages."""
    if rung == "libav":
        return
    for module in (jav, av_native):
        monkeypatch.setattr(module, "H264Writer", _no_libav)
    if rung == "native":
        return
    for module in (jnative, native):
        monkeypatch.setattr(module, "is_available", lambda: False)
    if rung == "ffmpeg":
        fake = tmp_path / "ffmpeg"
        fake.write_text(FAKE_FFMPEG)
        fake.chmod(0o755)
        monkeypatch.setattr(shutil, "which", lambda name: str(fake))
        return
    monkeypatch.setattr(shutil, "which", lambda name: None)


def _jax_rung(out) -> str:
    """The rung the JAX package's open writer took (it keeps no name)."""
    rungs = {"libav": out.libav, "native": out.native,
             "ffmpeg": out.process, "cv2": out.writer}
    return next(name for name, writer in rungs.items()
                if writer is not None)


@pytest.mark.parametrize("rung,vcodec,suffix,opened_by", [
    ("libav", "h264", ".mp4", "libav"),
    ("native", "mjpeg", ".avi", "native IO"),
    ("ffmpeg", "h264", ".mp4", "ffmpeg"),
    ("cv2", "mjpeg", ".avi", "cv2.VideoWriter (MJPG)"),
    # cv2's FFmpeg has no H.264 encoder here: the last resort, mp4v
    ("cv2", "h264", ".mp4", "cv2.VideoWriter (mp4v)"),
], ids=["libav", "native", "ffmpeg", "cv2", "cv2-mp4v"])
def test_encoder_rung_matches_jax(tmp_path, monkeypatch, rung, vcodec,
                                  suffix, opened_by):
    """Each rung of the writer chain, forced by taking the ones before it
    away, writes what the JAX writer writes on the same rung: the same
    decoded frames (the ffmpeg stand-in: the same bytes and arguments)."""
    _force(monkeypatch, tmp_path, rung)
    frames = write_clip(tmp_path / "src.avi", frames=5)
    written = {}
    for package, module in (("jax", jencoded), ("port", encoded)):
        path = str(tmp_path / f"{package}{suffix}")
        out = module.EncodedVideoOutput(path, W, H, FPS, vcodec=vcodec,
                                        replace=True).open()
        # both writers on the forced rung: the JAX writer falls through
        # its chain silently, so a rung it left would otherwise show only
        # as differing frames
        if package == "port":
            assert out.opened_by == opened_by
        else:
            assert _jax_rung(out) == rung
        for frame in frames:
            out.feed(frame)
        out.close()
        if rung == "ffmpeg":
            with open(path, "rb") as raw, open(path + ".argv") as argv:
                written[package] = (raw.read(),
                                    argv.read().replace(path, "OUT"))
        else:
            written[package] = read_video(path)
    if rung == "ffmpeg":
        assert written["port"] == written["jax"]
        assert written["port"][0] == np.stack(frames).tobytes()
    else:
        assert written["port"].shape == (5, H, W, 3)
        np.testing.assert_array_equal(written["port"], written["jax"])


class _RecordingLib:
    """The libav shim's library as a package loads it, recording what its
    writer passes: ``tfav_enc_open``'s arguments and the bytes of each
    frame given to ``tfav_enc_write``."""

    def __init__(self, lib, calls):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name == "tfav_enc_open":
            def record_open(path, *args):
                self._calls.append(("open", *args))
                return fn(path, *args)
            return record_open
        if name == "tfav_enc_write":
            def record_write(handle, ptr):
                self._calls.append(("write", ctypes.string_at(ptr, H * W * 3)))
                return fn(handle, ptr)
            return record_write
        return fn


def test_libav_writers_pass_the_same_calls(tmp_path, monkeypatch):
    """The libav rung of both packages hands libx264 the same options
    (codec, size, rate, GOP, B-frames, references, CRF, preset) and the
    same frame bytes: a difference between their encodes is then
    libx264's own, not the port's."""
    frames = write_clip(tmp_path / "src.avi", frames=5)
    calls = {}
    for package, module, loader in (("jax", jav, "_load"),
                                    ("port", av_native, "_require")):
        lib = getattr(module, loader)()
        calls[package] = []
        monkeypatch.setattr(module, loader, lambda lib=lib, c=calls[package]:
                            _RecordingLib(lib, c))
        encoding = jencoded if package == "jax" else encoded
        out = encoding.EncodedVideoOutput(
            str(tmp_path / f"{package}.mp4"), W, H, FPS, vcodec="h264",
            replace=True).open()
        for frame in frames:
            out.feed(frame)
        out.close()
    assert [c[0] for c in calls["port"]] == ["open"] + ["write"] * 5
    assert calls["port"] == calls["jax"]


def test_encoder_chain_refusal_when_nothing_opens(tmp_path, monkeypatch):
    """cv2 loads but opens no writer for the path: a ``RuntimeError`` with
    the reasons of every rung, as the JAX package raises one."""
    _force(monkeypatch, tmp_path, "cv2")
    path = str(tmp_path / "no-such-dir" / "out.avi")
    for module in (jencoded, encoded):
        with pytest.raises(RuntimeError, match="Could not open video writer"):
            module.EncodedVideoOutput(path, W, H, FPS, vcodec="mjpeg",
                                      replace=True).open()


# ---------------------------------------------------------------------------
# the native IO runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gray", [False, True], ids=["rgb", "gray"])
def test_native_reader_matches_jax(clip, gray):
    frames = {}
    for package, module in (("jax", jnative), ("port", native)):
        with module.NativeReader(clip, gray=gray) as reader:
            meta = (reader.width, reader.height, reader.fps,
                    reader.frame_count)
            frames[package] = (meta, list(reader))
    assert frames["port"][0] == frames["jax"][0] == (W, H, FPS, FRAMES)
    assert len(frames["port"][1]) == FRAMES
    for frame, jframe in zip(frames["port"][1], frames["jax"][1]):
        assert frame.shape == ((H, W) if gray else (H, W, 3))
        np.testing.assert_array_equal(frame, jframe)


def test_native_writer_round_trip_matches_jax(clip, tmp_path):
    rgb = write_clip(tmp_path / "src.avi", frames=6)
    files = {}
    for package, module in (("jax", jnative), ("port", native)):
        path = str(tmp_path / f"{package}.avi")
        with module.NativeWriter(path, W, H, FPS) as writer:
            for frame in rgb:
                writer.feed(frame)
        files[package] = read_video(path)
        with native.NativeReader(path) as reader:
            assert len(list(reader)) == 6
    np.testing.assert_array_equal(files["port"], files["jax"])
    with pytest.raises(FileNotFoundError):
        native.NativeReader(str(tmp_path / "missing.avi"))


def test_native_builds_where_the_library_is_missing(tmp_path, monkeypatch):
    """Without ``native/libtransflow_io.so`` the port builds
    ``native/transflow_io.cpp`` into its own build directory (never into
    ``native/``), and loads it; where the build fails, every entry raises
    naming the library."""
    built = str(tmp_path / "_build" / "libtransflow_io.so")
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "absent.so"))
    monkeypatch.setattr(native, "BUILD_PATH", built)
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setenv("CXX", "false")
    assert not native.is_available()
    assert "building" in native.load_error()
    with pytest.raises(RuntimeError, match="native IO library"):
        native.NativeWriter(str(tmp_path / "x.avi"), W, H, FPS)
    with pytest.raises(RuntimeError, match="native IO library"):
        native.display("w", np.zeros((H, W, 3), np.uint8))
    if shutil.which("g++") is None or subprocess.run(
            ["pkg-config", "--exists", "opencv4"]).returncode:
        pytest.fail("this machine has the native library's toolchain "
                    "(g++, OpenCV's pkg-config), which the build needs")
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.delenv("CXX")
    assert native.is_available(), native.load_error()
    assert os.path.isfile(built)
    out = str(tmp_path / "built.avi")
    with native.NativeWriter(out, W, H, FPS) as writer:
        writer.feed(np.zeros((H, W, 3), np.uint8))
    assert read_video(out).shape == (1, H, W, 3)


# ---------------------------------------------------------------------------
# the preview window
# ---------------------------------------------------------------------------

def _hud_frames(seed=5, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 3), np.uint8) for _ in range(n)]


@pytest.mark.parametrize("hud", [False, True], ids=["plain", "hud"])
def test_window_matches_jax(monkeypatch, hud):
    """``WindowOutput`` under a recorded cv2: the BGR frames shown, with
    the pixel HUD under the mouse, equal the JAX window's; both close
    their window."""
    monkeypatch.setenv("DISPLAY", ":0")
    shown = {}
    for package in ("jax", "port"):
        stub = HighGuiStub()
        if package == "jax":
            monkeypatch.setattr(jwindow, "cv2", stub)
            out = jwindow.WindowOutput(W, H, FPS, show_hud=hud)
        else:
            monkeypatch.setitem(sys.modules, "cv2", stub)
            out = window.WindowOutput(W, H, FPS, show_hud=hud)
        out.open()
        if hud:
            stub.mouse(cv2.EVENT_MOUSEMOVE, 7, 11, 0, None)
        for frame in _hud_frames():
            out.feed(frame)
        out.close()
        assert stub.windows == []
        shown[package] = stub.shown
    assert len(shown["port"]) == 3
    for (name, image), (jname, jimage), frame in zip(
            shown["port"], shown["jax"], _hud_frames()):
        assert name == jname == "transflow-tpu"
        np.testing.assert_array_equal(image, jimage)
        changed = (image != cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)).any()
        assert changed == hud


def test_window_refusals(monkeypatch):
    """No display: both windows refuse; no cv2: the port's names it."""
    monkeypatch.delenv("DISPLAY", raising=False)
    for module in (jwindow, window):
        with pytest.raises(RuntimeError, match="needs a display"):
            module.WindowOutput(W, H, FPS).open()
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        window.WindowOutput(W, H, FPS).open()


@pytest.mark.parametrize("extra", [[], ["-O"]], ids=["window", "preview"])
def test_pipeline_feeds_the_window(clip, tmp_path, monkeypatch, extra):
    """No ``-o`` (or ``-O`` beside one): the Pipeline opens the window on
    the main thread and shows each frame, per frame, as the JAX
    Pipeline does: the frames shown meet the CLI bars against the JAX
    window's, and with ``-O`` equal the port's written frames."""
    monkeypatch.setenv("DISPLAY", ":0")
    shown, pipelines = {}, {}
    for package in ("jax", "port"):
        argv = [clip, "-p", "noise", "--seed", str(SEED), "--no-exec",
                "--overwrite"]
        if extra:
            (tmp_path / package).mkdir()
            argv += ["-o", str(tmp_path / package / "%04d.ppm"), *extra]
        stub = HighGuiStub()
        if package == "jax":
            monkeypatch.setattr(jwindow, "cv2", stub)
            jcli.main(argv)
        else:
            monkeypatch.setitem(sys.modules, "cv2", stub)
            pipelines[package] = cli.main(argv, device="cpu")
        assert stub.windows == []
        shown[package] = np.stack([image for _, image in stub.shown])
    assert shown["port"].shape == shown["jax"].shape == (FRAMES - 1, H, W,
                                                          3)
    assert pipelines["port"]._batch_size == 1
    for got, want in zip(shown["port"], shown["jax"]):
        assert (got != want).any(axis=-1).mean() <= FRAME_SHARE
    if extra:
        written = np.stack([read_netpbm(str(tmp_path / "port" /
                                            f"{k:04d}.ppm"))
                            for k in range(FRAMES - 1)])
        np.testing.assert_array_equal(shown["port"][..., ::-1], written)


# ---------------------------------------------------------------------------
# the MJPEG output
# ---------------------------------------------------------------------------

def _first_part(port):
    """The bytes of the stream's first multipart part (boundary line,
    headers, JPEG, CRLF) from 127.0.0.1:``port``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("GET", "/transflow")
    response = conn.getresponse()
    content_type = response.getheader("Content-Type")
    try:
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            head += response.read(1)
        length = int(re.search(rb"Content-Length: (\d+)", head).group(1))
        return content_type, head + response.read(length + 2)
    finally:
        conn.close()


def _serve_one_part(out, port, frame):
    """The first part of ``out``'s stream, read while ``frame`` is fed."""
    import threading
    result = {}
    reader = threading.Thread(
        target=lambda: result.setdefault("part", _first_part(port)))
    reader.start()
    # the handler waits for a frame: feed until the part arrives
    while reader.is_alive():
        out.feed(frame)
        reader.join(0.05)
    return result["part"]


def test_mjpeg_matches_jax():
    """The first multipart part, the stream's type and the index page are
    byte-equal to the JAX output's for the same frame; ``close`` stops
    the server's thread."""
    import time
    frame = _hud_frames(seed=6, n=1)[0]
    got = {}
    for package, module in (("jax", jmjpeg), ("port", mjpeg)):
        port = _free_port()
        out = module.MjpegOutput(W, H, FPS, port=port,
                                 host="127.0.0.1").open()
        part = _serve_one_part(out, port, frame)
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=TIMEOUT)
        conn.request("GET", "/")
        index = conn.getresponse().read()
        conn.close()
        # the client has gone: a frame more ends the JAX handler's wait
        # (its close does not stop a waiting handler)
        time.sleep(0.1)
        out.feed(frame)
        out.close()
        assert not out._thread.is_alive()
        assert out.output_path is None
        got[package] = (part, index)
    assert got["port"] == got["jax"]
    content_type, part = got["port"][0]
    assert content_type == "multipart/x-mixed-replace;boundary=" \
                           "transflow-frame"
    jpeg = part.split(b"\r\n\r\n", 1)[1][:-2]
    decoded = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
    assert decoded.shape == (H, W, 3)
    assert jpeg == cv2.imencode(".jpg", cv2.cvtColor(frame,
                                                     cv2.COLOR_RGB2BGR),
                                [cv2.IMWRITE_JPEG_QUALITY, 50])[1].tobytes()


def test_mjpeg_close_with_a_client_waiting():
    """``close`` stops the server even while a client's handler waits for
    the next frame."""
    port = _free_port()
    out = mjpeg.MjpegOutput(W, H, FPS, port=port, host="127.0.0.1").open()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    conn.request("GET", "/transflow")
    response = conn.getresponse()
    assert response.status == 200
    out.close()
    conn.close()
    assert not out._thread.is_alive()


def test_mjpeg_refusals(monkeypatch):
    """A missing aiohttp or cv2 is named; a port in use fails the open."""
    for module in ("aiohttp", "cv2"):
        with monkeypatch.context() as patch:
            patch.setitem(sys.modules, module, None)
            with pytest.raises(ImportError, match=module):
                mjpeg.MjpegOutput(W, H, FPS, port=_free_port()).open()
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen()
        port = busy.getsockname()[1]
        with pytest.raises(RuntimeError, match="failed to start"):
            mjpeg.MjpegOutput(W, H, FPS, port=port, host="127.0.0.1").open()


# ---------------------------------------------------------------------------
# the realtime tool and the webcam probe
# ---------------------------------------------------------------------------

def test_realtime_headless_matches_extra(clip, tmp_path, monkeypatch):
    """File to file with ``-o``: the port's tool (the model on the CPU)
    against extra/realtime.py under the CPU JAX, on the same clip and
    seed: the same frame count, frames apart on <= 1 % of pixels (both
    MJPG-encoded by the native writer), and the same summary lines."""
    import transflow_tpu
    from transflow_tpu_torch.tools import realtime
    sys.path.insert(0, EXTRA)
    import realtime as jrealtime
    monkeypatch.setattr(transflow_tpu, "enable_compile_cache",
                        lambda *args: None)
    outputs, printed = {}, {}
    for package in ("jax", "port"):
        out = str(tmp_path / f"{package}.avi")
        argv = [clip, "-o", out, "--max-frames", "6", "--seed", "3"]
        buffer = io.StringIO()
        with contextlib.redirect_stdout(buffer):
            if package == "jax":
                monkeypatch.setattr(sys, "argv", ["realtime.py", *argv])
                jrealtime.main()
            else:
                assert realtime.main(argv, device="cpu") == 6
        outputs[package] = read_video(out)
        printed[package] = buffer.getvalue().splitlines()
    assert outputs["port"].shape == outputs["jax"].shape == (6, H, W, 3)
    for got, want in zip(outputs["port"], outputs["jax"]):
        assert (got != want).any(axis=-1).mean() <= FRAME_SHARE
    assert printed["port"][0] == printed["jax"][0] == \
        f"source: {W}x{H} @ {FPS:.1f} fps"
    assert printed["port"][1].startswith("6 frames in ")


def test_realtime_window_keys(clip, monkeypatch):
    """Window mode through ``native.display``: r resets, q quits."""
    from transflow_tpu_torch.tools import realtime
    keys = [ord("r"), -1, ord("q")]
    shown = []

    def display(name, rgb, wait_ms=1):
        shown.append(rgb.copy())
        return keys[len(shown) - 1]

    monkeypatch.setattr(native, "display", display)
    with contextlib.redirect_stdout(io.StringIO()):
        assert realtime.main([clip], device="cpu") == 3
    assert len(shown) == 3 and shown[0].shape == (H, W, 3)


def test_realtime_needs_the_native_library(clip, monkeypatch):
    from transflow_tpu_torch.tools import realtime
    monkeypatch.setattr(native, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="native IO library"):
        realtime.main([clip, "-o", "x.avi"], device="cpu")


class _FakeCapture:
    """A camera at index 1 only (640x480 at 30 frames/s)."""

    def __init__(self, index):
        self.index = index

    def isOpened(self):
        return self.index == 1

    def get(self, prop):
        return {cv2.CAP_PROP_FRAME_WIDTH: 640, cv2.CAP_PROP_FRAME_HEIGHT: 480,
                cv2.CAP_PROP_FPS: 30.0}[prop]

    def release(self):
        pass


@pytest.mark.parametrize("camera", [False, True], ids=["none", "one"])
def test_list_webcams_matches_extra(monkeypatch, camera):
    from transflow_tpu_torch.tools import list_webcams
    # extra/list_webcams.py calls cv2.setLogLevel at import, which OpenCV
    # 5 keeps in cv2.utils.logging only
    monkeypatch.setattr(cv2, "setLogLevel", lambda level: None,
                        raising=False)
    sys.path.insert(0, EXTRA)
    import list_webcams as jlist
    if camera:
        monkeypatch.setattr(cv2, "VideoCapture", _FakeCapture)
    else:
        monkeypatch.setattr(cv2, "VideoCapture",
                            lambda index: _FakeCapture(-1))
    results = {}
    for package, module in (("jax", jlist), ("port", list_webcams)):
        buffer = io.StringIO()
        with contextlib.redirect_stdout(buffer):
            found = module.main()
        results[package] = (found, buffer.getvalue())
    assert results["port"] == results["jax"]
    assert results["port"][0] == ([(1, 640, 480, 30.0)] if camera else [])
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        list_webcams.main()


def test_batch_render_resizes_a_pixmap_as_extra(tmp_path, monkeypatch):
    """The batch renderer's pixmap of another size than the frames is
    resized by ``cv2.resize`` as extra/batch_render.py resizes it; without
    cv2 that resize names it."""
    from transflow_tpu_torch.tools import batch_render
    sys.path.insert(0, EXTRA)
    import batch_render as jbatch
    path = str(tmp_path / "pixmap.png")
    imwrite(path, np.random.default_rng(7).integers(0, 256, (30, 50, 3),
                                                    np.uint8))
    got = batch_render.load_pixmap(path, H, W)
    assert got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, jbatch.load_pixmap(path, H, W))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        batch_render.load_pixmap(path, H, W)
    assert batch_render.load_pixmap(path, 30, 50).shape == (30, 50, 3)

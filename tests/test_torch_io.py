"""The port's host I/O against the JAX package and cv2: image reading and
writing (``utils/imageio.py`` against ``cv2.imread``,
``cv2.VideoCapture``, ``cv2.cvtColor`` and ``cv2.resize``), the generated
stills, the mask DSL, the source routers and the ``.flow.zip`` archives.
All of it is host logic, so the port must match exactly."""
import os
import sys

import cv2
import numpy as np
import PIL.Image
import pytest

from transflow_tpu.flow.sources import base as jbase
from transflow_tpu.output import archive as jarchive
from transflow_tpu.pixmap import base as jpixmap
from transflow_tpu.utils import masks as jmasks
from transflow_tpu.utils import misc as jmisc
from transflow_tpu_torch.flow.sources import base
from transflow_tpu_torch.flow.sources.archive import ArchiveFlowSource
from transflow_tpu_torch.output import archive
from transflow_tpu_torch.pixmap import base as pixmap
from transflow_tpu_torch.utils import imageio, masks, misc

# ---------------------------------------------------------------------------
# netpbm, gray, nearest resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 7), (33, 47), (48, 64, 3), (17, 31, 3),
                                   (1, 1, 3)], ids=str)
def test_netpbm_reader_matches_cv2(tmp_path, shape):
    """cv2 writes, the port reads; the port writes, cv2 reads."""
    rng = np.random.default_rng(len(shape) * 100 + shape[1])
    image = rng.integers(0, 256, shape, dtype=np.uint8)
    ext = ".pgm" if len(shape) == 2 else ".ppm"
    by_cv2 = str(tmp_path / f"cv2{ext}")
    cv2.imwrite(by_cv2, image if image.ndim == 2
                else cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
    got = imageio.read_netpbm(by_cv2)
    assert got.flags.writeable
    np.testing.assert_array_equal(got, image)
    by_port = str(tmp_path / f"port{ext}")
    imageio.write_netpbm(by_port, image)
    flag = cv2.IMREAD_GRAYSCALE if image.ndim == 2 else cv2.IMREAD_COLOR
    back = cv2.imread(by_port, flag)
    if image.ndim == 3:
        back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(back, image)


def test_netpbm_header_comments_and_refusals(tmp_path):
    path = tmp_path / "c.pgm"
    path.write_bytes(b"P5 # a comment\n3\n#another\n 2 255\n" + bytes(range(6)))
    np.testing.assert_array_equal(imageio.read_netpbm(str(path)),
                                  np.arange(6, dtype=np.uint8).reshape(2, 3))
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE),
                                  imageio.read_netpbm(str(path)))
    for data, match in [(b"P2\n1 1\n255\n0", "binary"),
                        (b"P5\n1 1\n65535\n\x00\x00", "maxval"),
                        (b"P6\n2 2\n255\n\x00", "truncated")]:
        path.write_bytes(data)
        with pytest.raises(ValueError, match=match):
            imageio.read_netpbm(str(path))


def test_gray_matches_cv2_on_random_rgb():
    rgb = np.random.default_rng(0).integers(0, 256, (250, 400, 3),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(imageio.rgb_to_gray(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    bgr = rgb[..., ::-1]
    np.testing.assert_array_equal(imageio.rgb_to_gray(rgb),
                                  cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("sizes", [
    ((48, 64), (96, 128)), ((48, 64), (100, 130)), ((37, 53), (111, 159)),
    ((1080, 1920), (720, 1280)), ((7, 9), (13, 29)), ((30, 40), (59, 83)),
    ((101, 99), (300, 301)), ((5, 5), (3, 3)), ((64, 48), (63, 47)),
    ((27, 81), (1080, 1920))], ids=str)
def test_nearest_resize_matches_cv2(sizes):
    (h, w), (oh, ow) = sizes
    image = np.random.default_rng(h * w).integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8)
    np.testing.assert_array_equal(
        imageio.resize_nearest(image, ow, oh),
        cv2.resize(image, (ow, oh), interpolation=cv2.INTER_NEAREST))


# ---------------------------------------------------------------------------
# sequences
# ---------------------------------------------------------------------------


def _write_sequence(directory, first, frames, ext):
    os.makedirs(directory, exist_ok=True)
    for i, frame in enumerate(frames):
        cv2.imwrite(os.path.join(directory, f"{first + i:04d}{ext}"),
                    frame if frame.ndim == 2
                    else cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    return os.path.join(directory, f"%04d{ext}")


@pytest.mark.parametrize("ext,channels", [(".pgm", 1), (".ppm", 3)])
@pytest.mark.parametrize("first", [0, 1, 4])
def test_sequence_matches_video_capture(tmp_path, first, ext, channels):
    """Frame count, frame rate, size, gray and RGB frames of a sequence
    against ``cv2.VideoCapture`` + ``cvtColor``, the JAX source's decode."""
    rng = np.random.default_rng(first)
    shape = (23, 35) if channels == 1 else (23, 35, 3)
    frames = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(5)]
    pattern = _write_sequence(str(tmp_path), first, frames, ext)
    seq = imageio.open_sequence(pattern)
    cap = cv2.VideoCapture(pattern)
    assert cap.isOpened()
    assert seq.count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
    assert seq.framerate == cap.get(cv2.CAP_PROP_FPS)
    assert (seq.width, seq.height) == (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
                                       int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    for k in range(5):
        ok, bgr = cap.read()
        assert ok
        np.testing.assert_array_equal(seq.read(gray=True),
                                      cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))
        seq.pos -= 1
        np.testing.assert_array_equal(seq.read(),
                                      cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    assert not cap.read()[0] and seq.read() is None
    cap.release()


def test_sequence_refusals(tmp_path, monkeypatch):
    """A sequence must start at an index among 0-4, as cv2's; a video that
    does not open raises as cv2's refusal; with cv2 missing, a video
    container, a camera or a stream names it (and opens nothing)."""
    frame = np.zeros((4, 4), np.uint8)
    pattern = _write_sequence(str(tmp_path), 5, [frame, frame], ".pgm")
    assert not cv2.VideoCapture(pattern).isOpened()
    with pytest.raises(FileNotFoundError):
        imageio.open_sequence(pattern)
    missing = str(tmp_path / "clip.mp4")
    assert not cv2.VideoCapture(missing).isOpened()
    with pytest.raises(FileNotFoundError, match="Could not open"):
        imageio.open_sequence(missing)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for path in [missing, "0", "rtsp://camera/stream"]:
        with pytest.raises(ImportError, match="cv2"):
            imageio.open_sequence(path)


def test_single_image_is_a_one_frame_video(tmp_path):
    """A single image is a video of one frame and no reported length, as
    ``cv2.VideoCapture`` opens it."""
    path = str(tmp_path / "pix.ppm")
    image = np.random.default_rng(3).integers(0, 256, (9, 11, 3), np.uint8)
    imageio.write_netpbm(path, image)
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) <= 0
    seq = imageio.open_sequence(path)
    assert seq.count is None
    np.testing.assert_array_equal(seq.read(), image)
    assert seq.read() is None


# ---------------------------------------------------------------------------
# stills, pixmap and flow routing
# ---------------------------------------------------------------------------

STILLS = ["color", "color:#204060", "color:rgb(1, 2, 3)", "0a0b0c", "noise",
          "bwnoise", "cnoise", "gradient"]


@pytest.mark.parametrize("size", [(64, 48), (37, 23)], ids=str)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", STILLS)
def test_generated_stills_bit_equal(kind, seed, size):
    got = pixmap.PixmapSource.from_args(kind, size, seed=seed).open()
    want = jpixmap.PixmapSource.from_args(kind, size, seed=seed).open()
    assert type(got).__name__ == type(want).__name__
    assert got.is_constant and want.is_constant
    np.testing.assert_array_equal(next(got), next(want))


def test_image_pixmap_and_alteration_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    image = str(tmp_path / "pix.png")
    PIL.Image.fromarray(rng.integers(0, 256, (20, 30, 4), np.uint8)).save(image)
    overlay = rng.integers(0, 256, (10, 12, 4), np.uint8)
    overlay[..., 3] = (overlay[..., 3] > 128) * 255
    alteration = str(tmp_path / "alter.png")
    PIL.Image.fromarray(overlay).save(alteration)
    for path, alter in [(image, None), (image, alteration),
                        ("noise", alteration)]:
        got = pixmap.PixmapSource.from_args(
            path, (30, 20), seed=2, alteration_path=alter).open()
        want = jpixmap.PixmapSource.from_args(
            path, (30, 20), seed=2, alteration_path=alter).open()
        np.testing.assert_array_equal(next(got), next(want))


def test_video_pixmap_matches_jax(tmp_path):
    """A pixmap sequence: frames, length, frame rate, seek and repeat."""
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (12, 16, 3), np.uint8) for _ in range(4)]
    pattern = _write_sequence(str(tmp_path), 1, frames, ".ppm")
    for kwargs in [{}, {"repeat": 2}, {"seek": 1}]:
        got = pixmap.PixmapSource.from_args(pattern, (16, 12), **kwargs)
        want = jpixmap.PixmapSource.from_args(pattern, (16, 12), **kwargs)
        assert type(got).__name__ == type(want).__name__ == \
            "VideoPixmapSource"
        got.open()
        want.open()
        assert (got.length, got.framerate, got.width, got.height) == \
            (want.length, want.framerate, want.width, want.height)
        for _ in range(want.length - (kwargs.get("seek") or 0)):
            np.testing.assert_array_equal(next(got), next(want))
        got.close()
        want.close()


def test_pixmap_routing_matches_jax(tmp_path):
    png = str(tmp_path / "image.png")
    PIL.Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(png)
    ppm = str(tmp_path / "single.ppm")
    imageio.write_netpbm(ppm, np.zeros((4, 4, 3), np.uint8))
    for path in STILLS + ["first", "COLOR", png, ppm,
                          str(tmp_path / "missing.png"), "clip.mp4",
                          str(tmp_path / "%04d.ppm")]:
        kwargs = dict(seed=0, flow_path="flow.mp4")
        got = pixmap.PixmapSource.from_args(path, (4, 4), **kwargs)
        want = jpixmap.PixmapSource.from_args(path, (4, 4), **kwargs)
        assert type(got).__name__ == type(want).__name__, path


def test_first_pixmap_reads_the_flow_sequence(tmp_path):
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (12, 16, 3), np.uint8) for _ in range(3)]
    pattern = _write_sequence(str(tmp_path), 0, frames, ".ppm")
    got = pixmap.PixmapSource.from_args("first", (16, 12),
                                        flow_path=pattern).open()
    want = jpixmap.PixmapSource.from_args("first", (16, 12),
                                          flow_path=pattern).open()
    np.testing.assert_array_equal(next(got), next(want))


@pytest.mark.parametrize("path,cv_config", [
    ("flow.flow.zip", None), ("frames/%04d.pgm", None),
    ("frames/%04d.pgm", '{"method": "liteflownet", "lfn_warp_bound": 16}'),
    ("frames/%04d.pgm", {"method": "farneback", "fb_levels": 2}),
    ("clip.mp4", None), ("0", None), ("avi::clip.avi", None)], ids=str)
def test_flow_routing_matches_jax(path, cv_config):
    got = base.FlowSource.from_args(path, cv_config=cv_config,
                                    direction="backward")
    want = jbase.FlowSource.from_args(path, cv_config=cv_config,
                                      direction="backward")
    assert type(got).__name__ == type(want).__name__
    assert got.direction.value == want.direction.value
    if hasattr(want, "config"):
        assert got.config.to_dict() == want.config.to_dict()
        assert got.file == want.file


def test_flow_routing_refusals(tmp_path):
    with pytest.raises(FileNotFoundError):   # --mv: the shim opens nothing
        base.FlowSource.from_args(str(tmp_path / "clip.mp4"),
                                  use_mvs=True).open()
    with pytest.raises(FileNotFoundError):
        base.FlowSource.from_args("clip.mp4", cv_config="nope.json")
    # the tuning window opens with the source, as in the JAX package
    for module in (base, jbase):
        source = module.FlowSource.from_args("clip.mp4", cv_config="window")
        assert source.config.show_window and source.config.window is None
    for module in (base, jbase):
        with pytest.raises(FileNotFoundError, match="Could not open"):
            module.FlowSource.from_args(str(tmp_path / "clip.mp4")).open()


# ---------------------------------------------------------------------------
# masks and paths
# ---------------------------------------------------------------------------

MASK_RULES = ["zeros", "ones", "border:5", "border:10%:5", "border:1:2:3:4",
              "border-top:3", "border-right:10%", "border-bottom:2",
              "border-left:4", "hline:5", "vline:20%", "circle:10",
              "circle:25%", "rect:10:8", "rect:20%", "grid:2:3:4",
              "border:5:inv", "ones:inv", "random", "IMAGE_GRAY",
              "IMAGE_RGB", "IMAGE_PGM"]


@pytest.mark.parametrize("shape", [(48, 64), (37, 23)], ids=str)
@pytest.mark.parametrize("rule", MASK_RULES)
def test_mask_dsl_matches_jax(tmp_path, rule, shape):
    rng = np.random.default_rng(8)
    if rule == "IMAGE_GRAY":
        rule = str(tmp_path / "m.png")
        PIL.Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(rule)
    elif rule == "IMAGE_RGB":
        rule = str(tmp_path / "m.png")
        PIL.Image.fromarray(rng.integers(0, 256, (*shape, 3),
                                         np.uint8)).save(rule)
    elif rule == "IMAGE_PGM":
        rule = str(tmp_path / "m.pgm")
        imageio.write_netpbm(rule, rng.integers(0, 256, shape, np.uint8))
    for kind in ("load_float_mask", "load_bool_mask"):
        results = []
        for module in (masks, jmasks):
            np.random.seed(0)  # the 'random' rule draws from numpy's global
            try:
                results.append(getattr(module, kind)(rule, shape))
            except ValueError as err:  # a grid too large for the frame
                results.append(type(err))
        got, want = results
        if isinstance(want, type):
            assert got is want
            continue
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert np.array_equal(masks.load_bool_mask(None, shape, True),
                          jmasks.load_bool_mask(None, shape, True))


def test_paths_match_jax(tmp_path):
    from transflow_tpu.config import Config as JConfig
    from transflow_tpu_torch.config import Config
    for name in ["out.flow.zip", "out.mp4", "out.001.mp4", "a.map.png"]:
        path = str(tmp_path / name)
        assert misc.find_unique_path(path) == jmisc.find_unique_path(path)
        open(path, "w").close()
        assert misc.find_unique_path(path) == jmisc.find_unique_path(path)
    for output in [None, "out/%04d.ppm", ["mjpeg:8080", "x.005.mp4"],
                   ["mjpeg"]]:
        for suffix in [".flow.zip", "_00012.ckpt.zip", ".config.json"]:
            got = Config("in.ckpt.zip", output_path=output, seed=0)
            want = JConfig("in.ckpt.zip", output_path=output, seed=0)
            assert (got.get_secondary_output_path(suffix)
                    == want.get_secondary_output_path(suffix))


# ---------------------------------------------------------------------------
# archives
# ---------------------------------------------------------------------------


def _write_archive(module, path, flows, rounded):
    meta = {"direction": 1, "width": flows.shape[2],
            "height": flows.shape[1], "framerate": 25.0}
    out = module.NumpyArchiveOutput(path, meta, replace=True)
    for flow in flows:
        out.write_array(np.round(flow).astype(int) if rounded else flow)
    out.close()


@pytest.mark.parametrize("rounded", [False, True], ids=["float", "rounded"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flow_archives_cross_read(tmp_path, writer, rounded):
    """A .flow.zip of either package reads in the other: equal arrays and
    meta, on the stored (mmap) and deflated (pool) paths."""
    rng = np.random.default_rng(9)
    flows = (rng.standard_normal((5, 12, 16, 2)) * 3).astype(np.float32)
    flows[2] = 0  # an all-zero flow deflates
    path = str(tmp_path / "f.flow.zip")
    _write_archive(jarchive if writer == "jax" else archive, path, flows,
                   rounded)
    sources = [ArchiveFlowSource(path), jbase.FlowSource.from_args(path)]
    arrays = []
    for source in sources:
        source.open()
        assert (source.width, source.height, source.framerate,
                source.direction.value, source.length) == (16, 12, 25.0, 1, 5)
        arrays.append(np.stack([np.array(item.array) for item in source]))
        source.close()
    want = np.round(flows) if rounded else flows
    np.testing.assert_array_equal(arrays[0], want)
    np.testing.assert_array_equal(arrays[1], want)

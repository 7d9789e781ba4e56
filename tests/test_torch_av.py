"""The port's libav binding (``av_native``), its ``--mv`` source and its
``-o x.mp4`` writer against the JAX package's, over the committed H.264
fixture (tests/fixtures/mv: a libx264 stream, bf=0 and refs=1, of a known
translation, and its decoder's side data).

The shim-dependent tests skip only where the prebuilt
``native/libtransflow_av.so`` does not load (no FFmpeg shared libraries),
as tests/test_mv_native.py does; the mocked-record cases run anywhere."""
import json
import os
import sys

import numpy as np
import pytest

from test_mv import FakeFrame, FakeMV, make_source
from transflow_tpu import av_native as jav
from transflow_tpu import cli as jcli
from transflow_tpu.flow.sources import base as jbase
from transflow_tpu.flow.sources.mv import \
    MotionVectorFlowSource as JaxMotionVectorFlowSource
from transflow_tpu_torch import av_native, cli
from transflow_tpu_torch.flow.sources import base
from transflow_tpu_torch.flow.sources.base import FlowItem
from transflow_tpu_torch.flow.sources.mv import MotionVectorFlowSource
from transflow_tpu_torch.output.encoded import EncodedVideoOutput
from transflow_tpu_torch.utils.imageio import read_netpbm

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "mv")
CLIP = os.path.join(FIXTURES, "clip.mp4")
FIELDS = ["source", "w", "h", "src_x", "src_y", "dst_x", "dst_y",
          "motion_x", "motion_y", "motion_scale"]


@pytest.fixture
def shim():
    if not av_native.is_available():
        pytest.skip(f"native libav shim unavailable: "
                    f"{av_native.load_error()}")


@pytest.fixture(scope="module")
def dump():
    with open(os.path.join(FIXTURES, "expected_side_data.json")) as file:
        return json.load(file)


def _records(reader):
    """Every frame's records as a plain array of the named fields (the
    struct's padding bytes hold whatever the decoder left there)."""
    names = list(av_native.MV_DTYPE.names)
    out = []
    while (mvs := reader.next()) is not None:
        out.append(np.asarray(mvs)[names].copy())
    return out


def test_binding_matches_jax():
    assert av_native.MV_DTYPE == jav.MV_DTYPE
    assert av_native.ENCODERS == jav.ENCODERS
    assert os.path.samefile(os.path.dirname(av_native.LIB_PATH),
                            os.path.dirname(jav._LIB_PATH))


def test_mv_reader_matches_dump_and_jax(shim, dump):
    with av_native.MvReader(CLIP) as reader, jav.MvReader(CLIP) as jreader:
        meta = dump["meta"]
        assert (reader.width, reader.height) == (meta["width"],
                                                 meta["height"])
        assert reader.fps == pytest.approx(meta["fps"])
        assert reader.frame_count == meta["frame_count"]
        assert (reader.width, reader.height, reader.fps,
                reader.frame_count) == (jreader.width, jreader.height,
                                        jreader.fps, jreader.frame_count)
        got, want = _records(reader), _records(jreader)
        assert len(got) == len(want) == len(dump["frames"])
        for index, (g, w, d) in enumerate(zip(got, want, dump["frames"])):
            np.testing.assert_array_equal(g, w, err_msg=str(index))
            assert [{f: int(mv[f]) for f in FIELDS} for mv in g] == d, index
        reader.rewind()
        again = _records(reader)
    assert len(again) == len(got)
    for a, g in zip(again, got):
        np.testing.assert_array_equal(a, g)


def test_mv_source_matches_jax_on_every_frame(shim, dump):
    """The dense fields of the real stream, frame by frame, bit-equal to
    the JAX source's; the dominant value is the clip's translation; and a
    rewind replays the same fields."""
    source = MotionVectorFlowSource(CLIP).open()
    jsource = JaxMotionVectorFlowSource(CLIP).open()
    try:
        assert (source.width, source.height, source.framerate,
                source.base_length, source.length) == (
            jsource.width, jsource.height, jsource.framerate,
            jsource.base_length, jsource.length)
        fields = []
        for index, (item, jitem) in enumerate(zip(source, jsource)):
            assert item.kind == jitem.kind == FlowItem.FLOW
            assert item.array.dtype == np.float32
            np.testing.assert_array_equal(item.array, jitem.array,
                                          err_msg=f"frame {index}")
            values, counts = np.unique(item.array.reshape(-1, 2), axis=0,
                                       return_counts=True)
            assert values[np.argmax(counts)].tolist() == \
                dump["meta"]["true_flow"], index
            fields.append(item.array)
        assert len(fields) == dump["meta"]["frame_count"] - 1
        source.rewind(3)
        np.testing.assert_array_equal(source._read_item().array, fields[3])
    finally:
        source.close()
        jsource.close()


class FakeReader:
    """Stands for ``MvReader``: one record array per ``next()``."""

    def __init__(self, frames):
        self.frames = iter(frames)

    def next(self):
        return next(self.frames, None)


def _as_records(vectors):
    """tests/test_mv.py's fake vectors as the shim's records."""
    records = np.zeros(len(vectors or ()), av_native.MV_DTYPE)
    for record, mv in zip(records, vectors or ()):
        for name in ("source", "w", "h", "src_x", "src_y", "motion_x",
                     "motion_y", "motion_scale"):
            record[name] = getattr(mv, name)
    return records.view(np.recarray)


def _mocked(vectors, height=32, width=48):
    """One frame's field from the port's source and the JAX source's
    (tests/test_mv.py's mocked PyAV side data) on the same records."""
    src = MotionVectorFlowSource("fake.mp4")
    src.height, src.width = height, width
    src.reader = FakeReader([_as_records(vectors)])
    jsrc = make_source(height, width, [FakeFrame(vectors)])
    return src._read_item().array, jsrc._read_item().array


def _random_vectors(n, seed=5):
    """``n`` overlapping blocks of every partition size at random places
    (some reaching over the frame's edges), motions and scales."""
    rng = np.random.default_rng(seed)
    return [FakeMV(int(rng.integers(0, 48)), int(rng.integers(0, 32)),
                   int(rng.choice([4, 8, 16])), int(rng.choice([4, 8, 16])),
                   int(rng.integers(-64, 65)), int(rng.integers(-64, 65)),
                   int(rng.choice([1, 2, 4, 8]))) for _ in range(n)]


@pytest.mark.parametrize("vectors", [
    [FakeMV(16, 8, 16, 16, 8, -4)],                       # sign and scale
    [FakeMV(8, 8, 16, 16, 4, 0, motion_scale=1),          # overlap: the
     FakeMV(12, 8, 16, 16, 0, 8, motion_scale=1)],        # last wins
    [FakeMV(4, 4, 8, 8, 3, 5, motion_scale=2),
     FakeMV(44, 28, 8, 8, -7, 1, motion_scale=4)],        # at the edges
    None,                                                 # no side data
    [],
    _random_vectors(300),
], ids=["sign_scale", "overlap", "edges", "no_side_data", "empty",
        "random"])
def test_rasterization_matches_jax(vectors):
    got, want = _mocked(vectors)
    assert got.shape == (32, 48, 2) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if vectors and len(vectors) > 2:
        assert np.count_nonzero(got) > 0
    if vectors and len(vectors) == 1:
        assert np.all(got[0:16, 8:24] == (-2.0, 1.0))
    if vectors and len(vectors) == 2 and vectors[0].motion_scale == 1:
        assert np.all(got[4, 10] == (0.0, -8.0))
        assert np.all(got[4, 2] == (-4.0, 0.0))
    if not vectors:
        assert np.count_nonzero(got) == 0


def test_bidirectional_source_rejected():
    with pytest.raises(AssertionError, match="bf=0 and refs=1"):
        _mocked([FakeMV(8, 8, 16, 16, 4, 4, source=1)])


def test_missing_backend_raises(monkeypatch):
    monkeypatch.setattr(av_native, "_load", lambda: None)
    with pytest.raises(ImportError, match="PyAV or the native libav shim"):
        MotionVectorFlowSource(CLIP).open()


def test_missing_file_raises(shim, tmp_path):
    with pytest.raises(FileNotFoundError):
        MotionVectorFlowSource(str(tmp_path / "missing.mp4")).open()


@pytest.mark.parametrize("path", ["clip.mp4", "mp4::clip.mp4"])
def test_mv_routing_matches_jax(path):
    got = base.FlowSource.from_args(path, use_mvs=True)
    want = jbase.FlowSource.from_args(path, use_mvs=True)
    assert type(got).__name__ == type(want).__name__
    assert (got.file, got.avformat) == (want.file, want.avformat)


def test_h264_writer_reopens_in_both_readers(shim, tmp_path):
    """The port's writer at its defaults (bf 0, refs 1): the file reopens
    in both packages' readers, every vector forward-only, with the same
    records."""
    rng = np.random.default_rng(11)
    path = str(tmp_path / "contract.mp4")
    canvas = rng.integers(0, 256, (80, 112, 3), np.uint8)
    with av_native.H264Writer(path, 96, 64, 30.0) as writer:
        for t in range(8):
            writer.feed(canvas[t:t + 64, 2 * t:2 * t + 96])
        with pytest.raises(ValueError):
            writer.feed(canvas)
    with av_native.MvReader(path) as reader, jav.MvReader(path) as jreader:
        assert (reader.width, reader.height, reader.frame_count) == \
            (jreader.width, jreader.height, jreader.frame_count) == \
            (96, 64, 8)
        got, want = _records(reader), _records(jreader)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert sum(len(g) for g in got) > 0
    assert set(np.concatenate(got)["source"].tolist()) == {-1}


def test_encoded_output_picks_the_libav_writer(shim, tmp_path, monkeypatch):
    import shutil
    monkeypatch.setattr(shutil, "which", lambda name: "/no/ffmpeg")
    out = EncodedVideoOutput(str(tmp_path / "out.mp4"), 32, 16, 25.0,
                             replace=True).open()
    assert out.libav is not None and out.process is None
    for k in range(3):
        out.feed(np.full((16, 32, 3), 40 * k, np.uint8))
    out.close()
    with av_native.MvReader(str(tmp_path / "out.mp4")) as reader:
        assert (reader.width, reader.height) == (32, 16)
        assert len(_records(reader)) == 3


def test_encoded_output_without_any_encoder_raises(tmp_path, monkeypatch):
    """No libav shim, no native IO library, no ffmpeg binary and no cv2:
    the last rung's import names cv2, and the message says why each rung
    before it did not open."""
    import shutil
    from transflow_tpu_torch import native
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(av_native, "_load", lambda: None)
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    out = EncodedVideoOutput(str(tmp_path / "out.mp4"), 32, 16, 25.0)
    with pytest.raises(ImportError, match="cv2") as info:
        out.open()
    assert "libav:" in str(info.value) and "ffmpeg: no binary" in str(
        info.value)


def _cli_frames(run, argv, out_dir):
    out_dir.mkdir()
    run([*argv, "-o", str(out_dir / "%04d.ppm"), "--no-exec",
         "--overwrite"])
    names = sorted(p.name for p in out_dir.glob("*.ppm"))
    return np.stack([read_netpbm(str(out_dir / n)) for n in names])


def test_cli_mv_matches_jax(shim, tmp_path):
    """``--mv`` through the port's CLI on the CPU renders the JAX CLI's
    frames bit for bit."""
    argv = [CLIP, "--mv", "-p", "noise", "--seed", "0"]
    got = _cli_frames(lambda a: cli.main(a, device="cpu"), argv,
                      tmp_path / "port")
    want = _cli_frames(jcli.main, argv, tmp_path / "jax")
    assert got.shape == (9, 96, 128, 3)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[-1])


def test_cli_mv_to_mp4(shim, tmp_path):
    """``-o x.mp4``: the CLI writes real H.264 through the shim, one frame
    a flow, at the clip's size."""
    out = tmp_path / "out.mp4"
    cli.main([CLIP, "--mv", "-p", "noise", "--seed", "0", "-o", str(out),
              "--no-exec", "--overwrite"], device="cpu")
    with av_native.MvReader(str(out)) as reader:
        assert (reader.width, reader.height, reader.frame_count) == \
            (128, 96, 9)
        assert len(_records(reader)) == 9
    with open(out, "rb") as file:
        assert file.read(12)[4:8] == b"ftyp"

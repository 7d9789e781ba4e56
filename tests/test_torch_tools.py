"""The port's tools (``transflow_tpu_torch/tools``: viewflow, the player's
helpers, ``FlowClip`` and its window, the control session and its
window) against their ``extra/`` originals on the same inputs; the
windows under a cv2 whose HighGUI calls are recorded (``HighGuiStub``)."""
import contextlib
import io
import json
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

from transflow_tpu.flow import Direction as JaxDirection
from transflow_tpu.output.archive import NumpyArchiveOutput as JaxArchive
from transflow_tpu_torch import cli
from transflow_tpu_torch.output.archive import NumpyArchiveOutput
from transflow_tpu_torch.tools import control, viewflow, viewflow_player
from transflow_tpu_torch.utils.imageio import (imread, read_netpbm,
                                               write_netpbm)

EXTRA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "extra")
sys.path.insert(0, EXTRA)
import control as jcontrol  # noqa: E402
import viewflow as jviewflow  # noqa: E402
import viewflow_player as jplayer  # noqa: E402

H, W, FLOWS = 24, 40, 3
# tests/test_torch_farneback.py's bar for the whole estimator in float32
FB_PSNR = 60.0


class HighGuiStub:
    """cv2 with its window calls recorded instead of shown: ``imshow``
    keeps a copy of each image, ``waitKey`` returns the queued keys, then
    q; every other name is cv2's own."""

    def __init__(self, keys=()):
        import cv2
        self._cv2 = cv2
        self.keys = list(keys)
        self.shown = []
        self.windows = []
        self.mouse = None

    def __getattr__(self, name):
        return getattr(self._cv2, name)

    def namedWindow(self, name, flags=0):
        self.windows.append(name)

    def setMouseCallback(self, name, callback):
        self.mouse = callback

    def imshow(self, name, image):
        self.shown.append((name, np.array(image)))

    def waitKey(self, delay=0):
        return self.keys.pop(0) if self.keys else ord("q")

    def destroyWindow(self, name):
        self.windows.remove(name)


def _flows(seed=2, n=FLOWS, h=H, w=W):
    rng = np.random.default_rng(seed)
    flows = [(2.0 * rng.standard_normal((h, w, 2))).astype(np.float32)
             for _ in range(n)]
    flows[0][: h // 2] = 0.0      # a still half: magnitudes of 0
    return flows


# ---------------------------------------------------------------------------
# the player's helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 5])
def test_helpers_match_extra(seed):
    rng = np.random.default_rng(seed)
    flow = (4.0 * rng.standard_normal((48, 72, 2))).astype(np.float32)
    flow[:20, :30] = (6.0, -3.0)
    frame = rng.integers(0, 256, (48, 72, 3), dtype=np.uint8)
    np.testing.assert_array_equal(viewflow_player.magnitude_image(flow),
                                  jplayer.magnitude_image(flow))
    for step in (8, 24):
        assert viewflow_player.arrow_segments(flow, step) == \
            jplayer.arrow_segments(flow, step)
    np.testing.assert_array_equal(viewflow_player.reconstruct(frame, flow),
                                  jplayer.reconstruct(frame, flow))
    for cursor in (None, (3, 7), (500, 2)):
        assert viewflow_player.hud_lines(4, 9, 25.0, flow, "source",
                                         cursor) == \
            jplayer.hud_lines(4, 9, 25.0, flow, "source", cursor)


# ---------------------------------------------------------------------------
# viewflow
# ---------------------------------------------------------------------------

def _archive(path, flows, package):
    meta = {"direction": JaxDirection.BACKWARD.value, "width": W,
            "height": H, "framerate": 10.0}
    out = (JaxArchive if package == "jax" else NumpyArchiveOutput)(
        str(path), meta, replace=True)
    for flow in flows:
        out.write_array(flow)
    out.close()
    return str(path)


def _stdout(fn) -> str:
    buffer = io.StringIO()
    with contextlib.redirect_stdout(buffer):
        fn()
    return buffer.getvalue()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_stats_match_extra(tmp_path, monkeypatch, package):
    """``--stats`` over a ``.flow.zip`` written by each package: the same
    text as extra/viewflow.py's."""
    path = _archive(tmp_path / "clip.flow.zip", _flows(), package)
    got = _stdout(lambda: viewflow.main([path, "--stats"]))
    monkeypatch.setattr(sys, "argv", ["viewflow.py", path, "--stats"])
    want = _stdout(jviewflow.main)
    assert got == want
    assert len(got.splitlines()) == FLOWS + 1


def test_stats_of_an_estimator_source(tmp_path, monkeypatch):
    """An image sequence yields frames: both tools stop at the note."""
    (tmp_path / "seq").mkdir()
    for i in range(3):
        write_netpbm(str(tmp_path / "seq" / f"{i:04d}.pgm"),
                     np.full((H, W), 10 * i, np.uint8))
    path = str(tmp_path / "seq" / "%04d.pgm")
    got = _stdout(lambda: viewflow.main([path, "--stats"]))
    monkeypatch.setattr(sys, "argv", ["viewflow.py", path, "--stats"])
    assert got == _stdout(jviewflow.main)
    assert "estimator source" in got


@pytest.mark.parametrize("extra", [[], ["--magnitude"],
                                   ["--binary", "--scale", "0.3"]],
                         ids=["direction", "magnitude", "binary"])
def test_render_matches_extra(tmp_path, monkeypatch, extra):
    """The render mode over an archive: the port's CLI with ``--view-flow``
    (or ``--view-flow-magnitude``) on the CPU writes the frames
    extra/viewflow.py writes through the JAX CLI."""
    path = _archive(tmp_path / "clip.flow.zip", _flows(), "port")
    frames = {}
    for package in ("jax", "port"):
        out = tmp_path / package
        out.mkdir()
        argv = [path, "-o", str(out / "%04d.ppm"), *extra]
        if package == "jax":
            monkeypatch.setattr(sys, "argv", ["viewflow.py", *argv])
            jviewflow.main()
        else:
            viewflow.main(argv, device="cpu")
        frames[package] = np.stack([read_netpbm(str(out / f"{i:04d}.ppm"))
                                    for i in range(FLOWS)])
        assert not (out / f"{FLOWS:04d}.ppm").exists()
    np.testing.assert_array_equal(frames["port"], frames["jax"])
    assert frames["port"].shape == (FLOWS, H, W, 3)


def test_play_raises(monkeypatch):
    """Without cv2 the player's window names it, before reading the
    clip."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        viewflow.main(["clip.flow.zip", "--play"])
    with pytest.raises(ImportError, match="cv2"):
        viewflow_player.run_player("clip.flow.zip")


# every view, overlay and zoom of the player, then q
PLAYER_KEYS = [ord(k) for k in "d1f2m3+=-a d"]


def test_player_window_matches_extra(tmp_path, monkeypatch):
    """``run_player`` (through ``viewflow --play``) shows the images the
    JAX tool's player shows for the same keys over the same archive, and
    closes its window."""
    path = _archive(tmp_path / "clip.flow.zip", _flows(), "jax")
    shown = {}
    for package in ("jax", "port"):
        stub = HighGuiStub(PLAYER_KEYS)
        monkeypatch.setitem(sys.modules, "cv2", stub)
        if package == "jax":
            jplayer.run_player(path)
        else:
            viewflow.main([path, "--play"], device="cpu")
        assert stub.windows == [] and stub.mouse is not None
        shown[package] = stub.shown
    assert len(shown["port"]) == len(PLAYER_KEYS) + 1
    for (name, image), (jname, jimage) in zip(shown["port"], shown["jax"]):
        assert name == jname == "viewflow"
        np.testing.assert_array_equal(image, jimage)


# ---------------------------------------------------------------------------
# FlowClip
# ---------------------------------------------------------------------------

def test_flowclip_archive_matches_extra(tmp_path):
    flows = _flows()
    path = _archive(tmp_path / "clip.flow.zip", flows, "jax")
    clip = viewflow_player.FlowClip(path)
    want = jplayer.FlowClip(path)
    assert len(clip) == len(want) == FLOWS
    assert clip.framerate == want.framerate
    assert (clip.height, clip.width) == (want.height, want.width) == (H, W)
    for i in range(FLOWS):
        np.testing.assert_array_equal(clip.flow(i), flows[i])
        np.testing.assert_array_equal(clip.flow(i), want.flow(i))
        np.testing.assert_array_equal(clip.frame(i), want.frame(i))


def _flow_psnr(flow, ref):
    """tests/test_flow_ops.py::_flow_psnr: PSNR at an 8 px peak."""
    mse = float(np.mean((np.asarray(flow) - np.asarray(ref)) ** 2))
    return 10 * np.log10(8.0 ** 2 / mse) if mse else np.inf


@pytest.fixture(scope="module")
def pgm_clip(tmp_path_factory):
    """Four 48x64 PGM frames of a smooth texture panned 2 px a frame."""
    from scipy import ndimage
    root = tmp_path_factory.mktemp("clip")
    rng = np.random.default_rng(3)
    canvas = ndimage.gaussian_filter(rng.uniform(0, 255, (60, 80)), 1.5)
    for i in range(4):
        write_netpbm(str(root / f"{i:04d}.pgm"),
                     canvas[2 * i:2 * i + 48, 2 * i:2 * i + 64]
                     .astype(np.uint8))
    return str(root / "%04d.pgm")


def test_flowclip_sequence_matches_extra(pgm_clip):
    """A PGM sequence (cv2 opens it as a video): the same frames, and each
    pair's Farneback within tests/test_torch_farneback.py's 60 dB bar of
    the JAX tool's."""
    clip = viewflow_player.FlowClip(pgm_clip, device="cpu")
    want = jplayer.FlowClip(pgm_clip)
    assert len(clip) == len(want) == 3
    assert clip.framerate == want.framerate
    for i in range(3):
        np.testing.assert_array_equal(clip.frame(i), want.frame(i))
        got = clip.flow(i)
        assert got.shape == (48, 64, 2) and got.dtype == np.float32
        assert _flow_psnr(got, want.flow(i)) >= FB_PSNR
    # the interior follows the pan
    assert np.abs(np.median(clip.flow(1)[8:-8, 8:-8], axis=(0, 1))
                  - 2.0).max() < 0.5


def test_flowclip_flow_is_the_estimator(pgm_clip):
    """``flow(i)`` is the port's Farneback on the pair (frame i + 1 back to
    frame i), called directly."""
    from transflow_tpu_torch.flow.estimators.farneback import farneback
    clip = viewflow_player.FlowClip(pgm_clip, device="cpu")
    gray = [torch.from_numpy(read_netpbm(pgm_clip % i)) for i in range(2)]
    assert torch.equal(torch.from_numpy(clip.flow(0)),
                       farneback(gray[1], gray[0]))


def test_flowclip_video_matches_extra(tmp_path):
    """A video file (MJPG in an .avi, cv2-written): the frames and frame
    rate of the JAX tool's clip."""
    import cv2
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 12.0,
                             (W, H))
    rng = np.random.default_rng(4)
    base_frame = rng.integers(0, 256, (H, W, 3), np.uint8)
    for t in range(4):
        writer.write(np.roll(base_frame, 2 * t, axis=1))
    writer.release()
    clip = viewflow_player.FlowClip(path, device="cpu")
    want = jplayer.FlowClip(path)
    assert len(clip) == len(want) == 3
    assert clip.framerate == want.framerate == 12.0
    for i in range(4):
        np.testing.assert_array_equal(clip.frame(i), want.frame(i))


def test_flowclip_refusals(tmp_path, monkeypatch):
    for make in (jplayer.FlowClip, viewflow_player.FlowClip):
        with pytest.raises(FileNotFoundError):
            make(str(tmp_path / "clip.mp4"))
    write_netpbm(str(tmp_path / "one.pgm"), np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="2 frames"):
        viewflow_player.FlowClip(str(tmp_path / "one.pgm"))
    (tmp_path / "seq").mkdir()
    for i in range(2):
        write_netpbm(str(tmp_path / "seq" / f"{i:04d}.pgm"),
                     np.zeros((8, 8), np.uint8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    clip = viewflow_player.FlowClip(str(tmp_path / "seq" / "%04d.pgm"))
    with pytest.raises(RuntimeError, match="CUDA"):
        clip.flow(0)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        viewflow_player.FlowClip(str(tmp_path / "clip.mp4"))


# ---------------------------------------------------------------------------
# the control session
# ---------------------------------------------------------------------------

def _synthetic_checkpoint(path):
    """tests/test_utils.py::TestControlSession's: a mapping shifted by +1
    column."""
    h, w = 6, 8
    pos_i = np.arange(h)[:, None] * np.ones((1, w), int)
    pos_j = np.clip(np.arange(w)[None, :] * np.ones((h, 1), int) + 1,
                    0, w - 1)
    buffer = io.BytesIO()
    np.savez(buffer, **{"layer0.pos_i": pos_i, "layer0.pos_j": pos_j})
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("meta.json", json.dumps({"cursor": 1}))
        z.writestr("state.npz", buffer.getvalue())
    return str(path)


@pytest.fixture(scope="module")
def cli_checkpoint(tmp_path_factory):
    """The end checkpoint of the port's CLI (``-C``) on the CPU over six
    panned PGM frames."""
    root = tmp_path_factory.mktemp("ckpt")
    (root / "seq").mkdir()
    (root / "out").mkdir()
    canvas = np.random.default_rng(0).integers(0, 256, (60, 80), np.uint8)
    for i in range(6):
        write_netpbm(str(root / "seq" / f"{i:04d}.pgm"),
                     canvas[2 * i:2 * i + 32, 2 * i:2 * i + 48])
    cli.main([str(root / "seq" / "%04d.pgm"), "-p", "noise", "--seed", "0",
              "-r", "random", "0.05", "-o", str(root / "out" / "%04d.ppm"),
              "-C", "--overwrite", "--no-exec"], device="cpu")
    return str(root / "out" / "%04d_00005.ckpt.zip")


def _session_parity(path, tmp_path, cells):
    session = control.ControlSession(path)
    want = jcontrol.ControlSession(path)
    assert session.meta == want.meta
    assert session.arrays.keys() == want.arrays.keys()
    for key in want.arrays:
        np.testing.assert_array_equal(session.arrays[key], want.arrays[key])
    assert (session.height, session.width) == (want.height, want.width)
    for k, (i, j) in enumerate(cells):
        assert session.source_of(i, j) == want.source_of(i, j)
        np.testing.assert_array_equal(session.outputs_of(i, j),
                                      want.outputs_of(i, j))
        color = ["red", "#00ff80", (1, 2, 3)][k % 3]
        for s in (session, want):
            s.paint(i, j, color, radius=k % 2)
        np.testing.assert_array_equal(session.alteration, want.alteration)
        np.testing.assert_array_equal(session.preview(), want.preview())
    for s in (session, want):
        s.erase(*cells[0], radius=1)
    np.testing.assert_array_equal(session.alteration, want.alteration)
    np.testing.assert_array_equal(session.preview(), want.preview())
    got = session.export(str(tmp_path / "port.png"))
    np.testing.assert_array_equal(imread(got), imread(
        want.export(str(tmp_path / "jax.png"))))
    np.testing.assert_array_equal(imread(got), session.alteration)
    for s in (session, want):
        s.reset()
    np.testing.assert_array_equal(session.preview(), want.preview())
    return session


def test_control_session_synthetic(tmp_path):
    session = _session_parity(_synthetic_checkpoint(tmp_path / "x.ckpt.zip"),
                              tmp_path, [(2, 3), (0, 7), (5, 0)])
    assert session.source_of(2, 3) == (2, 4)
    session.paint(2, 3, "red")
    assert tuple(session.alteration[2, 4]) == (255, 0, 0, 255)
    assert tuple(session.preview()[2, 3]) == (255, 0, 0)


def test_control_session_on_a_cli_checkpoint(cli_checkpoint, tmp_path):
    session = _session_parity(cli_checkpoint, tmp_path,
                              [(5, 9), (16, 24), (31, 47), (0, 0)])
    assert (session.height, session.width) == (32, 48)
    with pytest.raises(ValueError, match="layer 3"):
        control.ControlSession(cli_checkpoint, layer=3)


def test_control_main(cli_checkpoint, tmp_path, monkeypatch, capsys):
    """``--silent`` exports the empty alteration; with a display the
    window opens, and without cv2 it names it."""
    out = str(tmp_path / "alt.png")
    control.main([cli_checkpoint, "--silent", "-o", out])
    assert "mapping 48x32; exported" in capsys.readouterr().out
    assert imread(out).shape == (32, 48, 4) and not imread(out).any()
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        control.main([cli_checkpoint, "-o", out])


def test_control_window_matches_extra(cli_checkpoint, tmp_path,
                                      monkeypatch):
    """``run_window``: the same painting through the mouse, the same
    color, reset and export keys and the same previews as the JAX tool's
    window, and the exported alteration equal."""
    import cv2
    keys = [255, ord("c"), 255, ord("s"), ord("r"), ord("s")]
    strokes = [(cv2.EVENT_LBUTTONDOWN, 5, 9, 0),
               (cv2.EVENT_MOUSEMOVE, 16, 24, cv2.EVENT_FLAG_LBUTTON),
               (cv2.EVENT_RBUTTONDOWN, 16, 24, 0)]
    results = {}
    for package, module in (("jax", jcontrol), ("port", control)):
        stub = HighGuiStub()
        session = module.ControlSession(cli_checkpoint)
        out = str(tmp_path / f"{package}.png")

        def wait(delay=0, stub=stub):
            if len(stub.shown) == 1:   # on the first frame: paint, erase
                for event, x, y, flags in strokes:
                    stub.mouse(event, x, y, flags, None)
            return (keys[len(stub.shown) - 1] if len(stub.shown) <= len(keys)
                    else ord("q"))

        stub.waitKey = wait
        monkeypatch.setitem(sys.modules, "cv2", stub)
        with contextlib.redirect_stdout(io.StringIO()):
            module.run_window(session, out)
        assert stub.windows == []
        results[package] = ([image for _, image in stub.shown],
                            imread(out))
    got, want = results["port"], results["jax"]
    assert len(got[0]) == len(want[0]) == len(keys) + 1
    assert not np.array_equal(got[0][0], got[0][1])   # the paint shows
    for image, jimage in zip(got[0], want[0]):
        np.testing.assert_array_equal(image, jimage)
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the batch renderer's default files
# ---------------------------------------------------------------------------

# the CLI tests' bar on frames against the JAX CLI
# (tests/test_torch_pipeline.py): at most 1 % of pixels differ
FRAME_SHARE = 0.01
BATCH_H, BATCH_W, BATCH_FRAMES = 32, 48, 9


def _read_video(path):
    """(fourcc, the frames as cv2 decodes them) of a video file."""
    import cv2
    capture = cv2.VideoCapture(path)
    fourcc = int(capture.get(cv2.CAP_PROP_FOURCC))
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return fourcc.to_bytes(4, "little").decode(), np.stack(frames)


def test_batch_render_default_files_match_extra(tmp_path, monkeypatch):
    """Two MJPG clips through the port's batch renderer with its default
    output and through extra/batch_render.py (JAX on the virtual 8-device
    CPU mesh): the same file names, ``.avi`` files in MJPG with the same
    frame count, and frames within the CLI tests' bar. The port's encoder
    chain is taken to its cv2 rung, ``cv2.VideoWriter`` as the JAX tool
    calls it (the card's machine has no native IO library; here that rung
    would open first, with its own JPEG quality)."""
    import cv2
    from transflow_tpu_torch import native
    from transflow_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setattr(native, "is_available", lambda: False)
    from transflow_tpu_torch.tools import batch_render
    import batch_render as jbatch
    rng = np.random.default_rng(4)
    pairs = []
    for s, pan in enumerate((2, -1)):
        canvas = rng.integers(0, 256, (BATCH_H + 20, BATCH_W + 20),
                              dtype=np.uint8)
        clip = str(tmp_path / f"clip{s}.avi")
        writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                                 (BATCH_W, BATCH_H))
        for i in range(BATCH_FRAMES):
            o = i * pan if pan > 0 else (BATCH_FRAMES - i) * -pan
            writer.write(cv2.cvtColor(
                np.ascontiguousarray(canvas[o:o + BATCH_H, o:o + BATCH_W]),
                cv2.COLOR_GRAY2BGR))
        writer.release()
        pix = str(tmp_path / f"pix{s}.png")
        cv2.imwrite(pix, rng.integers(0, 256, (BATCH_H, BATCH_W, 3),
                                      dtype=np.uint8))
        pairs.append((clip, pix))
    got = batch_render.batch_render(pairs, str(tmp_path / "port"), chunk=4,
                                    seed=3,
                                    mesh=make_mesh(devices=["cpu"] * 2))
    want = jbatch.batch_render(pairs, str(tmp_path / "jax"), chunk=4, seed=3)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["stream00.avi",
                                                "stream01.avi"]
    for path, jpath in zip(got, want):
        fourcc, frames = _read_video(path)
        jfourcc, jframes = _read_video(jpath)
        assert fourcc == jfourcc == "MJPG"
        assert frames.shape == jframes.shape == (BATCH_FRAMES - 1, BATCH_H,
                                                 BATCH_W, 3)
        for frame, jframe in zip(frames, jframes):
            assert (frame != jframe).any(axis=-1).mean() <= FRAME_SHARE


# ---------------------------------------------------------------------------
# the published-weights check, rehearsed on a synthetic checkpoint
# ---------------------------------------------------------------------------

def _sniklaus_checkpoint(path, edit=None):
    """The port's random LiteFlowNet weights saved with ``torch.save`` in
    the published checkpoint's layout (``net*`` names, OIHW), with
    ``edit`` applied to that dict first."""
    from transflow_tpu_torch.flow.estimators import liteflownet as lfn
    keys = lfn.torch_state_keys()
    state = {keys[k]: v for k, v in lfn.random_params(0).items()}
    if edit is not None:
        edit(state)
    torch.save(state, str(path))
    return str(path)


def _verify_main(argv):
    from transflow_tpu_torch.tools import verify_weights
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = verify_weights.main(argv)
    return code, json.loads(out.getvalue())


def test_verify_weights_passes_a_synthetic_checkpoint(tmp_path):
    """The rehearsal: exit 0 with the network's 212 tensors (the JAX
    tool's leaf count), the JAX loader reading the same file to the same
    weights, and the digest of the port's network on the bundled frames."""
    import jax
    from transflow_tpu.flow.estimators import liteflownet as jlfn
    from transflow_tpu_torch.flow.estimators import liteflownet as lfn
    from transflow_tpu_torch.tools import verify_weights
    path = _sniklaus_checkpoint(tmp_path / "network-default.pytorch")
    code, result = _verify_main([path, "--device", "cpu"])
    assert code == 0 and result["ok"]
    assert result["tree_problems"] == []
    jstate = jlfn.load_torch_weights(path)
    assert result["tree_leaves"] == len(jax.tree_util.tree_leaves(jstate)) \
        == 212
    port = lfn.load_torch_weights(path)
    for key, value in lfn.params_from_jax(jstate).items():
        assert torch.equal(port[key], value), key
    assert result["sha256"] == verify_weights.sha256_of(path)
    assert result["sha256_match"] == "unpinned"
    net = lfn.LiteFlowNet()
    net.load_state_dict(lfn.random_params(0))
    f0, f1 = verify_weights.bundled_frames()
    flow = lfn.liteflownet(f0, f1, net=net.eval()).numpy()
    assert result["flow_golden"] == verify_weights.flow_digest(flow)
    assert result["flow_golden"]["shape"] == [256, 448, 2]


@pytest.mark.parametrize("broken", ["renamed", "shape", "dtype"])
def test_verify_weights_fails_a_broken_tree(tmp_path, broken):
    """A renamed tensor, a wrong shape or a wrong dtype each fail the
    check, named, before any forward pass."""
    name = "netFeatures.netOne.0.weight"

    def edit(state):
        if broken == "renamed":
            state["netFeatures.netOne.9.weight"] = state.pop(name)
        elif broken == "shape":
            state[name] = state[name][:, :, :3]
        else:
            state[name] = state[name].double()

    path = _sniklaus_checkpoint(tmp_path / "broken.pytorch", edit)
    code, result = _verify_main([path, "--device", "cpu"])
    assert code == 1 and not result["ok"]
    assert "flow_golden" not in result
    want = {"renamed": [f"missing: {name}",
                        "unexpected: netFeatures.netOne.9.weight"],
            "shape": [f"shape {name}: (32, 3, 3, 7) != (32, 3, 7, 7)"],
            "dtype": [f"dtype {name}: torch.float64 != torch.float32"]}
    assert result["tree_problems"] == want[broken]


@pytest.mark.parametrize("pin", ["match", "mismatch"])
def test_verify_weights_holds_the_pinned_digest(tmp_path, monkeypatch, pin):
    """With a digest pinned, a file that hashes to it passes and one that
    does not fails, its tensors and forward pass sound all the same."""
    from transflow_tpu_torch.tools import verify_weights
    path = _sniklaus_checkpoint(tmp_path / "network-default.pytorch")
    digest = verify_weights.sha256_of(path) if pin == "match" else "0" * 64
    monkeypatch.setattr(verify_weights, "pinned_sha", lambda: digest)
    code, result = _verify_main([path, "--device", "cpu"])
    assert result["tree_problems"] == [] and "flow_golden" in result
    assert result["sha256_pinned"] == digest
    assert result["sha256_match"] is (pin == "match")
    assert (code, result["ok"]) == ((0, True) if pin == "match"
                                    else (1, False))


def test_verify_weights_helpers_match_the_jax_tool():
    """The bundled frames, the digest and the pinned digest are the JAX
    tool's."""
    from transflow_tpu_torch.tools import verify_weights
    sys.path.insert(0, os.path.join(os.path.dirname(EXTRA), "tools"))
    import verify_weights as jverify
    for got, want in zip(verify_weights.bundled_frames(),
                         jverify.bundled_frames()):
        np.testing.assert_array_equal(got, want)
    flow = np.random.default_rng(3).standard_normal((8, 10, 2)) * 4
    assert verify_weights.flow_digest(flow) == jverify.flow_digest(flow)
    assert verify_weights.pinned_sha() == jverify.pinned_sha()

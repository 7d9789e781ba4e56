"""The port's web GUI and live tuning against the JAX package's:
tests/test_gui.py, tests/test_gui_client.py and tests/test_tuning.py with
the port's server rendering on the CPU (``device="cpu"``); the static
client byte-equal to the JAX package's; the Engine's rebuild after a
tuning edit equal to a fresh Farneback with the new settings. Every
socket and websocket wait has its own timeout."""
import json
import os
import re
import socket
import sys
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from test_torch_codecs import write_clip
from transflow_tpu.flow.sources.cv import CvFlowConfig as JaxCvFlowConfig
from transflow_tpu.gui import tuning as jtuning
from transflow_tpu.gui.server import STATIC_DIR as JAX_STATIC
from transflow_tpu_torch.config import Config, LayerConfig, PixmapSourceConfig
from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
from transflow_tpu_torch.gui import tuning
from transflow_tpu_torch.gui.server import STATIC_DIR, GuiServer
from transflow_tpu_torch.gui.tuning import (FIELD_KINDS, FIELD_SPECS, FIELDS,
                                            CvFlowConfigWindow, coerce_value)

TIMEOUT = 10         # seconds for an HTTP request or one websocket message
JOB_TIMEOUT = 120    # seconds for a GENERATE job to answer DONE
APP_JS = os.path.join(STATIC_DIR, "app.js")


def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


@pytest.fixture(scope="module")
def server():
    gui = GuiServer("127.0.0.1", _free_port(), _free_port(), device="cpu")
    gui.start(block=False, open_browser=False)
    yield gui
    gui.stop()


@pytest.fixture(scope="module")
def test_video(tmp_path_factory):
    """tests/test_gui.py's clip: 8 frames of 48x32, MJPG."""
    path = tmp_path_factory.mktemp("gui") / "video.avi"
    write_clip(path, frames=8, h=32, w=48)
    return str(path)


def _url(server, path):
    return f"http://127.0.0.1:{server.port}{path}"


def _connect(server):
    import websockets.sync.client
    return websockets.sync.client.connect(
        f"ws://127.0.0.1:{server.ws_port}", open_timeout=TIMEOUT)


def _run_job(server, config):
    """GENERATE ``config``; the messages up to DONE (an ERROR fails)."""
    messages = []
    with _connect(server) as ws:
        ws.send("GENERATE " + json.dumps(config))
        deadline = time.time() + JOB_TIMEOUT
        while time.time() < deadline:
            message = ws.recv(timeout=JOB_TIMEOUT)
            messages.append(message)
            if message.startswith("DONE"):
                return messages
            if message.startswith("ERROR"):
                raise AssertionError(message)
    raise AssertionError(f"no DONE within {JOB_TIMEOUT} s: {messages}")


def _frame_count(path):
    capture = cv2.VideoCapture(path)
    count = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
    capture.release()
    return count


# ---------------------------------------------------------------------------
# the server (tests/test_gui.py)
# ---------------------------------------------------------------------------

def test_ping(server):
    with urllib.request.urlopen(_url(server, "/ping"),
                                timeout=TIMEOUT) as resp:
        assert resp.read() == b"PONG"


def test_index_and_wss(server):
    with urllib.request.urlopen(_url(server, "/"), timeout=TIMEOUT) as resp:
        assert "transflow" in resp.read().decode()
    with urllib.request.urlopen(_url(server, "/wss"),
                                timeout=TIMEOUT) as resp:
        assert int(resp.read()) == server.ws_port


@pytest.mark.parametrize("name", ["app.js", "index.html", "style.css"])
def test_static_files_match_jax(server, name):
    """The port's own copy of the client, byte-equal to the JAX
    package's, is what the server sends."""
    assert os.path.realpath(STATIC_DIR) != os.path.realpath(JAX_STATIC)
    with open(os.path.join(STATIC_DIR, name), "rb") as got, \
            open(os.path.join(JAX_STATIC, name), "rb") as want:
        body = got.read()
        assert body == want.read()
    with urllib.request.urlopen(_url(server, f"/{name}"),
                                timeout=TIMEOUT) as resp:
        assert resp.read() == body
    assert sorted(os.listdir(STATIC_DIR)) == sorted(os.listdir(JAX_STATIC))


def test_static_path_cannot_escape(server):
    with urllib.request.urlopen(_url(server, "/../../server.py"),
                                timeout=TIMEOUT) as resp:
        with open(os.path.join(STATIC_DIR, "index.html"), "rb") as index:
            assert resp.read() == index.read()


def test_media_range(server, test_video):
    req = urllib.request.Request(_url(server, f"/media?path={test_video}"),
                                 headers={"Range": "bytes=0-99"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        assert resp.status == 206
        assert len(resp.read()) == 100


def test_media_full_and_suffix_range(server, test_video):
    size = os.path.getsize(test_video)
    with urllib.request.urlopen(_url(server, f"/media?path={test_video}"),
                                timeout=TIMEOUT) as resp:
        assert resp.status == 200
        assert len(resp.read()) == size
    req = urllib.request.Request(_url(server, f"/media?path={test_video}"),
                                 headers={"Range": f"bytes={size - 50}-"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        assert resp.status == 206
        assert resp.headers["Content-Range"] == \
            f"bytes {size - 50}-{size - 1}/{size}"
        assert len(resp.read()) == 50


def test_media_missing_file(server):
    with pytest.raises(urllib.error.HTTPError) as info:
        urllib.request.urlopen(_url(server, "/media?path=/nope/missing.mp4"),
                               timeout=TIMEOUT)
    assert info.value.code == 404


def test_generate_job(server, test_video, tmp_path):
    """A GENERATE renders on the server's device: PREVIEW, STATUS, then
    DONE with the output; 8 frames give 7."""
    out = str(tmp_path / "gui-out.avi")
    config = {"flow_path": test_video, "output_path": out,
              "vcodec": "mjpeg",
              "pixmap_sources": [{"path": "noise", "layers": [0]}],
              "seed": 1}
    messages = _run_job(server, config)
    assert messages[0] == \
        f"PREVIEW http://127.0.0.1:{server.mjpeg_port}/transflow"
    statuses = [json.loads(m[len("STATUS "):]) for m in messages
                if m.startswith("STATUS")]
    assert all(status.get("error") in (None, "") for status in statuses)
    assert messages[-1] == f"DONE {out}"
    assert _frame_count(out) == 7
    assert server.pipeline.engine.device == torch.device("cpu")
    assert server.pipeline.config.output_path[0] == \
        f"mjpeg:{server.mjpeg_port}"


def test_generate_job_frames_stream_as_mjpeg(server, test_video, tmp_path):
    """The job's MJPEG preview (the first output) serves its frames while
    the job runs, at the clip's size."""
    import http.client
    import threading
    config = {"flow_path": test_video,
              "output_path": str(tmp_path / "%04d.png"),
              "pixmap_sources": [{"path": "noise", "layers": [0]}],
              "seed": 2}
    fetched = {}

    def fetch():
        deadline = time.time() + JOB_TIMEOUT
        while time.time() < deadline and "jpeg" not in fetched:
            try:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", server.mjpeg_port, timeout=TIMEOUT)
                conn.request("GET", "/transflow")
                response = conn.getresponse()
                head = b""
                while not head.endswith(b"\r\n\r\n"):
                    head += response.read(1)
                length = int(re.search(rb"Content-Length: (\d+)",
                                       head).group(1))
                fetched["jpeg"] = response.read(length)
                conn.close()
            except OSError:
                time.sleep(0.01)

    client = threading.Thread(target=fetch, daemon=True)
    client.start()
    _run_job(server, {**config, "repeat": 5})
    client.join(TIMEOUT)
    assert "jpeg" in fetched
    image = cv2.imdecode(np.frombuffer(fetched["jpeg"], np.uint8),
                         cv2.IMREAD_COLOR)
    assert image.shape == (32, 48, 3)
    assert len(list(tmp_path.glob("*.png"))) == 7 * 5


def test_interrupt_without_job(server):
    with _connect(server) as ws:
        ws.send("INTERRUPT")  # no job: must not crash the server
        ws.send("RELOAD")
        message = ws.recv(timeout=TIMEOUT)
        while not message.startswith("RELOAD "):
            message = ws.recv(timeout=TIMEOUT)
        state = json.loads(message[len("RELOAD "):])
        assert set(state) == {"ongoing", "outputFile", "previewUrl"}
        assert state["previewUrl"].endswith("/transflow")


def test_interrupt_cancels_a_job(server, test_video, tmp_path):
    """INTERRUPT during a long job: CANCEL to every client, then the job
    ends early with DONE."""
    config = {"flow_path": test_video,
              "output_path": str(tmp_path / "%04d.ppm"),
              "pixmap_sources": [{"path": "noise", "layers": [0]}],
              "repeat": 0, "seed": 4}
    with _connect(server) as ws:
        ws.send("GENERATE " + json.dumps(config))
        seen = []
        deadline = time.time() + JOB_TIMEOUT
        while time.time() < deadline:
            message = ws.recv(timeout=JOB_TIMEOUT)
            seen.append(message.split(" ", 1)[0])
            if message.startswith("STATUS") and "INTERRUPT" not in seen:
                ws.send("INTERRUPT")
                seen.append("INTERRUPT")
            if message.startswith(("DONE", "ERROR")):
                break
    assert "CANCEL" in seen and seen[-1] == "DONE"
    assert not server.job_ongoing


def test_reload_reports_finished_job_state(server, test_video, tmp_path):
    out = str(tmp_path / "reload-out.avi")
    _run_job(server, {"flow_path": test_video, "output_path": out,
                      "vcodec": "mjpeg",
                      "pixmap_sources": [{"path": "noise", "layers": [0]}],
                      "seed": 3})
    with _connect(server) as ws:
        ws.send("RELOAD")
        message = ws.recv(timeout=TIMEOUT)
        assert message.startswith("RELOAD ")
        state = json.loads(message[len("RELOAD "):])
        assert state["ongoing"] is False
        assert state["outputFile"] == out


def test_generate_layered_multi_pixmap(server, test_video, tmp_path):
    """tests/test_gui.py's 2-layer / 2-pixmap GENERATE: moveref and
    introduction, a still and a video pixmap, a clean DONE."""
    out = str(tmp_path / "layered-out.avi")
    config = {
        "flow_path": test_video, "output_path": out, "vcodec": "mjpeg",
        "pixmap_sources": [{"path": "cnoise", "layers": [0]},
                           {"path": test_video, "layers": [1]}],
        "layers": [
            {"index": 0, "classname": "moveref", "reset_mode": "random",
             "reset_random_factor": 0.1},
            {"index": 1, "classname": "introduction",
             "mask_alpha": "circle:10"},
        ],
        "seed": 5,
    }
    messages = _run_job(server, config)
    assert any(m.startswith("STATUS") for m in messages)
    assert out in messages[-1]
    assert _frame_count(out) == 7


def test_bad_messages_answer_errors(server, tmp_path):
    with _connect(server) as ws:
        ws.send("HELLO")
        assert ws.recv(timeout=TIMEOUT).startswith("ERROR unknown message")
        ws.send("GENERATE " + json.dumps({"layers": [{"index": "x"}]}))
        message = ws.recv(timeout=TIMEOUT)
        while not message.startswith("ERROR"):
            message = ws.recv(timeout=TIMEOUT)
        assert message.startswith("ERROR")


def test_file_dialog_round_trip_or_headless_error(server):
    """FILE_OPEN answers 'FILE <key> <path>' with a display, or a clear
    ERROR when headless."""
    with _connect(server) as ws:
        ws.send("FILE_OPEN flow_path")
        message = ws.recv(timeout=15)
        assert (message.startswith("FILE flow_path ")
                or message.startswith("ERROR file dialog unavailable"))


def test_server_needs_a_card_or_a_device(monkeypatch):
    """With no device named the server renders on the card, and raises
    without one; without websockets its start names it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GuiServer("127.0.0.1", 0, 0)
    monkeypatch.setitem(sys.modules, "websockets", None)
    with pytest.raises(ImportError, match="websockets"):
        GuiServer("127.0.0.1", 0, 0, device="cpu").start(block=False,
                                                         open_browser=False)


# ---------------------------------------------------------------------------
# the client (tests/test_gui_client.py) against the port's Config
# ---------------------------------------------------------------------------

def _build_config_source():
    text = open(APP_JS, encoding="utf8").read()
    match = re.search(r"function buildConfig\(\).*?\n}\n", text, re.S)
    assert match, "buildConfig() not found in app.js"
    return match.group(0), text


def test_buildconfig_keys_match_config_schema():
    src, _ = _build_config_source()
    top = re.search(r"const config = \{(.*?)\n  \};", src, re.S).group(1)
    top_flat = re.sub(r"\(\{.*?\}\)", "", top, flags=re.S)
    top_keys = set(re.findall(r"\n    (\w+):", top_flat))
    top_keys |= set(re.findall(r"config\.(\w+) =", src))
    unknown = top_keys - {key for key, _ in Config._FIELDS}
    assert not unknown, f"app.js emits unknown Config keys: {unknown}"
    pix = re.search(r"pixmap_sources: pixmaps\.map\(\(p\) => \(\{(.*?)\}\)\)",
                    src, re.S).group(1)
    pix_keys = set(re.findall(r"\n      (\w+):", pix))
    assert pix_keys <= {key for key, _ in PixmapSourceConfig._FIELDS}
    lay = re.search(r"layers: layers\.slice\(0, MAX_LAYERS\)"
                    r"\.map\(\(l\) => \(\{(.*?)\}\)\)", src, re.S).group(1)
    lay_keys = set(re.findall(r"\n      (\w+):", lay))
    assert lay_keys <= {key for key, _ in LayerConfig._FIELDS}


def test_client_grid_limits_declared():
    _, app = _build_config_source()
    assert "MAX_LAYERS = 5" in app and "MAX_PIXMAPS = 5" in app
    for feature in ["FILE_OPEN", "FILE_SAVE", "applyFile", "/media?path=",
                    "media_video", "requestFile"]:
        assert feature in app, feature
    index = open(os.path.join(STATIC_DIR, "index.html"),
                 encoding="utf8").read()
    for element in ["browse_flow", "browse_output", "media_video",
                    "media_image", "reload", "export_json", "import_json"]:
        assert element in index, element


def test_generate_json_round_trips_through_the_port_config():
    """A GENERATE payload of two layers and two pixmaps, as buildConfig
    assembles it, parses into the port's Config as into the JAX
    package's, and back."""
    from transflow_tpu.config import Config as JaxConfig
    payload = {
        "flow_path": "flow.mp4", "direction": "backward", "use_mvs": False,
        "cv_config": {"method": "horn-schunck"}, "seek_time": "00:00:02",
        "duration_time": None, "repeat": 2, "flow_filters": "clip=8",
        "mask_path": None, "lock_mode": "stay", "lock_expr": "(0.5, 0.2)",
        "vcodec": "h264", "render_scale": 1.0, "render_colors": None,
        "render_binary": False, "compositor_background": "#102030",
        "output_path": "out.mp4", "view_flow": False,
        "view_flow_magnitude": False,
        "pixmap_sources": [
            {"path": "a.png", "layers": [0], "introduction_path": None,
             "alteration_path": None, "seek_time": None, "repeat": 1},
            {"path": "b.mp4", "layers": [0, 1], "introduction_path": None,
             "alteration_path": "alt.png", "seek_time": "00:00:01.500",
             "repeat": 3}],
        "layers": [
            {"index": 0, "classname": "moveref", "mask_dst":
             "border-left:10%", "reset_mode": "random",
             "reset_random_factor": 0.1, "reset_source": True},
            {"index": 1, "classname": "introduction",
             "introduce_once": True,
             "moving_pixels_leave_empty_spot": True}],
        "seed": 7, "batch_frames": 4,
    }
    src, _ = _build_config_source()
    for key in payload:
        assert re.search(rf"\b{key}\b", src), f"{key} not in buildConfig"
    cfg = Config.fromdict(json.loads(json.dumps(payload)))
    want = JaxConfig.fromdict(json.loads(json.dumps(payload)))
    drop = ("timestamp", "command")
    assert ({k: v for k, v in cfg.todict().items() if k not in drop}
            == {k: v for k, v in want.todict().items() if k not in drop})
    assert cfg.seek_time == 2.0 and cfg.pixmap_sources[1].seek_time == 1.5
    assert [layer.classname for layer in cfg.layers] == ["moveref",
                                                         "introduction"]
    again = Config.fromdict(cfg.todict())
    assert [layer.index for layer in again.layers] == [0, 1]
    assert again.cv_config == {"method": "horn-schunck"}


def test_inline_cv_config_drives_a_render(tmp_path):
    """An inline cv_config (the client's method select) routes through the
    port's CvFlowConfig in a render; a bad one, or a dangling path, is
    refused."""
    from transflow_tpu_torch.pipeline import Pipeline
    video = str(tmp_path / "v.avi")
    write_clip(video, frames=5)
    out = str(tmp_path / "o.avi")

    def config(cv_config):
        return Config(video, cv_config=cv_config,
                      pixmap_sources=[PixmapSourceConfig("noise",
                                                         layers=[0])],
                      output_path=out, vcodec="mjpeg", seed=3)

    pipeline = Pipeline(config({"method": "horn-schunck",
                                "hs_iterations": 2}),
                        progress=False, execute=False, device="cpu")
    pipeline.run()
    assert pipeline.engine.runtimes[0].source.config.hs_iterations == 2
    assert _frame_count(out) == 4
    for bad in ({"method": "nope"}, "/no/such/file.json"):
        with pytest.raises((ValueError, FileNotFoundError)):
            Pipeline(config(bad), progress=False, execute=False,
                     device="cpu").run()


# ---------------------------------------------------------------------------
# live tuning (tests/test_tuning.py)
# ---------------------------------------------------------------------------

def test_fields_match_config_schema():
    assert FIELDS == jtuning.FIELDS
    for attr, label, kind, spec in FIELDS:
        assert attr in CvFlowConfig.DEFAULTS, attr
        default = CvFlowConfig.DEFAULTS[attr]
        assert coerce_value(kind, str(default)) == default
        if kind in ("int", "float"):
            lo, hi = spec
            assert lo <= default <= hi, (attr, default, spec)
        else:
            assert default in spec


@pytest.mark.parametrize("kind,raw", [
    ("int", "7"), ("float", "0.5"), ("choice", "farneback"),
    ("int", "not-a-number"), ("float", ""), ("int", "3.5")])
def test_coerce_value(kind, raw):
    """The JAX function's value, or its ValueError."""
    try:
        want = jtuning.coerce_value(kind, raw)
    except ValueError:
        with pytest.raises(ValueError):
            coerce_value(kind, raw)
        return
    assert coerce_value(kind, raw) == want
    assert type(coerce_value(kind, raw)) is type(want)


@pytest.mark.parametrize("attr,raw", [
    ("fb_levels", "5"), ("fb_iterations", "5"), ("fb_poly_sigma", "1.5"),
    ("method", "horn-schunck"), ("fb_levels", ""), ("fb_levels", "abc"),
    ("fb_poly_sigma", "-")])
def test_apply_value_matches_jax(attr, raw):
    """The same answer, settings and version as the JAX window's: a
    parsed value bumps the version, a half-typed one changes nothing."""
    config, jconfig = CvFlowConfig(), JaxCvFlowConfig()
    ok = CvFlowConfigWindow(config).apply_value(attr, raw)
    assert ok == jtuning.CvFlowConfigWindow(jconfig).apply_value(attr, raw)
    assert config.to_dict() == jconfig.to_dict()
    assert config.version == jconfig.version == int(ok)


def test_field_specs_lookup_tables():
    assert FIELD_KINDS == jtuning.FIELD_KINDS
    assert FIELD_SPECS == jtuning.FIELD_SPECS
    assert FIELD_KINDS["method"] == "choice"
    assert FIELD_SPECS["fb_levels"] == (1, 8)


def test_window_starts_its_thread(monkeypatch):
    """``start`` runs the panel on a daemon thread (its tkinter loop is
    replaced here: no display); without tkinter it names it."""
    ran = []
    monkeypatch.setattr(CvFlowConfigWindow, "_run",
                        lambda self: ran.append(self.config))
    config = CvFlowConfig(show_window=True)
    config.start()
    config.window.thread.join(TIMEOUT)
    assert ran == [config] and config.window.thread.daemon
    monkeypatch.setitem(sys.modules, "tkinter", None)
    with pytest.raises(ImportError, match="tkinter"):
        CvFlowConfigWindow(config).start()


def test_tuning_rebuilds_the_engine_step(test_video):
    """An edit through ``apply_value`` between two frames: the Engine
    builds its estimator step anew once, and the next frame's raw flow
    equals a fresh ``farneback`` with the new settings on the same pair
    and warm start; a cv2 source with ``show_window`` renders per frame."""
    from transflow_tpu_torch.compositor.core import make_layer_params
    from transflow_tpu_torch.engine import Engine
    from transflow_tpu_torch.flow import Direction
    from transflow_tpu_torch.flow.estimators.farneback import farneback
    from transflow_tpu_torch.flow.sources.cv import CvFlowSource
    config = CvFlowConfig()
    source = CvFlowSource(test_video, config,
                          direction=Direction.BACKWARD).open()
    h, w = source.height, source.width
    layers = make_layer_params([LayerConfig(0)], h, w, {0: [(3, None)]},
                               device="cpu")
    engine = Engine(Config(test_video, seed=0), [source], layers, h, w,
                    device="cpu")
    runtime = engine.runtimes[0]
    items = iter(source)
    pixmaps = ((torch.zeros((h, w, 3), dtype=torch.uint8),),)
    steps = []
    for k in range(4):
        if k == 2:
            assert CvFlowConfigWindow(config).apply_value("fb_iterations",
                                                          "5")
            prev_gray = runtime.prev_gray.clone()
            prev_flow = runtime.prev_flow.clone()
        item = next(items)
        engine.process_frame([item], pixmaps, k / 10.0, ((k,),))
        steps.append(runtime.estimator_step)
        if k == 2:
            want = farneback(torch.from_numpy(item.array), prev_gray,
                             prev_flow, **config.estimator_kwargs())
            assert torch.equal(runtime.last_raw, want)
    assert [steps[k] is steps[k - 1] for k in range(1, 4)] == [True, False,
                                                               True]
    assert config.estimator_kwargs()["iterations"] == 5

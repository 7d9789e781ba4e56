"""The port's host shims against the JAX package's: ``CvFlowConfig``, the
``FlowSource`` iterator, ``Config``/``PixmapSourceConfig``, the expression
evaluator and the timestamp/size parsers. All of it is host logic, so the
port must match exactly."""
import enum
import inspect
import json
import sys

import numpy as np
import pytest
import torch

from transflow_tpu import config as jconfig
from transflow_tpu import flow as jflow
from transflow_tpu.flow.sources import base as jbase
from transflow_tpu.flow.sources import cv as jcv
from transflow_tpu.utils import expr as jexpr
from transflow_tpu.utils import misc as jmisc
from transflow_tpu_torch import config
from transflow_tpu_torch.flow import LockMode
from transflow_tpu_torch.flow.sources import base
from transflow_tpu_torch.flow.sources import cv
from transflow_tpu_torch.utils import expr, misc

# ---------------------------------------------------------------------------
# CvFlowConfig
# ---------------------------------------------------------------------------

CUSTOM = {
    "farneback": dict(fb_pyr_scale=0.4, fb_levels=2.0, fb_winsize=9,
                      fb_iterations=1, fb_poly_n=7, fb_poly_sigma=1.5,
                      fb_flags=256, fb_downscale=2, fb_select_warp=4),
    "horn-schunck": dict(hs_alpha=2.0, hs_iterations=5, hs_decay=0.1,
                         hs_delta=0.5),
    "lukas-kanade": dict(lk_window_size=9, lk_max_level=3, lk_step=2),
    "liteflownet": dict(lfn_warp_bound="16", lfn_scale=0.5),
}


def test_cv_config_defaults_pinned_to_jax():
    assert cv.METHODS == jcv.METHODS
    assert cv.CvFlowConfig.DEFAULTS == jcv.CvFlowConfig.DEFAULTS
    assert cv.CvFlowConfig().to_dict() == jcv.CvFlowConfig().to_dict()


@pytest.mark.parametrize("custom", [False, True], ids=["default", "custom"])
@pytest.mark.parametrize("method", jcv.METHODS)
def test_estimator_kwargs_match_jax(method, custom):
    kwargs = dict(method=method, **(CUSTOM[method] if custom else {}))
    got = cv.CvFlowConfig(**kwargs).estimator_kwargs()
    want = jcv.CvFlowConfig(**kwargs).estimator_kwargs()
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


@pytest.mark.parametrize("kwargs", [
    {"method": "raft"}, {"bogus": 1}, {"lfn_warp_bound": -16},
    {"lfn_scale": 0}, {"lfn_scale": 1.5}, {"fb_downscale": 0},
    {"fb_select_warp": -1}], ids=str)
def test_cv_config_errors_match_jax(kwargs):
    with pytest.raises(ValueError) as got:
        cv.CvFlowConfig(**kwargs)
    with pytest.raises(ValueError) as want:
        jcv.CvFlowConfig(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_cv_config_json_round_trip(tmp_path, direction):
    path = str(tmp_path / "lfn.json")
    settings = dict(method="liteflownet", lfn_warp_bound=12, lfn_scale=0.75,
                    hs_alpha=3.0)
    writer, reader = ((cv.CvFlowConfig, jcv.CvFlowConfig)
                      if direction == "port-to-jax"
                      else (jcv.CvFlowConfig, cv.CvFlowConfig))
    writer(**settings).to_file(path)
    back = reader.from_file(path)
    assert back.to_dict() == writer(**settings).to_dict()
    assert back.estimator_kwargs() == {"warp_bound": 12, "scale": 0.75}
    with open(path, encoding="utf8") as file:
        assert json.load(file) == writer(**settings).to_dict()


def test_cv_config_update_and_window(monkeypatch):
    """``update`` bumps the version; ``show_window=True`` keeps the same
    settings as the JAX config's, opens nothing until ``start``, and
    there names tkinter where it is missing."""
    cfg = cv.CvFlowConfig(method="liteflownet")
    assert cfg.version == 0
    cfg.update("lfn_warp_bound", 8)
    assert cfg.version == 1 and cfg.estimator_kwargs()["warp_bound"] == 8
    shown, jshown = (cv.CvFlowConfig(show_window=True, fb_levels=4),
                     jcv.CvFlowConfig(show_window=True, fb_levels=4))
    assert shown.show_window and shown.window is None
    assert shown.to_dict() == jshown.to_dict()
    cv.CvFlowConfig().start()  # no window asked: nothing opens
    monkeypatch.setitem(sys.modules, "tkinter", None)
    with pytest.raises(ImportError, match="tkinter"):
        shown.start()
    assert shown.window.thread is None


# ---------------------------------------------------------------------------
# FlowSource: a stub reader in both packages
# ---------------------------------------------------------------------------

N_FRAMES, H, W = 12, 4, 5


def _stub(module, kind, **kwargs):
    """A FlowSource of ``module`` over N_FRAMES in-memory frames (``kind``
    'frame': N-1 flow steps, primed after each rewind, as the cv2 source)
    or flows ('flow': N steps, as the archive source)."""
    data = np.arange(N_FRAMES * H * W * 2, dtype=np.float32).reshape(
        N_FRAMES, H, W, 2)

    class Stub(module.FlowSource):
        yields_frames = kind == "frame"

        def _open_reader(self):
            self.height, self.width = H, W
            self.framerate = 10.0
            self.base_length = N_FRAMES - (kind == "frame")

        def _rewind_reader(self, frame_index):
            self.pos = frame_index
            self.primed = False

        def _read_item(self):
            prime = None
            if kind == "frame" and not self.primed:
                prime = data[self.pos]
                self.pos += 1
                self.primed = True
            if self.pos >= N_FRAMES:
                raise StopIteration
            item = module.FlowItem(
                module.FlowItem.FRAME if kind == "frame"
                else module.FlowItem.FLOW, data[self.pos], prime=prime)
            self.pos += 1
            return item

    return Stub(**kwargs).open()


def _trace(source, cap=60):
    """(kind, array, prime, discarded, locked, t) of each item."""
    out = []
    for _ in range(cap):
        t = source.t
        try:
            item = next(source)
        except StopIteration:
            break
        disc = item.discarded
        out.append((item.kind, item.array, item.prime, item.locked, t,
                    None if disc is None else (disc.kind, disc.array,
                                               disc.prime)))
    return out


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and np.array_equal(a, b))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def _jax_enums(kwargs: dict) -> dict:
    """``kwargs`` with the port's enum members swapped for the JAX
    package's members of the same name: an enum of one package never
    equals the other's."""
    return {k: getattr(getattr(jflow, type(v).__name__), v.name)
            if isinstance(v, enum.Enum) else v for k, v in kwargs.items()}


def _enum_names(values: dict) -> dict:
    return {k: (type(v).__name__, v.name) if isinstance(v, enum.Enum)
            else v for k, v in values.items()}


SOURCE_CASES = {
    "plain": dict(),
    "seek": dict(seek_time=0.3),
    "duration": dict(seek_time=0.2, duration_time=0.5),
    "repeat": dict(duration_time=0.4, repeat=3),
    "lock-stay": dict(lock_expr="(0.3, 0.2), (0.8, 0.1)"),
    "lock-skip": dict(lock_expr="int(t * 10) % 3 == 1",
                      lock_mode=LockMode.SKIP),
    "seek-ckpt": dict(seek_ckpt=5, repeat=2),
    "seek-ckpt-lock-stay": dict(seek_ckpt=6, lock_expr="(0.2, 0.3)"),
    "seek-ckpt-lock-skip": dict(seek_ckpt=4, lock_expr="t > 0.6",
                                lock_mode="skip"),
    "unbounded-repeat": dict(repeat=0),
}


@pytest.mark.parametrize("kind", ["frame", "flow"])
@pytest.mark.parametrize("case", list(SOURCE_CASES))
def test_flow_source_matches_jax(case, kind):
    kwargs = SOURCE_CASES[case]
    got_src = _stub(base, kind, **kwargs)
    want_src = _stub(jbase, kind, **_jax_enums(kwargs))
    assert got_src.length == want_src.length
    got, want = _trace(got_src), _trace(want_src)
    assert len(got) == len(want) > 0
    for idx, (a, b) in enumerate(zip(got, want)):
        assert _equal(a, b), (idx, a[0], b[0], a[4], b[4])
    assert got_src.t == want_src.t


def test_lock_before_first_flow_raises():
    src = _stub(base, "flow", lock_expr="(0.0, 0.5)")
    with pytest.raises(RuntimeError, match="not been initialized"):
        next(src)


@pytest.mark.parametrize("option", ["mask_path", "kernel_path"])
def test_postprocess_mask_and_kernel_match_jax(option, tmp_path):
    """A source's ``--mask`` (a DSL rule, loaded at the source's size) and
    ``--kernel`` (an ``.npy`` file) reach the post-process as in the JAX
    package: bit-equal on integer flows with dyadic taps."""
    value = "circle:40%"
    if option == "kernel_path":
        value = str(tmp_path / "kernel.npy")
        np.save(value, np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]],
                                np.float32) / 16)
    src = _stub(base, "flow", direction="backward", **{option: value})
    jsrc = _stub(jbase, "flow", direction="backward", **{option: value})
    flow = np.random.default_rng(0).integers(-6, 7, (H, W, 2)) \
        .astype(np.float32)
    got = src.build_postprocess(device="cpu")(torch.from_numpy(flow), 0.0)
    want = jsrc.build_postprocess()(flow, 0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bare = _stub(base, "flow", direction="backward").build_postprocess()
    assert not torch.equal(got, bare(torch.from_numpy(flow), 0.0))


def test_backward_postprocess_clips_to_frame():
    src = _stub(base, "flow", direction="backward")
    flow = torch.full((H, W, 2), 100.0)
    out = src.build_postprocess()(flow, 0.0)
    assert out[..., 0].max() == W - 1 and out[..., 1].max() == H - 1


# ---------------------------------------------------------------------------
# Config and PixmapSourceConfig
# ---------------------------------------------------------------------------

def test_config_fields_pinned_to_jax():
    assert config.Config._FIELDS == jconfig.Config._FIELDS
    assert (config.PixmapSourceConfig._FIELDS
            == jconfig.PixmapSourceConfig._FIELDS)
    for cls, jcls in ((config.Config, jconfig.Config),
                      (config.PixmapSourceConfig,
                       jconfig.PixmapSourceConfig)):
        # annotations name each package's own classes: compare the rest
        assert ([(p.name, p.default, p.kind) for p in
                 inspect.signature(cls.__init__).parameters.values()]
                == [(p.name, p.default, p.kind) for p in
                    inspect.signature(jcls.__init__).parameters.values()])
    # each package's enums: compare members by class and name
    assert _enum_names(vars(config.Config("in.mp4", seed=3))) == \
        _enum_names(vars(jconfig.Config("in.mp4", seed=3)))
    assert config.Config("in.mp4").direction.name == "FORWARD"


CONFIG_DICT = {
    "flow_path": "flow.mp4", "extra_flow_paths": ["b.mp4"],
    "flows_merging_function": "sum", "direction": "backward",
    "seek_time": "00:00:01.500", "to_time": "00:00:04", "repeat": 2,
    "lock_expr": "(1, 2)", "lock_mode": "skip",
    "pixmap_sources": [{"path": "a.png", "layers": [0, 2],
                        "seek_time": "00:01:00"}, {"path": "b.mp4"}],
    "layers": [{"index": 2, "reset_mode": "random",
                "reset_random_factor": 0.1}],
    "compositor_background": "#000000", "size": "640x360",
    "render_colors": "#ff0000,#00ff00", "seed": 7, "batch_frames": 8,
    "view_flow_magnitude": True, "render_scale": 0.5,
}


def _comparable(d):
    return {k: v for k, v in d.items() if k not in ("timestamp", "command")}


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_config_dict_round_trip(direction):
    src, dst = ((config.Config, jconfig.Config) if direction == "port-to-jax"
                else (jconfig.Config, config.Config))
    first = src.fromdict(CONFIG_DICT)
    assert (_comparable(first.todict())
            == _comparable(dst.fromdict(CONFIG_DICT).todict()))
    back = dst.fromdict(json.loads(json.dumps(first.todict())))
    assert _comparable(back.todict()) == _comparable(first.todict())
    assert [layer.index for layer in back.layers] == [2, 0]


def test_config_errors_match_jax():
    for kwargs in ({"duration_time": -1}, {"direction": "sideways"},
                   {"lock_mode": "hold"}, {"size": "640"},
                   {"layers": [config.LayerConfig(1), config.LayerConfig(1)]}):
        with pytest.raises(ValueError) as got:
            config.Config("f.mp4", **kwargs)
        jkwargs = dict(kwargs)
        if "layers" in jkwargs:
            jkwargs["layers"] = [jconfig.LayerConfig(1),
                                 jconfig.LayerConfig(1)]
        with pytest.raises(ValueError) as want:
            jconfig.Config("f.mp4", **jkwargs)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# expressions, timestamps, sizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "0.5 * t", "t > 1 and t < 2", "int(t * 30) % 3 == 1",
    "math.sin(t) > 0.5", "max(0, min(1, t - 0.25)) ** 2",
    "1 if t >= math.pi else -1", "abs(round(t, 1) - 2.5) <= 0.05",
    "not (t // 0.5) % 2"])
def test_expression_matches_jax_on_scalars(text):
    got, want = expr.parse_expression(text), jexpr.parse_expression(text)
    for t in np.linspace(0.0, 4.0, 41):
        assert got(float(t)) == want(float(t)), (text, t)


@pytest.mark.parametrize("text", [
    "__import__('os')", "t.__class__", "open('x')", "lambda: 1",
    "[x for x in (1, 2)]", "numpy.__dict__", "t.real"])
def test_expression_errors_match_jax(text):
    with pytest.raises(ValueError) as got:
        expr.parse_expression(text)
    with pytest.raises(ValueError) as want:
        jexpr.parse_expression(text)
    assert str(got.value) == str(want.value)


def test_expression_arrays_match_jax():
    """Array arguments (the polar filter's r and a) evaluate as in the JAX
    package; tests/test_torch_expr.py holds the float32 arithmetic."""
    fn = expr.parse_expression("r * 2", ("t", "r", "a"))
    jfn = jexpr.parse_expression("r * 2", ("t", "r", "a"))
    assert fn(1.0, 2.0, 3.0) == jfn(1.0, 2.0, 3.0) == 4.0
    r = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    got = fn(1.0, torch.from_numpy(r), torch.from_numpy(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(1.0, r, r)))
    with pytest.raises(TypeError, match="3 arguments"):
        fn(1.0)


@pytest.mark.parametrize("text", ["(1, 2)", "1, 2", "(0.5, 1), (3, 0.25)",
                                  " (1,2),(3,4) "])
def test_lock_intervals_match_jax(text):
    assert expr.parse_lock_intervals(text) == jexpr.parse_lock_intervals(text)


def test_lock_interval_errors_match_jax():
    with pytest.raises(ValueError) as got:
        expr.parse_lock_intervals("(1, 2, 3)")
    with pytest.raises(ValueError) as want:
        jexpr.parse_lock_intervals("(1, 2, 3)")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value", ["00:01:02", "01:00:00.250", 3.5, 7, None])
def test_parse_timestamp_matches_jax(value):
    assert misc.parse_timestamp(value) == jmisc.parse_timestamp(value)


def test_parse_timestamp_warns_like_jax():
    with pytest.warns(UserWarning, match="Could not parse"):
        assert misc.parse_timestamp("soon") is None


@pytest.mark.parametrize("value", ["1920x1080", "640 by 360", (320, 240),
                                   [8, 6], None])
def test_parse_size_matches_jax(value):
    assert misc.parse_size(value) == jmisc.parse_size(value)


@pytest.mark.parametrize("value", ["1920", "1x2x3", 5])
def test_parse_size_errors_match_jax(value):
    with pytest.raises(ValueError) as got:
        misc.parse_size(value)
    with pytest.raises(ValueError) as want:
        jmisc.parse_size(value)
    assert str(got.value) == str(want.value)

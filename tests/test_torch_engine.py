"""The port's Engine against the JAX package's, on the CPU.

A flow-yielding stub source feeds both Engines the same raw flows, so the
post-process, compositor and renderers must match bit for bit, the random
reset included: both Engines split JAX's threefry key of the seed once per
frame. A LiteFlowNet frame source at ``lfn_warp_bound=8`` runs the bounded
backwarp through both Engines; its flows meet the network bar. A
checkpoint of either package resumes in the other.
"""
import json
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transflow_tpu import config as jconfig
from transflow_tpu import engine as jengine
from transflow_tpu.compositor import core as jcore
from transflow_tpu.flow.estimators import liteflownet as jlfn
from transflow_tpu.flow.sources import base as jbase
from transflow_tpu.flow.sources import cv as jcv
from transflow_tpu.ops import render as jrender
from transflow_tpu_torch import config, engine
from transflow_tpu_torch.compositor import core
from transflow_tpu_torch.flow import Direction
from transflow_tpu_torch.flow.sources import base, cv
from transflow_tpu_torch.ops import render, warp

H, W = 24, 32
FRAMES = 10
FPS = 30.0
# f32 network on both sides (tests/test_torch_liteflownet.py's bar)
NET_TOL = 1e-3


def _source(module, data, kind, config=None, **kwargs):
    """A FlowSource of ``module`` over in-memory ``data``: frames
    (primed after each rewind, as the cv2 source) or raw flows."""

    class Stub(module.FlowSource):
        yields_frames = kind == "frame"

        def _open_reader(self):
            self.height, self.width = data.shape[1:3]
            self.framerate = FPS
            self.base_length = len(data) - (kind == "frame")

        def _rewind_reader(self, frame_index):
            self.pos = frame_index
            self.primed = False

        def _read_item(self):
            prime = None
            if kind == "frame" and not self.primed:
                prime = data[self.pos]
                self.pos += 1
                self.primed = True
            if self.pos >= len(data):
                raise StopIteration
            item = module.FlowItem(
                module.FlowItem.FRAME if kind == "frame"
                else module.FlowItem.FLOW, data[self.pos], prime=prime)
            self.pos += 1
            return item

    src = Stub(direction="backward", **kwargs)
    src.config = config
    return src.open()


def _flows(n, h=H, w=W, seed=0):
    """Integer and half-integer motion with sub-pixel noise, reaching off
    the frame."""
    rng = np.random.default_rng(seed)
    flow = (rng.integers(-6, 7, (n, h, w, 2))
            + 0.5 * rng.integers(0, 2, (n, h, w, 2))
            + 0.1 * rng.standard_normal((n, h, w, 2)))
    return flow.astype(np.float32)


def _video(n, h, w, seed=0, step=2):
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (h + n * step, w + n * step, 3),
                          dtype=np.uint8)
    return np.stack([canvas[i * step:i * step + h, i * step:i * step + w]
                     for i in range(n)])


def _pixmap(h, w, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _engines(layer_kwargs, cfg_kwargs, sources, h=H, w=W, wf=1,
             export=True):
    """(port Engine, JAX Engine) over (port source, JAX source) pairs."""
    out_h, out_w = h, w * wf
    lp = core.make_layer_params([config.LayerConfig(0, **layer_kwargs)],
                                out_h, out_w, {0: [(3, None)]}, device="cpu")
    jlp = jcore.make_layer_params([jconfig.LayerConfig(0, **layer_kwargs)],
                                  out_h, out_w, {0: [(3, None)]})
    eng = engine.Engine(config.Config("in.mp4", **cfg_kwargs),
                        [s for s, _ in sources], lp, out_h, out_w,
                        width_factor=wf, export_flows=export, device="cpu")
    jeng = jengine.Engine(jconfig.Config("in.mp4", **cfg_kwargs),
                          [j for _, j in sources], jlp, out_h, out_w,
                          width_factor=wf, export_flows=export)
    eng._framerate = jeng._framerate = FPS
    return eng, jeng


def _assert_states_equal(state, jstate):
    for layer, jlayer in zip(state, jstate):
        assert set(layer) == set(jlayer)
        for key, value in layer.items():
            np.testing.assert_array_equal(value.numpy(),
                                          np.asarray(jlayer[key]),
                                          err_msg=key)


ENGINE_CASES = {
    "constant-frame": (dict(reset_mode="constant", reset_constant_step=2),
                       {}, 1, "frame"),
    "constant-chunk": (dict(reset_mode="constant", reset_constant_step=2),
                       {}, 1, "chunk"),
    "linear-frame": (dict(reset_mode="linear", reset_linear_factor=0.3,
                          moving_pixels_leave_empty_spot=True), {}, 1,
                     "frame"),
    "linear-chunk": (dict(reset_mode="linear", reset_linear_factor=0.3,
                          moving_pixels_leave_empty_spot=True), {}, 1,
                     "chunk"),
    "view-flow-frame": (dict(reset_mode="constant"),
                        dict(view_flow=True, render_scale=0.25), 1, "frame"),
    "magnitude-upscaled-chunk": (
        dict(reset_mode="linear"),
        dict(view_flow_magnitude=True, render_scale=0.2,
             render_colors="#102030,#f0e0d0"), 2, "chunk"),
    "random-frame": (dict(reset_mode="random", reset_random_factor=0.05),
                     {}, 1, "frame"),
    "random-chunk": (dict(reset_mode="random", reset_random_factor=0.05),
                     {}, 1, "chunk"),
    "random-high-frame": (dict(reset_mode="random", reset_random_factor=0.7,
                               moving_pixels_leave_empty_spot=True,
                               reset_source=True), {}, 1, "frame"),
    "random-high-chunk": (dict(reset_mode="random", reset_random_factor=0.7,
                               moving_pixels_leave_empty_spot=True,
                               reset_source=True), {}, 1, "chunk"),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_flow_source_engine_matches_jax(case):
    layer_kwargs, cfg_kwargs, wf, path = ENGINE_CASES[case]
    flows = _flows(FRAMES)
    cfg_kwargs = dict(cfg_kwargs, direction="backward", seed=0)
    eng, jeng = _engines(layer_kwargs, cfg_kwargs,
                         [(_source(base, flows, "flow"),
                           _source(jbase, flows, "flow"))], wf=wf)
    pix = _pixmap(H, W * wf)
    if path == "frame":
        frames, jframes, out, jout = [], [], [], []
        for idx, (item, jitem) in enumerate(zip(eng.runtimes[0].source,
                                                jeng.runtimes[0].source)):
            t = idx / FPS
            frame, flow = eng.process_frame(
                [item], ((torch.from_numpy(pix),),), t, ((idx,),))
            jframe, jflow = jeng.process_frame(
                [jitem], ((jnp.asarray(pix),),), t, ((idx,),))
            frames.append(frame)
            jframes.append(jframe)
            out.append(flow)
            jout.append(jflow)
        frames, jframes = torch.stack(frames), np.stack(jframes)
        out, jout = torch.stack(out), np.stack(jout)
    else:
        frames, out = eng.process_chunk([flows], ((pix,),), ((None,),), 0,
                                        0)
        jframes, jout = jeng.process_chunk([flows], ((jnp.asarray(pix),),),
                                           ((None,),), 0, 0)
    assert frames.shape == (FRAMES, H, W * wf, 3)
    assert frames.dtype == torch.uint8
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    _assert_states_equal(eng.comp_state, jeng.comp_state)
    np.testing.assert_array_equal(eng.key,
                                  np.asarray(jax.random.key_data(jeng.key)))
    assert len(np.unique(frames.numpy())) > 2      # the frames move


@pytest.fixture
def random_weights(monkeypatch):
    monkeypatch.setenv("TRANSFLOW_LITEFLOWNET_RANDOM", "1")
    monkeypatch.delenv(jlfn.WEIGHTS_ENV, raising=False)
    monkeypatch.delenv("TRANSFLOW_LITEFLOWNET_BF16", raising=False)
    monkeypatch.delenv("TRANSFLOW_LITEFLOWNET_WARP_BOUND", raising=False)
    monkeypatch.setattr(jlfn, "_CACHE", {})


def test_liteflownet_engine_matches_jax(random_weights, monkeypatch):
    """A LiteFlowNet frame source at lfn_warp_bound=8 through both
    Engines: 9 bounded warps per frame in the port, exported flows within
    the network bar."""
    calls = []
    plain = warp.bounded_backwarp_plain
    monkeypatch.setattr(warp, "bounded_backwarp_plain",
                        lambda *a: calls.append(a[2]) or plain(*a))
    h, w = 64, 96
    video = _video(3, h, w)
    settings = dict(method="liteflownet", lfn_warp_bound=8)
    eng, jeng = _engines(
        dict(reset_mode="constant"), dict(direction="backward", seed=0),
        [(_source(base, video, "frame", cv.CvFlowConfig(**settings)),
          _source(jbase, video, "frame", jcv.CvFlowConfig(**settings)))],
        h=h, w=w)
    pix = _pixmap(h, w)
    for idx, (item, jitem) in enumerate(zip(eng.runtimes[0].source,
                                            jeng.runtimes[0].source)):
        frame, flow = eng.process_frame([item], ((torch.from_numpy(pix),),),
                                        idx / FPS, ((idx,),))
        jframe, jflow = jeng.process_frame([jitem], ((jnp.asarray(pix),),),
                                           idx / FPS, ((idx,),))
        assert frame.shape == (h, w, 3) and frame.dtype == torch.uint8
        np.testing.assert_allclose(flow.numpy(), np.asarray(jflow),
                                   atol=NET_TOL, rtol=NET_TOL)
        assert len(calls) == 9 * (idx + 1)


def _gray_video(n, h, w, seed=0, step=2):
    """(n, h, w) uint8 gray frames: a smooth texture panned by ``step`` px
    per frame along both axes."""
    import scipy.ndimage as ndi
    rng = np.random.default_rng(seed)
    tex = ndi.gaussian_filter(rng.standard_normal((h + n * step,
                                                   w + n * step)), 2.0)
    tex = ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.uint8)
    return np.stack([tex[i * step:i * step + h, i * step:i * step + w]
                     for i in range(n)])


FARNEBACK_SETTINGS = {"defaults": {}, "fastest": dict(fb_downscale=4,
                                                      fb_iterations=2),
                      "select-warp": dict(fb_select_warp=16)}


@pytest.mark.parametrize("setting", list(FARNEBACK_SETTINGS))
def test_farneback_engine_matches_jax(setting):
    """A Farneback frame source over ``CvFlowConfig()`` and two of its
    knobs through both Engines, one frame at a time: the exported flows
    within 60 dB PSNR at an 8 px peak of JAX's (measured 140-148 dB), the
    frames equal but for flows that round apart at a .5 edge (<= 1 % of
    pixels; measured equal), the keys equal."""
    h, w = 64, 96
    video = _gray_video(5, h, w)
    settings = FARNEBACK_SETTINGS[setting]
    eng, jeng = _engines(
        dict(reset_mode="random", reset_random_factor=0.05),
        dict(direction="backward", seed=0),
        [(_source(base, video, "frame", cv.CvFlowConfig(**settings)),
          _source(jbase, video, "frame", jcv.CvFlowConfig(**settings)))],
        h=h, w=w)
    pix = _pixmap(h, w)
    for idx, (item, jitem) in enumerate(zip(eng.runtimes[0].source,
                                            jeng.runtimes[0].source)):
        frame, flow = eng.process_frame([item], ((torch.from_numpy(pix),),),
                                        idx / FPS, ((idx,),))
        jframe, jflow = jeng.process_frame([jitem], ((jnp.asarray(pix),),),
                                           idx / FPS, ((idx,),))
        jflow = np.asarray(jflow)
        mse = float(np.mean((flow.numpy() - jflow) ** 2))
        assert mse == 0 or 10 * np.log10(64.0 / mse) >= 60.0, idx
        assert np.abs(jflow).max() > 1.0      # the pan is found
        differ = (frame.numpy() != np.asarray(jframe)).any(axis=-1).mean()
        assert differ <= 0.01, idx
    np.testing.assert_array_equal(eng.key,
                                  np.asarray(jax.random.key_data(jeng.key)))


def test_farneback_chunk_equals_frames():
    """``process_chunk`` equals the same frames one by one, the warm start
    (prev_flow) and random reset included."""
    video = _gray_video(6, 64, 96, seed=2)
    runs = []
    for _ in range(2):
        src = _source(base, video, "frame",
                      cv.CvFlowConfig(fb_flags=4 | 256))
        lp = core.make_layer_params(
            [config.LayerConfig(0, reset_mode="random",
                                reset_random_factor=0.2)], 64, 96,
            {0: [(3, None)]}, device="cpu")
        eng = engine.Engine(config.Config("in.mp4", direction="backward",
                                          seed=5), [src], lp, 64, 96,
                            export_flows=True, device="cpu")
        eng._framerate = FPS
        runs.append(eng)
    chunked, stepped = runs
    items = list(chunked.runtimes[0].source)
    pix = torch.from_numpy(_pixmap(64, 96))
    chunked.runtimes[0].reset(items[0].prime)
    frames, flows = chunked.process_chunk(
        [np.stack([it.array for it in items])], ((pix,),), ((None,),), 1, 1)
    for k, item in enumerate(items):
        frame, flow = stepped.process_frame([item], ((pix,),),
                                            (1 + k) / FPS, ((1 + k,),))
        assert torch.equal(frames[k], frame)
        assert torch.equal(flows[k], flow)
    _assert_engines_equal(chunked, stepped)
    assert torch.equal(chunked.runtimes[0].prev_flow,
                       stepped.runtimes[0].prev_flow)


CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "configs")
# the presets of the secondary estimators, with their flow bars against
# JAX: Horn-Schunck 1e-5 (1e-4 where horn-schunck-diverge's alpha 0.01
# amplifies a rounding, tests/test_torch_horn_schunck.py), Lucas-Kanade
# 1e-4 (tests/test_torch_lucas_kanade.py)
CLASSIC_PRESETS = {"horn-schunck.json": 1e-5,
                   "horn-schunck-diverge.json": 1e-4,
                   "horn-schunck-smooth-inertia.json": 1e-5,
                   "lukas-kanade.json": 1e-4, "lk16.json": 1e-4}


@pytest.mark.parametrize("preset", list(CLASSIC_PRESETS))
def test_classic_engine_matches_jax(preset):
    """A frame source over each Horn-Schunck and Lucas-Kanade preset
    through both Engines, one frame at a time (Horn-Schunck's warm start
    carried between frames): the exported flows within the estimator's
    bar of JAX's (4 ulp beyond ~100 px); then JAX's exported flows through
    the port's Engine over a flow source: JAX's frames bit for bit."""
    h, w = 64, 96
    video = _gray_video(5, h, w)
    with open(os.path.join(CONFIGS, preset), encoding="utf8") as file:
        settings = json.load(file)
    layer = dict(reset_mode="random", reset_random_factor=0.05)
    cfg = dict(direction="backward", seed=0)
    eng, jeng = _engines(
        layer, cfg,
        [(_source(base, video, "frame", cv.CvFlowConfig(**settings)),
          _source(jbase, video, "frame", jcv.CvFlowConfig(**settings)))],
        h=h, w=w)
    pix = _pixmap(h, w)
    jframes, jflows = [], []
    for idx, (item, jitem) in enumerate(zip(eng.runtimes[0].source,
                                            jeng.runtimes[0].source)):
        _, flow = eng.process_frame([item], ((torch.from_numpy(pix),),),
                                    idx / FPS, ((idx,),))
        jframe, jflow = jeng.process_frame([jitem], ((jnp.asarray(pix),),),
                                           idx / FPS, ((idx,),))
        np.testing.assert_allclose(flow.numpy(), np.asarray(jflow),
                                   atol=CLASSIC_PRESETS[preset],
                                   rtol=2.0 ** -21, err_msg=str(idx))
        jframes.append(np.asarray(jframe))
        jflows.append(np.array(jflow))
    assert len(jflows) == 4 and np.abs(jflows[-1]).max() > 1.0
    jflows = np.stack(jflows)
    eng, _ = _engines(layer, cfg, [(_source(base, jflows, "flow"),
                                    _source(jbase, jflows, "flow"))],
                      h=h, w=w)
    for idx, item in enumerate(eng.runtimes[0].source):
        frame, _ = eng.process_frame([item], ((torch.from_numpy(pix),),),
                                     idx / FPS, ((idx,),))
        np.testing.assert_array_equal(frame.numpy(), jframes[idx])


def _lfn_engine(video, seed=5, reset=0.2):
    src = _source(base, video, "frame",
                  cv.CvFlowConfig(method="liteflownet", lfn_warp_bound=8))
    h, w = video.shape[1:3]
    lp = core.make_layer_params(
        [config.LayerConfig(0, reset_mode="random",
                            reset_random_factor=reset)], h, w,
        {0: [(3, None)]}, device="cpu")
    eng = engine.Engine(config.Config("in.mp4", direction="backward",
                                      seed=seed), [src], lp, h, w,
                        export_flows=True, device="cpu")
    eng._framerate = FPS
    return eng


def _assert_engines_equal(a, b):
    for layer_a, layer_b in zip(a.comp_state, b.comp_state):
        for key in layer_a:
            assert torch.equal(layer_a[key], layer_b[key]), key
    np.testing.assert_array_equal(a.key, b.key)


def test_chunk_equals_frames_with_random_reset(random_weights):
    video = _video(6, 64, 96, seed=2)
    chunked, stepped = _lfn_engine(video), _lfn_engine(video)
    items = list(chunked.runtimes[0].source)
    pix = torch.from_numpy(_pixmap(64, 96))
    chunked.runtimes[0].reset(items[0].prime)
    frames, flows = chunked.process_chunk(
        [np.stack([it.array for it in items])], ((pix,),), ((None,),), 1, 1)
    for k, item in enumerate(items):
        frame, flow = stepped.process_frame([item], ((pix,),),
                                            (1 + k) / FPS, ((1 + k,),))
        assert torch.equal(frames[k], frame)
        assert torch.equal(flows[k], flow)
    _assert_engines_equal(chunked, stepped)
    assert torch.equal(chunked.runtimes[0].last_raw,
                       stepped.runtimes[0].last_raw)
    assert torch.equal(chunked.runtimes[0].prev_gray,
                       stepped.runtimes[0].prev_gray)


def test_state_arrays_match_jax_names_and_dtypes():
    flows = _flows(2)
    eng, jeng = _engines(dict(reset_mode="random"),
                         dict(direction="backward", seed=0),
                         [(_source(base, flows, "flow"),
                           _source(jbase, flows, "flow"))])
    arrays = eng.state_arrays()
    jarrays = jeng.state_arrays()
    layers = {k: (v.dtype, v.shape) for k, v in arrays.items()
              if k.startswith("layer")}
    jlayers = {k: (v.dtype, v.shape) for k, v in jarrays.items()
               if k.startswith("layer")}
    assert layers == jlayers and len(layers) == 5
    assert set(arrays) - set(layers) == {engine.RNG_STATE_KEY}
    assert set(jarrays) - set(jlayers) == {"rng_key"}
    key, jkey = arrays["rng_key"], jarrays["rng_key"]
    assert key.dtype == jkey.dtype and key.shape == jkey.shape
    np.testing.assert_array_equal(key, jkey)


def test_checkpoint_resume_is_bit_equal(random_weights, tmp_path):
    video = _video(7, 64, 96, seed=3)
    pix = ((torch.from_numpy(_pixmap(64, 96)),),)
    whole = _lfn_engine(video)
    items = list(whole.runtimes[0].source)
    outs = [whole.process_frame([it], pix, k / FPS, ((k,),))[0]
            for k, it in enumerate(items)]
    first = _lfn_engine(video)
    for k, item in enumerate(items[:3]):
        first.process_frame([item], pix, k / FPS, ((k,),))
    path = tmp_path / "ckpt.npz"
    np.savez(path, **first.state_arrays())
    resumed = _lfn_engine(video, seed=99)     # the key loads
    resumed.load_state_arrays(dict(np.load(path)))
    resumed.runtimes[0].reset(items[2].array)
    for k, item in enumerate(items[3:], start=3):
        frame, _ = resumed.process_frame([item], pix, k / FPS, ((k,),))
        assert torch.equal(frame, outs[k]), k
    _assert_engines_equal(resumed, whole)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_checkpoints_cross_load(direction):
    """A checkpoint written by either package resumes in the other: after
    loading it, the reader renders the writer's following frames bit for
    bit, random resets included (the key travels as ``rng_key``)."""
    flows = _flows(8)
    eng, jeng = _engines(dict(reset_mode="random", reset_random_factor=0.3,
                              moving_pixels_leave_empty_spot=True),
                         dict(direction="backward", seed=3),
                         [(_source(base, flows, "flow"),
                           _source(jbase, flows, "flow"))])
    pix = _pixmap(H, W)
    tpix, jpix = ((pix,),), ((jnp.asarray(pix),),)
    head, tail = flows[:4], flows[4:]
    # the writer runs the head; the reader other frames, so its key and
    # state differ until it loads the checkpoint
    if direction == "jax-to-port":
        jeng.process_chunk([head], jpix, ((None,),), 0, 0)
        eng.process_chunk([flows[::-1][:3].copy()], tpix, ((None,),), 0, 0)
        eng.load_state_arrays(jeng.state_arrays())
    else:
        eng.process_chunk([head], tpix, ((None,),), 0, 0)
        jeng.process_chunk([flows[::-1][:3].copy()], jpix, ((None,),), 0, 0)
        jeng.load_state_arrays(eng.state_arrays())
    _assert_states_equal(eng.comp_state, jeng.comp_state)
    frames, _ = eng.process_chunk([tail], tpix, ((None,),), 4, 4)
    jframes, _ = jeng.process_chunk([tail], jpix, ((None,),), 4, 4)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    _assert_states_equal(eng.comp_state, jeng.comp_state)
    np.testing.assert_array_equal(eng.key,
                                  np.asarray(jax.random.key_data(jeng.key)))


def test_legacy_generator_state_is_ignored(caplog):
    """An earlier port's checkpoint holds a torch generator state instead
    of ``rng_key``: its compositor leaves load, the key stays, and a
    warning says so."""
    flows = _flows(2)
    eng, _ = _engines(dict(reset_mode="linear"),
                      dict(direction="backward", seed=0),
                      [(_source(base, flows, "flow"),
                        _source(jbase, flows, "flow"))])
    arrays = eng.state_arrays()
    key = arrays.pop(engine.RNG_STATE_KEY)
    arrays["torch_generator_state"] = torch.Generator().get_state().numpy()
    arrays["layer0.alpha"] = np.zeros_like(arrays["layer0.alpha"])
    eng.key = np.array([1, 2], np.uint32)
    with caplog.at_level(logging.WARNING, logger=engine.__name__):
        eng.load_state_arrays(arrays)
    assert "torch_generator_state" in caplog.text
    np.testing.assert_array_equal(eng.key, [1, 2])
    assert not eng.comp_state[0]["alpha"].any()
    assert key.dtype == np.uint32


# ---------------------------------------------------------------------------
# SourceRuntime: replay and live re-tuning (ports of tests/test_engine.py)
# ---------------------------------------------------------------------------

def _runtime(h=64, w=96):
    config_ = cv.CvFlowConfig(method="liteflownet")
    source = _source(base, _video(2, h, w), "frame", config_)
    step = engine.make_estimator_step("liteflownet",
                                      config_.estimator_kwargs(),
                                      source.direction, device="cpu")
    return engine.SourceRuntime(source, step, device="cpu"), config_


def test_rejit_only_on_version_bump(random_weights):
    runtime, config_ = _runtime()
    original = runtime.estimator_step
    runtime._maybe_rejit()
    assert runtime.estimator_step is original
    config_.update("lfn_warp_bound", 8)  # bumps version
    runtime._maybe_rejit()
    assert runtime.estimator_step is not original
    assert runtime.estimator_step.params is original.params
    rebuilt = runtime.estimator_step
    runtime._maybe_rejit()
    assert runtime.estimator_step is rebuilt


def test_rejit_changes_estimation(random_weights):
    runtime, config_ = _runtime()
    video = _video(2, 64, 96, seed=4)
    runtime.reset(video[0])
    flow1 = runtime.ingest(base.FlowItem(base.FlowItem.FRAME, video[1]))
    config_.update("lfn_scale", 0.5)
    runtime.reset(video[0])
    flow2 = runtime.ingest(base.FlowItem(base.FlowItem.FRAME, video[1]))
    assert flow1.shape == flow2.shape == (64, 96, 2)
    assert not torch.equal(flow1, flow2)


def test_replay_before_first_flow_raises(random_weights):
    runtime, _ = _runtime()
    with pytest.raises(RuntimeError, match="Lock replay"):
        runtime.ingest(base.FlowItem(base.FlowItem.REPLAY, locked=True))


def test_replay_returns_last_flow_and_advances_discarded(random_weights):
    runtime, _ = _runtime()
    video = _video(3, 64, 96, seed=1)
    runtime.reset(video[0])
    flow_b = runtime.ingest(base.FlowItem(base.FlowItem.FRAME, video[1]))
    # lock skip: the discarded frame advances prev_gray, output replays
    replay = runtime.ingest(base.FlowItem(
        base.FlowItem.REPLAY, locked=True,
        discarded=base.FlowItem(base.FlowItem.FRAME, video[2])))
    assert torch.equal(replay, flow_b)
    np.testing.assert_array_equal(runtime.prev_gray.numpy(), video[2])


@pytest.mark.parametrize("direction", [Direction.FORWARD, Direction.BACKWARD])
def test_estimator_step_frame_order(direction, monkeypatch):
    """Forward pairs (prev, next), backward pairs (next, prev)."""
    monkeypatch.setattr(engine, "get_estimator",
                        lambda method: lambda left, right, **kw: (left,
                                                                  right))
    step = engine.make_estimator_step("lukas-kanade", {}, direction,
                                      device="cpu")
    assert step.params == ()
    want = ("prev", "next") if direction == Direction.FORWARD \
        else ("next", "prev")
    assert step("prev", "next", None) == want


# ---------------------------------------------------------------------------
# renderers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scale,colors", [(1.0, None), (0.3, None),
                                          (2.5, ("#123456", "#fedcba",
                                                 "#00ff80", "#808080"))],
                         ids=["default", "scaled", "colors"])
def test_renderers_match_jax(scale, colors):
    flow = (3 * np.random.default_rng(7).standard_normal((20, 30, 2))) \
        .astype(np.float32)
    tflow, jflow = torch.from_numpy(flow), jnp.asarray(flow)
    np.testing.assert_array_equal(
        render.render2d(tflow, scale, colors).numpy(),
        np.asarray(jrender.render2d(jflow, scale, colors)))
    # XLA's CPU backend fuses the square-sum into a multiply-add: 1 ulp
    mag = render.flow_magnitude(tflow)
    np.testing.assert_allclose(mag.numpy(),
                               np.asarray(jrender.flow_magnitude(jflow)),
                               rtol=2.4e-7, atol=0)
    colors_1d = None if colors is None else colors[:2]
    for binary in (False, True):
        got = render.render1d(mag, scale, colors_1d, binary)
        want = jrender.render1d(jnp.asarray(mag.numpy()), scale, colors_1d,
                                binary)
        assert got.dtype == torch.uint8 and got.shape == (20, 30, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# post-processing, merges and every layer class through the Engine
# ---------------------------------------------------------------------------

# two dyadic taps: one rounding per output, whatever the order of sums, so
# F.conv2d and XLA's convolution agree bit for bit on any flow
TWO_TAP_KERNEL = np.array([[0, 0, 0], [0, 0.5, 0.25], [0, 0, 0]], np.float32)


@pytest.fixture(scope="module")
def layer_files(tmp_path_factory):
    """A fractional PGM mask (a wrapped gradient) and the kernel .npy."""
    from transflow_tpu_torch.utils.imageio import write_netpbm
    root = tmp_path_factory.mktemp("engine_files")
    ii, jj = np.indices((H, W))
    write_netpbm(str(root / "gradient.pgm"),
                 ((ii * 9 + jj * 5) % 256).astype(np.uint8))
    np.save(root / "kernel.npy", TWO_TAP_KERNEL)
    return {"gradient": str(root / "gradient.pgm"),
            "kernel": str(root / "kernel.npy")}


def _flow_sources(flows_list, direction="backward", **kwargs):
    """(port, JAX) stub flow sources over each flows array."""
    pairs = []
    for flows in flows_list:
        pair = (_source(base, flows, "flow", **kwargs),
                _source(jbase, flows, "flow", **kwargs))
        pair[0].direction = Direction.from_arg(direction)
        pair[1].direction = jbase.Direction.from_arg(direction)
        pairs.append(pair)
    return pairs


def _layered_engines(layers: list[dict], sources_by_layer: dict,
                     cfg_kwargs: dict, sources):
    """(port Engine, JAX Engine) with one layer per dict of ``layers``."""
    lp = core.make_layer_params(
        [config.LayerConfig(i, **k) for i, k in enumerate(layers)], H, W,
        sources_by_layer, device="cpu")
    jlp = jcore.make_layer_params(
        [jconfig.LayerConfig(i, **k) for i, k in enumerate(layers)], H, W,
        sources_by_layer)
    eng = engine.Engine(config.Config("in.mp4", **cfg_kwargs),
                        [s for s, _ in sources], lp, H, W,
                        export_flows=True, device="cpu")
    jeng = jengine.Engine(jconfig.Config("in.mp4", **cfg_kwargs),
                          [j for _, j in sources], jlp, H, W,
                          export_flows=True)
    eng._framerate = jeng._framerate = FPS
    return eng, jeng


def _pixmap_trees(params, seed=4):
    rng = np.random.default_rng(seed)
    pix = tuple(tuple(rng.integers(0, 256, (H, W, c), dtype=np.uint8)
                      for c in p.channel_counts) for p in params)
    return (pix, tuple(tuple(jnp.asarray(x) for x in layer)
                       for layer in pix))


def _run_engines(eng, jeng, flows_list, path: str):
    """Both Engines over the flows, by chunk or frame by frame; returns
    (frames, flows, JAX frames, JAX flows) as numpy."""
    pix, jpix = _pixmap_trees(eng.layer_params)
    if path == "chunk":
        slots = tuple((None,) * len(layer) for layer in pix)
        frames, out = eng.process_chunk(list(flows_list), pix, slots, 0, 0)
        jframes, jout = jeng.process_chunk(list(flows_list), jpix, slots,
                                           0, 0)
        return (frames.numpy(), out.numpy(), np.asarray(jframes),
                np.asarray(jout))
    tpix = tuple(tuple(torch.from_numpy(x) for x in layer) for layer in pix)
    got, jgot = [], []
    items = zip(*[rt.source for rt in eng.runtimes])
    jitems = zip(*[rt.source for rt in jeng.runtimes])
    for idx, (its, jits) in enumerate(zip(items, jitems)):
        numbers = tuple((idx,) * len(layer) for layer in pix)
        got.append(eng.process_frame(list(its), tpix, idx / FPS, numbers))
        jgot.append(jeng.process_frame(list(jits), jpix, idx / FPS,
                                       numbers))
    return (np.stack([f.numpy() for f, _ in got]),
            np.stack([f.numpy() for _, f in got]),
            np.stack([np.asarray(f) for f, _ in jgot]),
            np.stack([np.asarray(f) for _, f in jgot]))


@pytest.mark.parametrize("path", ["chunk", "frame"])
def test_forward_mask_kernel_filters_engine_matches_jax(path, layer_files):
    """``-d forward``, a DSL ``--mask``, a dyadic ``--kernel`` and the
    scale/threshold/clip filters on a flow source: frames and flows
    bit-equal to the JAX Engine's."""
    flows = _flows(6, seed=2) * 1.7
    sources = _flow_sources(
        [flows], "forward", mask_path="circle:45%",
        kernel_path=layer_files["kernel"],
        flow_filters="scale=1.5;threshold=1;clip=5+np.sin(t)")
    eng, jeng = _layered_engines(
        [dict(reset_mode="random", reset_random_factor=0.1)],
        {0: [(3, None)]}, dict(direction="forward", seed=1), sources)
    frames, out, jframes, jout = _run_engines(eng, jeng, [flows], path)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(frames, jframes)
    _assert_states_equal(eng.comp_state, jeng.comp_state)
    assert np.abs(out).max() > 1            # the forward mapping moves


@pytest.mark.parametrize("name", ["first", "sum", "average", "difference",
                                  "product", "maskbin", "masklin",
                                  "absmax"])
def test_merges_engine_matches_jax(name):
    """Two flow sources under each merge: bit-equal to the JAX Engine."""
    a, b = _flows(6, seed=3), _flows(6, seed=4) * 0.5
    sources = _flow_sources([a, b])
    eng, jeng = _layered_engines(
        [dict(reset_mode="linear", moving_pixels_leave_empty_spot=True)],
        {0: [(3, None)]},
        dict(direction="backward", seed=2, flows_merging_function=name),
        sources)
    frames, out, jframes, jout = _run_engines(eng, jeng, [a, b], "chunk")
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(frames, jframes)


def _all_layers(files):
    """introduction, sum, static and moveref, each with all four layer
    masks, and ``-i`` introduction masks on two sources."""
    masks = dict(mask_src="rect:80%:70%", mask_dst="circle:45%:inv",
                 reset_mask=files["gradient"])
    # a 3-channel pixmap's alpha is 0 or 1: the fractional alpha mask
    # hides it, a 0/1 one shows part of it
    layers = [dict(classname="introduction", mask_alpha=files["gradient"],
                   moving_pixels_leave_empty_spot=True, **masks),
              dict(classname="sum", reset_mode="random",
                   reset_random_factor=0.2, mask_alpha="rect:90%:90%",
                   **masks),
              dict(classname="static", mask_alpha="border:5", **masks),
              dict(reset_mode="constant", reset_constant_step=1.5,
                   mask_alpha="circle:35%",
                   moving_pixels_leave_empty_spot=True, **masks)]
    left = np.zeros((H, W), bool)
    left[:, :W // 3] = True
    sources_by_layer = {0: [(3, left), (4, ~left)], 1: [(3, None)],
                        2: [(4, np.indices((H, W))[0] > H // 2)],
                        3: [(3, None), (3, left)]}
    return layers, sources_by_layer


@pytest.mark.parametrize("path", ["chunk", "frame"])
def test_every_layer_class_engine_matches_jax(path, layer_files):
    flows = _flows(6, seed=5)
    sources = _flow_sources([flows])
    layers, by_layer = _all_layers(layer_files)
    eng, jeng = _layered_engines(layers, by_layer,
                                 dict(direction="backward", seed=3), sources)
    frames, _, jframes, _ = _run_engines(eng, jeng, [flows], path)
    np.testing.assert_array_equal(frames, jframes)
    _assert_states_equal(eng.comp_state, jeng.comp_state)


def test_polar_filter_engine_within_bound():
    """``polar``: transcendental functions in float32 on each side, so
    the post-processed flows agree within 8 ulps of their radius
    (tests/test_torch_postprocess.py holds the filter to 4)."""
    flows = _flows(4, seed=6)
    text = "polar=r:a+0.1*t"
    sources = _flow_sources([flows], flow_filters=text)
    eng, jeng = _layered_engines([{}], {0: [(3, None)]},
                                 dict(direction="backward", seed=4), sources)
    _, out, _, jout = _run_engines(eng, jeng, [flows], "frame")
    radius = np.linalg.norm(jout, axis=-1, keepdims=True)
    assert (np.abs(out - jout) <= 8 * np.spacing(radius)).all()


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_every_layer_class_checkpoint_cross_loads(direction, layer_files):
    """Checkpoints of the four classes (int32 sum positions, the 0-d bool
    ``introduced_once``) written by either package resume in the other:
    the reader renders the writer's following frames bit for bit."""
    flows = _flows(8, seed=7)
    layers, by_layer = _all_layers(layer_files)
    eng, jeng = _layered_engines(layers, by_layer,
                                 dict(direction="backward", seed=5),
                                 _flow_sources([flows]))
    pix, jpix = _pixmap_trees(eng.layer_params)
    slots = tuple((None,) * len(layer) for layer in pix)
    head, tail = flows[:4], flows[4:]
    if direction == "jax-to-port":
        jeng.process_chunk([head], jpix, slots, 0, 0)
        eng.load_state_arrays(jeng.state_arrays())
    else:
        eng.process_chunk([head], pix, slots, 0, 0)
        jeng.load_state_arrays(eng.state_arrays())
    arrays = eng.state_arrays()
    assert arrays["layer1.pos_i"].dtype == np.int32
    assert arrays["layer0.introduced_once"].shape == ()
    assert arrays["layer0.introduced_once"].dtype == np.bool_
    _assert_states_equal(eng.comp_state, jeng.comp_state)
    frames, _ = eng.process_chunk([tail], pix, slots, 4, 4)
    jframes, _ = jeng.process_chunk([tail], jpix, slots, 4, 4)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    _assert_states_equal(eng.comp_state, jeng.comp_state)

"""The port's FlowTransferModel against the JAX package's, and the port's
import boundary.

Random LiteFlowNet weights (the same in both packages) give sub-pixel
flows, so this checks the estimator inside the step and the step's
plumbing; tests/test_torch_compositor.py carries the motion.
"""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_engine import _gray_video
from transflow_tpu.config import LayerConfig as JaxLayerConfig
from transflow_tpu import flow as jflow
from transflow_tpu.flow.estimators import liteflownet as jlfn
from transflow_tpu.model import FlowTransferModel as JaxModel
from transflow_tpu.ops.image import upscale_flow as jax_upscale_flow
from transflow_tpu_torch import flow, prng
from transflow_tpu_torch.config import Config, LayerConfig
from transflow_tpu_torch.engine import Engine
from transflow_tpu_torch.flow import Direction
from transflow_tpu_torch.model import FlowTransferModel
from transflow_tpu_torch.ops.image import upscale_flow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96
FRAMES = 4
# f32 network on both sides (tests/test_torch_liteflownet.py's bar)
FLOW_TOL = 1e-3


@pytest.fixture
def random_weights(monkeypatch):
    monkeypatch.setenv("TRANSFLOW_LITEFLOWNET_RANDOM", "1")
    monkeypatch.delenv(jlfn.WEIGHTS_ENV, raising=False)
    monkeypatch.delenv("TRANSFLOW_LITEFLOWNET_BF16", raising=False)
    monkeypatch.setattr(jlfn, "_CACHE", {})


def _frames(n, h=H, w=W, step=2):
    """(n, h, w, 3) uint8: a random texture panned by ``step`` px/frame."""
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 256, (h + n * step, w + n * step, 3),
                          dtype=np.uint8)
    return np.stack([canvas[i * step:i * step + h, i * step:i * step + w]
                     for i in range(n)])


def test_model_matches_jax(random_weights):
    frames = _frames(FRAMES + 1)
    layers = [dict(reset_mode="random", reset_random_factor=0.2)]
    jmodel = JaxModel(H, W, [JaxLayerConfig(0, **layers[0])],
                      method="liteflownet")
    model = FlowTransferModel(H, W, [LayerConfig(0, **layers[0])],
                              method="liteflownet", device="cpu")
    jstate = jmodel.init_state(frames[0])
    state = model.init_state(torch.from_numpy(frames[0]))
    jpix, pix = jmodel.default_pixmaps(), model.default_pixmaps()
    for a, b in zip(jpix[0], pix[0]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jkeys = jax.random.split(jax.random.key(0), FRAMES)
    keys = prng.split(prng.key(0), FRAMES)
    np.testing.assert_array_equal(keys, np.asarray(jax.random.key_data(jkeys)))
    for idx in range(1, FRAMES + 1):
        t = idx / 30.0
        jstate, jrgb = jmodel.step(jstate, jnp.asarray(frames[idx]), jpix,
                                   jnp.float32(t), jkeys[idx - 1],
                                   jmodel.default_frame_numbers())
        state, rgb = model.step(state, torch.from_numpy(frames[idx]), pix,
                                t, keys[idx - 1],
                                model.default_frame_numbers())
        np.testing.assert_allclose(state["prev_flow"].numpy(),
                                   np.asarray(jstate["prev_flow"]),
                                   atol=FLOW_TOL, rtol=FLOW_TOL)
        assert rgb.dtype == torch.uint8 and rgb.shape == (H, W, 3)
        # a flow at a rounding edge (.5) may round apart: <= 1% of pixels
        differ = (rgb.numpy() != np.asarray(jrgb)).any(axis=-1).mean()
        assert differ <= 0.01


def test_scan_equals_steps(random_weights):
    frames = torch.from_numpy(_frames(FRAMES + 1))
    model = FlowTransferModel(
        H, W, [LayerConfig(0, reset_mode="random", reset_random_factor=0.2)],
        method="liteflownet", width_factor=2, device="cpu")
    pix = model.default_pixmaps()
    state_a, rgbs = model.scan(model.init_state(frames[0]), frames[1:], pix,
                               0.0, prng.key(3))
    state_b = model.init_state(frames[0])
    keys = prng.split(prng.key(3), FRAMES)     # model.py:183
    for idx in range(FRAMES):
        state_b, rgb = model.step(state_b, frames[idx + 1], pix, idx / 30.0,
                                  keys[idx], model.default_frame_numbers(idx))
        assert torch.equal(rgbs[idx], rgb)
    assert rgbs.shape == (FRAMES, H, 2 * W, 3)
    assert torch.equal(state_a["prev_flow"], state_b["prev_flow"])
    for key, value in state_a["comp"][0].items():
        assert torch.equal(value, state_b["comp"][0][key]), key


def test_upscale_flow_matches_jax():
    flow = np.random.default_rng(1).standard_normal((5, 7, 2)) \
        .astype(np.float32)
    got = upscale_flow(torch.from_numpy(flow), 3, 2)
    want = np.asarray(jax_upscale_flow(jnp.asarray(flow), 3, 2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_farneback_model_matches_jax(monkeypatch):
    """``FlowTransferModel(method="farneback")`` against the JAX model:
    no network is loaded; the raw flows (warm-started with flag 4) within
    60 dB PSNR at an 8 px peak of JAX's (measured 147 dB), the frames
    equal but for flows that round apart at a .5 edge (<= 1 % of pixels;
    measured equal)."""
    from transflow_tpu_torch.flow.estimators import liteflownet

    def no_weights(*args, **kwargs):
        raise AssertionError("Farneback loaded LiteFlowNet's weights")

    monkeypatch.setattr(liteflownet, "get_weights", no_weights)
    frames = _gray_video(FRAMES + 1, H, W, seed=1)
    layers = [dict(reset_mode="random", reset_random_factor=0.2)]
    kwargs = dict(method="farneback", estimator_kwargs=dict(flags=4))
    jmodel = JaxModel(H, W, [JaxLayerConfig(0, **layers[0])], **kwargs)
    model = FlowTransferModel(H, W, [LayerConfig(0, **layers[0])],
                              device="cpu", **kwargs)
    assert model.net is None
    jstate = jmodel.init_state(frames[0])
    state = model.init_state(torch.from_numpy(frames[0]))
    jpix, pix = jmodel.default_pixmaps(), model.default_pixmaps()
    jkeys = jax.random.split(jax.random.key(0), FRAMES)
    keys = prng.split(prng.key(0), FRAMES)
    for idx in range(1, FRAMES + 1):
        jstate, jrgb = jmodel.step(jstate, jnp.asarray(frames[idx]), jpix,
                                   jnp.float32(idx / 30.0), jkeys[idx - 1],
                                   jmodel.default_frame_numbers())
        state, rgb = model.step(state, torch.from_numpy(frames[idx]), pix,
                                idx / 30.0, keys[idx - 1],
                                model.default_frame_numbers())
        want = np.asarray(jstate["prev_flow"])
        mse = float(np.mean((state["prev_flow"].numpy() - want) ** 2))
        assert mse == 0 or 10 * np.log10(64.0 / mse) >= 60.0, idx
        assert np.abs(want).max() > 1.0       # the pan is found
        differ = (rgb.numpy() != np.asarray(jrgb)).any(axis=-1).mean()
        assert differ <= 0.01, idx


@pytest.mark.parametrize("kwargs", [{"method": "horn-schunck"}],
                         ids=["horn-schunck"])
def test_unported_options_raise(random_weights, kwargs):
    """An option an earlier port refused, now ported: the model with
    Horn-Schunck at its defaults against the JAX model over a few steps
    (warm start, early stop on the device): no network is loaded, the raw
    flows within 1e-5 of JAX's (tests/test_torch_horn_schunck.py's bar),
    the frames equal but for flows that round apart at a .5 edge (<= 1 %
    of pixels)."""
    frames = _gray_video(FRAMES + 1, H, W, seed=2)
    layers = [dict(reset_mode="random", reset_random_factor=0.2)]
    jmodel = JaxModel(H, W, [JaxLayerConfig(0, **layers[0])], **kwargs)
    model = FlowTransferModel(H, W, [LayerConfig(0, **layers[0])],
                              device="cpu", **kwargs)
    assert model.net is None
    jstate = jmodel.init_state(frames[0])
    state = model.init_state(torch.from_numpy(frames[0]))
    jpix, pix = jmodel.default_pixmaps(), model.default_pixmaps()
    jkeys = jax.random.split(jax.random.key(0), FRAMES)
    keys = prng.split(prng.key(0), FRAMES)
    for idx in range(1, FRAMES + 1):
        jstate, jrgb = jmodel.step(jstate, jnp.asarray(frames[idx]), jpix,
                                   jnp.float32(idx / 30.0), jkeys[idx - 1],
                                   jmodel.default_frame_numbers())
        state, rgb = model.step(state, torch.from_numpy(frames[idx]), pix,
                                idx / 30.0, keys[idx - 1],
                                model.default_frame_numbers())
        want = np.asarray(jstate["prev_flow"])
        np.testing.assert_allclose(state["prev_flow"].numpy(), want,
                                   atol=1e-5, rtol=0)
        assert np.abs(want).max() > 1.0
        differ = (rgb.numpy() != np.asarray(jrgb)).any(axis=-1).mean()
        assert differ <= 0.01, idx


def _gradient_mask(h=H, w=W):
    ii, jj = np.indices((h, w))
    return ((ii * 7 + jj * 5) % 256 / 255.0).astype(np.float32)


# each an option an earlier port refused, as (port kwargs, JAX kwargs)
MODEL_OPTIONS = {
    "forward": ({"direction": Direction.FORWARD},
                {"direction": jflow.Direction.FORWARD}),
    "filters": ({"flow_filters": "scale=1.5;clip=2"},
                {"flow_filters": "scale=1.5;clip=2"}),
    "mask": ({"mask": _gradient_mask()}, {"mask": _gradient_mask()}),
    "kernel": ({"kernel": np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]],
                                   np.float32) / 8},
               {"kernel": np.array([[0, 1, 0], [1, 4, 1], [0, 1, 0]],
                                   np.float32) / 8}),
    "sum": ({"layer_cfgs": [LayerConfig(0, classname="sum")]},
            {"layer_cfgs": [JaxLayerConfig(0, classname="sum")]}),
    "introduction": (
        {"layer_cfgs": [LayerConfig(0, classname="introduction")]},
        {"layer_cfgs": [JaxLayerConfig(0, classname="introduction")]}),
}


def _quarter_pan_video(n, h=H, w=W, seed=1):
    """(n, h, w) uint8 gray frames of a smooth texture panned by 1.25 px
    per frame along both axes (every 4th sample of a 4x texture moved 5
    samples a frame): flows far from the .5 and integer edges where
    ``round`` and ``floor`` flip."""
    import scipy.ndimage as ndi
    rng = np.random.default_rng(seed)
    tex = ndi.gaussian_filter(rng.standard_normal((4 * h + 5 * n,
                                                   4 * w + 5 * n)), 8.0)
    tex = ((tex - tex.min()) / np.ptp(tex) * 255).astype(np.uint8)
    return np.stack([tex[5 * i:5 * i + 4 * h:4, 5 * i:5 * i + 4 * w:4]
                     for i in range(n)])


@pytest.mark.parametrize("option", list(MODEL_OPTIONS))
def test_model_options_match_jax(option):
    """``FlowTransferModel(method="farneback")`` with an option the port
    once refused, against the JAX model over a 1.25 px pan: the frames
    equal but for flows that round apart at an edge (<= 1 % of pixels, the
    bar of test_farneback_model_matches_jax; measured equal)."""
    frames = _quarter_pan_video(FRAMES + 1)
    kwargs, jkwargs = MODEL_OPTIONS[option]
    common = dict(method="farneback", estimator_kwargs=dict(flags=4))
    jmodel = JaxModel(H, W, **common, **jkwargs)
    model = FlowTransferModel(H, W, device="cpu", **common, **kwargs)
    jstate = jmodel.init_state(frames[0])
    state = model.init_state(torch.from_numpy(frames[0]))
    jpix, pix = jmodel.default_pixmaps(), model.default_pixmaps()
    jkeys = jax.random.split(jax.random.key(0), FRAMES)
    keys = prng.split(prng.key(0), FRAMES)
    moved = 0.0
    for idx in range(1, FRAMES + 1):
        t = np.float32(idx / 30.0)
        jstate, jrgb = jmodel.step(jstate, jnp.asarray(frames[idx]), jpix,
                                   jnp.float32(t), jkeys[idx - 1],
                                   jmodel.default_frame_numbers(idx))
        state, rgb = model.step(state, torch.from_numpy(frames[idx]), pix,
                                t, keys[idx - 1],
                                model.default_frame_numbers(idx))
        differ = (rgb.numpy() != np.asarray(jrgb)).any(axis=-1).mean()
        assert differ <= 0.01, (option, idx, differ)
        moved = max(moved, float(np.abs(np.asarray(jstate["prev_flow"]))
                                 .max()))
    assert moved > 1.0                    # the pan is found


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import neither jax nor
    flax nor the JAX package, and import with none of the libraries its
    routes load where they run (cv2, PIL, aiohttp, websockets, tkinter):
    with each of them and ``transflow_tpu`` blocked in ``sys.modules`` any
    import of one fails. The walk reaches the multi-host layer, the GUI,
    the window, MJPEG and native IO outputs, the tools (the chunk fuzzer
    and the weights check among them), the bench and LiteFlowNet's head
    kernels' module."""
    blocked = ("jax", "flax", "transflow_tpu", "cv2", "PIL", "aiohttp",
               "websockets", "tkinter")
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import transflow_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    transflow_tpu_torch.__path__, 'transflow_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        f"       if m.split('.')[0] in {blocked!r}\n"
        "       and sys.modules[m] is not None]\n"
        "want = {'transflow_tpu_torch.parallel.multihost',\n"
        "        'transflow_tpu_torch.tools.viewflow',\n"
        "        'transflow_tpu_torch.tools.viewflow_player',\n"
        "        'transflow_tpu_torch.tools.control',\n"
        "        'transflow_tpu_torch.gui.server',\n"
        "        'transflow_tpu_torch.gui.tuning',\n"
        "        'transflow_tpu_torch.output.window',\n"
        "        'transflow_tpu_torch.output.mjpeg',\n"
        "        'transflow_tpu_torch.native',\n"
        "        'transflow_tpu_torch.tools.realtime',\n"
        "        'transflow_tpu_torch.tools.list_webcams',\n"
        "        'transflow_tpu_torch.bench',\n"
        "        'transflow_tpu_torch.tools.fuzz_chunks',\n"
        "        'transflow_tpu_torch.tools.verify_weights',\n"
        "        'transflow_tpu_torch.ops.lfn_heads'}\n"
        "print('MODULES', len(names), 'IMPORTED', bad,\n"
        "      'MISSING', want - set(names))\n"
        "sys.exit(1 if bad or want - set(names) or len(names) < 25 else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_layer_config_pinned_to_jax():
    assert LayerConfig._FIELDS == JaxLayerConfig._FIELDS
    assert LayerConfig.CLASSNAMES == JaxLayerConfig.CLASSNAMES
    assert (inspect.signature(LayerConfig.__init__)
            == inspect.signature(JaxLayerConfig.__init__))
    assert vars(LayerConfig(0)) == vars(JaxLayerConfig(0))
    values = {"index": 2, "classname": "moveref", "reset_mode": "random",
              "reset_random_factor": 0.25, "reset_source": "yes",
              "transparent_pixels_can_move": "on",
              "pixels_can_move_to_empty_spot": 0}
    assert (LayerConfig.fromdict(values).todict()
            == JaxLayerConfig.fromdict(values).todict())


@pytest.mark.parametrize("name", ["Direction", "LockMode"])
def test_flow_enums_pinned_to_jax(name):
    """The port's own enums carry the JAX package's names and values, and
    ``from_arg`` reads the same arguments."""
    mine, theirs = getattr(flow, name), getattr(jflow, name)
    assert mine is not theirs
    assert ([(m.name, m.value) for m in mine]
            == [(m.name, m.value) for m in theirs])
    for member in theirs:
        for arg in (member.value, member.name.lower(), None):
            assert mine.from_arg(arg).name == theirs.from_arg(arg).name
    with pytest.raises(ValueError):
        mine.from_arg("sideways")


@pytest.mark.parametrize("entry", ["model", "engine"])
def test_entry_points_need_a_card_by_default(entry, monkeypatch,
                                             random_weights):
    """With no ``device`` the entry points run on the card; without one
    they raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "model":
            FlowTransferModel(H, W, method="liteflownet")
        else:
            Engine(Config("in.mp4"), [], [], H, W)

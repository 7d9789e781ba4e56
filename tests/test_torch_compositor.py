"""The port's compositor against the JAX package's, bit for bit.

Both get the same flows (large integer and half-integer motion, clipped
to the frame) and the same key: the port's ``update`` splits it into
per-layer keys and draws the random reset with ``prng.uniform``, as the
JAX step does with ``jax.random`` (core.py:518, :278).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transflow_tpu.compositor import core as jcore
from transflow_tpu.config import LayerConfig as JaxLayerConfig
from transflow_tpu.flow.transforms import clip_to_frame as jax_clip
from transflow_tpu.ops.scatter import scatter_any as jax_scatter_any
from transflow_tpu.utils import colors as jax_colors
from transflow_tpu_torch.compositor import core
from transflow_tpu_torch.config import LayerConfig
from transflow_tpu_torch.flow.transforms import clip_to_frame
from transflow_tpu_torch.ops.scatter import scatter_any
from transflow_tpu_torch.utils import colors

H, W = 48, 64
FRAMES = 10


def _sources(kind: str):
    left = np.zeros((H, W), bool)
    left[:, :W // 2] = True
    return {"rgb": {0: [(3, None)]},
            "rgba": {0: [(4, None)]},
            "two": {0: [(3, left), (4, ~left)]}}[kind]


def _flows(seed: int):
    """Clipped (H, W, 2) f32 flows as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(FRAMES):
        flow = (rng.integers(-9, 10, (H, W, 2))
                + 0.5 * rng.integers(0, 2, (H, W, 2))).astype(np.float32)
        flow[rng.random((H, W)) < 0.3] = 0.0       # unmoving pixels
        j = jax_clip(jnp.asarray(flow))
        t = clip_to_frame(torch.from_numpy(flow))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        out.append((j, t))
    return out


def _assert_state_equal(port_state: dict, jax_state: dict):
    assert set(port_state) == set(jax_state)
    for key, value in jax_state.items():
        want = np.asarray(value)
        got = port_state[key].numpy()
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def _run_both(cfg_kwargs: dict, sources: str, seed: int = 0):
    srcs = _sources(sources)
    jparams = jcore.make_layer_params([JaxLayerConfig(0, **cfg_kwargs)],
                                      H, W, srcs)
    params = core.make_layer_params([LayerConfig(0, **cfg_kwargs)], H, W,
                                    srcs, device="cpu")
    jinit, jstep = jcore.build_compositor(jparams, H, W, "#204060")
    init, step = core.build_compositor(params, H, W, "#204060",
                                       device="cpu")
    rng = np.random.default_rng(seed + 100)
    pix = [rng.integers(0, 256, (H, W, c), dtype=np.uint8)
           for c in params[0].channel_counts]
    jpix = (tuple(jnp.asarray(p) for p in pix),)
    tpix = tuple(torch.from_numpy(p) for p in pix)
    jstate, state = jinit(), init()
    _assert_state_equal(state[0], jstate[0])
    keys = jax.random.split(jax.random.key(seed), FRAMES)
    numbers = ((0,) * len(pix),)
    for (jflow, flow), key in zip(_flows(seed), keys):
        jstate = jstep.update(jstate, jflow, jpix, key, numbers)
        jstate, jrgb = jstep.render(jstate)
        state = step.update(state, flow, (tpix,),
                            np.asarray(jax.random.key_data(key)), numbers)
        state, rgb = step.render(state)
        _assert_state_equal(state[0], jstate[0])
        np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    return state


MOVEMENT = {
    "default": {},
    "transparent_move": {"transparent_pixels_can_move": True,
                         "moving_pixels_leave_empty_spot": True},
    "not_to_empty": {"pixels_can_move_to_empty_spot": False,
                     "moving_pixels_leave_empty_spot": True},
    "not_to_filled": {"pixels_can_move_to_filled_spot": False,
                      "moving_pixels_leave_empty_spot": True},
    "leave_empty": {"moving_pixels_leave_empty_spot": True},
}
RESETS = {
    "off": {},
    "constant": {"reset_mode": "constant", "reset_constant_step": 2.5},
    "linear": {"reset_mode": "linear", "reset_linear_factor": 0.3},
    "random": {"reset_mode": "random", "reset_random_factor": 0.2},
}


@pytest.mark.parametrize("reset", list(RESETS))
@pytest.mark.parametrize("movement", list(MOVEMENT))
def test_moveref_bit_exact(movement, reset):
    state = _run_both({**MOVEMENT[movement], **RESETS[reset]}, "rgb")
    if movement in ("transparent_move", "not_to_empty", "leave_empty"):
        # the flags only mean something once holes exist
        assert (state[0]["alpha"] == 0).any()


@pytest.mark.parametrize("sources", ["rgb", "rgba", "two"])
@pytest.mark.parametrize("reset", [
    {"reset_mode": "random", "reset_random_factor": 0.1,
     "reset_source": True, "moving_pixels_leave_empty_spot": True},
    {"reset_mode": "linear", "transparent_pixels_can_move": True,
     "moving_pixels_leave_empty_spot": True}], ids=["random", "linear"])
def test_pixmap_layouts_bit_exact(sources, reset):
    _run_both(reset, sources, seed=5)


def test_update_draws_from_the_generator():
    """step_fn draws each layer's random reset from its own split of the
    caller's key, as the JAX step does: two random layers and a linear one
    over four frames, bit-equal to the JAX compositor."""
    cfgs = [LayerConfig(0, reset_mode="random", reset_random_factor=0.3),
            LayerConfig(1, reset_mode="linear"),
            LayerConfig(2, reset_mode="random", reset_random_factor=0.6)]
    srcs = {0: [(3, None)], 1: [(4, None)], 2: [(3, None)]}
    params = core.make_layer_params(cfgs, H, W, srcs, device="cpu")
    jparams = jcore.make_layer_params(
        [JaxLayerConfig(c.index, **{k: v for k, v in vars(c).items()
                                    if k in ("reset_mode",
                                             "reset_random_factor")})
         for c in cfgs], H, W, srcs)
    init, step = core.build_compositor(params, H, W, device="cpu")
    jinit, jstep = jcore.build_compositor(jparams, H, W)
    rng = np.random.default_rng(0)
    pix = [rng.integers(0, 256, (H, W, c), dtype=np.uint8) for c in (3, 4, 3)]
    tpix = tuple((torch.from_numpy(p),) for p in pix)
    jpix = tuple((jnp.asarray(p),) for p in pix)
    numbers = ((0,), (0,), (0,))
    state, jstate = init(), jinit()
    key = jax.random.key(7)
    for jflow, flow in _flows(1)[:4]:
        key, sub = jax.random.split(key)
        state, rgb = step(state, flow, tpix,
                          np.asarray(jax.random.key_data(sub)), numbers)
        jstate, jrgb = jstep(jstate, jflow, jpix, sub, numbers)
        np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
        for layer, jlayer in zip(state, jstate):
            _assert_state_equal(layer, jlayer)
    assert rgb.dtype == torch.uint8 and rgb.shape == (H, W, 3)


def test_scatter_any_matches_jax():
    rng = np.random.default_rng(3)
    idx = rng.integers(-5, H * W + 5, H * W).astype(np.int32)
    mask = rng.random(H * W) < 0.4
    mask &= (idx >= 0) & (idx < H * W)
    want = np.asarray(jax_scatter_any((H, W), jnp.asarray(idx),
                                      jnp.asarray(mask)))
    got = scatter_any((H, W), torch.from_numpy(idx), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_parse_color_matches_jax():
    assert colors.CSS4_COLORS == jax_colors.CSS4_COLORS
    for text in list(jax_colors.CSS4_COLORS) + [
            "#ffffff", "#204060", "0x123456", "abcdef", "rgb(1, 2, 3)",
            "(10,20,30)", "RGB(4,5,6)", "White", "#0f0F0f"]:
        assert colors.parse_color(text) == jax_colors.parse_color(text), text


@pytest.mark.parametrize("cfg_kwargs", [
    {"mask_src": "circle:40%", "moving_pixels_leave_empty_spot": True},
    {"classname": "introduction"},
    {"classname": "sum", "reset_mode": "random", "reset_random_factor": 0.1},
    {"classname": "static"}], ids=["mask_src", "introduction", "sum",
                                   "static"])
def test_layer_classes_and_masks_bit_exact(cfg_kwargs):
    """The options an earlier port refused (a layer mask, the introduction,
    sum and static classes), bit-equal to the JAX compositor;
    tests/test_torch_layers.py holds every class, mask and flag."""
    _run_both(cfg_kwargs, "two", seed=3)

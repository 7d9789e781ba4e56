"""Every layer class of the port's compositor, with every layer mask and
flag, against the JAX package's, bit for bit.

Both compositors get the same clipped flows (large integer and
half-integer motion, unmoving pixels among them), the same pixmaps, frame
numbers and key; the port splits the key and draws the random reset with
``prng`` as the JAX step does with ``jax.random``. Float masks come from a
PGM gradient image (fractional values, so ``mask_alpha``'s product and
``reset_mask``'s threshold round), bool masks from the mask DSL. The mesh
cases run JAX on the virtual CPU mesh of tests/conftest.py, and the port's
compositor as it runs under a mesh, its state whole on one device.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transflow_tpu.compositor import Compositor as JaxCompositor
from transflow_tpu.compositor import core as jcore
from transflow_tpu.config import LayerConfig as JaxLayerConfig
from transflow_tpu.flow.transforms import clip_to_frame as jax_clip
from transflow_tpu.parallel.mesh import make_space_mesh as jax_space_mesh
from transflow_tpu_torch.compositor import Compositor, core
from transflow_tpu_torch.config import LayerConfig
from transflow_tpu_torch.utils.imageio import write_netpbm

H, W = 48, 64
FRAMES = 8


@pytest.fixture(scope="module")
def gradient(tmp_path_factory):
    """A PGM whose luminance ramps across the frame and wraps: mask
    values k/255 for many k."""
    path = tmp_path_factory.mktemp("masks") / "gradient.pgm"
    ii, jj = np.indices((H, W))
    write_netpbm(str(path), ((ii * 7 + jj * 5) % 256).astype(np.uint8))
    return str(path)


def _flows(seed: int, n: int = FRAMES, h: int = H, w: int = W,
           reach: int = 9):
    """(jax, numpy) pairs of clipped (H, W, 2) f32 flows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        flow = (rng.integers(-reach, reach + 1, (h, w, 2))
                + 0.5 * rng.integers(0, 2, (h, w, 2))).astype(np.float32)
        flow[rng.random((h, w)) < 0.3] = 0.0
        clipped = jax_clip(jnp.asarray(flow))
        out.append((clipped, np.array(clipped)))
    return out


def _sources(kind: str, h: int = H, w: int = W):
    left = np.zeros((h, w), bool)
    left[:, :w // 2] = True
    return {"rgb": [(3, None)], "rgba": [(4, None)],
            "two": [(3, left), (4, ~left)]}[kind]


def _assert_state_equal(port_state: dict, jax_state: dict, label=""):
    assert set(port_state) == set(jax_state), label
    for key, value in jax_state.items():
        want = np.asarray(value)
        got = port_state[key].cpu().numpy()
        assert got.dtype == want.dtype, (label, key)
        np.testing.assert_array_equal(got, want, err_msg=f"{label} {key}")


def run_both(cfgs: list[dict], sources: dict, seed: int = 0,
             frames: int = FRAMES, halo=None, n_mesh: int = 0,
             h: int = H, w: int = W, reach: int = 9):
    """Both compositors over ``frames`` flows; asserts states and frames
    equal after each; returns the port's last state."""
    jcfgs = [JaxLayerConfig(i, **c) for i, c in enumerate(cfgs)]
    pcfgs = [LayerConfig(i, **c) for i, c in enumerate(cfgs)]
    jparams = jcore.make_layer_params(jcfgs, h, w, sources)
    params = core.make_layer_params(pcfgs, h, w, sources, device="cpu")
    jmesh = jax_space_mesh(n_mesh) if n_mesh else None
    jinit, jstep = jcore.build_compositor(jparams, h, w, "#204060",
                                          halo=halo, mesh=jmesh)
    init, step = core.build_compositor(params, h, w, "#204060", halo=halo,
                                       device="cpu")
    rng = np.random.default_rng(seed + 100)
    pix = [[rng.integers(0, 256, (h, w, c), dtype=np.uint8)
            for c in p.channel_counts] for p in params]
    jstate, state = jinit(), init()
    for layer, jlayer in zip(state, jstate):
        _assert_state_equal(layer, jlayer, "init")
    keys = jax.random.split(jax.random.key(seed), frames)
    for k, ((jflow, flow), key) in enumerate(zip(_flows(seed, frames, h, w,
                                                        reach), keys)):
        # pixmaps change every frame, as a video source's do
        tpix = tuple(tuple(torch.from_numpy(np.roll(p, k, axis=1))
                           for p in layer) for layer in pix)
        jpix = tuple(tuple(jnp.asarray(np.roll(p, k, axis=1))
                           for p in layer) for layer in pix)
        numbers = tuple(tuple(3 * k + s for s in range(len(layer)))
                        for layer in pix)
        jnumbers = tuple(tuple(jnp.int32(n) for n in layer)
                         for layer in numbers)
        jstate = jstep.update(jstate, jflow, jpix, key, jnumbers)
        jstate, jrgb = jstep.render(jstate)
        state = step.update(state, torch.from_numpy(flow), tpix,
                            np.asarray(jax.random.key_data(key)), numbers)
        state, rgb = step.render(state)
        for layer, jlayer in zip(state, jstate):
            _assert_state_equal(layer, jlayer, f"frame {k}")
        np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb))
    return state


CLASSES = {
    "moveref": {"reset_mode": "random", "reset_random_factor": 0.3,
                "moving_pixels_leave_empty_spot": True},
    "sum": {"classname": "sum", "reset_mode": "linear",
            "reset_linear_factor": 0.3},
    "static": {"classname": "static"},
    "introduction": {"classname": "introduction",
                     "moving_pixels_leave_empty_spot": True},
}


def _masks(kind: str, gradient: str) -> dict:
    return {"none": {},
            "alpha": {"mask_alpha": gradient},
            "src": {"mask_src": "circle:40%"},
            "dst": {"mask_dst": "border:6"},
            "reset": {"reset_mask": gradient},
            "all": {"mask_alpha": gradient, "mask_src": "rect:70%:60%",
                    "mask_dst": "circle:45%:inv", "reset_mask": gradient},
            }[kind]


@pytest.mark.parametrize("masks", ["none", "alpha", "src", "dst", "reset",
                                   "all"])
@pytest.mark.parametrize("classname", list(CLASSES))
def test_layer_class_and_masks_bit_exact(classname, masks, gradient):
    state = run_both([{**CLASSES[classname], **_masks(masks, gradient)}],
                     {0: _sources("two")}, seed=len(masks))
    if classname == "sum":
        assert state[0]["pos_i"].dtype == torch.int32


@pytest.mark.parametrize("mode", [
    {"reset_mode": "random", "reset_random_factor": 0.6},
    {"reset_mode": "constant", "reset_constant_step": 2.5},
    {"reset_mode": "linear", "reset_linear_factor": 0.7}],
    ids=["random", "constant", "linear"])
@pytest.mark.parametrize("classname", ["moveref", "sum"])
def test_reset_modes_under_reset_mask(classname, mode, gradient):
    """The reset factor times a fractional reset mask, in float32 as JAX's
    weak-typed product (TestResetModes of tests/test_compositor.py)."""
    cfg = {"classname": classname, "reset_mask": gradient, **mode}
    run_both([cfg], {0: _sources("rgb")}, seed=4)


INTRO_FLAGS = {
    "default": {},
    "not_on_empty": {"introduce_pixels_on_empty_spots": False},
    "not_on_filled": {"introduce_pixels_on_filled_spots": False},
    "not_moving": {"introduce_moving_pixels": False},
    "not_unmoving": {"introduce_unmoving_pixels": False},
    "once": {"introduce_once": True},
    "all_filled": {"introduce_on_all_filled_spots": True},
    "all_empty": {"introduce_on_all_empty_spots": True},
    "transparent": {"transparent_pixels_can_move": True,
                    "moving_pixels_leave_empty_spot": True},
}


@pytest.mark.parametrize("sources", ["rgb", "rgba", "two"])
@pytest.mark.parametrize("flags", list(INTRO_FLAGS))
def test_introduction_flags_bit_exact(flags, sources):
    """Each of introduction's eligibility flags (TestIntroductionVsOracle
    of tests/test_compositor.py), with 3- and 4-channel pixmaps and the
    frame numbers of each source."""
    cfg = {"classname": "introduction", "moving_pixels_leave_empty_spot":
           True, **INTRO_FLAGS[flags]}
    state = run_both([cfg], {0: _sources(sources)}, seed=11)
    assert state[0]["introduced_once"].dtype == torch.bool
    assert state[0]["introduced_once"].dim() == 0


@pytest.mark.parametrize("sources", ["rgb", "rgba", "two"])
def test_static_and_sum_pixmap_layouts(sources):
    """Static's masked blit and sum's regather over every pixmap layout
    (TestRgbaPixmaps of tests/test_compositor.py)."""
    run_both([{"classname": "static"},
              {"classname": "sum", "reset_mode": "random",
               "reset_random_factor": 0.2, "reset_source": True}],
             {0: _sources(sources), 1: _sources(sources)}, seed=6)


def test_sum_positions_leave_the_frame_unclipped():
    """Sum's int32 positions accumulate without bound; only the regather
    clips its reads."""
    state = run_both([{"classname": "sum"}], {0: _sources("rgb")}, seed=2,
                     frames=12, reach=20)
    pos = state[0]["pos_i"]
    assert pos.dtype == torch.int32
    assert int(pos.max()) > H or int(pos.min()) < 0


def test_every_class_stacked(gradient):
    """The four classes in one compositor, each over its own sources: the
    composite and every layer's state."""
    run_both([CLASSES["introduction"],
              {**CLASSES["sum"], "mask_alpha": gradient},
              {**CLASSES["static"], "mask_alpha": "circle:30%"},
              {**CLASSES["moveref"], "mask_src": "border:4",
               "mask_dst": "circle:40%"}],
             {0: _sources("two"), 1: _sources("rgb"),
              2: [(4, np.indices((H, W))[0] < H // 3)],
              3: _sources("rgba")}, seed=9)


@pytest.mark.parametrize("classname", ["moveref", "introduction"])
@pytest.mark.parametrize("masks", ["src", "dst", "all"])
def test_masks_under_mesh_with_halo(classname, masks):
    """``mask_src`` travels through the bounded gather with the state (and
    ``mask_dst`` stays at the target) under a two-shard mesh with
    ``halo``, against the JAX virtual mesh, whose sharded gather it
    equals. Flows reach past the halo, so the clamp runs."""
    run_both([{**CLASSES[classname], **_masks(masks, "hline:50%")}],
             {0: _sources("rgb", 24, 48)}, seed=13, frames=4, halo=3,
             n_mesh=2, h=24, w=48, reach=6)


def test_compositor_class_matches_jax(gradient):
    """The host-facing ``Compositor`` (the verify skill's drive) against
    the JAX package's: set_pixmap, update and render over every class."""
    cfgs = [dict(classname="introduction"),
            dict(reset_mode="random", reset_random_factor=0.05,
                 mask_alpha=gradient),
            dict(classname="sum")]
    sources = {0: [(3, None)], 1: [(3, np.ones((H, W), bool))],
               2: [(4, None)]}
    comp = Compositor(H, W, [LayerConfig(i, **c) for i, c in enumerate(cfgs)],
                      sources, background_color="#000000", seed=7,
                      device="cpu")
    jcomp = JaxCompositor(H, W, [JaxLayerConfig(i, **c)
                                 for i, c in enumerate(cfgs)],
                          sources, background_color="#000000", seed=7)
    rng = np.random.default_rng(0)
    for layer, channels in ((0, 3), (1, 3), (2, 4)):
        pixmap = rng.integers(0, 256, (H, W, channels), np.uint8)
        comp.set_pixmap(layer, 0, pixmap)
        jcomp.set_pixmap(layer, 0, pixmap)
    for _, flow in _flows(1, 6):
        comp.update(flow)
        jcomp.update(flow)
        np.testing.assert_array_equal(comp.render(), jcomp.render())
    for layer, jlayer in zip(comp.state, jcomp.state):
        _assert_state_equal(layer, jlayer)

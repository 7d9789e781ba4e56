"""The compositor kernels' plain versions (ops/compositor.py: K0, K1, K2)
against the JAX package's compositor, bit for bit.

Each test calls the plain versions the way their wrappers call the
kernels (a layer's key words, the halo, groups of sources or layers) on
seeded numpy inputs, and the JAX functions (``update_moveref``,
``update_sum``, ``render_fn``) on the same inputs. Every split of the
sources or layers into groups must give the one-pass JAX result. The
kernels themselves run on the card only (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transflow_tpu.compositor import core as jcore
from transflow_tpu.config import LayerConfig as JaxLayerConfig
from transflow_tpu.flow.transforms import clip_to_frame as jax_clip
from transflow_tpu_torch.compositor import core
from transflow_tpu_torch.config import LayerConfig
from transflow_tpu_torch.ops import compositor as ck
from transflow_tpu_torch.utils.imageio import write_netpbm

H, W = 20, 28
FRAMES = 4
SOURCE_GROUPS = (1, 2, 4, ck.MAX_SOURCES)
LAYER_GROUPS = (1, 2, 3, ck.MAX_LAYERS)
CHANNELS = (3, 4, 3, 3, 4, 4, 3, 4, 3)


@pytest.fixture(scope="module")
def gradient(tmp_path_factory):
    """A PGM whose values wrap across the frame: float masks k/255."""
    path = tmp_path_factory.mktemp("masks") / "gradient.pgm"
    ii, jj = np.indices((H, W))
    write_netpbm(str(path), ((ii * 13 + jj * 7) % 256).astype(np.uint8))
    return str(path)


def _flows(seed: int, n: int = FRAMES, reach: int = 6):
    """(jax, torch) pairs of clipped (H, W, 2) f32 flows: integer and
    half-integer motion, unmoving pixels among them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        flow = (rng.integers(-reach, reach + 1, (H, W, 2))
                + 0.5 * rng.integers(0, 2, (H, W, 2))).astype(np.float32)
        flow[rng.random((H, W)) < 0.3] = 0.0
        clipped = jax_clip(jnp.asarray(flow))
        out.append((clipped, torch.from_numpy(np.array(clipped))))
    return out


def _sources(n: int, seed: int):
    """``n`` sources of CHANNELS' channel counts, each with a random
    introduction mask (some pixels in none, some in several); one source
    covers the frame."""
    if n == 1:
        return [(3, None)]
    rng = np.random.default_rng(seed)
    return [(CHANNELS[s], rng.random((H, W)) < 0.4) for s in range(n)]


def _layers(cfgs: list[dict], sources: list):
    """(JAX params, port params, numpy pixmaps a layer)."""
    srcs = dict(enumerate(sources))
    jparams = jcore.make_layer_params(
        [JaxLayerConfig(i, **c) for i, c in enumerate(cfgs)], H, W, srcs)
    params = core.make_layer_params(
        [LayerConfig(i, **c) for i, c in enumerate(cfgs)], H, W, srcs,
        device="cpu")
    rng = np.random.default_rng(len(cfgs) + 17)
    pix = [[rng.integers(0, 256, (H, W, c), dtype=np.uint8)
            for c in p.channel_counts] for p in params]
    return jparams, params, pix


def _assert_state_equal(got: dict, want: dict, label=""):
    assert set(got) == set(want), label
    for key, value in want.items():
        expected = np.asarray(value)
        actual = got[key].numpy()
        assert actual.dtype == expected.dtype, (label, key)
        np.testing.assert_array_equal(actual, expected,
                                      err_msg=f"{label} {key}")


def run_update(cfg: dict, sources: list, halo=None,
               groups=(ck.MAX_SOURCES,), frames: int = FRAMES,
               seed: int = 0) -> dict:
    """One layer through ``frames`` JAX updates and, for each group size,
    through ``ck.layer_update`` (the plain version on the CPU); asserts
    every state equal after every frame. Returns the last port state."""
    jparams, params, pix = _layers([cfg], [sources])
    jp, p = jparams[0], params[0]
    jupdate = jcore.update_sum if p.cfg.classname == "sum" \
        else jcore.update_moveref
    jstate = jcore.init_layer_state(jp)
    states = dict.fromkeys(groups, core.init_layer_state(p))
    for k, (jflow, flow) in enumerate(_flows(seed, frames)):
        tpix = tuple(torch.from_numpy(np.roll(x, k, axis=0)) for x in pix[0])
        jpix = tuple(jnp.asarray(np.roll(x, k, axis=0)) for x in pix[0])
        key = jax.random.fold_in(jax.random.key(seed), k)
        jstate = jupdate(jp, jstate, jflow, jpix, key, halo)
        words = np.asarray(jax.random.key_data(key))
        for group in groups:
            states[group] = ck.layer_update(p, states[group], flow, tpix,
                                            words, halo, group)
            _assert_state_equal(states[group], jstate,
                                f"frame {k} group {group}")
    return states[groups[0]]


RESETS = {
    "off": {},
    "random": {"reset_mode": "random", "reset_random_factor": 0.3},
    "constant": {"reset_mode": "constant", "reset_constant_step": 2.5},
    "linear": {"reset_mode": "linear", "reset_linear_factor": 0.3},
}


@pytest.mark.parametrize("reset_mask", [False, True], ids=["factor", "mask"])
@pytest.mark.parametrize("reset", list(RESETS))
@pytest.mark.parametrize("classname", ["moveref", "sum"])
def test_update_reset_modes(classname, reset, reset_mask, gradient):
    """Moveref and sum under each reset mode, with and without a reset
    mask (a fractional one: the factor's product rounds)."""
    cfg = {"classname": classname, **RESETS[reset]}
    if reset_mask:
        cfg["reset_mask"] = gradient
    state = run_update(cfg, _sources(1, 0), seed=1)
    if classname == "sum":
        assert state["pos_i"].dtype == torch.int32
        if reset == "off":      # the sum's positions leave the frame
            assert (state["pos_i"] < 0).any() or (state["pos_i"] >= H).any()


MASKS = {
    "none": {},
    "src": {"mask_src": "circle:40%"},
    "dst": {"mask_dst": "border:4"},
    "reset": {"reset_mask": "gradient"},
    "all": {"mask_alpha": "gradient", "mask_src": "rect:70%:60%",
            "mask_dst": "circle:45%:inv", "reset_mask": "gradient"},
}


@pytest.mark.parametrize("masks", list(MASKS))
def test_update_masks(masks, gradient):
    """The movement masks and the reset mask, set and unset, under the
    random reset and leave-empty."""
    cfg = {k: gradient if v == "gradient" else v
           for k, v in MASKS[masks].items()}
    run_update({"reset_mode": "random", "reset_random_factor": 0.2,
                "moving_pixels_leave_empty_spot": True, **cfg},
               _sources(1, 0), seed=2)


FLAGS = {
    "transparent": {"transparent_pixels_can_move": True,
                    "moving_pixels_leave_empty_spot": True},
    "not_to_empty": {"pixels_can_move_to_empty_spot": False,
                     "moving_pixels_leave_empty_spot": True},
    "not_to_filled": {"pixels_can_move_to_filled_spot": False},
    "leave_empty": {"moving_pixels_leave_empty_spot": True},
}


@pytest.mark.parametrize("halo", [None, 2], ids=["gather", "halo2"])
@pytest.mark.parametrize("flag", list(FLAGS))
def test_update_movement_flags(flag, halo):
    """Each movement flag, with the plain gather and with a halo of 2 rows
    (flows reach 6: the bounded gather clamps)."""
    state = run_update({**FLAGS[flag], "reset_mode": "constant"},
                       _sources(1, 0), halo=halo, frames=5, seed=3)
    if flag != "not_to_filled":
        assert (state["alpha"] == 0).any()   # holes exist


@pytest.mark.parametrize("classname", ["moveref", "sum"])
@pytest.mark.parametrize("n", [1, 3, 9])
def test_update_sources_in_groups(n, classname):
    """1, 3 and 9 sources mixing 3 and 4 channels under the random reset
    with ``reset_source``: the regather in groups of 1, 2, 4 and 8 sources
    gives the one-pass JAX state every frame."""
    cfg = {"classname": classname, "reset_mode": "random",
           "reset_random_factor": 0.3, "reset_source": True}
    if classname == "moveref":
        cfg["moving_pixels_leave_empty_spot"] = True
    run_update(cfg, _sources(n, n), groups=SOURCE_GROUPS, seed=4)


@pytest.mark.parametrize("halo", [None, 2], ids=["gather", "halo2"])
def test_leave_empty_sources_plain(halo):
    """K0's plain version marks exactly the pixels some target reads: a
    loop over the pixels by the definition (core.py:224-230)."""
    cfg = {"mask_src": "circle:45%", "mask_dst": "rect:80%:80%",
           "moving_pixels_leave_empty_spot": True}
    _, params, _ = _layers([cfg], [_sources(1, 0)])
    p = params[0]
    rng = np.random.default_rng(6)
    alpha = (rng.random((H, W)) < 0.7).astype(np.uint8)
    state = dict(core.init_layer_state(p), alpha=torch.from_numpy(alpha))
    flow = _flows(6, 1)[0][1]
    got = ck.leave_empty_sources_plain(p, state, flow, halo).numpy()
    want = np.zeros((H, W), bool)
    mask_src, mask_dst = p.mask_src.numpy(), p.mask_dst.numpy()
    f = flow.numpy()
    for i in range(H):
        for j in range(W):
            di, dj = (int(np.rint(f[i, j, 1])), int(np.rint(f[i, j, 0])))
            si = min(max(i + di, 0), H - 1)
            sj = min(max(j + dj, 0), W - 1)
            if halo is not None:
                si = min(max(i + min(max(si - i, -halo), halo), 0), H - 1)
            if (di or dj) and mask_src[si, sj] and alpha[si, sj] \
                    and mask_dst[i, j]:
                want[si, sj] = True
    np.testing.assert_array_equal(got, want)
    assert want.any()


def _stack_cfgs(n: int, gradient: str) -> list[dict]:
    """``n`` layers cycling through the classes, most with an alpha
    mask."""
    cycle = [
        {"reset_mode": "random", "reset_random_factor": 0.2,
         "mask_alpha": gradient, "moving_pixels_leave_empty_spot": True},
        {"classname": "sum", "reset_mode": "linear"},
        {"classname": "introduction", "mask_alpha": gradient,
         "moving_pixels_leave_empty_spot": True},
        {"classname": "static", "mask_alpha": "circle:40%"},
        {"classname": "moveref", "mask_alpha": "border:3",
         "transparent_pixels_can_move": True},
    ]
    return [cycle[k % len(cycle)] for k in range(n)]


@pytest.mark.parametrize("n", [1, 3, 9])
def test_composite_in_groups(n, gradient):
    """1, 3 and 9 layers of every class, most with a fractional alpha
    mask, through the JAX step and the port's update; the render in groups
    of 1, 2, 3 and 8 layers equals JAX's ``render_fn`` (image and
    states), frame after frame."""
    cfgs = _stack_cfgs(n, gradient)
    jparams, params, pix = _layers(cfgs, [_sources(2, 9)] * n)
    jinit, jstep = jcore.build_compositor(jparams, H, W, "#204060")
    init, step = core.build_compositor(params, H, W, "#204060",
                                       device="cpu")
    background = torch.tensor([0x20, 0x40, 0x60], dtype=torch.uint8)
    jstate, state = jinit(), init()
    tpix = tuple(tuple(torch.from_numpy(x) for x in layer) for layer in pix)
    jpix = tuple(tuple(jnp.asarray(x) for x in layer) for layer in pix)
    numbers = tuple((0, 0) for _ in range(n))
    for k, (jflow, flow) in enumerate(_flows(7, 3)):
        key = jax.random.fold_in(jax.random.key(7), k)
        jstate = jstep.update(jstate, jflow, jpix, key, numbers)
        state = step.update(state, flow, tpix,
                            np.asarray(jax.random.key_data(key)), numbers)
        jstate, jrgb = jstep.render(jstate)
        for group in LAYER_GROUPS:
            got_states, rgb = ck.composite(params, state, background, H, W,
                                           group)
            np.testing.assert_array_equal(rgb.numpy(), np.asarray(jrgb),
                                          err_msg=f"frame {k} group {group}")
            for got, want in zip(got_states, jstate):
                _assert_state_equal(got, want, f"frame {k} group {group}")
        state = got_states


def test_composite_without_layers():
    """No layer: the background alone."""
    background = torch.tensor([1, 2, 3], dtype=torch.uint8)
    states, image = ck.composite([], [], background, H, W)
    assert states == []
    np.testing.assert_array_equal(image.numpy(),
                                  np.broadcast_to([1, 2, 3], (H, W, 3)))


def _misuse_case(case: str):
    """A call of a wrapper with one argument wrong."""
    cfg = {"reset_mode": "random"}
    _, params, pix = _layers([cfg, {"classname": "introduction"}],
                             [[(3, None), (4, None)]] * 2)
    p = params[0]
    state = core.init_layer_state(p)
    flow = torch.zeros((H, W, 2))
    tpix = tuple(torch.from_numpy(x) for x in pix[0])
    key = np.array([0, 1], np.uint32)
    args = dict(params=p, state=state, flow=flow, pixmaps=tpix, key=key,
                halo=None, group=ck.MAX_SOURCES)
    bg = torch.zeros(3, dtype=torch.uint8)
    comp = dict(params_list=params[:1], states=[state], background=bg,
                height=H, width=W, group=ck.MAX_LAYERS)
    update = {
        "flow dtype": dict(flow=flow.double()),
        "flow shape": dict(flow=torch.zeros((H, W + 1, 2))),
        "pixmap count": dict(pixmaps=tpix[:1]),
        "pixmap channels": dict(pixmaps=(tpix[0], tpix[0])),
        "pixmap dtype": dict(pixmaps=(tpix[0].float(), tpix[1])),
        "pos dtype": dict(state=dict(state, pos_i=state["pos_i"].long())),
        "pos dtypes differ": dict(state=dict(
            state, pos_j=state["pos_j"].int())),
        "alpha dtype": dict(state=dict(state, alpha=state["alpha"].int())),
        "rgba shape": dict(state=dict(state, rgba=state["rgba"][..., :3])),
        "no key": dict(key=None),
        "key shape": dict(key=np.zeros(3, np.uint32)),
        "group 0": dict(group=0),
        "group too large": dict(group=ck.MAX_SOURCES + 1),
        "introduction": dict(params=params[1]),
        "meta device": dict(flow=torch.zeros((H, W, 2), device="meta")),
    }
    composite = {
        "states count": dict(states=[]),
        "background shape": dict(background=torch.zeros(4, dtype=torch.uint8)),
        "rgba dtype": dict(states=[dict(state, rgba=state["rgba"].int())]),
        "layer size": dict(height=H + 1),
        "layer group 0": dict(group=0),
        "layer group too large": dict(group=ck.MAX_LAYERS + 1),
        "meta background": dict(background=torch.zeros(
            3, dtype=torch.uint8, device="meta")),
    }
    if case in update:
        return lambda: ck.layer_update(**{**args, **update[case]})
    return lambda: ck.composite(**{**comp, **composite[case]})


@pytest.mark.parametrize("case", [
    "flow dtype", "flow shape", "pixmap count", "pixmap channels",
    "pixmap dtype", "pos dtype", "pos dtypes differ", "alpha dtype",
    "rgba shape", "no key", "key shape", "group 0", "group too large",
    "introduction", "meta device", "states count", "background shape",
    "rgba dtype", "layer size", "layer group 0", "layer group too large",
    "meta background"])
def test_wrapper_misuse_raises(case):
    with pytest.raises(ValueError):
        _misuse_case(case)()


def test_last_source_plane():
    """The reset's source plane: the last source whose introduction mask
    holds the pixel, 255 where none does."""
    sources = _sources(9, 3)
    _, params, _ = _layers([{}], [sources])
    masks = np.stack([m for _, m in sources])
    want = np.where(masks.any(0), 8 - np.argmax(masks[::-1], axis=0), 255)
    np.testing.assert_array_equal(params[0].last_source_plane.numpy(), want)
    assert (want == 255).any() and (want < 9).any()

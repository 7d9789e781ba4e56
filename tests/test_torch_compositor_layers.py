"""The introduction layer's update (K3's plain version) and the static
layer's blit (K4's) against the JAX package's ``update_introduction`` and
``update_static``, bit for bit.

Each test calls ``ops/compositor.py``'s plain versions the way their
wrappers call the kernels (the layer's flags and masks, the halo, the
frame numbers, groups of sources) on seeded numpy inputs, and the JAX
functions on the same inputs, frame after frame with the state carried.
Every split of the sources into groups must give the one-pass JAX state.
The kernels themselves run on the card only (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_compositor_kernels import (H, W, _assert_state_equal,
                                           _flows, _layers)
from transflow_tpu.compositor import core as jcore
from transflow_tpu_torch.compositor import core
from transflow_tpu_torch.ops import compositor as ck

# ten sources' channel counts: 3 and 4 mixed
CHANNELS = (3, 4, 4, 3, 3, 4, 3, 4, 4, 3)
GROUPS = (1, 3, ck.MAX_SOURCES)
FRAMES = 4


def _sources(n: int, seed: int):
    """``n`` sources of CHANNELS' counts with random introduction masks
    (some pixels in none, some in several); one source covers the frame."""
    if n == 1:
        return [(3, None)]
    rng = np.random.default_rng(seed)
    return [(CHANNELS[s], rng.random((H, W)) < 0.45) for s in range(n)]


def _pixmaps(pix, k: int):
    """Frame ``k``'s pixmaps for (JAX, the port): a video's pixmaps move."""
    rolled = [np.roll(x, 2 * k, axis=1) for x in pix]
    return (tuple(jnp.asarray(x) for x in rolled),
            tuple(torch.from_numpy(x) for x in rolled))


def run_introduction(cfg: dict, sources: list, halo=None,
                     groups=(ck.MAX_SOURCES,), frames: int = FRAMES,
                     seed: int = 0) -> dict:
    """An introduction layer through ``frames`` JAX updates and, for each
    group size, through ``ck.introduction_update`` (the plain version on
    the CPU); asserts every state equal after every frame. Returns the
    last port state."""
    jparams, params, pix = _layers([{"classname": "introduction", **cfg}],
                                   [sources])
    jp, p = jparams[0], params[0]
    jstate = jcore.init_layer_state(jp)
    states = dict.fromkeys(groups, core.init_layer_state(p))
    for k, (jflow, flow) in enumerate(_flows(seed, frames)):
        jpix, tpix = _pixmaps(pix[0], k)
        numbers = tuple(5 * k + s for s in range(p.num_sources))
        jstate = jcore.update_introduction(
            jp, jstate, jflow, jpix, None,
            tuple(jnp.int32(n) for n in numbers), halo)
        for group in groups:
            states[group] = ck.introduction_update(
                p, states[group], flow, tpix, numbers, halo, group)
            _assert_state_equal(states[group], jstate,
                                f"frame {k} group {group}")
    return states[groups[0]]


ELIGIBILITY = {
    "default": {},
    "not_on_empty": {"introduce_pixels_on_empty_spots": False},
    "not_on_filled": {"introduce_pixels_on_filled_spots": False},
    "not_moving": {"introduce_moving_pixels": False},
    "not_unmoving": {"introduce_unmoving_pixels": False},
    "all_filled": {"introduce_on_all_filled_spots": True,
                   "introduce_pixels_on_empty_spots": False},
    "all_empty": {"introduce_on_all_empty_spots": True,
                  "introduce_pixels_on_filled_spots": False},
    "all_both": {"introduce_on_all_filled_spots": True,
                 "introduce_on_all_empty_spots": True,
                 "introduce_moving_pixels": False},
}


@pytest.mark.parametrize("flags", list(ELIGIBILITY))
def test_introduction_eligibility_flags(flags):
    """Each eligibility flag and the two all-spots flags (the gather at the
    base coordinates) over two sources of 3 and 4 channels, with holes
    (leave-empty) so empty and filled spots both occur."""
    cfg = {"moving_pixels_leave_empty_spot": True, **ELIGIBILITY[flags]}
    run_introduction(cfg, _sources(2, 1), seed=1)


def test_introduction_once_over_two_frames():
    """``introduce_once``: the first frame introduces, the second reads the
    old ``introduced_once`` and introduces nowhere."""
    cfg = {"introduce_once": True, "moving_pixels_leave_empty_spot": True}
    state = run_introduction(cfg, _sources(2, 2), frames=2, seed=2,
                             groups=GROUPS)
    assert bool(state["introduced_once"])


@pytest.mark.parametrize("halo", [None, 2], ids=["gather", "halo2"])
@pytest.mark.parametrize("masks", ["none", "src_dst"])
def test_introduction_leave_empty(halo, masks):
    """Leave-empty with the plain gather and with a halo of 2 rows (flows
    reach 6: the bounded gather clamps its row, the pixmaps are still read
    at the true source), with and without movement masks."""
    cfg = {"moving_pixels_leave_empty_spot": True,
           "introduce_pixels_on_filled_spots": False}
    if masks == "src_dst":
        cfg.update(mask_src="circle:40%", mask_dst="rect:80%:70%")
    state = run_introduction(cfg, _sources(2, 3), halo=halo, frames=5,
                             seed=3)
    assert (state["alpha"] == 0).any()


@pytest.mark.parametrize("flag", ["transparent", "not_to_empty",
                                  "not_to_filled"])
def test_introduction_movement_flags(flag):
    """The movement flags K1 shares, under the introduction's update."""
    cfg = {"transparent": {"transparent_pixels_can_move": True,
                           "moving_pixels_leave_empty_spot": True},
           "not_to_empty": {"pixels_can_move_to_empty_spot": False,
                            "moving_pixels_leave_empty_spot": True},
           "not_to_filled": {"pixels_can_move_to_filled_spot": False}}[flag]
    run_introduction(cfg, _sources(2, 4), halo=2, seed=4)


@pytest.mark.parametrize("channels", [3, 4])
def test_introduction_one_source(channels):
    """One source covering the frame: 3 channels introduce alpha 1, 4 the
    pixmap's alpha byte (0 included)."""
    run_introduction({"moving_pixels_leave_empty_spot": True},
                     [(channels, None)], seed=5)


@pytest.mark.parametrize("n", [3, 10])
def test_introduction_sources_in_groups(n):
    """3 and 10 sources mixing 3 and 4 channels, leave-empty with a halo:
    the introduction in groups of 1, 3 and 8 sources (the eligibility mask
    computed once) gives the one-pass JAX state every frame."""
    run_introduction({"moving_pixels_leave_empty_spot": True,
                      "introduce_pixels_on_filled_spots": False},
                     _sources(n, n), halo=3, groups=GROUPS, seed=6)


def run_static(sources: list, groups=GROUPS, frames: int = 3,
               seed: int = 0) -> dict:
    """A static layer through ``frames`` JAX updates and, for each group
    size, through ``ck.static_blit`` (the plain version on the CPU)."""
    jparams, params, pix = _layers([{"classname": "static"}], [sources])
    jp, p = jparams[0], params[0]
    jstate = jcore.init_layer_state(jp)
    states = dict.fromkeys(groups, core.init_layer_state(p))
    for k, (jflow, _) in enumerate(_flows(seed, frames)):
        jpix, tpix = _pixmaps(pix[0], k)
        jstate = jcore.update_static(jp, jstate, jflow, jpix, None)
        for group in groups:
            states[group] = ck.static_blit(p, states[group], tpix, group)
            _assert_state_equal(states[group], jstate,
                                f"frame {k} group {group}")
    return states[groups[0]]


@pytest.mark.parametrize("n", [0, 1, 2, 10])
def test_static_blit_in_groups(n):
    """No source, one, two and ten sources mixing 3 and 4 channels, in
    groups of 1, 3 and 8: the running rgba gives the one-pass JAX
    state."""
    run_static([] if n == 0 else _sources(n, 10 + n), seed=n)


@pytest.mark.parametrize("channels", [3, 4])
def test_static_blit_one_source(channels):
    """One full-frame source: the rgb always, the alpha byte from a
    4-channel pixmap only (a 3-channel one leaves the opaque 1)."""
    state = run_static([(channels, None)], groups=(ck.MAX_SOURCES,))
    alpha = state["rgba"][..., 3]
    assert (alpha == 1).all() if channels == 3 else (alpha != 1).any()


def _layer(classname: str):
    _, params, pix = _layers([{"classname": classname}],
                             [[(3, None), (4, None)]])
    p = params[0]
    return p, core.init_layer_state(p), tuple(
        torch.from_numpy(x) for x in pix[0])


def _misuse_case(case: str):
    """A call of K3's or K4's dispatcher with one argument wrong."""
    p, state, tpix = _layer("introduction")
    flow = torch.zeros((H, W, 2))
    intro = dict(params=p, state=state, flow=flow, pixmaps=tpix,
                 frame_numbers=(0, 1), halo=None, group=ck.MAX_SOURCES)
    sp, sstate, spix = _layer("static")
    static = dict(params=sp, state=sstate, pixmaps=spix,
                  group=ck.MAX_SOURCES)
    moveref = _layers([{}], [[(3, None), (4, None)]])[1][0]
    intro_cases = {
        "intro flow dtype": dict(flow=flow.double()),
        "intro pixmap count": dict(pixmaps=tpix[:1]),
        "intro pixmap channels": dict(pixmaps=(tpix[1], tpix[1])),
        "intro frame numbers": dict(frame_numbers=(0,)),
        "intro pos dtype": dict(state=dict(state,
                                           pos_i=state["pos_i"].int())),
        "intro frame dtype": dict(state=dict(state,
                                             frame=state["frame"].long())),
        "intro once shape": dict(state=dict(
            state, introduced_once=torch.zeros(1, dtype=torch.bool))),
        "intro rgb shape": dict(state=dict(state,
                                           rgb=state["rgb"][..., :2])),
        "intro group 0": dict(group=0),
        "intro class": dict(params=moveref),
    }
    static_cases = {
        "static rgba dtype": dict(state={"rgba": sstate["rgba"].int()}),
        "static pixmap count": dict(pixmaps=spix[1:]),
        "static group too large": dict(group=ck.MAX_SOURCES + 1),
        "static class": dict(params=p),
    }
    if case in intro_cases:
        return lambda: ck.introduction_update(**{**intro,
                                                 **intro_cases[case]})
    return lambda: ck.static_blit(**{**static, **static_cases[case]})


@pytest.mark.parametrize("case", [
    "intro flow dtype", "intro pixmap count", "intro pixmap channels",
    "intro frame numbers", "intro pos dtype", "intro frame dtype",
    "intro once shape", "intro rgb shape", "intro group 0", "intro class",
    "static rgba dtype", "static pixmap count", "static group too large",
    "static class"])
def test_layer_wrappers_refuse_misuse(case):
    with pytest.raises(ValueError):
        _misuse_case(case)()


def test_leave_empty_sources_takes_introduction_layers():
    """K0's plain version over an introduction layer marks the same pixels
    as over a moveref layer with the same flags, masks and alpha."""
    cfg = {"mask_src": "circle:45%", "moving_pixels_leave_empty_spot": True}
    _, params, _ = _layers([{"classname": "introduction", **cfg}, cfg],
                           [[(3, None)], [(3, None)]])
    rng = np.random.default_rng(8)
    alpha = torch.from_numpy((rng.random((H, W)) < 0.7).astype(np.uint8))
    flow = _flows(8, 1)[0][1]
    marks = [ck.leave_empty_sources_plain(
        p, dict(core.init_layer_state(p), alpha=alpha), flow, 2)
        for p in params]
    assert torch.equal(marks[0], marks[1]) and marks[0].any()


@pytest.mark.parametrize("halo", [None, 2], ids=["gather", "halo2"])
@pytest.mark.parametrize("classname", ["moveref", "sum", "introduction",
                                       "static"])
def test_core_updates_match_jax(classname, halo):
    """compositor/core.py's one-pass public updates (``update_moveref``,
    ``update_sum``, ``update_introduction``, ``update_static``: the JAX
    package's exported names, which the kernels' plain versions compose)
    against JAX's over three frames, with leave-empty and the random
    reset's draw given as ``prng.uniform``."""
    from transflow_tpu_torch import prng
    cfg = {"classname": classname}
    if classname in ("moveref", "introduction"):
        cfg["moving_pixels_leave_empty_spot"] = True
    if classname in ("moveref", "sum"):
        cfg.update(reset_mode="random", reset_random_factor=0.2)
    jparams, params, pix = _layers([cfg], [_sources(2, 12)])
    jp, p = jparams[0], params[0]
    jupdate = getattr(jcore, f"update_{classname}")
    update = getattr(core, f"update_{classname}")
    jstate, state = jcore.init_layer_state(jp), core.init_layer_state(p)
    for k, (jflow, flow) in enumerate(_flows(12, 3)):
        jpix, tpix = _pixmaps(pix[0], k)
        key = jax.random.fold_in(jax.random.key(12), k)
        if classname == "introduction":
            jstate = jupdate(jp, jstate, jflow, jpix, key, (k, k + 1), halo)
            state = update(p, state, flow, tpix, (k, k + 1), halo)
        else:
            jstate = jupdate(jp, jstate, jflow, jpix, key, halo)
            rand = prng.uniform(np.asarray(jax.random.key_data(key)),
                                (H, W), "cpu") \
                if classname in ("moveref", "sum") else None
            state = update(p, state, flow, tpix, rand, halo)
        _assert_state_equal(state, jstate, f"frame {k}")

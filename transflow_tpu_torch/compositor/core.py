"""Functional compositor core of the port: every layer class.

Counterpart of transflow_tpu/compositor/core.py. A layer update is a
function of the layer's state dict of tensors, as in JAX; the reference's
scatter permutation is the same masked gather (``new[p] = data[p +
flow[p]]`` for targets p), and the only scatter left writes a constant
(``ops/scatter.py::scatter_any``). Everything is integer or selection logic
and matches the JAX package bit for bit given the same flow and key: the
random reset draws ``prng.uniform`` from the same threefry key as
``jax.random.uniform``.

``build_compositor`` runs every layer's update, and the render of the
stack, through ``ops/compositor.py`` (kernels K0-K4 of
``csrc/compositor.cu`` on the card, which hash the draw in registers;
this module's functions on the CPU).

The four classes (moveref, sum, static, introduction), the four reset
modes and the four layer masks (``mask_alpha``, ``mask_src``,
``mask_dst``, ``reset_mask``) are ported. A mask the config leaves unset
is all ones in the JAX package; here it is None and the step skips its
product or test, which gives the same values. Documented deviations from
the reference are the JAX package's (core.py:17-24): introduction's
exclusions have their intended meaning, and sum moves along (dy -> i,
dx -> j).
"""
import functools
from typing import Sequence

import numpy as np
import torch

from .. import prng
from .._device import resolve_device
from ..config import LayerConfig
from ..ops import compositor as kernels
from ..ops.halo_gather import bounded_row_gather, clamped_rows
from ..ops.scatter import scatter_any
from ..utils import load_bool_mask, load_float_mask, parse_color

# compact carry dtypes of the JAX package (core.py:47-49): in-frame
# coordinates fit int16, alpha is 0..255, source indexes < 256 pixmaps.
# Sum layers keep int32 positions: their displacement accumulates without
# bound.
POS_DTYPE = torch.int16
ALPHA_DTYPE = torch.uint8
SOURCE_DTYPE = torch.uint8

# the reset mode's factor, which the reset mask multiplies
_RESET_FACTORS = {"random": "reset_random_factor",
                  "constant": "reset_constant_step",
                  "linear": "reset_linear_factor"}


class LayerParams:
    """Per-layer parameters: the config, its masks and the per-source
    introduction masks, on ``device``, loaded once.

    ``mask_alpha`` (float), ``mask_src`` and ``mask_dst`` (bool) are (H, W)
    tensors, or None where the config sets none (all ones). ``reset_factor``
    is the reset mode's float32 factor times the float ``reset_mask``, in
    float32 as JAX's weak-typed product (core.py:278, :299, :310): an (H,
    W) tensor, or a 0-d one without a mask; None for mode "off"."""

    def __init__(self, cfg: LayerConfig, height: int, width: int,
                 intro_masks: Sequence[np.ndarray],
                 channel_counts: Sequence[int], device=None):
        self.cfg = cfg
        self.height = height
        self.width = width
        self.device = resolve_device(device)
        shape = (height, width)

        def put(array):
            return torch.as_tensor(array, device=self.device)

        self.mask_alpha = None if cfg.mask_alpha is None else put(
            load_float_mask(cfg.mask_alpha, shape, 1.0))
        self.mask_src = None if cfg.mask_src is None else put(
            load_bool_mask(cfg.mask_src, shape, True))
        self.mask_dst = None if cfg.mask_dst is None else put(
            load_bool_mask(cfg.mask_dst, shape, True))
        self.reset_factor = None
        if cfg.reset_mode in _RESET_FACTORS:
            factor = float(np.float32(getattr(cfg,
                                              _RESET_FACTORS[cfg.reset_mode])))
            self.reset_factor = (
                torch.full((), factor, dtype=torch.float32,
                           device=self.device) if cfg.reset_mask is None
                else put(load_float_mask(cfg.reset_mask, shape, 1.0))
                * factor)
        self.intro_masks = tuple(
            torch.as_tensor(np.asarray(m, dtype=bool), device=self.device)
            for m in intro_masks)
        self.channel_counts = tuple(channel_counts)
        self.num_sources = len(self.intro_masks)

    @functools.cached_property
    def last_source_plane(self) -> torch.Tensor:
        """(H, W) uint8: the last source whose introduction mask holds the
        pixel, 255 where none does: the source the random reset with
        ``reset_source`` gives a reset pixel (``_reset``'s loop), in one
        plane for kernel K1. Made at first use."""
        plane = torch.full((self.height, self.width), 255,
                           dtype=SOURCE_DTYPE, device=self.device)
        for s, mask in enumerate(self.intro_masks):
            plane = torch.where(mask, torch.full_like(plane, s), plane)
        return plane

    def base_source(self) -> torch.Tensor:
        """Initial per-pixel source index: later sources overwrite earlier.

        Parity: transflow/compositor/layers/reference.py:46-52."""
        source = torch.zeros((self.height, self.width), dtype=SOURCE_DTYPE,
                             device=self.device)
        for s, mask in enumerate(self.intro_masks):
            source = torch.where(mask, torch.full_like(source, s), source)
        return source


def _base_coords(height: int, width: int, device):
    ii = torch.arange(height, dtype=torch.int32,
                      device=device)[:, None].expand(height, width)
    jj = torch.arange(width, dtype=torch.int32,
                      device=device)[None, :].expand(height, width)
    return ii, jj


def init_layer_state(params: LayerParams) -> dict:
    """A layer's first state (core.py:118-151): static starts opaque
    (static.py:9-12); introduction empty, with its own colours, frame
    numbers and a 0-d ``introduced_once``; moveref and sum an identity
    mapping, opaque (reference.py:38-42), sum with int32 positions."""
    h, w = params.height, params.width
    classname = params.cfg.classname
    if not (h < 32768 and w < 32768):
        raise ValueError("POS_DTYPE int16 requires dims < 32768")
    if len(params.intro_masks) >= 256:
        raise ValueError("SOURCE_DTYPE uint8 caps sources at 255")
    device = params.device
    rgba = torch.zeros((h, w, 4), dtype=torch.uint8, device=device)
    if classname == "static":
        rgba[..., 3] = 1
        return {"rgba": rgba}
    if classname == "introduction":
        return {
            "rgb": torch.zeros((h, w, 3), dtype=torch.uint8, device=device),
            "alpha": torch.zeros((h, w), dtype=ALPHA_DTYPE, device=device),
            "source": torch.zeros((h, w), dtype=SOURCE_DTYPE, device=device),
            "pos_i": torch.zeros((h, w), dtype=POS_DTYPE, device=device),
            "pos_j": torch.zeros((h, w), dtype=POS_DTYPE, device=device),
            "frame": torch.zeros((h, w), dtype=torch.int32, device=device),
            "introduced_once": torch.zeros((), dtype=torch.bool,
                                           device=device),
        }
    pos_dtype = torch.int32 if classname == "sum" else POS_DTYPE
    ii, jj = _base_coords(h, w, device)
    return {
        "pos_i": ii.to(pos_dtype).contiguous(),
        "pos_j": jj.to(pos_dtype).contiguous(),
        "alpha": torch.ones((h, w), dtype=ALPHA_DTYPE, device=device),
        "source": params.base_source(),
        "rgba": rgba,
    }


def movement_targets(params: LayerParams, alpha: torch.Tensor,
                     flow: torch.Tensor, halo: int | None = None):
    """The movement's gather and its targets. Returns (gather, is_target,
    moving, src_i, src_j, eff_i): ``gather(x)`` reads ``x`` at each
    pixel's source, ``eff_i`` is the row it reads (``src_i`` without a
    halo).

    ``halo``: source reads go through the bounded-displacement gather
    (ops/halo_gather.py), exact for |flow_y| <= halo. Under a mesh that
    splits H the JAX package reads through its sharded form, which equals
    it; here the state is whole on one device."""
    cfg = params.cfg
    h, w = params.height, params.width
    di = torch.round(flow[..., 1]).to(torch.int32)
    dj = torch.round(flow[..., 0]).to(torch.int32)
    moving = (di != 0) | (dj != 0)
    ii, jj = _base_coords(h, w, flow.device)
    src_i = (ii + di).clamp(0, h - 1)
    src_j = (jj + dj).clamp(0, w - 1)
    if halo is None:
        eff_i = src_i
        flat_src = (src_i.long() * w + src_j.long()).reshape(-1)

        def gather(x):
            return x.reshape((h * w,) + x.shape[2:])[flat_src] \
                .reshape(x.shape)
    else:
        # the row the bounded gather reads; the leave-empty scatter
        # vacates that same row (core.py:224-230)
        eff_i = clamped_rows(src_i, halo)

        def gather(x):
            return bounded_row_gather(x, src_i, src_j, halo)

    filled = alpha != 0
    # the source's mask plane, read through the same gather as the state
    # (core.py:183-189); None where it is all ones
    src_plane = params.mask_src
    if not cfg.transparent_pixels_can_move:
        src_plane = filled if src_plane is None else src_plane & filled
    is_target = moving if src_plane is None else moving & gather(src_plane)
    if params.mask_dst is not None:
        is_target = is_target & params.mask_dst
    if not cfg.pixels_can_move_to_empty_spot:
        is_target = is_target & filled
    if not cfg.pixels_can_move_to_filled_spot:
        is_target = is_target & ~filled
    return gather, is_target, moving, src_i, src_j, eff_i


def leave_empty_sources(params: LayerParams, alpha: torch.Tensor,
                        flow: torch.Tensor,
                        halo: int | None = None) -> torch.Tensor:
    """(H, W) bool: the pixels that some target of the movement reads,
    which ``moving_pixels_leave_empty_spot`` empties (core.py:224-230)."""
    _, is_target, _, _, src_j, eff_i = movement_targets(params, alpha,
                                                        flow, halo)
    return _occupied(params, is_target, src_j, eff_i)


def _occupied(params: LayerParams, is_target: torch.Tensor,
              src_j: torch.Tensor, eff_i: torch.Tensor) -> torch.Tensor:
    w = params.width
    flat_eff = (eff_i.long() * w + src_j.long()).reshape(-1)
    return scatter_any((params.height, w), flat_eff, is_target)


def _movement(params: LayerParams, channels: dict, alpha: torch.Tensor,
              flow: torch.Tensor, halo: int | None = None):
    """Apply the flow permutation to ``channels`` + ``alpha``.

    Parity: transflow/compositor/layers/movement.py:20-64 as a masked
    gather. Returns (channels, alpha, (moving, src_i, src_j)); ``halo`` as
    in ``movement_targets``."""
    cfg = params.cfg
    gather, is_target, moving, src_i, src_j, eff_i = movement_targets(
        params, alpha, flow, halo)
    g_alpha = gather(alpha)

    def sel(mask, a, b):
        return torch.where(mask[..., None] if a.dim() == 3 else mask, a, b)

    out = {k: sel(is_target, gather(v), v) for k, v in channels.items()}
    new_alpha = torch.where(is_target, g_alpha, alpha)
    if cfg.moving_pixels_leave_empty_spot:
        is_source = _occupied(params, is_target, src_j, eff_i)
        new_alpha = torch.where(is_source, torch.zeros_like(new_alpha),
                                new_alpha)
    arrived = is_target & (g_alpha != 0) if cfg.transparent_pixels_can_move \
        else is_target
    new_alpha = torch.where(arrived, torch.ones_like(new_alpha), new_alpha)
    return out, new_alpha, (moving, src_i, src_j)


def _gather_pixmap_slices(params: LayerParams, pixmaps, gi, gj,
                          sources: range):
    """Each source's (H, W, channel_counts[s]) pixmap read at (gi, gj), for
    s in ``sources``."""
    h, w = params.height, params.width
    flat = (gi.long() * w + gj.long()).reshape(-1)
    for s in sources:
        pixmap = pixmaps[s]
        yield pixmap.reshape(h * w, -1)[flat].reshape(h, w, -1)


def _reset(params: LayerParams, state: dict, rand=None) -> dict:
    """Parity: transflow/compositor/layers/reference.py:58-91.

    ``rand``: the (H, W) f32 uniform draw of the random mode
    (``ops/compositor.py::layer_update_plain`` draws it with
    ``prng.uniform`` from the layer's key, as core.py does with
    ``jax.random.uniform``)."""
    cfg = params.cfg
    mode = cfg.reset_mode
    if mode == "off":
        return state
    h, w = params.height, params.width
    ii, jj = _base_coords(h, w, state["pos_i"].device)
    pos_i, pos_j = state["pos_i"], state["pos_j"]
    if mode == "random":
        reset = rand < params.reset_factor
        state = dict(state)
        state["pos_i"] = torch.where(reset, ii.to(pos_i.dtype), pos_i)
        state["pos_j"] = torch.where(reset, jj.to(pos_j.dtype), pos_j)
        state["alpha"] = torch.where(reset, torch.ones_like(state["alpha"]),
                                     state["alpha"])
        if cfg.reset_source:
            source = state["source"]
            for s, mask in enumerate(params.intro_masks):
                source = torch.where(reset & mask, torch.full_like(source, s),
                                     source)
            state["source"] = source
        return state
    d_i = (ii - pos_i).float()
    d_j = (jj - pos_j).float()
    if mode == "constant":
        norm_base = torch.maximum(d_i.abs(), d_j.abs())
        safe = torch.where(norm_base > 0, norm_base, torch.ones_like(norm_base))
        step_i = torch.where(norm_base > 0, d_i / safe, d_i)
        step_j = torch.where(norm_base > 0, d_j / safe, d_j)
        step_i = step_i * params.reset_factor
        step_j = step_j * params.reset_factor
        norm_scaled = torch.maximum(step_i.abs(), step_j.abs())
        overshoot = norm_scaled > norm_base
        step_i = torch.where(overshoot, d_i, step_i)
        step_j = torch.where(overshoot, d_j, step_j)
    elif mode == "linear":
        step_i = params.reset_factor * d_i
        step_j = params.reset_factor * d_j
    else:
        raise ValueError(f"Unknown reset mode {mode}")
    state = dict(state)
    # int16 + int32 promotes to int32; back to the carry dtype (the stepped
    # position stays in the frame, so this never wraps)
    state["pos_i"] = (pos_i + torch.round(step_i).to(torch.int32)) \
        .to(pos_i.dtype)
    state["pos_j"] = (pos_j + torch.round(step_j).to(torch.int32)) \
        .to(pos_j.dtype)
    return state


def _reference_rgba(params: LayerParams, state: dict, pixmaps,
                    sources: range | None = None) -> dict:
    """Regather rgba from the coordinate mapping, over ``sources`` (all by
    default; a later range continues from the state's rgba, as a later
    launch of kernel K1 does).

    Parity: transflow/compositor/layers/reference.py:93-105, including the
    reference's per-source sequential alpha handling for 3-channel
    pixmaps."""
    h, w = params.height, params.width
    if sources is None:
        sources = range(params.num_sources)
    rgba = state["rgba"]
    rgb = rgba[..., :3]
    a = rgba[..., 3]
    mi = state["pos_i"].clamp(0, h - 1)
    mj = state["pos_j"].clamp(0, w - 1)
    slices = _gather_pixmap_slices(params, pixmaps, mi, mj, sources)
    for s, gathered in zip(sources, slices):
        sel = (state["source"] == s) & (state["alpha"] != 0)
        rgb = torch.where(sel[..., None], gathered[..., :3], rgb)
        if params.channel_counts[s] == 4:
            a = torch.where(sel, gathered[..., 3], a)
        else:
            a = sel.to(torch.uint8)
    state = dict(state)
    state["rgba"] = torch.cat([rgb, a[..., None]], dim=-1)
    return state


def update_moveref(params: LayerParams, state: dict, flow, pixmaps,
                   rand=None, halo: int | None = None) -> dict:
    """MoveReferenceLayer.update (move_reference.py:12-14). ``rand`` is the
    random reset's uniform draw (only read in that mode); ``halo`` selects
    the movement gather (``_movement``)."""
    state = moveref_movement(params, state, flow, halo)
    state = _reset(params, state, rand)
    return _reference_rgba(params, state, pixmaps)


def moveref_movement(params: LayerParams, state: dict, flow,
                     halo: int | None = None) -> dict:
    """A moveref layer's state moved by ``flow`` (``_movement`` of its
    positions, source and alpha)."""
    channels = {"pos_i": state["pos_i"], "pos_j": state["pos_j"],
                "source": state["source"]}
    channels, alpha, _ = _movement(params, channels, state["alpha"], flow,
                                   halo)
    return dict(state, **channels, alpha=alpha)


def update_sum(params: LayerParams, state: dict, flow, pixmaps, rand=None,
               halo: int | None = None) -> dict:
    """SumLayer.update: additive displacement, then reset + regather.

    Parity: sum.py:9-14 with the component transposition fixed (dy -> i).
    The int32 positions are not clipped; the regather clips its reads."""
    state = sum_movement(state, flow)
    state = _reset(params, state, rand)
    return _reference_rgba(params, state, pixmaps)


def sum_movement(state: dict, flow) -> dict:
    """A sum layer's positions plus the floored flow, in int32."""
    state = dict(state)
    state["pos_i"] = state["pos_i"] + torch.floor(flow[..., 1]).to(
        torch.int32)
    state["pos_j"] = state["pos_j"] + torch.floor(flow[..., 0]).to(
        torch.int32)
    return state


def update_static(params: LayerParams, state: dict, flow, pixmaps,
                  rand=None, halo: int | None = None, groups=None) -> dict:
    """StaticLayer.update (static.py:14-17): masked blit, flow ignored.

    ``groups``: the sources as ranges, in order (by default one range of
    all of them); a later range continues from the rgba an earlier one
    made, as a later launch of kernel K4 does."""
    rgba = state["rgba"]
    for sources in (range(params.num_sources),) if groups is None \
            else groups:
        rgb = rgba[..., :3]
        a = rgba[..., 3]
        for s in sources:
            mask = params.intro_masks[s]
            pixmap = pixmaps[s]
            rgb = torch.where(mask[..., None], pixmap[..., :3], rgb)
            if params.channel_counts[s] == 4:
                a = torch.where(mask, pixmap[..., 3], a)
        rgba = torch.cat([rgb, a[..., None]], dim=-1)
    return {"rgba": rgba}


def update_introduction(params: LayerParams, state: dict, flow, pixmaps,
                        frame_numbers, halo: int | None = None,
                        groups=None) -> dict:
    """IntroductionLayer.update (introduction.py:16-67): move pixels
    carrying their RGB, then introduce new pixels from each source where
    the eligibility flags allow (their intended meaning, as in the JAX
    package). ``frame_numbers`` holds one int per source.

    ``groups`` as in ``update_static``: the eligibility mask is made once,
    before any source, and each range introduces over the state the one
    before it left, as kernel K3's launches do."""
    cfg = params.cfg
    state, moving, src_i, src_j = introduction_movement(params, state, flow,
                                                        halo)
    mask = introduction_eligible(params, state, moving)
    if cfg.introduce_on_all_filled_spots or cfg.introduce_on_all_empty_spots:
        gi, gj = _base_coords(params.height, params.width, flow.device)
    else:
        gi, gj = src_i, src_j
    for sources in (range(params.num_sources),) if groups is None \
            else groups:
        slices = _gather_pixmap_slices(params, pixmaps, gi, gj, sources)
        for s, gathered in zip(sources, slices):
            tgt = mask & params.intro_masks[s]
            if params.channel_counts[s] == 4:
                new_a = gathered[..., 3].to(ALPHA_DTYPE)
            else:
                new_a = torch.ones_like(state["alpha"])
            state["rgb"] = torch.where(tgt[..., None], gathered[..., :3],
                                       state["rgb"])
            state["alpha"] = torch.where(tgt, new_a, state["alpha"])
            state["source"] = torch.where(
                tgt, torch.full_like(state["source"], s), state["source"])
            state["pos_i"] = torch.where(tgt, gi.to(POS_DTYPE),
                                         state["pos_i"])
            state["pos_j"] = torch.where(tgt, gj.to(POS_DTYPE),
                                         state["pos_j"])
            # a Python int: a fill on the device, no copy from the host
            state["frame"] = torch.where(
                tgt, torch.full_like(state["frame"], int(frame_numbers[s])),
                state["frame"])
    state["introduced_once"] = torch.ones_like(state["introduced_once"])
    return state


def introduction_movement(params: LayerParams, state: dict, flow,
                          halo: int | None = None):
    """An introduction layer's state moved by ``flow`` (``_movement`` of
    its rgb, source, positions, frame numbers and alpha). Returns (state,
    moving, src_i, src_j)."""
    channels = {"rgb": state["rgb"], "source": state["source"],
                "pos_i": state["pos_i"], "pos_j": state["pos_j"],
                "frame": state["frame"]}
    channels, alpha, (moving, src_i, src_j) = _movement(
        params, channels, state["alpha"], flow, halo)
    return dict(state, **channels, alpha=alpha), moving, src_i, src_j


def introduction_eligible(params: LayerParams, state: dict,
                          moving: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: where the moved ``state`` takes new pixels, under the
    layer's ``introduce_*`` flags in the JAX package's order
    (core.py:410-425); ``introduce_once`` reads the state's
    ``introduced_once``."""
    cfg = params.cfg
    filled = state["alpha"] != 0
    mask = torch.ones_like(filled)
    if not cfg.introduce_pixels_on_empty_spots:
        mask = mask & filled
    if not cfg.introduce_pixels_on_filled_spots:
        mask = mask & ~filled
    if not cfg.introduce_moving_pixels:
        mask = mask & ~moving
    if not cfg.introduce_unmoving_pixels:
        mask = mask & moving
    if cfg.introduce_on_all_filled_spots:
        mask = mask | filled
    if cfg.introduce_on_all_empty_spots:
        mask = mask | ~filled
    if cfg.introduce_once:
        mask = mask & ~state["introduced_once"]
    return mask


def render_layer(params: LayerParams, state: dict):
    """Layer.render (layer.py:32-34): alpha *= mask_alpha, kept in the
    state (core.py:457-478); without a mask the state passes through.
    Returns (state, rgba uint8)."""
    mask = params.mask_alpha
    if params.cfg.classname == "introduction":
        alpha = state["alpha"]
        if mask is not None:
            alpha = (mask * alpha.float()).clamp(0, 255).to(ALPHA_DTYPE)
            state = dict(state, alpha=alpha)
        return state, torch.cat([state["rgb"], alpha[..., None]], dim=-1)
    if mask is None:
        return state, state["rgba"]
    rgba = state["rgba"]
    alpha = (mask * rgba[..., 3].float()).to(torch.uint8)
    rgba = torch.cat([rgba[..., :3], alpha[..., None]], dim=-1)
    return dict(state, rgba=rgba), rgba


def build_compositor(layer_params: Sequence[LayerParams], height: int,
                     width: int, background_color: str = "#ffffff",
                     halo: int | None = None, device=None):
    """Build the compositor functions.

    Returns (init_fn, step_fn) where
      init_fn() -> state (list of layer state dicts)
      step_fn(state, flow, pixmaps, key, frame_numbers, render=True)
          -> (state, rgb | None)
    with ``step_fn.update`` and ``step_fn.render``. ``pixmaps`` holds one
    tuple per layer of (H, W, C) uint8 tensors, one per source. ``key`` is
    a ``prng`` key; it splits into one key per layer, and a random-reset
    layer draws its uniforms from its own (core.py:518, :278).

    Every layer updates through ``ops/compositor.py``: moveref and sum
    layers through ``layer_update`` (kernels K0 and K1 on the card, which
    draw the random reset in registers), introduction layers through
    ``introduction_update`` (K0 and K3), static layers through
    ``static_blit`` (K4); the stack renders through ``composite`` (K2). On
    the CPU each runs its plain version.

    ``halo``: the bounded movement gather for H-sharded runs (see
    ``movement_targets``). The state lies whole on one device, under a
    mesh too: the JAX package's sharded gather under a mesh that splits H
    equals the bounded one.

    Parity: transflow/compositor/compositor.py:17-53."""
    device = resolve_device(device)
    bg_color = torch.tensor(parse_color(background_color), dtype=torch.uint8,
                            device=device)
    default_params = list(layer_params)

    def init_fn():
        return [init_layer_state(p) for p in default_params]

    def update_fn(state, flow, pixmaps, key, frame_numbers,
                  params_list=None):
        params_list = default_params if params_list is None else params_list
        if not params_list:
            return []
        keys = prng.split(key, len(params_list))
        new_state = []
        for idx, params in enumerate(params_list):
            classname = params.cfg.classname
            if classname == "introduction":
                new_state.append(kernels.introduction_update(
                    params, state[idx], flow, pixmaps[idx],
                    frame_numbers[idx], halo))
            elif classname == "static":
                new_state.append(kernels.static_blit(params, state[idx],
                                                     pixmaps[idx]))
            else:
                random = params.cfg.reset_mode == "random"
                new_state.append(kernels.layer_update(
                    params, state[idx], flow, pixmaps[idx],
                    keys[idx] if random else None, halo))
        return new_state

    def render_fn(state, params_list=None):
        params_list = default_params if params_list is None else params_list
        return kernels.composite(params_list, state, bg_color, height,
                                 width)

    def step_fn(state, flow, pixmaps, key, frame_numbers, render=True,
                params_list=None):
        state = update_fn(state, flow, pixmaps, key, frame_numbers,
                          params_list)
        if not render:
            return state, None
        return render_fn(state, params_list)

    step_fn.init = init_fn
    step_fn.update = update_fn
    step_fn.render = render_fn
    return init_fn, step_fn


def make_layer_params(layer_cfgs: Sequence[LayerConfig], height: int,
                      width: int, sources_by_layer: dict,
                      device=None) -> list[LayerParams]:
    """Assemble LayerParams for each config.

    ``sources_by_layer`` maps layer index (cfg.index) to a list of
    (channel_count, introduction_mask ndarray | None) tuples."""
    out = []
    for cfg in layer_cfgs:
        specs = sources_by_layer.get(cfg.index, [])
        intro_masks = []
        channel_counts = []
        for channels, mask in specs:
            if mask is None:
                mask = np.ones((height, width), dtype=bool)
            intro_masks.append(mask)
            channel_counts.append(channels)
        out.append(LayerParams(cfg, height, width, intro_masks,
                               channel_counts, device))
    return out

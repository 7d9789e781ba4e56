"""Functional compositor core of the port: the moveref layer.

Counterpart of transflow_tpu/compositor/core.py. A layer update is a
function of the layer's state dict of tensors, as in JAX; the reference's
scatter permutation is the same masked gather (``new[p] = data[p +
flow[p]]`` for targets p), and the only scatter left writes a constant
(``ops/scatter.py::scatter_any``). Everything is integer or selection logic
and matches the JAX package bit for bit given the same flow and key: the
random reset draws ``prng.uniform`` from the same threefry key as
``jax.random.uniform``.

Ported: the moveref class with its four reset modes. The introduction, sum
and static classes and mask files wait for ROADMAP Queue 1 (items 7 and 4).
"""
from typing import Sequence

import numpy as np
import torch

from .. import prng
from .._device import resolve_device
from ..config import LayerConfig
from ..ops.halo_gather import (bounded_row_gather, clamped_rows,
                               sharded_bounded_gather)
from ..ops.scatter import scatter_any
from ..utils import parse_color

# compact carry dtypes of the JAX package (core.py:47-49): in-frame
# coordinates fit int16, alpha is 0..255, source indexes < 256 pixmaps
POS_DTYPE = torch.int16
ALPHA_DTYPE = torch.uint8
SOURCE_DTYPE = torch.uint8

_MASKS = ("mask_alpha", "mask_src", "mask_dst", "reset_mask")


def _require_moveref(cfg: LayerConfig) -> None:
    if cfg.classname != "moveref":
        raise NotImplementedError(
            f"layer class {cfg.classname!r} is not ported yet: ROADMAP "
            "Queue 1, item 7 (other layer classes)")


class LayerParams:
    """Per-layer parameters: the config and the per-source introduction
    masks on ``device``. The config's masks (``mask_alpha``, ``mask_src``,
    ``mask_dst``, ``reset_mask``) are None, meaning all ones: the layers
    that read them are not ported yet."""

    def __init__(self, cfg: LayerConfig, height: int, width: int,
                 intro_masks: Sequence[np.ndarray],
                 channel_counts: Sequence[int], device=None):
        for name in _MASKS:
            if getattr(cfg, name) is not None:
                raise NotImplementedError(
                    f"{name}={getattr(cfg, name)!r}: layer masks are not "
                    "ported yet: ROADMAP Queue 1, item 7 (other layer "
                    "classes and layer masks)")
        self.cfg = cfg
        self.height = height
        self.width = width
        self.device = resolve_device(device)
        self.mask_alpha = self.mask_src = self.mask_dst = None
        self.reset_mask = None
        self.intro_masks = tuple(
            torch.as_tensor(np.asarray(m, dtype=bool), device=self.device)
            for m in intro_masks)
        self.channel_counts = tuple(channel_counts)
        self.num_sources = len(self.intro_masks)

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
    """Identity mapping, opaque (reference.py:38-42)."""
    _require_moveref(params.cfg)
    h, w = params.height, params.width
    if not (h < 32768 and w < 32768):
        raise ValueError("POS_DTYPE int16 requires dims < 32768")
    if len(params.intro_masks) >= 256:
        raise ValueError("SOURCE_DTYPE uint8 caps sources at 255")
    ii, jj = _base_coords(h, w, params.device)
    return {
        "pos_i": ii.to(POS_DTYPE),
        "pos_j": jj.to(POS_DTYPE),
        "alpha": torch.ones((h, w), dtype=ALPHA_DTYPE, device=params.device),
        "source": params.base_source(),
        "rgba": torch.zeros((h, w, 4), dtype=torch.uint8,
                            device=params.device),
    }


def _movement(params: LayerParams, channels: dict, alpha: torch.Tensor,
              flow: torch.Tensor, halo: int | None = None, mesh=None):
    """Apply the flow permutation to ``channels`` + ``alpha``.

    Parity: transflow/compositor/layers/movement.py:20-64 as a masked
    gather. Returns (channels, alpha, (moving, src_i, src_j)).

    ``halo``: source reads go through the bounded-displacement gather
    (ops/halo_gather.py), exact for |flow_y| <= halo; under a ``mesh``
    whose ``space`` axis splits H into shards of at least ``halo`` rows,
    through its sharded form (JAX's rule, core.py:191-204)."""
    cfg = params.cfg
    h, w = params.height, params.width
    di = torch.round(flow[..., 1]).to(torch.int32)
    dj = torch.round(flow[..., 0]).to(torch.int32)
    moving = (di != 0) | (dj != 0)
    ii, jj = _base_coords(h, w, flow.device)
    src_i = (ii + di).clamp(0, h - 1)
    src_j = (jj + dj).clamp(0, w - 1)
    n = mesh.shape.get("space", 1) if mesh is not None else 1
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
        if n > 1 and h % n == 0 and 1 <= halo <= h // n:
            def gather(x):
                return sharded_bounded_gather(x, src_i, src_j, halo, mesh)
        else:
            def gather(x):
                return bounded_row_gather(x, src_i, src_j, halo)

    filled = alpha != 0
    g_alpha = gather(alpha)
    g_channels = {k: gather(v) for k, v in channels.items()}
    # mask_src is all ones (LayerParams)
    is_target = moving if cfg.transparent_pixels_can_move \
        else moving & gather(filled)
    if not cfg.pixels_can_move_to_empty_spot:
        is_target = is_target & filled
    if not cfg.pixels_can_move_to_filled_spot:
        is_target = is_target & ~filled

    def sel(mask, a, b):
        return torch.where(mask[..., None] if a.dim() == 3 else mask, a, b)

    out = {k: sel(is_target, g_channels[k], v) for k, v in channels.items()}
    new_alpha = torch.where(is_target, g_alpha, alpha)
    if cfg.moving_pixels_leave_empty_spot:
        flat_eff = (eff_i.long() * w + src_j.long()).reshape(-1)
        is_source = scatter_any((h, w), flat_eff, is_target)
        new_alpha = torch.where(is_source, torch.zeros_like(new_alpha),
                                new_alpha)
    arrived = is_target & (g_alpha != 0) if cfg.transparent_pixels_can_move \
        else is_target
    new_alpha = torch.where(arrived, torch.ones_like(new_alpha), new_alpha)
    return out, new_alpha, (moving, src_i, src_j)


def _gather_pixmap_slices(params: LayerParams, pixmaps, gi, gj):
    """Each source's (H, W, channel_counts[s]) pixmap read at (gi, gj)."""
    h, w = params.height, params.width
    flat = (gi.long() * w + gj.long()).reshape(-1)
    for s in range(params.num_sources):
        pixmap = pixmaps[s]
        yield pixmap.reshape(h * w, -1)[flat].reshape(h, w, -1)


def _reset(params: LayerParams, state: dict, rand=None) -> dict:
    """Parity: transflow/compositor/layers/reference.py:58-91.

    ``rand``: the (H, W) f32 uniform draw of the random mode
    (``build_compositor`` draws it with ``prng.uniform`` from the layer's
    key, as core.py does with ``jax.random.uniform``)."""
    cfg = params.cfg
    mode = cfg.reset_mode
    if mode == "off":
        return state
    h, w = params.height, params.width
    ii, jj = _base_coords(h, w, state["pos_i"].device)
    pos_i, pos_j = state["pos_i"], state["pos_j"]
    if mode == "random":
        # reset_mask is all ones: the threshold is the factor in f32
        threshold = torch.tensor(cfg.reset_random_factor, dtype=torch.float32,
                                 device=rand.device)
        reset = rand < threshold
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
        factor = float(np.float32(cfg.reset_constant_step))
        step_i = step_i * factor
        step_j = step_j * factor
        norm_scaled = torch.maximum(step_i.abs(), step_j.abs())
        overshoot = norm_scaled > norm_base
        step_i = torch.where(overshoot, d_i, step_i)
        step_j = torch.where(overshoot, d_j, step_j)
    elif mode == "linear":
        factor = float(np.float32(cfg.reset_linear_factor))
        step_i = factor * d_i
        step_j = factor * d_j
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


def _reference_rgba(params: LayerParams, state: dict, pixmaps) -> dict:
    """Regather rgba from the coordinate mapping.

    Parity: transflow/compositor/layers/reference.py:93-105, including the
    reference's per-source sequential alpha handling for 3-channel
    pixmaps."""
    h, w = params.height, params.width
    rgba = state["rgba"]
    rgb = rgba[..., :3]
    a = rgba[..., 3]
    mi = state["pos_i"].clamp(0, h - 1)
    mj = state["pos_j"].clamp(0, w - 1)
    slices = _gather_pixmap_slices(params, pixmaps, mi, mj)
    for s, gathered in enumerate(slices):
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
                   rand=None, halo: int | None = None, mesh=None) -> dict:
    """MoveReferenceLayer.update (move_reference.py:12-14). ``rand`` is the
    random reset's uniform draw (only read in that mode); ``halo`` and
    ``mesh`` select the movement gather (``_movement``)."""
    channels = {"pos_i": state["pos_i"], "pos_j": state["pos_j"],
                "source": state["source"]}
    channels, alpha, _ = _movement(params, channels, state["alpha"], flow,
                                   halo, mesh)
    state = dict(state, **channels, alpha=alpha)
    state = _reset(params, state, rand)
    return _reference_rgba(params, state, pixmaps)


def render_layer(params: LayerParams, state: dict):
    """Layer.render (layer.py:32-34): alpha *= mask_alpha, which is all
    ones here, so the state passes through. Returns (state, rgba uint8)."""
    return state, state["rgba"]


def build_compositor(layer_params: Sequence[LayerParams], height: int,
                     width: int, background_color: str = "#ffffff",
                     halo: int | None = None, mesh=None, device=None):
    """Build the compositor functions.

    Returns (init_fn, step_fn) where
      init_fn() -> state (list of layer state dicts)
      step_fn(state, flow, pixmaps, key, frame_numbers, render=True)
          -> (state, rgb | None)
    with ``step_fn.update`` and ``step_fn.render``. ``pixmaps`` holds one
    tuple per layer of (H, W, C) uint8 tensors, one per source. ``key`` is
    a ``prng`` key; it splits into one key per layer, and a random-reset
    layer draws its uniforms from its own (core.py:518, :278).

    ``halo``: the bounded movement gather for H-sharded runs, under
    ``mesh`` (a ``SpaceMesh``) its sharded form; see ``_movement``.

    Parity: transflow/compositor/compositor.py:17-53."""
    for params in layer_params:
        _require_moveref(params.cfg)
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
            rand = None
            if params.cfg.reset_mode == "random":
                rand = prng.uniform(keys[idx], (params.height, params.width),
                                    flow.device)
            new_state.append(update_moveref(params, state[idx], flow,
                                            pixmaps[idx], rand, halo, mesh))
        return new_state

    def render_fn(state, params_list=None):
        params_list = default_params if params_list is None else params_list
        image = bg_color.expand(height, width, 3)
        new_state = []
        for idx, params in enumerate(params_list):
            st, rgba = render_layer(params, state[idx])
            new_state.append(st)
            image = torch.where((rgba[..., 3] != 0)[..., None],
                                rgba[..., :3], image)
        return new_state, image

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

"""The compositor's moveref step and render: kernels K0 (the leave-empty
sources), K1 (a moveref or sum layer's update) and K2 (the composite).

Counterpart of transflow_tpu/compositor/core.py's ``update_moveref``,
``update_sum`` (the movement, the random reset's draw, the reset and the
regather) and ``render_layer`` over ``build_compositor``'s layer stack,
which XLA compiles from jnp ops (there is no Pallas source). Each kernel
has three functions, as the Farneback ops have: ``*_plain``, the plain
PyTorch version (the port's compositor/core.py functions, called with the
kernel's arguments, groups included); ``*_cuda``, which launches the
hand-written kernel of ``csrc/compositor.cu`` and counts its launches; and
the dispatcher, which sends CPU tensors to the first and CUDA tensors to
the second, with no fallback between them. The two agree bit for bit.

A launch takes at most ``MAX_SOURCES`` sources (K1) or ``MAX_LAYERS``
layers (K2) by value; more go over several launches (``group``), each
carrying the running rgba or image, which gives the one-pass result: both
loops are sequential selections. The plain versions take ``group`` too and
regather over the same groups.

The random reset's key is a layer's ``prng`` key (uint32 (2,)), passed to
K1 as two launch arguments: no copy and no host sync.
"""
import ctypes
import functools

import numpy as np
import torch

from .. import prng
from .._device import check_cuda, cuda_stream, dispatch, kernel_library, \
    launch

# what a launch takes (csrc/compositor.cu: kMaxSources, kMaxLayers)
MAX_SOURCES = 8
MAX_LAYERS = 8
# K0, K1 and K2 launches of one compositor step (update and render) on
# the card over one moveref or sum layer of at most MAX_SOURCES sources
# that leaves no empty spots (the flagship's stack)
MOVEREF_PER_FRAME = (0, 1, 1)

# csrc/compositor.cu's flag bits
_SUM = 1 << 0
_CONTINUE = 1 << 1
_TRANSPARENT = 1 << 2
_TO_EMPTY = 1 << 3
_TO_FILLED = 1 << 4
_LEAVE_EMPTY = 1 << 5
_RESET_SOURCE = 1 << 6
_POS_IN32 = 1 << 7
_POS_OUT32 = 1 << 8
_MODE_SHIFT = 9
_MODES = {"off": 0, "random": 1, "constant": 2, "linear": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int


class _UpdateArgs(ctypes.Structure):
    """csrc/compositor.cu's UpdateArgs (K0 and K1)."""
    _fields_ = [(name, _P) for name in (
        "flow", "pos_i", "pos_j", "alpha", "source", "rgba", "out_pos_i",
        "out_pos_j", "out_alpha", "out_source", "out_rgba", "mask_src",
        "mask_dst", "reset_factor", "reset_source", "marks")] + [
        ("pixmaps", _P * MAX_SOURCES), ("channels", _I * MAX_SOURCES)] + [
        (name, _I) for name in ("num_sources", "first_source", "H", "W",
                                "halo", "flags", "factor_plane")] + [
        ("key0", ctypes.c_uint), ("key1", ctypes.c_uint)]


class _RenderLayer(ctypes.Structure):
    """csrc/compositor.cu's RenderLayer (one layer of K2)."""
    _fields_ = [(name, _P) for name in ("rgb", "alpha", "mask", "out")] + [
        (name, _I) for name in ("rgb_stride", "alpha_stride", "clip")]


class _CompositeArgs(ctypes.Structure):
    """csrc/compositor.cu's CompositeArgs (K2)."""
    _fields_ = [("layers", _RenderLayer * MAX_LAYERS), ("background", _P),
                ("image", _P), ("out", _P), ("num_layers", _I), ("n", _I)]


@functools.cache
def _check_abi() -> None:
    """Raise unless the ctypes mirrors have the kernels' struct sizes."""
    lib = kernel_library()
    for which, struct in enumerate((_UpdateArgs, _CompositeArgs)):
        size = lib.query("transflow_compositor_args_size", which)
        if size != ctypes.sizeof(struct):
            raise RuntimeError(f"{struct.__name__} is {ctypes.sizeof(struct)}"
                               f" bytes here, {size} in csrc/compositor.cu")


def _core():
    # the plain versions are compositor/core.py's functions; imported at
    # call time, since core.py imports this module
    from ..compositor import core
    return core


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# The checks both versions make
# ---------------------------------------------------------------------------

def _check_plane(name: str, t: torch.Tensor, shape: tuple, dtypes) -> None:
    if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape or \
            t.dtype not in dtypes:
        got = (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) \
            else type(t).__name__
        raise ValueError(f"{name} must be {shape} "
                         f"{'/'.join(str(d) for d in dtypes)}, got {got}")


def _check_group(group: int, most: int) -> None:
    if not (isinstance(group, int) and 1 <= group <= most):
        raise ValueError(f"group must be an int in [1, {most}], got {group}")


def _check_update(params, state: dict, flow: torch.Tensor, pixmaps, key,
                  group: int) -> None:
    """Raise unless the arguments are what K1 takes: a moveref or sum
    layer's state, an (H, W, 2) float32 flow, one (H, W, C) uint8 pixmap a
    source with C its channel count (3 or 4), a key in random mode."""
    classname = params.cfg.classname
    if classname not in ("moveref", "sum"):
        raise ValueError(f"layer_update takes moveref and sum layers, not "
                         f"{classname}")
    h, w = params.height, params.width
    _check_plane("flow", flow, (h, w, 2), (torch.float32,))
    for name in ("pos_i", "pos_j"):
        _check_plane(name, state[name], (h, w), (torch.int16, torch.int32))
    if state["pos_i"].dtype != state["pos_j"].dtype:
        raise ValueError("pos_i and pos_j must have one dtype")
    for name in ("alpha", "source"):
        _check_plane(name, state[name], (h, w), (torch.uint8,))
    _check_plane("rgba", state["rgba"], (h, w, 4), (torch.uint8,))
    if len(pixmaps) != params.num_sources:
        raise ValueError(f"the layer has {params.num_sources} sources, got "
                         f"{len(pixmaps)} pixmaps")
    for s, (pixmap, channels) in enumerate(zip(pixmaps,
                                               params.channel_counts)):
        if channels not in (3, 4):
            raise ValueError(f"source {s} has {channels} channels: pixmaps "
                             "have 3 or 4")
        _check_plane(f"pixmap {s}", pixmap, (h, w, channels), (torch.uint8,))
    if params.cfg.reset_mode == "random":
        k = np.asarray(key) if key is not None else None
        if k is None or k.shape != (2,) or k.dtype != np.uint32:
            raise ValueError("the random reset needs the layer's key, "
                             f"uint32 of shape (2,), got {key!r}")
    _check_group(group, MAX_SOURCES)


def _check_composite(params_list, states, background: torch.Tensor,
                     height: int, width: int, group: int) -> None:
    """Raise unless the arguments are what K2 takes: one state a layer
    with (H, W, 4) uint8 ``rgba``, or ``rgb`` (H, W, 3) and ``alpha`` (H,
    W) uint8 for an introduction layer, and a (3,) uint8 background."""
    if len(states) != len(params_list):
        raise ValueError(f"{len(params_list)} layers, {len(states)} states")
    _check_plane("background", background, (3,), (torch.uint8,))
    for params, state in zip(params_list, states):
        if (params.height, params.width) != (height, width):
            raise ValueError(f"a layer of {params.height}x{params.width} in "
                             f"a {height}x{width} stack")
        if params.cfg.classname == "introduction":
            _check_plane("rgb", state["rgb"], (height, width, 3),
                         (torch.uint8,))
            _check_plane("alpha", state["alpha"], (height, width),
                         (torch.uint8,))
        else:
            _check_plane("rgba", state["rgba"], (height, width, 4),
                         (torch.uint8,))
    _check_group(group, MAX_LAYERS)


# ---------------------------------------------------------------------------
# K0: the sources that targets leave empty
# ---------------------------------------------------------------------------

def leave_empty_sources_plain(params, state: dict, flow: torch.Tensor,
                              halo: int | None = None) -> torch.Tensor:
    """(H, W) bool: the pixels some target of the movement reads, where
    ``moving_pixels_leave_empty_spot`` empties them (``scatter_any`` over
    the movement's targets, core.py ``_movement``)."""
    return _core().leave_empty_sources(params, state["alpha"], flow, halo)


def _update_args(params, state: dict, flow: torch.Tensor, halo,
                 flags: int) -> _UpdateArgs:
    """K0's and K1's arguments for ``params``'s movement over ``state``."""
    cfg = params.cfg
    for on, bit in ((cfg.transparent_pixels_can_move, _TRANSPARENT),
                    (cfg.pixels_can_move_to_empty_spot, _TO_EMPTY),
                    (cfg.pixels_can_move_to_filled_spot, _TO_FILLED)):
        if on:
            flags |= bit
    if state["pos_i"].dtype == torch.int32:
        flags |= _POS_IN32
    return _UpdateArgs(
        flow=flow.data_ptr(), pos_i=state["pos_i"].data_ptr(),
        pos_j=state["pos_j"].data_ptr(), alpha=state["alpha"].data_ptr(),
        source=state["source"].data_ptr(), rgba=state["rgba"].data_ptr(),
        mask_src=_ptr(params.mask_src), mask_dst=_ptr(params.mask_dst),
        H=params.height, W=params.width,
        halo=-1 if halo is None else int(halo), flags=flags)


def leave_empty_sources_cuda(params, state: dict, flow: torch.Tensor,
                             halo: int | None = None,
                             out: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Kernel K0 on contiguous tensors on one CUDA device: marks (uint8 1)
    in ``out`` (H, W) uint8, which must be all zero (a new zeroed buffer
    when None), and returns it. ``leave_empty_sources_cuda.launches``
    counts launches."""
    h, w = params.height, params.width
    if params.cfg.classname != "moveref":
        raise ValueError("leave_empty_sources takes moveref layers, not "
                         f"{params.cfg.classname}")
    _check_plane("flow", flow, (h, w, 2), (torch.float32,))
    if out is None:
        out = torch.zeros((h, w), dtype=torch.uint8, device=flow.device)
    _check_plane("out", out, (h, w), (torch.uint8,))
    masks = [m for m in (params.mask_src, params.mask_dst) if m is not None]
    check_cuda("leave_empty_sources_cuda", flow, state["alpha"], out, *masks)
    _check_abi()
    args = _update_args(params, state, flow, halo, _LEAVE_EMPTY)
    args.marks = out.data_ptr()
    launch(flow.device, "transflow_leave_empty_sources",
           ctypes.addressof(args), cuda_stream(flow))
    leave_empty_sources_cuda.launches += 1
    return out


leave_empty_sources_cuda.launches = 0


# ---------------------------------------------------------------------------
# K1: a moveref or sum layer's update
# ---------------------------------------------------------------------------

def layer_update_plain(params, state: dict, flow: torch.Tensor, pixmaps,
                       key=None, halo: int | None = None,
                       group: int = MAX_SOURCES) -> dict:
    """A moveref or sum layer's new state: the port's ``update_moveref``
    or ``update_sum`` (core.py), the draw ``prng.uniform`` of ``key`` in
    random mode, the regather over the sources in groups of ``group``."""
    _check_update(params, state, flow, pixmaps, key, group)
    core = _core()
    rand = None
    if params.cfg.reset_mode == "random":
        rand = prng.uniform(key, (params.height, params.width), flow.device)
    if params.cfg.classname == "sum":
        state = core.sum_movement(state, flow)
    else:
        state = core.moveref_movement(params, state, flow, halo)
    state = core._reset(params, state, rand)
    for first in range(0, max(params.num_sources, 1), group):
        state = core._reference_rgba(
            params, state, pixmaps,
            range(first, min(first + group, params.num_sources)))
    return state


def layer_update_cuda(params, state: dict, flow: torch.Tensor, pixmaps,
                      key=None, halo: int | None = None,
                      group: int = MAX_SOURCES) -> dict:
    """Kernel K1 on contiguous tensors on one CUDA device (after K0 where
    the layer leaves empty spots), one launch a group of ``group``
    sources; returns new state tensors (it never writes the caller's).
    ``layer_update_cuda.launches`` counts K1's launches,
    ``leave_empty_sources_cuda.launches`` K0's."""
    _check_update(params, state, flow, pixmaps, key, group)
    cfg = params.cfg
    h, w = params.height, params.width
    tensors = [flow, *(state[k] for k in ("pos_i", "pos_j", "alpha",
                                          "source", "rgba")), *pixmaps]
    masks = [m for m in (params.mask_src, params.mask_dst,
                         params.reset_factor) if m is not None]
    check_cuda("layer_update_cuda", *tensors, *masks)
    _check_abi()
    device = flow.device
    stream = cuda_stream(flow)
    sum_layer = cfg.classname == "sum"
    out_dtype = torch.int32 if sum_layer else state["pos_i"].dtype
    new = {"pos_i": torch.empty((h, w), dtype=out_dtype, device=device),
           "pos_j": torch.empty((h, w), dtype=out_dtype, device=device),
           "alpha": torch.empty((h, w), dtype=torch.uint8, device=device),
           "source": torch.empty((h, w), dtype=torch.uint8, device=device),
           "rgba": torch.empty((h, w, 4), dtype=torch.uint8, device=device)}
    flags = (_MODES[cfg.reset_mode] << _MODE_SHIFT) | (
        _POS_OUT32 if out_dtype == torch.int32 else 0)
    if sum_layer:
        flags |= _SUM
    marks = None
    if cfg.moving_pixels_leave_empty_spot and not sum_layer:
        flags |= _LEAVE_EMPTY
        marks = leave_empty_sources_cuda(params, state, flow, halo)
    if cfg.reset_source and cfg.reset_mode == "random":
        flags |= _RESET_SOURCE
    args = _update_args(params, state, flow, halo, flags)
    for name in ("pos_i", "pos_j", "alpha", "source", "rgba"):
        setattr(args, f"out_{name}", new[name].data_ptr())
    if marks is not None:
        args.marks = marks.data_ptr()
    if params.reset_factor is not None:
        args.reset_factor = params.reset_factor.data_ptr()
        args.factor_plane = int(params.reset_factor.dim() == 2)
    if flags & _RESET_SOURCE:
        args.reset_source = params.last_source_plane.data_ptr()
    if cfg.reset_mode == "random":
        args.key0, args.key1 = (int(k) for k in np.asarray(key))
    for first in range(0, max(params.num_sources, 1), group):
        if first:
            # a later group: the regather alone, over the new state and
            # the running rgba
            args.flags = _CONTINUE | (_POS_IN32 if out_dtype == torch.int32
                                      else 0)
            for name in ("pos_i", "pos_j", "alpha", "source", "rgba"):
                setattr(args, name, new[name].data_ptr())
        count = min(group, params.num_sources - first)
        args.num_sources, args.first_source = count, first
        for k in range(count):
            args.pixmaps[k] = pixmaps[first + k].data_ptr()
            args.channels[k] = params.channel_counts[first + k]
        launch(device, "transflow_layer_update", ctypes.addressof(args),
               stream)
        layer_update_cuda.launches += 1
    return new


layer_update_cuda.launches = 0


def layer_update(params, state: dict, flow: torch.Tensor, pixmaps,
                 key=None, halo: int | None = None,
                 group: int = MAX_SOURCES) -> dict:
    """Dispatcher of K1 (and K0) by the flow's device. ``key``: the
    layer's ``prng`` key, read in random mode only."""
    flow = flow.contiguous()
    state = {k: v.contiguous() for k, v in state.items()}
    pixmaps = tuple(x.contiguous() for x in pixmaps)
    fn = dispatch("layer_update", layer_update_plain, layer_update_cuda,
                  flow, *(state[k] for k in ("pos_i", "alpha", "rgba")),
                  *pixmaps)
    return fn(params, state, flow, pixmaps, key, halo, group)


# ---------------------------------------------------------------------------
# K2: the layer stack over the background
# ---------------------------------------------------------------------------

def composite_plain(params_list, states, background: torch.Tensor,
                    height: int, width: int, group: int = MAX_LAYERS):
    """(new states, (H, W, 3) uint8 image): ``render_layer`` (core.py) of
    each layer in order, each drawn over the image where its alpha is not
    0, starting from ``background`` ((3,) uint8); groups of ``group``
    layers carry the image."""
    _check_composite(params_list, states, background, height, width, group)
    core = _core()
    image = background.expand(height, width, 3)
    new_states = []
    for first in range(0, len(params_list), group):
        for params, state in zip(params_list[first:first + group],
                                 states[first:first + group]):
            state, rgba = core.render_layer(params, state)
            new_states.append(state)
            image = torch.where((rgba[..., 3] != 0)[..., None],
                                rgba[..., :3], image)
    return new_states, image


def composite_cuda(params_list, states, background: torch.Tensor,
                   height: int, width: int, group: int = MAX_LAYERS):
    """Kernel K2 on contiguous tensors on one CUDA device, one launch a
    group of ``group`` layers (one for none); returns (new states, image)
    and writes no tensor it was given. ``composite_cuda.launches`` counts
    launches."""
    _check_composite(params_list, states, background, height, width, group)
    tensors = [background]
    for params, state in zip(params_list, states):
        if params.cfg.classname == "introduction":
            tensors += [state["rgb"], state["alpha"]]
        else:
            tensors.append(state["rgba"])
        if params.mask_alpha is not None:
            tensors.append(params.mask_alpha)
    check_cuda("composite_cuda", *tensors)
    _check_abi()
    device = background.device
    stream = cuda_stream(background)
    image = torch.empty((height, width, 3), dtype=torch.uint8, device=device)
    args = _CompositeArgs(background=background.data_ptr(),
                          out=image.data_ptr(), n=height * width)
    new_states = []
    for first in range(0, max(len(params_list), 1), group):
        layers = list(zip(params_list[first:first + group],
                          states[first:first + group]))
        args.num_layers = len(layers)
        for k, (params, state) in enumerate(layers):
            mask = params.mask_alpha
            layer = args.layers[k]
            if params.cfg.classname == "introduction":
                layer.rgb, layer.rgb_stride = state["rgb"].data_ptr(), 3
                layer.alpha, layer.alpha_stride = state["alpha"].data_ptr(), 1
                layer.clip = 1
                if mask is not None:
                    state = dict(state, alpha=torch.empty_like(
                        state["alpha"]))
                    layer.out = state["alpha"].data_ptr()
            else:
                rgba = state["rgba"]
                layer.rgb, layer.rgb_stride = rgba.data_ptr(), 4
                layer.alpha, layer.alpha_stride = rgba.data_ptr() + 3, 4
                layer.clip = 0
                if mask is not None:
                    state = dict(state, rgba=torch.empty_like(rgba))
                    layer.out = state["rgba"].data_ptr()
            layer.mask = _ptr(mask)
            new_states.append(state)
        if first:
            args.image = image.data_ptr()   # the running image, in place
        launch(device, "transflow_composite", ctypes.addressof(args), stream)
        composite_cuda.launches += 1
    return new_states, image


composite_cuda.launches = 0


def composite(params_list, states, background: torch.Tensor, height: int,
              width: int, group: int = MAX_LAYERS):
    """Dispatcher of K2 by the background's device."""
    fn = dispatch("composite", composite_plain, composite_cuda, background,
                  *(t for state in states for t in state.values()))
    return fn(params_list, states, background, height, width, group)

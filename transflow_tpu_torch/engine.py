"""Device engine of the port: estimation + post-process + merge + upscale +
compositor per frame, owning all device-resident state.

Counterpart of transflow_tpu/engine.py. PyTorch runs eagerly, so there is
no jit: ``process_frame`` runs the per-frame device step once and
``process_chunk`` is a Python loop over the same step. The Engine's key is
JAX's threefry key of ``cfg.seed`` (``prng``), split once per frame on both
paths as in the JAX Engine, so the random reset draws the JAX Engine's
numbers and a chunk is bit-equal to the same frames one by one.

Under a ``SpaceMesh`` the estimator's correlation is sharded over the
mesh's devices (``mesh_safe_kwargs``); everything else runs on
``mesh.devices[0]``, the compositor's movement through the ``halo``'s
bounded gather, which equals the JAX package's sharded one.
"""
import logging
from typing import Sequence

import numpy as np
import torch

from . import prng
from ._device import resolve_device
from .compositor.core import LayerParams, build_compositor
from .config import Config
from .flow import Direction
from .flow.estimators import get_estimator
from .flow.merge import get_merge_function
from .flow.sources.base import FlowItem, FlowSource
from .ops.image import upscale_flow
from .ops.render import flow_magnitude, render1d, render2d
from .parallel.mesh import mesh_device

logger = logging.getLogger(__name__)

# the checkpoint entry of the Engine's key, the JAX Engine's entry
RNG_STATE_KEY = "rng_key"
# the generator state an earlier port's checkpoints hold instead
_LEGACY_RNG_KEY = "torch_generator_state"


def _to_device(array, device, dtype: torch.dtype | None = None):
    """A host array or tensor as a tensor on ``device`` (no copy when it
    is there already)."""
    if not isinstance(array, torch.Tensor):
        array = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        array = array.to(dtype)
    return array.to(device)


def _tree_to_device(tree, device):
    """Tuples of tuples of arrays (or None) onto ``device``."""
    return tuple(tuple(None if x is None else _to_device(x, device)
                       for x in layer) for layer in tree)


class SourceRuntime:
    """Device-side state for one flow source."""

    def __init__(self, source: FlowSource, estimator_step, device=None,
                 mesh=None):
        self.source = source
        self.estimator_step = estimator_step  # None for flow-yielding sources
        self.device = resolve_device(device)
        self.mesh = mesh
        self.prev_gray = None
        self.prev_flow = None
        self.last_raw = None
        self._cfg_version = getattr(getattr(source, "config", None),
                                    "version", None)

    def _maybe_rejit(self):
        """Live tuning: ``config.update`` bumps ``config.version``; rebuild
        the estimator step with the new hyper-parameters (the network's
        weights carry over)."""
        config = getattr(self.source, "config", None)
        if config is None or config.version == self._cfg_version:
            return
        self._cfg_version = config.version
        old = self.estimator_step
        params = (old.params if old is not None
                  and old.method == config.method else None)
        self.estimator_step = make_estimator_step(
            config.method, mesh_safe_estimator_kwargs(config, self.mesh),
            self.source.direction, device=self.device, params=params)

    def reset(self, prime_frame):
        h, w = self.source.height, self.source.width
        self.prev_gray = _to_device(prime_frame, self.device)
        self.prev_flow = torch.zeros((h, w, 2), dtype=torch.float32,
                                     device=self.device)

    def ingest(self, item: FlowItem):
        """Consume a FlowItem, return the raw device flow for this tick."""
        if item.kind == FlowItem.REPLAY:
            if item.discarded is not None:
                self._advance(item.discarded, keep=False)
            if self.last_raw is None:
                raise RuntimeError("Lock replay before first flow")
            return self.last_raw
        return self._advance(item, keep=True)

    def _advance(self, item: FlowItem, keep: bool):
        if item.kind == FlowItem.FLOW:
            raw = _to_device(item.array, self.device, torch.float32)
        else:
            if item.prime is not None:
                self.reset(item.prime)
            self._maybe_rejit()
            gray = _to_device(item.array, self.device)
            raw = self.estimator_step(self.prev_gray, gray, self.prev_flow)
            self.prev_gray = gray
            if keep:
                self.prev_flow = raw
        if keep:
            self.last_raw = raw
        return raw


def mesh_safe_kwargs(kwargs: dict, method: str, mesh) -> dict:
    """Estimator kwargs for execution under ``mesh`` (None off-mesh, where
    they pass through). Parity: engine.py::mesh_safe_kwargs. The bounded
    warp behind lfn_warp_bound is stripped, with a warning, as in the JAX
    package (whose Pallas warp has no SPMD rule); LiteFlowNet's
    correlation runs sharded over the mesh ('pallas_halo')."""
    kwargs = dict(kwargs)
    if mesh is not None and kwargs.get("warp_bound"):
        logger.warning(
            "lfn_warp_bound=%s is ignored under a mesh (the bounded warp "
            "is not sharded, as in the JAX package); using the exact "
            "gather path", kwargs["warp_bound"])
        kwargs["warp_bound"] = 0
    if mesh is not None and method == "liteflownet":
        kwargs["corr_kernel"] = "pallas_halo"
        kwargs["corr_mesh"] = mesh
    return kwargs


def mesh_safe_estimator_kwargs(config, mesh) -> dict:
    """``mesh_safe_kwargs`` over a flow-source config's estimator kwargs."""
    return mesh_safe_kwargs(config.estimator_kwargs(), config.method, mesh)


def make_estimator_step(method: str, estimator_kwargs: dict,
                        direction: Direction, device=None, params=None):
    """(prev_gray, gray, prev_flow) -> raw flow for one source.

    Frame ordering parity: transflow/flow/sources/cv.py:467-474 (forward
    pairs (prev, next); backward pairs (next, prev)). ``step.params`` is
    the estimator's network (the ``LiteFlowNet`` module from
    ``get_weights(device=...)``, or ``params`` when given) and ``step.fn``
    the call with the network as an argument."""
    estimator = get_estimator(method)
    if params is None and method == "liteflownet":
        from .flow.estimators.liteflownet import get_weights
        params = get_weights(device=device)

    def fn(prev_gray, gray, prev_flow, params):
        if direction == Direction.FORWARD:
            left, right = prev_gray, gray
        else:
            left, right = gray, prev_gray
        if method in ("farneback", "horn-schunck"):
            return estimator(left, right, prev_flow, **estimator_kwargs)
        if method == "liteflownet":
            return estimator(left, right, net=params, **estimator_kwargs)
        return estimator(left, right, **estimator_kwargs)

    def step(prev_gray, gray, prev_flow):
        return fn(prev_gray, gray, prev_flow, step.params)

    step.fn = fn
    step.params = () if params is None else params
    step.method = method
    return step


class Engine:
    """Owns the per-frame device step and the device state."""

    def __init__(self,
                 cfg: Config,
                 flow_sources: Sequence[FlowSource],
                 layer_params: Sequence[LayerParams],
                 out_height: int,
                 out_width: int,
                 width_factor: int = 1,
                 height_factor: int = 1,
                 export_flows: bool = False,
                 mesh=None,
                 halo: int | None = None,
                 device=None):
        """``layer_params`` live on ``device``, the current CUDA device
        by default (no card and no ``device`` raises). ``mesh``: a
        ``SpaceMesh``; the network and the state then live on
        ``mesh.devices[0]`` (the default ``device``; one that disagrees
        raises) and LiteFlowNet's correlation is sharded over the mesh.
        ``halo``: the bounded movement-gather displacement (under a mesh
        the JAX package shards that gather; its result is the same); pair
        it with a clip filter for exactness."""
        self.cfg = cfg
        self.device = mesh_device(mesh, device)
        self.mesh = mesh
        self.halo = halo
        self.out_height = out_height
        self.out_width = out_width
        self.width_factor = width_factor
        self.height_factor = height_factor
        self.export_flows = export_flows
        self.key = prng.key(cfg.seed)
        self.runtimes: list[SourceRuntime] = []
        for source in flow_sources:
            estimator_step = None
            if source.yields_frames:
                estimator_step = make_estimator_step(
                    source.config.method,
                    mesh_safe_estimator_kwargs(source.config, mesh),
                    source.direction, device=self.device)
            self.runtimes.append(
                SourceRuntime(source, estimator_step, device=self.device,
                              mesh=mesh))
        postprocesses = [src.build_postprocess(device=self.device)
                         for src in flow_sources]
        merge = get_merge_function(cfg.flows_merging_function)
        self.layer_params = list(layer_params)
        init_fn, comp_step = build_compositor(
            self.layer_params, out_height, out_width,
            cfg.compositor_background, halo=halo, device=self.device)
        self.comp_state = init_fn()
        render_mode = ("flow" if cfg.view_flow
                       else "magnitude" if cfg.view_flow_magnitude
                       else "compositor" if any(
                           p.num_sources for p in self.layer_params) else None)
        self.render_mode = render_mode
        wf, hf = width_factor, height_factor

        def device_step(comp_state, raw_flows, t, pixmaps, key,
                        frame_numbers, params_list):
            processed = [pp(raw, t) for pp, raw in zip(postprocesses,
                                                      raw_flows)]
            flow = merge(processed)
            if wf != 1 or hf != 1:
                flow = upscale_flow(flow, wf, hf)
            comp_state = comp_step.update(comp_state, flow, pixmaps, key,
                                          frame_numbers, params_list)
            if render_mode == "flow":
                frame = render2d(flow, cfg.render_scale, cfg.render_colors)
            elif render_mode == "magnitude":
                frame = render1d(flow_magnitude(flow), cfg.render_scale,
                                 cfg.render_colors, cfg.render_binary)
            elif render_mode == "compositor":
                comp_state, frame = comp_step.render(comp_state, params_list)
            else:
                frame = torch.zeros((out_height, out_width, 3),
                                    dtype=torch.uint8, device=self.device)
            return comp_state, frame, flow

        self._device_step = device_step
        self._framerate = 30.0  # set by the caller before chunking

    # ------------------------------------------------------------------

    def process_chunk(self, source_chunks, const_pixmaps, pix_chunks,
                      base_frame: int, frame0: int):
        """Process K stacked frames per source, one device step each.

        ``source_chunks``: one stacked array per flow source, a (K, H, W[,
        3]) uint8 frame chunk for a frame-yielding source (estimated with
        its warm-start carry) or a (K, H, W, 2) raw-flow chunk for a
        flow-yielding one. ``const_pixmaps``/``pix_chunks``: per-layer
        tuples of per-source slots; a constant source holds its (H, W, C)
        array in the first (None in the second), a video source a (K, H,
        W, C) chunk in the second (None in the first). ``t`` of step k is
        ``float32((base_frame + k) / framerate)``, computed in float64 as in
        the JAX Engine. Returns the (K, H', W', 3) uint8 frames, and the K
        post-processed flows when the Engine exports flows (else ``()``)."""
        const_pixmaps = _tree_to_device(const_pixmaps, self.device)
        pix_chunks = _tree_to_device(pix_chunks, self.device)
        ts = np.float32((base_frame + np.arange(len(source_chunks[0])))
                        / self._framerate)
        chunks = []
        for runtime, chunk in zip(self.runtimes, source_chunks):
            if runtime.estimator_step is None:
                chunks.append(_to_device(chunk, self.device, torch.float32))
            else:
                runtime._maybe_rejit()
                chunks.append(_to_device(chunk, self.device))
        frames, flows = [], []
        for k, t in enumerate(ts):
            raws = []
            for runtime, chunk in zip(self.runtimes, chunks):
                if runtime.estimator_step is None:
                    raws.append(chunk[k])
                    continue
                raw = runtime.estimator_step(runtime.prev_gray, chunk[k],
                                             runtime.prev_flow)
                runtime.prev_gray = chunk[k]
                runtime.prev_flow = raw
                raws.append(raw)
            pixmaps = tuple(
                tuple(const if chunk is None else chunk[k]
                      for const, chunk in zip(const_layer, chunk_layer))
                for const_layer, chunk_layer in zip(const_pixmaps,
                                                    pix_chunks))
            fno = frame0 + k
            frame_numbers = tuple(tuple(fno for _ in p.channel_counts)
                                  for p in self.layer_params)
            self.key, sub = prng.split(self.key)
            self.comp_state, frame, flow = self._device_step(
                self.comp_state, tuple(raws), t, pixmaps, sub, frame_numbers,
                self.layer_params)
            frames.append(frame)
            if self.export_flows:
                flows.append(flow)
        for runtime, chunk in zip(self.runtimes, chunks):
            runtime.last_raw = (chunk[-1] if runtime.estimator_step is None
                                else runtime.prev_flow)
        return torch.stack(frames), (torch.stack(flows) if self.export_flows
                                     else ())

    def process_frame(self, items: Sequence[FlowItem], pixmaps, t: float,
                      frame_numbers):
        """One frame: items (one per flow source) -> (rgb, flow) tensors.

        ``pixmaps``: tuple per layer of tuples per source of uint8 arrays
        on the device; ``frame_numbers`` mirrors it with ints."""
        raw_flows = tuple(rt.ingest(item)
                          for rt, item in zip(self.runtimes, items))
        self.key, sub = prng.split(self.key)
        self.comp_state, frame, flow = self._device_step(
            self.comp_state, raw_flows, np.float32(t),
            _tree_to_device(pixmaps, self.device), sub, frame_numbers,
            self.layer_params)
        return frame, flow

    # ------------------------------------------------------------------
    # checkpoint support
    # ------------------------------------------------------------------

    def state_arrays(self) -> dict:
        """Compositor state and key as named numpy arrays, with the JAX
        Engine's names and dtypes: a checkpoint of either package resumes
        in the other."""
        out = {RNG_STATE_KEY: self.key.copy()}
        for idx, layer_state in enumerate(self.comp_state):
            for name, value in layer_state.items():
                out[f"layer{idx}.{name}"] = value.cpu().numpy()
        return out

    def load_state_arrays(self, arrays: dict):
        """Load ``state_arrays`` of either package. The generator state of
        an earlier port's checkpoint cannot become a key and is ignored."""
        if RNG_STATE_KEY in arrays:
            key = np.array(arrays[RNG_STATE_KEY])
            if key.shape != (2,):
                raise ValueError(f"checkpoint {RNG_STATE_KEY!r} has shape "
                                 f"{key.shape}, expected (2,)")
            self.key = key.astype(np.uint32)
        elif _LEGACY_RNG_KEY in arrays:
            logger.warning(
                "checkpoint RNG entry %r (a torch generator state) is "
                "ignored: the Engine keeps its key under %r",
                _LEGACY_RNG_KEY, RNG_STATE_KEY)
        new_state = []
        for idx, layer_state in enumerate(self.comp_state):
            loaded = {}
            for name, value in layer_state.items():
                stored = arrays.get(f"layer{idx}.{name}")
                if stored is None:
                    loaded[name] = value
                else:
                    # cast to the live carry dtype (older checkpoints store
                    # int32 leaves)
                    loaded[name] = torch.from_numpy(
                        np.array(stored)).to(value.dtype).to(self.device)
            new_state.append(loaded)
        self.comp_state = new_state

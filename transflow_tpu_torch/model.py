"""FlowTransferModel of the port: the flagship per-frame step.

Counterpart of transflow_tpu/model.py: estimator -> post-process -> merge
-> upscale -> compositor update -> render, for one frame (``step``) or a
chunk (``scan``, a Python loop over ``step``). PyTorch runs eagerly, so
there is no jit form. ``key`` is a ``prng`` key, JAX's threefry key data,
so the random reset draws the JAX model's numbers.

Ported: Farneback (``takes_prev``: the previous raw flow warm-starts it
with flag 4) and LiteFlowNet (its weights loaded only for that method),
both directions, the flow filters, mask and kernel, every layer class,
and the ``halo``/``mesh`` movement gather. The other estimators raise
``NotImplementedError`` naming their ROADMAP item.
"""
from typing import Sequence

import numpy as np
import torch

from . import prng
from .compositor.core import build_compositor, make_layer_params
from .config import LayerConfig
from .flow import Direction
from .flow.estimators import get_estimator
from .flow.merge import get_merge_function
from .flow.transforms import make_postprocess
from .ops.image import upscale_flow
from .parallel.mesh import mesh_device


class FlowTransferModel:

    def __init__(self,
                 height: int,
                 width: int,
                 layer_cfgs: Sequence[LayerConfig] | None = None,
                 sources_by_layer: dict | None = None,
                 method: str = "farneback",
                 estimator_kwargs: dict | None = None,
                 direction: Direction = Direction.BACKWARD,
                 flow_filters: str | None = None,
                 mask: np.ndarray | None = None,
                 kernel: np.ndarray | None = None,
                 background_color: str = "#ffffff",
                 width_factor: int = 1,
                 height_factor: int = 1,
                 framerate: float = 30.0,
                 halo: int | None = None,
                 mesh=None,
                 device=None):
        """``halo``: the bounded movement gather; ``mesh``: a
        ``SpaceMesh``, under which the gather is sharded and everything
        else runs on ``mesh.devices[0]`` (``device`` defaults to it, and
        without a mesh to the current CUDA device: with no card and no
        ``device`` the constructor raises; pass ``device="cpu"`` for the
        CPU). ``estimator_kwargs`` reach the
        estimator as they are (``corr_kernel``, ``corr_mesh``, ...)."""
        # every argument but the placement, for ``replica``
        self._build_args = {k: v for k, v in locals().items()
                            if k not in ("self", "mesh", "device")}
        self.height = height
        self.width = width
        self.out_height = height * height_factor
        self.out_width = width * width_factor
        self.framerate = framerate
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        estimator = get_estimator(method)
        postprocess = make_postprocess(flow_filters, mask, kernel, direction,
                                       device=self.device)
        merge = get_merge_function("first")
        if layer_cfgs is None:
            layer_cfgs = [LayerConfig(0)]
        if sources_by_layer is None:
            sources_by_layer = {
                0: [(3, np.ones((self.out_height, self.out_width), bool))]}
        self.layer_params = make_layer_params(
            layer_cfgs, self.out_height, self.out_width, sources_by_layer,
            device=self.device)
        init_fn, comp_step = build_compositor(
            self.layer_params, self.out_height, self.out_width,
            background_color, halo=halo, mesh=mesh, device=self.device)
        self._comp_init = init_fn
        self._comp_step = comp_step
        estimator_kwargs = dict(estimator_kwargs or {})
        wf, hf = width_factor, height_factor
        takes_prev = method in ("farneback", "horn-schunck")
        # LiteFlowNet's weights: a checkpoint, or the random weights the
        # environment allows (liteflownet.py::get_weights); None for the
        # classic estimators
        self.net = None
        if method == "liteflownet":
            from .flow.estimators.liteflownet import get_weights
            self.net = get_weights(device=self.device)

        def estimate(prev_gray, gray, prev_flow):
            if direction == Direction.FORWARD:
                left, right = prev_gray, gray
            else:
                left, right = gray, prev_gray
            if method == "liteflownet":
                return estimator(left, right, net=self.net,
                                 **estimator_kwargs)
            if takes_prev:
                return estimator(left, right, prev_flow, **estimator_kwargs)
            return estimator(left, right, **estimator_kwargs)

        def step(state, frame, pixmaps, t, key, frame_numbers, params_list):
            raw = estimate(state["prev_gray"], frame, state["prev_flow"])
            flow = merge([postprocess(raw, t)])
            if wf != 1 or hf != 1:
                flow = upscale_flow(flow, wf, hf)
            comp = self._comp_step.update(state["comp"], flow, pixmaps, key,
                                          frame_numbers, params_list)
            comp, rgb = self._comp_step.render(comp, params_list)
            new_state = {"comp": comp, "prev_gray": frame, "prev_flow": raw}
            return new_state, rgb

        self._step = step

    # ------------------------------------------------------------------

    def replica(self, mesh=None, device=None) -> "FlowTransferModel":
        """This model placed on ``mesh`` (a ``SpaceMesh``) or ``device``:
        itself where it is placed so already, else a new model built with
        the same arguments there (its parameters are made again, from the
        same configs)."""
        here = self.mesh.devices if self.mesh is not None else None
        there = mesh.devices if mesh is not None else None
        if here == there and self.device == mesh_device(mesh, device):
            return self
        args = dict(self._build_args)
        kwargs = args["estimator_kwargs"]
        if kwargs and kwargs.get("corr_mesh") is not None:
            # the sharded correlation runs over the replica's own mesh
            args["estimator_kwargs"] = {**kwargs, "corr_mesh": mesh}
        return FlowTransferModel(**args, mesh=mesh, device=device)

    def init_state(self, first_gray) -> dict:
        return {
            "comp": self._comp_init(),
            "prev_gray": torch.as_tensor(first_gray, dtype=torch.uint8,
                                         device=self.device),
            "prev_flow": torch.zeros((self.height, self.width, 2),
                                     dtype=torch.float32, device=self.device),
        }

    def default_pixmaps(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        return tuple(
            tuple(torch.as_tensor(
                rng.integers(0, 256, (self.out_height, self.out_width,
                                      channels), dtype=np.uint8),
                device=self.device)
                  for channels in params.channel_counts)
            for params in self.layer_params)

    def default_frame_numbers(self, value: int = 0):
        return tuple(tuple(value for _ in params.channel_counts)
                     for params in self.layer_params)

    def step(self, state, gray, pixmaps, t, key, frame_numbers,
             params_list=None):
        """One frame: (state, (H, W, 3) uint8 frame) -> (state, rgb).
        ``key`` is a ``prng`` key (uint32 (2,))."""
        if params_list is None:
            params_list = self.layer_params
        gray = torch.as_tensor(gray, dtype=torch.uint8, device=self.device)
        return self._step(state, gray, pixmaps, t, key, frame_numbers,
                          params_list)

    def scan(self, state, grays, pixmaps, t0, key, params_list=None,
             frame0: int = 0):
        """Process a (K, H, W[, 3]) chunk of frames in order, ``key`` split
        into one key per frame (model.py:183); returns (state, (K, H', W',
        3) uint8 frames)."""
        keys = prng.split(key, len(grays))
        rgbs = []
        for idx in range(len(grays)):
            fno = frame0 + idx
            frame_numbers = tuple(tuple(fno for _ in p.channel_counts)
                                  for p in self.layer_params)
            t = t0 + idx / self.framerate
            state, rgb = self.step(state, grays[idx], pixmaps, t, keys[idx],
                                   frame_numbers, params_list)
            rgbs.append(rgb)
        return state, torch.stack(rgbs)

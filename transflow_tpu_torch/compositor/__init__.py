"""Stateful host-facing Compositor over the functional core.

Counterpart of transflow_tpu/compositor/__init__.py (parity reference:
transflow/compositor/compositor.py:17-53: from_args / update / render /
set_pixmap), with the state on ``device`` (the current CUDA device by
default; ``device="cpu"`` for the CPU). The key is the JAX Compositor's
threefry key of ``seed`` (``prng``), split once per update, so the random
reset draws the JAX Compositor's numbers.
"""
from typing import Sequence

import numpy as np
import torch

from .. import prng
from .._device import resolve_device
from ..config import LayerConfig
from .core import (LayerParams, build_compositor, init_layer_state,
                   make_layer_params, render_layer, update_introduction,
                   update_moveref, update_static, update_sum)

__all__ = [
    "Compositor", "LayerParams", "build_compositor", "init_layer_state",
    "make_layer_params", "render_layer", "update_introduction",
    "update_moveref", "update_static", "update_sum",
]


class Compositor:

    def __init__(self, height: int, width: int,
                 layer_cfgs: Sequence[LayerConfig],
                 sources_by_layer: dict,
                 background_color: str = "#ffffff",
                 seed: int = 0, device=None):
        self.height = height
        self.width = width
        self.device = resolve_device(device)
        self.layer_cfgs = list(layer_cfgs)
        self.background_color = background_color
        self.layer_params = make_layer_params(
            layer_cfgs, height, width, sources_by_layer, device=self.device)
        init_fn, step_fn = build_compositor(
            self.layer_params, height, width, background_color,
            device=self.device)
        self._step = step_fn
        self.state = init_fn()
        self.key = prng.key(seed)
        # per-layer lists of current pixmaps + frame numbers, fed by the host
        self.pixmaps: list[list] = [
            [torch.zeros((height, width, c), dtype=torch.uint8,
                         device=self.device) for c in p.channel_counts]
            for p in self.layer_params]
        self.frame_numbers: list[list[int]] = [
            [0] * p.num_sources for p in self.layer_params]

    @classmethod
    def from_args(cls, height: int, width: int,
                  layer_cfgs: Sequence[LayerConfig],
                  background_color: str = "#ffffff",
                  sources_by_layer: dict | None = None,
                  seed: int = 0, device=None) -> "Compositor":
        return cls(height, width, layer_cfgs,
                   sources_by_layer if sources_by_layer is not None else {},
                   background_color, seed, device)

    def set_pixmap(self, layer_pos: int, source_pos: int, pixmap,
                   frame_number: int | None = None):
        """Feed the next frame of a pixmap source (host numpy or tensor)."""
        if not isinstance(pixmap, torch.Tensor):
            pixmap = torch.from_numpy(np.ascontiguousarray(pixmap))
        self.pixmaps[layer_pos][source_pos] = pixmap.to(self.device)
        if frame_number is None:
            frame_number = self.frame_numbers[layer_pos][source_pos] + 1
        self.frame_numbers[layer_pos][source_pos] = frame_number

    def update(self, flow):
        self.key, sub = prng.split(self.key)
        if not isinstance(flow, torch.Tensor):
            flow = torch.from_numpy(np.ascontiguousarray(flow))
        pixmaps = tuple(tuple(src) for src in self.pixmaps)
        frames = tuple(tuple(src) for src in self.frame_numbers)
        self.state = self._step.update(
            self.state, flow.to(self.device, torch.float32), pixmaps, sub,
            frames)

    def render(self) -> np.ndarray:
        self.state, image = self._step.render(self.state)
        return image.cpu().numpy()

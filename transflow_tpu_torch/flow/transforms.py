"""Flow post-processing: filters -> mask -> kernel -> direction -> clip.

Counterpart of transflow_tpu/flow/transforms.py (parity reference:
transflow/flow/sources/source.py:337-363, post_process). The chain is
built once per source; its mask and kernel are copied to the device then,
not per frame. The forward direction's conversion is kernel B5 on the card
(``ops/scatter.py::forward_to_backward``), bit-equal to the JAX package's
scatter.
"""
from typing import Sequence

import numpy as np
import torch

from . import Direction
from .filters import FlowFilter
from .._device import resolve_device
from ..ops.image import clip_to_frame, conv2d_same
from ..ops.scatter import forward_to_backward

__all__ = ["clip_to_frame", "forward_to_backward", "make_postprocess"]


def make_postprocess(flow_filters: Sequence[FlowFilter] | str | None = None,
                     mask: np.ndarray | None = None,
                     kernel: np.ndarray | None = None,
                     direction: Direction = Direction.BACKWARD,
                     device=None):
    """Build fn(flow, t) -> flow for (H, W, 2) flows on ``device`` (the
    current CUDA device by default): the filters in order, times the (H,
    W) float ``mask``, the ``kernel``'s 'same' convolution of each
    component, the forward-to-backward conversion for
    ``Direction.FORWARD``, then ``clip_to_frame``. ``fn.mask`` is the mask
    on the device (None without one)."""
    if isinstance(flow_filters, str):
        flow_filters = FlowFilter.parse_many(flow_filters)
    filters = tuple(flow_filters or ())
    if mask is not None or kernel is not None:
        device = resolve_device(device)
    mask_t = None if mask is None else torch.as_tensor(
        np.asarray(mask, dtype=np.float32), device=device)
    kernel_t = None if kernel is None else torch.as_tensor(
        np.asarray(kernel, dtype=np.float32), device=device)

    def postprocess(flow, t):
        flow = flow.float()
        for flt in filters:
            flow = flt(flow, t)
        if mask_t is not None:
            flow = flow * (mask_t[..., None] if mask_t.dim() == 2 else mask_t)
        if kernel_t is not None:
            flow = conv2d_same(flow.movedim(-1, 0), kernel_t).movedim(0, -1)
        if direction == Direction.FORWARD:
            flow = forward_to_backward(flow)
        return clip_to_frame(flow)

    postprocess.mask = mask_t
    return postprocess

"""Flow post-processing of the port. Counterpart of
transflow_tpu/flow/transforms.py: the flagship's chain (backward direction,
no filters, mask or kernel) is ``clip_to_frame`` alone."""
import torch

from . import Direction

_NOT_PORTED = "not ported yet: ROADMAP Queue 1, item 6 (flow post-processing)"


def clip_to_frame(flow: torch.Tensor) -> torch.Tensor:
    """Clamp so every target x+fx stays in [0, W-1] and y+fy in [0, H-1].

    Parity: source.py:250-263,361-362 (fx_min/fx_max/fy_min/fy_max tables)."""
    h, w = flow.shape[:2]
    ii = torch.arange(h, dtype=torch.float32,
                      device=flow.device)[:, None].expand(h, w)
    jj = torch.arange(w, dtype=torch.float32,
                      device=flow.device)[None, :].expand(h, w)
    fx = torch.clamp(flow[..., 0], -jj, (w - 1) - jj)
    fy = torch.clamp(flow[..., 1], -ii, (h - 1) - ii)
    return torch.stack([fx, fy], dim=-1)


def make_postprocess(flow_filters=None, mask=None, kernel=None,
                     direction: Direction = Direction.BACKWARD):
    """Build fn(flow, t) -> flow. Only the default chain is
    ported; filters, a mask, a kernel or the forward direction raise."""
    if flow_filters:
        raise NotImplementedError(f"flow filters are {_NOT_PORTED}")
    if mask is not None:
        raise NotImplementedError(f"flow masks are {_NOT_PORTED}")
    if kernel is not None:
        raise NotImplementedError(f"flow kernels are {_NOT_PORTED}")
    if direction != Direction.BACKWARD:
        raise NotImplementedError(f"direction {direction.name.lower()} "
                                  f"(forward_to_backward) is {_NOT_PORTED}")

    def postprocess(flow, t):
        return clip_to_frame(flow.float())

    return postprocess

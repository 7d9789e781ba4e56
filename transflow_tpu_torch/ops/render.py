"""Flow visualization renderers (the Engine's ``view_flow`` and
``view_flow_magnitude`` modes). Counterpart of transflow_tpu/ops/render.py;
f32 math in the same order, so the uint8 frames are bit-equal."""
import torch

from ..utils import parse_color

DEFAULT_COLORS_1D = ("#000000", "#ffffff")
DEFAULT_COLORS_2D = ("#ffff00", "#0000ff", "#ff00ff", "#00ff00")


def _color(color: str, device) -> torch.Tensor:
    return torch.tensor(parse_color(color), dtype=torch.float32,
                        device=device)


def _to_uint8(frame: torch.Tensor) -> torch.Tensor:
    return frame.clamp(0, 255).to(torch.uint8)


def render1d(arr, scale: float = 1.0, colors=None, binary: bool = False):
    """Map a scalar (H, W) field onto a 2-color gradient (or binary split)."""
    if colors is None:
        colors = DEFAULT_COLORS_1D
    c0 = _color(colors[0], arr.device)
    c1 = _color(colors[1], arr.device)
    arr = arr.float()[..., None]
    if binary:
        coeff = torch.round(scale * arr).clamp(0.0, 1.0)
        coeff_a, coeff_b = 1.0 - coeff, coeff
    else:
        coeff_a = (1.0 - scale * arr).clamp(0.0, 1.0)
        coeff_b = (scale * arr).clamp(0.0, 1.0)
    return _to_uint8(coeff_a * c0 + coeff_b * c1)


def render2d(flow, scale: float = 1.0, colors=None):
    """Map a (H, W, 2) flow onto a 4-color additive mix (±x, ±y)."""
    if colors is None:
        colors = DEFAULT_COLORS_2D
    palette = [_color(c, flow.device) for c in colors]
    fx = flow[..., 0].float()[..., None]
    fy = flow[..., 1].float()[..., None]
    coeff_y = (1.0 + scale * fx).clamp(0.0, 1.0)
    coeff_b = (1.0 - scale * fx).clamp(0.0, 1.0)
    coeff_m = (1.0 + scale * fy).clamp(0.0, 1.0)
    coeff_g = (1.0 - scale * fy).clamp(0.0, 1.0)
    frame = 0.5 * (coeff_y * palette[0] + coeff_b * palette[1]
                   + coeff_m * palette[2] + coeff_g * palette[3])
    return _to_uint8(frame)


def flow_magnitude(flow):
    return torch.sqrt(torch.sum(torch.square(flow.float()), dim=-1))

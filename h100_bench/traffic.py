"""The benchmark's one traffic generator: what a cell's traffic file asks
for, made on the device from the run's seed.

A traffic file gives the frames' size, the clip (its length, the
texture's blur, the pan's amplitudes and frequencies, the noise), the
pixmap, and how frames reach the Engine: ``loop``
``"closed_chunks"`` (a render: ``chunk`` frames a call, ``ahead`` calls in
flight) or ``"open_frames"`` (a live source: one frame a call, arriving
at ``rate_fps``). It also says how many steps set-up runs
(``warm_steps``), how many steps of the window the check keeps
(``probes``) and between which shares of the window's length they fall
(``probe_window``, each drawn from the seed), and how many steps a traced
segment runs (``trace_steps``). The seed changes the texture's and the
pixmap's values, the network's weights and where the kept steps fall,
never a size, a count or an arrival time.

The clip is a blurred random texture panned by a whole number of pixels
a frame, ``dx = int(ax sin(fx t) + ax)`` (0 to ``2 ax``) and ``dy = int(ay
cos(fy t) + ay)`` (0 to ``2 ay``) from frame ``t - 1`` to frame ``t``:
moving content with a known, bounded motion, with a camera's noise
(``noise``: the standard deviation, in levels, of a Gaussian drawn anew
for each frame and pixel, rounded) so that no two frames are exact
shifts of each other. It replays in order from pinned host memory and
loops, with one cut where it does.
"""
import math

import torch

# keys every traffic file holds
TRAFFIC_KEYS = ("loop", "height", "width", "clip_frames", "texture_sigma",
                "pan", "noise", "pixmap", "warm_steps",
                "probe_window", "trace_steps")


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _blur(x: torch.Tensor, sigma: float, dim: int) -> torch.Tensor:
    """Gaussian blur of ``x`` along ``dim`` (radius ``ceil(4 sigma)``,
    edges replicated), its taps added in order."""
    radius = int(math.ceil(4 * sigma))
    taps = [math.exp(-0.5 * (k / sigma) ** 2)
            for k in range(-radius, radius + 1)]
    total = sum(taps)
    n = x.shape[dim]
    idx = torch.arange(-radius, n + radius, device=x.device).clamp(0, n - 1)
    padded = x.index_select(dim, idx)
    acc = padded.narrow(dim, 0, n) * (taps[0] / total)
    for k in range(1, len(taps)):
        acc = acc + padded.narrow(dim, k, n) * (taps[k] / total)
    return acc


def pan(traffic: dict, t: int) -> tuple[int, int]:
    """The pan from clip frame ``t - 1`` to frame ``t``, (dx, dy) pixels."""
    p = traffic["pan"]
    dx = int(p["x_amp"] * math.sin(p["x_freq"] * t) + p["x_amp"])
    dy = int(p["y_amp"] * math.cos(p["y_freq"] * t) + p["y_amp"])
    return dx, dy


def offsets(traffic: dict) -> list[tuple[int, int]]:
    """Each clip frame's (x, y) offset in the texture: the pans summed."""
    out, x, y = [], 0, 0
    for t in range(traffic["clip_frames"]):
        if t:
            dx, dy = pan(traffic, t)
            x, y = x + dx, y + dy
        out.append((x, y))
    return out


def make_clip(traffic: dict, channels: int, gen: torch.Generator,
              device) -> torch.Tensor:
    """The (T, H, W) or (T, H, W, 3) uint8 clip on ``device``."""
    h, w = traffic["height"], traffic["width"]
    where = offsets(traffic)
    span_x = max(x for x, _ in where)
    span_y = max(y for _, y in where)
    base = torch.rand((channels, h + span_y, w + span_x), generator=gen,
                      device=device)
    sigma = traffic["texture_sigma"]
    base = _blur(_blur(base, sigma, 1), sigma, 2)
    lo = base.amin(dim=(1, 2), keepdim=True)
    hi = base.amax(dim=(1, 2), keepdim=True)
    base = (255 * (base - lo) / (hi - lo)).to(torch.uint8)
    frames = []
    for x, y in where:
        crop = base[:, y:y + h, x:x + w]
        noise = torch.randn(crop.shape, generator=gen, device=device)
        frames.append((crop.float() + torch.round(traffic["noise"] * noise))
                      .clamp(0, 255).to(torch.uint8))
    clip = torch.stack(frames).permute(0, 2, 3, 1)
    return (clip[..., 0] if channels == 1 else clip).contiguous()


def make_pixmap(traffic: dict, gen: torch.Generator,
                device) -> torch.Tensor:
    """The still (H, W, 3) uint8 pixmap: uniform random colours."""
    if traffic["pixmap"] != "uniform":
        raise ValueError(f"unknown pixmap {traffic['pixmap']!r}")
    return torch.randint(0, 256, (traffic["height"], traffic["width"], 3),
                         generator=gen, device=device, dtype=torch.uint8)


def make_weights(config: dict, template: dict, gen: torch.Generator,
                 device) -> dict | None:
    """The network's state dict drawn from ``gen`` in two calls, when the
    configuration has one (``weights``): each convolution's weight
    He-normal (``std sqrt(2 / fan_in)``), its bias normal times
    ``bias_std``, and the upsamplers' taps bilinear, as the network
    initialises them. ``template`` maps each parameter name to its
    float32 tensor of the right shape (the reference network's)."""
    spec = config.get("weights")
    if spec is None:
        return None
    if spec["init"] != "he_normal":
        raise ValueError(f"unknown weight init {spec['init']!r}")
    convs = [k for k, v in template.items() if k.endswith(".weight")]
    biases = [k for k, v in template.items() if k.endswith(".bias")]
    n_w = sum(template[k].numel() for k in convs)
    n_b = sum(template[k].numel() for k in biases)
    flat_w = torch.randn(n_w, generator=gen, device=device)
    flat_b = torch.randn(n_b, generator=gen, device=device)
    state, at = {}, 0
    for k in convs:
        shape = template[k].shape
        fan_in = shape[1] * shape[2] * shape[3]
        state[k] = (flat_w[at:at + template[k].numel()].reshape(shape)
                    * math.sqrt(2.0 / fan_in))
        at += template[k].numel()
    at = 0
    for k in biases:
        state[k] = (flat_b[at:at + template[k].numel()]
                    * spec["bias_std"])
        at += template[k].numel()
    for k, v in template.items():
        if k not in state:
            state[k] = v.to(device)
    return state

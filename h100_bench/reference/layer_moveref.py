"""The compositor's moveref layer (transflow's MoveReferenceLayer) with its
random reset, and the render of the layer over the background, in plain
PyTorch: the reference of the ``moveref`` layer class.

The layer's state maps each output pixel to a pixel of its source:
``pos_i``, ``pos_j`` (int16), ``alpha`` and ``source`` (uint8), and the
regathered ``rgba``. A frame moves it by the rounded flow (a pixel reads
the state at ``p + round(flow[p])`` where that pixel is filled), resets
each pixel whose uniform draw falls below the reset factor to its own
coordinates, and regathers the colours from the pixmap.

Covered: one 3-channel source over the whole frame, no masks, the default
movement flags, reset mode ``random`` or ``off``.

The layer is integer and selection logic and states no precision; its
control (``update(..., control=True)``) breaks the guarantee that a pixel
moves by its flow rounded to the nearest whole pixel: it truncates, as a
float-to-int cast does.
"""
import numpy as np
import torch

from . import prng

LAYER_KEYS = ("pos_i", "pos_j", "alpha", "source", "rgba")


def check_layer(layer: dict) -> None:
    """Raise unless the layer's options are the ones covered."""
    defaults = {"classname": "moveref", "mask_alpha": None, "mask_src": None,
                "mask_dst": None, "transparent_pixels_can_move": False,
                "pixels_can_move_to_empty_spot": True,
                "pixels_can_move_to_filled_spot": True,
                "moving_pixels_leave_empty_spot": False, "reset_mask": None,
                "reset_source": False}
    for key, value in defaults.items():
        if layer.get(key, value) != value:
            raise NotImplementedError(f"the moveref reference covers "
                                      f"{key}={value!r}, got {layer[key]!r}")
    if layer.get("reset_mode", "off") not in ("off", "random"):
        raise NotImplementedError("the moveref reference covers reset "
                                  "modes off and random")


def init_state(height: int, width: int, device) -> dict:
    """The layer's first state: the identity mapping, opaque, source 0,
    rgba zero."""
    ii, jj = _coords(height, width, device)
    return {"pos_i": ii.to(torch.int16).contiguous(),
            "pos_j": jj.to(torch.int16).contiguous(),
            "alpha": torch.ones((height, width), dtype=torch.uint8,
                                device=device),
            "source": torch.zeros((height, width), dtype=torch.uint8,
                                  device=device),
            "rgba": torch.zeros((height, width, 4), dtype=torch.uint8,
                                device=device)}


def _coords(h: int, w: int, device):
    ii = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    jj = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return ii.expand(h, w), jj.expand(h, w)


def update(state: dict, flow: torch.Tensor, pixmap: torch.Tensor, key,
           layer: dict, control: bool = False) -> dict:
    """The state after one frame of ``flow`` ((H, W, 2) float32, already
    clipped to the frame); ``pixmap`` (H, W, 3) uint8; ``key`` the layer's
    key of this frame; ``control`` truncates the displacement."""
    h, w = state["alpha"].shape
    ii, jj = _coords(h, w, flow.device)
    whole = torch.trunc if control else torch.round
    di = whole(flow[..., 1]).to(torch.int32)
    dj = whole(flow[..., 0]).to(torch.int32)
    moving = (di != 0) | (dj != 0)
    src_i = (ii + di).clamp(0, h - 1)
    src_j = (jj + dj).clamp(0, w - 1)
    flat = (src_i.long() * w + src_j.long()).reshape(-1)

    def gather(x):
        return x.reshape((h * w,) + x.shape[2:])[flat].reshape(x.shape)

    alpha = state["alpha"]
    target = moving & gather(alpha != 0)
    new = {key_: torch.where(target, gather(state[key_]), state[key_])
           for key_ in ("pos_i", "pos_j", "source")}
    new_alpha = torch.where(target, gather(alpha), alpha)
    new_alpha = torch.where(target, torch.ones_like(new_alpha), new_alpha)
    if layer.get("reset_mode", "off") == "random":
        factor = torch.tensor(float(np.float32(layer["reset_random_factor"])),
                              dtype=torch.float32, device=flow.device)
        reset = prng.uniform(key, (h, w), flow.device) < factor
        new["pos_i"] = torch.where(reset, ii.to(torch.int16), new["pos_i"])
        new["pos_j"] = torch.where(reset, jj.to(torch.int16), new["pos_j"])
        new_alpha = torch.where(reset, torch.ones_like(new_alpha), new_alpha)
    mi = new["pos_i"].clamp(0, h - 1).long()
    mj = new["pos_j"].clamp(0, w - 1).long()
    gathered = pixmap.reshape(h * w, -1)[(mi * w + mj).reshape(-1)]
    gathered = gathered.reshape(h, w, -1)
    shown = (new["source"] == 0) & (new_alpha != 0)
    rgb = torch.where(shown[..., None], gathered[..., :3],
                      state["rgba"][..., :3])
    rgba = torch.cat([rgb, shown.to(torch.uint8)[..., None]], dim=-1)
    return dict(new, alpha=new_alpha, rgba=rgba)


def render(state: dict, background: str) -> torch.Tensor:
    """The (H, W, 3) uint8 frame: the layer's colours where its alpha is
    not 0, the ``#rrggbb`` background elsewhere."""
    rgba = state["rgba"]
    value = int(background.lstrip("#"), 16)
    bg = torch.tensor([(value >> 16) & 255, (value >> 8) & 255, value & 255],
                      dtype=torch.uint8, device=rgba.device)
    return torch.where((rgba[..., 3] != 0)[..., None], rgba[..., :3],
                       bg.expand_as(rgba[..., :3]))

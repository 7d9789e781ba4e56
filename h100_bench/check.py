"""The comparison that decides a run's ``correct``.

A probe is one step of the timed path (a chunk of a render, a frame of a
live run) that the harness kept: the compositor's state before and after
it (``Engine.state_arrays`` of snapshots taken on the device), the raw
flow of each of its frames as the estimator returned it, and the frames
it rendered, read back into host memory as every step's are. Two probes
are judged: the first step of set-up, which starts from the Engine's
first state, and a step of the measured window drawn from the seed,
which starts from the state the program reached there.

For each probe the reference works out again, from the frames the
harness made, each frame's flow (``reference/<method>.py``). It then
moves the layer (``reference/layer_<class>.py``) from the probe's
starting state (its own first state for set-up's step) by the flows the
program moved it by, each clipped to the frame, and renders it: the
compositor is integer logic that rounds the flow to whole pixels, so it
is judged on the program's flows, where a difference of rounding in the
estimator cannot move a pixel. Three numbers are compared, each the
worst over the probes:

- ``flow_gap``: each frame's raw flow against the reference's, as the
  mean absolute difference over the mean absolute difference between the
  reference at the configuration's precision and the reference in
  float32: the program's gap in units of the gap that the stated
  precision itself opens. A network with random weights amplifies a
  rounding differently from seed to seed; the quotient cancels that, so
  a sound program reads about 1 or less on every seed and a lower
  precision many times more;
- ``state_mismatch``: the share of pixels whose state after the step
  (positions, alpha, source, colours) differs from the reference's;
- ``frame_mismatch``: the share of the step's rendered pixels whose
  colour differs from the reference's.

The control puts the reference in the program's place with its
estimator computed at the precision below the configuration's (its
``precision.control``) and its compositor, which is integer logic and
states no precision, breaking the guarantee that a pixel moves by its
flow rounded to the nearest whole pixel (it truncates): the same numbers
between the control's outputs and the reference's.

Where a probe holds no raw flow for a frame (an Engine that does not call
its source's estimator step once a frame), that frame's flow is not
compared and the reference compositor takes the reference's flow there.
"""
import importlib.util
import pathlib

import torch

REFERENCE_DIR = pathlib.Path(__file__).resolve().parent / "reference"
NUMBERS = ("flow_gap", "state_mismatch", "frame_mismatch")


def load_reference(name: str):
    """``reference/<name>.py`` as a module of the ``h100_bench.reference``
    package."""
    path = REFERENCE_DIR / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reference {path.name} in "
                                f"{REFERENCE_DIR}")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench.reference.{name.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Probe:
    """One kept step: ``positions`` (the clip index of each of its frames,
    after the index of the frame before its first), ``first_frame``
    (frames the Engine processed before it), the state before (None: the
    Engine's first state) and after (checkpoint arrays), the raw flow of
    each frame (None where not kept) and its rendered frames, (K, H, W, 3)
    uint8 on the host."""

    def __init__(self, positions, first_frame, state_before, state_after,
                 raw_flows, frames):
        self.positions = list(positions)
        self.first_frame = first_frame
        self.state_before = state_before
        self.state_after = state_after
        self.raw_flows = list(raw_flows)
        self.frames = frames


class Reference:
    """The configuration's reference over the harness's inputs."""

    def __init__(self, config: dict, clip: torch.Tensor,
                 pixmap: torch.Tensor, weights: dict | None, seed: int,
                 device):
        self.config = config
        self.clip = clip
        self.pixmap = pixmap
        self.seed = seed
        self.device = device
        self.estimator = load_reference(config["cv_config"]["method"])
        self.layers = [load_reference(f"layer_{layer['classname']}")
                       for layer in config["layers"]]
        if len(self.layers) != 1:
            raise NotImplementedError("the check covers one layer")
        self.layers[0].check_layer(config["layers"][0])
        self.net = None
        if weights is not None:
            self.net = self.estimator.network(
                {k: v.float() for k, v in weights.items()}, device)

    def raw_flow(self, prev_index: int, index: int,
                 variant: str = "stated") -> torch.Tensor:
        prev = self.clip[prev_index].to(self.device)
        cur = self.clip[index].to(self.device)
        return self.estimator.flow(prev, cur, self.config["cv_config"],
                                   self.config["direction"],
                                   self.config["precision"], variant,
                                   self.net)

    def raw_flows(self, probe: Probe, variant: str = "stated") -> list:
        """The reference's raw flow of each of the probe's frames, at the
        stated precision, in float32 or as the control."""
        return [self.raw_flow(probe.positions[j - 1], probe.positions[j],
                              variant)
                for j in range(1, len(probe.positions))]

    def compose(self, probe: Probe, flows: list, control: bool = False):
        """(state after, frames) of the reference compositor moved from the
        probe's starting state by ``flows`` (raw, one a frame)."""
        from .reference import prng
        from .reference.image import clip_to_frame
        layer_mod, layer = self.layers[0], self.config["layers"][0]
        h, w = self.pixmap.shape[:2]
        if probe.state_before is None:
            state = layer_mod.init_state(h, w, self.device)
        else:
            state = {k: torch.from_numpy(probe.state_before[f"layer0.{k}"])
                     .to(self.device) for k in layer_mod.LAYER_KEYS}
        keys = prng.frame_keys(self.seed, probe.first_frame, len(flows))
        frames = []
        for raw, key in zip(flows, keys):
            state = layer_mod.update(state, clip_to_frame(raw.float()),
                                     self.pixmap, key, layer, control)
            frames.append(layer_mod.render(state,
                                           self.config["background"]))
        return state, torch.stack(frames)


def flow_gap(got: torch.Tensor, want: torch.Tensor,
             want32: torch.Tensor) -> float:
    """Mean |got - want| over mean |want32 - want| (floored at a millionth
    of mean |want|)."""
    got, want, want32 = got.float(), want.float(), want32.float()
    scale = max(float((want32 - want).abs().mean()),
                1e-6 * float(want.abs().mean()), 1e-30)
    return float((got - want).abs().mean()) / scale


def state_mismatch(got: dict, want: dict, keys) -> float:
    differs = None
    for k in keys:
        d = got[k] != want[k]
        d = d.reshape(d.shape[0], d.shape[1], -1).any(dim=-1)
        differs = d if differs is None else differs | d
    return float(differs.float().mean())


def frame_mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got != want).any(dim=-1).float().mean())


def flow_extent(probes: list) -> dict:
    """How far the window's kept steps moved pixels: the mean absolute
    raw flow (px) of the last probe, and the share of its pixels whose
    rounded flow is not zero."""
    raw = probes[-1].raw_flows[-1].float()
    return {"flow_mean_px": float(raw.abs().mean()),
            "moving_share": float((torch.round(raw) != 0).any(dim=-1)
                                  .float().mean())}


def numbers(reference: Reference, probes: list, control: bool = False
            ) -> dict:
    """The three numbers, each the worst over ``probes``: the program's
    outputs against the reference's, or with ``control`` the control's
    against the reference's."""
    keys = reference.layers[0].LAYER_KEYS
    out = dict.fromkeys(NUMBERS, 0.0)
    for probe in probes:
        ref_raws = reference.raw_flows(probe)
        ref32_raws = reference.raw_flows(probe, "float32")
        if control:
            got_raws = reference.raw_flows(probe, "control")
            got_state, got_frames = reference.compose(probe, got_raws, True)
        else:
            got_raws = [None if raw is None else raw.to(reference.device)
                        for raw in probe.raw_flows]
            got_state = {k: torch.from_numpy(probe.state_after[f"layer0.{k}"])
                         .to(reference.device) for k in keys}
            got_frames = torch.as_tensor(probe.frames).to(reference.device)
        moved_by = [ref if got is None else got
                    for got, ref in zip(got_raws, ref_raws)]
        ref_state, ref_frames = reference.compose(probe, moved_by)
        for got, ref, ref32 in zip(got_raws, ref_raws, ref32_raws):
            if got is not None:
                out["flow_gap"] = max(out["flow_gap"],
                                      flow_gap(got, ref, ref32))
        out["state_mismatch"] = max(out["state_mismatch"], state_mismatch(
            got_state, ref_state, keys))
        out["frame_mismatch"] = max(out["frame_mismatch"], frame_mismatch(
            got_frames, ref_frames))
    return out


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    rows = {name: {"value": values[name], "limit": limits[name]}
            for name in NUMBERS}
    ok = all(row["value"] <= row["limit"] for row in rows.values())
    return ok, rows

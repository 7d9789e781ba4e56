"""The timed path: frames into the Engine, rendered frames back into host
memory, as the port's Pipeline moves them.

``Feed`` holds the clip in pinned host memory and plays it in order from
position 1 (frame 0 primes the estimator), looping with one cut. A step
is one ``Engine.process_chunk`` call over ``chunk`` frames (the
Pipeline's batched loop) or one ``Engine.process_frame`` call (its
per-frame loop, which a stream source takes): the frames are copied up
with ``non_blocking=True``, and the rendered frames are copied into a
new pinned host buffer, as ``Pipeline._read_back`` does, with an event
recorded behind the copy. A step is done when its event is.

A kept step also keeps the compositor's state before and after it and
the raw flow of each of its frames (as the source's estimator step
returns them; where the Engine did not call that step once a frame, only
the last, ``SourceRuntime.last_raw``). Each is copied into host memory
in the stream's order, behind the work that made it, so the harness
holds nothing of its own on the card; set-up sets aside the pinned
buffers that the window's kept steps fill. The steps kept are set-up's
first (``keep_steps``) and, in the measured window, the first step
dispatched at or after each of ``keep_fractions`` of its length.

``render_window`` runs steps in a closed loop with ``ahead`` steps in
flight; ``live_window`` starts one frame each ``1 / rate_fps`` seconds on
a fixed schedule (an open loop) and times each from when it was due until
its frame is in host memory.
"""
import math
import time

import numpy as np
import torch

from .check import Probe
from .system import state_arrays


def _recording(estimate, flows: list, keep):
    """``estimate`` (a source's estimator step) keeping a host copy
    (``keep``) of each raw flow it returns in ``flows``: the flows a kept
    step's frames moved by, which the check drives the reference
    compositor with."""
    def recording(*args):
        raw = estimate(*args)
        flows.append(keep(raw))
        return raw
    recording.__dict__.update(estimate.__dict__)
    return recording


def _tensors(tree) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _map(tree, fn):
    """``tree`` with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


class Step:
    """A dispatched step: its frames' host buffer, the event behind the
    copy (None on the CPU), the host seconds the Engine call took."""

    def __init__(self, index, positions, first_frame, frames, event,
                 host_s):
        self.index = index
        self.positions = positions
        self.first_frame = first_frame
        self.frames = frames
        self.event = event
        self.host_s = host_s

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


class Feed:
    """The clip, the pixmap and the Engine, stepped in order."""

    def __init__(self, engine, clip: torch.Tensor, pixmap: torch.Tensor,
                 traffic: dict, device):
        self.engine = engine
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.chunk = traffic.get("chunk", 1)
        self.live = traffic["loop"] == "open_frames"
        self.framerate = float(traffic.get("framerate", 30.0))
        clip_host = clip.cpu()
        self.length = clip_host.shape[0]
        if self.cuda:
            clip_host = clip_host.pin_memory()
        self.clip_host = clip_host
        # the chunks' host buffers, one for each start in the loop: the
        # frames of a chunk lie in one pinned block, as a decoder's do
        self._chunks = {}
        if not self.live:
            start = 1
            while start not in self._chunks:
                idx = [(start + k) % self.length for k in range(self.chunk)]
                block = clip_host[idx]
                self._chunks[start] = block.pin_memory() if self.cuda \
                    else block
                start = (start + self.chunk) % self.length
        self.pixmap = pixmap
        self.position = 1
        self.frames_done = 0
        self.steps = 0
        self.keep_steps: set = set()
        self.keep_fractions: list = []
        self._keep_at: list = []
        self._spare: dict = {}
        self.probes: list = []
        engine.runtimes[0].reset(clip[0].to(self.device))

    def _keep(self, tensor: torch.Tensor) -> torch.Tensor:
        """A host copy of ``tensor`` as the stream has it now: on the
        card, copied without waiting into a pinned buffer that set-up set
        aside (or a new one)."""
        if not self.cuda:
            return tensor.clone()
        spare = self._spare.get((tuple(tensor.shape), tensor.dtype))
        host = spare.pop() if spare else torch.empty(
            tensor.shape, dtype=tensor.dtype, pin_memory=True)
        host.copy_(tensor, non_blocking=True)
        return host

    def set_aside(self) -> None:
        """Pinned buffers for the window's kept steps, shaped as set-up's
        kept step's: two states and the flows each."""
        if not self.cuda or not self.probes:
            return
        _, _, after, flows = self.probes[0]
        tensors = 2 * _tensors(after) + [f for f in flows if f is not None]
        for _ in self.keep_fractions:
            for t in tensors:
                self._spare.setdefault((tuple(t.shape), t.dtype), []).append(
                    torch.empty(t.shape, dtype=t.dtype, pin_memory=True))

    def arm(self, start: float, seconds: float) -> None:
        """Keep the first step dispatched at or after each of
        ``keep_fractions`` of a window of ``seconds`` from ``start``."""
        self._keep_at = sorted(start + f * seconds
                               for f in self.keep_fractions)

    def keeping(self) -> bool:
        """Whether a step still has to be kept in this window."""
        return bool(self._keep_at)

    def _kept_now(self, index: int) -> bool:
        if index in self.keep_steps:
            return True
        if self._keep_at and time.perf_counter() >= self._keep_at[0]:
            self._keep_at.pop(0)
            return True
        return False

    def _upload(self, host: torch.Tensor) -> torch.Tensor:
        return host.to(self.device, non_blocking=True) if self.cuda \
            else host.clone()

    def _read_back(self, frames: torch.Tensor):
        if not self.cuda:
            return frames.clone(), None
        host = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)
        host.copy_(frames, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(frames.device))
        return host, event

    def dispatch(self) -> Step:
        """Run the next step on the Engine and start its read-back."""
        index = self.steps
        count = 1 if self.live else self.chunk
        positions = [(self.position + k - 1) % self.length
                     for k in range(count + 1)]
        probe = self._kept_now(index)
        # the state before set-up's first step is the Engine's first, which
        # the reference makes itself
        before = _map(self.engine.comp_state, self._keep) \
            if probe and index else None
        runtime = self.engine.runtimes[0]
        estimate, flows = runtime.estimator_step, []
        if probe:
            runtime.estimator_step = _recording(estimate, flows, self._keep)
        started = time.perf_counter()
        try:
            if self.live:
                frame, _ = self._live_step(positions[-1])
                frames = frame[None]
            else:
                frames, _ = self.engine.process_chunk(
                    [self._upload(self._chunks[self.position])],
                    ((self.pixmap,),), ((None,),), self.frames_done,
                    self.frames_done)
        finally:
            runtime.estimator_step = estimate
        host_s = time.perf_counter() - started
        if probe:
            after = _map(self.engine.comp_state, self._keep)
            if len(flows) != count:
                flows = [None] * (count - 1) + [self._keep(runtime.last_raw)]
        host, event = self._read_back(frames)
        step = Step(index, positions, self.frames_done, host, event, host_s)
        if probe:
            self.probes.append((step, before, after, flows))
        self.position = (self.position + count) % self.length
        self.frames_done += count
        self.steps += 1
        return step

    def _live_step(self, position: int):
        from transflow_tpu_torch.flow.sources.base import FlowItem
        item = FlowItem(FlowItem.FRAME, self._upload(self.clip_host[position]))
        return self.engine.process_frame(
            [item], ((self.pixmap,),), self.frames_done / self.framerate,
            ((self.frames_done,),))

    def kept_probes(self) -> list:
        """The kept steps as ``check.Probe``s (their read-backs waited
        for), the state before set-up's first None."""
        want = len(self.keep_steps) + len(self.keep_fractions)
        if len(self.probes) != want:
            raise RuntimeError(f"{len(self.probes)} steps were kept of "
                               f"{want}: a window never ran")
        out = []
        for step, before, after, flows in self.probes:
            step.wait()
            out.append(Probe(
                step.positions, step.first_frame,
                None if before is None
                else state_arrays(self.engine, before),
                state_arrays(self.engine, after), flows,
                step.frames.numpy()))
        return out


def warm_up(feed: Feed, steps: int) -> None:
    """Set-up's steps, each waited for: every shape the window uses."""
    for _ in range(steps):
        feed.dispatch().wait()


def render_window(feed: Feed, ahead: int, seconds: float | None = None,
                  count: int | None = None) -> dict:
    """Steps in a closed loop, ``ahead`` in flight, dispatched until
    ``seconds`` have passed (or ``count`` steps are dispatched); the
    window ends when the last is in host memory. A timed window keeps
    the feed's steps (``Feed.arm``), dispatching past its end only while
    one is still to be kept. Returns frames, steps, seconds and the
    Engine's host seconds."""
    pending = []
    started = time.perf_counter()
    deadline = started + (seconds if seconds is not None else math.inf)
    if seconds is not None:
        feed.arm(started, seconds)
    frames = steps = dispatched = 0
    host_s = 0.0
    ended = started
    stop = False
    while True:
        if (time.perf_counter() < deadline and (count is None
                                                or dispatched < count)) \
                or feed.keeping():
            pending.append(feed.dispatch())
            dispatched += 1
        else:
            stop = True
        while pending and (len(pending) > ahead or stop):
            step = pending.pop(0)
            step.wait()
            ended = time.perf_counter()
            frames += step.frames.shape[0]
            steps += 1
            host_s += step.host_s
        if stop:
            break
    return {"frames": frames, "steps": steps, "seconds": ended - started,
            "host_s": host_s}


def live_window(feed: Feed, seconds: float, rate: float,
                keep: bool = True) -> dict:
    """One frame due every ``1 / rate`` s for ``seconds``; each started
    when due (or when the one before is done, if later) and timed from
    its due time until it is in host memory. With ``keep`` the window
    keeps the feed's steps (``Feed.arm``). Returns the latencies (s),
    how late the starts ran, frames, seconds and the Engine's host
    seconds."""
    count = math.ceil(seconds * rate)
    origin = time.perf_counter() + 0.01
    if keep:
        feed.arm(origin, count / rate)
    latencies, late = [], []
    host_s = 0.0
    for i in range(count):
        due = origin + i / rate
        wait = due - time.perf_counter()
        if wait > 0.002:
            time.sleep(wait - 0.002)
        while time.perf_counter() < due:
            pass
        late.append(time.perf_counter() - due)
        step = feed.dispatch()
        step.wait()
        latencies.append(time.perf_counter() - due)
        host_s += step.host_s
    ended = time.perf_counter()
    return {"frames": count, "steps": count, "seconds": ended - origin,
            "host_s": host_s, "latencies": latencies,
            "late_max": max(late), "late_mean": float(np.mean(late))}

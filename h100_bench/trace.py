"""The device trace of a run's traced steps: ``torch.profiler`` over them,
its Chrome trace read back, and what the per-layer metrics need from it.

Two segments of the same number of steps follow the window. The first
is profiled plainly (CPU operators, runtime calls and the card's
activity): the device's busy and idle time, the kernels' and copies'
times come from it. The second adds the profiler's Python tracer
(``with_stack``), which slows the host several times over, so only the
attribution of kernels to layers comes from it: each kernel's
``correlation`` names its launching runtime call, and the Python
functions open on that call's thread at its start are its stack,
outermost first.

Each segment runs inside a ``record_function`` range, ``WINDOW``; a
segment keeps the device's operations (kernels, copies and sets) that
overlap that range, clipped to it. An idle gap on the device is named by
the innermost operator or runtime call the harness's thread was in at the
gap's middle.
"""
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

WINDOW = "h100_bench.window"
DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                "gpu_memset": "memset"}
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
_ADDRESS = re.compile(r" of [^>]* at 0x[0-9a-f]+(?=>)")


class Timeline:
    """One traced segment: its window, the device's operations in it, the
    host's events by thread."""

    def __init__(self, events: list):
        window = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == WINDOW]
        if not window:
            raise ValueError(f"the trace has no {WINDOW!r} range")
        w = window[0]
        self.start = float(w["ts"])
        self.end = self.start + float(w["dur"])
        self.main_tid = w.get("tid")
        self.ops = []  # (start us, end us, name, kind, correlation)
        self.host = defaultdict(list)  # tid -> [(start, end, name)]
        self.python = defaultdict(list)
        self.launches = {}  # correlation -> (tid, start)
        for e in events:
            cat = e.get("cat")
            kind = DEVICE_KINDS.get(cat)
            if kind is not None and "dur" in e:
                s = max(float(e["ts"]), self.start)
                t = min(float(e["ts"]) + float(e["dur"]), self.end)
                if t > s:
                    self.ops.append((s, t, e.get("name", ""), kind,
                                     e.get("args", {}).get("correlation")))
                continue
            if "dur" not in e or "ts" not in e:
                continue
            span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", ""))
            if cat == "python_function":
                self.python[e.get("tid")].append(span)
            elif cat in HOST_KINDS and e.get("name") != WINDOW:
                self.host[e.get("tid")].append(span)
            if cat in LAUNCH_KINDS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    self.launches[corr] = (e.get("tid"), float(e["ts"]))
        self.ops.sort()

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran."""
        total, reach = 0.0, self.start
        for s, t, *_ in self.ops:
            if t > reach:
                total += t - max(s, reach)
                reach = t
        return total / 1e6

    def seconds(self, kind: str = "kernel", name: str | None = None) -> float:
        """Summed seconds of the operations of ``kind`` whose name holds
        ``name`` (all of them when None)."""
        return sum(t - s for s, t, n, k, _ in self.ops
                   if k == kind and (name is None or name in n)) / 1e6

    def kernel_stacks(self) -> dict:
        """correlation -> the Python stack (outermost first) open on the
        launching thread when the kernel was launched."""
        queries = defaultdict(list)
        for _, _, _, kind, corr in self.ops:
            if kind == "kernel" and corr in self.launches:
                tid, ts = self.launches[corr]
                if tid not in self.python and len(self.python) == 1:
                    tid = next(iter(self.python))
                queries[tid].append((ts, corr))
        stacks = {}
        for tid, items in queries.items():
            items.sort()
            for (_, corr), stack in zip(items, stacks_at(
                    self.python.get(tid, []), [t for t, _ in items])):
                stacks[corr] = stack
        return stacks

    def idle_gaps(self, top: int = 10) -> list:
        """The device's idle seconds in the window, summed by the innermost
        operator or runtime call the harness's thread was in at each gap's
        middle; the ``top`` largest."""
        gaps, reach = [], self.start
        for s, t, *_ in self.ops:
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, t)
        if self.end > reach:
            gaps.append((reach, self.end))
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        totals = defaultdict(float)
        for (_, length), stack in zip(mids, stacks_at(
                self.host.get(self.main_tid, []), [m for m, _ in mids])):
            name = stack[-1] if stack else "(host between operators)"
            totals[_ADDRESS.sub("", name)] += length
        return sorted(([name, sec / 1e6] for name, sec in totals.items()),
                      key=lambda row: -row[1])[:top]

    def top_ops(self, top: int = 10) -> list:
        """The device operations that took most time, by name, in
        seconds."""
        totals = defaultdict(float)
        for s, t, name, *_ in self.ops:
            totals[name] += t - s
        return sorted(([n, sec / 1e6] for n, sec in totals.items()),
                      key=lambda row: -row[1])[:top]


class Summary:
    """The two traced segments of a run, each of ``frames`` frames: the
    plain one's timeline, and the stacked one's kernels by launching
    path."""

    def __init__(self, plain: list, stacked: list, frames: int):
        self.frames = frames
        self.plain = Timeline(plain)
        stacked = Timeline(stacked)
        stacks = stacked.kernel_stacks()
        self._kernels = [(t - s, stacks.get(corr)) for s, t, _, kind, corr
                         in stacked.ops if kind == "kernel"]
        self.window_s = self.plain.window_s
        self.busy_s = self.plain.busy_s

    def seconds(self, kind: str = "kernel", name: str | None = None) -> float:
        return self.plain.seconds(kind, name)

    def launched_from(self, *paths: str) -> float:
        """Seconds of the stacked segment's kernels whose launching stack
        passes through a file whose path holds one of ``paths``."""
        return sum(d for d, stack in self._kernels if stack and any(
            p in frame for frame in stack for p in paths)) / 1e6

    def attributed(self) -> float:
        """The share of the stacked segment's kernel time whose launching
        stack is known."""
        every = sum(d for d, _ in self._kernels)
        return sum(d for d, s in self._kernels if s) / every if every \
            else 0.0


def stacks_at(spans: list, times: list) -> list:
    """For each of the sorted ``times``, the names of the spans
    (``(start, end, name)``, properly nested) open then, outermost
    first."""
    spans = sorted(spans, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(e[2] for e in stack))
    return out


@contextlib.contextmanager
def traced(device, with_stack: bool):
    """Profile the block (CPU and, on a card, CUDA activity; with
    ``with_stack`` the Python tracer too) inside the ``WINDOW`` range;
    yields a list that holds the trace's events once the block has ended.
    The trace is written to a temporary file (under ``TMPDIR``) and
    removed after reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    events: list = []
    with profile(activities=activities, with_stack=with_stack) as prof:
        with record_function(WINDOW):
            yield events
        if cuda:
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf8") as file:
            events.extend(json.load(file)["traceEvents"])
    finally:
        os.unlink(path)

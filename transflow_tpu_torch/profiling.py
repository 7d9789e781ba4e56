"""Per-stage frame timing and device tracing of the port.

Counterpart of transflow_tpu/profiling.py:

* ``StageTimers``: wall time per stage, with totals, means and the last
  value, as a dict and a printable table. Stages may be timed from
  several threads. The Pipeline's main thread times ``setup``,
  ``decode_wait``, ``device_step``, ``checkpoint`` and ``flush`` (the
  wait for the last frames to be written); its readback thread
  ``readback`` (the wait for the card's copies) and ``flow_export``; its
  encode threads ``encode``.
* ``device_trace``: ``torch.profiler`` around a run, the card's kernels
  included where there is one, written as a Chrome trace
  (``trace.json``) into the directory given.
* ``host_sync_sites``: where the host waited for the card during a call.

The Pipeline wires them behind ``--profile`` and ``--trace-dir``.
"""
import contextlib
import json
import os
import threading
import time
from collections import OrderedDict


class StageTimers:

    def __init__(self):
        self.totals: OrderedDict[str, float] = OrderedDict()
        self.counts: OrderedDict[str, int] = OrderedDict()
        self.last: dict[str, float] = {}
        self.started = time.perf_counter()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + elapsed
                self.counts[name] = self.counts.get(name, 0) + 1
                self.last[name] = elapsed

    def report(self) -> dict:
        wall = time.perf_counter() - self.started
        stages = {}
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
        for name, total in totals.items():
            count = counts[name]
            stages[name] = {
                "total_s": round(total, 4),
                "count": count,
                "mean_ms": round(1000 * total / max(count, 1), 3),
                "share": round(total / wall, 3) if wall > 0 else 0.0,
            }
        frames = max(counts.values()) if counts else 0
        return {
            "wall_s": round(wall, 3),
            "frames": frames,
            "fps": round(frames / wall, 2) if wall > 0 else 0.0,
            "stages": stages,
        }

    def format_table(self) -> str:
        report = self.report()
        lines = [f"wall {report['wall_s']}s — {report['frames']} frames — "
                 f"{report['fps']} fps",
                 f"{'stage':<18}{'mean ms':>10}{'total s':>10}{'share':>8}"]
        for name, row in report["stages"].items():
            lines.append(f"{name:<18}{row['mean_ms']:>10}{row['total_s']:>10}"
                         f"{row['share']:>8.0%}")
        return "\n".join(lines)

    def dump(self, path: str):
        with open(path, "w") as file:
            json.dump(self.report(), file, indent=2)


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """``torch.profiler`` capture, written to ``trace_dir/trace.json``
    (Chrome trace format), when a directory is given."""
    if not trace_dir:
        yield
        return
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def host_sync_sites(fn, device=None) -> list[str]:
    """Run ``fn()`` and return the last lines of the Python stack at each
    wait of the host for the card meanwhile (``torch.cuda.
    set_sync_debug_mode`` warns at each); on a CPU ``device``, none."""
    import traceback
    import warnings

    import torch
    if device is not None and torch.device(device).type != "cuda":
        fn()
        return []
    sites: list[str] = []

    def show(message, *_args, **_kwargs):
        if "synchroniz" in str(message):
            stack = [f for f in traceback.extract_stack()[:-1]
                     if not f.filename.endswith("warnings.py")]
            sites.append("".join(traceback.format_list(stack[-6:])))

    torch.cuda.synchronize(device)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        sites.clear()  # a process's first switch to "warn" reports a wait
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites

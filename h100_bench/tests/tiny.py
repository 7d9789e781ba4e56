"""Cells cut to a size a CPU test run holds.

On the CPU the port runs its plain versions in float32 (Farneback's
planes and LiteFlowNet's convolutions), so a tiny cell's configuration
states float32 where the card's states bfloat16; the reference then
computes what the plain versions compute, bit for bit, and every number
reads 0 against the cell's own limits.
"""
import copy
import pathlib

from h100_bench import cells

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 12345


def shrink(cell: cells.Cell) -> cells.Cell:
    """``cell`` at 64 x 96 with an 8-frame clip, chunks of 4 and short
    windows, in float32."""
    cell = copy.deepcopy(cell)
    t = cell.traffic
    t.update(height=64, width=96, clip_frames=8, warm_steps=2,
             trace_steps=2)
    if t["loop"] == "closed_chunks":
        t.update(chunk=4, probes=1)
    else:
        t.update(probes=2)
    precision = cell.config["precision"]
    for key in ("storage", "conv"):
        if key in precision:
            precision[key] = "float32"
    return cell


# cells that BENCHMARK.json does not hold yet (PERF.md, Open questions),
# with their metrics, as the change that adds them would enter them: their
# traffic and loop stay tested
LATER = {
    "workloads": [{"name": "liteflownet.live_1080p", "config": "liteflownet",
                   "traffic": "live_1080p", "chips": 1}],
    "end_to_end": [
        {"name": "live_latency_p50_ms", "unit": "ms",
         "workloads": ["liteflownet.live_1080p"]},
        {"name": "live_latency_p95_ms", "unit": "ms",
         "workloads": ["liteflownet.live_1080p"]}],
    "per_layer": [
        {"name": "engine_host_ms_per_frame.live", "unit": "ms/frame",
         "moves": "live_latency_p50_ms",
         "workloads": ["liteflownet.live_1080p"]},
        {"name": "device_idle_pct.live", "unit": "%",
         "moves": "live_latency_p50_ms",
         "workloads": ["liteflownet.live_1080p"]}],
}


def load(name: str, root=ROOT) -> cells.Cell:
    """The cell ``name`` of BENCHMARK.json or of ``LATER``."""
    bench = copy.deepcopy(cells.load_benchmark(root))
    for group, entries in LATER.items():
        bench[group] += entries
    return cells.load_cell(name, root, bench)


def tiny_cell(name: str, root=ROOT) -> cells.Cell:
    return shrink(load(name, root))

"""Run one cell of the benchmark once and print its result.

    python3 -m h100_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up builds the port's Engine from the cell's configuration, makes
the clip, the pixmap and any weights on the card from the seed, and runs
the traffic's warm-up steps (every shape the window uses); then the
window runs for ``--seconds``. With ``--trace 1`` a few more steps run
under the profiler after the window, and the result holds the per-layer
metrics in place of the end-to-end ones. Last, the kept steps are judged
against the plain reference (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit, which also end standard error. Without a card, with fewer cards
than the cell asks for, or where a module of JAX or of the JAX package is
loaded once the window has closed, it prints no result and exits with 2.
"""
import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from . import cells, check, drive, guard, system, trace, traffic  # noqa

EXIT_REFUSED = 2


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _keep_fractions(cell: cells.Cell, seed: int) -> list:
    """Where in the window its kept steps fall, as shares of its length
    drawn from the seed within the traffic's ``probe_window``."""
    t = cell.traffic
    lo, hi = t["probe_window"]
    rng = random.Random(seed)
    return sorted(rng.uniform(lo, hi) for _ in range(t["probes"]))


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device, root=cells.ROOT, prepare=None, started=None,
             control: bool = False) -> dict:
    """One run of ``cell``; the result's dict. ``prepare(engine)``, when
    given, runs on the Engine before set-up's steps (the tests plant
    faults with it); ``control`` adds the control's numbers
    (``control.py``)."""
    import torch
    started = STARTED if started is None else started
    config, t = cell.config, cell.traffic
    device = torch.device(device)
    gen = traffic.generator(seed, device)
    # the clip is replayed from host memory, as decoded frames are: it
    # leaves the card before the Engine is built, and the peak of device
    # memory counts from there
    clip = traffic.make_clip(t, system.frame_channels(config), gen,
                             device).cpu()
    pixmap = traffic.make_pixmap(t, gen, device)
    weights = None
    if "weights" in config:
        template = check.load_reference(
            config["cv_config"]["method"]).template()
        weights = traffic.make_weights(config, template, gen, device)
    made = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    engine = system.build_engine(config, seed, t["height"], t["width"],
                                 t["framerate"], device, weights)
    if weights is not None:
        weights = {k: v.cpu() for k, v in weights.items()}
    built = time.perf_counter()
    if prepare is not None:
        prepare(engine)
    feed = drive.Feed(engine, clip, pixmap, t, device)
    feed.keep_steps = {0}
    feed.keep_fractions = _keep_fractions(cell, seed)
    drive.warm_up(feed, t["warm_steps"])
    feed.set_aside()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started
    print(f"set-up {setup_s:.3f} s: inputs made by {made - started:.3f}, "
          f"Engine built by {built - started:.3f}", file=sys.stderr)

    live = t["loop"] == "open_frames"
    if live:
        window = drive.live_window(feed, seconds, t["rate_fps"])
    else:
        window = drive.render_window(feed, t["ahead"], seconds=seconds)
    summary = None
    if traced:
        segments = []
        for with_stack in (False, True):
            with trace.traced(device, with_stack) as events:
                if live:
                    drive.live_window(feed, t["trace_steps"] / t["rate_fps"],
                                      t["rate_fps"], keep=False)
                else:
                    drive.render_window(feed, t["ahead"],
                                        count=t["trace_steps"])
            segments.append(events)
        frames = t["trace_steps"] * (1 if live else t["chunk"])
        summary = trace.Summary(*segments, frames)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    probes = feed.kept_probes()
    del feed, engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = check.Reference(config, clip, pixmap, weights, seed, device)
    values = check.numbers(reference, probes)
    correct, rows = check.judge(values, config["limits"])
    controls = check.numbers(reference, probes, control=True) \
        if control else None

    e2e = {"setup_s": setup_s}
    if live:
        lat = 1e3 * np.asarray(window["latencies"])
        e2e["live_latency_p50_ms"] = float(np.percentile(lat, 50))
        e2e["live_latency_p95_ms"] = float(np.percentile(lat, 95))
    else:
        e2e["render_fps"] = window["frames"] / window["seconds"]
    ctx = types.SimpleNamespace(cell=cell, config=config, traffic=t,
                                window=window, trace=summary, e2e=e2e)
    metrics = {}
    if traced:
        for spec in cell.per_layer:
            value = cells.load_metric(spec["name"], root).read(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": float(value),
                                         "unit": spec["unit"]}
    else:
        for spec in cell.end_to_end:
            metrics[spec["name"]] = {"value": float(e2e[spec["name"]]),
                                     "unit": spec["unit"]}
    result = {"correct": bool(correct), "attempted": window["frames"],
              "failed": 0, "metrics": metrics,
              "device": _device(device, peak, summary)}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.plain.top_ops(),
                               "idle_gaps": summary.plain.idle_gaps()}
    result["diagnostics"] = {
        "setup_s": setup_s, "window_s": window["seconds"],
        "window_frames": window["frames"], "steps": window["steps"],
        "kept_from_frame": [probe.first_frame for probe in probes],
        "card": power_limit() if device.type == "cuda" else None,
        **check.flow_extent(probes),
        **(_latency_diagnostics(window) if live else {}),
        **({"trace_attributed": summary.attributed()} if summary else {})}
    if controls is not None:
        result["control"] = controls
    result["checks"] = rows
    return result


def _latency_diagnostics(window: dict) -> dict:
    """The live window's tail and how late its starts ran."""
    lat = 1e3 * np.asarray(window["latencies"])
    worst = int(np.argmax(lat))
    return {"latency_max_ms": float(lat[worst]), "latency_argmax": worst,
            "latency_p99_ms": float(np.percentile(lat, 99)),
            "late_max_ms": 1e3 * window["late_max"],
            "late_mean_ms": 1e3 * window["late_mean"]}


def _device(device, peak: int, summary) -> dict:
    import torch
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        out["busy_s"] = summary.busy_s
        out["window_s"] = summary.window_s
    return out


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cell = cells.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available()
                     else 0}", file=sys.stderr)
        return EXIT_REFUSED
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = guard.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return EXIT_REFUSED
    for name, row in result["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

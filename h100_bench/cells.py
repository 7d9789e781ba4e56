"""The benchmark's cells, found by name from ``BENCHMARK.json``.

A workload names its configuration (``configs/<config>.json``) and its
traffic mix (``traffic/<traffic>.json``); each per-layer metric is read
by a module ``metrics/<name>.py``, or, where there is none, by
``metrics/<stem>.py`` for a name ``<stem>.<part>`` (one reader for the
metric's splits by the end-to-end metric they move). Its ``read(ctx)``
returns the metric's value or None where it finds nothing to read; its
unit, layer and moved metric are ``BENCHMARK.json``'s. An end-to-end or
per-layer metric with a ``workloads`` key belongs to the cells it lists,
one without to every cell.
"""
import importlib.util
import json
import pathlib

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Cell:
    """One workload with its configuration, traffic and metrics."""

    def __init__(self, workload: dict, config: dict, traffic: dict,
                 end_to_end: list, per_layer: list):
        self.name = workload["name"]
        self.workload = workload
        self.chips = workload["chips"]
        self.config = config
        self.traffic = traffic
        self.end_to_end = end_to_end
        self.per_layer = per_layer


def _load_json(path: pathlib.Path) -> dict:
    with open(path, encoding="utf8") as file:
        return json.load(file)


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return _load_json(pathlib.Path(root) / "BENCHMARK.json")


def load_cell(name: str, root: pathlib.Path = ROOT,
              bench: dict | None = None) -> Cell:
    """The workload ``name`` of ``root``'s ``BENCHMARK.json`` (or of
    ``bench``), with the files it names under ``root/h100_bench``."""
    root = pathlib.Path(root)
    bench = load_benchmark(root) if bench is None else bench
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has "
                       f"{sorted(workloads)})")
    workload = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[workload["config"]]["file"])
    traffic = _load_json(root / "h100_bench" / "traffic"
                         / f"{workload['traffic']}.json")
    end_to_end = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(workload, config, traffic, end_to_end, per_layer)


def load_metric(name: str, root: pathlib.Path = ROOT):
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    else ``metrics/<stem>.py`` for ``<stem>.<part>``."""
    folder = pathlib.Path(root) / "h100_bench" / "metrics"
    path = folder / f"{name}.py"
    if not path.exists() and "." in name:
        path = folder / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench.metrics." + path.stem.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

"""BENCHMARK.json and the files it names: every cell loads by name, each
per-layer metric has a reader, and every cell that reports a per-layer
metric reports the end-to-end metric it moves."""
import json
import re

import pytest

from h100_bench import cells, traffic
from tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [entry["name"] for entry in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_loads_by_name(name):
    cell = cells.load_cell(name, ROOT)
    assert cell.chips == 1
    assert set(traffic.TRAFFIC_KEYS) <= set(cell.traffic)
    assert cell.config["name"] == cell.workload["config"]
    assert set(cell.config["limits"]) == {"flow_gap", "state_mismatch",
                                          "frame_mismatch"}
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert metric["moves"] in e2e


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.load_cell("no.such_cell", ROOT)


@pytest.mark.parametrize("spec", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_metric_has_a_reader(spec):
    module = cells.load_metric(spec["name"], ROOT)
    assert callable(module.read)
    assert set(spec["workloads"]) <= set(WORKLOADS)


def test_every_config_file_and_source():
    for config in BENCH["configs"]:
        data = json.loads((ROOT / config["file"]).read_text())
        assert data["name"] == config["name"]
        assert data["reduced"] == config["reduced"] == []
        assert len(config["source"]) <= 200 and len(config["why"]) <= 200


def test_why_fits_a_line():
    for entry in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]

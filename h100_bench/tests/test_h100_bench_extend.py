"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and entries alone: a copy of the benchmark with one
of each runs a cell that uses all three, with no file that was there
edited."""
import json
import shutil

from h100_bench import cells, run
from tiny import ROOT, SEED, shrink

METRIC = '''"""Frames a step of the window."""


def read(ctx):
    return ctx.window["frames"] / ctx.window["steps"]
'''


def test_new_config_traffic_and_metric_are_files_and_entries(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench_dir = tmp_path / "h100_bench"
    config = json.loads((bench_dir / "configs" / "farneback.json")
                        .read_text())
    config.update(name="farneback_two_levels")
    config["cv_config"]["fb_levels"] = 2
    (bench_dir / "configs" / "farneback_two_levels.json").write_text(
        json.dumps(config))
    mix = json.loads((bench_dir / "traffic" / "render_uhd.json")
                     .read_text())
    mix.update(chunk=8)
    (bench_dir / "traffic" / "render_chunk8.json").write_text(
        json.dumps(mix))
    (bench_dir / "metrics" / "frames_per_step.py").write_text(METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "farneback_two_levels", "source": "https://example.org",
        "file": "h100_bench/configs/farneback_two_levels.json",
        "reduced": [], "why": "a dummy"})
    cell_name = "farneback_two_levels.render_chunk8"
    bench["workloads"].append({
        "name": cell_name, "config": "farneback_two_levels",
        "traffic": "render_chunk8", "chips": 1, "why": "a dummy"})
    bench["end_to_end"][0]["workloads"].append(cell_name)
    bench["per_layer"].append({
        "name": "frames_per_step.render", "unit": "frames",
        "better": "higher", "source": "host_clock",
        "layer": "Engine (engine.py)", "moves": "render_fps",
        "workloads": [cell_name]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = shrink(cells.load_cell(cell_name, tmp_path))
    assert cell.config["cv_config"]["fb_levels"] == 2
    assert [m["name"] for m in cell.per_layer] == ["frames_per_step.render"]
    plain = run.run_cell(cell, SEED, 1.0, False, "cpu", root=tmp_path)
    assert plain["correct"]
    assert set(plain["metrics"]) == {"render_fps", "setup_s"}
    traced = run.run_cell(cell, SEED, 1.0, True, "cpu", root=tmp_path)
    assert traced["correct"]
    assert traced["metrics"]["frames_per_step.render"]["value"] == 4.0

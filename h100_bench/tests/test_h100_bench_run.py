"""A run of each cell at a tiny size on the CPU, the result's keys, the
refusal without a card, and the comparison that decides ``correct``
failing where the timed path is broken underneath."""
import json
import subprocess
import sys

import pytest
import torch

from h100_bench import run
from tiny import ROOT, SEED, tiny_cell

CELLS = ["farneback.render_uhd", "liteflownet.render_1080p",
         "liteflownet.live_1080p"]


def _run(name, traced=False, prepare=None, seed=SEED):
    return run.run_cell(tiny_cell(name), seed, 0.5, traced, "cpu",
                        prepare=prepare)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct_and_reports_its_metrics(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed",
                                "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    cell = tiny_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for value in result["metrics"].values():
        assert value["value"] > 0
    for row in result["checks"].values():
        assert row["value"] == 0.0 and row["limit"] > 0.0
    assert result["diagnostics"]["moving_share"] > 0.5
    json.dumps(result)


@pytest.mark.parametrize("name", ["farneback.render_uhd",
                                  "liteflownet.live_1080p"])
def test_traced_run_reports_per_layer_metrics(name):
    result = _run(name, traced=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in tiny_cell(name).per_layer}
    # on the CPU nothing runs on a device: only host-clock metrics and
    # the idle share read something
    assert set(result["metrics"]) <= names
    assert any(k.startswith("engine_host_ms") for k in result["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_kept_steps_fall_inside_the_window(name):
    result = _run(name)
    cell = tiny_cell(name)
    t = cell.traffic
    warm_frames = t["warm_steps"] * t.get("chunk", 1)
    kept = result["diagnostics"]["kept_from_frame"]
    assert kept[0] == 0 and len(kept) == 1 + t["probes"]
    for first in kept[1:]:
        assert warm_frames <= first < warm_frames + result["attempted"]


def test_same_seed_same_inputs():
    from h100_bench import traffic
    cell = tiny_cell("liteflownet.render_1080p")
    made = []
    for _ in range(2):
        gen = traffic.generator(SEED, "cpu")
        made.append((traffic.make_clip(cell.traffic, 3, gen, "cpu"),
                     traffic.make_pixmap(cell.traffic, gen, "cpu")))
    assert torch.equal(made[0][0], made[1][0])
    assert torch.equal(made[0][1], made[1][1])


def test_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "h100_bench.run", "--workload",
         "farneback.render_uhd", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": str(ROOT)}, timeout=300, check=False)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# faults planted under the timed path: each has to turn ``correct`` false

def _state_unchanged(engine):
    step = engine.process_chunk

    def frozen(*args, **kwargs):
        state = engine.comp_state
        out = step(*args, **kwargs)
        engine.comp_state = state
        return out
    engine.process_chunk = frozen


def _half_the_chunk(engine):
    step = engine.process_chunk

    def half(source_chunks, *args):
        k = len(source_chunks[0])
        frames, flows = step([c[:k // 2] for c in source_chunks], *args)
        return torch.cat([frames, frames])[:k], flows
    engine.process_chunk = half


def _frame_altered(engine):
    step = engine.process_chunk

    def altered(*args):
        frames, flows = step(*args)
        frames = frames.clone()
        frames[-1] = 255 - frames[-1]
        return frames, flows
    engine.process_chunk = altered


def _flow_altered(engine):
    runtime = engine.runtimes[0]
    estimate = runtime.estimator_step

    def altered(*args):
        return estimate(*args) * 1.1
    runtime.estimator_step = altered


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_chunk,
                                   _frame_altered, _flow_altered])
@pytest.mark.parametrize("name", ["farneback.render_uhd",
                                  "liteflownet.render_1080p"])
def test_a_broken_step_is_not_correct(name, fault):
    result = _run(name, prepare=fault)
    assert not result["correct"], result["checks"]


def _live_state_unchanged(engine):
    step = engine.process_frame

    def frozen(*args):
        state = engine.comp_state
        out = step(*args)
        engine.comp_state = state
        return out
    engine.process_frame = frozen


def _live_frame_altered(engine):
    step = engine.process_frame

    def altered(*args):
        frame, flow = step(*args)
        return 255 - frame, flow
    engine.process_frame = altered


@pytest.mark.parametrize("fault", [_live_state_unchanged,
                                   _live_frame_altered, _flow_altered])
def test_a_broken_live_frame_is_not_correct(fault):
    result = _run("liteflownet.live_1080p", prepare=fault)
    assert not result["correct"], result["checks"]

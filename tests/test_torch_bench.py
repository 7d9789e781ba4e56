"""The port's bench (``transflow_tpu_torch/bench.py``) on the CPU at a
small size (its constants set here, as tests/test_bench_health.py sets
bench.py's): its frames are bench.py's bit for bit, its record carries
every field with bench.py's metric, ``--e2e`` adds the CLI's three runs
with their ``StageTimers`` split, and the flagship's chunks meet the JAX
model's ``jit_scan`` within tests/test_torch_model.py's Farneback bars."""
import contextlib
import inspect
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench as jbench  # noqa: E402  (the root bench.py)
from transflow_tpu.config import LayerConfig as JaxLayerConfig  # noqa: E402
from transflow_tpu.flow import Direction as JaxDirection  # noqa: E402
from transflow_tpu.model import FlowTransferModel as JaxModel  # noqa: E402
from transflow_tpu_torch import bench  # noqa: E402

H, W = 48, 64
# WARMUP_MAX: CPU timings under a loaded test run may never agree
SMALL = {"HEIGHT": H, "WIDTH": W, "CHUNK": 2, "CHUNKS_PER_SAMPLE": 2,
         "REPEATS": 3, "WARMUP_MAX": 2, "CPU_FRAMES": 1, "LFN_HEIGHT": 64,
         "LFN_WIDTH": 96, "LFN_CHAIN": 2, "E2E_FRAMES": 6}
# the record's fields, in their order
FIELDS = ("metric", "value", "unit", "vs_baseline", "ms_per_frame",
          "best_fps", "noise_iqr_pct", "stage_ms", "hbm_io_gbps",
          "carry_state_mb", "cpu_reference_fps",
          "liteflownet_1088p_ms_per_frame", "liteflownet_1088p_fps",
          "fastest_preset", "launches_per_frame", "card")
E2E_RUNS = ("still_pixmap", "video_pixmap", "archive_replay")
# tests/test_torch_model.py::test_farneback_model_matches_jax's bars
FLOW_PSNR = 60.0      # dB at an 8 px peak
FRAME_SHARE = 0.01    # of pixels, where flows round apart at a .5 edge


@contextlib.contextmanager
def small_bench(tmp_path, **extra):
    with pytest.MonkeyPatch.context() as patch:
        for name, value in {**SMALL, **extra}.items():
            patch.setattr(bench, name, value)
        patch.setattr(bench, "CPU_BASELINE_PATH", tmp_path / "cpu.json")
        yield patch


def _run(tmp_path, argv):
    """``bench.main(argv, device="cpu")`` at the small size: (its stdout,
    its record)."""
    out = io.StringIO()
    with small_bench(tmp_path), contextlib.redirect_stdout(out):
        record = bench.main(argv, device="cpu")
    return out.getvalue(), record


@pytest.fixture(scope="module")
def e2e_run(tmp_path_factory):
    return _run(tmp_path_factory.mktemp("bench_e2e"), ["--e2e"])


@pytest.mark.parametrize("size", [(H, W), (1080, 1920)])
@pytest.mark.parametrize("seed", [0, 2])
def test_make_frames_matches_bench_py(monkeypatch, size, seed):
    for module in (bench, jbench):
        monkeypatch.setattr(module, "HEIGHT", size[0])
        monkeypatch.setattr(module, "WIDTH", size[1])
    got = bench.make_frames(3, seed=seed)
    assert got.shape == (3, *size) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jbench.make_frames(3, seed=seed))


def test_main_prints_one_record(tmp_path):
    """``main([])`` prints one JSON line with every field, in order, and
    bench.py's metric; no e2e field without ``--e2e``."""
    stdout, record = _run(tmp_path, [])
    lines = stdout.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == record
    keys = list(record)
    assert [k for k in keys if k in FIELDS] == list(FIELDS)
    assert record["metric"] == bench.METRIC
    assert f'"metric": "{bench.METRIC}"' in inspect.getsource(jbench.main)
    assert record["unit"] == "frames/sec"
    assert record["value"] > 0 and record["vs_baseline"] > 0
    assert record["ms_per_frame"] == pytest.approx(1e3 / record["value"])
    assert set(record["stage_ms"]) == {"estimator", "compositor_render",
                                       "fused_total"}
    assert record["fastest_preset"]["fps"] > 0
    assert record["liteflownet_1088p_fps"] > 0
    assert record["warmup_samples"] >= 2 and record["samples"] == 3
    assert 0 < record["window_fps"] <= record["best_fps"]
    # the card's figures are none off the card
    assert record["card"] == "cpu" and record["hbm_io_gbps"] is None
    assert record["launches_per_frame"] == {
        "flagship": {"B1": 0, "B2a": 0, "B2b": 0, "B8": 0, "K0": 0,
                     "K1": 0, "K2": 0},
        "liteflownet": {"A1": 0, "A3": 0, "B7": 0, "B16": 0, "B17": 0,
                        "B18": 0}}
    assert record["host_syncs_per_frame"] == 0
    assert not [k for k in keys if k.startswith("e2e_")]
    assert json.loads((tmp_path / "cpu.json").read_text())["cpu_fps"] == \
        record["cpu_reference_fps"]


def test_e2e_reports_the_three_runs(e2e_run):
    """``--e2e`` at 48x64 over 6 frames: frames/s, chunk size and the
    ``StageTimers`` split of each run."""
    stdout, record = e2e_run
    assert json.loads(stdout.splitlines()[-1]) == record
    for run in E2E_RUNS:
        assert record[f"e2e_fps_{run}"] > 0
        assert record[f"e2e_batch_{run}"] == 16
        split = record[f"e2e_split_ms_{run}"]
        assert set(split) == {"decode_wait", "device_step", "encode"}
        assert split["device_step"] > 0 and split["encode"] > 0
    assert list(record)[-1] == "card"


def test_cpu_reference_is_cached_per_size(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "CPU_BASELINE_PATH", tmp_path / "c.json")
    monkeypatch.setattr(bench, "bench_cpu_reference",
                        lambda: calls.append(1) or 2.5)
    for size in ((H, W), (H, W), (2 * H, W)):
        monkeypatch.setattr(bench, "HEIGHT", size[0])
        monkeypatch.setattr(bench, "WIDTH", size[1])
        assert bench.cpu_reference_fps() == 2.5
    assert len(calls) == 2


def test_a_failing_stage_raises_and_prints_nothing(tmp_path, monkeypatch,
                                                   capsys):
    def broken(device):
        raise RuntimeError("liteflownet failed")

    monkeypatch.setattr(bench, "bench_liteflownet", broken)
    with small_bench(tmp_path), pytest.raises(RuntimeError,
                                              match="liteflownet failed"):
        bench.main([], device="cpu")
    assert capsys.readouterr().out == ""


def test_main_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


@pytest.mark.parametrize("case", ["stall", "budget"])
def test_steady_state_reports_its_window(monkeypatch, case):
    """``_steady_state``'s figures over scripted sample times: the median
    hides a stall that the window's summed seconds show; past its budget it
    stops at one sample and says so."""
    monkeypatch.setattr(bench, "REPEATS", 5)
    times = iter([2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 6.0])
    budget = 0.0 if case == "budget" else 60.0
    median, best, iqr_pct, warmups, n, seconds = bench._steady_state(
        lambda: next(times), stats=True, budget_s=budget)
    if case == "stall":
        # 2 then 1 disagree, 1 and 1 agree: three warm-up samples
        assert (warmups, n, median, best) == (3, 5, 1.0, 1.0)
        assert seconds == 10.0 and iqr_pct == 0.0
    else:
        # the first sample always runs; past the budget, one more
        assert (warmups, n, median, seconds) == (1, 1, 1.0, 1.0)


def test_flagship_chunks_match_jax(tmp_path):
    """Two chained flagship chunks (``FlagshipChain``: gray set n, ``t0``
    n, ``fold_in(key(0), n)``) against JAX's ``jit_scan`` of the same
    model on the same frames and keys: each frame within the bars, the
    last raw flow within 60 dB."""
    with small_bench(tmp_path, CHUNK=4) as patch:
        patch.setattr(jbench, "HEIGHT", H)
        patch.setattr(jbench, "WIDTH", W)
        chain = bench.FlagshipChain(bench.flagship_model("cpu"))
        jmodel = JaxModel(
            H, W,
            [JaxLayerConfig(0, reset_mode="random", reset_random_factor=0.01)],
            {0: [(3, np.ones((H, W), bool))]}, method="farneback",
            estimator_kwargs={}, direction=JaxDirection.BACKWARD)
        jstate = jmodel.init_state(jbench.make_frames(bench.CHUNK + 1)[0])
        jpix = jmodel.default_pixmaps()
        for a, b in zip(jpix[0], chain.pixmaps[0]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        root = jax.random.key(0)
        for n in range(2):
            rgbs = chain.run(1).numpy()
            jstate, jrgbs = jmodel.jit_scan(
                jstate, jnp.asarray(jbench.make_frames(
                    bench.CHUNK, seed=n % bench.GRAY_SETS)),
                jpix, jnp.float32(n), jax.random.fold_in(root, n))
            jrgbs = np.asarray(jrgbs)
            assert rgbs.shape == jrgbs.shape == (bench.CHUNK, H, W, 3)
            for k in range(bench.CHUNK):
                differ = (rgbs[k] != jrgbs[k]).any(axis=-1).mean()
                assert differ <= FRAME_SHARE, (n, k)
            want = np.asarray(jstate["prev_flow"])
            mse = float(np.mean((chain.state["prev_flow"].numpy() - want)
                                ** 2))
            assert mse == 0 or 10 * np.log10(64.0 / mse) >= FLOW_PSNR, n
            assert np.abs(want).max() > 1.0     # the texture's shift found

"""The port's chunk fuzzer (``transflow_tpu_torch/tools/fuzz_chunks.py``)
on the CPU: its draws are tools/fuzz_chunks.py's, and three seeded cases
(a video source with a checkpoint cadence and its resume, an archive
replay with a cadence and a video pixmap, a video source under a skip
lock) are bit-equal chunked, per frame and resumed."""
import importlib.util
import os

import numpy as np
import pytest

from transflow_tpu_torch.tools import fuzz_chunks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5


def _jax_fuzzer():
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_chunks", os.path.join(REPO, "tools", "fuzz_chunks.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [0, 1, SEED])
def test_draws_match_the_jax_fuzzer(seed):
    jfuzz = _jax_fuzzer()
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(20):
        case, layers = fuzz_chunks.draw_case(rng)
        jcase, jlayers = jfuzz.draw_case(jrng, None, None)
        assert case == jcase
        assert [vars(x) for x in layers] == [vars(x) for x in jlayers]


def test_seeded_cases_cover_the_routes():
    """The three cases the tests run: a video with a cadence, the archive
    with a cadence, a lock."""
    rng = np.random.default_rng(SEED)
    cases = [fuzz_chunks.draw_case(rng)[0] for _ in range(3)]
    assert (cases[0]["source"], cases[0]["checkpoint_every"]) == ("video", 5)
    assert (cases[1]["source"], cases[1]["checkpoint_every"]) == ("archive",
                                                                  5)
    assert cases[1]["pixmap"] == "video"
    assert cases[2]["lock"] is not None


@pytest.mark.parametrize("index", [0, 1, 2])
def test_case_is_bit_equal(index, capsys):
    assert fuzz_chunks.run(3, SEED, only=index, device="cpu") == 0
    assert f"ok case {index}:" in capsys.readouterr().out


def test_a_mismatch_fails_the_case(monkeypatch, capsys):
    """A frame that differs fails its case, is counted and exits 1."""
    monkeypatch.setattr(fuzz_chunks, "_same", lambda *args: False)
    assert fuzz_chunks.main(["3", "--seed", str(SEED), "--only", "2",
                             "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL case 2: pixel mismatch" in out
    assert "0/1 cases bit-equal" in out

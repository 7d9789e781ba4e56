"""The trace's reading on a synthetic Chrome trace: the window, busy and
idle time, copies, kernels by name and by the Python stack that launched
them, and idle gaps by the host's operator."""
import pytest

from h100_bench import trace

WIN = {"cat": "user_annotation", "name": trace.WINDOW, "ts": 100.0,
       "dur": 100.0, "tid": 1}


def _events(python=True):
    ev = [WIN,
          {"cat": "kernel", "name": "poly_expansion_kernel", "ts": 90.0,
           "dur": 20.0, "args": {"correlation": 1}},
          {"cat": "kernel", "name": "layer_update_kernel", "ts": 120.0,
           "dur": 10.0, "args": {"correlation": 2}},
          {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 125.0,
           "dur": 15.0, "args": {}},
          {"cat": "kernel", "name": "late", "ts": 195.0, "dur": 10.0,
           "args": {"correlation": 3}},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 85.0,
           "dur": 1.0, "tid": 1, "args": {"correlation": 1}},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 115.0,
           "dur": 1.0, "tid": 1, "args": {"correlation": 2}},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 150.0,
           "dur": 1.0, "tid": 1, "args": {"correlation": 3}},
          {"cat": "cpu_op", "name": "aten::sync", "ts": 160.0, "dur": 30.0,
           "tid": 1}]
    if python:
        ev += [{"cat": "python_function", "name":
                "x/transflow_tpu_torch/engine.py(1): process_chunk",
                "ts": 80.0, "dur": 80.0, "tid": 1},
               {"cat": "python_function", "name":
                "x/transflow_tpu_torch/flow/estimators/farneback.py(2): f",
                "ts": 84.0, "dur": 10.0, "tid": 1},
               {"cat": "python_function", "name":
                "x/transflow_tpu_torch/compositor/core.py(3): update",
                "ts": 114.0, "dur": 5.0, "tid": 1}]
    return ev


def test_timeline_clips_to_the_window():
    tl = trace.Timeline(_events())
    assert tl.window_s == pytest.approx(100e-6)
    # kernels 100-110, 120-130, copy 125-140, kernel 195-200
    assert tl.busy_s == pytest.approx(35e-6)
    assert tl.seconds("kernel") == pytest.approx(25e-6)
    assert tl.seconds("memcpy") == pytest.approx(15e-6)
    assert tl.seconds("kernel", "layer_update") == pytest.approx(10e-6)
    assert tl.top_ops(2)[0][0] == "Memcpy DtoH"


def test_idle_gaps_named_by_the_host():
    gaps = dict(trace.Timeline(_events()).idle_gaps())
    # 110-120 (a launch open at its middle, 115), 140-195 (aten::sync
    # open at 167.5)
    assert gaps == pytest.approx({"aten::sync": 55e-6,
                                  "cudaLaunchKernel": 10e-6})


def test_kernels_attributed_to_their_launching_stack():
    s = trace.Summary(_events(python=False), _events(), frames=2)
    assert s.launched_from("flow/estimators/") == pytest.approx(10e-6)
    assert s.launched_from("transflow_tpu_torch/compositor/") == \
        pytest.approx(10e-6)
    # the late kernel, launched at 150 inside process_chunk, counts its
    # 5 us inside the window
    assert s.launched_from("transflow_tpu_torch/engine.py") == \
        pytest.approx(25e-6)
    assert s.attributed() == pytest.approx(1.0)
    assert s.busy_s == pytest.approx(35e-6)


def test_a_trace_without_the_window_raises():
    with pytest.raises(ValueError):
        trace.Timeline([e for e in _events() if e is not WIN])

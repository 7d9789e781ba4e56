"""The import guard compares whole top-level names: the port passes, the
JAX package, JAX and Flax do not."""
from h100_bench import guard


def test_port_passes():
    assert guard.forbidden_modules(["transflow_tpu_torch",
                                    "transflow_tpu_torch.engine",
                                    "jax_like", "flaxen", "torch"]) == []


def test_jax_package_and_jax_fail():
    found = guard.forbidden_modules(["transflow_tpu", "transflow_tpu.ops",
                                     "jax.numpy", "jaxlib", "flax.linen",
                                     "transflow_tpu_torch"])
    assert found == ["flax.linen", "jax.numpy", "jaxlib", "transflow_tpu",
                     "transflow_tpu.ops"]


def test_a_run_loads_neither():
    import subprocess
    import sys
    from tiny import ROOT
    code = ("import sys; from h100_bench import run, guard; "
            "from tests_tiny_run import main; main(); "
            "print(guard.forbidden_modules()); "
            "sys.exit(bool(guard.forbidden_modules()))")
    out = subprocess.run(
        [sys.executable, "-c", code.replace(
            "from tests_tiny_run import main; main(); ",
            "import sys; sys.path.insert(0, 'h100_bench/tests'); "
            "from tiny import tiny_cell, SEED; "
            "run.run_cell(tiny_cell('liteflownet.live_1080p'), SEED, 0.3, "
            "False, 'cpu'); ")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=False)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]

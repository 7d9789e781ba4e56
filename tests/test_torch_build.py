"""The build of the port's CUDA kernels (``_device._build``) with a
stand-in for nvcc: its output, where ptxas reports registers and spills,
is kept beside the library and read back when the library is already
built, so a check of that report never passes on an empty log."""
import sys

import pytest

from transflow_tpu_torch import _device

PTXAS = "ptxas info    : Used 168 registers, used 1 barriers"

FAKE_NVCC = f"""#!{sys.executable}
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open(out, "w") as f:
    f.write("built")
if "-c" in args:
    print({PTXAS!r})
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``_build`` over one stand-in source with a stand-in nvcc; returns
    the list of the nvcc runs' logs that reached ``KernelLibrary``."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_device, "CSRC_DIR", csrc)
    monkeypatch.setattr(_device, "BUILD_DIR", build)
    monkeypatch.setattr(_device, "nvcc_path", lambda: str(nvcc))
    logs = []
    monkeypatch.setattr(_device, "KernelLibrary",
                        lambda path, seconds, log: logs.append(log) or path)
    return logs, nvcc


def test_build_log_survives_a_cached_library(fake_build, monkeypatch):
    logs, nvcc = fake_build
    first = _device._build()
    assert first.exists() and PTXAS in logs[0]
    assert first.with_suffix(".log").read_text() == logs[0]
    # the second build finds the library and runs no nvcc
    nvcc.unlink()
    assert _device._build() == first
    assert logs[1] == logs[0]
    assert not list(first.parent.glob("*.tmp")) and \
        not list(first.parent.glob("*.o"))


def test_build_without_a_kept_log_reads_empty(fake_build):
    """A library built before the log was kept reads as an empty log (the
    chip smoke then fails its spill check rather than pass it)."""
    logs, _ = fake_build
    first = _device._build()
    first.with_suffix(".log").unlink()
    _device._build()
    assert logs[1] == ""


def test_every_c_entry_has_its_argument_types():
    """Each ``extern "C"`` entry of ``csrc/*.cu`` is in ``_SIGNATURES``
    with one argument type a parameter (the error string excepted, which
    ``KernelLibrary`` types itself): without them ctypes would pass a
    pointer as a 32-bit int."""
    import re
    entries = {}
    for src in _device.CSRC_DIR.glob("*.cu"):
        for name, params in re.findall(
                r'extern "C"[^(]*?\b(transflow_\w+)\(([^)]*)\)',
                src.read_text()):
            entries[name] = len([p for p in params.split(",") if p.strip()])
    entries.pop("transflow_cuda_error_string")
    assert entries == {name: len(types) for name, types
                       in _device._SIGNATURES.items()}

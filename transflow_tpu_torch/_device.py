"""Device and dtype helpers, and the build of the package's CUDA kernels.

The kernels under ``csrc/`` have a plain C interface. The first launch of
any of them compiles every ``csrc/*.cu`` with ``nvcc``, one process per
source, all started together, and links the objects into one shared
library under ``_build/`` (named by a hash of the sources and flags, so an
edited source builds anew), loaded with ``ctypes``. Nothing is built when a
module is imported: the CPU paths never need ``nvcc``.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel dtype codes shared with csrc/*.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the C entry points and their argument types; pointers and the stream are
# c_void_p so ctypes never narrows them to 32-bit ints
_SIGNATURES = {
    # f1, dtype1, f2, dtype2, out, H, W, C, stride, f2_row0, f2_rows, stream
    "transflow_corr7x7": (_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P),
    # table (9 int64 per shard), shards, dtype1, dtype2, W, C, stride,
    # stream
    "transflow_corr7x7_shards": (_P, _I, _I, _I, _I, _I, _I, _P),
    # image, dtype, flow, out, H, W, C, bound, stream
    "transflow_bounded_backwarp": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    # image, dtype, pixel stride, flow, out, H, W, C, stream
    "transflow_exact_backwarp": (_P, _I, _I, _P, _P, _I, _I, _I, _P),
    # y, dtype, bias, out, N, H*W, C, nchw, leaky, stream
    "transflow_conv_epilogue": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, dtype, weight, out, h, w, C, stream
    "transflow_upsample2x_phases": (_P, _I, _P, _P, _I, _I, _I, _P),
    # dist, dist dtype, flow, flow dtype, wx, bx, wy, by, out, H, W, S,
    # stream
    "transflow_reg_apply": (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                            _P),
    # image, dtype, out, storage dtype, H, W, n, params (host), stream
    "transflow_poly_expansion": (_P, _I, _P, _I, _I, _I, _I, _P, _P),
    # image1, image2, dtype, out1, out2, storage dtype, H, W, n, params
    # (host), stream
    "transflow_poly_expansion_pair": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _P,
                                      _P),
    # poly1, poly2, dtype, flow, planes, H, W, select radius, stream
    "transflow_update_equations": (_P, _P, _I, _P, _P, _I, _I, _I, _P),
    # planes, dtype, flow, out, H, W, taps, symmetric, round the vertical
    # sum, vertical taps (host), horizontal taps (host), stream
    "transflow_aggregate_solve": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                                  _P),
    # flow, winner (int32 scratch), out, H, W, stream
    "transflow_forward_to_backward": (_P, _P, _P, _I, _I, _P),
    # prev, next, planes, control, H, W, alpha^2, stream
    "transflow_hs_derivatives": (_P, _P, _P, _P, _I, _I, _F, _P),
    # planes, flow, out, control, partials, partials' count, H, W, delta,
    # has delta, stream
    "transflow_hs_iterate": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # H, W -> B10's count of partial sums (a value, not an error code)
    "transflow_hs_iterate_partials": (_I, _I),
    # image, ix, iy, H, W, stream
    "transflow_lk_scharr": (_P, _P, _P, _I, _I, _P),
    # prev, next, ix, iy, flow, out, H, W, stream
    "transflow_lk_warp_products": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # ix, iy, out, H, W, taps, det floor, stream
    "transflow_lk_structure_tensor": (_P, _P, _P, _I, _I, _I, _F, _P),
    # planes, tensor, flow, out, H, W, taps, eps^2, stream
    "transflow_lk_window_solve": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # 0-3 -> sizeof(UpdateArgs), sizeof(CompositeArgs), sizeof(IntroArgs)
    # or sizeof(BlitArgs) (a value)
    "transflow_compositor_args_size": (_I,),
    # the address of an UpdateArgs (ops/compositor.py), stream
    "transflow_leave_empty_sources": (_P, _P),
    "transflow_layer_update": (_P, _P),
    # the address of an IntroArgs, stream
    "transflow_introduction_update": (_P, _P),
    # the address of a BlitArgs, stream
    "transflow_static_blit": (_P, _P),
    # the address of a CompositeArgs, stream
    "transflow_composite": (_P, _P),
    # the levels' table (host, 22 int64 a level), levels, images, dtype,
    # shared bytes, stream
    "transflow_pyramid_levels": (_P, _I, _I, _I, _I, _P),
    # flow, row starts, row weights, column starts, column weights, out,
    # h, w, lh, lw, row taps, column taps, scale, then
    # ops/pyramid.py::resize_plan's tile rows and columns, row lead, rows,
    # slab, column lead and pitch, stream
    "transflow_flow_resize_tiled": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _F, *[_I] * 7, _P),
    # src0, src1, images, dtype (0 float32, 2 uint8), the levels' table
    # (host, 6 int64), H, W, reduces, stream
    "transflow_lk_pyramid": (_P, _P, _I, _I, _P, _I, _I, _I, _P),
}


def nvcc_path() -> str:
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME",
                                                  "/usr/local/cuda"),
                                   "bin", "nvcc")):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


class KernelLibrary:
    """The compiled ``csrc/`` kernels, loaded with ctypes."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(str(path))
        self._lib.transflow_cuda_error_string.argtypes = (_I,)
        self._lib.transflow_cuda_error_string.restype = ctypes.c_char_p
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = _I

    def query(self, name: str, *args) -> int:
        """The value ``name`` returns: an entry that computes, not launches."""
        return getattr(self._lib, name)(*args)

    def call(self, name: str, *args) -> None:
        """Launch ``name`` and raise if the launch reported an error."""
        err = getattr(self._lib, name)(*args)
        if err != 0:
            msg = self._lib.transflow_cuda_error_string(err).decode()
            raise RuntimeError(f"{name} failed to launch: CUDA error {err} "
                               f"({msg})")


def _build() -> KernelLibrary:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    path = BUILD_DIR / f"libtransflow_kernels-{tag}.so"
    # nvcc's output (ptxas's registers and spills) is kept beside the
    # library and read back when the library is already built
    log_path = path.with_suffix(".log")
    start = time.perf_counter()
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        suffix = f"{tag}.{os.getpid()}"
        objects = [BUILD_DIR / f"{src.stem}-{suffix}.o" for src in sources]
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        # one nvcc per source, all at once; then one link
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objects)]
        logs = [proc.communicate()[0] for proc in procs]
        log = "".join(logs)
        failed = [f"{src.name}: nvcc failed ({proc.returncode}):\n{out}"
                  for src, proc, out in zip(sources, procs, logs)
                  if proc.returncode != 0]
        if not failed:
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                capture_output=True, text=True, check=False)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed.append(f"link failed ({link.returncode}):\n"
                              f"{link.stdout}{link.stderr}")
        for obj in objects:
            obj.unlink(missing_ok=True)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("\n".join(failed))
        log_tmp = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
        log_tmp.write_text(log)
        os.replace(log_tmp, log_path)
        os.replace(tmp, path)
    return KernelLibrary(path, time.perf_counter() - start, log)


@functools.cache
def kernel_library() -> KernelLibrary:
    """Build (at first use) and load the CUDA kernels; one per process."""
    return _build()


def default_device() -> torch.device:
    """Where the port's entry points run when the caller names no device:
    the current CUDA device. Raises without one; never the CPU, which a
    caller asks for by name (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device) -> torch.device:
    """``device`` as a torch device, ``default_device()`` when None."""
    return default_device() if device is None else torch.device(device)


def launch(device: torch.device, name: str, *args) -> None:
    """Launch the kernel library's entry ``name`` with ``args`` while
    ``device`` is the current CUDA device (made so for the call only where
    it is not: the switch costs host time on every launch)."""
    lib = kernel_library()
    if device.index == torch.cuda.current_device():
        lib.call(name, *args)
    else:
        with torch.cuda.device(device):
            lib.call(name, *args)


def cuda_stream(tensor: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``tensor``'s device."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless ``tensors`` are contiguous and on one CUDA device: what
    a kernel wrapper takes."""
    device = tensors[0].device
    if not all(t.is_cuda and t.device == device for t in tensors):
        raise ValueError(f"{name} needs tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def dispatch(name: str, plain, cuda, *tensors: torch.Tensor):
    """A kernel's dispatcher: ``plain`` (its plain PyTorch version) for CPU
    tensors, ``cuda`` (its wrapper) for CUDA tensors, else raise. There is
    no fallback between the two."""
    if all(t.device.type == "cpu" for t in tensors):
        return plain
    if tensors[0].is_cuda:
        return cuda
    raise ValueError(f"{name} has no path for device {tensors[0].device}")

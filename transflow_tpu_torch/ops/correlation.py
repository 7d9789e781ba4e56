"""Cost-volume correlation (FlowNet-style 7x7 window).

Counterpart of transflow_tpu/ops/correlation.py and
transflow_tpu/ops/pallas_correlation.py. ``correlation7x7`` is the plain
PyTorch version; ``correlation7x7_cuda`` launches the hand-written kernel in
``csrc/correlation.cu``; ``sharded_correlation7x7`` runs the same kernel on
each shard of a ``SpaceMesh`` after a halo exchange (its plain version is
``correlation7x7_band``); ``correlation`` picks one. All keep the JAX
layout: (H, W, C) x (H, W, C) -> (ceil(H/s), ceil(W/s), 49) float32.
"""
import torch
import torch.nn.functional as F

from .._device import DTYPE_CODES, cuda_stream, kernel_library
from ..parallel.mesh import exchange_rows

WINDOW = 7
MAX_DISP = 3
KERNELS = (None, "xla", "pallas", "pallas_halo")


def _stage_dtype(x: torch.Tensor) -> torch.Tensor:
    """Each operand is read in its own dtype: bf16 stays bf16, anything
    else is read as f32 (pallas_correlation.py::_stage_dtype). The math is
    f32 either way."""
    return x if x.dtype in (torch.bfloat16, torch.float32) else x.float()


def _taps(f1: torch.Tensor, f2p: torch.Tensor, stride: int) -> torch.Tensor:
    """The 49 channel means of f1 against ``f2p``, f2's rows and columns
    from -3s to H + 3s (zeros outside the frame)."""
    h, w, _ = f1.shape
    pad = MAX_DISP * stride
    f1s = _stage_dtype(f1)[::stride, ::stride].float()
    outs = []
    for dy in range(-MAX_DISP, MAX_DISP + 1):
        for dx in range(-MAX_DISP, MAX_DISP + 1):
            y0, x0 = pad + dy * stride, pad + dx * stride
            shifted = f2p[y0:y0 + h:stride, x0:x0 + w:stride]
            outs.append((f1s * shifted).mean(dim=-1))
    return torch.stack(outs, dim=-1)


def correlation7x7(f1: torch.Tensor, f2: torch.Tensor,
                   stride: int = 1) -> torch.Tensor:
    """Plain version: 49 shifted products with a channel mean.

    out[y, x, (dy+3)*7+(dx+3)] =
        mean_c f1[y*s, x*s, c] * f2[y*s + dy*s, x*s + dx*s, c]
    with zero padding outside the frame, computed in f32."""
    pad = MAX_DISP * stride
    f2p = F.pad(_stage_dtype(f2).float(), (0, 0, pad, pad, pad, pad))
    return _taps(f1, f2p, stride)


def correlation7x7_band(f1: torch.Tensor, f2_band: torch.Tensor,
                        stride: int = 1, row0: int = 0) -> torch.Tensor:
    """Plain version of the band computation: ``correlation7x7`` of f1
    against the f2 rows that ``f2_band`` holds, its row ``row0`` lined up
    with f1's row 0; rows the band does not hold, and columns outside the
    frame, read as zeros."""
    h = f1.shape[0]
    pad = MAX_DISP * stride
    rows = f2_band.shape[0]
    lo, hi = row0 - pad, row0 + h + pad
    f2 = _stage_dtype(f2_band).float()[max(lo, 0):min(hi, rows)]
    f2p = F.pad(f2, (0, 0, pad, pad, max(0, -lo), max(0, hi - rows)))
    return _taps(f1, f2p, stride)


def _launch(f1: torch.Tensor, f2: torch.Tensor, stride: int,
            row0: int) -> torch.Tensor:
    """Launch the kernel on the (H, W, C) f1 and the (R, W, C) f2 buffer
    whose row ``row0`` lines up with f1's row 0; counts nothing."""
    if not (f1.is_cuda and f2.is_cuda) or f1.device != f2.device:
        raise ValueError("the correlation kernel needs both operands on one "
                         f"CUDA device, got {f1.device} and {f2.device}")
    if f1.dim() != 3 or f2.dim() != 3 or f1.shape[1:] != f2.shape[1:]:
        raise ValueError("the correlation kernel needs (H, W, C) operands "
                         f"of one width and depth, got {tuple(f1.shape)} "
                         f"and {tuple(f2.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    f1, f2 = _stage_dtype(f1), _stage_dtype(f2)
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("the correlation kernel needs contiguous (H, W, C) "
                         "operands")
    h, w, c = f1.shape
    out = torch.empty((-(-h // stride), -(-w // stride), WINDOW * WINDOW),
                      dtype=torch.float32, device=f1.device)
    with torch.cuda.device(f1.device):
        kernel_library().call(
            "transflow_corr7x7", f1.data_ptr(), DTYPE_CODES[f1.dtype],
            f2.data_ptr(), DTYPE_CODES[f2.dtype], out.data_ptr(), h, w, c,
            stride, row0, f2.shape[0], cuda_stream(f1))
    return out


def correlation7x7_cuda(f1: torch.Tensor, f2: torch.Tensor,
                        stride: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel on (H, W, C) CUDA tensors of one shape,
    contiguous, each float32 or bfloat16. ``correlation7x7_cuda.launches``
    counts launches."""
    if f1.shape != f2.shape:
        raise ValueError("correlation7x7_cuda needs two (H, W, C) tensors "
                         f"of one shape, got {tuple(f1.shape)} and "
                         f"{tuple(f2.shape)}")
    out = _launch(f1, f2, stride, 0)
    correlation7x7_cuda.launches += 1
    return out


correlation7x7_cuda.launches = 0


def sharded_ok(h: int, n_space: int, stride: int) -> bool:
    """Whether ``sharded_correlation7x7`` applies at this shape.

    The split must be exact; stride 2 also needs every shard to start on
    an even global row, so the per-shard subsample hits the same grid as
    the global one. Tiny shards aren't worth a launch and a halo exchange.
    Parity: pallas_correlation.py::sharded_ok."""
    if h % (n_space * stride):
        return False
    return h // (n_space * stride) >= 8


def sharded_correlation7x7(f1: torch.Tensor, f2: torch.Tensor, mesh,
                           stride: int = 1) -> torch.Tensor:
    """The correlation with H split over ``mesh`` (kernel A2).

    Parity: pallas_correlation.py::sharded_pallas_correlation7x7. Both
    operands are split over the mesh's devices, each staged in its own
    dtype; every shard receives 3*stride boundary rows of f2 from each
    neighbour (zeros at the frame's edges) and runs the band computation
    on its haloed f2 band: the kernel on a CUDA shard, its plain version
    on a CPU one. Returns the whole output on f1's device.
    ``sharded_correlation7x7.launches`` counts the shards' kernel
    launches (``correlation7x7_cuda.launches`` does not)."""
    h = f1.shape[0]
    n = mesh.shape["space"]
    if not sharded_ok(h, n, stride):
        raise ValueError(
            f"H={h} does not shard over {n} devices at stride {stride} "
            "(check sharded_ok first)")
    pad = MAX_DISP * stride
    f1_bands = mesh.split(_stage_dtype(f1))
    f2_bands = mesh.split(_stage_dtype(f2))
    outs = []
    for a, b, (top, bottom) in zip(f1_bands, f2_bands,
                                   exchange_rows(f2_bands, pad, mesh)):
        band = torch.cat([top, b, bottom])
        if a.device.type == "cpu":
            outs.append(correlation7x7_band(a, band, stride, pad))
        else:
            outs.append(_launch(a, band, stride, pad))
            sharded_correlation7x7.launches += 1
    return mesh.join(outs, f1.device)


sharded_correlation7x7.launches = 0


def check_kernel(kernel: str | None, mesh=None) -> None:
    """JAX's checks of a correlation override (correlation.py:57-67)."""
    if kernel not in KERNELS:
        raise ValueError(
            "correlation kernel must be 'xla', 'pallas' or 'pallas_halo', "
            f"got {kernel!r}")
    if kernel == "pallas_halo":
        if mesh is None:
            raise ValueError("correlation kernel 'pallas_halo' needs a mesh")
        if "space" not in mesh.shape:
            raise ValueError(
                "correlation kernel 'pallas_halo' shards over a 'space' "
                f"mesh axis; got axes {tuple(mesh.shape)}")


def correlation(f1: torch.Tensor, f2: torch.Tensor, stride: int = 1,
                kernel: str | None = None, mesh=None) -> torch.Tensor:
    """Dispatcher. ``kernel`` takes JAX's values:

    * None or 'pallas': CPU tensors take the plain version, CUDA tensors
      the kernel (where JAX runs the Pallas kernel, in interpret mode on
      the CPU); there is no fallback between the two;
    * 'xla': the plain version;
    * 'pallas_halo': ``sharded_correlation7x7`` over ``mesh`` (a mesh with
      a 'space' axis) where ``sharded_ok`` holds, else the unsharded
      correlation: the JAX package's static shape rule, not a fallback on
      failure."""
    check_kernel(kernel, mesh)
    if kernel == "pallas_halo" and sharded_ok(f1.shape[0],
                                              mesh.shape["space"], stride):
        return sharded_correlation7x7(f1, f2, mesh, stride)
    if kernel == "xla":
        return correlation7x7(f1, f2, stride)
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return correlation7x7(f1, f2, stride)
    if f1.is_cuda:
        return correlation7x7_cuda(f1, f2, stride)
    raise ValueError(f"correlation has no path for device {f1.device}")

"""Cost-volume correlation (FlowNet-style 7x7 window).

Counterpart of transflow_tpu/ops/correlation.py and
transflow_tpu/ops/pallas_correlation.py. ``correlation7x7`` is the plain
PyTorch version; ``correlation7x7_cuda`` launches the hand-written kernel in
``csrc/correlation.cu``; ``sharded_correlation7x7`` runs the same kernel
over the shards of a ``SpaceMesh``, one launch per device, reading each
shard's halo rows where they lie (its plain version is
``correlation7x7_segments`` per shard); ``correlation`` picks one. All
keep the JAX layout: (H, W, C) x (H, W, C) -> (ceil(H/s), ceil(W/s), 49)
float32.
"""
import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .._device import DTYPE_CODES, cuda_stream, launch

WINDOW = 7
MAX_DISP = 3
KERNELS = (None, "xla", "pallas", "pallas_halo")
# shards that one launch of the sharded entry takes (csrc kMaxShards)
MAX_SHARDS_PER_LAUNCH = 8


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


def correlation7x7_cuda(f1: torch.Tensor, f2: torch.Tensor,
                        stride: int = 1) -> torch.Tensor:
    """Launch the CUDA kernel on (H, W, C) CUDA tensors of one shape,
    contiguous, each float32 or bfloat16. ``correlation7x7_cuda.launches``
    counts launches."""
    if not (f1.is_cuda and f2.is_cuda) or f1.device != f2.device:
        raise ValueError("the correlation kernel needs both operands on one "
                         f"CUDA device, got {f1.device} and {f2.device}")
    if f1.dim() != 3 or f1.shape != f2.shape:
        raise ValueError("the correlation kernel needs two (H, W, C) "
                         f"tensors of one shape, got {tuple(f1.shape)} and "
                         f"{tuple(f2.shape)}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    f1, f2 = _stage_dtype(f1), _stage_dtype(f2)
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("the correlation kernel needs contiguous (H, W, C) "
                         "operands")
    h, w, c = f1.shape
    out = torch.empty((-(-h // stride), -(-w // stride), WINDOW * WINDOW),
                      dtype=torch.float32, device=f1.device)
    # the C entry's row window (f2_row0, f2_rows) is the whole frame here
    launch(f1.device, "transflow_corr7x7", f1.data_ptr(),
           DTYPE_CODES[f1.dtype], f2.data_ptr(), DTYPE_CODES[f2.dtype],
           out.data_ptr(), h, w, c, stride, 0, h, cuda_stream(f1))
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


class ShardSegments(NamedTuple):
    """One shard of A2 on its device: its f1 rows, f2 as three row
    segments (the 3s rows above it, its own rows, the 3s rows below it; a
    halo is None at the frame's edge, read as zeros) and its first row in
    the joined output."""
    f1: torch.Tensor
    top: torch.Tensor | None
    body: torch.Tensor
    bottom: torch.Tensor | None
    out_row0: int


def shard_segments(f1: torch.Tensor, f2: torch.Tensor, mesh,
                   stride: int) -> list[ShardSegments]:
    """Each shard's ``ShardSegments`` over ``mesh``. A halo is a view of
    the neighbour's rows where the neighbour lies on the shard's device
    (read in place: no copy, no zero rows) and a ``Tensor.to`` copy where
    it lies on another (the two ``ppermute``s of the JAX entry)."""
    pad = MAX_DISP * stride
    f1_bands, f2_bands = mesh.split(f1), mesh.split(f2)
    n = len(f2_bands)
    out_rows = -(-f1_bands[0].shape[0] // stride)
    return [ShardSegments(
        f1_bands[i],
        f2_bands[i - 1][-pad:].to(dev) if i > 0 else None,
        f2_bands[i],
        f2_bands[i + 1][:pad].to(dev) if i < n - 1 else None,
        i * out_rows) for i, dev in enumerate(mesh.devices)]


def correlation7x7_segments(f1: torch.Tensor, top: torch.Tensor | None,
                            body: torch.Tensor, bottom: torch.Tensor | None,
                            stride: int = 1) -> torch.Tensor:
    """Plain version of one shard of A2 (the CPU twin of the kernel's
    sharded entry): ``correlation7x7_band`` of f1 against the band that
    the three segments make, body row 0 lined up with f1's row 0; an
    absent halo reads as zeros."""
    parts = [x for x in (top, body, bottom) if x is not None]
    row0 = 0 if top is None else top.shape[0]
    return correlation7x7_band(f1, torch.cat(parts), stride, row0)


def _rows(x: torch.Tensor | None) -> tuple[int, int]:
    return (0, 0) if x is None else (x.data_ptr(), x.shape[0])


def shard_table(shards: list[ShardSegments], out: torch.Tensor,
                out_rows0: list[int]) -> list[int]:
    """The sharded entry's descriptors, 9 integers per shard: f1's address
    and rows, each f2 segment's address and rows (0, 0 for an absent
    halo), and the address of the shard's first row in ``out``."""
    table = []
    for s, row0 in zip(shards, out_rows0):
        table += [s.f1.data_ptr(), s.f1.shape[0], *_rows(s.top),
                  *_rows(s.body), *_rows(s.bottom), out[row0].data_ptr()]
    return table


def one_card_table(f1: torch.Tensor, f2: torch.Tensor, out: torch.Tensor,
                   n: int, stride: int) -> list[int]:
    """``shard_table`` for n shards of contiguous f1, f2 and ``out`` that
    lie on one device, from their addresses alone (no views: this is the
    host's part of every sharded launch on one card, where building
    ``shard_segments``' views costs the host more than the kernel takes;
    chip_smoke.py's sharded phase times both)."""
    h, w, c = f1.shape
    rows, pad = h // n, MAX_DISP * stride
    row1, row2 = w * c * f1.element_size(), w * c * f2.element_size()
    row_out = out[0].numel() * out.element_size()
    base1, base2, base_out = f1.data_ptr(), f2.data_ptr(), out.data_ptr()
    table = []
    for i in range(n):
        top = (base2 + (i * rows - pad) * row2, pad) if i else (0, 0)
        bottom = ((base2 + (i + 1) * rows * row2, pad) if i < n - 1
                  else (0, 0))
        table += [base1 + i * rows * row1, rows, *top,
                  base2 + i * rows * row2, rows, *bottom,
                  base_out + i * (rows // stride) * row_out]
    return table


def _launch_table(table: list[int], f1: torch.Tensor, f2: torch.Tensor,
                  stride: int) -> None:
    """One launch of the sharded entry over ``table``'s shards, whose f1
    and f2 are shaped and typed as ``f1`` and ``f2``; counts nothing."""
    n = len(table) // 9
    if not 1 <= n <= MAX_SHARDS_PER_LAUNCH:
        raise ValueError(f"1 to {MAX_SHARDS_PER_LAUNCH} shards per launch, "
                         f"got {n}")
    array = (ctypes.c_longlong * len(table))(*table)
    launch(f1.device, "transflow_corr7x7_shards", ctypes.addressof(array), n,
           DTYPE_CODES[f1.dtype], DTYPE_CODES[f2.dtype], f1.shape[1],
           f1.shape[2], stride, cuda_stream(f1))


def _launch_shards(shards: list[ShardSegments], out: torch.Tensor,
                   out_rows0: list[int], stride: int) -> None:
    """One launch of the kernel's sharded entry for up to 8 shards on one
    CUDA device; shard i writes ``out`` from row ``out_rows0[i]``. Counts
    nothing."""
    device = shards[0].f1.device
    ref = shards[0]
    tensors = [t for s in shards for t in s[:4] if t is not None] + [out]
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("the sharded correlation kernel needs every shard "
                         f"of a launch on one CUDA device, got {device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the sharded correlation kernel needs contiguous "
                         "row segments")
    for s in shards:
        if (s.f1.dtype != ref.f1.dtype or s.f1.shape != ref.f1.shape
                or s.body.shape != ref.f1.shape or any(
                    x is not None and (x.shape[1:] != ref.f1.shape[1:]
                                       or x.dtype != ref.body.dtype)
                    for x in (s.top, s.bottom, s.body))):
            raise ValueError("the shards of a launch need (rows, W, C) f1 "
                             "and f2 segments of one shape and dtype")
    _launch_table(shard_table(shards, out, out_rows0), ref.f1, ref.body,
                  stride)


def sharded_correlation7x7(f1: torch.Tensor, f2: torch.Tensor, mesh,
                           stride: int = 1) -> torch.Tensor:
    """The correlation with H split over ``mesh`` (kernel A2).

    Parity: pallas_correlation.py::sharded_pallas_correlation7x7. Both
    operands are split over the mesh's devices, each staged in its own
    dtype; every shard reads 3*stride boundary rows of f2 from each
    neighbour (zeros at the frame's edges). Where every shard lies on f1's
    card (``SpaceMesh(["cuda:0"] * n)``, n <= 8) one launch runs them all,
    reading each shard's rows and halos where they lie in f1 and f2 and
    writing its rows of the output (``one_card_table``). Otherwise the
    operands are cut into ``shard_segments`` (a halo from another device
    is copied over): the shards of each CUDA device run in one launch per
    8, writing the joined output directly on f1's device, and CPU shards
    run the plain version, ``correlation7x7_segments``, one by one.
    Returns the whole output on f1's device.
    ``sharded_correlation7x7.launches`` counts the kernel launches
    (``correlation7x7_cuda.launches`` does not)."""
    h, w = f1.shape[:2]
    n = mesh.shape["space"]
    if not sharded_ok(h, n, stride):
        raise ValueError(
            f"H={h} does not shard over {n} devices at stride {stride} "
            "(check sharded_ok first)")
    f1, f2 = _stage_dtype(f1), _stage_dtype(f2)
    oh, ow = -(-h // stride), -(-w // stride)
    rows = oh // n
    out = torch.empty((oh, ow, WINDOW * WINDOW), dtype=torch.float32,
                      device=f1.device)
    if (f1.is_cuda and n <= MAX_SHARDS_PER_LAUNCH and f2.device == f1.device
            and all(d == f1.device for d in mesh.devices)):
        if f1.shape != f2.shape or not (f1.is_contiguous()
                                        and f2.is_contiguous()):
            raise ValueError("the sharded correlation kernel needs "
                             "contiguous (H, W, C) operands of one shape, "
                             f"got {tuple(f1.shape)} and {tuple(f2.shape)}")
        _launch_table(one_card_table(f1, f2, out, n, stride), f1, f2,
                      stride)
        sharded_correlation7x7.launches += 1
        return out
    shards = shard_segments(f1, f2, mesh, stride)
    by_device: dict[torch.device, list[ShardSegments]] = {}
    for shard, dev in zip(shards, mesh.devices):
        by_device.setdefault(dev, []).append(shard)
    for dev, group in by_device.items():
        if dev.type == "cpu":
            for s in group:
                out[s.out_row0:s.out_row0 + rows] = correlation7x7_segments(
                    *s[:4], stride)
            continue
        local = out if dev == out.device else torch.empty(
            (len(group) * rows, ow, WINDOW * WINDOW), dtype=torch.float32,
            device=dev)
        rows0 = ([s.out_row0 for s in group] if local is out
                 else [j * rows for j in range(len(group))])
        for k in range(0, len(group), MAX_SHARDS_PER_LAUNCH):
            _launch_shards(group[k:k + MAX_SHARDS_PER_LAUNCH], local,
                           rows0[k:k + MAX_SHARDS_PER_LAUNCH], stride)
            sharded_correlation7x7.launches += 1
        if local is not out:
            for s, row0 in zip(group, rows0):
                out[s.out_row0:s.out_row0 + rows] = local[row0:row0 + rows]
    return out


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

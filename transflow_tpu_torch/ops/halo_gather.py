"""Bounded-displacement 2-D gather, and its H-sharded form.

Counterpart of transflow_tpu/ops/halo_gather.py. The compositor's
movement reads ``v[src_i, src_j]``; with ``halo`` set, the row reach
``src_i - i`` is clamped to ``[-halo, halo]``, so under a ``space`` mesh a
shard only ever reads its neighbours' nearest ``halo`` rows.

``bounded_row_gather`` keeps the semantics of the JAX function as one
gather at the clamped row; the JAX function's 2*halo+1 row shifts exist
so that GSPMD partitions the gather into neighbour-row exchanges, and a
plain gather does the same job here. ``sharded_bounded_gather`` is the
manual-SPMD entry: split over the mesh, exchange ``halo`` rows with each
neighbour, one local gather per shard, join.
"""
import torch

from ..parallel.mesh import exchange_rows

__all__ = ["bounded_row_gather", "clamped_rows", "sharded_bounded_gather"]


def _rows(src_i: torch.Tensor) -> torch.Tensor:
    return torch.arange(src_i.shape[0], dtype=src_i.dtype,
                        device=src_i.device)[:, None]


def clamped_rows(src_i: torch.Tensor, halo: int) -> torch.Tensor:
    """The rows the bounded gather reads for the (H, W) source rows
    ``src_i``: ``clip(i + clip(src_i - i, -halo, halo), 0, H-1)``."""
    ii = _rows(src_i)
    return (ii + (src_i - ii).clamp(-halo, halo)).clamp(0, src_i.shape[0] - 1)


def bounded_row_gather(v: torch.Tensor, src_i: torch.Tensor,
                       src_j: torch.Tensor, halo: int) -> torch.Tensor:
    """``v[clamped_rows(src_i, halo), src_j]``.

    v: (H, W) or (H, W, C); src_i and src_j: (H, W) integer tensors, src_j
    in [0, W-1]. Equal to ``v[src_i, src_j]`` where ``|src_i - i| <=
    halo``; rows further away clamp to the halo window."""
    return v[clamped_rows(src_i, halo).long(), src_j.long()]


def sharded_bounded_gather(v: torch.Tensor, src_i: torch.Tensor,
                           src_j: torch.Tensor, halo: int,
                           mesh) -> torch.Tensor:
    """``bounded_row_gather`` over the shards of ``mesh``: one local gather
    per shard into its haloed row window, bit-equal to the unsharded one.

    ``src_i`` is in the frame, so the clamped reach never crosses the
    frame's edge and the zero rows the edge shards receive are never read.
    Needs ``H % n == 0`` and ``1 <= halo <= H / n`` (the exchange reaches
    nearest neighbours only). Returns the result on v's device. Parity:
    halo_gather.py::sharded_bounded_gather."""
    h = v.shape[0]
    n = mesh.shape["space"]
    if h % n:
        raise ValueError(f"H={h} does not shard over {n} devices")
    if halo < 1 or h // n < halo:
        raise ValueError(
            f"halo={halo} needs 1 <= halo <= shard height {h // n} "
            "(neighbor-only exchange); use bounded_row_gather")
    v_bands = mesh.split(v)
    reach_bands = mesh.split((src_i - _rows(src_i)).clamp(-halo, halo))
    j_bands = mesh.split(src_j)
    outs = []
    for v_loc, reach, sj, (top, bottom) in zip(
            v_bands, reach_bands, j_bands, exchange_rows(v_bands, halo, mesh)):
        padded = torch.cat([top, v_loc, bottom])
        li = _rows(reach) + halo + reach
        outs.append(padded[li.long(), sj.long()])
    return mesh.join(outs, v.device)

"""Deterministic scatter primitives. Counterpart of
transflow_tpu/ops/scatter.py; ``scatter_last_wins`` (the ``-d forward``
path) waits for ROADMAP Queue 1, item 6."""
import torch


def scatter_any(target_shape: tuple[int, ...], flat_indices: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Boolean occupancy: out.flat[i] = any(mask[p] for p with
    flat_indices[p] == i), as an amax scatter. ``flat_indices`` may hold
    anything where ``mask`` is False: those writes go to a spare slot that
    is dropped."""
    size = 1
    for dim in target_shape:
        size *= dim
    mask = mask.reshape(-1)
    idx = torch.where(mask, flat_indices.reshape(-1).long(), size)
    out = torch.zeros(size + 1, dtype=torch.int32, device=mask.device)
    out.scatter_reduce_(0, idx, mask.to(torch.int32), reduce="amax")
    return (out[:size] > 0).reshape(target_shape)

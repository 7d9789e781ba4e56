"""Deterministic scatter primitives, and kernel B5 (forward to backward).

Counterpart of transflow_tpu/ops/scatter.py. The reference resolves scatter
collisions through numpy.put's sequential last-write-wins order
(transflow/utils.py:421-430, transflow/flow/sources/source.py:349-360);
here, as in the JAX package, an amax scatter of the 1-based flat write
order picks the last writer in flat order, whatever order the writes land
in.

``forward_to_backward`` is transflow_tpu/flow/transforms.py's function of
that name, the ``-d forward`` path's conversion, with three functions as
the Farneback ops have: ``forward_to_backward_plain`` (the plain PyTorch
version, through ``scatter_last_wins``), ``forward_to_backward_cuda``
(kernel B5 of ``csrc/scatter.cu``, counted) and the dispatcher, which
sends CPU tensors to the first and CUDA tensors to the second, with no
fallback between them. The two agree bit for bit.
"""
import torch

from .._device import cuda_stream, launch
from .image import clip_to_frame


def scatter_any(target_shape: tuple[int, ...], flat_indices: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Boolean occupancy: out.flat[i] = any(mask[p] for p with
    flat_indices[p] == i), as an amax scatter. ``flat_indices`` may hold
    anything where ``mask`` is False: those writes put a 0 (no change)
    at the writer's own position, so they contend with no other write
    (one shared spare slot for all of them serialises the atomics on the
    card)."""
    size = 1
    for dim in target_shape:
        size *= dim
    mask = mask.reshape(-1)
    own = torch.arange(mask.numel(), device=mask.device) % size
    idx = torch.where(mask, flat_indices.reshape(-1).long(), own)
    out = torch.zeros(size, dtype=torch.int32, device=mask.device)
    out.scatter_reduce_(0, idx, mask.to(torch.int32), reduce="amax")
    return (out > 0).reshape(target_shape)


def scatter_last_wins(values: torch.Tensor, flat_indices: torch.Tensor,
                      mask: torch.Tensor,
                      default: torch.Tensor) -> torch.Tensor:
    """out[i] = values[p*] where p* is the LAST p (in flat order) with
    mask[p] and flat_indices[p] == i; default[i] elsewhere: numpy.put's
    rule for masked writes. ``values``/``default`` are (N[, C]) and
    ``flat_indices``/``mask`` (N,); masked-out indices may hold anything.

    An amax ``scatter_reduce_`` of the 1-based write order (0, no change,
    for a masked-out write, at the writer's own position as in
    ``scatter_any``), then a gather of the winning writer's value."""
    size = default.shape[0]
    n = flat_indices.shape[0]
    order = torch.arange(1, n + 1, dtype=torch.int32, device=values.device)
    idx = torch.where(mask, flat_indices.long(), (order.long() - 1) % size)
    winner = torch.zeros(size, dtype=torch.int32, device=values.device)
    winner.scatter_reduce_(0, idx, torch.where(mask, order, 0),
                           reduce="amax")
    picked = values[(winner - 1).clamp(min=0).long()]
    has_writer = (winner > 0).reshape((-1,) + (1,) * (values.dim() - 1))
    return torch.where(has_writer, picked, default)


def _check_flow(flow: torch.Tensor) -> None:
    if flow.dim() != 3 or flow.shape[2] != 2 or flow.dtype != torch.float32:
        raise ValueError(f"forward_to_backward needs an (H, W, 2) float32 "
                         f"flow, got {tuple(flow.shape)} {flow.dtype}")


def forward_to_backward_plain(flow: torch.Tensor) -> torch.Tensor:
    """Convert a forward flow into a backward mapping (parity:
    source.py:349-360): clip to the frame, round half to even, scatter the
    base coordinates along the flow (the last writer in flat order wins),
    subtract the base. (H, W, 2) float32 in and out."""
    _check_flow(flow)
    h, w = flow.shape[:2]
    n = h * w
    flow = clip_to_frame(flow)
    flow_int = torch.round(flow).to(torch.int32)
    flow_flat = (flow_int[..., 1] * w + flow_int[..., 0]).reshape(-1)
    base = torch.arange(n, dtype=torch.int32, device=flow.device)
    targets = (base + flow_flat).clamp(0, n - 1)
    mask = flow_flat != 0
    coords = torch.stack([(base % w).float(), (base // w).float()], dim=-1)
    scattered = scatter_last_wins(coords, targets, mask, coords)
    return (scattered - coords).reshape(h, w, 2)


# kernel B5's scratch: H*W + 2 int32 words per device, stream and size,
# zeroed once when made. B5 never clears it between calls (each call tags
# its words with an epoch that it keeps in the last two words); a call on
# another stream takes its own, so two streams never share one.
_WINNERS: dict[tuple[int, int, int], torch.Tensor] = {}


def forward_to_backward_cuda(flow: torch.Tensor) -> torch.Tensor:
    """Kernel B5 on a contiguous (H, W, 2) float32 flow on a CUDA device:
    two kernel launches (scatter, resolve) on the current stream, each
    counted on ``forward_to_backward_cuda.launches``, over the stream's
    scratch. A launch that fails drops that scratch: its words may then
    be ahead of its epoch."""
    _check_flow(flow)
    if not flow.is_cuda or not flow.is_contiguous():
        raise ValueError("forward_to_backward_cuda needs a contiguous flow "
                         f"on a CUDA device, got {flow.device}")
    if flow.data_ptr() % 16:
        flow = flow.clone()     # the kernel takes 16-byte aligned tensors
    h, w = flow.shape[:2]
    stream = cuda_stream(flow)
    key = (flow.device.index, stream, h * w)
    winner = _WINNERS.get(key)
    if winner is None:
        winner = torch.zeros(h * w + 2, dtype=torch.int32,
                             device=flow.device)
        _WINNERS[key] = winner
    out = torch.empty_like(flow)
    try:
        launch(flow.device, "transflow_forward_to_backward", flow.data_ptr(),
               winner.data_ptr(), out.data_ptr(), h, w, stream)
    except RuntimeError:
        del _WINNERS[key]
        raise
    forward_to_backward_cuda.launches += 2
    return out


forward_to_backward_cuda.launches = 0


def forward_to_backward(flow: torch.Tensor) -> torch.Tensor:
    """Dispatcher of B5 by the flow's device."""
    if flow.device.type == "cpu":
        return forward_to_backward_plain(flow)
    if flow.is_cuda:
        return forward_to_backward_cuda(flow.contiguous())
    raise ValueError(f"forward_to_backward has no path for device "
                     f"{flow.device}")

"""Horn-Schunck optical flow in PyTorch.

Counterpart of transflow_tpu/flow/estimators/horn_schunck.py (transflow's
flow/methods/horn_schunck.py): a binomial pre-blur, the derivative
stencils, then Jacobi steps toward the alpha-regularised flow with an
early stop on ``||du||_2 < delta``, from zero or from ``decay *
prev_flow``.

1. kernel B9 (``ops/horn_schunck.py::hs_derivatives``): both frames'
   blur, ``ex``, ``ey``, ``et`` and ``denom`` in one launch;
2. ``max_iters`` launches of kernel B10 (``hs_iterate``): one step each.
   The JAX function's ``while_loop`` stops on a norm it computes on the
   device; here the stop is a word in a device buffer that B10's last
   block sets, and the launches after it copy the flow through, so the
   host never waits for the card.

On a CPU tensor both run their plain versions; on a CUDA tensor the
kernels.
"""
import torch

from ...ops.horn_schunck import hs_derivatives, hs_iterate

__all__ = ["horn_schunck", "horn_schunck_counted"]


def horn_schunck_counted(prev_gray, next_gray, prev_flow=None, *,
                         alpha: float = 1.0, max_iters: int = 3,
                         decay: float = 0.0, delta: float | None = 1.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``horn_schunck`` and the iterations it took: a 0-d int32 tensor on
    the frames' device (reading it on the host waits for the card)."""
    prev_gray = torch.as_tensor(prev_gray)
    next_gray = torch.as_tensor(next_gray, device=prev_gray.device)
    planes, control = hs_derivatives(prev_gray.contiguous(),
                                     next_gray.contiguous(), alpha)
    if prev_flow is None:
        flow = torch.zeros((*prev_gray.shape, 2), dtype=torch.float32,
                           device=prev_gray.device)
    else:
        # a float32 product, as the JAX function's weak-typed decay makes it
        flow = (decay * torch.as_tensor(
            prev_flow, device=prev_gray.device).float()).contiguous()
    for _ in range(int(max_iters)):
        flow = hs_iterate(planes, flow, control, delta)
    return flow, control[1]


def horn_schunck(prev_gray, next_gray, prev_flow=None, *, alpha: float = 1.0,
                 max_iters: int = 3, decay: float = 0.0,
                 delta: float | None = 1.0) -> torch.Tensor:
    """Estimate the (H, W, 2) float32 flow between two (H, W) uint8
    grayscale frames, on their device; ``delta=None`` never stops early."""
    return horn_schunck_counted(prev_gray, next_gray, prev_flow, alpha=alpha,
                                max_iters=max_iters, decay=decay,
                                delta=delta)[0]

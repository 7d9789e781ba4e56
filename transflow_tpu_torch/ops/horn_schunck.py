"""Horn-Schunck's hot loops: kernels B9 (pre-blur and derivatives) and B10
(one Jacobi step, with the early stop kept on the device).

Counterpart of transflow_tpu/flow/estimators/horn_schunck.py, which XLA
compiles from jnp ops (there is no Pallas source). Each kernel has three
functions, as in ``ops/farneback.py``: ``*_plain``, the plain PyTorch
version; ``*_cuda``, which launches the hand-written kernel of
``csrc/horn_schunck.cu`` and counts its launches; and the dispatcher, which
sends CPU tensors to the first and CUDA tensors to the second.

Layouts: the four derivative planes are one (4, H, W) float32 stack
``[ex, ey, et, denom]``; flows are (H, W, 2) float32 ``(u, v)``; the
control block is an int32 tensor of ``CONTROL_WORDS`` words ``[stop,
iterations taken, blocks done, unused]`` on the planes' device, zeroed by
B9 and updated by every B10 launch. The early stop is the JAX loop's
``sqrt(sum((new_u - u)**2)) < delta``: B10's last block to finish sets the
stop word, and a later launch that finds it set copies its flow through,
so the host launches ``max_iters`` steps and never reads the norm.

The pre-blur and the stencils are exact in float32 (every blurred value is
a multiple of 1/256 and every derivative of 1/1024), and ``denom``'s two
multiply-adds are fused as XLA's CPU compiler fuses them, so B9 equals the
JAX function bit for bit in any order of sums. B10's plain version adds the
3x3 average's eight nonzero taps in row-major order with each product and
sum rounded to float32, the kernel's order; its squared steps are summed
in float64 (the kernel's order differs, so the stop decision of the two
can differ only where the norm lies within float64 rounding of ``delta``).
"""
import math

import numpy as np
import torch

from .._device import check_cuda, cuda_stream, dispatch, kernel_library, \
    launch
from .image import correlate2d_reflect, pad_axis, separable_correlate

# cv2.GaussianBlur((5, 5), sigma=0)'s binomial taps, and the stencils and
# average of the JAX module (numpy float32, the JAX module's constants)
K5 = np.asarray([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0
X_KERNEL = np.asarray([[1.0, -1.0], [1.0, -1.0]], np.float32) * 0.25
Y_KERNEL = np.asarray([[1.0, 1.0], [-1.0, -1.0]], np.float32) * 0.25
T_KERNEL = np.ones((2, 2), np.float32) * 0.25
AVG_KERNEL = np.asarray([[1.0, 2.0, 1.0], [2.0, 0.0, 2.0],
                         [1.0, 2.0, 1.0]], np.float32) / 12.0
# the average's nonzero taps (row offset, column offset, weight) in the
# kernel's order of addition (csrc/horn_schunck.cu)
AVG_TAPS = tuple((dy, dx, float(AVG_KERNEL[dy + 1, dx + 1]))
                 for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                 if AVG_KERNEL[dy + 1, dx + 1] != 0)
CONTROL_WORDS = 4


def _alpha2(alpha: float) -> float:
    """``alpha ** 2`` as the JAX function adds it to a float32 plane."""
    return float(np.float32(alpha ** 2))


def fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c`` of float32 operands rounded to float32 once, as a fused
    multiply-add rounds it. The product of two float32 values is exact in
    float64; the float64 sum is rounded to odd (a sum that is not exact
    keeps its last bit set: TwoSum gives its error), which makes the
    rounding to float32 that follows the correctly rounded result."""
    p = a.double() * b.double()
    c = torch.as_tensor(c, dtype=torch.float64, device=p.device)
    s = p + c
    shared = s - p
    err = (p - (s - shared)) + (c - shared)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


# ---------------------------------------------------------------------------
# B9: pre-blur and derivatives
# ---------------------------------------------------------------------------

def _blur5(image: torch.Tensor) -> torch.Tensor:
    tmp = separable_correlate(image, K5, axis=0, mode="reflect")
    return separable_correlate(tmp, K5, axis=1, mode="reflect")


def hs_derivatives_plain(prev_gray: torch.Tensor, next_gray: torch.Tensor,
                         alpha: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two (H, W) uint8 frames -> the (4, H, W) float32 planes ``[ex, ey,
    et, denom]`` and a zeroed control block.

    Both frames are blurred with the binomial 5-tap kernel (reflect-101
    padding), then ``ex``, ``ey`` and ``et`` are the 2x2 stencils of both
    (symmetric padding on the high side) and ``denom = alpha**2 + ex**2 +
    ey**2`` as two fused multiply-adds, ``fma(ey, ey, fma(ex, ex,
    alpha**2))``: XLA's CPU compiler fuses the JAX function's expression
    so, and so does the kernel."""
    a = _blur5(prev_gray.float())
    b = _blur5(next_gray.float())
    ex = correlate2d_reflect(a, X_KERNEL) + correlate2d_reflect(b, X_KERNEL)
    ey = correlate2d_reflect(a, Y_KERNEL) + correlate2d_reflect(b, Y_KERNEL)
    et = correlate2d_reflect(b, T_KERNEL) - correlate2d_reflect(a, T_KERNEL)
    denom = fma_f32(ey, ey, fma_f32(ex, ex, _alpha2(alpha)))
    control = torch.zeros(CONTROL_WORDS, dtype=torch.int32,
                          device=prev_gray.device)
    return torch.stack([ex, ey, et, denom]), control


def _check_frames(name: str, prev_gray: torch.Tensor,
                  next_gray: torch.Tensor) -> None:
    if prev_gray.dim() != 2 or prev_gray.shape != next_gray.shape or \
            prev_gray.dtype != torch.uint8 or next_gray.dtype != torch.uint8:
        raise ValueError(f"{name} needs two (H, W) uint8 frames of one "
                         f"shape, got {tuple(prev_gray.shape)} "
                         f"{prev_gray.dtype} and {tuple(next_gray.shape)} "
                         f"{next_gray.dtype}")


def hs_derivatives_cuda(prev_gray: torch.Tensor, next_gray: torch.Tensor,
                        alpha: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel B9 on two contiguous (H, W) uint8 frames on one CUDA
    device; it also zeroes the control block it returns.
    ``hs_derivatives_cuda.launches`` counts launches."""
    check_cuda("hs_derivatives_cuda", prev_gray, next_gray)
    _check_frames("hs_derivatives_cuda", prev_gray, next_gray)
    h, w = prev_gray.shape
    planes = torch.empty((4, h, w), dtype=torch.float32,
                         device=prev_gray.device)
    control = torch.empty(CONTROL_WORDS, dtype=torch.int32,
                          device=prev_gray.device)
    launch(prev_gray.device, "transflow_hs_derivatives",
           prev_gray.data_ptr(), next_gray.data_ptr(), planes.data_ptr(),
           control.data_ptr(), h, w, _alpha2(alpha), cuda_stream(prev_gray))
    hs_derivatives_cuda.launches += 1
    return planes, control


hs_derivatives_cuda.launches = 0


def hs_derivatives(prev_gray: torch.Tensor, next_gray: torch.Tensor,
                   alpha: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Dispatcher of B9 by the frames' device."""
    fn = dispatch("hs_derivatives", hs_derivatives_plain,
                  hs_derivatives_cuda, prev_gray, next_gray)
    return fn(prev_gray, next_gray, alpha)


# ---------------------------------------------------------------------------
# B10: one Jacobi step and the early stop
# ---------------------------------------------------------------------------

def _average(x: torch.Tensor) -> torch.Tensor:
    """The 3x3 ``AVG_KERNEL`` average of an (H, W) plane with symmetric
    padding: the eight nonzero taps in ``AVG_TAPS`` order, each product
    and sum rounded to float32."""
    h, w = x.shape
    padded = pad_axis(pad_axis(x, 0, 1, 1, "symmetric"), 1, 1, 1,
                      "symmetric")
    acc = None
    for dy, dx, weight in AVG_TAPS:
        term = padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] * weight
        acc = term if acc is None else acc + term
    return acc


def _delta_f32(delta: float | None) -> float | None:
    """``delta`` as the JAX function compares a float32 norm with it."""
    return None if delta is None else float(np.float32(delta))


def hs_iterate_plain(planes: torch.Tensor, flow: torch.Tensor,
                     control: torch.Tensor,
                     delta: float | None) -> torch.Tensor:
    """One step of the JAX loop's body on the (4, H, W) planes and the
    (H, W, 2) flow; returns the new flow and updates ``control`` in place.

    With the stop word set the flow is returned as it is (a copy).
    Otherwise ``c = (ex * u_avg + ey * v_avg + et) / denom``, ``u = u_avg -
    ex * c`` and ``v = v_avg - ey * c``; the iteration count rises by one,
    and the stop word is set where ``delta`` is not None and
    ``sqrt(sum((new_u - u) ** 2)) < delta`` (float32 squares summed in
    float64)."""
    if int(control[0]):
        return flow.clone()
    ex, ey, et, denom = planes.unbind(0)
    u, v = flow[..., 0], flow[..., 1]
    u_avg = _average(u)
    v_avg = _average(v)
    c = (ex * u_avg + ey * v_avg + et) / denom
    new_u = u_avg - ex * c
    new_v = v_avg - ey * c
    control[1] += 1
    limit = _delta_f32(delta)
    if limit is not None:
        step = new_u - u
        norm = math.sqrt(float((step * step).double().sum()))
        if norm < limit:
            control[0] = 1
    return torch.stack([new_u, new_v], dim=-1)


def iterate_partials(h: int, w: int) -> int:
    """The float64 partial sums B10 needs at (h, w), one a block: the
    kernel's own count (``transflow_hs_iterate_partials``), so the scratch
    follows its tiling."""
    return kernel_library().query("transflow_hs_iterate_partials", h, w)


def hs_iterate_cuda(planes: torch.Tensor, flow: torch.Tensor,
                    control: torch.Tensor,
                    delta: float | None) -> torch.Tensor:
    """Launch kernel B10 on contiguous (4, H, W) float32 planes, an (H, W,
    2) float32 flow and B9's control block on one CUDA device; returns the
    new flow. ``hs_iterate_cuda.launches`` counts launches."""
    check_cuda("hs_iterate_cuda", planes, flow, control)
    h, w = flow.shape[:2]
    if tuple(planes.shape) != (4, h, w) or planes.dtype != torch.float32:
        raise ValueError("hs_iterate_cuda needs (4, H, W) float32 planes, "
                         f"got {tuple(planes.shape)} {planes.dtype}")
    if tuple(flow.shape) != (h, w, 2) or flow.dtype != torch.float32:
        raise ValueError(f"hs_iterate_cuda needs an (H, W, 2) float32 flow, "
                         f"got {tuple(flow.shape)} {flow.dtype}")
    if tuple(control.shape) != (CONTROL_WORDS,) or \
            control.dtype != torch.int32:
        raise ValueError("hs_iterate_cuda needs B9's int32 control block")
    partials = torch.empty(iterate_partials(h, w), dtype=torch.float64,
                           device=flow.device)
    out = torch.empty_like(flow)
    limit = _delta_f32(delta)
    launch(flow.device, "transflow_hs_iterate", planes.data_ptr(),
           flow.data_ptr(), out.data_ptr(), control.data_ptr(),
           partials.data_ptr(), partials.numel(), h, w,
           0.0 if limit is None else limit, int(limit is not None),
           cuda_stream(flow))
    hs_iterate_cuda.launches += 1
    return out


hs_iterate_cuda.launches = 0


def hs_iterate(planes: torch.Tensor, flow: torch.Tensor,
               control: torch.Tensor, delta: float | None) -> torch.Tensor:
    """Dispatcher of B10 by the tensors' device."""
    fn = dispatch("hs_iterate", hs_iterate_plain, hs_iterate_cuda, planes,
                  flow, control)
    return fn(planes, flow, control, delta)

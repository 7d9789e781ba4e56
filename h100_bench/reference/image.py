"""Image primitives of the reference: padding, ordered 1-D correlations,
JAX's linear resize bands, bilinear sampling and resizing, and the
clip of a flow to its frame.

Every sum is added in a fixed order, each product and sum rounded to
float32, so a result does not depend on a library's choice of algorithm.
"""
import functools

import numpy as np
import torch
import torch.nn.functional as F


def pad_axis(x: torch.Tensor, dim: int, lo: int, hi: int,
             mode: str) -> torch.Tensor:
    """``x`` padded along ``dim``: ``"symmetric"`` repeats the edge sample
    (numpy's mode of that name), ``"constant"`` pads with zeros."""
    n = x.shape[dim]
    if mode == "symmetric":
        idx = torch.arange(-lo, n + hi, device=x.device).remainder(2 * n)
        idx = torch.where(idx < n, idx, 2 * n - 1 - idx)
        return x.index_select(dim, idx)
    if mode == "constant":
        shape = list(x.shape)
        shape[dim] = lo
        head = x.new_zeros(shape)
        shape[dim] = hi
        return torch.cat([head, x, x.new_zeros(shape)], dim)
    raise ValueError(f"unknown pad mode {mode!r}")


def rounded_taps(taps, dtype: torch.dtype) -> list[float]:
    """Float32 taps rounded to ``dtype``, as Python floats."""
    t = torch.as_tensor(np.asarray(taps, np.float32))
    return t.to(dtype).float().tolist()


def ordered_correlate(x: torch.Tensor, taps, dim: int,
                      mode: str) -> torch.Tensor:
    """1-D correlation of float32 ``x`` along ``dim`` with ``taps``
    (floats), padded by ``mode``, the products added in tap order."""
    n = x.shape[dim]
    lo = (len(taps) - 1) // 2
    padded = pad_axis(x, dim, lo, len(taps) - 1 - lo, mode)
    acc = padded.narrow(dim, 0, n) * taps[0]
    for k in range(1, len(taps)):
        acc = acc + padded.narrow(dim, k, n) * taps[k]
    return acc


def gaussian_kernel_1d(sigma: float, radius: int) -> torch.Tensor:
    """Normalised float32 Gaussian taps on ``[-radius, radius]``."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


@functools.lru_cache(maxsize=None)
def resize_weights(in_size: int, out_size: int
                   ) -> tuple[np.ndarray, np.ndarray]:
    """``jax.image.resize(..., "linear")`` of ``in_size`` samples to
    ``out_size`` as bands: (starts (out,), float32 weights (out, K)).

    The triangle kernel, widened by the factor on a downscale
    (anti-aliased), each output's weights divided by their sum (added in
    ascending order), zero where the sum is below ``1000 * eps`` or the
    sample lies outside ``[-0.5, in - 0.5]``; the band of K weights holds
    every nonzero one and lies inside the input."""
    f32, f64 = np.float32, np.float64
    inv_scale = 1.0 / (out_size / in_size)
    recip = f64(f32(1) / f32(max(inv_scale, 1.0)))
    half = np.arange(out_size, dtype=f32) + f32(0.5)
    sample = half * f32(inv_scale) - f32(0.5)
    width = int(np.ceil(max(inv_scale, 1.0))) + 1
    lo = np.floor(sample).astype(np.int64) - width
    cand = lo[:, None] + np.arange(2 * width + 2)[None, :]
    valid = (cand >= 0) & (cand < in_size)
    dist = np.abs(sample[:, None] - cand.astype(f32)).astype(f64)
    w = np.maximum(f32(0), (1.0 - dist * recip).astype(f32))
    w = np.where(valid, w, f32(0)).astype(f32)
    total = np.zeros(out_size, f32)
    for k in range(w.shape[1]):
        total = total + w[:, k]
    keep = np.abs(total) > f32(1000 * np.finfo(np.float32).eps)
    w = np.where(keep[:, None],
                 w / np.where(total != 0, total, f32(1))[:, None],
                 f32(0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[:, None], w, f32(0))
    nonzero = w != 0
    first = np.where(nonzero.any(axis=1), nonzero.argmax(axis=1), 0)
    last = np.where(nonzero.any(axis=1),
                    w.shape[1] - 1 - nonzero[:, ::-1].argmax(axis=1), 0)
    taps = int((last - first).max()) + 1
    starts = np.clip(lo + first, 0, in_size - taps)
    cols = (starts - lo)[:, None] + np.arange(taps)[None, :]
    inner = (cols >= 0) & (cols < w.shape[1])
    weights = np.where(inner, w[np.arange(out_size)[:, None],
                                np.clip(cols, 0, w.shape[1] - 1)], f32(0))
    return starts.astype(np.int64), np.ascontiguousarray(weights, f32)


def resize_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """``x`` resized along ``dim`` by ``resize_weights``' bands, each
    band's products added in order from its first."""
    starts, weights = resize_weights(x.shape[dim], out_size)
    w = torch.from_numpy(weights).to(x.device)
    shape = [1] * x.dim()
    shape[dim] = -1
    acc = None
    for k in range(weights.shape[1]):
        index = torch.from_numpy(starts + k).to(x.device)
        term = x.index_select(dim, index) * w[:, k].reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def resize_flow(flow: torch.Tensor, lh: int, lw: int,
                scale: float) -> torch.Tensor:
    """JAX's linear resize of an (h, w, 2) float32 flow to (lh, lw), along
    H then W (an axis of equal size skipped), times ``scale`` rounded to
    float32."""
    h, w = flow.shape[:2]
    out = flow if lh == h else resize_axis(flow, lh, 0)
    out = out if lw == w else resize_axis(out, lw, 1)
    return out * float(np.float32(scale))


def torch_bilinear_resize(image: torch.Tensor, new_h: int,
                          new_w: int) -> torch.Tensor:
    """Bilinear resize of an (H, W, C) image in float32 with torch's
    semantics (half-pixel centres, edges clamped, no anti-aliasing)."""
    image = image.float()
    if (new_h, new_w) == tuple(image.shape[:2]):
        return image
    out = F.interpolate(image.permute(2, 0, 1)[None], size=(new_h, new_w),
                        mode="bilinear", align_corners=False,
                        antialias=False)[0].permute(1, 2, 0)
    return out.contiguous()


def bilinear_sample_clamped(image: torch.Tensor, yy: torch.Tensor,
                            xx: torch.Tensor) -> torch.Tensor:
    """Sample an (H, W, C) image at float (yy, xx): the anchor ``floor``
    clamped to the frame, the +1 taps replicating the last row and
    column, the weights from the unclamped coordinate; rows' x first."""
    h, w = image.shape[:2]
    right = torch.cat([image[:, 1:], image[:, -1:]], dim=1)
    down = torch.cat([image[1:], image[-1:]], dim=0)
    downright = torch.cat([right[1:], right[-1:]], dim=0)
    packed = torch.cat([image, right, down, downright], dim=-1)
    y0f = torch.floor(yy)
    x0f = torch.floor(xx)
    wy = (yy - y0f)[..., None]
    wx = (xx - x0f)[..., None]
    y0 = y0f.long().clamp(0, h - 1)
    x0 = x0f.long().clamp(0, w - 1)
    v00, v01, v10, v11 = packed[y0, x0].chunk(4, dim=-1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def clip_to_frame(flow: torch.Tensor) -> torch.Tensor:
    """Clamp an (H, W, 2) flow so every target stays inside the frame."""
    h, w = flow.shape[:2]
    ii = torch.arange(h, dtype=torch.float32,
                      device=flow.device)[:, None].expand(h, w)
    jj = torch.arange(w, dtype=torch.float32,
                      device=flow.device)[None, :].expand(h, w)
    fx = torch.clamp(flow[..., 0], -jj, (w - 1) - jj)
    fy = torch.clamp(flow[..., 1], -ii, (h - 1) - ii)
    return torch.stack([fx, fy], dim=-1)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (saturating at +-448, as a kernel that
    stores fp8 with ``satfinite`` does), back in ``x``'s dtype."""
    return x.float().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)

"""Device-side image primitives of the port.

Counterpart of transflow_tpu/ops/image.py: the separable correlations and
blurs (and their reflect-101 mode, Horn-Schunck's pre-blur), the 2-D
correlation of Horn-Schunck's stencils, the pyramid reduce of
Lucas-Kanade (kernel B14 on the card, ``ops/pyramid.py``; Farneback's
pyramid levels are kernel B8 there), the anti-aliased resize that
``jax.image.resize(..., "linear")`` is, bilinear resize with torch's own
semantics (LiteFlowNet), the integer-factor flow upscale, the
clamped-anchor bilinear sampler, and the luma of the realtime tool. Every function keeps the JAX function's
name and its (H, W[, C]) layout.
"""
import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32_convolutions(device: torch.device):
    """cuDNN without TF32 while the block runs on a CUDA ``device``.

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits); the JAX package's convolutions here are full float32, so the
    port turns TF32 off for its own and restores the caller's setting."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def pad_axis(x: torch.Tensor, dim: int, lo: int, hi: int,
             mode: str) -> torch.Tensor:
    """``x`` padded by ``lo`` and ``hi`` samples along ``dim``.

    ``"symmetric"`` is numpy's mode of that name: the edge sample repeats
    (``[2, 1, 0 | 0, 1, 2 | 2, 1]``), any pad width; ``F.pad`` has no such
    mode, so the pad is an index. ``"reflect"`` is numpy's (and
    ``jnp.pad``'s) mode of that name, reflect-101: the edge sample does
    not repeat (``[2, 1 | 0, 1, 2 | 1, 0]``), any pad width.
    ``"constant"`` pads with zeros."""
    n = x.shape[dim]
    if mode == "symmetric":
        idx = torch.arange(-lo, n + hi, device=x.device).remainder(2 * n)
        idx = torch.where(idx < n, idx, 2 * n - 1 - idx)
        return x.index_select(dim, idx)
    if mode == "reflect":
        if n == 1:
            idx = torch.zeros(lo + 1 + hi, dtype=torch.long, device=x.device)
        else:
            period = 2 * (n - 1)
            idx = torch.arange(-lo, n + hi, device=x.device).remainder(period)
            idx = torch.where(idx < n, idx, period - idx)
        return x.index_select(dim, idx)
    if mode == "constant":
        shape = list(x.shape)
        shape[dim] = lo
        head = x.new_zeros(shape)
        shape[dim] = hi
        return torch.cat([head, x, x.new_zeros(shape)], dim)
    raise ValueError(f"unknown pad mode {mode!r}")


def rounded_taps(kernel_1d, dtype: torch.dtype) -> torch.Tensor:
    """The float32 taps of ``kernel_1d`` rounded to ``dtype``, as float32:
    the JAX package casts a correlation's taps to the image's dtype."""
    if isinstance(kernel_1d, torch.Tensor):
        taps = kernel_1d.detach().cpu().float()
    else:
        taps = torch.from_numpy(np.array(kernel_1d, np.float32))
    return taps.to(dtype).float()


def ordered_correlate(x: torch.Tensor, taps, dim: int,
                      mode: str) -> torch.Tensor:
    """1-D correlation of float32 ``x`` along ``dim`` with the float32
    ``taps`` (a list), padded by ``mode`` (``pad_axis``): products added in
    tap order, each rounded to float32. The port's kernels add their sums
    in this order, so a kernel and a plain version written with this
    agree bit for bit; ``F.conv2d`` leaves the order to the library."""
    n = x.shape[dim]
    lo = (len(taps) - 1) // 2
    padded = pad_axis(x, dim, lo, len(taps) - 1 - lo, mode)
    acc = padded.narrow(dim, 0, n) * taps[0]
    for k in range(1, len(taps)):
        acc = acc + padded.narrow(dim, k, n) * taps[k]
    return acc


@functools.lru_cache(maxsize=None)
def _taps_on(taps: tuple, device: torch.device) -> torch.Tensor:
    """``taps`` as a float32 tensor on ``device``, copied there once: a copy
    from host memory on every call would make the host wait for the card."""
    return torch.tensor(taps, dtype=torch.float32, device=device)


def separable_correlate(image: torch.Tensor, kernel_1d, axis: int,
                        mode: str = "symmetric") -> torch.Tensor:
    """1-D cross-correlation along ``axis`` of a 2-D image with edge padding.

    A bf16 image correlates with taps rounded to bf16; every other dtype
    with float32 taps. The products of bf16 values are exact in float32, so
    the plain version upcasts the rounded operands and taps and convolves
    in float32 (``F.conv2d`` on bf16 would return bf16). Output is float32.
    On the card cuDNN runs with TF32 off (``exact_f32_convolutions``)."""
    dt = torch.bfloat16 if image.dtype == torch.bfloat16 else torch.float32
    taps = _taps_on(tuple(rounded_taps(kernel_1d, dt).tolist()),
                    image.device)
    n = taps.shape[0]
    lo = (n - 1) // 2
    padded = pad_axis(image.to(dt).float(), axis, lo, n - 1 - lo, mode)
    weight = taps.reshape((1, 1, n, 1) if axis == 0 else (1, 1, 1, n))
    with exact_f32_convolutions(image.device):
        return F.conv2d(padded[None, None], weight)[0, 0]


def box_filter(image: torch.Tensor, size: int) -> torch.Tensor:
    """Separable (size x size) box sum with zero padding (not normalised).

    A bf16 image keeps bf16 between the two passes (each pass accumulates
    float32); output is float32."""
    ones = np.ones((size,), np.float32)
    tmp = separable_correlate(image, ones, axis=0, mode="constant")
    if image.dtype == torch.bfloat16:
        tmp = tmp.to(torch.bfloat16)
    return separable_correlate(tmp, ones, axis=1, mode="constant")


def correlate2d_reflect(image: torch.Tensor, kernel) -> torch.Tensor:
    """'same' 2-D cross-correlation of an (H, W) image with numpy's
    symmetric padding (the edge repeats), in float32:
    ``scipy.ndimage.convolve(image, kernel, mode="reflect")``. The kernel
    (as the caller holds it, float32) is flipped here, and an even size
    puts its extra tap on the high side, as ndimage's origin 0 does. The
    sum is ``F.conv2d``'s, with TF32 off on the card."""
    flipped = np.array(kernel, np.float32)[::-1, ::-1]
    kh, kw = flipped.shape
    k = _taps_on(tuple(flipped.ravel().tolist()), image.device)
    padded = pad_axis(image.float(), 0, (kh - 1) // 2, kh // 2, "symmetric")
    padded = pad_axis(padded, 1, (kw - 1) // 2, kw // 2, "symmetric")
    with exact_f32_convolutions(image.device):
        return F.conv2d(padded[None, None], k.reshape(1, 1, kh, kw))[0, 0]


def downsample2x(image: torch.Tensor) -> torch.Tensor:
    """The classic pyramid reduce: the 5-tap binomial blur ``[1, 4, 6, 4,
    1] / 16`` along each axis with symmetric padding, then every second
    row and column from the first (``[::2, ::2]``: an odd size rounds
    up), in float32. Float32 (H', W'), contiguous: kernel B14 on the card
    (``ops/pyramid.py::downsample2x``), its plain version on the CPU."""
    # imported here: ops/pyramid.py imports this module
    from .pyramid import downsample2x as reduce
    return reduce((image.float().contiguous(),))[0]


def gaussian_kernel_1d(sigma: float, radius: int) -> torch.Tensor:
    """Normalised float32 Gaussian taps on ``[-radius, radius]`` (CPU)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(image: torch.Tensor, sigma: float,
                  radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur with symmetric padding; the radius defaults
    to ``int(3 * sigma + 0.5)``. The float32 result of the first pass is
    not rounded before the second."""
    if radius is None:
        radius = int(3.0 * sigma + 0.5)
    k = gaussian_kernel_1d(sigma, radius)
    tmp = separable_correlate(image, k, axis=0)
    return separable_correlate(tmp, k, axis=1)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 RGB -> (...) uint8 BT.601 luma: ``0.299 R + 0.587 G
    + 0.114 B`` in float32, rounded half to even."""
    rgb = rgb.to(torch.float32)
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return torch.round(gray).to(torch.uint8)


def clip_to_frame(flow: torch.Tensor) -> torch.Tensor:
    """Clamp so every target x+fx stays in [0, W-1] and y+fy in [0, H-1].

    Parity: source.py:250-263,361-362 (fx_min/fx_max/fy_min/fy_max tables)."""
    h, w = flow.shape[:2]
    ii = torch.arange(h, dtype=torch.float32,
                      device=flow.device)[:, None].expand(h, w)
    jj = torch.arange(w, dtype=torch.float32,
                      device=flow.device)[None, :].expand(h, w)
    fx = torch.clamp(flow[..., 0], -jj, (w - 1) - jj)
    fy = torch.clamp(flow[..., 1], -ii, (h - 1) - ii)
    return torch.stack([fx, fy], dim=-1)


def conv2d_same(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'same' 2-D convolution of (..., H, W) planes with zero fill:
    scipy.signal.convolve2d(image, kernel, mode="same", boundary="fill"),
    a true convolution (kernel flipped) with the extra tap on the low side
    for even sizes. ``kernel`` is a float32 (kh, kw) tensor on the image's
    device. The JAX function leaves the convolution to XLA; here it is
    ``F.conv2d`` in full float32 (``exact_f32_convolutions``), whose order
    of additions is the library's."""
    lead = image.shape[:-2]
    h, w = image.shape[-2:]
    x = image.float().reshape(-1, 1, h, w)
    kh, kw = kernel.shape
    pad_top, pad_left = (kh - 1) // 2, (kw - 1) // 2
    x = F.pad(x, (pad_left, kw - 1 - pad_left, pad_top, kh - 1 - pad_top))
    with exact_f32_convolutions(image.device):
        out = F.conv2d(x, kernel.flip(0, 1)[None, None])
    return out.reshape(*lead, h, w)


def upscale_flow(flow: torch.Tensor, width_factor: int,
                 height_factor: int) -> torch.Tensor:
    """Integer-factor kron upscale that also scales vector magnitudes.

    Parity reference: transflow/utils.py:417-418 (upscale_array)."""
    scaled = flow * torch.tensor([width_factor, height_factor],
                                 dtype=flow.dtype, device=flow.device)
    out = scaled.repeat_interleave(height_factor, dim=0)
    return out.repeat_interleave(width_factor, dim=1)


def _resize(image: torch.Tensor, new_h: int, new_w: int,
            antialias: bool) -> torch.Tensor:
    """``F.interpolate`` (bilinear, half-pixel centres) of an (H, W) or
    (H, W, C) image in float32."""
    squeeze = image.dim() == 2
    if squeeze:
        image = image[..., None]
    image = image.float()
    if (new_h, new_w) == tuple(image.shape[:2]):
        out = image
    else:
        out = F.interpolate(image.permute(2, 0, 1)[None], size=(new_h, new_w),
                            mode="bilinear", align_corners=False,
                            antialias=antialias)[0].permute(1, 2, 0)
        out = out.contiguous()
    return out[..., 0] if squeeze else out


def bilinear_resize(image: torch.Tensor, new_h: int,
                    new_w: int) -> torch.Tensor:
    """``jax.image.resize(image, ..., "linear")`` (or ``"bilinear"``, the
    same method) of an (H, W) or (H, W, C) image, in float32.

    JAX's linear resize scales its triangle kernel with the factor on a
    downscale, i.e. anti-aliases: ``F.interpolate(antialias=True)`` is the
    same filter (within 4.6e-5 on [0, 255] images at the pyramid's shapes).
    On an upscale both are plain bilinear; there ``antialias=False`` is
    used, whose weights land within 2e-6 of JAX's where the factor is not
    whole (68 -> 135), where the anti-aliasing path's are 6e-5 away
    (tests/test_torch_farneback.py)."""
    h, w = image.shape[:2]
    return _resize(image, new_h, new_w, antialias=new_h < h or new_w < w)


def torch_bilinear_resize(image: torch.Tensor, new_h: int,
                          new_w: int) -> torch.Tensor:
    """Bilinear resize of an (H, W) or (H, W, C) image, computed in f32.

    ``F.interpolate(mode='bilinear', align_corners=False, antialias=False)``
    is exactly what the JAX function of this name emulates: four neighbours
    at half-pixel centres, edges clamped, no anti-aliasing on downscale."""
    return _resize(image, new_h, new_w, antialias=False)


def prepack_bilinear_taps(image: torch.Tensor) -> torch.Tensor:
    """(H, W[, C]) -> (H, W, 4C) tap pack for ``bilinear_sample_packed``:
    the image and its edge-replicated right, down and down-right shifts."""
    if image.dim() == 2:
        image = image[..., None]
    right = torch.cat([image[:, 1:], image[:, -1:]], dim=1)
    down = torch.cat([image[1:], image[-1:]], dim=0)
    downright = torch.cat([right[1:], right[-1:]], dim=0)
    return torch.cat([image, right, down, downright], dim=-1)


def bilinear_sample_packed(packed: torch.Tensor, yy: torch.Tensor,
                           xx: torch.Tensor) -> torch.Tensor:
    """Sample a ``prepack_bilinear_taps`` pack at float (yy, xx); returns
    (H, W, C) float32.

    The anchor ``floor`` is clamped to the frame, the weight is not: it
    is ``y - floor(y)`` of the unclamped coordinate (neither
    ``grid_sample``'s border nor its zeros mode). The lerps run in the JAX
    function's order, rows' x first."""
    h, w = packed.shape[:2]
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


def bilinear_sample(image: torch.Tensor, yy: torch.Tensor,
                    xx: torch.Tensor) -> torch.Tensor:
    """Sample image (H, W[, C]) at float coordinates (yy, xx), clamped
    anchors: the pack and one sample."""
    out = bilinear_sample_packed(prepack_bilinear_taps(image), yy, xx)
    return out[..., 0] if image.dim() == 2 else out

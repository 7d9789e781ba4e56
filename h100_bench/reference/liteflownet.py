"""LiteFlowNet (Hui, Tang, Loy, CVPR 2018), sniklaus/pytorch-liteflownet's
``default`` network, in plain PyTorch: the reference of the
``liteflownet`` estimator.

The module tree and parameter names are the port's (``features.one0``,
``matching2.main0``, ...), so one state dict loads into both. Activations
are (H, W, C) or (N, H, W, C); a convolution views them as NCHW in
channels_last memory. Every operation is a plain one: the 7x7 correlation
as 49 shifted products with a channel mean, the backwarp as one gather of
four taps, the 2x upsampler as four shifted products a phase, and the
regularization's softmax tap apply tap by tap.

Precision: the configuration states the dtype the convolutions compute in
(``conv``; bfloat16 on the card); parameters are float32, the bias is
added in the convolution's dtype, and the correlation, the warps and the
tap apply compute in float32 after JAX's dtype promotion. For the control
each convolution's input and weight are first rounded to float8 e4m3; the
check also runs every convolution in float32 (TF32 off), the gap that the
stated dtype opens.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .image import fp8_round, torch_bilinear_resize

_LEVELS = (2, 3, 4, 5, 6)
_FLT_BACKWARP = {2: 10.0, 3: 5.0, 4: 2.5, 5: 1.25, 6: 0.625}
_KERNEL = {2: 7, 3: 5, 4: 5, 5: 3, 6: 3}
_PAD = {2: 3, 3: 2, 4: 2, 5: 1, 6: 1}
_DIST_CH = {2: 49, 3: 25, 4: 25, 5: 9, 6: 9}
_FEAT_CH = {2: 32, 3: 64, 4: 96, 5: 128, 6: 192}
_MEAN_ONE = (0.411618, 0.434631, 0.454253)
_MEAN_TWO = (0.410782, 0.433645, 0.452793)


def leaky(x: torch.Tensor) -> torch.Tensor:
    """``leaky_relu(x, 0.1)`` with the slope rounded to x's dtype."""
    slope = torch.tensor(0.1, dtype=x.dtype).item()
    return F.leaky_relu(x, slope)


class _Conv(nn.Module):
    """A convolution on (N, H, W, C) or (H, W, C) activations: computed in
    the given dtype without its bias, then the bias rounded to that dtype
    added, then optionally the leaky ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, pad=None):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        if pad is None:
            pad = kh // 2
        self.padding = (pad, pad) if isinstance(pad, int) else tuple(pad)
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x, mode, leaky_relu=False):
        dtype, quant = mode
        batched = x.dim() == 4
        x = x if batched else x[None]
        y = F.conv2d(quant(x.to(dtype)).permute(0, 3, 1, 2),
                     quant(self.weight.to(dtype)), None, self.stride,
                     self.padding)
        y = y.permute(0, 2, 3, 1) + self.bias.to(y.dtype)
        y = leaky(y) if leaky_relu else y
        return y if batched else y[0]


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                stride: int) -> torch.Tensor:
    """out[y, x, (dy+3)*7+(dx+3)] = mean_c f1[ys, xs, c] f2[ys + dy s,
    xs + dx s, c] in float32 (bf16 operands read as they are, anything
    else as float32), zero outside the frame."""
    h, w, _ = f1.shape
    pad = 3 * stride
    f1s = f1[::stride, ::stride].float()
    f2p = F.pad(f2.float(), (0, 0, pad, pad, pad, pad))
    outs = []
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            y0, x0 = pad + dy * stride, pad + dx * stride
            shifted = f2p[y0:y0 + h:stride, x0:x0 + w:stride]
            outs.append((f1s * shifted).mean(dim=-1))
    return torch.stack(outs, dim=-1)


def backwarp(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear ``image[(i, j) + flow]`` with zero padding, in float32:
    the four taps read at the anchor clamped to [-1, size] (a +1 tap of a
    negative anchor falls back to the anchor), each weighted by its
    in-frame test."""
    h, w, c = image.shape
    zrow = image.new_zeros((1, w, c))
    zcol = image.new_zeros((h, 1, c))
    right = torch.cat([image[:, 1:], zcol], dim=1)
    down = torch.cat([image[1:], zrow], dim=0)
    downright = torch.cat([right[1:], zrow], dim=0)
    v4 = torch.cat([image, right, down, downright], dim=-1)
    yy = torch.arange(h, dtype=torch.float32, device=image.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=image.device)[None, :]
    sx = xx + flow[..., 0]
    sy = yy + flow[..., 1]
    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    wx = (sx - x0f)[..., None]
    wy = (sy - y0f)[..., None]
    x0 = x0f.clamp(-1, w).long()
    y0 = y0f.clamp(-1, h).long()
    g = v4[y0.clamp(0, h - 1), x0.clamp(0, w - 1)]
    t00, t01, t10, t11 = g.split(c, dim=-1)
    mx = (x0 < 0)[..., None]
    my = (y0 < 0)[..., None]
    t01e = torch.where(mx, t00, t01)
    t10e = torch.where(my, t00, t10)
    t11e = torch.where(mx & my, t00,
                       torch.where(mx, t10, torch.where(my, t01, t11)))

    def inb(xi, yi):
        return (((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1))
                .float()[..., None])

    return (t00 * (1 - wx) * (1 - wy) * inb(x0f, y0f)
            + t01e * wx * (1 - wy) * inb(x0f + 1, y0f)
            + t10e * (1 - wx) * wy * inb(x0f, y0f + 1)
            + t11e * wx * wy * inb(x0f + 1, y0f + 1))


def upsample2x(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose2d(k=4, s=2, p=1, groups=C)`` of (h, w, C) with (C,
    1, 4, 4) taps, phase by phase: four shifted products a phase, summed
    in float32; the output keeps x's dtype (bf16 or float32)."""
    h, w, c = x.shape
    out_dtype = x.dtype if x.dtype in (torch.bfloat16, torch.float32) \
        else torch.float32
    x = x.to(out_dtype)
    rhs = weight[:, 0].permute(1, 2, 0).flip(0, 1).float()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    rows = []
    for r in (0, 1):
        cols = []
        for s in (0, 1):
            acc = None
            for ki, di in ((r, r - 1), (r + 2, r)):
                for kj, dj in ((s, s - 1), (s + 2, s)):
                    term = rhs[ki, kj] * xp[di + 1:di + 1 + h,
                                            dj + 1:dj + 1 + w]
                    acc = term if acc is None else acc + term
            cols.append(acc)
        rows.append(torch.stack(cols, dim=2))
    out = torch.stack(rows, dim=1)
    return out.reshape(2 * h, 2 * w, c).to(out_dtype)


def reg_apply(dist, flow, wx, bx, wy, by) -> torch.Tensor:
    """The regularization's softmax over ``-dist^2`` (its sum taken tap by
    tap) applied to each flow component's S x S neighbourhood, times the
    1x1 scale convolutions' taps, plus their biases; float32."""
    taps = dist.shape[-1]
    size = math.isqrt(taps)
    h, w = flow.shape[0], flow.shape[1]
    dist = -torch.square(dist.float())
    dist = torch.exp(dist - dist.amax(dim=-1, keepdim=True))
    total = dist[..., 0]
    for k in range(1, taps):
        total = total + dist[..., k]
    divisor = (1.0 / total)[..., None]
    wx, wy = wx.reshape(-1), wy.reshape(-1)
    bx, by = bx.reshape(()), by.reshape(())
    pad = (size - 1) // 2
    px = F.pad(flow[..., 0], (pad, pad, pad, pad))
    py = F.pad(flow[..., 1], (pad, pad, pad, pad))
    acc_x = torch.zeros((h, w), dtype=torch.float32, device=flow.device)
    acc_y = torch.zeros_like(acc_x)
    k = 0
    for dy in range(size):
        for dx in range(size):
            d = dist[..., k]
            acc_x = acc_x + (wx[k] * d) * px[dy:dy + h, dx:dx + w]
            acc_y = acc_y + (wy[k] * d) * py[dy:dy + h, dx:dx + w]
            k += 1
    return torch.cat([((acc_x + bx)[..., None]) * divisor,
                      ((acc_y + by)[..., None]) * divisor], dim=-1)


def _bilinear_taps(channels: int) -> torch.Tensor:
    taps = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 16.0
    return torch.from_numpy(taps).expand(channels, 1, 4, 4).clone()


class Features(nn.Module):
    def __init__(self):
        super().__init__()
        self.one0 = _Conv(3, 32, 7)
        self.two0 = _Conv(32, 32, 3, 2)
        self.two1 = _Conv(32, 32, 3)
        self.two2 = _Conv(32, 32, 3)
        self.thr0 = _Conv(32, 64, 3, 2)
        self.thr1 = _Conv(64, 64, 3)
        self.fou0 = _Conv(64, 96, 3, 2)
        self.fou1 = _Conv(96, 96, 3)
        self.fiv0 = _Conv(96, 128, 3, 2)
        self.six0 = _Conv(128, 192, 3, 2)

    def forward(self, x, mode):
        one = self.one0(x, mode, True)
        two = self.two2(self.two1(self.two0(one, mode, True), mode, True),
                        mode, True)
        thr = self.thr1(self.thr0(two, mode, True), mode, True)
        fou = self.fou1(self.fou0(thr, mode, True), mode, True)
        fiv = self.fiv0(fou, mode, True)
        six = self.six0(fiv, mode, True)
        return [one, two, thr, fou, fiv, six]


class Matching(nn.Module):
    def __init__(self, level):
        super().__init__()
        self.level = level
        if level == 2:
            self.feat0 = _Conv(32, 64, 1, pad=0)
        if level != 6:
            self.upflow_kernel = nn.Parameter(_bilinear_taps(2))
        if level < 4:
            self.upcorr_kernel = nn.Parameter(_bilinear_taps(49))
        self.main0 = _Conv(49, 128, 3)
        self.main1 = _Conv(128, 64, 3)
        self.main2 = _Conv(64, 32, 3)
        self.main3 = _Conv(32, 2, _KERNEL[level], pad=_PAD[level])

    def forward(self, feat1, feat2, flow, mode):
        lvl = self.level
        if lvl == 2:
            both = self.feat0(torch.stack([feat1, feat2]), mode, True)
            feat1, feat2 = both[0], both[1]
        if flow is not None:
            flow = upsample2x(flow, self.upflow_kernel)
            feat2 = backwarp(feat2, flow * _FLT_BACKWARP[lvl])
        corr = leaky(correlation(feat1, feat2, 1 if lvl >= 4 else 2))
        if lvl < 4:
            corr = upsample2x(corr, self.upcorr_kernel)
        x = self.main0(corr, mode, True)
        x = self.main1(x, mode, True)
        x = self.main2(x, mode, True)
        delta = self.main3(x, mode)
        return delta if flow is None else flow + delta


class Subpixel(nn.Module):
    def __init__(self, level):
        super().__init__()
        self.level = level
        feat = 64 if level == 2 else _FEAT_CH[level]
        if level == 2:
            self.feat0 = _Conv(32, 64, 1, pad=0)
        self.main0 = _Conv(2 * feat + 2, 128, 3)
        self.main1 = _Conv(128, 64, 3)
        self.main2 = _Conv(64, 32, 3)
        self.main3 = _Conv(32, 2, _KERNEL[level], pad=_PAD[level])

    def forward(self, feat1, feat2, flow, mode):
        lvl = self.level
        if lvl == 2:
            both = self.feat0(torch.stack([feat1, feat2]), mode, True)
            feat1, feat2 = both[0], both[1]
        warped = backwarp(feat2, flow * _FLT_BACKWARP[lvl])
        x = torch.cat([feat1, warped, flow], dim=-1)
        x = self.main0(x, mode, True)
        x = self.main1(x, mode, True)
        x = self.main2(x, mode, True)
        return flow + self.main3(x, mode)


class Regularization(nn.Module):
    def __init__(self, level):
        super().__init__()
        self.level = level
        size, pad, dch = _KERNEL[level], _PAD[level], _DIST_CH[level]
        if level < 5:
            self.feat0 = _Conv(_FEAT_CH[level], 128, 1, pad=0)
        self.main0 = _Conv(131 if level < 6 else 195, 128, 3)
        self.main1 = _Conv(128, 128, 3)
        self.main2 = _Conv(128, 64, 3)
        self.main3 = _Conv(64, 64, 3)
        self.main4 = _Conv(64, 32, 3)
        self.main5 = _Conv(32, 32, 3)
        if level >= 5:
            self.dist0 = _Conv(32, dch, size, pad=pad)
        else:
            self.dist0 = _Conv(32, dch, (size, 1), pad=(pad, 0))
            self.dist1 = _Conv(dch, dch, (1, size), pad=(0, pad))
        self.scalex = _Conv(size * size, 1, 1, pad=0)
        self.scaley = _Conv(size * size, 1, 1, pad=0)

    def forward(self, img1, img2, feat1, flow, mode):
        lvl = self.level
        difference = torch.sqrt(torch.sum(torch.square(
            img1 - backwarp(img2, flow * _FLT_BACKWARP[lvl])), dim=-1,
            keepdim=True))
        if lvl < 5:
            feat1 = self.feat0(feat1, mode, True)
        x = torch.cat([difference,
                       flow - flow.mean(dim=(0, 1), keepdim=True), feat1],
                      dim=-1)
        for conv in (self.main0, self.main1, self.main2, self.main3,
                     self.main4, self.main5):
            x = conv(x, mode, True)
        dist = self.dist0(x, mode)
        if lvl < 5:
            dist = self.dist1(dist, mode)
        return reg_apply(dist, flow, self.scalex.weight, self.scalex.bias,
                         self.scaley.weight, self.scaley.bias)


class LiteFlowNet(nn.Module):
    """``forward(img1, img2, mode)``: two (H, W, 3) float32 images in
    [0, 1], H and W multiples of 32 -> the (H/2, W/2, 2) float32 flow;
    ``mode`` is (the convolutions' dtype, the rounding of their
    operands)."""

    def __init__(self):
        super().__init__()
        self.features = Features()
        for lvl in _LEVELS:
            setattr(self, f"matching{lvl}", Matching(lvl))
            setattr(self, f"subpixel{lvl}", Subpixel(lvl))
            setattr(self, f"regularization{lvl}", Regularization(lvl))

    def forward(self, img1, img2, mode):
        img1 = img1 - torch.tensor(_MEAN_ONE, device=img1.device)
        img2 = img2 - torch.tensor(_MEAN_TWO, device=img2.device)
        feats = self.features(torch.stack([img1, img2]), mode)
        feats1 = [f[0] for f in feats]
        feats2 = [f[1] for f in feats]
        pair = [torch.cat([img1, img2], dim=-1)]
        for lvl in range(1, 6):
            shape = feats1[lvl].shape
            pair.append(torch_bilinear_resize(pair[-1], shape[0], shape[1]))
        imgs1 = [p[..., :3] for p in pair]
        imgs2 = [p[..., 3:] for p in pair]
        flow = None
        for idx in (-1, -2, -3, -4, -5):
            lvl = _LEVELS[idx]
            flow = getattr(self, f"matching{lvl}")(feats1[idx], feats2[idx],
                                                   flow, mode)
            flow = getattr(self, f"subpixel{lvl}")(feats1[idx], feats2[idx],
                                                   flow, mode)
            flow = getattr(self, f"regularization{lvl}")(
                imgs1[idx], imgs2[idx], feats1[idx], flow, mode)
        return flow * 20.0


def network(state: dict, device) -> LiteFlowNet:
    """The reference network holding ``state`` (the port's parameter
    names), on ``device``."""
    net = LiteFlowNet()
    net.load_state_dict(state)
    return net.to(device).eval().requires_grad_(False)


def _to_rgb01(image: torch.Tensor) -> torch.Tensor:
    """uint8 (H, W, 3) RGB or (H, W) gray -> float32 BGR in [0, 1]."""
    if image.dim() == 2:
        image = image[..., None].expand(-1, -1, 3)
    return image.flip(-1).float() / 255.0


@torch.no_grad()
def estimate(left: torch.Tensor, right: torch.Tensor, net: LiteFlowNet,
             mode, scale: float = 1.0) -> torch.Tensor:
    """The (H, W, 2) float32 flow from uint8 ``left`` to ``right``: both
    resized to multiples of 32 (of ``scale`` times their size), the
    network, the flow resized back and its components scaled by the
    ratio of sizes."""
    img1 = _to_rgb01(left)
    img2 = _to_rgb01(right)
    h, w = img1.shape[:2]
    ph = max(32, int(np.ceil(h * scale / 32.0) * 32))
    pw = max(32, int(np.ceil(w * scale / 32.0) * 32))
    if (ph, pw) != (h, w):
        img1 = torch_bilinear_resize(img1, ph, pw)
        img2 = torch_bilinear_resize(img2, ph, pw)
    out = torch_bilinear_resize(net(img1, img2, mode), h, w)
    return out * torch.tensor((w / pw, h / ph), dtype=torch.float32,
                              device=out.device)


def flow(prev: torch.Tensor, cur: torch.Tensor, cv_config: dict,
         direction: str, precision: dict, variant: str = "stated",
         net=None) -> torch.Tensor:
    """The raw flow of the frame pair (``prev``, ``cur``) as the estimator
    pairs them for ``direction``, through ``net`` (``network``).
    ``variant``: ``"stated"`` computes the convolutions in
    ``precision["conv"]``, ``"float32"`` in float32 with TF32 off,
    ``"control"`` as stated after rounding their operands to float8
    e4m3."""
    if int(cv_config.get("lfn_warp_bound", 0)) != 0:
        raise NotImplementedError("the reference covers lfn_warp_bound 0")
    dtype = getattr(torch, precision["conv"])
    quant = (lambda x: x)
    if variant == "float32":
        dtype = torch.float32
    elif variant == "control":
        if precision["control"] != "conv_operands_float8_e4m3fn":
            raise ValueError(f"unknown control {precision['control']!r}")
        quant = fp8_round
    left, right = (prev, cur) if direction == "forward" else (cur, prev)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return estimate(left, right, net, (dtype, quant),
                        float(cv_config.get("lfn_scale", 1.0)))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def template() -> dict:
    """The network's parameters, by name, as float32 tensors of their
    shapes (the upsamplers' taps bilinear)."""
    return LiteFlowNet().state_dict()

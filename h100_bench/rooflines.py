"""The yardstick of the kernels: the card's published peaks, each kernel's
least time at a cell's shapes, and the networks' operation counts.

A kernel's bound is the larger of its bytes over the memory's peak rate
and its operations over the compute peak it runs on: each input byte read
once, each output byte written once, the operations its arithmetic needs
(float32 outside the tensor cores unless said). The bounds are summed a
frame over the launches a frame makes at the cell's shapes, in the dtypes
the configuration states.

A roofline share sums the bounds of the kernels the trace shows over
their summed time there; a kernel the trace does not show adds neither
bound nor time, so a change that fuses or drops a kernel cannot push the
share past 100 %. The step's share of the peak (``*_mfu``) still bounds
such a change.
"""
import math

from .reference.image import resize_weights

# NVIDIA H100 SXM5 data sheet: HBM3 bandwidth, float32 outside the tensor
# cores, and bf16 on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

# the operations a pixel of Farneback's kernels needs (poly_n 5, winsize
# 15): B1 per image, 18 a tap of the 2n + 1 taps of the nine correlations
# (a product and a sum each, over three vertical and six horizontal
# passes), five 6-term dot products and the halving; B2a the sample of
# five planes and the normal equations' algebra; B2b a vertical and a
# horizontal box sum of each of six planes, then the 2x2 solve
FB_B2A_OPS = 53 + 46
# K1's threefry draw a pixel (20 rounds of an add, a rotate and a xor,
# five key injections, the float): counted at the float32 peak
K1_DRAW_OPS = 100

BF16, F32 = 2, 4


def bound_s(nbytes: float, ops: float, flops: float = F32_FLOPS) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / flops)


# ---------------------------------------------------------------------------
# Farneback: B1, B2a, B2b, B8, B15
# ---------------------------------------------------------------------------

def fb_levels(h: int, w: int, cv: dict) -> list[tuple[int, int, float]]:
    """The pyramid's (height, width, scale), finest first."""
    shapes = []
    poly_n = int(cv.get("fb_poly_n", 5))
    for k in range(int(cv.get("fb_levels", 3)) + 1):
        scale = cv.get("fb_pyr_scale", 0.5) ** k
        lh, lw = int(round(h * scale)), int(round(w * scale))
        if min(lh, lw) <= 2 * poly_n + 1:
            break
        shapes.append((lh, lw, scale))
    return shapes


def b1_ops(poly_n: int) -> int:
    return 18 * (2 * poly_n + 1) + 5 * 11 + 1


def b2b_ops(winsize: int) -> int:
    return 6 * 4 * winsize + 14


def fb_bounds(h: int, w: int, cv: dict, storage: int = BF16) -> dict:
    """Seconds a frame of each of Farneback's kernels at least takes:
    {family: (bound s, float32 operations)}; ``storage`` bytes a value of
    the stored planes."""
    levels = fb_levels(h, w, cv)
    iters = int(cv.get("fb_iterations", 3))
    out = {"B1": [0.0, 0.0], "B2a": [0.0, 0.0], "B2b": [0.0, 0.0],
           "B8": [0.0, 0.0], "B15": [0.0, 0.0]}

    def add(family, nbytes, ops):
        out[family][0] += bound_s(nbytes, ops)
        out[family][1] += ops

    for lh, lw, scale in levels:
        px = lh * lw
        # level 0 reads the bf16 frames, the others B8's float32 levels
        in_size = storage if scale == 1.0 else F32
        add("B1", 2 * px * (in_size + 5 * storage),
            2 * b1_ops(int(cv.get("fb_poly_n", 5))) * px)
        for _ in range(iters):
            add("B2a", px * (8 + 16 * storage), FB_B2A_OPS * px)
            add("B2b", px * (6 * storage + 16),
                b2b_ops(int(cv.get("fb_winsize", 15))) * px)
    below = [(lh, lw, (1.0 / s - 1.0) * 0.5) for lh, lw, s in levels
             if s != 1.0]
    if below:
        nbytes = 2 * (h * w * storage + sum(lh * lw * F32
                                            for lh, lw, _ in below))
        ops = 0
        for lh, lw, sigma in below:
            taps = 2 * int(3.0 * sigma + 0.5) + 1
            ky = resize_weights(h, lh)[1].shape[1]
            kx = resize_weights(w, lw)[1].shape[1]
            ops += 2 * 2 * (taps * h * w + ky * lh * w + taps * lh * w
                            + kx * lh * lw)
        add("B8", nbytes, ops)
    for (lh, lw, _), (sh, sw, _) in zip(levels[:-1], levels[1:]):
        add("B15", *resize_cost(sh, sw, lh, lw))
    return {k: tuple(v) for k, v in out.items()}


def resize_cost(h: int, w: int, lh: int, lw: int) -> tuple[int, int]:
    """(bytes, operations) of a flow's resize from (h, w) to (lh, lw):
    both flows once; along H at (lh, w) ky products and ky - 1 sums a
    value, along W at (lh, lw) kx and kx - 1, the scale's product."""
    ops = 2 * lh * lw
    if lh != h:
        ops += 2 * lh * w * (2 * resize_weights(h, lh)[1].shape[1] - 1)
    if lw != w:
        ops += 2 * lh * lw * (2 * resize_weights(w, lw)[1].shape[1] - 1)
    return 8 * (h * w + lh * lw), ops


# ---------------------------------------------------------------------------
# the compositor: K1 (a moveref layer's update) and K2 (the composite)
# ---------------------------------------------------------------------------

def comp_bounds(h: int, w: int, reset_factor: float) -> dict:
    """K1 and K2 a frame over one moveref layer of one 3-channel source
    without masks: K1 writes the positions, alpha, source and colours (10
    bytes a pixel), reads the flow and the pixmap's colour, and for a
    pixel the random reset does not take the positions, source and alpha
    it keeps or gathers (6 bytes), and draws its uniform; K2 reads the
    layer's colours and alpha and writes the image."""
    n = h * w
    k1_bytes = n * (10 + 8 + 3 + 6 * (1.0 - reset_factor))
    k1_ops = K1_DRAW_OPS * n
    return {"K1": (bound_s(k1_bytes, k1_ops), k1_ops),
            "K2": (bound_s(7 * n, 0), 0)}


# ---------------------------------------------------------------------------
# LiteFlowNet: A1, B7, B16, B17, B18, and its operations
# ---------------------------------------------------------------------------

_FEATS = ((32, 1), (32, 2), (64, 4), (96, 8), (128, 16), (192, 32))
_FEAT_CH = {2: 32, 3: 64, 4: 96, 5: 128, 6: 192}
_KERNEL = {2: 7, 3: 5, 4: 5, 5: 3, 6: 3}
_DIST_CH = {2: 49, 3: 25, 4: 25, 5: 9, 6: 9}


def lfn_size(h: int, w: int, scale: float = 1.0) -> tuple[int, int]:
    """The network's input size for an h x w frame."""
    return (max(32, int(math.ceil(h * scale / 32.0) * 32)),
            max(32, int(math.ceil(w * scale / 32.0) * 32)))


def lfn_launches(ph: int, pw: int) -> list[tuple]:
    """A frame's convolutions and head kernels at input (ph, pw), in the
    dtypes the configuration states (bf16 features and convolutions,
    float32 flows after the first level's regularization, float32
    images):

    ``("conv", n, h, w, cin, cout, kh, kw, leaky)`` (output shape; each is
    cuDNN's convolution then a B18 launch), ``("A1", h, w, c, stride,
    f1 bytes, f2 bytes)``, ``("B7", h, w, c, image bytes)``, ``("B16",
    h, w, c, bytes)`` (input shape) and ``("B17", h, w, size, flow
    bytes)``."""
    out = []
    res = {}
    cin = 3
    names = [(0, 32, 7, 1), (1, 32, 3, 2), (1, 32, 3, 1), (1, 32, 3, 1),
             (2, 64, 3, 2), (2, 64, 3, 1), (3, 96, 3, 2), (3, 96, 3, 1),
             (4, 128, 3, 2), (5, 192, 3, 2)]
    for idx, cout, k, _ in names:
        div = _FEATS[idx][1]
        res[idx] = (ph // div, pw // div)
        out.append(("conv", 2, ph // div, pw // div, cin, cout, k, k, True))
        cin = cout
    level_res = {6: res[5], 5: res[4], 4: res[3], 3: res[2], 2: res[1]}
    for lvl in (6, 5, 4, 3, 2):
        lh, lw = level_res[lvl]
        size = _KERNEL[lvl]
        feat = 64 if lvl == 2 else _FEAT_CH[lvl]
        flow_bytes = BF16 if lvl == 6 else F32
        # matching
        if lvl == 2:
            out.append(("conv", 2, lh, lw, 32, 64, 1, 1, True))
        if lvl != 6:
            out.append(("B16", lh // 2, lw // 2, 2, F32))
            out.append(("B7", lh, lw, feat, BF16))
        stride = 1 if lvl >= 4 else 2
        out.append(("A1", lh, lw, feat, stride, BF16,
                    BF16 if lvl == 6 else F32))
        if lvl < 4:
            out.append(("B16", -(-lh // 2), -(-lw // 2), 49, F32))
        out += [("conv", 1, lh, lw, 49, 128, 3, 3, True),
                ("conv", 1, lh, lw, 128, 64, 3, 3, True),
                ("conv", 1, lh, lw, 64, 32, 3, 3, True),
                ("conv", 1, lh, lw, 32, 2, size, size, False)]
        # subpixel
        if lvl == 2:
            out.append(("conv", 2, lh, lw, 32, 64, 1, 1, True))
        out.append(("B7", lh, lw, feat, BF16))
        out += [("conv", 1, lh, lw, 2 * feat + 2, 128, 3, 3, True),
                ("conv", 1, lh, lw, 128, 64, 3, 3, True),
                ("conv", 1, lh, lw, 64, 32, 3, 3, True),
                ("conv", 1, lh, lw, 32, 2, size, size, False)]
        # regularization
        out.append(("B7", lh, lw, 3, F32))
        if lvl < 5:
            out.append(("conv", 1, lh, lw, _FEAT_CH[lvl], 128, 1, 1, True))
        out += [("conv", 1, lh, lw, 131 if lvl < 6 else 195, 128, 3, 3,
                 True),
                ("conv", 1, lh, lw, 128, 128, 3, 3, True),
                ("conv", 1, lh, lw, 128, 64, 3, 3, True),
                ("conv", 1, lh, lw, 64, 64, 3, 3, True),
                ("conv", 1, lh, lw, 64, 32, 3, 3, True),
                ("conv", 1, lh, lw, 32, 32, 3, 3, True)]
        dch = _DIST_CH[lvl]
        if lvl >= 5:
            out.append(("conv", 1, lh, lw, 32, dch, size, size, False))
        else:
            out.append(("conv", 1, lh, lw, 32, dch, size, 1, False))
            out.append(("conv", 1, lh, lw, dch, dch, 1, size, False))
        out.append(("B17", lh, lw, size, flow_bytes))
    return out


def lfn_flops(ph: int, pw: int) -> float:
    """A frame's operations in the convolutions (2 a multiply-add) and
    the correlation (a product and a sum a channel and displacement)."""
    total = 0.0
    for item in lfn_launches(ph, pw):
        if item[0] == "conv":
            _, n, h, w, cin, cout, kh, kw, _ = item
            total += 2.0 * n * h * w * cin * cout * kh * kw
        elif item[0] == "A1":
            _, h, w, c, stride, *_ = item
            total += 2.0 * 49 * c * -(-h // stride) * -(-w // stride)
    return total


def lfn_bounds(ph: int, pw: int) -> dict:
    """Seconds a frame of A1, B7, B16, B17 and B18 at least takes:
    {family: (bound s, operations)}."""
    out = {k: [0.0, 0.0] for k in ("A1", "B7", "B16", "B17", "B18")}

    def add(family, nbytes, ops):
        out[family][0] += bound_s(nbytes, ops)
        out[family][1] += ops

    for item in lfn_launches(ph, pw):
        kind = item[0]
        if kind == "conv":
            _, n, h, w, _, cout, _, _, leaky = item
            values = n * h * w * cout
            # cuDNN's output read and the result written (bf16), the
            # float32 biases; the add, and the leaky ReLU's test and product
            add("B18", 2 * values * BF16 + 4 * cout,
                values * (3 if leaky else 1))
        elif kind == "A1":
            _, h, w, c, stride, t1, t2 = item
            pixels = -(-h // stride) * -(-w // stride)
            add("A1", pixels * (c * (t1 + t2) + 49 * F32),
                2 * 49 * c * pixels)
        elif kind == "B7":
            _, h, w, c, size = item
            add("B7", h * w * (c * size + 2 * F32 + c * F32),
                h * w * (15 * c + 18))
        elif kind == "B16":
            _, h, w, c, size = item
            add("B16", h * w * c * size * 5 + 64 * c, 7 * 4 * h * w * c)
        elif kind == "B17":
            _, h, w, size, flow_bytes = item
            taps = size * size
            add("B17", h * w * (taps * BF16 + 2 * flow_bytes + 2 * F32)
                + 4 * (2 * taps + 2), h * w * (11 * taps + 5))
    return {k: tuple(v) for k, v in out.items()}


# ---------------------------------------------------------------------------
# kernels in a trace
# ---------------------------------------------------------------------------

# each family's kernel name in the trace (the __global__ functions of the
# port's csrc/)
KERNEL_NAMES = {
    "B1": "poly_expansion_kernel", "B2a": "update_equations_kernel",
    "B2b": "aggregate_solve_kernel", "B8": "pyramid_levels_kernel",
    "B15": "flow_resize_kernel", "A1": "corr7x7_kernel",
    "B7": "exact_backwarp_kernel", "B16": "upsample2x_phases_kernel",
    "B17": "reg_apply_kernel", "B18": "conv_epilogue_",
    "K1": "layer_update_kernel", "K2": "composite_kernel",
}


def share(trace, bounds: dict, frames: int) -> float | None:
    """Percent of the traced time of ``bounds``' kernel families that
    their summed bounds (a frame, times ``frames``) account for; None
    where the trace shows none of them."""
    bound = spent = 0.0
    for family, (seconds, _) in bounds.items():
        took = trace.seconds("kernel", KERNEL_NAMES[family])
        if took > 0:
            bound += seconds * frames
            spent += took
    return 100.0 * bound / spent if spent > 0 else None

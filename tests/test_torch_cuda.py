"""Card-only tests of the port: each CUDA kernel against its plain PyTorch
version, and the slice on the card against the slice on the CPU.

They skip without a CUDA card (the kernels have no CPU mode). This file
imports no JAX, so on a machine without it run
``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from transflow_tpu_torch import prng
from transflow_tpu_torch.ops import conv_epilogue as ce
from transflow_tpu_torch.ops import farneback as fb
from transflow_tpu_torch.ops import horn_schunck as hs
from transflow_tpu_torch.ops import lfn_heads
from transflow_tpu_torch.ops import lucas_kanade as lk
from transflow_tpu_torch.ops import pyramid
from transflow_tpu_torch.ops.conv_epilogue import (conv_epilogue,
                                                   conv_epilogue_cuda,
                                                   conv_epilogue_plain)
from transflow_tpu_torch.ops.correlation import (correlation,
                                                 correlation7x7,
                                                 correlation7x7_cuda,
                                                 sharded_correlation7x7)
from transflow_tpu_torch.ops import warp
from transflow_tpu_torch.ops.lfn_heads import (reg_apply, reg_apply_cuda,
                                               reg_apply_plain,
                                               upsample2x_phases,
                                               upsample2x_phases_cuda,
                                               upsample2x_phases_plain)
from transflow_tpu_torch.ops.warp import (bounded_backwarp,
                                          bounded_backwarp_cuda,
                                          bounded_backwarp_plain,
                                          exact_backwarp,
                                          exact_backwarp_cuda,
                                          exact_backwarp_plain)
from transflow_tpu_torch.parallel import make_space_mesh

pytestmark = pytest.mark.cuda

BF16, F32 = torch.bfloat16, torch.float32
PAIRS = [(F32, F32), (BF16, BF16), (BF16, F32)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture
def exact_f32(monkeypatch):
    """f32 convolutions without TF32, on both devices."""
    monkeypatch.setenv("TRANSFLOW_LITEFLOWNET_BF16", "0")
    monkeypatch.setenv("TRANSFLOW_LITEFLOWNET_RANDOM", "1")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "/".join(
    str(t)[6:] for t in p))
@pytest.mark.parametrize("shape", [(16, 24, 8, 1), (32, 48, 16, 2),
                                   (4, 6, 192, 1), (9, 37, 20, 2),
                                   (68, 120, 128, 1), (136, 240, 64, 2),
                                   # off the tile grid: W not a multiple
                                   # of a tile, odd H at stride 2; C = 24
                                   # (one channel group), 200 (four, the
                                   # last one short), 18 (rows of 72 or 36
                                   # bytes: the element-wise staging)
                                   (17, 45, 24, 2), (11, 29, 200, 1),
                                   (13, 21, 18, 1), (35, 61, 96, 2)],
                         ids=str)
def test_kernel_matches_plain(device, shape, pair):
    h, w, c, stride = shape
    gen = torch.Generator(device=device).manual_seed(0)
    f1 = torch.randn((h, w, c), generator=gen, device=device).to(pair[0])
    f2 = torch.randn((h, w, c), generator=gen, device=device).to(pair[1])
    before = correlation7x7_cuda.launches
    got = correlation(f1, f2, stride)
    torch.cuda.synchronize()
    assert correlation7x7_cuda.launches == before + 1
    want = correlation7x7(f1, f2, stride)
    assert got.shape == want.shape
    # f32 math on both sides, different summation order
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(9, 37, 24, 3), (20, 30, 18, 4),
                                   (544, 960, 64, 16)], ids=str)
def test_bounded_backwarp_matches_plain(device, shape, dtype):
    """Kernel A3 against its plain version, with a fifth of the pixels
    beyond the bound so the clamp runs. Both round the image to bf16 and
    add the same f32 terms in the same order: bit-equal."""
    h, w, c, bound = shape
    gen = torch.Generator(device=device).manual_seed(1)
    image = torch.randn((h, w, c), generator=gen, device=device).to(dtype)
    flow = bound * (2 * torch.rand((h, w, 2), generator=gen,
                                   device=device) - 1)
    far = torch.rand((h, w, 1), generator=gen, device=device) < 0.2
    flow = torch.where(far, 3 * bound * torch.randn(
        (h, w, 2), generator=gen, device=device), flow)
    before = bounded_backwarp_cuda.launches
    got = bounded_backwarp(image, flow, bound)
    torch.cuda.synchronize()
    assert bounded_backwarp_cuda.launches == before + 1
    want = bounded_backwarp_plain(image, flow, bound)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# LiteFlowNet's exact backwarps of a 1088x1920 input: the matching and
# subpixel heads' features (levels 6-2) and, beside them, odd shapes and
# channel counts (3, 5, 33: one channel a thread; 8 on one-pixel rows and
# columns)
B7_SHAPES = [(34, 60, 192), (68, 120, 128), (136, 240, 96), (272, 480, 64),
             (544, 960, 64), (9, 37, 5), (17, 23, 3), (13, 21, 33),
             (1, 7, 8), (7, 1, 16)]
# the regularization's 3-channel images at levels 6-2
B7_LEVELS = [(34, 60), (68, 120), (136, 240), (272, 480), (544, 960)]


def _b7_flow(h, w, gen, device):
    """(h, w, 2) float32 flow: +-8 px at level 2 (544x960) scaled to the
    level, a tenth on whole taps, a fifth 1-3 frames outside."""
    reach = max(1.0, 8.0 * w / 960)
    flow = reach * (2 * torch.rand((h, w, 2), generator=gen,
                                   device=device) - 1)
    whole = torch.rand((h, w, 1), generator=gen, device=device) < 0.1
    flow = torch.where(whole, flow.round(), flow)
    far = torch.rand((h, w, 1), generator=gen, device=device) < 0.2
    size = torch.tensor([w, h], dtype=torch.float32, device=device)
    away = size * (1 + 2 * torch.rand((h, w, 2), generator=gen,
                                      device=device))
    return torch.where(far, torch.sign(flow) * away, flow)


def _b7_edge_flow(h, w, device):
    """Every pixel's float floors on an edge case of each axis: -1 (the +1
    tap falls back to the anchor's), n-1 (the +1 tap is the zero pad), n
    and beyond, -2 and below, and inside, in every combination."""
    def targets(n):
        return torch.tensor([-1, n - 1, n, n + 3, -2, -7, 0, max(n - 2, 0),
                             n // 2], dtype=torch.float32, device=device)
    ii = torch.arange(h, device=device)[:, None].expand(h, w)
    jj = torch.arange(w, device=device)[None, :].expand(h, w)
    tx, ty = targets(w), targets(h)
    sx = tx[(ii + 2 * jj) % len(tx)] + torch.where((ii + jj) % 2 == 1,
                                                   0.25, 0.75)
    sy = ty[(3 * ii + jj) % len(ty)] + torch.where(ii % 2 == 1, 0.75, 0.25)
    return torch.stack([sx - jj, sy - ii], -1)


def _check_b7(image, flow):
    """B7 through the dispatcher against its plain version: one launch,
    bit-equal."""
    before = exact_backwarp_cuda.launches
    got = exact_backwarp(image, flow)
    torch.cuda.synchronize()
    assert exact_backwarp_cuda.launches == before + 1
    want = exact_backwarp_plain(image, flow)
    assert got.shape == want.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    return got


@pytest.mark.parametrize("kind", ["random", "edges"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", B7_SHAPES, ids=str)
def test_exact_backwarp_matches_plain(device, shape, dtype, kind):
    """Kernel B7 against its plain version: both widen the image exactly
    and round each product and sum in the same order, so bit-equal."""
    h, w, c = shape
    gen = torch.Generator(device=device).manual_seed(4)
    image = torch.randn((h, w, c), generator=gen, device=device).to(dtype)
    flow = (_b7_flow(h, w, gen, device) if kind == "random"
            else _b7_edge_flow(h, w, device))
    _check_b7(image, flow)


@pytest.mark.parametrize("shape", B7_LEVELS, ids=str)
def test_exact_backwarp_reads_the_strided_view(device, shape):
    """The regularization's image: the second half of a 6-channel f32 pair
    (pixels 6 elements apart, 12 bytes in), read in place and bit-equal
    to its plain version and to the kernel on a contiguous copy."""
    h, w = shape
    gen = torch.Generator(device=device).manual_seed(5)
    pair = torch.rand((h, w, 6), generator=gen, device=device)
    view = pair[..., 3:]
    assert view.stride() == (6 * w, 6, 1)
    flow = _b7_flow(h, w, gen, device)
    got = _check_b7(view, flow)
    torch.testing.assert_close(got, exact_backwarp_cuda(view.contiguous(),
                                                        flow),
                               atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_exact_backwarp_unaligned_and_bf16_flow(device, dtype):
    """An image whose base is not on 16 bytes takes one channel a thread;
    a bf16 flow is widened exactly: both bit-equal to the plain version."""
    gen = torch.Generator(device=device).manual_seed(6)
    h, w, c = 68, 120, 128
    flat = torch.randn(h * w * c + 1, generator=gen, device=device).to(dtype)
    shifted = flat[1:].view(h, w, c)
    assert shifted.data_ptr() % 16
    _check_b7(shifted, _b7_flow(h, w, gen, device))
    _check_b7(shifted, _b7_flow(h, w, gen, device).to(BF16))


def test_exact_backwarp_refuses_misuse(device):
    image = torch.zeros((6, 8, 4), device=device)
    flow = torch.zeros((6, 8, 2), device=device)
    with pytest.raises(ValueError, match="CUDA device"):
        exact_backwarp_cuda(image, flow.cpu())
    with pytest.raises(ValueError, match="rows of W pixels"):
        exact_backwarp_cuda(torch.zeros((6, 10, 4), device=device)[:, :8],
                            flow)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        exact_backwarp_cuda(image.half(), flow)


@pytest.mark.parametrize("bound,per_frame", [(0, (0, 14)), (16, (9, 5))])
def test_liteflownet_never_takes_the_plain_exact_backwarp(device,
                                                          monkeypatch, bound,
                                                          per_frame):
    """A forward at bound 0 launches 14 B7 (4 matching, 5 subpixel and 5
    regularization warps), at bound 16 9 A3 and 5 B7, and never the exact
    backwarp's plain version."""
    from transflow_tpu_torch.flow.estimators.liteflownet import get_weights
    monkeypatch.setattr(warp, "exact_backwarp_plain", lambda *a: pytest.fail(
        "the plain exact backwarp ran on the card"))
    net = get_weights(allow_random=True, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    i1, i2 = (torch.rand((128, 192, 3), generator=gen, device=device)
              for _ in range(2))
    before = (bounded_backwarp_cuda.launches, exact_backwarp_cuda.launches)
    with torch.no_grad():
        flow = net(i1, i2, warp_bound=bound)
    torch.cuda.synchronize()
    assert flow.shape == (64, 96, 2) and torch.isfinite(flow).all()
    assert (bounded_backwarp_cuda.launches - before[0],
            exact_backwarp_cuda.launches - before[1]) == per_frame


def test_liteflownet_1088p_equals_its_plain_warps(device, monkeypatch):
    """A 1088x1920 forward at bound 0 through B7 is bit-equal to the same
    forward with the dispatcher sent to the plain version on the card
    (deterministic cuDNN, so the convolutions repeat exactly)."""
    from transflow_tpu_torch.flow.estimators.liteflownet import get_weights
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    net = get_weights(allow_random=True, device=device)
    gen = torch.Generator(device=device).manual_seed(8)
    i1, i2 = (torch.rand((1088, 1920, 3), generator=gen, device=device)
              for _ in range(2))
    before = exact_backwarp_cuda.launches
    with torch.no_grad():
        got = net(i1, i2, warp_bound=0)
    assert exact_backwarp_cuda.launches == before + 14
    monkeypatch.setattr(warp, "exact_backwarp_cuda", exact_backwarp_plain)
    with torch.no_grad():
        want = net(i1, i2, warp_bound=0)
    assert got.shape == (544, 960, 2) and torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# B16's shapes of a 1088x1920 input (the flow at levels 6-3, the cost
# volume at 3 and 2, each doubled) and odd ones: one pixel, a column, a
# row, C of 1, 3 and 64, H * W * C past many 256-thread blocks unevenly.
# Then the tiling's edges: a block takes 256 consecutive (column, channel)
# pairs of a row and a band of 8 input rows (halved on frames too small to
# give each of 132 SMs two blocks), so 1057 rows are one past a band and
# each width puts one or two pairs past a block's 256 (W * C of 257, 258,
# 258, 10241 and 320 at C = 1, 2, 3, 49, 64); single rows and columns;
# 4000 channels
B16_SHAPES = [(34, 60, 2), (68, 120, 2), (136, 240, 2), (272, 480, 2),
              (136, 240, 49), (272, 480, 49), (1, 1, 2), (7, 1, 3),
              (1, 9, 49), (13, 17, 1), (5, 9, 64),
              (1057, 257, 1), (1057, 129, 2), (1057, 86, 3),
              (1057, 209, 49), (1057, 5, 64), (1, 300, 3), (300, 1, 1),
              (1, 1000, 49), (999, 1, 49), (3, 5, 4000)]
# B17's levels of a 1088x1920 input (H, W, S) and odd ones: frames smaller
# than the window, one row or column, a frame of one pixel, pixels past a
# 128-pixel block (11 * 13 = 143, 1 * 129, 3 * 50). Then the tiling's
# edges: a block walks tiles of 32 x 4 pixels, so S = 3, 5 and 7 on tiles
# the frame cuts, and odd widths, where a tile row's distances start off
# 16 bytes ((i * W + j0) * S * S not a multiple of 8 values) and its ends
# take element loads
B17_SHAPES = [(34, 60, 3), (68, 120, 3), (136, 240, 5), (272, 480, 5),
              (544, 960, 7), (1, 1, 3), (2, 3, 7), (3, 2, 5), (11, 13, 7),
              (1, 129, 5), (129, 1, 3), (3, 50, 7),
              (9, 33, 7), (10, 65, 5), (17, 31, 3), (13, 101, 7),
              (33, 77, 5), (5, 47, 3), (203, 333, 7), (1, 33, 7),
              (31, 1, 5)]


def _same_bits(got, want):
    """Bit-equal (the signs of zeros included), NaN in the same places."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    got, want = (torch.where(nan, 0, t) for t in (got, want))
    ints = torch.int16 if got.dtype == BF16 else torch.int32
    assert torch.equal(got.view(ints), want.view(ints))


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", B16_SHAPES, ids=str)
def test_upsample2x_phases_matches_plain(device, shape, dtype):
    """Kernel B16 through its dispatcher against its plain version: one
    launch, the four products summed in the same order, bit-equal; zeros
    and negative taps give the plain version's signed zeros."""
    h, w, c = shape
    gen = torch.Generator(device=device).manual_seed(10)
    x = torch.randn((h, w, c), generator=gen, device=device).to(dtype)
    x[::2, ::3] = 0.0
    weight = torch.randn((c, 1, 4, 4), generator=gen, device=device)
    before = upsample2x_phases_cuda.launches
    got = upsample2x_phases(x, weight)
    torch.cuda.synchronize()
    assert upsample2x_phases_cuda.launches == before + 1
    want = upsample2x_phases_plain(x, weight)
    assert got.dtype == dtype and got.shape == (2 * h, 2 * w, c)
    _same_bits(got, want)


def test_upsample2x_phases_keeps_non_finite_values(device):
    """An inf or NaN input and an inf tap spread as the plain version's
    products and sums spread them (inf * 0 at a padded tap is NaN)."""
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((9, 11, 5), generator=gen, device=device)
    x[4, 5, 1] = float("inf")
    x[0, 0, 2] = float("nan")
    weight = torch.randn((5, 1, 4, 4), generator=gen, device=device)
    weight[3, 0, 0, 0] = float("-inf")
    _same_bits(upsample2x_phases_cuda(x, weight),
               upsample2x_phases_plain(x, weight))


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("offset", [1, 3])
def test_upsample2x_phases_reads_an_unaligned_base(device, dtype, offset):
    """An input whose first value lies ``offset`` values past 16 bytes (a
    contiguous view into a larger buffer): every staged row starts off 16
    bytes, and the kernel still equals its plain version bit for bit."""
    h, w, c = 37, 70, 49
    gen = torch.Generator(device=device).manual_seed(16)
    buf = torch.randn(h * w * c + offset, generator=gen,
                      device=device).to(dtype)
    x = buf[offset:].view(h, w, c)
    weight = torch.randn((c, 1, 4, 4), generator=gen, device=device)
    _same_bits(upsample2x_phases_cuda(x, weight),
               upsample2x_phases_plain(x, weight))


def _reg_inputs(h, w, size, dist_dtype, flow_dtype, gen, device):
    taps = size * size
    dist = (1.5 * torch.randn((h, w, taps), generator=gen,
                              device=device)).to(dist_dtype)
    flow = (8 * (2 * torch.rand((h, w, 2), generator=gen, device=device)
                 - 1)).to(flow_dtype)
    flow[::4] = flow[::4].round()
    flow[1::5, :, 0] = -0.0
    params = [torch.randn(shape, generator=gen, device=device)
              for shape in ((1, taps, 1, 1), (1,), (1, taps, 1, 1), (1,))]
    return dist, flow, params


@pytest.mark.parametrize("flow_dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("dist_dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", B17_SHAPES, ids=str)
def test_reg_apply_matches_plain(device, shape, dist_dtype, flow_dtype):
    """Kernel B17 through its dispatcher against its plain version: one
    launch, bit-equal (expf equals torch.exp on the card, every product and
    sum rounded in the plain version's order)."""
    h, w, size = shape
    gen = torch.Generator(device=device).manual_seed(12)
    dist, flow, params = _reg_inputs(h, w, size, dist_dtype, flow_dtype, gen,
                                     device)
    before = reg_apply_cuda.launches
    got = reg_apply(dist, flow, *params)
    torch.cuda.synchronize()
    assert reg_apply_cuda.launches == before + 1
    want = reg_apply_plain(dist, flow, *params)
    assert got.dtype == F32 and got.shape == (h, w, 2)
    _same_bits(got, want)


@pytest.mark.parametrize("dist_dtype", [BF16, F32], ids=["bf16", "f32"])
def test_reg_apply_keeps_nan_and_signed_zeros(device, dist_dtype):
    """NaN distances make their pixels NaN as ``amax`` does; a zero flow
    with zero biases gives +0.0, as the plain version's zeros start."""
    gen = torch.Generator(device=device).manual_seed(13)
    dist, flow, params = _reg_inputs(40, 50, 7, dist_dtype, F32, gen, device)
    dist[3, 4, 0] = float("nan")
    dist[20, :, 48] = float("nan")
    dist[30, 7] = 0.0
    got = reg_apply_cuda(dist, flow, *params)
    _same_bits(got, reg_apply_plain(dist, flow, *params))
    assert torch.isnan(got[3, 4]).all() and torch.isnan(got[20]).all()
    params[1].zero_()
    params[3].zero_()
    zero = torch.zeros_like(flow)
    got = reg_apply_cuda(dist, zero, *params)
    _same_bits(got, reg_apply_plain(dist, zero, *params))
    assert not torch.signbit(got[~torch.isnan(got)]).any()


@pytest.mark.parametrize("size", [3, 5, 7])
@pytest.mark.parametrize("dist_dtype", [BF16, F32], ids=["bf16", "f32"])
def test_reg_apply_reads_an_unaligned_base(device, dist_dtype, size):
    """Distances whose first value lies 3 values past 16 bytes (a
    contiguous view into a larger buffer), at an odd width: every tile
    row's run starts off 16 bytes, and the kernel still equals its plain
    version bit for bit."""
    h, w = 19, 45
    taps = size * size
    gen = torch.Generator(device=device).manual_seed(17)
    dist, flow, params = _reg_inputs(h, w, size, dist_dtype, F32, gen,
                                     device)
    buf = torch.empty(h * w * taps + 3, dtype=dist_dtype, device=device)
    view = buf[3:].view(h, w, taps)
    view.copy_(dist)
    _same_bits(reg_apply_cuda(view, flow, *params),
               reg_apply_plain(view, flow, *params))


def test_lfn_heads_refuse_misuse(device):
    x = torch.zeros((6, 8, 4), device=device)
    weight = torch.zeros((4, 1, 4, 4), device=device)
    with pytest.raises(ValueError, match="CUDA device"):
        upsample2x_phases_cuda(x, weight.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        upsample2x_phases_cuda(torch.zeros((6, 16, 4), device=device)[:, ::2],
                               weight)
    dist = torch.zeros((6, 8, 25), device=device)
    flow = torch.zeros((6, 8, 2), device=device)
    params = [torch.zeros(n, device=device) for n in (25, 1, 25, 1)]
    with pytest.raises(ValueError, match="CUDA device"):
        reg_apply_cuda(dist, flow.cpu(), *params)
    with pytest.raises(ValueError, match="contiguous"):
        reg_apply_cuda(dist, torch.zeros((6, 8, 4), device=device)[..., ::2],
                       *params)
    with pytest.raises(ValueError, match="float32 taps"):
        reg_apply_cuda(dist, flow, params[0].to(BF16), *params[1:])


@pytest.mark.parametrize("bound", [0, 16])
def test_liteflownet_never_takes_the_plain_heads(device, monkeypatch, bound):
    """A forward launches 6 B16 (the flow at levels 5-2, the cost volume
    at 3 and 2) and 5 B17 (one a level) at any bound, and never the heads'
    plain versions."""
    from transflow_tpu_torch.flow.estimators.liteflownet import get_weights
    for name in ("upsample2x_phases_plain", "reg_apply_plain"):
        monkeypatch.setattr(lfn_heads, name, lambda *a: pytest.fail(
            "a head's plain version ran on the card"))
    net = get_weights(allow_random=True, device=device)
    gen = torch.Generator(device=device).manual_seed(14)
    i1, i2 = (torch.rand((128, 192, 3), generator=gen, device=device)
              for _ in range(2))
    before = (upsample2x_phases_cuda.launches, reg_apply_cuda.launches)
    with torch.no_grad():
        flow = net(i1, i2, warp_bound=bound)
    torch.cuda.synchronize()
    assert flow.shape == (64, 96, 2) and torch.isfinite(flow).all()
    assert (upsample2x_phases_cuda.launches - before[0],
            reg_apply_cuda.launches - before[1]) == (6, 5)


def test_liteflownet_1088p_equals_its_plain_heads(device, monkeypatch):
    """A 1088x1920 forward through B16 and B17 (6 and 5 launches) is
    bit-equal to the same forward with both dispatchers sent to the plain
    versions on the card (deterministic cuDNN)."""
    from transflow_tpu_torch.flow.estimators.liteflownet import get_weights
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    net = get_weights(allow_random=True, device=device)
    gen = torch.Generator(device=device).manual_seed(15)
    i1, i2 = (torch.rand((1088, 1920, 3), generator=gen, device=device)
              for _ in range(2))
    before = (upsample2x_phases_cuda.launches, reg_apply_cuda.launches)
    with torch.no_grad():
        got = net(i1, i2, warp_bound=0)
    assert (upsample2x_phases_cuda.launches - before[0],
            reg_apply_cuda.launches - before[1]) == (6, 5)
    monkeypatch.setattr(lfn_heads, "upsample2x_phases_cuda",
                        upsample2x_phases_plain)
    monkeypatch.setattr(lfn_heads, "reg_apply_cuda", reg_apply_plain)
    with torch.no_grad():
        want = net(i1, i2, warp_bound=0)
    assert got.shape == (544, 960, 2) and torch.isfinite(got).all()
    _same_bits(got, want)


# B18's (N, H, W, C) a bound-0 1088x1920 frame: the features' ten
# convolutions (both images), the L2 heads' 1x1 feature convolutions, and
# at each level (H, W, distance taps) the heads' 128, 64, 32 and 2 channels
# and the regularization's distances; the network gives them bf16, and the
# L2 ones are held in f32 too
B18_LEVELS = ((544, 960, 49), (272, 480, 25), (136, 240, 25), (68, 120, 9),
              (34, 60, 9))
B18_SHAPES = [(2, 1088, 1920, 32), (2, 544, 960, 32), (2, 272, 480, 64),
              (2, 136, 240, 96), (2, 68, 120, 128), (2, 34, 60, 192),
              (2, 544, 960, 64)] + [(1, h, w, c) for h, w, taps in B18_LEVELS
                                    for c in (128, 64, 32, 2, taps)]
B18_CASES = [(shape, BF16) for shape in B18_SHAPES] + [
    (shape, F32) for shape in B18_SHAPES if shape[1] == 544]


def _b18_input(shape, dtype, kind, gen, device):
    """Random (N, C, H, W) values in ``kind``'s layout with exact zeros of
    both signs, and a float32 bias with a +0.0 and a -0.0."""
    n, h, w, c = shape
    y = 4 * torch.randn((n, h, w, c), generator=gen, device=device)
    flat = y.view(-1)
    flat[::13] = 0.0
    flat[5::13] = -0.0
    y = y.to(dtype).permute(0, 3, 1, 2)
    if kind == ce.NCHW:
        y = y.contiguous()
    bias = torch.randn(c, generator=gen, device=device)
    bias[0] = 0.0
    bias[-1] = -0.0
    return y, bias


def _check_b18(y, bias, leaky):
    """B18 through its dispatcher against its plain version: one launch,
    in place on a channels_last input, bit-equal."""
    want = conv_epilogue_plain(y, bias, leaky)
    in_place = ce.layout(y, bias, "test") == ce.CHANNELS_LAST
    before = conv_epilogue_cuda.launches
    got = conv_epilogue(y, bias, leaky)
    torch.cuda.synchronize()
    assert conv_epilogue_cuda.launches == before + 1
    n, c, h, w = y.shape
    assert got.shape == (n, h, w, c) and got.is_contiguous()
    assert got.dtype == y.dtype
    assert (got.data_ptr() == y.data_ptr()) == in_place
    _same_bits(got, want)


@pytest.mark.parametrize("leaky", [True, False], ids=["leaky", "linear"])
@pytest.mark.parametrize("kind", [ce.CHANNELS_LAST, ce.NCHW])
@pytest.mark.parametrize("case", B18_CASES, ids=lambda c: "x".join(
    map(str, c[0])) + "-" + str(c[1])[6:])
def test_conv_epilogue_matches_plain(device, case, kind, leaky):
    shape, dtype = case
    gen = torch.Generator(device=device).manual_seed(18)
    _check_b18(*_b18_input(shape, dtype, kind, gen, device), leaky)


@pytest.mark.parametrize("kind", [ce.CHANNELS_LAST, ce.NCHW])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_conv_epilogue_keeps_non_finite_values(device, dtype, kind):
    """Infinities, NaN, signed zeros, subnormals and the largest values:
    the sign test keeps -0.0, NaN stays NaN, a sum past the range is
    infinite, a subnormal is not flushed; as the plain version."""
    gen = torch.Generator(device=device).manual_seed(19)
    y, bias = _b18_input((2, 11, 37, 9), dtype, kind, gen, device)
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0,
                            -0.0, 3e38, -3e38, 1e-39, -3e-39, -1.2e-38],
                           device=device).to(dtype)
    flat = y.permute(0, 2, 3, 1).reshape(-1) if kind == ce.NCHW else \
        y.permute(0, 2, 3, 1).view(-1)
    flat[:special.numel() * 37:37] = special
    if kind == ce.NCHW:
        y = flat.view(2, 11, 37, 9).permute(0, 3, 1, 2).contiguous()
    bias[1] = float("inf")
    bias[2] = 3e38
    bias[3] = -0.0
    for leaky in (True, False):
        _check_b18(y.clone(), bias, leaky)


@pytest.mark.parametrize("kind", [ce.CHANNELS_LAST, ce.NCHW])
@pytest.mark.parametrize("channels", [1, 2, 3, 9, 25, 49, 192])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_conv_epilogue_unaligned_base_and_odd_channels(device, dtype,
                                                       channels, kind):
    """A tensor whose first value lies 1 or 3 values past 16 bytes (a view
    into a larger buffer: the one-element path) and an aligned one whose
    element count is no multiple of the vector (the tail), at odd C."""
    n, h, w, c = 1, 13, 29, channels
    gen = torch.Generator(device=device).manual_seed(20)
    for offset in (0, 1, 3):
        buf = torch.randn(n * h * w * c + offset, generator=gen,
                          device=device).to(dtype)
        y = buf[offset:].view(n, h, w, c).permute(0, 3, 1, 2)
        if kind == ce.NCHW:
            y = buf[offset:].view(n, c, h, w)
        assert (y.data_ptr() % 16 == 0) == (offset == 0)
        bias = torch.randn(c, generator=gen, device=device)
        for leaky in (True, False):
            _check_b18(y, bias, leaky)


def test_conv_epilogue_refuses_misuse(device):
    y = torch.zeros((1, 4, 5, 6), device=device, dtype=BF16)
    bias = torch.zeros(4, device=device)
    with pytest.raises(ValueError, match="CUDA device"):
        conv_epilogue_cuda(y, bias.cpu(), True)
    with pytest.raises(ValueError, match="contiguous bias"):
        conv_epilogue_cuda(y, torch.zeros(8, device=device)[::2], True)
    with pytest.raises(ValueError, match="at most 1024"):
        conv_epilogue_cuda(torch.zeros((1, 1025, 2, 2), device=device),
                           torch.zeros(1025, device=device), True)
    with pytest.raises(ValueError, match="channels_last or contiguous"):
        conv_epilogue_cuda(y.transpose(2, 3), bias, True)
    with pytest.raises(ValueError, match="bias of 4"):
        conv_epilogue_cuda(y, bias[:3], True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        conv_epilogue_cuda(y.half(), bias, True)


@pytest.mark.parametrize("bound", [0, 16])
def test_liteflownet_never_takes_the_plain_epilogue(device, monkeypatch,
                                                    bound):
    """A forward launches 93 B18, one a convolution (the features 10, the
    matching and subpixel heads 21 each, the regularization 41), at any
    bound, and never the epilogue's plain version."""
    from transflow_tpu_torch.flow.estimators.liteflownet import get_weights
    monkeypatch.setattr(ce, "conv_epilogue_plain", lambda *a: pytest.fail(
        "the plain epilogue ran on the card"))
    net = get_weights(allow_random=True, device=device)
    gen = torch.Generator(device=device).manual_seed(21)
    i1, i2 = (torch.rand((128, 192, 3), generator=gen, device=device)
              for _ in range(2))
    before = conv_epilogue_cuda.launches
    with torch.no_grad():
        flow = net(i1, i2, warp_bound=bound)
    torch.cuda.synchronize()
    assert flow.shape == (64, 96, 2) and torch.isfinite(flow).all()
    assert conv_epilogue_cuda.launches - before == 93


def test_liteflownet_1088p_equals_its_plain_epilogue(device, monkeypatch):
    """A 1088x1920 forward through B18 (93 launches) is bit-equal to the
    same forward with the dispatcher sent to the plain version on the card
    (deterministic cuDNN)."""
    from transflow_tpu_torch.flow.estimators.liteflownet import get_weights
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    net = get_weights(allow_random=True, device=device)
    gen = torch.Generator(device=device).manual_seed(22)
    i1, i2 = (torch.rand((1088, 1920, 3), generator=gen, device=device)
              for _ in range(2))
    before = conv_epilogue_cuda.launches
    with torch.no_grad():
        got = net(i1, i2, warp_bound=0)
    assert conv_epilogue_cuda.launches == before + 93
    monkeypatch.setattr(ce, "conv_epilogue_cuda", conv_epilogue_plain)
    with torch.no_grad():
        want = net(i1, i2, warp_bound=0)
    assert got.shape == (544, 960, 2) and torch.isfinite(got).all()
    _same_bits(got, want)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "/".join(
    str(t)[6:] for t in p))
@pytest.mark.parametrize("shape", [(64, 48, 16, 1, 4), (128, 48, 32, 2, 4),
                                   (136, 240, 96, 1, 4), (272, 480, 64, 2, 4),
                                   (68, 120, 128, 1, 2), (64, 37, 24, 1, 2),
                                   (128, 45, 200, 1, 8), (272, 96, 64, 2, 8),
                                   (136, 240, 96, 1, 8)], ids=str)
def test_sharded_kernel_equals_unsharded(device, shape, pair):
    """Kernel A2 over shards that repeat one card, in one launch that
    reads the halos in place: every output pixel sums the same products
    in the same order as kernel A1, so bit-equal."""
    h, w, c, stride, n = shape
    gen = torch.Generator(device=device).manual_seed(2)
    f1 = torch.randn((h, w, c), generator=gen, device=device).to(pair[0])
    f2 = torch.randn((h, w, c), generator=gen, device=device).to(pair[1])
    mesh = make_space_mesh(n, devices=[device] * n)
    before = (sharded_correlation7x7.launches, correlation7x7_cuda.launches)
    got = sharded_correlation7x7(f1, f2, mesh, stride)
    torch.cuda.synchronize()
    assert (sharded_correlation7x7.launches,
            correlation7x7_cuda.launches) == (before[0] + 1, before[1])
    want = correlation7x7_cuda(f1, f2, stride)
    assert got.shape == want.shape and got.device == f1.device
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_kernel_unaligned_rows_equal_aligned(device, dtype):
    """An f2 whose base is not on 16 bytes is staged element by element;
    the sums are those of the 16-byte copies of an aligned f2, bit for
    bit."""
    gen = torch.Generator(device=device).manual_seed(3)
    h, w, c = 34, 60, 64
    f1 = torch.randn((h, w, c), generator=gen, device=device).to(BF16)
    flat = torch.randn(h * w * c + 1, generator=gen, device=device).to(dtype)
    shifted = flat[1:].view(h, w, c)
    assert shifted.data_ptr() % 16
    torch.testing.assert_close(correlation7x7_cuda(f1, shifted, 1),
                               correlation7x7_cuda(f1, shifted.clone(), 1),
                               atol=0, rtol=0)


def test_uniform_on_card_matches_cpu(device):
    """The threefry draw on the card is the CPU's, bit for bit."""
    key = prng.split(prng.key(7), 3)[1]
    got = prng.uniform(key, (1080, 1920), device)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), prng.uniform(key, (1080, 1920)),
                               atol=0, rtol=0)


def test_slice_on_card_matches_cpu(device, exact_f32):
    from transflow_tpu_torch.config import LayerConfig
    from transflow_tpu_torch.model import FlowTransferModel
    h, w, frames = 64, 96, 3
    rng = np.random.default_rng(0)
    canvas = torch.from_numpy(rng.integers(0, 256, (h + 8, w + 8, 3),
                                           dtype=np.uint8))
    clip = [canvas[2 * i:2 * i + h, 2 * i:2 * i + w] for i in range(frames)]
    flows = {}
    for dev in (device, torch.device("cpu")):
        model = FlowTransferModel(h, w, [LayerConfig(0)],
                                  method="liteflownet", device=dev)
        state = model.init_state(clip[0])
        pix = model.default_pixmaps()
        keys = prng.split(prng.key(0), len(clip) - 1)
        before = (correlation7x7_cuda.launches, exact_backwarp_cuda.launches,
                  upsample2x_phases_cuda.launches, reg_apply_cuda.launches)
        out = []
        for frame, key in zip(clip[1:], keys):
            state, rgb = model.step(state, frame, pix, 0.0, key,
                                    model.default_frame_numbers())
            out.append(state["prev_flow"].cpu())
        launches = (correlation7x7_cuda.launches - before[0],
                    exact_backwarp_cuda.launches - before[1],
                    upsample2x_phases_cuda.launches - before[2],
                    reg_apply_cuda.launches - before[3])
        # a frame: 5 correlations (A1), 14 exact backwarps (B7), 6 phase
        # upsamples (B16) and 5 tap applies (B17)
        per_frame = (5, 14, 6, 5) if dev.type == "cuda" else (0, 0, 0, 0)
        assert launches == tuple(n * (frames - 1) for n in per_frame)
        flows[dev.type] = torch.stack(out)
    assert torch.isfinite(flows["cuda"]).all()
    torch.testing.assert_close(flows["cuda"], flows["cpu"], atol=1e-3,
                               rtol=1e-3)


# the B1/B2b tiles are 32x64 (where the grid gives every SM a block) and
# 16x32 outputs: levels smaller than one tile, one row or column past a
# tile, rows that do not start on 16 bytes (W = 45, 37, 961), and a
# 540x960 level (the 32x64 tiles) with one row and column more
FB_SHAPES = [(13, 21), (9, 37), (37, 45), (17, 33), (33, 65), (64, 96),
             (135, 240), (540, 960), (541, 961)]


@pytest.mark.parametrize("storage", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FB_SHAPES, ids=str)
def test_farneback_kernels_match_plain(device, shape, storage):
    """Every instantiation against its plain version: B1 with poly_n 5 and
    7 (register windows) and 2 (runtime count), float32 and storage-dtype
    input, one image and both in one launch; B2a (select radius 0, 3 and
    16, flows moving off the frame); B2b with a box of 15 (register
    windows), 4 and 21 (runtime count) and a Gaussian of 15 (register
    windows), on planes with a flat band where the old flow stays. Both
    keep the JAX function's rounding points and add every sum in the same
    order, fused multiply-adds only where the product is exact:
    bit-equal."""
    h, w = shape
    gen = torch.Generator(device=device).manual_seed(4)
    images = [torch.rand((h, w), generator=gen, device=device) * 255
              for _ in range(2)]
    for n in (5, 7, 2):
        for pair in (images, [image.to(storage) for image in images]):
            before = fb.poly_expansion_cuda.launches
            got = fb.poly_expansion_pair(*pair, n, 1.2, storage)
            single = fb.poly_expansion(pair[1], n, 1.2, storage)
            torch.cuda.synchronize()
            assert fb.poly_expansion_cuda.launches == before + 2
            want = fb.poly_expansion_pair_plain(*pair, n, 1.2, storage)
            for out, ref in zip((*got, single), (*want, want[1])):
                assert out.dtype == storage and out.shape == (h, w, 5)
                torch.testing.assert_close(out, ref, atol=0, rtol=0)
    polys = fb.poly_expansion_pair(*images, 5, 1.2, storage)
    flow = 6 * torch.randn((h, w, 2), generator=gen, device=device)
    for radius in (0, 3, 16):
        before = fb.update_equations_cuda.launches
        planes = fb.update_equations(*polys, flow, radius)
        torch.cuda.synchronize()
        assert fb.update_equations_cuda.launches == before + 1
        assert planes.dtype == storage and planes.shape == (6, h, w)
        torch.testing.assert_close(
            planes, fb.update_equations_plain(*polys, flow, radius),
            atol=0, rtol=0)
    planes[:, :, :w // 3] = 0
    for winsize, gaussian in ((15, False), (4, False), (21, False),
                              (15, True)):
        before = fb.aggregate_solve_cuda.launches
        got = fb.aggregate_solve(planes, flow, winsize, gaussian)
        torch.cuda.synchronize()
        assert fb.aggregate_solve_cuda.launches == before + 1
        torch.testing.assert_close(
            got, fb.aggregate_solve_plain(planes, flow, winsize, gaussian),
            atol=0, rtol=0)


# B2a's blocks: 32x8 outputs, one a thread: one row and column past a
# block (9x33, 17x65, 545x1025, 545x968), odd widths (37, 45, 961: rows
# that start on 2 bytes), and a 1080p level
B2A_SHAPES = [(9, 33), (17, 65), (9, 37), (37, 45), (135, 240), (541, 961),
              (545, 968), (545, 1025)]
B2A_FLOWS = ["zero", "pan", "smooth", "random", "edges", "corner", "far"]


def _b2a_flow(kind: str, h: int, w: int, gen, device) -> torch.Tensor:
    """(h, w, 2) f32 flows for B2a: none; the Engine's 3 px pan; a smooth
    field around it; 6 px normal; samples at random just inside and just
    outside each edge of the frame (the right edge's taps coincide); every
    sample on the stack's last pixel pair; every sample far off the frame,
    either side."""
    yy = torch.arange(h, device=device, dtype=F32)[:, None].expand(h, w)
    xx = torch.arange(w, device=device, dtype=F32)[None, :].expand(h, w)
    pos = torch.stack([xx, yy], -1)
    size = torch.tensor([w, h], device=device, dtype=F32)

    def pick(n):
        return torch.randint(0, n, (h, w, 2), generator=gen, device=device)

    if kind == "zero":
        flow = torch.zeros((h, w, 2), device=device)
    elif kind == "pan":
        flow = torch.full((h, w, 2), 3.0, device=device)
    elif kind == "smooth":
        flow = torch.stack([3 + 0.7 * torch.sin(xx / 5),
                            3 + 0.7 * torch.cos(yy / 4)], -1)
    elif kind == "random":
        flow = 6 * torch.randn((h, w, 2), generator=gen, device=device)
    elif kind == "edges":
        # targets -0.5, 0.25, S - 1.25, S - 0.75 and S + 2 on an axis of S
        k = pick(5)
        offset = torch.tensor([-0.5, 0.25, -1.25, -0.75, 2.0], device=device)
        flow = offset[k] + (k >= 2) * size - pos
    elif kind == "corner":
        flow = size - torch.tensor([1.5, 1.25], device=device) - pos
    else:
        flow = (2 * pick(2) - 1) * (
            size + torch.tensor([5.5, 7.25], device=device))
    return flow.contiguous()


@pytest.mark.parametrize("kind", B2A_FLOWS)
@pytest.mark.parametrize("storage", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", B2A_SHAPES, ids=str)
def test_update_equations_matches_plain_on_edge_flows(device, shape,
                                                      storage, kind):
    """Kernel B2a at select radius 0, 3 and 16 against its plain version
    where its blocks end, on flows whose warps share their tap rows or
    scatter, at the frame's edges (one tap where the right edge holds the
    pair) and at the stack's end: the same values in the same order, so
    bit-equal."""
    h, w = shape
    gen = torch.Generator(device=device).manual_seed(5)
    polys = [(100 * torch.randn((h, w, 5), generator=gen, device=device)
              ).to(storage) for _ in range(2)]
    flow = _b2a_flow(kind, h, w, gen, device)
    for radius in (0, 3, 16):
        before = fb.update_equations_cuda.launches
        got = fb.update_equations(*polys, flow, radius)
        torch.cuda.synchronize()
        assert fb.update_equations_cuda.launches == before + 1
        assert got.dtype == storage and got.shape == (6, h, w)
        torch.testing.assert_close(
            got, fb.update_equations_plain(*polys, flow, radius), atol=0,
            rtol=0)


@pytest.mark.parametrize("storage", [F32, BF16], ids=["f32", "bf16"])
def test_update_equations_unaligned_stacks(device, storage):
    """B2a on stacks and a flow whose base is not on 16 bytes: the same
    bits as the plain version."""
    h, w = 64, 96
    gen = torch.Generator(device=device).manual_seed(6)

    def shifted(shape, scale, dtype):
        n = int(np.prod(shape))
        flat = scale * torch.randn(n + 1, generator=gen, device=device)
        return flat.to(dtype)[1:].view(shape)

    polys = [shifted((h, w, 5), 100, storage) for _ in range(2)]
    flow = shifted((h, w, 2), 4, F32)
    assert all(t.data_ptr() % 16 for t in (*polys, flow))
    for radius in (0, 16):
        torch.testing.assert_close(
            fb.update_equations(*polys, flow, radius),
            fb.update_equations_plain(*polys, flow, radius), atol=0, rtol=0)


def test_farneback_on_card_matches_cpu(device, monkeypatch):
    """The estimator on the card (the kernels) against the CPU (the plain
    versions), float32 storage: >= 60 dB at an 8 px peak, the CPU tests'
    bar against JAX. B1 takes both images of a level in one launch, B8
    both images of each level below L0."""
    from transflow_tpu_torch.flow.estimators.farneback import farneback
    monkeypatch.setenv("TRANSFLOW_FARNEBACK_BF16", "0")
    rng = np.random.default_rng(0)
    canvas = torch.from_numpy(rng.integers(0, 256, (100, 140),
                                           dtype=np.uint8)).float()
    canvas = torch.nn.functional.avg_pool2d(canvas[None, None], 5, 1, 2)
    canvas = canvas[0, 0].round().to(torch.uint8)
    a, b = canvas[4:100, 6:134], canvas[2:98, 3:131]
    before = (fb.poly_expansion_cuda.launches,
              pyramid.pyramid_levels_cuda.launches)
    got = farneback(a.to(device), b.to(device), select_warp=0).cpu()
    # one B1 a level, one B8 for every level below L0
    assert (fb.poly_expansion_cuda.launches - before[0],
            pyramid.pyramid_levels_cuda.launches - before[1]) == (4, 1)
    want = farneback(a, b)
    mse = float(((got - want) ** 2).mean())
    assert mse == 0 or 10 * np.log10(64 / mse) >= 60.0


# B8's cases: (frame, level, sigma). The three levels of a 1080p frame at
# cv2's defaults (also fb_downscale 2, 4 and 8's pre-resize); the levels
# below fb_downscale 2 and 8's float32 images; fb_pyr_scale 0.8's first
# two levels (no whole ratio, radius 0 and 1); fb_levels 8's deepest three
# (radius 23, 47, 95: narrower tiles, the rows read through L2); an
# unaligned width and height; a level of one row
B8_CASES = [((1080, 1920), (540, 960), 0.5), ((1080, 1920), (270, 480), 1.5),
            ((1080, 1920), (135, 240), 3.5), ((540, 960), (270, 480), 0.5),
            ((540, 960), (68, 120), 3.5), ((135, 240), (68, 120), 0.5),
            ((135, 240), (34, 60), 1.5),
            ((1080, 1920), (864, 1536), 0.125),
            ((1080, 1920), (691, 1229), 0.28125),
            ((1080, 1920), (68, 120), 7.5), ((1080, 1920), (34, 60), 15.5),
            ((1080, 1920), (17, 30), 31.5), ((97, 131), (49, 66), 0.5),
            ((37, 45), (1, 3), 3.5)]


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", B8_CASES,
                         ids=[f"{a}->{b}" for a, b, _ in B8_CASES])
def test_pyramid_level_matches_plain(device, case, dtype):
    """Kernel B8 on both images of one level, and on one image, against
    its plain version on the card: bit-equal (both add every sum in one
    order, each product and sum rounded to float32); one launch a call,
    two for a deep level."""
    (h, w), (lh, lw), sigma = case
    gen = torch.Generator(device=device).manual_seed(h + lh)
    images = [torch.randint(0, 256, (h, w), generator=gen,
                            device=device).to(dtype) for _ in range(2)]
    if dtype == F32:
        images = [x + torch.rand((h, w), generator=gen, device=device)
                  for x in images]
    before = pyramid.pyramid_levels_cuda.launches
    got = pyramid.pyramid_levels(images, [(sigma, lh, lw)])[0]
    alone = pyramid.pyramid_levels(images[1:], [(sigma, lh, lw)])[0]
    torch.cuda.synchronize()
    assert pyramid.pyramid_levels_cuda.launches == before + 2 * (
        pyramid.launches(h, w, [(sigma, lh, lw)]))
    want = pyramid.pyramid_level_plain(images, sigma, lh, lw)
    for out, ref in zip((*got, *alone), (*want, want[1])):
        assert out.dtype == F32 and out.shape == (lh, lw)
        assert torch.equal(out, ref)


# B8's pyramids: (name, frame, pyr_scale, levels), each built as Farneback
# builds it (every level below L0 in one launch, a deep level's rows in
# one more): cv2's defaults at 1080p, fb_pyr_scale 0.8, fb_levels 8 (the
# deep route at its last level), the pyramids below fb_downscale 2's and
# 8's pre-resize (float32 images), odd frame sizes
PYRAMIDS = [("defaults", (1080, 1920), 0.5, 3),
            ("pyr_scale 0.8", (1080, 1920), 0.8, 3),
            ("levels 8", (1080, 1920), 0.5, 8),
            ("downscale 2", (540, 960), 0.5, 3),
            ("downscale 8", (135, 240), 0.5, 3),
            ("odd", (97, 131), 0.5, 3), ("odd 0.7", (181, 211), 0.7, 4)]


@pytest.mark.parametrize("images", [2, 1], ids=["both", "one"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name,shape,pyr_scale,levels", PYRAMIDS,
                         ids=[p[0] for p in PYRAMIDS])
def test_pyramid_levels_matches_plain(device, name, shape, pyr_scale, levels,
                                      dtype, images):
    """Kernel B8's one-launch pyramid (every level below L0 of one or two
    images) against its plain version on the card: bit-equal at every
    level, in ``pyramid.launches`` launches (two at fb_levels 8, whose last
    level is deep)."""
    from transflow_tpu_torch.flow.estimators import farneback as fb_est
    h, w = shape
    gen = torch.Generator(device=device).manual_seed(h + w + levels)
    frames = [torch.randint(0, 256, (h, w), generator=gen,
                            device=device).to(dtype) for _ in range(images)]
    if dtype == F32:
        frames = [x + torch.rand((h, w), generator=gen, device=device)
                  for x in frames]
    below = fb_est._pyramid_levels(fb_est._level_shapes(h, w, pyr_scale,
                                                        levels, 5))
    before = pyramid.pyramid_levels_cuda.launches
    got = pyramid.pyramid_levels(frames, below)
    torch.cuda.synchronize()
    count = pyramid.pyramid_levels_cuda.launches - before
    assert count == pyramid.launches(h, w, below) == 1 + (name == "levels 8")
    want = pyramid.pyramid_levels_plain(frames, below)
    assert len(got) == len(want) == len(below)
    for (_, lh, lw), outs, refs in zip(below, got, want):
        assert len(outs) == images
        for out, ref in zip(outs, refs):
            assert out.dtype == F32 and out.shape == (lh, lw)
            assert torch.equal(out, ref)


def test_pyramid_levels_cuda_refuses_cpu_tensors(device):
    """B8's wrapper takes CUDA tensors only: a CPU image raises before
    any launch, and so does a pair on two devices."""
    x = torch.zeros((64, 96))
    before = pyramid.pyramid_levels_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        pyramid.pyramid_levels_cuda((x, x), [(0.5, 32, 48)])
    with pytest.raises(ValueError, match="CUDA"):
        pyramid.pyramid_levels_cuda((x.to(device), x), [(0.5, 32, 48)])
    assert pyramid.pyramid_levels_cuda.launches == before


@pytest.mark.parametrize("shape", [(1080, 1920), (540, 960), (67, 121),
                                   (97, 131), (7, 5), (1, 1)], ids=str)
def test_downsample2x_matches_plain(device, shape):
    """Kernel B14 on both images in one launch against its plain version
    on the card: bit-equal, an odd size rounding up."""
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    images = [torch.rand(shape, generator=gen, device=device) * 255
              for _ in range(2)]
    before = pyramid.downsample2x_cuda.launches
    got = pyramid.downsample2x(images)
    torch.cuda.synchronize()
    assert pyramid.downsample2x_cuda.launches == before + 1
    for out, ref in zip(got, pyramid.downsample2x_plain(images)):
        assert out.shape == ((shape[0] + 1) // 2, (shape[1] + 1) // 2)
        assert torch.equal(out, ref)


# B14's pyramids: (frame, window, ...) for max_level 0 to 4; the 1080p
# frame at lukas-kanade.json's window (its max_level 2) and at a window
# that lets every level through (max_level 3 and 4 take a second launch)
LK_FRAMES = [((1080, 1920), 15), ((1080, 1920), 2), ((37, 53), 2),
             ((67, 121), 2), ((97, 131), 4), ((130, 257), 2), ((7, 5), 1),
             ((1, 1), 1), ((64, 96), 15)]


@pytest.mark.parametrize("max_level", range(5))
@pytest.mark.parametrize("shape,win", LK_FRAMES, ids=str)
def test_lk_pyramid_matches_plain(device, shape, win, max_level):
    """Kernel B14's pyramid of two uint8 frames (their float32 casts and
    every level below, both frames a launch) against its plain version on
    the card: the same levels, each bit-equal, in ``lk_launches``
    launches (one up to two levels below L0)."""
    gen = torch.Generator(device=device).manual_seed(sum(shape) + win)
    a, b = (torch.randint(0, 256, shape, generator=gen, device=device,
                          dtype=torch.uint8) for _ in "ab")
    before = pyramid.lk_pyramid_cuda.launches
    got = pyramid.lk_pyramid(a, b, win, max_level)
    torch.cuda.synchronize()
    shapes = pyramid.lk_shapes(*shape, win, max_level)
    assert pyramid.lk_pyramid_cuda.launches - before == pyramid.lk_launches(
        len(shapes))
    want = pyramid.lk_pyramid_plain(a, b, win, max_level)
    assert len(got) == len(want) == len(shapes)
    for level, ref, lshape in zip(got, want, shapes):
        for out, r in zip(level, ref):
            assert out.dtype == F32 and tuple(out.shape) == lshape
            assert out.is_contiguous() and torch.equal(out, r)


@pytest.mark.parametrize("shape,offset", [((1080, 1920), 1), ((64, 96), 3),
                                          ((37, 53), 0)], ids=str)
def test_lk_pyramid_unaligned_frames(device, shape, offset):
    """B14 on frames that start ``offset`` bytes into a buffer (rows not
    16-byte aligned: element-wise staging; float4 stores stay on the
    outputs): bit-equal to its plain version, one launch."""
    h, w = shape
    gen = torch.Generator(device=device).manual_seed(h)
    frames = []
    for _ in "ab":
        buf = torch.randint(0, 256, (h * w + 16,), generator=gen,
                            device=device, dtype=torch.uint8)
        frames.append(buf[offset:offset + h * w].view(h, w))
    before = pyramid.lk_pyramid_cuda.launches
    got = pyramid.lk_pyramid(*frames, 2, 2)
    torch.cuda.synchronize()
    assert pyramid.lk_pyramid_cuda.launches == before + 1
    for level, ref in zip(got, pyramid.lk_pyramid_plain(*frames, 2, 2)):
        assert all(torch.equal(x, y) for x, y in zip(level, ref))


def test_lk_pyramid_cuda_refuses_misuse(device):
    """B14's pyramid takes two contiguous (H, W) uint8 frames of one shape
    on one CUDA device: CPU frames, float32 frames, mismatched shapes, two
    devices and a non-contiguous frame raise before any launch."""
    a = torch.zeros((64, 96), dtype=torch.uint8)
    x = a.to(device)
    before = pyramid.lk_pyramid_cuda.launches
    for prev, nxt, match in ((a, a, "CUDA"), (x.float(), x.float(), "uint8"),
                             (x, x[:, :90], "uint8"), (x, a, "uint8"),
                             (x.t(), x.t(), "contiguous")):
        with pytest.raises(ValueError, match=match):
            pyramid.lk_pyramid_cuda(prev, nxt, 4, 2)
    assert pyramid.lk_pyramid_cuda.launches == before


@pytest.mark.parametrize("shape", [(1080, 1920), (540, 960), (67, 121),
                                   (7, 5), (1, 1)], ids=str)
def test_downsample2x_one_image_matches_plain(device, shape):
    """``ops/image.py::downsample2x`` (B14's one reduce of one float32
    image) against its plain version on the card: bit-equal, one launch;
    a uint8 image is cast first, as on the CPU."""
    from transflow_tpu_torch.ops import image
    gen = torch.Generator(device=device).manual_seed(sum(shape) + 1)
    x = torch.rand(shape, generator=gen, device=device) * 255
    before = pyramid.downsample2x_cuda.launches
    got = image.downsample2x(x)
    torch.cuda.synchronize()
    assert pyramid.downsample2x_cuda.launches == before + 1
    assert torch.equal(got, pyramid.downsample2x_plain((x,))[0])
    u8 = x.to(torch.uint8)
    assert torch.equal(image.downsample2x(u8),
                       pyramid.downsample2x_plain((u8.float(),))[0])


def test_pyramids_never_take_the_plain_path(device, monkeypatch):
    """On the card Farneback (with fb_downscale 2) and Lucas-Kanade build
    their pyramids through B8 and B14 alone: the plain versions raise if
    called, and the launch counters move by the estimators' rules
    (Lucas-Kanade's whole pyramid in one B14 launch)."""
    from transflow_tpu_torch.flow.estimators import farneback as fb_est
    from transflow_tpu_torch.flow.estimators.lucas_kanade import (
        lucas_kanade)

    def refuse(*args):
        raise AssertionError("a plain pyramid version ran on the card")

    monkeypatch.setattr(pyramid, "pyramid_level_plain", refuse)
    monkeypatch.setattr(pyramid, "pyramid_levels_plain", refuse)
    monkeypatch.setattr(pyramid, "downsample2x_plain", refuse)
    monkeypatch.setattr(pyramid, "lk_pyramid_plain", refuse)
    gen = torch.Generator(device=device).manual_seed(9)
    a, b = (torch.randint(0, 256, (192, 256), generator=gen, device=device,
                          dtype=torch.uint8) for _ in "ab")
    before = (pyramid.pyramid_levels_cuda.launches,
              pyramid.lk_pyramid_cuda.launches)
    fb_est.farneback(a, b, downscale=2)
    lucas_kanade(a, b)
    torch.cuda.synchronize()
    assert (pyramid.pyramid_levels_cuda.launches - before[0],
            pyramid.lk_pyramid_cuda.launches - before[1]) == (
        fb_est.launches_per_frame(192, 256, downscale=2)[3], 1)


def test_pyramid_level_limit(device):
    """A level whose single output column needs more shared memory than
    the H100 gives (radius 60000) raises before any launch, naming the
    bytes."""
    x = torch.zeros((16, 60000), device=device)
    before = pyramid.pyramid_levels_cuda.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        pyramid.pyramid_levels((x,), [(20000.0, 16, 12)])
    assert pyramid.pyramid_levels_cuda.launches == before


def test_entry_points_default_to_the_card(device, exact_f32):
    """With no ``device`` the model and the Engine run on the current CUDA
    device, the network included."""
    from transflow_tpu_torch.config import Config
    from transflow_tpu_torch.engine import Engine
    from transflow_tpu_torch.model import FlowTransferModel
    model = FlowTransferModel(32, 48, method="liteflownet")
    assert model.device == device
    assert next(model.net.parameters()).device == device
    assert model.layer_params[0].intro_masks[0].device == device
    assert Engine(Config("in.mp4"), [], [], 32, 48).device == device


def test_cli_on_card_matches_cpu(device, monkeypatch, tmp_path):
    """The CLI disk to disk on a small PGM sequence, on the card and on
    the CPU (float32 storage): the exported flows within the 60 dB bar;
    then both devices replay the CPU's flows, and the compositor's frames
    are bit-equal."""
    from transflow_tpu_torch import cli
    from transflow_tpu_torch.flow.sources.archive import ArchiveFlowSource
    from transflow_tpu_torch.utils.imageio import read_netpbm, write_netpbm
    monkeypatch.setenv("TRANSFLOW_FARNEBACK_BF16", "0")
    rng = np.random.default_rng(1)
    canvas = torch.from_numpy(rng.integers(0, 256, (80, 110),
                                           dtype=np.uint8)).float()
    canvas = torch.nn.functional.avg_pool2d(canvas[None, None], 5, 1, 2)
    canvas = canvas[0, 0].round().to(torch.uint8).numpy()
    (tmp_path / "frames").mkdir()
    for i in range(6):
        write_netpbm(str(tmp_path / "frames" / f"{i:04d}.pgm"),
                     canvas[2 * i:2 * i + 64, 3 * i:3 * i + 96])

    def run(source, out, where, *extra):
        (tmp_path / out).mkdir()
        pipeline = cli.main(
            [str(source), "-p", "noise", "--seed", "0", "-r", "random",
             "0.1", "-o", str(tmp_path / out / "%04d.ppm"), "--no-exec",
             *extra], device=where)
        assert pipeline.engine.device.type == ("cuda" if where is None
                                               else where)
        return [read_netpbm(str(tmp_path / out / f"{i:04d}.ppm"))
                for i in range(5)]

    def flows(path):
        source = ArchiveFlowSource(str(path)).open()
        out = np.stack([np.array(item.array) for item in source])
        source.close()
        return out

    sequence = tmp_path / "frames" / "%04d.pgm"
    run(sequence, "card", None, "-F")
    run(sequence, "cpu", "cpu", "-F")
    got, want = (flows(tmp_path / d / "%04d.flow.zip")
                 for d in ("card", "cpu"))
    assert got.shape == want.shape == (5, 64, 96, 2)
    mse = float(((got - want) ** 2).mean())
    assert mse == 0 or 10 * np.log10(64 / mse) >= 60.0
    archive = tmp_path / "cpu" / "%04d.flow.zip"
    for a, b in zip(run(archive, "replay_card", None),
                    run(archive, "replay_cpu", "cpu")):
        np.testing.assert_array_equal(a, b)


def _b5_flows(h, w, device):
    """Forward flows for B5: random, converging on one pixel (every
    atomic on one word), half-integers (round half to even), mostly off
    the frame, and a constant (W/2, 0) whose right half of each row clips
    onto the row's last pixel."""
    gen = torch.Generator(device=device).manual_seed(5)
    ii = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    jj = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    converge = torch.stack([(w // 2 - jj).expand(h, w),
                            (h // 2 - ii).expand(h, w)], dim=-1)
    halves = torch.randint(-8, 9, (h, w, 2), generator=gen,
                           device=device).float() + 0.5
    edge = torch.zeros((h, w, 2), device=device)
    edge[..., 0] = w / 2
    return {"random": torch.randn((h, w, 2), generator=gen,
                                  device=device) * 6,
            "converge": converge.contiguous(), "halves": halves,
            "leave": torch.randn((h, w, 2), generator=gen,
                                 device=device) * 4 * max(h, w),
            "edge": edge}


B5_KINDS = ["random", "converge", "halves", "leave", "edge"]


@pytest.mark.parametrize("kind", B5_KINDS)
@pytest.mark.parametrize("shape", [(1, 1), (7, 5), (48, 64), (135, 240),
                                   (270, 481)], ids=str)
def test_forward_to_backward_matches_plain(device, shape, kind):
    """Kernel B5 against its plain version on the same flow: bit-equal
    (exact integers, and the winner is a maximum, so no order of the
    atomics shows); two launches per call; the dispatcher takes the
    kernel for a CUDA tensor."""
    from transflow_tpu_torch.ops import scatter
    h, w = shape
    flow = _b5_flows(h, w, device)[kind]
    before = scatter.forward_to_backward_cuda.launches
    got = scatter.forward_to_backward(flow)
    torch.cuda.synchronize()
    assert scatter.forward_to_backward_cuda.launches == before + 2
    want = scatter.forward_to_backward_plain(flow)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), scatter.forward_to_backward_plain(
        flow.cpu()))


def test_forward_to_backward_1080p_converge(device):
    """B5 at 1080x1920 with every pixel converging on the centre (one
    word wins against 2 M writers): bit-equal to the plain version."""
    from transflow_tpu_torch.ops import scatter
    flow = _b5_flows(1080, 1920, device)["converge"]
    got = scatter.forward_to_backward_cuda(flow)
    assert torch.equal(got, scatter.forward_to_backward_plain(flow))
    assert int((got != 0).any(-1).sum()) == 1


def test_forward_to_backward_back_to_back(device):
    """Calls in a row on one stream with no sync between, on flows that
    differ: each bit-equal to the plain version, so no call sees the
    winners of the one before (their words carry an older epoch); a call
    at another size between them takes its own scratch."""
    from transflow_tpu_torch.ops import scatter
    flows = [_b5_flows(48, 64, device)[k]
             for k in ("converge", "random", "edge", "leave")]
    flows.insert(2, torch.zeros((48, 64, 2), device=device))
    flows += [_b5_flows(135, 240, device)["random"],
              _b5_flows(48, 64, device)["halves"],
              torch.zeros((48, 64, 2), device=device)]
    outs = [scatter.forward_to_backward_cuda(f) for f in flows]
    torch.cuda.synchronize()
    for flow, got in zip(flows, outs):
        assert torch.equal(got, scatter.forward_to_backward_plain(flow))
    assert not bool(outs[2].any()) and not bool(outs[-1].any())


def test_forward_to_backward_epoch_wrap(device):
    """600 calls in a row at one size, on flows that take turns, each
    bit-equal to the plain version: the scratch's epoch runs out twice
    (every 255 calls the resolve clears the words and the epoch starts
    again), so the calls just before and after a restart are held too."""
    from transflow_tpu_torch.ops import scatter
    flows = list(_b5_flows(48, 64, device).values())
    wants = [scatter.forward_to_backward_plain(f) for f in flows]
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    key = (device.index, stream.cuda_stream, 48 * 64)
    scatter._WINNERS.pop(key, None)   # a fresh scratch: epoch 0
    with torch.cuda.stream(stream):
        outs = [scatter.forward_to_backward_cuda(flows[k % len(flows)])
                for k in range(600)]
    torch.cuda.synchronize()
    for k, got in enumerate(outs):
        assert torch.equal(got, wants[k % len(flows)]), k
    assert scatter._WINNERS[key][-2:].tolist() == [600 - 2 * 255] * 2


def test_forward_to_backward_two_streams(device):
    """Calls on two streams at once each take their own zeroed scratch
    and are bit-equal to the plain version."""
    from transflow_tpu_torch.ops import scatter
    kinds = B5_KINDS * 2
    flows = [_b5_flows(135, 240, device)[k] for k in kinds]
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(device))
    for k, flow in enumerate(flows):
        with torch.cuda.stream(streams[k % 2]):
            outs.append(scatter.forward_to_backward_cuda(flow))
    torch.cuda.synchronize()
    for flow, got in zip(flows, outs):
        assert torch.equal(got, scatter.forward_to_backward_plain(flow))
    keys = {(device.index, s.cuda_stream, 135 * 240) for s in streams}
    assert keys <= set(scatter._WINNERS)
    assert len({scatter._WINNERS[k].data_ptr() for k in keys}) == 2


def test_forward_to_backward_unaligned_flow(device):
    """A flow that starts 8 bytes past a 16-byte boundary (a view into a
    larger buffer) goes through the kernel's 16-byte reads as a copy:
    bit-equal, two launches."""
    from transflow_tpu_torch.ops import scatter
    h, w = 48, 64
    buf = torch.empty(h * w * 2 + 2, device=device)
    flow = buf[2:].view(h, w, 2)
    flow.copy_(_b5_flows(h, w, device)["random"])
    assert flow.data_ptr() % 16 == 8
    before = scatter.forward_to_backward_cuda.launches
    got = scatter.forward_to_backward_cuda(flow)
    assert scatter.forward_to_backward_cuda.launches == before + 2
    assert torch.equal(got, scatter.forward_to_backward_plain(flow))


def test_postprocess_chain_on_card_matches_cpu(device):
    """The backward chain (filters with polar, a fractional mask, a 5x5
    kernel, the clip) on the card against the CPU: the transcendental
    functions and cuDNN's convolution (TF32 off) differ in rounding only,
    so within the CPU tests' bound for the convolution."""
    from transflow_tpu_torch.flow import Direction
    from transflow_tpu_torch.flow.transforms import make_postprocess
    h, w = 64, 96
    rng = np.random.default_rng(3)
    ii, jj = np.indices((h, w))
    mask = ((ii * 9 + jj * 5) % 256 / 255.0).astype(np.float32)
    kernel = rng.random((5, 5)).astype(np.float32)
    flow = torch.from_numpy((rng.standard_normal((h, w, 2)) * 3)
                            .astype(np.float32))
    text = "scale=1.5;clip=8;polar=r:a+0.1*t"
    outs = {}
    for where in (device, "cpu"):
        pp = make_postprocess(text, mask, kernel, Direction.BACKWARD,
                              device=where)
        outs[str(where)] = pp(flow.to(where), np.float32(0.5)).cpu()
    scale = np.abs(kernel).sum() * 12
    assert (outs[str(device)] - outs["cpu"]).abs().max() <= 1e-5 * scale


# ---------------------------------------------------------------------------
# Horn-Schunck (B9, B10) and Lucas-Kanade (B11, B12)
# ---------------------------------------------------------------------------

# odd shapes off the tiles, and the 1080p shapes: the frame (B9, B10, L0)
# and Lucas-Kanade's two pyramid levels
CLASSIC_SHAPES = [(1, 1), (2, 3), (7, 5), (17, 33), (37, 45), (135, 241),
                  (270, 480), (540, 960), (1080, 1920)]


def _hs_flow(h, w, gen, device):
    return torch.randn((h, w, 2), generator=gen, device=device) * 2


def _check_horn_schunck_kernels(device, shape, alpha, frames=None):
    """B9's planes bit-equal to the plain version's (exact but for denom's
    two fused multiply-adds, emulated exactly there) and the control block
    zeroed; then four B10 launches from a random flow, each flow bit-equal,
    the iteration count equal, under a delta that stops after the third
    step (between the plain version's norms), no delta, and delta 0.
    ``frames`` maps the two frames before B9 (default: as they are)."""
    h, w = shape
    gen = torch.Generator(device=device).manual_seed(h * w)
    a = torch.randint(0, 256, shape, generator=gen, device=device,
                      dtype=torch.uint8)
    b = torch.randint(0, 256, shape, generator=gen, device=device,
                      dtype=torch.uint8)
    if frames is not None:
        a, b = frames(a), frames(b)
    before = hs.hs_derivatives_cuda.launches
    planes, control = hs.hs_derivatives(a, b, alpha)
    torch.cuda.synchronize()
    assert hs.hs_derivatives_cuda.launches == before + 1
    want, _ = hs.hs_derivatives_plain(a.cpu(), b.cpu(), alpha)
    assert torch.equal(planes.cpu(), want)
    assert control.tolist() == [0] * hs.CONTROL_WORDS
    flow0 = _hs_flow(h, w, gen, device)
    # the plain version's step norms, for a delta between steps 2 and 3
    norms, f, ctl = [], flow0.cpu(), torch.zeros(4, dtype=torch.int32)
    for _ in range(3):
        new = hs.hs_iterate_plain(want, f, ctl, None)
        norms.append(float((new[..., 0] - f[..., 0]).double().square()
                           .sum().sqrt()))
        f = new
    deltas = [None, 0.0]
    if norms[1] > norms[2] * 1.001:
        deltas.append((norms[1] * norms[2]) ** 0.5)
    for delta in deltas:
        control = torch.zeros(4, dtype=torch.int32, device=device)
        plain_control = torch.zeros(4, dtype=torch.int32)
        got, ref = flow0.contiguous(), flow0.cpu()
        for step in range(4):
            got = hs.hs_iterate(planes, got, control, delta)
            ref = hs.hs_iterate_plain(want, ref, plain_control, delta)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), ref), (delta, step)
            assert control.tolist()[:3] == plain_control.tolist()[:2] + [0]
        if delta is not None and delta > 0:
            assert control.tolist()[:2] == [1, 3]


@pytest.mark.parametrize("alpha", [1.0, 0.01])
@pytest.mark.parametrize("shape", CLASSIC_SHAPES, ids=str)
def test_horn_schunck_kernels_match_plain(device, shape, alpha):
    _check_horn_schunck_kernels(device, shape, alpha)


# shapes across the kernels' tiles: B10's 16x32 tile and B9's 32x64 each
# +-1 in H and W, one strip of 2 rows +-1, an odd W at the 1080p height
# (4,080 tiles: every block of B10's fixed grid walks several), 1x1, and
# frames with interior blocks (B9's 4-byte word loads)
TILE_SHAPES = [(15, 31), (15, 33), (17, 31), (17, 33), (16, 32), (31, 63),
               (31, 65), (33, 63), (33, 65), (32, 64), (1, 40), (2, 40),
               (3, 40), (1080, 1919), (1, 1), (100, 200), (135, 256)]


@pytest.mark.parametrize("alpha", [1.0, 0.01])
@pytest.mark.parametrize("shape", TILE_SHAPES, ids=str)
def test_horn_schunck_kernels_match_plain_across_tiles(device, shape, alpha):
    _check_horn_schunck_kernels(device, shape, alpha)


def _unaligned(frame):
    """``frame`` copied to a contiguous view one byte past an aligned
    address: B9 reads such frames byte by byte."""
    h, w = frame.shape
    buf = torch.empty(h * w + 1, dtype=torch.uint8, device=frame.device)
    out = buf[1:].view(h, w)
    out.copy_(frame)
    return out


@pytest.mark.parametrize("shape", [(100, 200), (135, 256)], ids=str)
def test_horn_schunck_kernels_match_plain_on_unaligned_frames(device, shape):
    _check_horn_schunck_kernels(device, shape, 1.0, frames=_unaligned)


def _hs_iterate_entry(planes, flow, control, delta, partials, count=None):
    """B10 through its raw C entry with the caller's ``partials`` (``count``
    of them, default all): the new flow."""
    from transflow_tpu_torch._device import cuda_stream, kernel_library
    h, w = flow.shape[:2]
    out = torch.empty_like(flow)
    kernel_library().call(
        "transflow_hs_iterate", planes.data_ptr(), flow.data_ptr(),
        out.data_ptr(), control.data_ptr(), partials.data_ptr(),
        partials.numel() if count is None else count, h, w, delta, 1,
        cuda_stream(flow))
    return out


def test_horn_schunck_iterate_is_deterministic(device):
    """Two runs of B10 at 1080x1920 from the same inputs (three steps under
    a delta between two of the norms) give the same flows, control words
    and partial sums, bit for bit."""
    gen = torch.Generator(device=device).manual_seed(3)
    a, b = (torch.randint(0, 256, (1080, 1920), generator=gen, device=device,
                          dtype=torch.uint8) for _ in "ab")
    planes, _ = hs.hs_derivatives(a, b, 1.0)
    flow0 = _hs_flow(1080, 1920, gen, device)
    runs = []
    for _ in range(2):
        control = torch.zeros(4, dtype=torch.int32, device=device)
        partials = torch.full((hs.iterate_partials(1080, 1920),),
                              float("nan"), dtype=torch.float64,
                              device=device)
        flows, flow = [], flow0
        for _ in range(3):
            flow = _hs_iterate_entry(planes, flow, control, 0.5, partials)
            flows.append(flow)
        torch.cuda.synchronize()
        runs.append((torch.stack(flows), control.clone(), partials.clone()))
    (f1, c1, p1), (f2, c2, p2) = runs
    assert torch.equal(f1, f2) and torch.equal(c1, c2)
    assert torch.equal(p1.view(torch.int64), p2.view(torch.int64))
    assert not p1.isnan().any()


def test_horn_schunck_iterate_needs_its_partials(device):
    """B10 takes exactly ``iterate_partials(H, W)`` partial sums, the
    kernel's own count: one fewer is refused at the launch."""
    h, w = 135, 241
    a = torch.zeros((h, w), dtype=torch.uint8, device=device)
    planes, control = hs.hs_derivatives(a, a, 1.0)
    flow = torch.zeros((h, w, 2), device=device)
    n = hs.iterate_partials(h, w)
    partials = torch.empty(n, dtype=torch.float64, device=device)
    _hs_iterate_entry(planes, flow, control, 1.0, partials)
    with pytest.raises(RuntimeError, match="transflow_hs_iterate"):
        _hs_iterate_entry(planes, flow, control, 1.0, partials, n - 1)
    torch.cuda.synchronize()
    assert control.tolist()[:2] == [1, 1]


def test_horn_schunck_static_pair_stops_on_the_card(device):
    """A static pair at 1080x1920: the first step's norm is 0, so one
    iteration is taken and the later launches copy through; the count is
    read once, after the frame."""
    from transflow_tpu_torch.flow.estimators.horn_schunck import (
        horn_schunck_counted)
    gen = torch.Generator(device=device).manual_seed(1)
    a = torch.randint(0, 256, (1080, 1920), generator=gen, device=device,
                      dtype=torch.uint8)
    before = hs.hs_iterate_cuda.launches
    flow, iters = horn_schunck_counted(a, a, max_iters=5)
    assert hs.hs_iterate_cuda.launches == before + 5
    assert int(iters) == 1 and not flow.any()


def test_horn_schunck_on_card_matches_cpu(device):
    """The estimator at 128x192 on the card against the CPU, the presets'
    settings and a warm start: bit-equal (B9's arithmetic is exact, B10
    rounds as its plain version does)."""
    from transflow_tpu_torch.flow.estimators.horn_schunck import (
        horn_schunck_counted)
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.integers(0, 256, (128, 192),
                                          dtype=np.uint8)) for _ in "ab")
    prev = torch.from_numpy(rng.standard_normal((128, 192, 2))
                            .astype(np.float32))
    for kwargs in ({}, dict(alpha=0.01, max_iters=1, decay=1.0),
                   dict(alpha=10.0, max_iters=1, decay=0.9),
                   dict(max_iters=20, delta=None)):
        got, iters = horn_schunck_counted(a.to(device), b.to(device),
                                          prev.to(device), **kwargs)
        want, want_iters = horn_schunck_counted(a, b, prev, **kwargs)
        assert torch.equal(got.cpu(), want), kwargs
        assert int(iters) == int(want_iters)


@pytest.mark.parametrize("win", [15, 7, 63])
@pytest.mark.parametrize("shape", CLASSIC_SHAPES, ids=str)
def test_lucas_kanade_kernels_match_plain(device, shape, win):
    """B11 on a flow with a tenth of its pixels moving far beyond the
    frame and some inf and NaN entries, B12's tensor mode and its solve
    (cv2's window of 15 at a compile-time count; 7 and 63, the largest,
    at a runtime count, 63 above 48 KB of shared memory): each bit-equal
    to its plain version (NaN where it is NaN)."""
    h, w = shape
    gen = torch.Generator(device=device).manual_seed(h + w)
    prev, nxt = (torch.rand(shape, generator=gen, device=device) * 255
                 for _ in "ab")
    ix, iy = (torch.randn(shape, generator=gen, device=device) * 20
              for _ in "xy")
    flow = torch.randn((h, w, 2), generator=gen, device=device) * 4
    flow.view(-1)[::10] *= 1e6
    flow.view(-1)[3::17] = float("nan")
    flow.view(-1)[5::19] = float("inf")
    before = (lk.lk_warp_products_cuda.launches,
              lk.lk_window_solve_cuda.launches)
    planes = lk.lk_warp_products(prev, nxt, ix, iy, flow)
    want = lk.lk_warp_products_plain(prev.cpu(), nxt.cpu(), ix.cpu(),
                                     iy.cpu(), flow.cpu())
    torch.cuda.synchronize()
    torch.testing.assert_close(planes.cpu(), want, rtol=0, atol=0,
                               equal_nan=True)
    tensor = lk.lk_structure_tensor(ix, iy, win)
    want_tensor = lk.lk_structure_tensor_plain(ix.cpu(), iy.cpu(), win)
    assert torch.equal(tensor.cpu(), want_tensor)
    # the solve on finite products and a finite flow
    planes = torch.randn((2, h, w), generator=gen, device=device) * 100
    flow = torch.randn((h, w, 2), generator=gen, device=device)
    got = lk.lk_window_solve(planes, tensor, flow, win, 0.01)
    want = lk.lk_window_solve_plain(planes.cpu(), want_tensor, flow.cpu(),
                                    win, 0.01)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert (lk.lk_warp_products_cuda.launches,
            lk.lk_window_solve_cuda.launches) == (before[0] + 1,
                                                   before[1] + 2)


def test_lucas_kanade_window_limit(device):
    """B12 takes windows of 1 to 63 pixels; a larger one raises before any
    launch."""
    ix = torch.zeros((40, 50), device=device)
    before = lk.lk_window_solve_cuda.launches
    with pytest.raises(ValueError, match="1 to 63"):
        lk.lk_structure_tensor(ix, ix, 64)
    assert lk.lk_window_solve_cuda.launches == before


def test_lucas_kanade_on_card_matches_cpu(device):
    """The estimator at 128x192 on the card against the CPU on a pan:
    every step is a kernel (B14, B15, B13, B12, B11) bit-equal to the
    plain version the CPU runs, so the flows are equal; 30 B11, 33 B12, 1
    B14 launch (the whole pyramid), 3 B13 and 2 B15 at three levels."""
    from transflow_tpu_torch.flow.estimators.lucas_kanade import (
        lucas_kanade)
    rng = np.random.default_rng(3)
    canvas = torch.from_numpy(rng.integers(0, 256, (140, 210),
                                           dtype=np.uint8)).float()
    canvas = torch.nn.functional.avg_pool2d(canvas[None, None], 5, 1, 2)
    canvas = canvas[0, 0].round().to(torch.uint8)
    a, b = canvas[6:134, 9:201], canvas[3:131, 5:197]
    counters = (lk.lk_warp_products_cuda, lk.lk_window_solve_cuda,
                pyramid.lk_pyramid_cuda, lk.lk_scharr_cuda,
                pyramid.resize_flow_cuda)
    before = [fn.launches for fn in counters]
    got = lucas_kanade(a.to(device), b.to(device)).cpu()
    assert tuple(fn.launches - n for fn, n in zip(counters, before)) == (
        30, 33, 1, 3, 2)
    want = lucas_kanade(a, b)
    assert torch.equal(got, want)
    assert want.abs().max() > 1.0


# B13's shapes: CLASSIC_SHAPES and one-row and one-column levels
SCHARR_SHAPES = CLASSIC_SHAPES + [(1, 97), (97, 1), (33, 1920)]


@pytest.mark.parametrize("shape", SCHARR_SHAPES, ids=str)
def test_lk_scharr_matches_plain(device, shape):
    """B13: both derivatives in one launch, each bit-equal to the plain
    version on a level of integers and on one of arbitrary floats (with
    zeros, so that a sum of signed zeros shows)."""
    gen = torch.Generator(device=device).manual_seed(sum(shape))
    whole = torch.randint(0, 256, shape, generator=gen, device=device,
                          dtype=torch.int32).float()
    floats = torch.randn(shape, generator=gen, device=device) * 50
    floats.view(-1)[::7] = 0.0
    for image in (whole, floats):
        before = lk.lk_scharr_cuda.launches
        ix, iy = lk.lk_scharr(image)
        assert lk.lk_scharr_cuda.launches == before + 1
        want_x, want_y = lk.lk_scharr_plain(image.cpu())
        torch.cuda.synchronize()
        assert ix.shape == iy.shape == shape
        assert ix.is_contiguous() and iy.is_contiguous()
        assert torch.equal(ix.cpu(), want_x) and torch.equal(iy.cpu(),
                                                             want_y)
        assert torch.equal(torch.signbit(ix.cpu()), torch.signbit(want_x))


def test_lk_scharr_cuda_refuses_misuse(device):
    """A CPU, non-contiguous, 3-D or bf16 image raises before any
    launch."""
    before = lk.lk_scharr_cuda.launches
    x = torch.zeros((16, 24), device=device)
    for bad in (x.cpu(), x.t(), x[None], x.to(BF16)):
        with pytest.raises(ValueError):
            lk.lk_scharr_cuda(bad)
    assert lk.lk_scharr_cuda.launches == before


# B15's cases: (source, target, scale): Farneback's flagship transitions at
# 1080p, the fast and fastest upscales to full size, fb_pyr_scale 0.8's
# last transition (no whole ratio), a warm start's fb_downscale 2 and 4
# pre-resizes (bands of 4 and 8 taps), Lucas-Kanade's transitions on a
# 1080p frame and on an odd one, an equal size, a one-row flow; then the
# edges of B15's tiles (ops/pyramid.py::resize_plan): outputs that are no
# multiple of a tile, an odd width (8-byte copies) whose last bands end
# at the last input column, a ratio that is not whole whose bands end at
# the last input row and column, the 8-tap downscale's shrunk 1 x 128
# tile over columns that do not fill the last one, an output smaller
# than one tile, and a downscale whose 240 input rows a tile stages a
# slab at a time
RESIZE_CASES = [((135, 240), (270, 480), 2.0), ((270, 480), (540, 960), 2.0),
                ((540, 960), (1080, 1920), 2.0),
                ((270, 480), (1080, 1920), 4.0),
                ((864, 1536), (1080, 1920), 1.25),
                ((1080, 1920), (540, 960), 0.5),
                ((1080, 1920), (270, 480), 0.25),
                ((34, 61), (67, 121), 2.0), ((37, 45), (37, 45), 0.5),
                ((1, 7), (1, 13), 2.0), ((5, 3), (1, 1), 0.1),
                ((541, 961), (1081, 1921), 2.0),
                ((67, 99), (134, 198), 2.0),
                ((100, 200), (250, 500), 2.5),
                ((1080, 1900), (270, 475), 0.25),
                ((7, 11), (13, 21), 2.0),
                ((1080, 1920), (9, 16), 1 / 120)]


@pytest.mark.parametrize("case", RESIZE_CASES,
                         ids=[f"{a}->{b}" for a, b, _ in RESIZE_CASES])
def test_resize_flow_matches_plain(device, case):
    """B15: one launch, bit-equal to the plain version, on a random flow
    with inf and NaN entries (NaN where it is NaN)."""
    (h, w), (lh, lw), scale = case
    gen = torch.Generator(device=device).manual_seed(h * w)
    flow = torch.randn((h, w, 2), generator=gen, device=device) * 8
    flow.view(-1)[3::101] = float("nan")
    flow.view(-1)[5::103] = float("-inf")
    before = pyramid.resize_flow_cuda.launches
    got = pyramid.resize_flow(flow, lh, lw, scale)
    assert pyramid.resize_flow_cuda.launches == before + 1
    want = pyramid.resize_flow_plain(flow.cpu(), lh, lw, scale)
    torch.cuda.synchronize()
    assert got.shape == (lh, lw, 2) and got.is_contiguous()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0,
                               equal_nan=True)


def test_resize_flow_cuda_refuses_misuse(device):
    """A CPU, non-contiguous, one-channel or float64 flow, or a size below
    1, raises before any launch."""
    before = pyramid.resize_flow_cuda.launches
    flow = torch.zeros((16, 24, 2), device=device)
    for bad, size in ((flow.cpu(), (8, 12)), (flow.transpose(0, 1), (8, 12)),
                      (flow[..., :1], (8, 12)), (flow.double(), (8, 12)),
                      (flow, (0, 12))):
        with pytest.raises(ValueError):
            pyramid.resize_flow_cuda(bad, *size, 2.0)
    assert pyramid.resize_flow_cuda.launches == before


@pytest.mark.parametrize("settings", [{}, {"downscale": 2},
                                      {"downscale": 4, "flags": 4}],
                         ids=["defaults", "fast", "warm fastest"])
def test_farneback_resizes_through_b15_on_card(device, monkeypatch,
                                               settings):
    """Farneback on the card never takes the plain resize and launches
    B15 as ``launches_per_frame`` says; float32 storage, so the flow
    equals the CPU's (every step a kernel bit-equal to its plain
    version)."""
    from transflow_tpu_torch.flow.estimators import farneback as fb_est
    monkeypatch.setenv("TRANSFLOW_FARNEBACK_BF16", "0")
    gen = torch.Generator(device=device).manual_seed(4)
    a, b = (torch.randint(0, 256, (192, 256), generator=gen, device=device,
                          dtype=torch.uint8) for _ in "ab")
    prev = torch.randn((192, 256, 2), generator=gen, device=device)
    want = fb_est.farneback(a.cpu(), b.cpu(), prev.cpu(), **settings)

    def refuse(*args):
        raise AssertionError("the plain resize ran on the card")

    monkeypatch.setattr(pyramid, "resize_flow_plain", refuse)
    before = pyramid.resize_flow_cuda.launches
    got = fb_est.farneback(a, b, prev, **settings)
    torch.cuda.synchronize()
    assert pyramid.resize_flow_cuda.launches - before == \
        fb_est.launches_per_frame(192, 256, **settings)[4]
    assert torch.equal(got.cpu(), want)



# ---------------------------------------------------------------------------
# multi-host on one card, and the tools
# ---------------------------------------------------------------------------

MH_H, MH_W, MH_CHUNK, MH_STREAMS = 64, 96, 3, 4

MH_WORKER = r"""
import os, sys
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, __REPO__)
import torch
import torch.distributed as dist
sys.path.insert(0, os.path.join(__REPO__, "tests"))
from test_torch_cuda import _mh_model, _mh_inputs
from transflow_tpu_torch.parallel import (initialize, make_global_mesh,
                                          shard_model_inputs, sharded_scan)
initialize(f"127.0.0.1:{port}", 2, rank, timeout=120)
try:
    device = torch.device("cuda", 0)
    mesh = make_global_mesh(space_axis=2, devices=[device] * 2)
    assert mesh.shape == {"stream": 2, "space": 2} and \
        mesh.processes == (0, 1), mesh
    model = _mh_model(device)
    state, grays, pixmaps, keys = _mh_inputs(model, device)
    _, rgbs = sharded_scan(model, mesh, per_stream_pixmaps=True)(
        *shard_model_inputs(mesh, state, grays, pixmaps, keys)[:3], 0.0,
        keys)
    for s, rgb in enumerate(rgbs):
        if rgb is not None:
            torch.save(rgb.cpu(), os.path.join(out, f"stream{s}.pt"))
    dist.barrier()
finally:
    dist.destroy_process_group()
"""


def _mh_model(device):
    from transflow_tpu_torch.config import LayerConfig
    from transflow_tpu_torch.model import FlowTransferModel
    return FlowTransferModel(
        MH_H, MH_W, [LayerConfig(0, reset_mode="random",
                                 reset_random_factor=0.05)],
        method="horn-schunck", estimator_kwargs=dict(max_iters=2, delta=None),
        flow_filters="clip=6", halo=8, device=device)


def _mh_inputs(model, device):
    """Four panned streams from one seed, the same in every process."""
    gen = torch.Generator().manual_seed(0)
    canvas = torch.randint(0, 256, (MH_H + 16, MH_W + 16), generator=gen,
                           dtype=torch.uint8)
    grays = [torch.stack([canvas[s * i:s * i + MH_H, s * i:s * i + MH_W]
                          for i in range(MH_CHUNK + 1)]).to(device)
             for s in range(1, MH_STREAMS + 1)]
    state = [model.init_state(g[0]) for g in grays]
    return (state, [g[1:] for g in grays], model.default_pixmaps(),
            list(prng.split(prng.key(3), MH_STREAMS)))


def test_two_process_sharded_scan_on_the_card(device, tmp_path):
    """Two gloo processes, ``[cuda:0] * 2`` each (stream 2 x space 2 across
    them): every stream bit-equal to the single-process ``sharded_scan``
    over ``[cuda:0] * 4``."""
    import os
    import socket
    import subprocess
    import sys
    from transflow_tpu_torch.parallel import (make_mesh, shard_model_inputs,
                                              sharded_scan)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(MH_WORKER.replace("__REPO__", repr(repo)))
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outputs = [proc.communicate(timeout=180)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"process {rank}:\n{out[-3000:]}"
    model = _mh_model(device)
    mesh = make_mesh(devices=[device] * 4, stream_axis=2)
    state, grays, pixmaps, keys = _mh_inputs(model, device)
    _, rgbs = sharded_scan(model, mesh, per_stream_pixmaps=True)(
        *shard_model_inputs(mesh, state, grays, pixmaps, keys)[:3], 0.0,
        keys)
    for s in range(MH_STREAMS):
        assert torch.equal(torch.load(tmp_path / f"stream{s}.pt"),
                           rgbs[s].cpu()), s


def test_flowclip_on_the_card_is_the_estimator(device, tmp_path):
    """``FlowClip.flow`` over a PGM sequence on the card: bit-equal to the
    port's Farneback on the pair, with B1-B2b launched."""
    from transflow_tpu_torch.flow.estimators.farneback import farneback
    from transflow_tpu_torch.tools.viewflow_player import FlowClip
    from transflow_tpu_torch.utils.imageio import write_netpbm
    gen = np.random.default_rng(0)
    canvas = gen.integers(0, 256, (100, 140), dtype=np.uint8)
    frames = [canvas[2 * i:2 * i + 90, 2 * i:2 * i + 120] for i in range(3)]
    for i, frame in enumerate(frames):
        write_netpbm(str(tmp_path / f"{i:04d}.pgm"), frame)
    clip = FlowClip(str(tmp_path / "%04d.pgm"))
    before = fb.poly_expansion_cuda.launches
    flow = clip.flow(1)
    assert fb.poly_expansion_cuda.launches > before
    want = farneback(torch.from_numpy(frames[2]).to(device),
                     torch.from_numpy(frames[1]).to(device))
    assert torch.equal(torch.from_numpy(flow), want.cpu())


def _engine_over(source, device):
    """An Engine on ``device`` over ``source`` with one moveref layer."""
    from transflow_tpu_torch.compositor.core import make_layer_params
    from transflow_tpu_torch.config import Config, LayerConfig
    from transflow_tpu_torch.engine import Engine
    h, w = source.height, source.width
    layers = make_layer_params([LayerConfig(0)], h, w, {0: [(3, None)]},
                               device=device)
    return Engine(Config("clip", seed=0), [source], layers, h, w,
                  device=device)


def test_live_tuning_rebuilds_on_the_card(device):
    """chip_smoke's G1 at 90x120: ``apply_value("fb_iterations", "5")``
    between two frames rebuilds the estimator step once; the next frame
    launches 20 B2a and 20 B2b (12 before) and its raw flow is bit-equal
    to ``farneback`` with the new settings on the same pair."""
    from transflow_tpu_torch.flow import Direction
    from transflow_tpu_torch.flow.estimators.farneback import farneback
    from transflow_tpu_torch.flow.sources.base import FlowItem, FlowSource
    from transflow_tpu_torch.flow.sources.cv import CvFlowConfig
    from transflow_tpu_torch.gui.tuning import CvFlowConfigWindow
    gen = np.random.default_rng(0)
    canvas = gen.integers(0, 256, (110, 140), dtype=np.uint8)
    frames = [torch.from_numpy(np.ascontiguousarray(
        canvas[2 * i:2 * i + 90, 2 * i:2 * i + 120])).to(device)
        for i in range(5)]

    class Frames(FlowSource):
        yields_frames = True

        def _open_reader(self):
            self.height, self.width = 90, 120
            self.base_length = len(frames) - 1
            self.pos = 0

        def _rewind_reader(self, index):
            self.pos = index

        def _read_item(self):
            prime = frames[0] if self.pos == 0 else None
            self.pos += 1 + (self.pos == 0)
            return FlowItem(FlowItem.FRAME, frames[self.pos - 1],
                            prime=prime)

    config = CvFlowConfig()
    source = Frames(direction=Direction.BACKWARD)
    source.config = config
    engine = _engine_over(source.open(), device)
    runtime, items = engine.runtimes[0], iter(source)
    pixmaps = ((torch.zeros((90, 120, 3), dtype=torch.uint8,
                            device=device),),)
    launches = []
    for k in range(4):
        if k == 2:
            assert CvFlowConfigWindow(config).apply_value("fb_iterations",
                                                          "5")
            prev = runtime.prev_gray.clone(), runtime.prev_flow.clone()
            step = runtime.estimator_step
        before = fb.update_equations_cuda.launches
        item = next(items)
        engine.process_frame([item], pixmaps, k / 30.0, ((k,),))
        launches.append(fb.update_equations_cuda.launches - before)
        if k == 2:
            assert runtime.estimator_step is not step
            want = farneback(item.array, *prev, **config.estimator_kwargs())
            assert torch.equal(runtime.last_raw, want)
    levels = launches[0] // 3
    assert launches == [3 * levels, 3 * levels, 5 * levels, 5 * levels]


def test_cv2_clip_through_the_engine_on_the_card(device, tmp_path,
                                                 monkeypatch):
    """A cv2-written MJPG clip through ``CvFlowSource`` and the Engine on
    the card (float32 storage): B1 launched, and each raw flow within 60
    dB of the same Engine's on the CPU. Skips where cv2 is absent."""
    cv2 = pytest.importorskip("cv2")
    monkeypatch.setenv("TRANSFLOW_FARNEBACK_BF16", "0")
    from transflow_tpu_torch.flow import Direction
    from transflow_tpu_torch.flow.sources.cv import CvFlowSource
    gen = np.random.default_rng(1)
    canvas = cv2.GaussianBlur(gen.integers(0, 256, (90, 150, 3),
                                           dtype=np.uint8), (5, 5), 1.5)
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             (120, 90))
    for i in range(5):
        writer.write(np.ascontiguousarray(canvas[:, 2 * i:2 * i + 120]))
    writer.release()
    flows = {}
    for where in ("cpu", device):
        with torch.backends.cudnn.flags(allow_tf32=False):
            source = CvFlowSource(path, direction=Direction.BACKWARD).open()
            engine = _engine_over(source, where)
            pixmaps = ((torch.zeros((90, 120, 3), dtype=torch.uint8,
                                    device=where),),)
            before = fb.poly_expansion_cuda.launches
            out = []
            for k, item in enumerate(source):
                engine.process_frame([item], pixmaps, k / 10.0, ((k,),))
                out.append(engine.runtimes[0].last_raw.cpu())
            source.close()
        flows[str(where)] = torch.stack(out)
        if where != "cpu":
            assert fb.poly_expansion_cuda.launches > before
    cpu, card = flows["cpu"], flows[str(device)]
    assert card.shape == (4, 90, 120, 2)
    mse = ((card - cpu) ** 2).mean(dim=(1, 2, 3))
    assert (10 * torch.log10(64.0 / mse.clamp_min(1e-30)) >= 60.0).all()


# ---------------------------------------------------------------------------
# The compositor's kernels K0, K1, K2 (ops/compositor.py) against their
# plain versions on the card, bit for bit, over the CPU tests' grid
# (tests/test_torch_compositor_kernels.py holds the plain versions to JAX)
# ---------------------------------------------------------------------------

COMP_CHANNELS = (3, 4, 3, 3, 4, 4, 3, 4, 3)


@pytest.fixture
def comp_gradient(tmp_path):
    """A PGM writer of (H, W) masks whose values wrap: floats k/255."""
    from transflow_tpu_torch.utils.imageio import write_netpbm

    def make(h, w):
        path = tmp_path / f"gradient_{h}x{w}.pgm"
        ii, jj = np.indices((h, w))
        write_netpbm(str(path), ((ii * 13 + jj * 7) % 256).astype(np.uint8))
        return str(path)
    return make


def _comp_layers(cfgs, sources, h, w, device):
    """Port params on ``device`` and seeded random pixmaps a layer."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.config import LayerConfig
    params = core.make_layer_params(
        [LayerConfig(i, **c) for i, c in enumerate(cfgs)], h, w,
        dict(enumerate(sources)), device=device)
    gen = torch.Generator(device=device).manual_seed(len(cfgs))
    pix = [tuple(torch.randint(0, 256, (h, w, c), generator=gen,
                               device=device, dtype=torch.uint8)
                 for c in p.channel_counts) for p in params]
    return params, pix


def _comp_sources(n, h, w, seed=0):
    if n == 1:
        return [(3, None)]
    rng = np.random.default_rng(seed)
    return [(COMP_CHANNELS[s], rng.random((h, w)) < 0.4) for s in range(n)]


def _comp_flow(h, w, gen, device, reach=6, clip=True):
    from transflow_tpu_torch.ops.image import clip_to_frame
    flow = (torch.randint(-reach, reach + 1, (h, w, 2), generator=gen,
                          device=device)
            + 0.5 * torch.randint(0, 2, (h, w, 2), generator=gen,
                                  device=device)).float()
    still = torch.rand((h, w, 1), generator=gen, device=device) < 0.3
    flow = torch.where(still, torch.zeros_like(flow), flow)
    return clip_to_frame(flow) if clip else flow


def _assert_comp_equal(got: dict, want: dict, label=""):
    assert set(got) == set(want), label
    for key, value in want.items():
        assert got[key].dtype == value.dtype, (label, key)
        assert torch.equal(got[key], value), (label, key)


def _check_update_kernels(device, cfg, sources, h, w, halo=None,
                          groups=(8,), frames=4, clip=True, seed=0):
    """K0/K1 (``layer_update_cuda``) against ``layer_update_plain`` on the
    card, for every group size, frame after frame with the state carried;
    checks the launches a frame."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.ops import compositor as ck
    params, pix = _comp_layers([cfg], [sources], h, w, device)
    p = params[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    want = core.init_layer_state(p)
    states = dict.fromkeys(groups, want)
    leave = p.cfg.moving_pixels_leave_empty_spot and p.cfg.classname != "sum"
    for k in range(frames):
        flow = _comp_flow(h, w, gen, device, clip=clip)
        key = prng.fold_in(prng.key(seed), k)
        want = ck.layer_update_plain(p, want, flow, pix[0], key, halo)
        for group in groups:
            before = (ck.leave_empty_sources_cuda.launches,
                      ck.layer_update_cuda.launches)
            states[group] = ck.layer_update_cuda(p, states[group], flow,
                                                 pix[0], key, halo, group)
            torch.cuda.synchronize()
            launches = -(-max(p.num_sources, 1) // group)
            assert (ck.leave_empty_sources_cuda.launches,
                    ck.layer_update_cuda.launches) == (
                before[0] + int(leave), before[1] + launches)
            _assert_comp_equal(states[group], want, f"frame {k} group {group}")
    return states[groups[0]]


COMP_UPDATE_CASES = {
    "moveref-off": ({}, 1, None),
    "moveref-random": ({"reset_mode": "random",
                        "reset_random_factor": 0.3}, 1, None),
    "moveref-random-mask": ({"reset_mode": "random", "reset_mask": "g",
                             "reset_random_factor": 0.5}, 1, None),
    "moveref-constant": ({"reset_mode": "constant",
                          "reset_constant_step": 2.5}, 1, None),
    "moveref-constant-mask": ({"reset_mode": "constant",
                               "reset_mask": "g"}, 1, None),
    "moveref-linear": ({"reset_mode": "linear",
                        "reset_linear_factor": 0.3}, 1, None),
    "moveref-linear-mask": ({"reset_mode": "linear", "reset_mask": "g"},
                            1, None),
    "sum-off": ({"classname": "sum"}, 1, None),
    "sum-random": ({"classname": "sum", "reset_mode": "random",
                    "reset_random_factor": 0.2}, 1, None),
    "sum-random-mask": ({"classname": "sum", "reset_mode": "random",
                         "reset_mask": "g"}, 1, None),
    "sum-constant": ({"classname": "sum", "reset_mode": "constant",
                      "reset_constant_step": 2.5}, 1, None),
    "sum-linear-mask": ({"classname": "sum", "reset_mode": "linear",
                         "reset_mask": "g"}, 1, None),
    "mask-src": ({"mask_src": "circle:40%", "reset_mode": "random",
                  "reset_random_factor": 0.1}, 1, None),
    "mask-dst": ({"mask_dst": "border:4",
                  "moving_pixels_leave_empty_spot": True}, 1, None),
    "masks-all": ({"mask_alpha": "g", "mask_src": "rect:70%:60%",
                   "mask_dst": "circle:45%:inv", "reset_mask": "g",
                   "reset_mode": "random", "reset_random_factor": 0.2,
                   "moving_pixels_leave_empty_spot": True}, 1, None),
    "transparent": ({"transparent_pixels_can_move": True,
                     "moving_pixels_leave_empty_spot": True}, 1, None),
    "not-to-empty": ({"pixels_can_move_to_empty_spot": False,
                      "moving_pixels_leave_empty_spot": True}, 1, None),
    "not-to-filled": ({"pixels_can_move_to_filled_spot": False}, 1, None),
    "leave-empty": ({"moving_pixels_leave_empty_spot": True}, 1, None),
    "leave-empty-halo2": ({"moving_pixels_leave_empty_spot": True,
                           "reset_mode": "constant"}, 1, 2),
    "transparent-halo2": ({"transparent_pixels_can_move": True,
                           "moving_pixels_leave_empty_spot": True}, 1, 2),
    "sources-3": ({"reset_mode": "random", "reset_random_factor": 0.3,
                   "reset_source": True,
                   "moving_pixels_leave_empty_spot": True}, 3, None),
    "sources-9": ({"reset_mode": "random", "reset_random_factor": 0.3,
                   "reset_source": True}, 9, None),
    "sum-sources-9": ({"classname": "sum", "reset_mode": "random",
                       "reset_random_factor": 0.3, "reset_source": True},
                      9, None),
}


@pytest.mark.parametrize("case", list(COMP_UPDATE_CASES))
def test_compositor_update_kernels_match_plain(device, comp_gradient, case):
    """K0 and K1 over every reset mode, mask, movement flag, the halo and
    1, 3 and 9 sources in groups of 1, 2, 4 and 8, at a small unaligned
    size, bit-equal to the plain version frame after frame."""
    h, w = 37, 53
    cfg, n, halo = COMP_UPDATE_CASES[case]
    cfg = {k: comp_gradient(h, w) if v == "g" else v for k, v in cfg.items()}
    groups = (1, 2, 4, 8) if n > 1 else (8,)
    _check_update_kernels(device, cfg, _comp_sources(n, h, w, n), h, w,
                          halo, groups, seed=len(case))


def test_compositor_update_kernels_unclipped_flow(device):
    """A flow that points past the frame: the movement clamps its source,
    the sum's positions run off the frame and only the regather clips."""
    for cfg in ({"moving_pixels_leave_empty_spot": True},
                {"classname": "sum"}):
        _check_update_kernels(device, cfg, [(4, None)], 29, 31, frames=6,
                              clip=False, seed=11)


@pytest.mark.parametrize("shape", [(1080, 1920), (1079, 1917)], ids=str)
def test_compositor_kernels_at_1080p(device, shape):
    """The main path's layer (moveref, random reset 0.01) at 1080x1920
    and at an unaligned 1079x1917, K1 then K2, bit-equal to plain."""
    from transflow_tpu_torch.ops import compositor as ck
    h, w = shape
    state = _check_update_kernels(
        device, {"reset_mode": "random", "reset_random_factor": 0.01},
        [(3, None)], h, w, frames=3, seed=5)
    params, _ = _comp_layers([{"mask_alpha": "circle:45%"}], [[(3, None)]],
                             h, w, device)
    bg = torch.tensor([255, 255, 255], dtype=torch.uint8, device=device)
    got = ck.composite_cuda(params, [state], bg, h, w)
    want = ck.composite_plain(params, [state], bg, h, w)
    assert torch.equal(got[1], want[1])
    _assert_comp_equal(got[0][0], want[0][0])


def test_compositor_kernels_over_30_frames(device, comp_gradient):
    """``build_compositor`` on the card (K0, K1, K2: a moveref layer with
    random reset 0.01, leave-empty and an alpha mask, and a sum layer)
    against the plain versions on the card over 30 frames of 1080x1920,
    the state carried through: bit-equal every frame, 1 K0, 2 K1 and 1 K2
    launches a frame."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.ops import compositor as ck
    h, w = 1080, 1920
    cfgs = [{"reset_mode": "random", "reset_random_factor": 0.01,
             "moving_pixels_leave_empty_spot": True,
             "mask_alpha": comp_gradient(h, w)},
            {"classname": "sum", "reset_mode": "linear"}]
    params, pix = _comp_layers(cfgs, [[(3, None)], [(4, None)]], h, w,
                               device)
    init, step = core.build_compositor(params, h, w, "#204060",
                                       device=device)
    bg = torch.tensor([0x20, 0x40, 0x60], dtype=torch.uint8, device=device)
    state = want = init()
    gen = torch.Generator(device=device).manual_seed(30)
    counters = (ck.leave_empty_sources_cuda, ck.layer_update_cuda,
                ck.composite_cuda)
    for k in range(30):
        flow = _comp_flow(h, w, gen, device, reach=4)
        key = prng.fold_in(prng.key(3), k)
        before = [fn.launches for fn in counters]
        state, rgb = step(state, flow, pix, key, ((0,), (0,)))
        torch.cuda.synchronize()
        assert [fn.launches - b for fn, b in zip(counters, before)] == \
            [1, 2, 1]
        keys = prng.split(key, 2)
        want = [ck.layer_update_plain(p, s, flow, x, kk)
                for p, s, x, kk in zip(params, want, pix, keys)]
        want, want_rgb = ck.composite_plain(params, want, bg, h, w)
        assert torch.equal(rgb, want_rgb), k
        for got, exp in zip(state, want):
            _assert_comp_equal(got, exp, f"frame {k}")


def test_compositor_draw_is_prng_uniform(device):
    """K1's draw at 1080x1920 is ``prng.uniform`` of the layer's key bit
    for bit: with the reset factor at the plain draw u every pixel keeps
    (rand < u is false), at the next float above u every pixel resets
    (rand <= u), so rand == u everywhere."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.ops import compositor as ck
    h, w = 1080, 1920
    params, pix = _comp_layers([{"reset_mode": "random"}], [[(3, None)]],
                               h, w, device)
    p = params[0]
    state = dict(core.init_layer_state(p),
                 alpha=torch.zeros((h, w), dtype=torch.uint8, device=device))
    flow = torch.zeros((h, w, 2), device=device)
    key = prng.split(prng.key(7), 3)[1]
    u = prng.uniform(key, (h, w), device)
    for factor, reset in ((u, 0), (torch.nextafter(u, torch.ones_like(u)),
                                   1)):
        p.reset_factor = factor
        out = ck.layer_update_cuda(p, state, flow, pix[0], key)
        assert torch.equal(out["alpha"], torch.full_like(out["alpha"],
                                                         reset))


def test_compositor_leave_empty_kernel_matches_plain(device):
    """K0 alone, into a zeroed buffer, against its plain version, with and
    without a halo."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.ops import compositor as ck
    h, w = 135, 241
    params, _ = _comp_layers([{"mask_src": "circle:45%",
                               "moving_pixels_leave_empty_spot": True}],
                             [[(3, None)]], h, w, device)
    gen = torch.Generator(device=device).manual_seed(8)
    state = dict(core.init_layer_state(params[0]), alpha=(torch.rand(
        (h, w), generator=gen, device=device) < 0.7).to(torch.uint8))
    flow = _comp_flow(h, w, gen, device, reach=9)
    for halo in (None, 3):
        got = ck.leave_empty_sources_cuda(params[0], state, flow, halo)
        want = ck.leave_empty_sources_plain(params[0], state, flow, halo)
        assert torch.equal(got.bool(), want) and want.any()


def _comp_stack(n, gradient):
    cycle = [
        {"reset_mode": "random", "reset_random_factor": 0.2,
         "mask_alpha": gradient, "moving_pixels_leave_empty_spot": True},
        {"classname": "sum", "reset_mode": "linear"},
        {"classname": "introduction", "mask_alpha": gradient,
         "moving_pixels_leave_empty_spot": True},
        {"classname": "static", "mask_alpha": "circle:40%"},
        {"classname": "moveref", "mask_alpha": "border:3",
         "transparent_pixels_can_move": True},
    ]
    return [cycle[k % len(cycle)] for k in range(n)]


@pytest.mark.parametrize("n", [1, 3, 9])
def test_composite_kernel_matches_plain(device, comp_gradient, n):
    """K2 over 1, 3 and 9 layers of every class in groups of 1, 3 and 8,
    after three steps of ``build_compositor`` on the card; then with alpha
    masks outside [0, 1] (-0.5 to 1.6: the cast of a product below 0 or
    above 255 to uint8, and introduction's clip), bit-equal to the plain
    version on the card."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.ops import compositor as ck
    h, w = 61, 83
    params, pix = _comp_layers(_comp_stack(n, comp_gradient(h, w)),
                               [_comp_sources(2, h, w)] * n, h, w, device)
    init, step = core.build_compositor(params, h, w, "#204060",
                                       device=device)
    state = init()
    gen = torch.Generator(device=device).manual_seed(n)
    numbers = tuple((0, 0) for _ in range(n))
    for k in range(3):
        state, _ = step(state, _comp_flow(h, w, gen, device), pix,
                        prng.fold_in(prng.key(n), k), numbers)
    bg = torch.tensor([0x20, 0x40, 0x60], dtype=torch.uint8, device=device)
    for masks in ("config", "outside [0, 1]"):
        if masks != "config":
            for p in params:
                if p.mask_alpha is not None:
                    p.mask_alpha = torch.rand((h, w), generator=gen,
                                              device=device) * 2.1 - 0.5
        want_states, want = ck.composite_plain(params, state, bg, h, w)
        for group in (1, 3, 8):
            before = ck.composite_cuda.launches
            got_states, got = ck.composite_cuda(params, state, bg, h, w,
                                                group)
            torch.cuda.synchronize()
            assert ck.composite_cuda.launches == before + -(-n // group)
            assert torch.equal(got, want), (masks, group)
            for a, b in zip(got_states, want_states):
                _assert_comp_equal(a, b, f"{masks} group {group}")


def test_compositor_kernels_need_one_card(device):
    """A wrapper given tensors on two devices, or a CPU pixmap, raises (K1,
    K3, K4)."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.ops import compositor as ck
    params, pix = _comp_layers([{}], [[(3, None)]], 8, 8, device)
    state = core.init_layer_state(params[0])
    flow = torch.zeros((8, 8, 2), device=device)
    with pytest.raises(ValueError):
        ck.layer_update_cuda(params[0], state, flow, (pix[0][0].cpu(),))
    with pytest.raises(ValueError):
        ck.layer_update(params[0], state, flow.cpu(), pix[0])
    with pytest.raises(ValueError):
        ck.introduction_update_cuda(
            *_comp_intro_args(device, pixmap_device="cpu"))
    with pytest.raises(ValueError):
        sparams, spix = _comp_layers([{"classname": "static"}],
                                     [[(3, None)]], 8, 8, device)
        ck.static_blit_cuda(sparams[0], core.init_layer_state(sparams[0]),
                            (spix[0][0].cpu(),))


# ---------------------------------------------------------------------------
# K3 (an introduction layer's update) and K4 (a static layer's blit)
# against their plain versions on the card, bit for bit
# (tests/test_torch_compositor_layers.py holds the plain versions to JAX)
# ---------------------------------------------------------------------------

INTRO_CHANNELS = (3, 4, 4, 3, 3, 4, 3, 4, 4, 3)


def _intro_sources(n, h, w, seed=0):
    if n == 1:
        return [(3, None)]
    rng = np.random.default_rng(seed)
    return [(INTRO_CHANNELS[s], rng.random((h, w)) < 0.45)
            for s in range(n)]


def _comp_intro_args(device, pixmap_device=None):
    """An 8x8 introduction layer's K3 arguments, the pixmap on
    ``pixmap_device`` (the card by default)."""
    from transflow_tpu_torch.compositor import core
    params, pix = _comp_layers([{"classname": "introduction"}],
                               [[(3, None)]], 8, 8, device)
    return (params[0], core.init_layer_state(params[0]),
            torch.zeros((8, 8, 2), device=device),
            tuple(x.to(pixmap_device or device) for x in pix[0]), (0,))


def _check_intro_kernels(device, cfg, sources, h, w, halo=None,
                         groups=(8,), frames=4, seed=0):
    """K0/K3 (``introduction_update_cuda``) against
    ``introduction_update_plain`` on the card, for every group size, frame
    after frame with the state carried; checks the launches a frame."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.ops import compositor as ck
    params, pix = _comp_layers([{"classname": "introduction", **cfg}],
                               [sources], h, w, device)
    p = params[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    want = core.init_layer_state(p)
    states = dict.fromkeys(groups, want)
    for k in range(frames):
        flow = _comp_flow(h, w, gen, device)
        numbers = tuple(5 * k + s for s in range(p.num_sources))
        want = ck.introduction_update_plain(p, want, flow, pix[0], numbers,
                                            halo)
        for group in groups:
            before = (ck.leave_empty_sources_cuda.launches,
                      ck.introduction_update_cuda.launches)
            states[group] = ck.introduction_update_cuda(
                p, states[group], flow, pix[0], numbers, halo, group)
            torch.cuda.synchronize()
            launches = -(-max(p.num_sources, 1) // group)
            assert (ck.leave_empty_sources_cuda.launches,
                    ck.introduction_update_cuda.launches) == (
                before[0] + int(p.cfg.moving_pixels_leave_empty_spot),
                before[1] + launches)
            _assert_comp_equal(states[group], want, f"frame {k} group {group}")
    return states[groups[0]]


COMP_INTRO_CASES = {
    "default": ({}, 2, None),
    "not-on-empty": ({"introduce_pixels_on_empty_spots": False,
                      "moving_pixels_leave_empty_spot": True}, 2, None),
    "not-on-filled": ({"introduce_pixels_on_filled_spots": False,
                       "moving_pixels_leave_empty_spot": True}, 2, None),
    "not-moving": ({"introduce_moving_pixels": False}, 2, None),
    "not-unmoving": ({"introduce_unmoving_pixels": False}, 2, None),
    "all-filled": ({"introduce_on_all_filled_spots": True,
                    "introduce_pixels_on_empty_spots": False,
                    "moving_pixels_leave_empty_spot": True}, 2, None),
    "all-empty": ({"introduce_on_all_empty_spots": True,
                   "introduce_pixels_on_filled_spots": False,
                   "moving_pixels_leave_empty_spot": True}, 2, None),
    "all-both": ({"introduce_on_all_filled_spots": True,
                  "introduce_on_all_empty_spots": True,
                  "introduce_moving_pixels": False}, 2, None),
    "once": ({"introduce_once": True,
              "moving_pixels_leave_empty_spot": True}, 3, None),
    "leave-empty": ({"moving_pixels_leave_empty_spot": True}, 2, None),
    "leave-empty-halo2": ({"moving_pixels_leave_empty_spot": True,
                           "introduce_pixels_on_filled_spots": False}, 2, 2),
    "masks-halo2": ({"mask_src": "circle:40%", "mask_dst": "rect:80%:70%",
                     "moving_pixels_leave_empty_spot": True}, 2, 2),
    "transparent": ({"transparent_pixels_can_move": True,
                     "moving_pixels_leave_empty_spot": True}, 2, None),
    "not-to-empty": ({"pixels_can_move_to_empty_spot": False,
                      "moving_pixels_leave_empty_spot": True}, 2, None),
    "not-to-filled": ({"pixels_can_move_to_filled_spot": False}, 2, None),
    "one-rgb": ({"moving_pixels_leave_empty_spot": True}, 1, None),
    "sources-10-halo3": ({"moving_pixels_leave_empty_spot": True,
                          "introduce_pixels_on_filled_spots": False}, 10,
                         3),
}


@pytest.mark.parametrize("case", list(COMP_INTRO_CASES))
def test_introduction_kernel_matches_plain(device, case):
    """K0 and K3 over every eligibility and movement flag, the two
    all-spots flags, ``introduce_once`` over frames, leave-empty with and
    without a halo, and 1, 2, 3 and 10 sources of 3 and 4 channels in
    groups of 1, 3 and 8, at a small unaligned size, bit-equal to the
    plain version frame after frame."""
    h, w = 37, 53
    cfg, n, halo = COMP_INTRO_CASES[case]
    groups = (1, 3, 8) if n > 1 else (8,)
    _check_intro_kernels(device, cfg, _intro_sources(n, h, w, n), h, w,
                         halo, groups, seed=len(case))


def test_introduction_kernel_four_channels(device):
    """One full-frame 4-channel source: alpha is the pixmap's byte."""
    _check_intro_kernels(device, {}, [(4, None)], 29, 31, frames=3, seed=3)


def _check_static_kernel(device, sources, h, w, groups=(1, 3, 8),
                         frames=3, seed=0):
    """K4 (``static_blit_cuda``) against ``static_blit_plain`` on the card
    for every group size, frame after frame, the pixmaps changing."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.ops import compositor as ck
    params, pix = _comp_layers([{"classname": "static"}], [sources], h, w,
                               device)
    p = params[0]
    want = core.init_layer_state(p)
    states = dict.fromkeys(groups, want)
    for k in range(frames):
        frame_pix = tuple(x.roll(k, 1) for x in pix[0])
        want = ck.static_blit_plain(p, want, frame_pix)
        for group in groups:
            before = ck.static_blit_cuda.launches
            states[group] = ck.static_blit_cuda(p, states[group], frame_pix,
                                                group)
            torch.cuda.synchronize()
            assert ck.static_blit_cuda.launches == \
                before + -(-max(p.num_sources, 1) // group)
            _assert_comp_equal(states[group], want, f"frame {k} group {group}")
    return states[groups[0]]


@pytest.mark.parametrize("n", [0, 1, 2, 10])
def test_static_blit_kernel_matches_plain(device, n):
    """No source, one, two and ten sources of 3 and 4 channels, in groups
    of 1, 3 and 8, at a small unaligned size: bit-equal to plain."""
    _check_static_kernel(device, [] if n == 0 else
                         _intro_sources(n, 37, 53, 10 + n), 37, 53)


@pytest.mark.parametrize("shape", [(1080, 1920), (1079, 1917)], ids=str)
def test_layer_kernels_at_1080p(device, shape):
    """K3 (ten sources in groups of 3, leave-empty, a halo of 8,
    ``introduce_once``) and K4 (ten sources in groups of 3) at 1080x1920
    and an unaligned 1079x1917, bit-equal to plain."""
    h, w = shape
    sources = _intro_sources(10, h, w, 1)
    _check_intro_kernels(device, {"moving_pixels_leave_empty_spot": True,
                                  "introduce_once": True},
                         sources, h, w, halo=8, groups=(3,), frames=2,
                         seed=4)
    _check_static_kernel(device, sources, h, w, groups=(3,), frames=2)


def test_compositor_never_takes_a_plain_update(device, comp_gradient,
                                               monkeypatch):
    """``build_compositor`` on the card over the four classes, with a
    halo of 4, as it runs meshless and under a mesh: every update runs
    K0, K1, K3 or K4 (the plain versions fail if called), 2 K0, 2 K1, 1 K3, 1 K4 and 1 K2 launches a frame, and
    the states and frames equal the plain versions' on the card."""
    from transflow_tpu_torch.compositor import core
    from transflow_tpu_torch.ops import compositor as ck
    h, w = 64, 96
    cfgs = [{"classname": "introduction",
             "moving_pixels_leave_empty_spot": True},
            {"classname": "sum", "reset_mode": "random",
             "reset_random_factor": 0.05},
            {"classname": "static", "mask_alpha": comp_gradient(h, w)},
            {"reset_mode": "random", "reset_random_factor": 0.05,
             "moving_pixels_leave_empty_spot": True,
             "mask_src": "circle:45%"}]
    params, pix = _comp_layers(cfgs, [_intro_sources(2, h, w)] * 4, h, w,
                               device)
    bg = torch.tensor([0x20, 0x40, 0x60], dtype=torch.uint8, device=device)
    plain = {name: getattr(ck, name) for name in (
        "layer_update_plain", "introduction_update_plain",
        "static_blit_plain", "leave_empty_sources_plain")}
    for name in plain:
        monkeypatch.setattr(ck, name, lambda *a, _n=name: pytest.fail(
            f"{_n} ran on the card"))
    init, step = core.build_compositor(
        params, h, w, "#204060", halo=4, device=device)
    state = want = init()
    gen = torch.Generator(device=device).manual_seed(9)
    counters = (ck.leave_empty_sources_cuda, ck.layer_update_cuda,
                ck.introduction_update_cuda, ck.static_blit_cuda,
                ck.composite_cuda)
    for k in range(4):
        flow = _comp_flow(h, w, gen, device)
        key = prng.fold_in(prng.key(2), k)
        numbers = tuple((k, k + 1) for _ in params)
        before = [fn.launches for fn in counters]
        state, rgb = step(state, flow, pix, key, numbers)
        torch.cuda.synchronize()
        assert [fn.launches - b for fn, b in zip(counters, before)] == \
            [2, 2, 1, 1, 1]
        keys = prng.split(key, len(params))
        want = [
            plain["introduction_update_plain"](params[0], want[0], flow,
                                               pix[0], numbers[0], 4),
            plain["layer_update_plain"](params[1], want[1], flow, pix[1],
                                        keys[1], 4),
            plain["static_blit_plain"](params[2], want[2], pix[2]),
            plain["layer_update_plain"](params[3], want[3], flow, pix[3],
                                        keys[3], 4)]
        want, want_rgb = ck.composite_plain(params, want, bg, h, w)
        assert torch.equal(rgb, want_rgb), k
        for got, exp in zip(state, want):
            _assert_comp_equal(got, exp, f"frame {k}")

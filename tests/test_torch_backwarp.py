"""The port's exact backwarp (kernel B7's plain version and dispatcher)
against the JAX package's ``liteflownet.backwarp`` on the CPU.

JAX's unbounded path is jnp ops; XLA's CPU backend may fuse a product into
the following add, where the port rounds each product first, so the two
agree within ``WARP_TOL`` = 1e-6 on images of |values| < 3 (bit for bit
where the weights are 0 or 1). The edge flows put the anchor's float
floor at -1 (the +1 tap falls back to column or row 0, its mask 1), at
W-1 or H-1 (the +1 tap is the zero pad), at W or H and beyond, and at -2
and below, on both axes and in every combination.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transflow_tpu.flow.estimators import liteflownet as jlfn
from transflow_tpu_torch.flow.estimators import liteflownet as lfn
from transflow_tpu_torch.ops import warp
from transflow_tpu_torch.ops.warp import (exact_backwarp,
                                          exact_backwarp_cuda,
                                          exact_backwarp_plain)

WARP_TOL = 1e-6
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
FLOWS = ("random", "edges", "integer")


def _image(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    image = np.clip(0.6 * rng.standard_normal(shape), -2.9, 2.9)
    return torch.from_numpy(image.astype(np.float32)).to(dtype)


def _edge_targets(n):
    """Float floors that hit each edge case along an axis of ``n``."""
    return np.array([-1, n - 1, n, n + 3, -2, -7, 0, n - 2, n // 2],
                    np.float64)


def _flow(kind, h, w, seed):
    """(h, w, 2) float32 flow. ``random``: +-8 px, a third of the pixels
    on whole taps, row 0 40 px above the frame and column 1 50 px right of
    it; ``edges``: every pixel's floors on the edge targets (fraction
    0.25 or 0.75); ``integer``: the edge targets as whole taps."""
    rng = np.random.default_rng(seed)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    if kind == "random":
        flow = rng.uniform(-8, 8, (h, w, 2))
        flow[::3, ::4] = np.round(flow[::3, ::4])
        flow[0, :, 1] = -40.0
        flow[:, 1, 0] = 50.0
        return flow.astype(np.float32)
    tx, ty = _edge_targets(w), _edge_targets(h)
    sx = tx[(ii + 2 * jj) % len(tx)]
    sy = ty[(3 * ii + jj) % len(ty)]
    if kind == "edges":
        sx = sx + np.where((ii + jj) % 2, 0.25, 0.75)
        sy = sy + np.where(ii % 2, 0.75, 0.25)
    return np.stack([sx - jj, sy - ii], -1).astype(np.float32)


def _jax(image, flow):
    jimage = jnp.asarray(image.float().numpy())
    if image.dtype == torch.bfloat16:
        jimage = jimage.astype(jnp.bfloat16)
    return np.asarray(jlfn.backwarp(jimage, jnp.asarray(flow)))


@pytest.mark.parametrize("kind", FLOWS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(20, 30, 3), (17, 23, 5), (12, 16, 64)],
                         ids=str)
def test_plain_matches_jax(shape, dtype, kind):
    image = _image(shape, shape[2], DTYPES[dtype])
    flow = _flow(kind, *shape[:2], shape[2] + 1)
    got = exact_backwarp_plain(image, torch.from_numpy(flow))
    want = _jax(image, flow)
    assert got.dtype == torch.float32 and got.shape == shape
    if kind == "integer":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=WARP_TOL, rtol=0)


def test_edge_flows_hit_every_case():
    """The edge flows' floors take each edge value on both axes."""
    h, w = 20, 30
    flow = _flow("edges", h, w, 0)
    jj, ii = np.meshgrid(np.arange(w), np.arange(h))
    x0f = np.floor(jj + flow[..., 0])
    y0f = np.floor(ii + flow[..., 1])
    for floors, n in ((x0f, w), (y0f, h)):
        assert {-1, n - 1, n, -2} <= set(floors.ravel().tolist())
    both_low = (x0f == -1) & (y0f == -1)
    assert both_low.any() and ((x0f == -1) & (y0f == h - 1)).any()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_reads_a_strided_view(dtype):
    """The regularization warps the second image of a 6-channel pair,
    ``p[..., 3:]``: pixels 6 elements apart, 3 elements in. The plain
    version reads the view as it reads the same values made contiguous,
    and both match JAX."""
    h, w = 34, 60
    pair = _image((h, w, 6), 6, DTYPES[dtype])
    view = pair[..., 3:]
    assert view.stride() == (6 * w, 6, 1) and not view.is_contiguous()
    flow = torch.from_numpy(_flow("random", h, w, 7))
    got = exact_backwarp_plain(view, flow)
    assert torch.equal(got, exact_backwarp_plain(view.contiguous(), flow))
    np.testing.assert_allclose(got.numpy(), _jax(view.contiguous(),
                                                 flow.numpy()),
                               atol=WARP_TOL, rtol=0)


def test_plain_takes_a_bf16_flow():
    """LiteFlowNet's level-6 subpixel head warps by a bf16 flow: the plain
    version widens it exactly, as the kernel's wrapper does."""
    image = _image((12, 16, 8), 1, torch.float32)
    flow = torch.from_numpy(_flow("random", 12, 16, 2)).to(torch.bfloat16)
    assert torch.equal(exact_backwarp_plain(image, flow),
                       exact_backwarp_plain(image, flow.float()))


def test_dispatch_by_device():
    image = _image((6, 9, 5), 3, torch.float32)
    flow = torch.from_numpy(_flow("edges", 6, 9, 4))
    before = exact_backwarp_cuda.launches
    assert torch.equal(exact_backwarp(image, flow),
                       exact_backwarp_plain(image, flow))
    assert exact_backwarp_cuda.launches == before
    with pytest.raises(ValueError, match="no path for device"):
        exact_backwarp(image.to("meta"), flow.to("meta"))


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA device"),
    ("flow shape", r"\(H, W, 2\) flow"),
    ("image rank", r"\(H, W, C\)"),
    ("empty", "non-empty"),
    ("dtype", "float32 or bfloat16"),
    ("flow dtype", "float32 or bfloat16"),
    ("channel stride", "contiguous channels"),
    ("row stride", "rows of W pixels"),
])
def test_cuda_wrapper_refuses_misuse(case, match):
    """The wrapper raises before any launch: on CPU tensors (it never runs
    the plain version) and on shapes, dtypes or strides the kernel does
    not take."""
    image = torch.zeros((6, 8, 4))
    flow = torch.zeros((6, 8, 2))
    if case == "flow shape":
        flow = torch.zeros((6, 7, 2))
    elif case == "image rank":
        image = torch.zeros((6, 8))
    elif case == "empty":
        image, flow = torch.zeros((0, 8, 4)), torch.zeros((0, 8, 2))
    elif case == "dtype":
        image = image.double()
    elif case == "flow dtype":
        flow = flow.double()
    elif case == "channel stride":
        image = torch.zeros((6, 8, 8))[..., ::2]
    elif case == "row stride":
        image = torch.zeros((6, 10, 4))[:, :8]
    before = exact_backwarp_cuda.launches
    with pytest.raises(ValueError, match=match):
        exact_backwarp_cuda(image, flow)
    assert exact_backwarp_cuda.launches == before


@pytest.mark.parametrize("channels,bound", [(8, 4), (16, None), (3, 2)])
def test_backwarp_takes_the_exact_path(channels, bound, monkeypatch):
    """``liteflownet.backwarp`` sends every warp without an honoured bound
    (no bound, or under 16 channels) to ``exact_backwarp`` and nothing else:
    on the CPU its plain version, once a call."""
    calls = []
    monkeypatch.setattr(warp, "exact_backwarp_plain",
                        lambda *a: calls.append(a[0].shape)
                        or exact_backwarp_plain(*a))
    monkeypatch.setattr(warp, "bounded_backwarp_plain",
                        lambda *a: pytest.fail("the bounded path ran"))
    image = _image((16, 32, channels), 5, torch.float32)
    flow = torch.from_numpy(_flow("random", 16, 32, 6))
    got = lfn.backwarp(image, flow, bound=bound)
    assert calls == [image.shape]
    assert torch.equal(got, exact_backwarp_plain(image, flow))
    np.testing.assert_allclose(got.numpy(), _jax(image, flow.numpy()),
                               atol=WARP_TOL, rtol=0)

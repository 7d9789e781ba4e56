"""The port's flow post-processing against the JAX package's: the eight
merges, ``scatter_last_wins`` and ``forward_to_backward`` (kernel B5's
plain version) bit for bit; the filters, ``conv2d_same`` and the whole
chain within the bounds stated by each test.

Inputs are seeded numpy, fed to the JAX function and to the port's on the
CPU. Kernel B5 itself runs on the card only (tests/test_torch_cuda.py and
chip_smoke.py hold it to the plain version).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transflow_tpu.flow import Direction as JaxDirection
from transflow_tpu.flow import filters as jfilters
from transflow_tpu.flow import merge as jmerge
from transflow_tpu.flow import transforms as jtransforms
from transflow_tpu.ops import image as jimage
from transflow_tpu.ops import scatter as jscatter
from transflow_tpu_torch.flow import Direction
from transflow_tpu_torch.flow import filters, merge, transforms
from transflow_tpu_torch.ops import image, scatter

H, W = 48, 64


def _flow(seed: int, scale: float = 5.0, h: int = H, w: int = W):
    return (np.random.default_rng(seed).standard_normal((h, w, 2))
            * scale).astype(np.float32)


def _equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _spacing(x) -> np.ndarray:
    return np.spacing(np.abs(np.asarray(x, np.float32)))


# ---------------------------------------------------------------------------
# merges
# ---------------------------------------------------------------------------

def _merge_inputs(n: int, seed: int) -> list[np.ndarray]:
    """n flows: continuous values, half-integers with sign flips (ties
    of |.| across flows for absmax's first-maximum rule), zeros, and
    values at the binarize threshold."""
    rng = np.random.default_rng(seed)
    flows = []
    for k in range(n):
        f = _flow(seed + k)
        ties = rng.integers(-3, 4, (H, W, 2)) * 0.5
        f[: H // 3] = ties[: H // 3] * (1 if k % 2 else -1)
        f[H // 3: H // 2] = 0.0
        f[H // 2: H // 2 + 4] = merge.BINARIZE_THRESHOLD * (1 - 2 * (k % 2))
        flows.append(f.astype(np.float32))
    return flows


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("name", list(jmerge.MERGE_FUNCTIONS))
def test_merges_bit_exact(name, n):
    flows = _merge_inputs(n, seed=n)
    got = merge.get_merge_function(name)([torch.from_numpy(f) for f in flows])
    want = jmerge.get_merge_function(name)([jnp.asarray(f) for f in flows])
    _equal(got, want)


def test_merge_names_match_jax():
    assert list(merge.MERGE_FUNCTIONS) == list(jmerge.MERGE_FUNCTIONS)
    with pytest.raises(ValueError, match="Unknown"):
        merge.get_merge_function("median")


# ---------------------------------------------------------------------------
# scatter_last_wins and forward_to_backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [0, 2, 3])
def test_scatter_last_wins_bit_exact(channels):
    """Duplicate targets (many writers per cell), masked-out writes with
    out-of-range indices, and cells nobody writes."""
    rng = np.random.default_rng(channels)
    n, size = 600, 200
    shape = (n,) if channels == 0 else (n, channels)
    values = rng.standard_normal(shape).astype(np.float32)
    default = rng.standard_normal((size,) + shape[1:]).astype(np.float32)
    idx = rng.integers(0, size // 3, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    idx[~mask] = rng.integers(-50, 5 * size, (~mask).sum())
    got = scatter.scatter_last_wins(torch.from_numpy(values),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(default))
    want = jscatter.scatter_last_wins(jnp.asarray(values), jnp.asarray(idx),
                                      jnp.asarray(mask), jnp.asarray(default))
    _equal(got, want)
    # numpy.put's order: the last masked write in flat order wins
    expect = default.copy()
    for p in np.flatnonzero(mask):
        expect[idx[p]] = values[p]
    np.testing.assert_array_equal(got.numpy(), expect)


def _forward_flows() -> dict:
    rng = np.random.default_rng(7)
    ii, jj = np.indices((H, W)).astype(np.float32)
    converge = np.stack([W / 2 - jj, H / 2 - ii], axis=-1)  # all to centre
    halves = (rng.integers(-8, 9, (H, W, 2)) + 0.5).astype(np.float32)
    leave = _flow(3, scale=40.0)                           # mostly off-frame
    sparse = _flow(4)
    sparse[rng.random((H, W)) < 0.6] = 0.0
    # a constant (W/2, 0): the right half of each row clips onto the
    # row's last pixel, the left half moves freely (a -f scaled pan)
    edge = np.zeros((H, W, 2), np.float32)
    edge[..., 0] = W / 2
    return {"random": _flow(1), "converge": converge.astype(np.float32),
            "converge_rows": np.stack([np.zeros_like(jj), 5 - ii], -1)
            .astype(np.float32),
            "half_integers": halves, "leave_frame": leave,
            "sparse": sparse, "zero": np.zeros((H, W, 2), np.float32),
            "edge_pileup": edge,
            "converge_column": np.stack([W // 3 - jj, np.zeros_like(ii)],
                                        -1).astype(np.float32)}


@pytest.mark.parametrize("name", list(_forward_flows()))
def test_forward_to_backward_bit_exact(name):
    flow = _forward_flows()[name]
    got = transforms.forward_to_backward(torch.from_numpy(flow))
    want = jtransforms.forward_to_backward(jnp.asarray(flow))
    _equal(got, want)
    if name == "converge":
        # one winner at the centre: the last pixel in flat order
        centre = got[H // 2, W // 2].numpy()
        np.testing.assert_array_equal(centre, [W - 1 - W // 2,
                                               H - 1 - H // 2])


def _np_put_loop(flow: np.ndarray) -> np.ndarray:
    """The reference's rule (source.py:349-360) written out: clip to the
    frame, round half to even, then every moving pixel in flat order puts
    its base coordinates at its target (numpy.put, mode "clip"), one
    write at a time, so a later write replaces an earlier one."""
    h, w = flow.shape[:2]
    ii, jj = np.indices((h, w))
    fx = np.clip(flow[..., 0], -jj, w - 1 - jj)
    fy = np.clip(flow[..., 1], -ii, h - 1 - ii)
    flat = (np.round(fy).astype(np.int64) * w
            + np.round(fx).astype(np.int64)).ravel()
    ax, ay = jj.ravel().copy(), ii.ravel().copy()
    for p in range(h * w):
        if flat[p] != 0:
            np.put(ax, p + flat[p], p % w, mode="clip")
            np.put(ay, p + flat[p], p // w, mode="clip")
    return np.stack([ax - jj.ravel(), ay - ii.ravel()],
                    -1).reshape(h, w, 2).astype(np.float32)


@pytest.mark.parametrize("name", list(_forward_flows()))
def test_forward_to_backward_matches_np_put_loop(name):
    """The port's forward_to_backward (kernel B5's plain version on the
    CPU) against a plain loop of numpy.put in flat order."""
    flow = _forward_flows()[name]
    got = transforms.forward_to_backward(torch.from_numpy(flow))
    np.testing.assert_array_equal(got.numpy(), _np_put_loop(flow))


def test_forward_to_backward_dispatch():
    """CPU tensors take the plain version; the kernel's wrapper refuses a
    tensor that is not on a CUDA device (no fallback)."""
    flow = torch.from_numpy(_flow(2))
    assert torch.equal(transforms.forward_to_backward(flow),
                       scatter.forward_to_backward_plain(flow))
    launches = scatter.forward_to_backward_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        scatter.forward_to_backward_cuda(flow)
    with pytest.raises(ValueError, match="float32"):
        scatter.forward_to_backward_plain(flow.double())
    assert scatter.forward_to_backward_cuda.launches == launches


def test_clip_to_frame_matches_jax():
    flow = _flow(5, scale=60.0)
    _equal(transforms.clip_to_frame(torch.from_numpy(flow)),
           jtransforms.clip_to_frame(jnp.asarray(flow)))


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def _jax_filter(text: str, flow, t):
    out = jnp.asarray(flow)
    for flt in jfilters.FlowFilter.parse_many(text):
        out = flt(out, jnp.float32(t))
    return np.asarray(out)


def _port_filter(text: str, flow, t):
    out = torch.from_numpy(flow)
    for flt in filters.FlowFilter.parse_many(text):
        out = flt(out, np.float32(t))
    return out.numpy()


@pytest.mark.parametrize("text", [
    "scale=1.5", "scale=np.sin(t)*2", "threshold=2", "threshold=0.5*t",
    "clip=3", "clip=1+np.abs(np.cos(t))", "scale=0.5;threshold=1;clip=2"])
@pytest.mark.parametrize("t", [0.4, 2.7])
def test_norm_filters_within_an_ulp_of_the_norm(text, t):
    """scale, threshold and clip: the norms are ``torch.linalg.
    vector_norm``'s, which equal ``jnp.linalg.norm``'s on XLA's CPU; the
    expressions are float32 within 1 ulp, so an output is within 2 ulps
    of JAX's (a factor 1 ulp apart, rounded once more), except where a
    norm lies within 1 ulp of the threshold, where either side of the
    comparison is accepted: those pixels are counted and must be few."""
    flow = _flow(11, scale=2.0)
    flow[:4] = 0.0
    got = _port_filter(text, flow, t)
    want = _jax_filter(text, flow, t)
    norm = np.asarray(jnp.linalg.norm(jnp.asarray(flow), axis=-1))
    edge = np.zeros(norm.shape, bool)
    for name, args in filters.iter_specs(text):
        if name in ("threshold", "clip"):
            thr = float(np.float32(jfilters.FlowFilter.from_args(
                name, args).expr(jnp.float32(t))))
            edge |= np.abs(norm - thr) <= _spacing(thr)
    close = np.abs(got - want) <= 2 * _spacing(want)
    assert close[~edge].all()
    assert edge.sum() <= 2, edge.sum()


@pytest.mark.parametrize("text,bound", [
    ("polar=r:a", 4), ("polar=r*2:a+0.1*t", 4),
    ("polar=np.sqrt(r):-a", 4), ("polar=1:np.pi/4", 4)])
def test_polar_filter_within_ulps(text, bound):
    """polar: atan2, the two expressions, cos and sin in float32, each a
    different polynomial in torch and XLA; each output component within
    ``bound`` ulps of the output radius of JAX's."""
    flow = _flow(12, scale=3.0)
    t = 1.3
    got = _port_filter(text, flow, t)
    want = _jax_filter(text, flow, t)
    radius = np.linalg.norm(want, axis=-1, keepdims=True)
    assert (np.abs(got - want) <= bound * _spacing(radius)).all()


def test_mixed_chain_within_ulps():
    """A mixed chain: scale by np.sin(t)*2, clip, threshold, polar."""
    text = "scale=np.sin(t)*2;clip=4;threshold=0.5;polar=r:a+0.1*t"
    flow = _flow(13, scale=3.0)
    for t in (0.7, 5.1):
        got = _port_filter(text, flow, t)
        want = _jax_filter(text, flow, t)
        radius = np.linalg.norm(want, axis=-1, keepdims=True)
        bad = np.abs(got - want) > 8 * _spacing(np.maximum(radius, 0.5))
        # a norm at the 0.5 threshold may zero on one side only
        assert bad.any(axis=-1).sum() <= 2


def test_filter_grammar_matches_jax():
    text = " scale=2 ; polar=r:a ;clip=t;"
    assert filters.iter_specs(text) == jfilters.FlowFilter.iter_specs(text)
    for bad in ("blur=2", "polar=r"):
        with pytest.raises(ValueError) as got:
            filters.FlowFilter.parse_many(bad)
        with pytest.raises(ValueError) as want:
            jfilters.FlowFilter.parse_many(bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# conv2d_same
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ksize", [(3, 3), (4, 4), (5, 2), (1, 6), (7, 7),
                                   (6, 3)])
def test_conv2d_same_within_tolerance(ksize):
    """scipy's 'same' convolution (kernel flipped, extra tap on the low
    side for even sizes): ``F.conv2d`` adds in its own order, so within
    1e-5 of sum|k| * max|image|."""
    rng = np.random.default_rng(ksize[0] * 10 + ksize[1])
    plane = _flow(20)[..., 0]
    kernel = rng.standard_normal(ksize).astype(np.float32)
    got = image.conv2d_same(torch.from_numpy(plane), torch.from_numpy(kernel))
    want = np.asarray(jimage.conv2d_same(jnp.asarray(plane), kernel))
    scale = np.abs(kernel).sum() * np.abs(plane).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("ksize", [(3, 3), (4, 4), (5, 5), (2, 3)])
def test_conv2d_same_dyadic_bit_exact(ksize):
    """Dyadic taps on integer flows: every sum is exact, so equal."""
    rng = np.random.default_rng(ksize[0])
    plane = rng.integers(-20, 21, (H, W)).astype(np.float32)
    kernel = (rng.integers(0, 5, ksize) / 16).astype(np.float32)
    got = image.conv2d_same(torch.from_numpy(plane), torch.from_numpy(kernel))
    _equal(got, jimage.conv2d_same(jnp.asarray(plane), kernel))


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def _mask():
    ii, jj = np.indices((H, W))
    return ((ii * 7 + jj * 5) % 256 / 255.0).astype(np.float32)


DYADIC = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16

CHAINS = {
    "forward": dict(direction="forward"),
    "mask": dict(mask=True),
    "kernel": dict(kernel=DYADIC),
    "forward_mask_kernel_filters": dict(direction="forward", mask=True,
                                        kernel=DYADIC,
                                        filters="scale=2;clip=6;threshold=1"),
    "backward_filters": dict(filters="scale=0.5;clip=3"),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_postprocess_chain_bit_exact(name):
    """filters -> mask -> kernel -> direction -> clip on integer flows
    with a dyadic kernel and exact filters: equal to JAX's."""
    spec = CHAINS[name]
    direction = spec.get("direction", "backward")
    mask = _mask() if spec.get("mask") else None
    args = (spec.get("filters"), mask, spec.get("kernel"))
    pp = transforms.make_postprocess(*args, Direction.from_arg(direction),
                                     device="cpu")
    jpp = jtransforms.make_postprocess(*args,
                                       JaxDirection.from_arg(direction))
    flow = np.random.default_rng(9).integers(-12, 13, (H, W, 2)) \
        .astype(np.float32)
    for t in (0.0, 0.5):
        got = pp(torch.from_numpy(flow), np.float32(t))
        _equal(got, jpp(jnp.asarray(flow), jnp.float32(t)))
    assert (pp.mask is None) == (mask is None)


def test_postprocess_polar_chain_within_ulps():
    text = "polar=r:a+0.1*t"
    pp = transforms.make_postprocess(text, _mask(), DYADIC,
                                     Direction.BACKWARD, device="cpu")
    jpp = jtransforms.make_postprocess(text, _mask(), DYADIC,
                                       JaxDirection.BACKWARD)
    flow = _flow(14, scale=4.0)
    got = pp(torch.from_numpy(flow), np.float32(0.9)).numpy()
    want = np.asarray(jpp(jnp.asarray(flow), jnp.float32(0.9)))
    scale = np.abs(DYADIC).sum() * np.abs(flow).max()
    assert np.abs(got - want).max() <= 1e-5 * scale

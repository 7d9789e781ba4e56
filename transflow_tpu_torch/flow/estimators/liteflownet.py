"""LiteFlowNet (Hui et al., CVPR'18) in PyTorch.

Counterpart of transflow_tpu/flow/estimators/liteflownet.py, with the same
module tree and parameter names (``features.one0``, ``matching2.main0``,
...). Activations keep the JAX layout, (H, W, C) or (N, H, W, C)
contiguous; a convolution views them as NCHW in ``channels_last`` memory
format, so the (H, W, C) operands of the correlation cost no copy.

Plain convolutions are ``F.conv2d``; the 7x7 correlation is the CUDA kernel
of ``ops/correlation.py`` on the card and its plain version on the CPU
(``corr_kernel='pallas_halo'`` with a ``corr_mesh`` shards it over H), and
so are the two backwarps of ``ops/warp.py``: the exact one (kernel B7,
every warp by default and the regularization's always) and the bounded
one (kernel A3, ``warp_bound``, opt-in), and the two head loops of
``ops/lfn_heads.py``: the phase upsampler (kernel B16) and the
regularization's softmax tap apply (kernel B17); each convolution's bias
add and leaky ReLU are kernel B18 (``ops/conv_epilogue.py``).
Parameters are f32; convolutions compute in ``_compute_dtype`` (bf16 on
CUDA, f32 on the CPU), and everything else keeps JAX's dtype promotion so
the correlation sees the same operand dtypes as on the TPU.
"""
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..._device import resolve_device
from ...ops.conv_epilogue import conv_epilogue, leaky_relu
from ...ops.correlation import check_kernel, correlation
from ...ops.image import _taps_on
from ...ops.image import torch_bilinear_resize as bilinear_resize
from ...ops.lfn_heads import reg_apply, upsample2x_phases
from ...ops.warp import bounded_backwarp, exact_backwarp

_LEVELS = (2, 3, 4, 5, 6)
_FLT_BACKWARP = {2: 10.0, 3: 5.0, 4: 2.5, 5: 1.25, 6: 0.625}
_KERNEL = {2: 7, 3: 5, 4: 5, 5: 3, 6: 3}
_PAD = {2: 3, 3: 2, 4: 2, 5: 1, 6: 1}
_DIST_CH = {2: 49, 3: 25, 4: 25, 5: 9, 6: 9}
_FEAT_CH = {2: 32, 3: 64, 4: 96, 5: 128, 6: 192}

_MEAN_ONE = (0.411618, 0.434631, 0.454253)
_MEAN_TWO = (0.410782, 0.433645, 0.452793)

WEIGHTS_ENV = "TRANSFLOW_LITEFLOWNET_WEIGHTS"
RANDOM_ENV = "TRANSFLOW_LITEFLOWNET_RANDOM"
WARP_BOUND_ENV = "TRANSFLOW_LITEFLOWNET_WARP_BOUND"
WARP_KERNEL_ENV = "TRANSFLOW_LITEFLOWNET_WARP_KERNEL"


# JAX's nn.leaky_relu(x, 0.1), the slope rounded to x's dtype; a
# convolution's runs in its epilogue (``_Conv(..., leaky=True)``)
_leaky = leaky_relu


def _compute_dtype(device) -> torch.dtype:
    """bf16 on CUDA, f32 on the CPU; TRANSFLOW_LITEFLOWNET_BF16=0 forces
    f32 everywhere."""
    if os.environ.get("TRANSFLOW_LITEFLOWNET_BF16", "1") == "0":
        return torch.float32
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


class _Conv(nn.Module):
    """Flax ``nn.Conv`` counterpart on (N, H, W, C) or (H, W, C): f32
    parameters (OIHW), computed in the dtype the caller gives, and with
    ``leaky`` JAX's ``_leaky`` after it.

    Flax's order: the convolution is rounded to ``dtype``, then the bias,
    cast to ``dtype``, is added in ``dtype``. Passing the bias into
    ``F.conv2d`` would leave the order to the backend (a fused bias is
    added before the one rounding), so the convolution runs without it and
    ``conv_epilogue`` (kernel B18 on the card) adds it, reading the f32
    bias in place. The weight is cast to ``dtype`` once and kept until the
    parameter changes (``load_state_dict``, ``.to``)."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1,
                 pad=None):
        super().__init__()
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        if pad is None:
            pad = kh // 2
        self.padding = (pad, pad) if isinstance(pad, int) else tuple(pad)
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout))
        self._cast = (None, None)  # (stamp, the weight in its dtype)

    def weight_as(self, dtype) -> torch.Tensor:
        """The weight in ``dtype``, cast once for the parameter's device,
        storage and in-place version (a reload or a move casts again)."""
        w = self.weight
        if w.dtype == dtype:
            return w
        stamp = (dtype, w.dtype, w.device, w.data_ptr(), w._version)
        if self._cast[0] != stamp:
            self._cast = (stamp, w.detach().to(dtype))
        return self._cast[1]

    def forward(self, x, dtype, leaky=False):
        batched = x.dim() == 4
        x = x if batched else x[None]
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), self.weight_as(dtype),
                     None, self.stride, self.padding)
        y = conv_epilogue(y, self.bias, leaky)
        return y if batched else y[0]


def _env_warp_bound() -> int:
    """TRANSFLOW_LITEFLOWNET_WARP_BOUND parsed with context (0 if unset)."""
    value = os.environ.get(WARP_BOUND_ENV)
    if not value:
        return 0
    try:
        return int(value)
    except ValueError:
        raise ValueError(
            f"{WARP_BOUND_ENV}={value!r} is not an integer (pixels at level "
            "2; 0 disables)") from None


def _warp_bound(level: int, base: int | None = None) -> int | None:
    """Per-level displacement bound of the bounded backwarp.

    ``base`` is the level-2 bound; coarser levels halve it, floored at 3.
    None falls back to TRANSFLOW_LITEFLOWNET_WARP_BOUND; 0 (or an unset
    env) means the exact gather. Parity: liteflownet.py::_warp_bound."""
    if base is None:
        base = _env_warp_bound()
    if base < 0:
        raise ValueError(
            f"lfn_warp_bound must be >= 0, got {base} (0 disables the "
            "bounded kernel)")
    if not base:
        return None
    return max(3, int(base) >> (level - 2))


def backwarp(image: torch.Tensor, flow: torch.Tensor,
             bound: int | None = None,
             kernel: str | None = None) -> torch.Tensor:
    """Bilinear warp ``image[(i, j) + flow]`` with zero padding.

    (H, W, C) image (f32 or bf16 on the card), (H, W, 2) flow in pixels;
    the result is f32 (the bilinear weights are f32). The exact path is
    ``ops/warp.py::exact_backwarp`` (kernel B7), whose edge semantics
    follow JAX: the four taps are read at the clamped (y0, x0) anchor, so
    on the low edges the +1 taps fall back to the anchor slot, and the
    in-bounds masks use the raw float floors.

    ``bound``: honoured when the image has at least 16 channels, as in JAX.
    The warp then goes through ``ops/warp.py::bounded_backwarp`` (kernel
    A3), which clamps each axis's displacement floor to ``[-bound,
    bound]``. ``kernel`` names its variant, falling back to
    TRANSFLOW_LITEFLOWNET_WARP_KERNEL; 'select' is the only one."""
    if bound is not None and image.shape[-1] >= 16:
        if kernel is None:
            kernel = os.environ.get(WARP_KERNEL_ENV)
        kernel = kernel or "select"
        if kernel != "select":
            raise ValueError(
                f"warp kernel must be 'select', got {kernel!r} (the 'mxu' "
                "variant was removed: it never compiled on the real TPU "
                "toolchain)")
        return bounded_backwarp(image, flow, int(bound))
    return exact_backwarp(image, flow)


# ``ConvTranspose2d(k=4, s=2, p=1, groups=C, bias=False)`` on (H, W, C)
# with (C, 1, 4, 4) taps, the JAX function's exact phase decomposition:
# kernel B16 on the card (ops/lfn_heads.py). Parity: liteflownet.py:220.
_upsample2x_phases = upsample2x_phases


def _bilinear_deconv_taps(channels: int) -> torch.Tensor:
    """Bilinear-upsampling taps in the (C, 1, 4, 4) layout."""
    taps = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 16.0
    return torch.from_numpy(taps).expand(channels, 1, 4, 4).clone()


class Features(nn.Module):
    """6-level feature pyramid. Parity: liteflownet.py:417-461."""

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

    def forward(self, x, dtype):
        one = self.one0(x, dtype, leaky=True)
        two = self.two0(one, dtype, leaky=True)
        two = self.two1(two, dtype, leaky=True)
        two = self.two2(two, dtype, leaky=True)
        thr = self.thr0(two, dtype, leaky=True)
        thr = self.thr1(thr, dtype, leaky=True)
        fou = self.fou0(thr, dtype, leaky=True)
        fou = self.fou1(fou, dtype, leaky=True)
        fiv = self.fiv0(fou, dtype, leaky=True)
        six = self.six0(fiv, dtype, leaky=True)
        return [one, two, thr, fou, fiv, six]


class Matching(nn.Module):
    """Cost-volume matching head. Parity: liteflownet.py:463-503."""

    def __init__(self, level: int):
        super().__init__()
        self.level = level
        if level == 2:
            self.feat0 = _Conv(32, 64, 1, pad=0)
        if level != 6:
            self.upflow_kernel = nn.Parameter(_bilinear_deconv_taps(2))
        if level < 4:
            self.upcorr_kernel = nn.Parameter(_bilinear_deconv_taps(49))
        self.main0 = _Conv(49, 128, 3)
        self.main1 = _Conv(128, 64, 3)
        self.main2 = _Conv(64, 32, 3)
        self.main3 = _Conv(32, 2, _KERNEL[level], pad=_PAD[level])

    def forward(self, feat1, feat2, flow, dtype, warp_bound=None,
                warp_kernel=None, corr_kernel=None, corr_mesh=None):
        lvl = self.level
        if lvl == 2:
            both = self.feat0(torch.stack([feat1, feat2]), dtype,
                              leaky=True)
            feat1, feat2 = both[0], both[1]
        if flow is not None:
            flow = _upsample2x_phases(flow, self.upflow_kernel)
            feat2 = backwarp(feat2, flow * _FLT_BACKWARP[lvl],
                             bound=_warp_bound(lvl, warp_bound),
                             kernel=warp_kernel)
        corr = _leaky(correlation(feat1, feat2, stride=1 if lvl >= 4 else 2,
                                  kernel=corr_kernel, mesh=corr_mesh))
        if lvl < 4:
            corr = _upsample2x_phases(corr, self.upcorr_kernel)
        x = self.main0(corr, dtype, leaky=True)
        x = self.main1(x, dtype, leaky=True)
        x = self.main2(x, dtype, leaky=True)
        delta = self.main3(x, dtype)
        return delta if flow is None else flow + delta


class Subpixel(nn.Module):
    """Sub-pixel refinement head. Parity: liteflownet.py:505-531."""

    def __init__(self, level: int):
        super().__init__()
        self.level = level
        feat = 64 if level == 2 else _FEAT_CH[level]
        if level == 2:
            self.feat0 = _Conv(32, 64, 1, pad=0)
        self.main0 = _Conv(2 * feat + 2, 128, 3)
        self.main1 = _Conv(128, 64, 3)
        self.main2 = _Conv(64, 32, 3)
        self.main3 = _Conv(32, 2, _KERNEL[level], pad=_PAD[level])

    def forward(self, feat1, feat2, flow, dtype, warp_bound=None,
                warp_kernel=None):
        lvl = self.level
        if lvl == 2:
            both = self.feat0(torch.stack([feat1, feat2]), dtype,
                              leaky=True)
            feat1, feat2 = both[0], both[1]
        warped = backwarp(feat2, flow * _FLT_BACKWARP[lvl],
                          bound=_warp_bound(lvl, warp_bound),
                          kernel=warp_kernel)
        x = torch.cat([feat1, warped, flow], dim=-1)
        x = self.main0(x, dtype, leaky=True)
        x = self.main1(x, dtype, leaky=True)
        x = self.main2(x, dtype, leaky=True)
        return flow + self.main3(x, dtype)


class Regularization(nn.Module):
    """Feature-driven local flow regularization, with the fused tap apply
    of the JAX module (``fused_apply``, its default): the softmax over the
    distance convolution's taps and the tap apply are kernel B17 on the
    card (``ops/lfn_heads.py::reg_apply``), reading the scale convolutions'
    parameters in place. Parity: liteflownet.py:533-579."""

    def __init__(self, level: int):
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

    def forward(self, img1, img2, feat1, flow, dtype):
        lvl = self.level
        difference = torch.sqrt(torch.sum(torch.square(
            img1 - backwarp(img2, flow * _FLT_BACKWARP[lvl])), dim=-1,
            keepdim=True))
        if lvl < 5:
            feat1 = self.feat0(feat1, dtype, leaky=True)
        x = torch.cat([difference,
                       flow - flow.mean(dim=(0, 1), keepdim=True), feat1],
                      dim=-1)
        for conv in (self.main0, self.main1, self.main2, self.main3,
                     self.main4, self.main5):
            x = conv(x, dtype, leaky=True)
        dist = self.dist0(x, dtype)
        if lvl < 5:
            dist = self.dist1(dist, dtype)
        return reg_apply(dist, flow, self.scalex.weight, self.scalex.bias,
                         self.scaley.weight, self.scaley.bias)


class LiteFlowNet(nn.Module):
    """Full pyramid network. Parity: liteflownet.py:581-611.

    ``forward(img1, img2)`` takes two (H, W, 3) f32 images in [0, 1], H and
    W multiples of 32, and returns the (H/2, W/2, 2) f32 flow.
    ``warp_bound`` (the level-2 bound of the bounded backwarp, see
    ``_warp_bound``; None falls back to the env, 0 disables) and
    ``warp_kernel`` reach the matching and subpixel heads, ``corr_kernel``
    and ``corr_mesh`` (see ``ops/correlation.py::correlation``) the
    matching heads' correlation."""

    def __init__(self):
        super().__init__()
        self.features = Features()
        for lvl in _LEVELS:
            setattr(self, f"matching{lvl}", Matching(lvl))
            setattr(self, f"subpixel{lvl}", Subpixel(lvl))
            setattr(self, f"regularization{lvl}", Regularization(lvl))

    def forward(self, img1, img2, warp_bound=None, warp_kernel=None,
                corr_kernel=None, corr_mesh=None):
        dtype = _compute_dtype(img1.device)
        # the means copied to the device once, not every frame
        img1 = img1 - _taps_on(_MEAN_ONE, img1.device)
        img2 = img2 - _taps_on(_MEAN_TWO, img2.device)
        feats = self.features(torch.stack([img1, img2]), dtype)
        feats1 = [f[0] for f in feats]
        feats2 = [f[1] for f in feats]
        pair = [torch.cat([img1, img2], dim=-1)]
        for lvl in range(1, 6):
            shape = feats1[lvl].shape
            pair.append(bilinear_resize(pair[-1], shape[0], shape[1]))
        imgs1 = [p[..., :3] for p in pair]
        imgs2 = [p[..., 3:] for p in pair]
        flow = None
        for idx in (-1, -2, -3, -4, -5):
            lvl = _LEVELS[idx]
            flow = getattr(self, f"matching{lvl}")(
                feats1[idx], feats2[idx], flow, dtype, warp_bound,
                warp_kernel, corr_kernel, corr_mesh)
            flow = getattr(self, f"subpixel{lvl}")(
                feats1[idx], feats2[idx], flow, dtype, warp_bound,
                warp_kernel)
            flow = getattr(self, f"regularization{lvl}")(
                imgs1[idx], imgs2[idx], feats1[idx], flow, dtype)
        return flow * 20.0


# ---------------------------------------------------------------------------
# weights: from the JAX package's pytree, the JAX random branch, or the
# published torch checkpoint
# ---------------------------------------------------------------------------

def _flax_leaf(key: str) -> tuple:
    """Port state-dict key -> Flax parameter path (under 'params')."""
    *modules, leaf = key.split(".")
    if leaf == "weight":
        leaf = "kernel"
    return tuple(modules) + (leaf,)


def _from_flax(key: str, value: np.ndarray) -> torch.Tensor:
    """One Flax leaf in the port's layout: HWIO -> OIHW for convolutions,
    (4, 4, C) -> (C, 1, 4, 4) for the deconvolution taps."""
    value = np.asarray(value, dtype=np.float32)
    if key.endswith("_kernel"):
        return torch.from_numpy(value.transpose(2, 0, 1)[:, None].copy())
    if key.endswith(".weight"):
        return torch.from_numpy(value.transpose(3, 2, 0, 1).copy())
    return torch.from_numpy(value.copy())


def _flax_shape(key: str, shape) -> tuple:
    """The Flax shape of the port parameter ``key`` of ``shape``."""
    if key.endswith("_kernel"):
        return (shape[2], shape[3], shape[0])
    if key.endswith(".weight"):
        return (shape[2], shape[3], shape[1], shape[0])
    return tuple(shape)


def params_from_jax(variables: dict) -> dict:
    """The JAX package's Flax variables (numpy or jax leaves) as the port's
    state dict."""
    params = variables["params"]
    state = {}
    for key in LiteFlowNet().state_dict():
        node = params
        for part in _flax_leaf(key):
            node = node[part]
        state[key] = _from_flax(key, np.asarray(node))
    return state


def random_params(seed: int = 0) -> dict:
    """The deterministic random weights of the JAX random branch
    (liteflownet.py::_get_variables): ``0.02 * standard_normal`` from
    ``np.random.default_rng(seed)``, drawn in jax's leaf order (sorted
    keys) with the Flax shapes, so both packages hold the same weights."""
    shapes = {key: _flax_shape(key, value.shape)
              for key, value in LiteFlowNet().state_dict().items()}
    rng = np.random.default_rng(seed)
    state = {}
    for key in sorted(shapes, key=_flax_leaf):
        value = (0.02 * rng.standard_normal(shapes[key])).astype(np.float32)
        state[key] = _from_flax(key, value)
    return state


def _torch_key_map() -> dict:
    """Port key prefix -> key prefix of the sniklaus checkpoint (with
    'module' already renamed 'net'); liteflownet.py::convert_torch_state."""
    names = {"features.one0": "netFeatures.netOne.0",
             "features.two0": "netFeatures.netTwo.0",
             "features.two1": "netFeatures.netTwo.2",
             "features.two2": "netFeatures.netTwo.4",
             "features.thr0": "netFeatures.netThr.0",
             "features.thr1": "netFeatures.netThr.2",
             "features.fou0": "netFeatures.netFou.0",
             "features.fou1": "netFeatures.netFou.2",
             "features.fiv0": "netFeatures.netFiv.0",
             "features.six0": "netFeatures.netSix.0"}
    for idx, lvl in enumerate(_LEVELS):
        mat, sub = f"netMatching.{idx}", f"netSubpixel.{idx}"
        reg = f"netRegularization.{idx}"
        if lvl == 2:
            names[f"matching{lvl}.feat0"] = f"{mat}.netFeat.0"
            names[f"subpixel{lvl}.feat0"] = f"{sub}.netFeat.0"
        if lvl != 6:
            names[f"matching{lvl}.upflow_kernel"] = f"{mat}.netUpflow.weight"
        if lvl < 4:
            names[f"matching{lvl}.upcorr_kernel"] = f"{mat}.netUpcorr.weight"
        for i, t in enumerate((0, 2, 4, 6)):
            names[f"matching{lvl}.main{i}"] = f"{mat}.netMain.{t}"
            names[f"subpixel{lvl}.main{i}"] = f"{sub}.netMain.{t}"
        if lvl < 5:
            names[f"regularization{lvl}.feat0"] = f"{reg}.netFeat.0"
            names[f"regularization{lvl}.dist1"] = f"{reg}.netDist.1"
        for i, t in enumerate((0, 2, 4, 6, 8, 10)):
            names[f"regularization{lvl}.main{i}"] = f"{reg}.netMain.{t}"
        names[f"regularization{lvl}.dist0"] = f"{reg}.netDist.0"
        names[f"regularization{lvl}.scalex"] = f"{reg}.netScaleX"
        names[f"regularization{lvl}.scaley"] = f"{reg}.netScaleY"
    return names


def torch_state_keys() -> dict:
    """Port state-dict key -> its key in the sniklaus checkpoint (with
    'module' renamed 'net')."""
    names = _torch_key_map()
    keys = {}
    for key in LiteFlowNet().state_dict():
        prefix, leaf = key.rsplit(".", 1)
        keys[key] = names[key] if key.endswith("_kernel") \
            else f"{names[prefix]}.{leaf}"
    return keys


def params_from_torch_state(state: dict) -> dict:
    """The sniklaus state dict (``network-default.pytorch`` layout; conv
    weights are already OIHW) as the port's state dict."""
    state = {key.replace("module", "net"): value
             for key, value in state.items()}
    return {key: torch.as_tensor(state[src], dtype=torch.float32)
            for key, src in torch_state_keys().items()}


def load_torch_weights(path: str) -> dict:
    """Load the published checkpoint (zip or legacy format) as the port's
    state dict. ``weights_only`` refuses anything but tensors."""
    return params_from_torch_state(
        torch.load(path, map_location="cpu", weights_only=True))


def get_weights(allow_random: bool = False, device=None) -> LiteFlowNet:
    """The network with its weights: the checkpoint named by
    TRANSFLOW_LITEFLOWNET_WEIGHTS, else (``allow_random`` or
    TRANSFLOW_LITEFLOWNET_RANDOM set) the JAX package's random weights."""
    path = os.environ.get(WEIGHTS_ENV)
    if path and os.path.isfile(path):
        state = load_torch_weights(path)
    elif allow_random or os.environ.get(RANDOM_ENV):
        state = random_params(0)
    else:
        raise FileNotFoundError(
            "LiteFlowNet weights not found. Download network-default.pytorch"
            f" (sniklaus/pytorch-liteflownet) and point {WEIGHTS_ENV} at it, "
            f"or set {RANDOM_ENV}=1 for random weights.")
    net = LiteFlowNet()
    net.load_state_dict(state)
    return net.to(resolve_device(device)).eval().requires_grad_(False)


def _to_rgb01(image) -> torch.Tensor:
    """uint8 (H, W, 3) RGB or (H, W) gray -> f32 BGR in [0, 1] (the
    reference feeds the network BGR)."""
    if image.dim() == 2:
        image = image[..., None].expand(-1, -1, 3)
    return image.flip(-1).float() / 255.0


@torch.no_grad()
def liteflownet(prev_gray_or_rgb, next_gray_or_rgb, *, net=None,
                allow_random: bool = False, warp_bound: int | None = None,
                warp_kernel: str | None = None,
                corr_kernel: str | None = None, corr_mesh=None,
                scale: float = 1.0) -> torch.Tensor:
    """Estimate the (H, W, 2) f32 flow between two uint8 frames, RGB
    (H, W, 3) or gray (H, W), on the device of ``net``.

    Parity: liteflownet.py::liteflownet: resize to a multiple of 32, run,
    resize back, rescale magnitudes. ``net`` is a ``LiteFlowNet`` with its
    weights (``get_weights``); None builds one from the environment, on
    the current CUDA device.
    ``warp_bound`` and ``warp_kernel`` fall back to their environment
    variables on each call (config key ``lfn_warp_bound``). ``corr_kernel``
    and ``corr_mesh`` (a ``SpaceMesh``) reach the correlation."""
    check_kernel(corr_kernel, corr_mesh)
    if warp_bound is None:
        warp_bound = _env_warp_bound() or None
    if warp_kernel is None:
        warp_kernel = os.environ.get(WARP_KERNEL_ENV) or None
    if not 0.0 < scale <= 1.0:
        raise ValueError(f"lfn_scale must be in (0, 1], got {scale}")
    if net is None:
        net = get_weights(allow_random)
    device = next(net.parameters()).device
    img1 = _to_rgb01(torch.as_tensor(prev_gray_or_rgb, device=device))
    img2 = _to_rgb01(torch.as_tensor(next_gray_or_rgb, device=device))
    h, w = img1.shape[:2]
    ph = max(32, int(np.ceil(h * scale / 32.0) * 32))
    pw = max(32, int(np.ceil(w * scale / 32.0) * 32))
    if (ph, pw) != (h, w):
        img1 = bilinear_resize(img1, ph, pw)
        img2 = bilinear_resize(img2, ph, pw)
    flow = bilinear_resize(net(img1, img2, warp_bound, warp_kernel,
                               corr_kernel, corr_mesh), h, w)
    return flow * _taps_on((w / pw, h / ph), device)

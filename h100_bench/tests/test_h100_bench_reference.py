"""The plain reference against the port's plain path at a small size on
the CPU: the reference imports nothing of the port, so this test holds
the two together. Each comparison is exact: the reference is a frozen copy
of the arithmetic the port's plain versions do, in the same order."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from h100_bench.reference import farneback as ref_fb
from h100_bench.reference import layer_moveref as ref_layer
from h100_bench.reference import liteflownet as ref_lfn
from h100_bench.reference import prng as ref_prng
from h100_bench.reference.image import clip_to_frame
from tiny import ROOT

H, W = 48, 72


def _frames(seed, channels=None):
    gen = torch.Generator().manual_seed(seed)
    shape = (H, W) if channels is None else (H, W, channels)
    return [torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
            for _ in range(2)]


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16])
def test_poly_expansion_matches_the_port(storage):
    from transflow_tpu_torch.ops.farneback import poly_expansion_plain
    image, _ = _frames(1)
    got = poly_expansion_plain(image.float(), 5, 1.2, storage)
    want = ref_fb.poly_expansion(image.float(), 5, 1.2, storage)
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_farneback_matches_the_port(seed):
    from transflow_tpu_torch.flow.estimators.farneback import farneback
    a, b = _frames(seed)
    cv = {"fb_pyr_scale": 0.5, "fb_levels": 3, "fb_winsize": 15,
          "fb_iterations": 3, "fb_poly_n": 5, "fb_poly_sigma": 1.2}
    want = farneback(a, b)
    got = ref_fb.estimate(a, b, cv, torch.float32)
    assert torch.equal(got, want)


def test_farneback_control_rounds_the_coefficients():
    a, b = _frames(5)
    precision = {"storage": "float32",
                 "control": "coefficients_float8_e4m3fn"}
    exact = ref_fb.flow(a, b, {}, "backward", precision)
    control = ref_fb.flow(a, b, {}, "backward", precision, "control")
    assert not torch.equal(exact, control)
    assert torch.isfinite(control).all()
    bf16 = ref_fb.flow(a, b, {}, "backward", dict(precision,
                                                  storage="bfloat16"))
    f32 = ref_fb.flow(a, b, {}, "backward", dict(precision,
                                                 storage="bfloat16"),
                      "float32")
    assert torch.equal(f32, exact) and not torch.equal(bf16, exact)


def test_prng_matches_the_port():
    from transflow_tpu_torch import prng
    key = prng.key(2 ** 31 + 7)
    assert np.array_equal(ref_prng.key(2 ** 31 + 7), key)
    assert np.array_equal(ref_prng.split(key, 3), prng.split(key, 3))
    assert torch.equal(ref_prng.uniform(key, (5, 7)),
                       prng.uniform(key, (5, 7)))


def test_moveref_update_and_render_match_the_port():
    from transflow_tpu_torch.compositor.core import (build_compositor,
                                                     make_layer_params)
    from transflow_tpu_torch.config import LayerConfig
    from transflow_tpu_torch import prng
    layer = {"classname": "moveref", "reset_mode": "random",
             "reset_random_factor": 0.3}
    cfg = LayerConfig(0, reset_mode="random", reset_random_factor=0.3)
    params = make_layer_params([cfg], H, W, {0: [(3, None)]}, device="cpu")
    init, step = build_compositor(params, H, W, "#ffffff", device="cpu")
    gen = torch.Generator().manual_seed(9)
    pixmap = torch.randint(0, 256, (H, W, 3), generator=gen,
                           dtype=torch.uint8)
    port_state, ref_state = init(), ref_layer.init_state(H, W, "cpu")
    key = prng.key(11)
    for _ in range(4):
        flow = clip_to_frame(6 * torch.randn((H, W, 2), generator=gen))
        key, sub = prng.split(key)
        port_state, frame = step(port_state, flow, ((pixmap,),), sub,
                                 ((0,),))
        ref_state = ref_layer.update(ref_state, flow, pixmap,
                                     ref_prng.split(sub, 1)[0], layer)
        ref_frame = ref_layer.render(ref_state, "#ffffff")
        for name in ref_layer.LAYER_KEYS:
            assert torch.equal(port_state[0][name], ref_state[name]), name
        assert torch.equal(frame, ref_frame)


def test_frame_keys_follow_the_engine():
    from transflow_tpu_torch import prng
    key, subs = prng.key(77), []
    for _ in range(6):
        key, sub = prng.split(key)
        subs.append(prng.split(sub, 1)[0])
    assert all(np.array_equal(a, b) for a, b in zip(
        ref_prng.frame_keys(77, 2, 4), subs[2:]))


@pytest.mark.parametrize("channels", [3])
def test_liteflownet_matches_the_port(channels):
    from transflow_tpu_torch.flow.estimators.liteflownet import (
        LiteFlowNet, liteflownet)
    from h100_bench import traffic
    template = ref_lfn.template()
    state = traffic.make_weights({"weights": {"init": "he_normal",
                                              "bias_std": 0.01}},
                                 template, torch.Generator().manual_seed(3),
                                 "cpu")
    net = LiteFlowNet()
    net.load_state_dict(state)
    net.eval().requires_grad_(False)
    a, b = _frames(13, channels)
    want = liteflownet(a, b, net=net, warp_bound=0)
    got = ref_lfn.flow(a, b, {"lfn_warp_bound": 0}, "forward",
                       {"conv": "float32"}, net=ref_lfn.network(state, "cpu"))
    assert torch.equal(got, want)
    assert torch.isfinite(got).all() and got.abs().max() > 0


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys; import h100_bench.reference.farneback, "
            "h100_bench.reference.liteflownet, "
            "h100_bench.reference.layer_moveref, h100_bench.check; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'transflow_tpu', "
            "'transflow_tpu_torch')); print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=False)
    assert out.returncode == 0, out.stdout + out.stderr

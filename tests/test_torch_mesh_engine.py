"""The port's Engine under a space mesh against the JAX package's.

``Engine(mesh=SpaceMesh(["cpu"] * 2), halo=4)`` against the JAX
``Engine(mesh=make_space_mesh(2), halo=4)`` on the virtual CPU mesh of
tests/conftest.py: over a flow-yielding source the frames, flows and states
are bit-equal, random resets included; over a LiteFlowNet frame source the
correlation runs sharded, the bounded warp is stripped with a warning, and
the flows meet the network bar.
"""
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_engine import FPS, NET_TOL, _flows, _pixmap, _source, _video
from transflow_tpu import config as jconfig
from transflow_tpu import engine as jengine
from transflow_tpu.compositor import core as jcore
from transflow_tpu.flow.estimators import liteflownet as jlfn
from transflow_tpu.flow.sources import base as jbase
from transflow_tpu.flow.sources import cv as jcv
from transflow_tpu.parallel.mesh import make_space_mesh as jax_space_mesh
from transflow_tpu_torch import config, engine
from transflow_tpu_torch.compositor import core
from transflow_tpu_torch.flow.sources import base, cv
from transflow_tpu_torch.ops import compositor as ck
from transflow_tpu_torch.ops import correlation, halo_gather, warp
from transflow_tpu_torch.parallel import SpaceMesh

H, W = 24, 32
HALO = 4


def _mesh_engines(layer_kwargs, sources, h=H, w=W, n=2, halo=HALO):
    lp = core.make_layer_params([config.LayerConfig(0, **layer_kwargs)],
                                h, w, {0: [(3, None)]}, device="cpu")
    jlp = jcore.make_layer_params([jconfig.LayerConfig(0, **layer_kwargs)],
                                  h, w, {0: [(3, None)]})
    cfg = dict(direction="backward", seed=5)
    eng = engine.Engine(config.Config("in.mp4", **cfg),
                        [s for s, _ in sources], lp, h, w, export_flows=True,
                        mesh=SpaceMesh(["cpu"] * n), halo=halo)
    jeng = jengine.Engine(jconfig.Config("in.mp4", **cfg),
                          [j for _, j in sources], jlp, h, w,
                          export_flows=True, mesh=jax_space_mesh(n),
                          halo=halo)
    eng._framerate = jeng._framerate = FPS
    return eng, jeng


@pytest.mark.parametrize("path", ["frame", "chunk"])
def test_mesh_engine_matches_jax(path):
    """Flows reach 6 px, past the halo of 4, so the clamp runs on both."""
    flows = _flows(6)
    eng, jeng = _mesh_engines(
        dict(reset_mode="random", reset_random_factor=0.2,
             moving_pixels_leave_empty_spot=True),
        [(_source(base, flows, "flow"), _source(jbase, flows, "flow"))])
    pix = _pixmap(H, W)
    if path == "frame":
        out = [eng.process_frame([it], ((torch.from_numpy(pix),),), k / FPS,
                                 ((k,),))
               for k, it in enumerate(eng.runtimes[0].source)]
        jout = [jeng.process_frame([it], ((jnp.asarray(pix),),), k / FPS,
                                   ((k,),))
                for k, it in enumerate(jeng.runtimes[0].source)]
        frames = torch.stack([f for f, _ in out])
        flows_out = torch.stack([f for _, f in out])
        jframes = np.stack([np.asarray(f) for f, _ in jout])
        jflows = np.stack([np.asarray(f) for _, f in jout])
    else:
        frames, flows_out = eng.process_chunk([flows], ((pix,),),
                                              ((None,),), 0, 0)
        jframes, jflows = jeng.process_chunk(
            [flows], ((jnp.asarray(pix),),), ((None,),), 0, 0)
    assert frames.shape == (6, H, W, 3)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes))
    np.testing.assert_array_equal(flows_out.numpy(), np.asarray(jflows))
    for key, value in jeng.comp_state[0].items():
        np.testing.assert_array_equal(eng.comp_state[0][key].numpy(),
                                      np.asarray(value), err_msg=key)
    np.testing.assert_array_equal(eng.key,
                                  np.asarray(jax.random.key_data(jeng.key)))


def test_horn_schunck_mesh_engine_matches_meshless():
    """tests/test_parallel.py's Horn-Schunck model (32x128, two iterations,
    no early stop, random reset 0.05, backward) over a 2-shard mesh with a
    halo of 8 and a clip filter of 8 px (so the bounded gather is exact):
    the estimator runs whole on the mesh's first device, and the frames
    and flows equal the meshless Engine's bit for bit; the flows are
    within 1e-5 of the JAX mesh Engine's."""
    from test_torch_engine import _gray_video
    h, w = 32, 128
    video = _gray_video(6, h, w, seed=3)
    settings = dict(method="horn-schunck", hs_iterations=2, hs_delta=None)
    layer = dict(reset_mode="random", reset_random_factor=0.05)
    kw = dict(flow_filters="clip=8")
    eng, jeng = _mesh_engines(
        layer, [(_source(base, video, "frame", cv.CvFlowConfig(**settings),
                         **kw),
                 _source(jbase, video, "frame",
                         jcv.CvFlowConfig(**settings), **kw))],
        h=h, w=w, halo=8)
    lp = core.make_layer_params([config.LayerConfig(0, **layer)], h, w,
                                {0: [(3, None)]}, device="cpu")
    flat = engine.Engine(
        config.Config("in.mp4", direction="backward", seed=5),
        [_source(base, video, "frame", cv.CvFlowConfig(**settings), **kw)],
        lp, h, w, export_flows=True, device="cpu")
    flat._framerate = FPS
    pix = _pixmap(h, w)
    for k, (it, jit, fit) in enumerate(zip(eng.runtimes[0].source,
                                           jeng.runtimes[0].source,
                                           flat.runtimes[0].source)):
        frame, flow = eng.process_frame([it], ((torch.from_numpy(pix),),),
                                        k / FPS, ((k,),))
        _, jflow = jeng.process_frame([jit], ((jnp.asarray(pix),),),
                                      k / FPS, ((k,),))
        fframe, fflow = flat.process_frame([fit],
                                           ((torch.from_numpy(pix),),),
                                           k / FPS, ((k,),))
        assert torch.equal(frame, fframe) and torch.equal(flow, fflow), k
        np.testing.assert_allclose(flow.numpy(), np.asarray(jflow),
                                   atol=1e-5, err_msg=str(k))
    assert k == 4 and flow.abs().max() > 1.0


def test_mesh_engine_runs_the_sharded_gather(monkeypatch):
    """H=24 over 2 shards of 12 >= halo rows, a mesh that splits the
    movement: the moveref layer updates through K1's dispatcher with the
    halo, once a frame, and the sharded gather is never called (it equals
    the bounded gather that the halo selects, and the state lies whole on
    one device)."""
    sharded, halos = [], []
    monkeypatch.setattr(halo_gather, "sharded_bounded_gather",
                        lambda *a: sharded.append(a) or pytest.fail(
                            "the sharded gather ran"))
    layer_update = ck.layer_update
    monkeypatch.setattr(ck, "layer_update",
                        lambda *a: halos.append(a[5]) or layer_update(*a))
    flows = _flows(2)
    eng, _ = _mesh_engines(dict(reset_mode="linear"),
                           [(_source(base, flows, "flow"),
                             _source(jbase, flows, "flow"))])
    eng.process_chunk([flows], ((_pixmap(H, W),),), ((None,),), 0, 0)
    assert halos == [HALO] * 2 and sharded == []


def test_mesh_places_unsharded_work_on_its_first_device():
    mesh = SpaceMesh(["cpu"] * 2)
    eng = engine.Engine(config.Config("in.mp4", seed=0), [], [], H, W,
                        mesh=mesh, halo=HALO)
    assert eng.device == mesh.devices[0] and eng.mesh is mesh
    with pytest.raises(ValueError, match="disagrees"):
        engine.Engine(config.Config("in.mp4", seed=0), [], [], H, W,
                      mesh=mesh, device="meta")


def test_mesh_safe_kwargs_match_jax(caplog):
    """Off-mesh the estimator kwargs pass through; under a mesh the
    bounded warp is stripped with JAX's warning and LiteFlowNet's
    correlation is sharded over the mesh."""
    cfg = cv.CvFlowConfig(method="liteflownet", lfn_warp_bound=12)
    jcfg = jcv.CvFlowConfig(method="liteflownet", lfn_warp_bound=12)
    assert (engine.mesh_safe_estimator_kwargs(cfg, None)
            == jengine.mesh_safe_estimator_kwargs(jcfg, None)
            == {"warp_bound": 12, "scale": 1.0})
    mesh = SpaceMesh(["cpu"] * 2)
    with caplog.at_level(logging.WARNING, logger=engine.__name__):
        got = engine.mesh_safe_estimator_kwargs(cfg, mesh)
    assert "lfn_warp_bound=12 is ignored" in caplog.text
    jmesh = jax_space_mesh(2)
    want = jengine.mesh_safe_estimator_kwargs(jcfg, jmesh)
    assert got.pop("corr_mesh") is mesh and want.pop("corr_mesh") is jmesh
    assert got == want == {"warp_bound": 0, "scale": 1.0,
                           "corr_kernel": "pallas_halo"}
    assert engine.mesh_safe_kwargs({"x": 1}, "farneback", mesh) == {"x": 1}


@pytest.fixture
def random_weights(monkeypatch):
    monkeypatch.setenv("TRANSFLOW_LITEFLOWNET_RANDOM", "1")
    monkeypatch.delenv(jlfn.WEIGHTS_ENV, raising=False)
    monkeypatch.delenv("TRANSFLOW_LITEFLOWNET_BF16", raising=False)
    monkeypatch.delenv("TRANSFLOW_LITEFLOWNET_WARP_BOUND", raising=False)
    monkeypatch.setattr(jlfn, "_CACHE", {})


def test_liteflownet_mesh_engine_matches_jax(random_weights, monkeypatch,
                                             caplog):
    """A LiteFlowNet frame source at lfn_warp_bound=8, 64x96, 2 frames:
    the bounded warp is stripped (no launch, a warning), level 2's
    correlation runs over both shards, and the flows meet the network
    bar against the JAX mesh Engine."""
    warps, bands = [], []
    plain_warp = warp.bounded_backwarp_plain
    monkeypatch.setattr(warp, "bounded_backwarp_plain",
                        lambda *a: warps.append(a[2]) or plain_warp(*a))
    plain_band = correlation.correlation7x7_band
    monkeypatch.setattr(correlation, "correlation7x7_band",
                        lambda *a: bands.append(a[0].shape) or plain_band(*a))
    h, w = 64, 96
    video = _video(3, h, w)
    settings = dict(method="liteflownet", lfn_warp_bound=8)
    with caplog.at_level(logging.WARNING, logger=engine.__name__):
        eng, jeng = _mesh_engines(
            dict(reset_mode="random", reset_random_factor=0.1),
            [(_source(base, video, "frame", cv.CvFlowConfig(**settings)),
              _source(jbase, video, "frame", jcv.CvFlowConfig(**settings)))],
            h=h, w=w, halo=8)
    assert "lfn_warp_bound=8 is ignored" in caplog.text
    pix = _pixmap(h, w)
    for k, (item, jitem) in enumerate(zip(eng.runtimes[0].source,
                                          jeng.runtimes[0].source)):
        frame, flow = eng.process_frame([item], ((torch.from_numpy(pix),),),
                                        k / FPS, ((k,),))
        jframe, jflow = jeng.process_frame([jitem], ((jnp.asarray(pix),),),
                                           k / FPS, ((k,),))
        assert frame.shape == (h, w, 3) and frame.dtype == torch.uint8
        np.testing.assert_allclose(flow.numpy(), np.asarray(jflow),
                                   atol=NET_TOL, rtol=NET_TOL)
        assert bands == [(16, 48, 64)] * 2 * (k + 1)
    assert warps == []

"""The port's ``stream`` mesh axis against the JAX package's: ``fold_in``,
``make_mesh``, ``sharded_scan`` and the batch renderer.

JAX runs on the virtual 8-device CPU mesh of tests/conftest.py; the port
over ``make_mesh(devices=["cpu"] * n)`` (real rows, real shards and halo
exchange, in one process). Horn-Schunck, as the batch renderer runs it:
``max_iters=2, delta=None`` here."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transflow_tpu.config import LayerConfig as JaxLayerConfig
from transflow_tpu.model import FlowTransferModel as JaxModel
from transflow_tpu.parallel import make_mesh as jmake_mesh
from transflow_tpu.parallel import shard_model_inputs as jshard
from transflow_tpu.parallel import sharded_scan as jsharded_scan
from transflow_tpu_torch import prng
from transflow_tpu_torch.config import LayerConfig
from transflow_tpu_torch.model import FlowTransferModel
from transflow_tpu_torch.parallel import (SpaceMesh, make_mesh,
                                          shard_model_inputs, sharded_scan)
from transflow_tpu_torch.tools import batch_render as tool
from transflow_tpu_torch.utils.imageio import read_netpbm, write_netpbm

H, W = 32, 64
CHUNK = 4
KWARGS = dict(method="horn-schunck",
              estimator_kwargs=dict(max_iters=2, delta=None))
LAYER = dict(reset_mode="random", reset_random_factor=0.05)
FLOW_ATOL = 1e-5       # tests/test_torch_horn_schunck.py's bar
FRAME_SHARE = 0.01     # tests/test_torch_model.py's: flows that round apart


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_fold_in_matches_jax(seed):
    key = jax.random.key(seed)
    for data in [0, 1, 2, 9, 17, 1000, 2**31, 2**32 - 1]:
        want = np.asarray(jax.random.key_data(jax.random.fold_in(key, data)))
        np.testing.assert_array_equal(prng.fold_in(prng.key(seed), data),
                                      want)
    split = jax.random.split(key, 3)
    for k, jk in zip(prng.split(prng.key(seed), 3), split):
        np.testing.assert_array_equal(
            prng.fold_in(k, 5),
            np.asarray(jax.random.key_data(jax.random.fold_in(jk, 5))))


@pytest.mark.parametrize("n,stream_axis", [
    (n, s) for n in (1, 2, 4, 8) for s in (None, 1, 2)
    if s is None or n % s == 0])
def test_make_mesh_shapes_match_jax(n, stream_axis):
    want = jmake_mesh(n, stream_axis)
    mesh = make_mesh(n, stream_axis, devices=["cpu"] * 8)
    assert mesh.shape == dict(want.shape)
    assert len(mesh.rows) == mesh.shape["stream"]
    assert all(isinstance(r, SpaceMesh) and
               len(r.devices) == mesh.shape["space"] for r in mesh.rows)
    assert len(mesh.devices) == n


def test_make_mesh_refusals():
    with pytest.raises(ValueError, match="do not form"):
        make_mesh(6, 4, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="do not form"):
        make_mesh(devices=[])


def _clip(n, pan, seed, h=H, w=W):
    """(n, h, w) uint8: a random texture panned ``pan`` px a frame along
    both axes (a negative pan from the far corner)."""
    rng = np.random.default_rng(seed)
    a = abs(pan)
    canvas = rng.integers(0, 256, (h + n * a, w + n * a), dtype=np.uint8)
    offs = [i * a if pan >= 0 else (n - i) * a for i in range(n)]
    return np.stack([canvas[o:o + h, o:o + w] for o in offs])


def _streams(n_streams=2, frames=CHUNK + 1):
    clips = [_clip(frames, 2 if s % 2 == 0 else -1, seed=10 + s)
             for s in range(n_streams)]
    pixmaps = [np.random.default_rng(20 + s).integers(
        0, 256, (H, W, 3), dtype=np.uint8) for s in range(n_streams)]
    return clips, pixmaps


def _jax_run(clips, pixmaps, space, halo, per_stream, seed=3):
    n = len(clips)
    filters = f"clip={halo}" if halo else None
    model = JaxModel(H, W, [JaxLayerConfig(0, **LAYER)], flow_filters=filters,
                     halo=halo, **KWARGS)
    mesh = jmake_mesh(n * space, stream_axis=n)
    state = jax.tree.map(lambda *xs: jnp.stack(xs),
                         *[model.init_state(c[0]) for c in clips])
    keys = jax.random.split(jax.random.key(seed), n)
    grays = jnp.asarray(np.stack([c[1:] for c in clips]))
    if per_stream:
        pix = ((jnp.asarray(np.stack(pixmaps)),),)
    else:
        pix = ((jnp.asarray(pixmaps[0]),),)
    st, gr, pm, ks = jshard(mesh, state, grays, ((jnp.asarray(pixmaps[0]),),),
                            keys)
    with mesh:
        state, rgbs = jsharded_scan(model, mesh, per_stream)(
            st, gr, pix if per_stream else pm, jnp.float32(0.0), ks)
    return np.asarray(state["prev_flow"]), np.asarray(rgbs)


def _port_model(halo):
    return FlowTransferModel(H, W, [LayerConfig(0, **LAYER)],
                             flow_filters=f"clip={halo}" if halo else None,
                             halo=halo, device="cpu", **KWARGS)


def _port_run(model, clips, pixmaps, space, per_stream, seed=3):
    n = len(clips)
    mesh = make_mesh(devices=["cpu"] * (n * space), stream_axis=n)
    state = [model.init_state(torch.from_numpy(c[0])) for c in clips]
    keys = prng.split(prng.key(seed), n)
    grays = np.stack([c[1:] for c in clips])
    shared = ((torch.from_numpy(pixmaps[0]),),)
    st, gr, pm, ks = shard_model_inputs(mesh, state, grays, shared, keys)
    pix = [((torch.from_numpy(p),),) for p in pixmaps] if per_stream \
        else shared
    return sharded_scan(model, mesh, per_stream)(st, gr, pix, 0.0, ks)


@pytest.mark.parametrize("per_stream", [True, False],
                         ids=["own_pixmaps", "shared_pixmap"])
@pytest.mark.parametrize("space,halo", [(1, None), (2, 6)],
                         ids=["stream2", "stream2xspace2_halo6"])
def test_sharded_scan_matches_jax(space, halo, per_stream):
    """``sharded_scan`` against JAX's over two streams with opposite pans
    and their own pixmaps: each stream's raw flow within 1e-5 of JAX's,
    its frames equal but for flows that round apart (<= 1 % of pixels);
    and each stream bit-equal to the port's ``model.scan`` alone with its
    key and pixmap (under space 2, a replica over the row's shards)."""
    clips, pixmaps = _streams()
    want_flow, want_rgb = _jax_run(clips, pixmaps, space, halo, per_stream)
    model = _port_model(halo)
    states, rgbs = _port_run(model, clips, pixmaps, space, per_stream)
    assert len(states) == len(rgbs) == 2
    keys = prng.split(prng.key(3), 2)
    for s in range(2):
        flow = states[s]["prev_flow"].numpy()
        np.testing.assert_allclose(flow, want_flow[s], atol=FLOW_ATOL, rtol=0)
        assert np.abs(want_flow[s]).max() > 0.5      # the pan is found
        assert rgbs[s].shape == (CHUNK, H, W, 3)
        for k in range(CHUNK):
            differ = (rgbs[s][k].numpy() != want_rgb[s, k]).any(-1).mean()
            assert differ <= FRAME_SHARE, (s, k, differ)
        pix = ((torch.from_numpy(pixmaps[s if per_stream else 0]),),)
        alone_state, alone = model.scan(
            model.init_state(torch.from_numpy(clips[s][0])),
            torch.from_numpy(clips[s][1:]), pix, 0.0, keys[s])
        assert torch.equal(rgbs[s], alone), s
        assert torch.equal(states[s]["prev_flow"], alone_state["prev_flow"])
    assert not torch.equal(rgbs[0], rgbs[1])


def test_sharded_scan_replicas():
    """A row on other devices than the model's runs a replica built with
    the same arguments there; the model's own row runs the model."""
    model = FlowTransferModel(H, W, device="cpu", **KWARGS)
    assert model.replica(device="cpu") is model
    mesh = SpaceMesh(["cpu"] * 2)
    other = model.replica(mesh=mesh, device="cpu")
    assert other is not model and other.mesh is mesh
    assert other.replica(mesh=SpaceMesh(["cpu"] * 2)) is other
    clips, pixmaps = _streams(4, frames=3)
    states, rgbs = _port_run(model, clips, pixmaps, 2, True, seed=0)
    assert len(states) == len(rgbs) == 4
    with pytest.raises(ValueError, match="multiple"):
        sharded_scan(model, make_mesh(devices=["cpu"] * 2, stream_axis=2))(
            states[:3], [c[1:] for c in clips[:3]],
            ((torch.from_numpy(pixmaps[0]),),), 0.0,
            prng.split(prng.key(0), 3))


# ---------------------------------------------------------------------------
# the batch renderer
# ---------------------------------------------------------------------------

TOOL_FRAMES = 9


@pytest.fixture(scope="module")
def tool_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch_torch")
    clips, pixmaps = _streams(2, frames=TOOL_FRAMES)
    pairs = []
    for s, (clip, pix) in enumerate(zip(clips, pixmaps)):
        (root / f"f{s}").mkdir()
        for i, frame in enumerate(clip):
            write_netpbm(str(root / f"f{s}" / f"{i:04d}.pgm"), frame)
        write_netpbm(str(root / f"pix{s}.ppm"), pix)
        pairs.append((str(root / f"f{s}" / "%04d.pgm"),
                      str(root / f"pix{s}.ppm")))
    return root, clips, pixmaps, pairs


def _scan_frames(clips, pixmaps, space, halo, seed, chunk):
    """The tool's run by hand: ``sharded_scan`` per chunk with the JAX
    tool's keys (``split(key(seed), S)``, ``fold_in(k, start)``)."""
    model = _port_model(halo)
    mesh = make_mesh(devices=["cpu"] * (2 * space), stream_axis=2)
    run = sharded_scan(model, mesh, per_stream_pixmaps=True)
    state = [model.init_state(torch.from_numpy(c[0])) for c in clips]
    pix = [((torch.from_numpy(p),),) for p in pixmaps]
    keys = prng.split(prng.key(seed), 2)
    out, t0 = [[], []], 0.0
    for start in range(1, TOOL_FRAMES, chunk):
        stop = min(start + chunk, TOOL_FRAMES)
        state, rgbs = run(state, [c[start:stop] for c in clips], pix, t0,
                          [prng.fold_in(k, start) for k in keys])
        for s in range(2):
            out[s].extend(rgbs[s].numpy())
        t0 += (stop - start) / 25.0
    return [np.stack(o) for o in out]


@pytest.mark.parametrize("space,halo", [(1, None), (2, 6)],
                         ids=["stream2", "stream2xspace2_halo6"])
def test_batch_render_two_streams(tool_inputs, tmp_path, space, halo):
    """Two streams that differ, each written as ``%04d`` frames equal to
    its ``sharded_scan`` frames."""
    root, clips, pixmaps, pairs = tool_inputs
    mesh = make_mesh(devices=["cpu"] * (2 * space), stream_axis=2)
    paths = tool.batch_render(
        pairs, str(tmp_path / "out"), chunk=4, halo=halo, seed=3,
        estimator_kwargs=KWARGS["estimator_kwargs"],
        output="s{stream:02d}/%04d.ppm", mesh=mesh)
    want = _scan_frames(clips, pixmaps, space, halo, seed=3, chunk=4)
    got = []
    for s, path in enumerate(paths):
        frames = np.stack([read_netpbm(path % i)
                           for i in range(TOOL_FRAMES - 1)])
        np.testing.assert_array_equal(frames, want[s])
        got.append(frames)
    assert not np.array_equal(got[0], got[1])


def test_batch_render_mp4_and_cli(tool_inputs, tmp_path, monkeypatch):
    """The tool's command line with MP4 outputs named by ``--output`` (H.264
    by the name's container, through the libav writer): each file reopens
    with the streams' size and frame count."""
    from transflow_tpu_torch import av_native
    import transflow_tpu_torch.parallel.mesh as mesh_module
    if not av_native.is_available():
        pytest.skip("native libav shim unavailable")
    root, clips, pixmaps, pairs = tool_inputs
    real = mesh_module.make_mesh
    # the command line builds make_mesh() over the CUDA devices
    monkeypatch.setattr(mesh_module, "make_mesh",
                        lambda: real(devices=["cpu"] * 2))
    tool.main([str(tmp_path / "out"), *[":".join(p) for p in pairs],
               "--chunk", "3", "--reset", "random:0.05",
               "--output", "stream{stream:02d}.mp4"])
    for s in range(2):
        with av_native.MvReader(str(tmp_path / "out" / f"stream{s:02d}.mp4")
                                ) as reader:
            assert (reader.height, reader.width) == (H, W)
            count = 0
            while reader.next() is not None:
                count += 1
        assert count == TOOL_FRAMES - 1


@pytest.mark.parametrize("output,vcodec", [
    ("stream{stream:02d}.avi", "mjpeg"), ("STREAM{stream:02d}.AVI", "mjpeg"),
    ("stream{stream:02d}.mp4", "h264"), ("stream{stream:02d}.mkv", "h264")])
def test_batch_render_codec_follows_output_name(output, vcodec):
    """An ``.avi`` output is written in MJPG, as the JAX tool writes it;
    any other container in H.264."""
    assert tool.output_vcodec(output) == vcodec


def test_batch_render_stream_count_must_fit_mesh(tool_inputs, tmp_path):
    root, clips, pixmaps, pairs = tool_inputs
    with pytest.raises(ValueError, match="multiple"):
        tool.batch_render([pairs[0]] * 3, str(tmp_path / "bad"),
                          mesh=make_mesh(devices=["cpu"] * 2,
                                         stream_axis=2))


def test_batch_render_needs_a_card_by_default(tool_inputs, tmp_path,
                                              monkeypatch):
    root, clips, pixmaps, pairs = tool_inputs
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="do not form"):
        tool.batch_render(pairs, str(tmp_path / "none"))

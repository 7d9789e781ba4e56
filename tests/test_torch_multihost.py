"""The port's multi-host layer (``parallel/multihost.py``) against the JAX
package's: the global mesh's layout on fake device lists, and two gloo
processes running the global ``stream x space`` mesh.

The layout cases are tests/test_multihost.py's, each against JAX's
``make_global_mesh`` on the same list. The two-process test is
tests/test_multihost_e2e.py's worker over ``torch.distributed``: each
worker imports no jax and writes its streams, its A2 output and its
all-reduced total; this process holds them to JAX's single-device
``jit_scan`` and interpreted kernel, and to the port's single-process
``sharded_scan``."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transflow_tpu.config import LayerConfig as JaxLayerConfig
from transflow_tpu.flow import Direction as JaxDirection
from transflow_tpu.model import FlowTransferModel as JaxModel
from transflow_tpu.ops.pallas_correlation import pallas_correlation7x7
from transflow_tpu.parallel.multihost import (
    global_mesh_grid as jglobal_mesh_grid, make_global_mesh as jglobal_mesh)
from transflow_tpu_torch import prng
from transflow_tpu_torch.config import LayerConfig
from transflow_tpu_torch.flow import Direction
from transflow_tpu_torch.model import FlowTransferModel
from transflow_tpu_torch.parallel import (RemoteRow, SpaceMesh, StreamMesh,
                                          global_mesh_grid, initialize,
                                          make_global_mesh, make_mesh,
                                          shard_model_inputs, sharded_scan)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOW_ATOL = 1e-5       # tests/test_torch_stream_mesh.py's bars
FRAME_SHARE = 0.01
# A2 against JAX's interpreted kernel: the JAX worker's 2e-7, and beside it
# tests/test_torch_sharded_correlation.py's 2 ulp relative (the plain
# version sums the channels in another order than the interpreted kernel)
A2_ATOL, A2_RTOL = 2e-7, 2.0 ** -22
WORKER_TIMEOUT = 120   # seconds for each worker


# ---------------------------------------------------------------------------
# the layout on fake device lists
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,per_host,space", [
    (32, 8, None), (32, 8, 4), (8, 8, 2), (8, 8, 1), (16, 4, 2), (8, 2, 1)])
def test_grid_matches_jax(n, per_host, space):
    assert global_mesh_grid(n, per_host, space) == \
        jglobal_mesh_grid(n, per_host, space)


@pytest.mark.parametrize("n,per_host,space", [(32, 8, 16), (8, 8, 3),
                                              (12, 8, 8)])
def test_refusals_match_jax(n, per_host, space):
    with pytest.raises(ValueError) as jax_error:
        jglobal_mesh_grid(n, per_host, space)
    with pytest.raises(ValueError) as error:
        global_mesh_grid(n, per_host, space)
    if "ICI" in str(jax_error.value):
        assert "must stay inside a host" in str(error.value)
    else:
        assert "global device count" in str(error.value)


def _positions(row) -> list[int]:
    """The indexes of a row's fake devices ``cpu:k``, local or remote."""
    return [torch.device(d).index for d in row.devices]


@pytest.mark.parametrize("n,per_host,space", [
    (8, 4, 4), (8, 4, 2), (8, 4, 1), (8, 8, None), (8, 8, 2), (8, 2, 2),
    (6, 3, 3), (4, 1, 1)])
def test_host_major_layout_matches_jax(n, per_host, space):
    """The grid of device positions and each row's process, against JAX's
    mesh over the same positions of its 8 virtual devices (k // per_host
    the host of position k); process 0's rows are ``SpaceMesh``es, the
    others' ``RemoteRow``s."""
    devices = jax.devices()[:n]
    want = jglobal_mesh(space_axis=space, devices=devices, per_host=per_host)
    grid = [[devices.index(d) for d in row] for row in np.asarray(
        want.devices)]
    mesh = make_global_mesh(space_axis=space,
                            devices=[f"cpu:{k}" for k in range(n)],
                            per_host=per_host)
    assert mesh.shape == dict(want.shape)
    assert [_positions(row) for row in mesh.rows] == grid
    assert list(mesh.processes) == [row[0] // per_host for row in grid]
    assert mesh.process == 0
    for row, owner in zip(mesh.rows, mesh.processes):
        assert isinstance(row, SpaceMesh if owner == 0 else RemoteRow)
        if owner:
            assert all(isinstance(d, str) for d in row.devices)
    # a repeated fake device gives the same layout
    repeated = make_global_mesh(space_axis=space, devices=["cpu"] * n,
                                per_host=per_host)
    assert repeated.processes == mesh.processes
    assert repeated.shape == mesh.shape


def test_live_topology_default(monkeypatch):
    """No process group: one host, every CUDA device, every row local (as
    JAX's over its live devices)."""
    want = jglobal_mesh()
    assert int(np.prod(list(want.shape.values()))) == len(jax.devices())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_global_mesh()
    assert mesh.shape == {"stream": 1, "space": 2}
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert all(isinstance(r, SpaceMesh) for r in mesh.rows)
    assert mesh.processes == (0,)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="local device"):
        make_global_mesh()


def test_local_streams_only():
    """On a mesh whose row 1 is another process's, ``shard_model_inputs``
    and ``sharded_scan`` place and run streams 0-1 and give ``None`` for
    2-3, whose inputs are not read."""
    mesh = make_global_mesh(space_axis=2, devices=["cpu"] * 4, per_host=2)
    assert [mesh.is_local(s, 4) for s in range(4)] == [True, True, False,
                                                       False]
    assert "processes=[0, 1]" in repr(mesh)
    h, w = 16, 32
    model = FlowTransferModel(h, w, method="horn-schunck",
                              estimator_kwargs=dict(max_iters=1, delta=None),
                              device="cpu")
    rng = np.random.default_rng(0)
    grays = rng.integers(0, 256, (4, 3, h, w), dtype=np.uint8)
    state = [model.init_state(torch.from_numpy(g[0])) for g in grays[:2]]
    state += [None, None]
    keys = list(prng.split(prng.key(0), 2)) + [None, None]
    placed = shard_model_inputs(mesh, state, [g[1:] for g in grays[:2]]
                                + [None, None], model.default_pixmaps(), keys)
    for entries in placed:
        assert entries[2] is None and entries[3] is None
        assert entries[0] is not None and entries[1] is not None
    states, rgbs = sharded_scan(model, mesh, per_stream_pixmaps=True)(
        *placed[:3], 0.0, placed[3])
    assert states[2:] == (None, None) and rgbs[2:] == (None, None)
    for s in range(2):
        _, alone = model.scan(state[s], torch.from_numpy(grays[s, 1:]),
                              model.default_pixmaps(), 0.0, keys[s])
        assert torch.equal(rgbs[s], alone)


def test_stream_mesh_checks_owners():
    row = SpaceMesh(["cpu"])
    with pytest.raises(ValueError, match="RemoteRow"):
        StreamMesh([row, row], processes=(0, 1), process=0)
    with pytest.raises(ValueError, match="RemoteRow"):
        StreamMesh([row, RemoteRow(("cpu",))])
    assert StreamMesh([row, RemoteRow(("cpu",))], (0, 1), 0).shape == {
        "stream": 2, "space": 1}


def test_initialize_needs_all_or_none():
    with pytest.raises(ValueError, match="together"):
        initialize("127.0.0.1:1234", 2)


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------

H, W, CHUNK, STREAMS = 32, 64, 2, 2
MODEL_ARGS = dict(method="horn-schunck",
                  estimator_kwargs=dict(max_iters=2, delta=None),
                  flow_filters="clip=6")
CORR_SHAPE = (64, 48, 16)

WORKER = r"""
import os, sys
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, __REPO__)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(2)
from transflow_tpu_torch import prng
from transflow_tpu_torch.config import LayerConfig
from transflow_tpu_torch.flow import Direction
from transflow_tpu_torch.model import FlowTransferModel
from transflow_tpu_torch.ops.correlation import sharded_correlation7x7
from transflow_tpu_torch.parallel import (RemoteRow, SpaceMesh, initialize,
                                          make_global_mesh,
                                          shard_model_inputs, sharded_scan)

initialize(f"127.0.0.1:{port}", 2, rank, timeout=__TIMEOUT__)
initialize(f"127.0.0.1:{port}", 2, rank)   # a no-op once the group exists
try:
    mesh = make_global_mesh(space_axis=4, devices=["cpu"] * 4)
    assert mesh.shape == {"stream": 2, "space": 4}, mesh.shape
    assert mesh.processes == (0, 1) and mesh.process == rank, mesh
    # each space row lies on one process: this one's local, the other's
    # remote
    assert isinstance(mesh.rows[rank], SpaceMesh), mesh
    assert isinstance(mesh.rows[1 - rank], RemoteRow), mesh

    # an all-reduce across processes of a sharded tensor's sum
    base = torch.arange(2 * 16 * 8, dtype=torch.float32).reshape(2, 16, 8)
    total = torch.stack([(2.0 * band).sum() for band in
                         mesh.rows[rank].split(base[rank])]).sum().reshape(1)
    dist.all_reduce(total)

    # the global scan: the same inputs on both processes, one stream each
    h, w, chunk, n = __H__, __W__, __CHUNK__, __STREAMS__
    model = FlowTransferModel(
        h, w, [LayerConfig(0, reset_mode="random", reset_random_factor=0.05)],
        {0: [(3, np.ones((h, w), bool))]}, direction=Direction.BACKWARD,
        halo=8, device="cpu", **__MODEL_ARGS__)
    rng = np.random.default_rng(0)
    grays = rng.integers(0, 256, (n, chunk, h, w), dtype=np.uint8)
    first = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    keys = [prng.key(100 + s) for s in range(n)]
    state = [model.init_state(torch.from_numpy(first[s])) for s in range(n)]
    st, gr, pm, ks = shard_model_inputs(mesh, state, grays,
                                        model.default_pixmaps(), keys)
    assert [x is None for x in st] == [s != rank for s in range(n)]
    new_state, rgbs = sharded_scan(model, mesh, per_stream_pixmaps=True)(
        st, gr, pm, 0.0, ks)
    assert [r is None for r in rgbs] == [s != rank for s in range(n)]

    # A2 on this process's space row
    crng = np.random.default_rng(7)
    f1 = torch.from_numpy(crng.standard_normal(__CORR__).astype(np.float32))
    f2 = torch.from_numpy(crng.standard_normal(__CORR__).astype(np.float32))
    corr = sharded_correlation7x7(f1, f2, mesh.rows[rank], stride=2)

    np.savez(os.path.join(out, f"rank{rank}.npz"), total=total.numpy(),
             rgb=rgbs[rank].numpy(), flow=new_state[rank]["prev_flow"].numpy(),
             corr=corr.numpy())
    dist.barrier()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "cv2")]
    assert not bad, bad
    print(f"proc {rank} ok", flush=True)
finally:
    dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def _worker_script(path):
    script = WORKER
    for key, value in {"__REPO__": repr(REPO), "__TIMEOUT__": WORKER_TIMEOUT,
                       "__H__": H, "__W__": W, "__CHUNK__": CHUNK,
                       "__STREAMS__": STREAMS,
                       "__MODEL_ARGS__": repr(MODEL_ARGS),
                       "__CORR__": CORR_SHAPE}.items():
        script = script.replace(key, str(value))
    path.write_text(script)
    return path


def _inputs():
    """The workers' inputs, made here from the same seeds."""
    rng = np.random.default_rng(0)
    grays = rng.integers(0, 256, (STREAMS, CHUNK, H, W), dtype=np.uint8)
    first = rng.integers(0, 256, (STREAMS, H, W), dtype=np.uint8)
    return grays, first


def _jax_streams(grays, first):
    """JAX's single-device ``jit_scan`` of each stream (the e2e worker's
    oracle): (final flows, frames)."""
    model = JaxModel(
        H, W, [JaxLayerConfig(0, reset_mode="random",
                              reset_random_factor=0.05)],
        {0: [(3, np.ones((H, W), bool))]}, direction=JaxDirection.BACKWARD,
        **MODEL_ARGS)
    flows, rgbs = [], []
    for s in range(STREAMS):
        state, rgb = model.jit_scan(
            model.init_state(first[s]), jnp.asarray(grays[s]),
            model.default_pixmaps(), jnp.float32(0.0),
            jnp.asarray(jax.random.PRNGKey(100 + s)))
        flows.append(np.asarray(state["prev_flow"]))
        rgbs.append(np.asarray(rgb))
    return flows, rgbs


def _port_streams(grays, first):
    """The port's single-process ``sharded_scan`` on the same layout."""
    model = FlowTransferModel(
        H, W, [LayerConfig(0, reset_mode="random", reset_random_factor=0.05)],
        {0: [(3, np.ones((H, W), bool))]}, direction=Direction.BACKWARD,
        halo=8, device="cpu", **MODEL_ARGS)
    mesh = make_mesh(devices=["cpu"] * 8, stream_axis=2)
    state = [model.init_state(torch.from_numpy(f)) for f in first]
    keys = [prng.key(100 + s) for s in range(STREAMS)]
    st, gr, pm, ks = shard_model_inputs(mesh, state, grays,
                                        model.default_pixmaps(), keys)
    return sharded_scan(model, mesh, per_stream_pixmaps=True)(st, gr, pm,
                                                              0.0, ks)


def test_two_process_global_mesh(tmp_path):
    """Two gloo processes on 127.0.0.1, four CPU devices each: the global
    mesh is stream 2 x space 4 with one row a process; the all-reduced
    total is the whole sum on both; each process's stream within 1e-5
    (flows) and 1 % of pixels (frames) of JAX's single-device scan and
    bit-equal to the port's single-process ``sharded_scan``; A2 on each
    row within 2e-7 and 2 ulp of JAX's interpreted kernel."""
    port = _free_port()
    script = _worker_script(tmp_path / "worker.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(2)]
    try:
        # the references, while the workers run
        grays, first = _inputs()
        jflows, jrgbs = _jax_streams(grays, first)
        pstates, prgbs = _port_streams(grays, first)
        crng = np.random.default_rng(7)
        f1 = crng.standard_normal(CORR_SHAPE).astype(np.float32)
        f2 = crng.standard_normal(CORR_SHAPE).astype(np.float32)
        corr_want = np.asarray(pallas_correlation7x7(
            jnp.asarray(f1), jnp.asarray(f2), stride=2, interpret=True))
        outputs = [proc.communicate(timeout=WORKER_TIMEOUT)[0]
                   for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"proc {rank} failed:\n{out[-3000:]}"
        assert f"proc {rank} ok" in out
    base = np.arange(2 * 16 * 8, dtype=np.float32)
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert got["total"][0] == base.sum() * 2
        np.testing.assert_allclose(got["flow"], jflows[rank], rtol=0,
                                   atol=FLOW_ATOL)
        assert np.abs(jflows[rank]).max() > 0.1
        assert got["rgb"].shape == (CHUNK, H, W, 3)
        for k in range(CHUNK):
            differ = (got["rgb"][k] != jrgbs[rank][k]).any(-1).mean()
            assert differ <= FRAME_SHARE, (rank, k, differ)
        np.testing.assert_array_equal(got["rgb"], prgbs[rank].numpy())
        np.testing.assert_array_equal(got["flow"],
                                      pstates[rank]["prev_flow"].numpy())
        np.testing.assert_allclose(got["corr"], corr_want, rtol=A2_RTOL,
                                   atol=A2_ATOL)
    assert not np.array_equal(np.load(tmp_path / "rank0.npz")["rgb"],
                              np.load(tmp_path / "rank1.npz")["rgb"])


def test_chip_smoke_fails_on_a_failing_worker():
    """chip_smoke's phase M waits for its workers with ``run_workers``: a
    worker that exits non-zero fails the phase at once (its peer, which
    would wait for it, is killed), and so does one still running at the
    time limit."""
    import time
    import chip_smoke
    ok = [sys.executable, "-c", "print('fine')"]
    assert chip_smoke.run_workers([ok, ok], 60) == ["fine\n", "fine\n"]
    hang = [sys.executable, "-c", "import time; time.sleep(60)"]
    start = time.monotonic()
    with pytest.raises(AssertionError, match="worker 1 exited 3"):
        chip_smoke.run_workers(
            [hang, [sys.executable, "-c", "import sys; sys.exit(3)"]], 60)
    assert time.monotonic() - start < 30
    with pytest.raises(AssertionError, match="still running after 1 s"):
        chip_smoke.run_workers([hang], 1)

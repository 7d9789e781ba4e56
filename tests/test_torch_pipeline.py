"""The port's Pipeline and CLI against the JAX package's, disk to disk on
the CPU at 48x64: Farneback over a PGM sequence (the JAX Engine's bars:
flows >= 60 dB, frames apart on <= 1 % of pixels), the replay of a
``.flow.zip`` with a random reset (bit-equal frames and ``-F`` archives),
checkpoints that each package resumes from the other (bit-equal frames),
and the port's own invariants: chunked equals per-frame, resume is
deterministic, a CPU mesh equals no mesh.

Three JAX Pipeline runs in all, in module-scoped fixtures."""
import io
import shutil
import zipfile

import numpy as np
import pytest

from transflow_tpu import cli as jcli
from transflow_tpu_torch import cli
from transflow_tpu_torch.utils.imageio import read_netpbm, write_netpbm

H, W = 48, 64
FRAMES = 8          # 7 flows
PAN = 2             # px per frame along both axes
CHECKPOINT = 3      # --checkpoint-every of the replays
SEED = 0


def _texture(rng, h, w):
    """A smooth random texture: coarse noise upsampled, plus fine noise."""
    coarse = rng.random((h // 6 + 2, w // 6 + 2))
    rows = np.linspace(0, coarse.shape[0] - 1.001, h)
    cols = np.linspace(0, coarse.shape[1] - 1.001, w)
    r0, c0 = rows.astype(int), cols.astype(int)
    fr, fc = (rows - r0)[:, None], (cols - c0)[None, :]
    smooth = ((1 - fr) * (1 - fc) * coarse[r0][:, c0]
              + fr * (1 - fc) * coarse[r0 + 1][:, c0]
              + (1 - fr) * fc * coarse[r0][:, c0 + 1]
              + fr * fc * coarse[r0 + 1][:, c0 + 1])
    return np.clip(smooth * 200 + rng.random((h, w)) * 55, 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    canvas = _texture(np.random.default_rng(SEED), H + PAN * FRAMES,
                      W + PAN * FRAMES)
    (root / "frames").mkdir()
    for i in range(FRAMES):
        write_netpbm(str(root / "frames" / f"{i:04d}.pgm"),
                     canvas[PAN * i:PAN * i + H, PAN * i:PAN * i + W])
    return root


def _run(package, argv, **kwargs):
    """One CLI run of ``package`` ("jax" or "port", the port on the CPU),
    quiet and overwriting."""
    argv = list(argv) + ["--no-exec", "--overwrite"]
    if package == "jax":
        return jcli.main(argv)
    return cli.main(argv, device="cpu", **kwargs)


def _outdir(root, name):
    (root / name).mkdir(exist_ok=True)
    return root / name


def _frames(directory, count=None, first=0):
    """The ``%04d.ppm`` frames of ``directory`` from ``first`` on."""
    frames = []
    i = first
    while (directory / f"{i:04d}.ppm").exists() and (
            count is None or len(frames) < count):
        frames.append(read_netpbm(str(directory / f"{i:04d}.ppm")))
        i += 1
    return np.stack(frames)


def _flows(path):
    with zipfile.ZipFile(path) as archive:
        names = sorted(n for n in archive.namelist() if n.endswith(".npy"))
        meta = archive.read("meta.json")
        return (np.stack([np.load(io.BytesIO(archive.read(n)))
                          for n in names]), meta)


def _farneback_argv(root, out):
    return [str(root / "frames" / "%04d.pgm"), "-p", "noise", "--seed",
            str(SEED), "-r", "random", "0.05", "-o",
            str(_outdir(root, out) / "%04d.ppm"), "-F", "-C"]


@pytest.fixture(scope="module")
def farneback(root):
    """The headline command's defaults over the PGM sequence, in both
    packages: (frames, flows) of each."""
    out = {}
    for package in ("jax", "port"):
        _run(package, _farneback_argv(root, f"fb_{package}"))
        directory = root / f"fb_{package}"
        out[package] = (_frames(directory),
                        _flows(directory / "%04d.flow.zip")[0])
    return out


def test_farneback_pipeline_meets_jax_bars(farneback):
    frames, flows = farneback["port"]
    jframes, jflows = farneback["jax"]
    assert frames.shape == jframes.shape == (FRAMES - 1, H, W, 3)
    assert flows.shape == jflows.shape == (FRAMES - 1, H, W, 2)
    assert np.abs(jflows).max() > 1.0   # the pan is found
    for k in range(FRAMES - 1):
        mse = float(np.mean((flows[k] - jflows[k]) ** 2))
        assert mse == 0 or 10 * np.log10(64.0 / mse) >= 60.0, k
        differ = (frames[k] != jframes[k]).any(axis=-1).mean()
        assert differ <= 0.01, k


def test_farneback_pipeline_finds_the_pan(farneback):
    flows = farneback["port"][1][:, 8:-8, 8:-8]
    medians = np.median(flows.reshape(len(flows), -1, 2), axis=1)
    np.testing.assert_allclose(medians, PAN, atol=0.25)


def _replay_argv(root, archive, out, *extra):
    return [str(archive), "-p", "noise", "--seed", str(SEED + 1), "-r",
            "random", "0.2", "-o", str(_outdir(root, out) / "%04d.ppm"),
            "-F", "--checkpoint-every", str(CHECKPOINT), *extra]


@pytest.fixture(scope="module")
def replays(root, farneback):
    """JAX's ``.flow.zip`` replayed by both packages with a random reset
    and checkpoints, and by the port chunked, per frame, in chunks of 2
    and over a 2-shard CPU mesh: the frames and -F flows of each, read
    before any resume writes over them."""
    archive = root / "fb_jax" / "%04d.flow.zip"
    runs = {"jax": ("jax", []), "port": ("port", []),
            "port_frames": ("port", ["--batch-frames", "1"]),
            "port_chunks": ("port", ["--batch-frames", "2"]),
            "port_mesh": ("port", ["--mesh", "2", "--halo", "8"])}
    out = {}
    for name, (package, extra) in runs.items():
        pipeline = _run(package, _replay_argv(root, archive, f"rp_{name}",
                                              *extra))
        if package == "port":
            out[f"{name}_batch"] = pipeline._batch_size
            out[f"{name}_mesh"] = pipeline.engine.mesh
        directory = root / f"rp_{name}"
        out[name] = (_frames(directory),
                     *_flows(directory / "%04d.flow.zip"))
    return out


def test_replay_matches_jax_bit_for_bit(replays):
    frames, flows, meta = replays["port"]
    jframes, jflows, jmeta = replays["jax"]
    assert frames.shape == (FRAMES - 1, H, W, 3)
    assert replays["port_batch"] > 1
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(flows, jflows)
    assert meta == jmeta


@pytest.mark.parametrize("name", ["port_frames", "port_chunks"])
def test_chunked_equals_per_frame(replays, name):
    assert replays[f"{name}_batch"] == (1 if name == "port_frames" else 2)
    for got, want in zip(replays[name], replays["port"]):
        np.testing.assert_array_equal(got, want)


def test_cpu_mesh_equals_no_mesh(replays):
    mesh = replays["port_mesh_mesh"]
    assert mesh is not None and len(mesh.devices) == 2
    for got, want in zip(replays["port_mesh"], replays["port"]):
        np.testing.assert_array_equal(got, want)


def _resume(package, root, source_run, out):
    """Resume ``source_run``'s checkpoint at CHECKPOINT in ``package``,
    into a copy of its output directory ``out``; returns the frames it
    wrote."""
    source = root / f"rp_{source_run}"
    target = root / out
    if target.exists():
        shutil.rmtree(target)
    target.mkdir()
    ckpt = source / f"%04d_{CHECKPOINT:05d}.ckpt.zip"
    # the resumed run writes where the checkpoint's config says: its
    # source's directory; take its frames from there, then restore them
    saved = {p.name: p.read_bytes() for p in source.glob("*.ppm")}
    for name in saved:
        (source / name).unlink()
    try:
        _run(package, [str(ckpt)])
        for path in source.glob("*.ppm"):
            shutil.copy(path, target / path.name)
    finally:
        for path in source.glob("*.ppm"):
            path.unlink()
        for name, data in saved.items():
            (source / name).write_bytes(data)
    assert not (target / f"{CHECKPOINT - 1:04d}.ppm").exists()
    return _frames(target, first=CHECKPOINT)


@pytest.mark.parametrize("resumer,writer", [("port", "jax"),
                                            ("jax", "port"),
                                            ("port", "port")])
def test_checkpoints_resume_across_packages(replays, root, resumer, writer):
    """A .ckpt.zip of either package resumed by the other, and the port's
    by itself, renders the rest of the replay bit for bit."""
    frames = _resume(resumer, root, writer, f"resume_{resumer}_{writer}")
    assert len(frames) == FRAMES - 1 - CHECKPOINT
    np.testing.assert_array_equal(frames, replays["jax"][0][CHECKPOINT:])


def test_profile_and_trace_outputs(root, farneback):
    """--profile writes the stage table beside the outputs, --trace-dir a
    torch.profiler trace; the stages cover the main thread's setup,
    device work and flush, and the threads' readback and encode."""
    import json
    out = _outdir(root, "profiled")
    trace = root / "trace"
    _run("port", [str(root / "fb_jax" / "%04d.flow.zip"), "-p", "noise",
                  "-o", str(out / "%04d.ppm"), "--profile", "--trace-dir",
                  str(trace), "--seed", "0"])
    report = json.loads((out / "%04d.profile.json").read_text())
    assert report["frames"] == FRAMES - 1
    assert {"setup", "decode_wait", "device_step", "flush",
            "encode"} <= set(report["stages"])
    assert (trace / "trace.json").stat().st_size > 0


def test_stage_timers_count_every_thread():
    """StageTimers from many threads at once lose no count."""
    import sys
    import threading
    from transflow_tpu_torch.profiling import StageTimers
    timers = StageTimers()
    threads, calls = 16, 300

    def work():
        for _ in range(calls):
            with timers.stage("a"):
                pass
            with timers.stage("b"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join(timeout=60)
        assert not any(worker.is_alive() for worker in workers)
    finally:
        sys.setswitchinterval(interval)
    assert timers.counts == {"a": threads * calls, "b": threads * calls}
    assert timers.report()["frames"] == threads * calls


def test_rounded_flow_export(root, replays):
    """--export-rounded-flow writes the exported flows rounded to
    integers."""
    _run("port", _replay_argv(root, root / "fb_jax" / "%04d.flow.zip",
                              "rounded", "--export-rounded-flow"))
    flows = _flows(root / "rounded" / "%04d.flow.zip")[0]
    assert flows.dtype.kind == "i"
    np.testing.assert_array_equal(flows, np.round(replays["port"][1]))

"""The port's benchmark: end-to-end 1080p frames/s of the flagship step
(Farneback flow, warp, composite) on the card, against the reference's
CPU pipeline (OpenCV Farneback and a numpy compositor) on the same host.

Counterpart of the root bench.py. Prints ONE JSON line: {"metric",
"value", "unit", "vs_baseline", ...}, with the stage split, LiteFlowNet
at 1088x1920, the ``fastest`` preset, the kernels' launches a frame, the
host's waits for the card a frame and the card's name and power limit;
``--e2e`` adds the CLI's disk-to-disk frames/s over a cv2-written MJPG
clip (a still pixmap, a video pixmap, a ``.flow.zip`` replay) with the
``StageTimers`` split of each.

Methodology: one timed sample is CHUNKS_PER_SAMPLE chained
``model.scan`` calls of CHUNK frames, over GRAY_SETS distinct gray
chunks, each call with its own ``t0`` and key (folded from a lifetime
counter, never reused), ended by one readback of a sum the card made of
the last chunk's frames: the state chain orders every call before it, so
the host clock around the sample spans the card's work. Samples warm up
until two agree within WARMUP_TOL (a process's first calls read slower),
then the median of REPEATS samples is the figure, with the best sample
and the spread. The median hides a stall inside one sample, so the record
also gives ``samples`` (how many were taken: the BUDGET_S cap may cut
them short) and ``window_fps``, every sample's frames over their summed
seconds. ``hbm_io_gbps`` is the frames' bytes times the median rate, not
traffic the card measured. A stage that fails raises: the run then exits
non-zero and prints no record.

Usage:
  python -m transflow_tpu_torch.bench [--e2e]
  python -m transflow_tpu_torch bench

``main(argv, device="cpu")`` runs it on the CPU (the tests shrink it by
setting this module's constants); without ``device`` it runs on the
current CUDA device and raises without one.
"""
import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from ._device import BUILD_DIR, PACKAGE_DIR, resolve_device

METRIC = "1080p_e2e_fps_flow_warp_composite"
HEIGHT, WIDTH = 1080, 1920
CHUNK = 16             # frames per model.scan call
CHUNKS_PER_SAMPLE = 32  # chained calls per timed sample
GRAY_SETS = 4          # distinct gray chunks rotated across calls
REPEATS = 15           # median of this many steady-state samples
WARMUP_TOL = 0.10      # two consecutive warm-up samples within 10 % => steady
WARMUP_MAX = 20        # cap on the warm-up samples
BUDGET_S = 150.0       # soft cap on one steady-state measurement's wall time
CPU_FRAMES = 3         # frames of the CPU reference
CPU_BASELINE_PATH = BUILD_DIR / "bench_cpu_baseline.json"
LFN_HEIGHT, LFN_WIDTH = 1088, 1920
LFN_CHAIN = 8          # LiteFlowNet calls chained in one sample
E2E_FRAMES = 96        # frames of the --e2e clip
FASTEST = PACKAGE_DIR.parent / "assets" / "configs" / "fastest.json"


def make_frames(n, seed=0):
    """Synthetic moving-texture frames: (n, HEIGHT, WIDTH) uint8, a blurred
    random texture shifted by up to 6 px a frame (bench.py::make_frames)."""
    rng = np.random.default_rng(seed)
    import scipy.ndimage
    base = scipy.ndimage.gaussian_filter(
        rng.integers(0, 256, (HEIGHT + 64, WIDTH + 64)).astype(np.float32), 2)
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    frames = []
    for t in range(n):
        dx, dy = int(3 * np.sin(0.3 * t) + 3), int(2 * np.cos(0.4 * t) + 2)
        frames.append(base[32 + dy:32 + dy + HEIGHT,
                           32 + dx:32 + dx + WIDTH])
    return np.stack(frames)


def _steady_state(region, repeats=None, stats=False, budget_s=None):
    """Warm ``region`` (a 0-argument callable returning elapsed seconds) up
    until two consecutive samples agree within WARMUP_TOL (at most
    WARMUP_MAX more), then take ``repeats`` samples (REPEATS by default).
    Returns their median; with ``stats`` (median, best, IQR in % of the
    median, warm-up samples taken, samples taken, their summed seconds).
    ``budget_s`` (BUDGET_S by default) caps the wall time softly: past it,
    warm-up stops and sampling ends after at least one sample."""
    repeats = REPEATS if repeats is None else repeats
    deadline = time.monotonic() + (BUDGET_S if budget_s is None
                                   else budget_s)
    prev = region()
    warmups = 1
    for _ in range(WARMUP_MAX):
        if time.monotonic() > deadline:
            break
        cur = region()
        warmups += 1
        if abs(cur - prev) / min(cur, prev) <= WARMUP_TOL:
            break
        prev = cur
    collected = []
    while len(collected) < repeats:
        if collected and time.monotonic() > deadline:
            break
        collected.append(region())
    samples = np.sort(collected)
    median = float(np.median(samples))
    if not stats:
        return median
    iqr = float(np.percentile(samples, 75) - np.percentile(samples, 25))
    return (median, float(samples[0]), 100.0 * iqr / median, warmups,
            len(samples), float(samples.sum()))


def _fb_counters():
    from .ops.farneback import (aggregate_solve_cuda, poly_expansion_cuda,
                                update_equations_cuda)
    from .ops.pyramid import pyramid_levels_cuda, resize_flow_cuda
    return (poly_expansion_cuda, update_equations_cuda, aggregate_solve_cuda,
            pyramid_levels_cuda, resize_flow_cuda)


def _comp_counters():
    from .ops.compositor import (composite_cuda, layer_update_cuda,
                                 leave_empty_sources_cuda)
    return leave_empty_sources_cuda, layer_update_cuda, composite_cuda


def _lfn_counters():
    from .ops.conv_epilogue import conv_epilogue_cuda
    from .ops.correlation import correlation7x7_cuda
    from .ops.lfn_heads import reg_apply_cuda, upsample2x_phases_cuda
    from .ops.warp import bounded_backwarp_cuda, exact_backwarp_cuda
    return (correlation7x7_cuda, bounded_backwarp_cuda, exact_backwarp_cuda,
            upsample2x_phases_cuda, reg_apply_cuda, conv_epilogue_cuda)


# A1, A3, B7, B16, B17, B18 launches a LiteFlowNet frame at bound 0
LFN_PER_FRAME = {"A1": 5, "A3": 0, "B7": 14, "B16": 6, "B17": 5, "B18": 93}


def _zero(counters) -> None:
    for fn in counters:
        fn.launches = 0


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.nelement() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def flagship_model(device, estimator_kwargs=None):
    """bench.py's flagship (``bench.py:376-382``): Farneback at cv2's
    defaults, backward flow, one moveref layer with random reset 0.01."""
    from .config import LayerConfig
    from .flow import Direction
    from .model import FlowTransferModel
    return FlowTransferModel(
        HEIGHT, WIDTH,
        [LayerConfig(0, reset_mode="random", reset_random_factor=0.01)],
        {0: [(3, np.ones((HEIGHT, WIDTH), bool))]},
        method="farneback", estimator_kwargs=dict(estimator_kwargs or {}),
        direction=Direction.BACKWARD, device=device)


class FlagshipChain:
    """The flagship's chained chunks: the state threads across samples,
    call n takes gray set n % GRAY_SETS, ``t0`` n and ``fold_in(key(0),
    n)``, n counted over the chain's lifetime."""

    def __init__(self, model):
        from . import prng
        self.model = model
        device = model.device
        self.grays = [torch.as_tensor(make_frames(CHUNK, seed=s),
                                      device=device)
                      for s in range(GRAY_SETS)]
        self.pixmaps = model.default_pixmaps()
        self.state = model.init_state(make_frames(1)[0])
        self.root = prng.key(0)
        self.calls = 0

    def run(self, chunks: int = None) -> torch.Tensor:
        """``chunks`` (CHUNKS_PER_SAMPLE) chained calls; the last call's
        frames."""
        from . import prng
        rgbs = None
        for _ in range(CHUNKS_PER_SAMPLE if chunks is None else chunks):
            n = self.calls
            self.state, rgbs = self.model.scan(
                self.state, self.grays[n % GRAY_SETS], self.pixmaps,
                float(n), prng.fold_in(self.root, n))
            self.calls += 1
        return rgbs

    def sample(self) -> float:
        """One timed sample: the chained calls, then one readback of the
        sum of the last chunk's frames; the host's seconds."""
        start = time.perf_counter()
        int(self.run().sum(dtype=torch.int64))
        return time.perf_counter() - start


def _sampled(chain) -> dict:
    frames = CHUNK * CHUNKS_PER_SAMPLE
    median, best, iqr_pct, warmups, n, seconds = _steady_state(
        chain.sample, stats=True)
    return {"fps": frames / median, "best_fps": frames / best,
            "noise_iqr_pct": iqr_pct, "ms_per_frame": 1e3 * median / frames,
            "warmup_samples": warmups, "samples": n,
            "window_fps": n * frames / seconds}


def bench_device(device) -> dict:
    """The flagship on ``device``: frames/s and its spread, the stage
    split, the state's size, its launches of B1, B2a, B2b, B8 and B15 and
    of the compositor's K0, K1 and K2 a frame (on the card they must be the
    estimator's ``launches_per_frame`` and ``MOVEREF_PER_FRAME``: no plain
    version ran) and the host's waits for the card a frame."""
    from . import prng
    from .flow.estimators.farneback import farneback, launches_per_frame
    from .ops.compositor import MOVEREF_PER_FRAME
    from .profiling import host_sync_sites
    model = flagship_model(device)
    chain = FlagshipChain(model)
    state_bytes = _nbytes(chain.state)
    # compile nothing, but build the kernels and warm the allocator
    int(chain.run(1).sum(dtype=torch.int64))
    out = _sampled(chain)

    frames_per_sample = CHUNK * CHUNKS_PER_SAMPLE
    counters = _fb_counters() + _comp_counters()
    _zero(counters)
    syncs = len(host_sync_sites(chain.run, device))
    launches = [fn.launches / frames_per_sample for fn in counters]
    int(chain.run(1).sum(dtype=torch.int64))
    want = launches_per_frame(HEIGHT, WIDTH) + MOVEREF_PER_FRAME
    if device.type == "cuda" and tuple(launches) != want:
        raise RuntimeError(f"flagship: B1/B2a/B2b/B8/B15/K0/K1/K2 launches "
                           f"a frame {launches}, expected {want}: a plain "
                           "version ran on the card")

    # the estimator alone: farneback fed its own flow, over GRAY_SETS
    # seeded pairs
    frames = make_frames(2)
    pairs = [tuple(torch.as_tensor(f, device=device)
                   for f in make_frames(2, seed=10 + s))
             for s in range(GRAY_SETS)]
    est = {"flow": torch.zeros((HEIGHT, WIDTH, 2), dtype=torch.float32,
                               device=device), "n": 0}

    def est_region():
        est["n"] += 1
        start = time.perf_counter()
        flow = est["flow"] + est["n"] * 1e-6
        for i in range(CHUNKS_PER_SAMPLE):
            a, b = pairs[i % GRAY_SETS]
            flow = farneback(a, b, flow)
        float(flow[0, 0, 0])
        est["flow"] = flow
        return time.perf_counter() - start

    est_ms = 1e3 * _steady_state(est_region, repeats=3) / CHUNKS_PER_SAMPLE

    # the compositor's update and render alone, on one flow, a fresh key
    # a call
    gray0, gray1 = (torch.as_tensor(f, device=device) for f in frames)
    flow0 = farneback(gray1, gray0, torch.zeros_like(est["flow"]))
    comp_fn = model._comp_step
    numbers = model.default_frame_numbers()
    comp = {"state": model.init_state(frames[0])["comp"], "n": 0}

    def comp_region():
        base = comp["n"] * CHUNKS_PER_SAMPLE
        comp["n"] += 1
        start = time.perf_counter()
        state, rgb = comp["state"], None
        for i in range(CHUNKS_PER_SAMPLE):
            state = comp_fn.update(state, flow0, chain.pixmaps,
                                   prng.fold_in(prng.key(1), base + i),
                                   numbers, model.layer_params)
            state, rgb = comp_fn.render(state, model.layer_params)
        int(rgb.sum(dtype=torch.int64))
        comp["state"] = state
        return time.perf_counter() - start

    comp_ms = 1e3 * _steady_state(comp_region, repeats=3) / CHUNKS_PER_SAMPLE
    io_bytes_per_frame = HEIGHT * WIDTH + 3 * HEIGHT * WIDTH
    out.update({
        "stage_ms": {"estimator": est_ms, "compositor_render": comp_ms,
                     "fused_total": out["ms_per_frame"]},
        # the frames' bytes in and out times the host-timed median rate:
        # derived, not the card's measured traffic; none off the card
        "hbm_io_gbps": (io_bytes_per_frame * out["fps"] / 1e9
                        if device.type == "cuda" else None),
        "carry_state_mb": state_bytes / 1e6,
        "launches_per_frame": dict(zip(("B1", "B2a", "B2b", "B8", "B15",
                                        "K0", "K1", "K2"), launches)),
        "host_syncs_per_frame": syncs / frames_per_sample,
    })
    return out


def bench_fastest(device) -> dict:
    """``assets/configs/fastest.json``'s estimator through the flagship's
    sampling."""
    from .flow.sources.cv import CvFlowConfig
    kwargs = CvFlowConfig.from_file(FASTEST).estimator_kwargs()
    chain = FlagshipChain(flagship_model(device, kwargs))
    int(chain.run(1).sum(dtype=torch.int64))
    out = _sampled(chain)
    return {"fps": out["fps"], "ms_per_frame": out["ms_per_frame"]}


def bench_liteflownet(device) -> dict:
    """LiteFlowNet at LFN_HEIGHT x LFN_WIDTH with random weights (the
    published network's graph; no download): LFN_CHAIN calls in a chain,
    each output perturbing the next call's inputs, ended by one readback;
    the median of two samples after a first. The warp bound is 0, so a
    frame launches 5 correlations (A1), no bounded backwarp (A3), 14
    exact backwarps (B7), 6 phase upsamples (B16), 5 regularization tap
    applies (B17) and 93 convolution epilogues (B18): on the card anything
    else raises."""
    from .flow.estimators.liteflownet import get_weights
    net = get_weights(allow_random=True, device=device)
    rng = np.random.default_rng(2)
    i1, i2 = (torch.as_tensor(rng.random((LFN_HEIGHT, LFN_WIDTH, 3),
                                         np.float32), device=device)
              for _ in range(2))
    counters = _lfn_counters()

    @torch.no_grad()
    def chained(s) -> float:
        for _ in range(LFN_CHAIN):
            out = net(i1 + s * 1e-6, i2 + s * 1e-6, warp_bound=0)
            s = out.mean() * 1e-6
        return float(s)

    times = []
    for i in range(3):
        _zero(counters)
        start = time.perf_counter()
        chained(torch.tensor(1e-3 * (i + 1), device=device))
        if i:  # the first sample builds the kernels
            times.append(time.perf_counter() - start)
    launches = {name: fn.launches / LFN_CHAIN
                for name, fn in zip(LFN_PER_FRAME, counters)}
    if device.type == "cuda" and launches != LFN_PER_FRAME:
        raise RuntimeError(f"liteflownet: launches a frame {launches}, "
                           f"expected {LFN_PER_FRAME}")
    ms = 1e3 * float(np.median(times)) / LFN_CHAIN
    return {"liteflownet_1088p_ms_per_frame": ms,
            "liteflownet_1088p_fps": 1e3 / ms,
            "launches_per_frame": launches}


def bench_cpu_reference() -> float:
    """The reference's per-frame CPU work: cv2 Farneback at its defaults,
    then the numpy moveref update (rounded flat flow, masked permutation by
    flat assignment, reset, gather) and the composite, CPU_FRAMES frames
    (bench.py::bench_cpu_reference); frames/s."""
    import cv2
    frames = make_frames(CPU_FRAMES + 1, seed=1)
    pixmap = np.random.default_rng(0).integers(
        0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)
    n = HEIGHT * WIDTH
    data = np.stack(np.indices((HEIGHT, WIDTH)), axis=-1).reshape(n, 2)
    alpha = np.ones(n, dtype=np.int32)
    rng = np.random.default_rng(0)
    start = time.perf_counter()
    for i in range(CPU_FRAMES):
        flow = cv2.calcOpticalFlowFarneback(
            frames[i + 1], frames[i], None, 0.5, 3, 15, 3, 5, 1.2, 0)
        flow_int = np.round(flow).astype(np.int32)
        flow_flat = (flow_int[..., 1] * WIDTH + flow_int[..., 0]).ravel()
        where_target = np.nonzero(flow_flat)[0]
        where_source = np.clip(where_target + flow_flat[where_target],
                               0, n - 1)
        data[where_target] = data[where_source]
        alpha[where_target] = 1
        reset = rng.random(n) < 0.01
        base_i, base_j = np.divmod(np.arange(n)[reset], WIDTH)
        data[reset, 0] = base_i
        data[reset, 1] = base_j
        rgb = pixmap[np.clip(data[:, 0], 0, HEIGHT - 1),
                     np.clip(data[:, 1], 0, WIDTH - 1)]
        image = np.where((alpha != 0)[:, None], rgb, 255).astype(np.uint8)
        _ = image.reshape(HEIGHT, WIDTH, 3)
    return CPU_FRAMES / (time.perf_counter() - start)


def cpu_reference_fps() -> float:
    """``bench_cpu_reference()``, cached in CPU_BASELINE_PATH for its
    HEIGHT x WIDTH (computed again at another size)."""
    try:
        with open(CPU_BASELINE_PATH) as file:
            cached = json.load(file)
        if (cached["height"], cached["width"]) == (HEIGHT, WIDTH):
            return cached["cpu_fps"]
    except (OSError, ValueError, KeyError):
        pass
    cpu_fps = bench_cpu_reference()
    CPU_BASELINE_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(CPU_BASELINE_PATH, "w") as file:
        json.dump({"cpu_fps": cpu_fps, "height": HEIGHT, "width": WIDTH,
                   "timestamp": time.time()}, file)
    return cpu_fps


def _e2e_run(name: str, cfg, frames: int, device) -> dict:
    """One Pipeline run of ``cfg``: frames/s disk to disk, its chunk size
    and its ``StageTimers`` split in ms a frame."""
    from .pipeline import Pipeline
    pipeline = Pipeline(cfg, progress=False, execute=False, replace=True,
                        export_config=False, device=device)
    start = time.perf_counter()
    pipeline.run()
    elapsed = time.perf_counter() - start
    if pipeline.cursor != frames:
        raise RuntimeError(f"e2e {name}: {pipeline.cursor} frames rendered, "
                           f"expected {frames}")
    stages = pipeline.timers.report()["stages"]
    split = {stage: 1e3 * stages[stage]["total_s"] / frames
             if stage in stages else 0.0
             for stage in ("decode_wait", "device_step", "encode")}
    return {f"e2e_fps_{name}": frames / elapsed,
            f"e2e_batch_{name}": pipeline._batch_size,
            f"e2e_split_ms_{name}": split}


def bench_e2e_cli(frames: int, device) -> dict:
    """Disk-to-disk frames/s of the CLI's Pipeline: a cv2-written MJPG
    ``.avi`` of ``frames`` frames in, MJPG out through the encoder chain,
    for a still pixmap and a video pixmap; then a float16 ``.flow.zip``
    replay (bench.py::bench_e2e_cli)."""
    import cv2

    from .config import Config, PixmapSourceConfig
    from .output.archive import NumpyArchiveOutput

    root = tempfile.mkdtemp(prefix="transflow_torch_bench_e2e_")
    try:
        src = os.path.join(root, "src.avi")
        writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                                 (WIDTH, HEIGHT))
        for frame in make_frames(frames, seed=2):
            writer.write(cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR))
        writer.release()
        pix = os.path.join(root, "pix.png")
        cv2.imwrite(pix, np.random.default_rng(0).integers(
            0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8))
        out = {}
        for name, pixmap_path in (("still_pixmap", pix),
                                  ("video_pixmap", src)):
            cfg = Config(src, output_path=os.path.join(root, f"{name}.avi"),
                         vcodec="mjpeg",
                         pixmap_sources=[PixmapSourceConfig(pixmap_path)],
                         seed=0)
            out.update(_e2e_run(name, cfg, frames - 1, device))

        # the replay of smooth float16 flows (the source casts them)
        arc = os.path.join(root, "replay.flow.zip")
        archive = NumpyArchiveOutput(arc, {
            "direction": 0, "width": WIDTH, "height": HEIGHT,
            "framerate": 30.0}, replace=True)
        yy = np.linspace(0, 2 * np.pi, HEIGHT, dtype=np.float32)[:, None]
        xx = np.linspace(0, 2 * np.pi, WIDTH, dtype=np.float32)[None, :]
        for k in range(frames):
            phase = 2 * np.pi * k / frames
            archive.write_array(np.stack(
                [3 * np.sin(xx + phase) * np.cos(yy),
                 3 * np.cos(xx) * np.sin(yy + phase)],
                axis=-1).astype(np.float16))
        archive.close()
        cfg = Config(arc, output_path=os.path.join(root, "replay.avi"),
                     vcodec="mjpeg", pixmap_sources=[PixmapSourceConfig(pix)],
                     seed=0)
        out.update(_e2e_run("archive_replay", cfg, frames, device))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def card(device):
    """The card's name and power limit as ``nvidia-smi`` gives them; "cpu"
    off the card."""
    if device.type != "cuda":
        return "cpu"
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True, timeout=60).stdout
    name, _, power_limit = line.strip().rpartition(", ")
    return {"name": name, "power_limit": power_limit}


def main(argv=None, device=None) -> dict:
    """Run the bench and print its record as one JSON line; returns the
    record. ``device``: the current CUDA device by default (no card
    raises); ``"cpu"`` runs it on the CPU."""
    parser = argparse.ArgumentParser(
        prog="python -m transflow_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    parser.add_argument("--e2e", action="store_true",
                        help="also time the CLI disk to disk over a "
                             "cv2-written MJPG clip")
    args = parser.parse_args(argv)
    device = resolve_device(device)
    cpu_fps = cpu_reference_fps()
    flagship = bench_device(device)
    record = {
        "metric": METRIC,
        "value": flagship["fps"],
        "unit": "frames/sec",
        "vs_baseline": flagship["fps"] / cpu_fps,
        "ms_per_frame": flagship["ms_per_frame"],
        "best_fps": flagship["best_fps"],
        "noise_iqr_pct": flagship["noise_iqr_pct"],
        "warmup_samples": flagship["warmup_samples"],
        "samples": flagship["samples"],
        "window_fps": flagship["window_fps"],
        "stage_ms": flagship["stage_ms"],
        "hbm_io_gbps": flagship["hbm_io_gbps"],
        "carry_state_mb": flagship["carry_state_mb"],
        "cpu_reference_fps": cpu_fps,
    }
    lfn = bench_liteflownet(device)
    lfn_launches = lfn.pop("launches_per_frame")
    record.update(lfn)
    record["fastest_preset"] = bench_fastest(device)
    if args.e2e:
        record.update(bench_e2e_cli(E2E_FRAMES, device))
    record["launches_per_frame"] = {"flagship": flagship["launches_per_frame"],
                                    "liteflownet": lfn_launches}
    record["host_syncs_per_frame"] = flagship["host_syncs_per_frame"]
    record["device"] = str(device)
    record["card"] = card(device)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()

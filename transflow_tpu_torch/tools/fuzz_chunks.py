"""Randomized chunk-boundary fuzz of the port's Pipeline: the chunked
render is bit-equal to the per-frame render across seek, duration,
repeat, lock and checkpoint boundaries, for both source kinds (a video's
frames through the estimator, and a ``.flow.zip`` replay's flows).

Counterpart of tools/fuzz_chunks.py, with its draws in its order. Each
case:

  1. renders a random config per frame (``batch_frames=1``) and chunked
     (a random batch size), and holds every output frame bit-equal;
  2. where a checkpoint cadence was drawn, resumes the chunked run from
     its first ``.ckpt.zip`` and holds the resumed tail bit-equal to the
     run's own frames.

Frames are written as PPM (the port's netpbm writer): the check compares
decoded arrays, so PNG is not needed. The assets are an MJPG ``.avi``
written by cv2, a PNG still and a float16 ``.flow.zip`` of smooth flows.

Usage:
  python -m transflow_tpu_torch.tools.fuzz_chunks [N] [--seed S] \\
      [--only I] [--device cpu]

N cases (default 100) run on the card by default; a failing case prints
its draw, and ``--seed S --only I`` runs it alone.
"""
import argparse
import os
import shutil
import sys
import tempfile

import numpy as np

FPS = 10.0
N_FRAMES = 14
H, W = 48, 64


def make_assets(root):
    """(video, image, archive) paths under ``root``: a panned random texture
    with a moving white bar as an MJPG ``.avi``, a random PNG still, and
    smooth time-varying float16 flows as a ``.flow.zip``."""
    from ..output.archive import NumpyArchiveOutput
    from ..utils.imageio import imwrite
    from ..utils.misc import require
    cv2 = require("cv2", "writing the fuzzer's MJPG clip")
    video = os.path.join(root, "video.avi")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), FPS,
                             (W, H))
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
    for t in range(N_FRAMES):
        frame = np.roll(base, shift=2 * t + 1, axis=1)
        frame[H // 3:2 * H // 3, (3 * t) % (W - 10):(3 * t) % (W - 10) + 10] \
            = (250, 250, 250)
        writer.write(frame)
    writer.release()
    image = os.path.join(root, "pix.png")
    imwrite(image, rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
    archive = os.path.join(root, "flow.flow.zip")
    arc = NumpyArchiveOutput(archive, {"direction": 0, "width": W,
                                       "height": H, "framerate": FPS},
                             replace=True)
    yy = np.linspace(0, 2 * np.pi, H, dtype=np.float32)[:, None]
    xx = np.linspace(0, 2 * np.pi, W, dtype=np.float32)[None, :]
    for t in range(N_FRAMES):
        phase = 2 * np.pi * t / N_FRAMES
        arc.write_array(np.stack(
            [2.5 * np.sin(xx + phase) * np.cos(yy + 0.5 * phase),
             2.5 * np.cos(xx - phase) * np.sin(yy)],
            axis=-1).astype(np.float16))
    arc.close()
    return video, image, archive


def draw_case(rng):
    """One random case and its layers, drawn as tools/fuzz_chunks.py draws
    them: seeks near the end, durations across rewinds, repeats, locks
    that extend or skip, checkpoint cadences landing mid-chunk."""
    from ..config import LayerConfig
    layers = []
    reset = rng.choice(["off", "random", "linear", "constant"])
    if reset != "off":
        layers = [LayerConfig(0, reset_mode=str(reset),
                              reset_random_factor=float(rng.uniform(.05, .4)),
                              reset_linear_factor=float(rng.uniform(.05, .4)),
                              reset_constant_step=float(rng.uniform(.5, 2)))]
    case = dict(
        seek_time=float(rng.choice([0.0, 0.2, 0.5, 1.0])),
        duration_time=float(rng.choice([0.4, 0.7, 1.1, 1.6])),
        repeat=int(rng.choice([1, 2, 3])),
        batch=int(rng.choice([2, 3, 5, 7])),
        checkpoint_every=(int(rng.choice([3, 5, 7]))
                          if rng.random() < 0.5 else None),
        pixmap=str(rng.choice(["image", "video"])),
        source=str(rng.choice(["video", "archive"])),
        filters=(str(rng.choice(["scale=1+math.sin(40*t)", "clip=4",
                                 "threshold=0.5"]))
                 if rng.random() < 0.4 else None),
        # a lock at t=0 raises (no flow to hold yet), so draws start later
        lock=((("stay", "(0.2, 0.3)") if rng.random() < 0.5
               else ("skip", "0.2 <= t < 0.5")) if rng.random() < 0.25
              else None),
        seed=int(rng.integers(0, 2 ** 31)),
    )
    return case, layers


def build_config(case, layers, video, image, archive, out_template):
    from ..config import Config, PixmapSourceConfig
    pix = image if case["pixmap"] == "image" else video
    src = video if case["source"] == "video" else archive
    return Config(
        src,
        pixmap_sources=[PixmapSourceConfig(pix, layers=[0])],
        layers=list(layers),
        output_path=out_template,
        vcodec="mjpeg",
        seek_time=case["seek_time"],
        duration_time=case["duration_time"],
        repeat=case["repeat"],
        flow_filters=case["filters"],
        lock_expr=case["lock"][1] if case["lock"] else None,
        lock_mode=case["lock"][0] if case["lock"] else None,
        seed=case["seed"],
        batch_frames=case["batch"],
    )


def frames_of(folder, prefix):
    # .ppm only: the checkpoints share the output prefix (ch_00003.ckpt.zip)
    return sorted(f for f in os.listdir(folder)
                  if f.startswith(prefix) and f.endswith(".ppm"))


def _same(folder, a, b) -> bool:
    from ..utils.imageio import read_netpbm
    return np.array_equal(read_netpbm(os.path.join(folder, a)),
                          read_netpbm(os.path.join(folder, b)))


def run_case(index, case, layers, video, image, archive, workdir,
             device=None):
    """Run one case under ``workdir``; None where it holds, else what
    differed."""
    from ..config import Config
    from ..pipeline import Pipeline
    folder = os.path.join(workdir, f"case{index}")
    os.makedirs(folder, exist_ok=True)
    results = {}
    for tag, batch in (("pf", 1), ("ch", case["batch"])):
        cfg = build_config(dict(case, batch=batch), layers, video, image,
                           archive, os.path.join(folder, f"{tag}-%03d.ppm"))
        Pipeline(cfg, progress=False, execute=False, replace=True,
                 checkpoint_every=(case["checkpoint_every"]
                                   if tag == "ch" else None),
                 device=device).run()
        results[tag] = frames_of(folder, tag + "-")
    if len(results["pf"]) != len(results["ch"]):
        return (f"frame-count mismatch: per-frame {len(results['pf'])} vs "
                f"chunked {len(results['ch'])}")
    if not results["pf"]:
        return "no frames rendered"
    for a, b in zip(results["pf"], results["ch"]):
        if not _same(folder, a, b):
            return f"pixel mismatch at {a} vs {b}"
    # the resume: the chunked config again from its first checkpoint
    if case["checkpoint_every"] and case["checkpoint_every"] < len(
            results["ch"]):
        ckpts = sorted(f for f in os.listdir(folder)
                       if f.endswith(".ckpt.zip"))
        if not ckpts:
            return "checkpoint cadence produced no .ckpt.zip"
        cursor = int(ckpts[0].split("_")[-1].split(".")[0])
        for name in frames_of(folder, "ch-"):
            os.rename(os.path.join(folder, name),
                      os.path.join(folder, name.replace("ch-", "ref-")))
        try:
            Pipeline(Config(os.path.join(folder, ckpts[0])), progress=False,
                     execute=False, replace=True, device=device).run()
        except RuntimeError as exc:
            if "locked but has not been initialized" in str(exc):
                # the resume landed inside a lock window, whose held flow
                # predates it: a refusal both packages make, not a fault
                return None
            raise
        resumed = frames_of(folder, "ch-")
        if not resumed:
            return "resume rendered no frames"
        for name in resumed:
            number = int(name.split("-")[1].split(".")[0])
            if number < cursor:
                return f"resume rewrote pre-cursor frame {name}"
            ref = name.replace("ch-", "ref-")
            if not os.path.exists(os.path.join(folder, ref)):
                return f"resume produced extra frame {name}"
            if not _same(folder, ref, name):
                return f"resume mismatch at {name}"
    shutil.rmtree(folder, ignore_errors=True)
    return None


def run(n: int = 100, seed: int = 0, only: int | None = None,
        device=None) -> int:
    """Draw ``n`` cases from ``seed`` and run them (only case ``only``
    where given) on ``device`` (the current CUDA device by default);
    prints a line a case; returns the count of failing cases."""
    workdir = tempfile.mkdtemp(prefix="transflow_torch_fuzz_chunks_")
    try:
        video, image, archive = make_assets(workdir)
        rng = np.random.default_rng(seed)
        failures = 0
        for index in range(n):
            case, layers = draw_case(rng)
            if only is not None and index != only:
                continue
            error = run_case(index, case, layers, video, image, archive,
                             workdir, device)
            if error:
                failures += 1
                print(f"FAIL case {index}: {error}\n  {case}", flush=True)
            else:
                print(f"ok case {index}: src={case['source']} "
                      f"batch={case['batch']} "
                      f"seek={case['seek_time']} "
                      f"dur={case['duration_time']} rep={case['repeat']} "
                      f"ckpt={case['checkpoint_every']} lock={case['lock']} "
                      f"pix={case['pixmap']}", flush=True)
        ran = n if only is None else 1
        print(f"\n{ran - failures}/{ran} cases bit-equal (seed={seed})",
              flush=True)
        return failures
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("n", nargs="?", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="cpu, or a CUDA device (default: the current "
                             "one)")
    args = parser.parse_args(argv)
    return 1 if run(args.n, args.seed, args.only, args.device) else 0


if __name__ == "__main__":
    sys.exit(main())

"""Realtime low-latency flow transfer: camera or video -> the card -> a
window or a file.

Counterpart of extra/realtime.py over the port: the native IO runtime
(``native.py``, native/transflow_io.cpp) captures, converts and shows the
frames off the GIL, and each frame is one ``FlowTransferModel.step`` of
the port on its device (the card by default).

Hotkeys (window mode):
  ESC/q  quit
  r      reset the compositor (one frame of full reset)
  s      save a PNG snapshot

Usage:
  python -m transflow_tpu_torch.tools.realtime 0                 # webcam 0
  python -m transflow_tpu_torch.tools.realtime in.mp4 -o out.avi # headless
"""
import argparse
import time

import numpy as np


def main(argv=None, device=None) -> int:
    """Run the tool's command line ``argv``; returns the frames rendered.
    ``device``: where the model steps, the current CUDA device by default;
    ``"cpu"`` runs it on the CPU."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("source", help="webcam index or video path")
    parser.add_argument("-o", "--output", default=None,
                        help="write to a video file instead of a window")
    parser.add_argument("--size", default=None, help="WIDTHxHEIGHT")
    parser.add_argument("--method", default="farneback",
                        choices=["farneback", "horn-schunck", "lukas-kanade"])
    parser.add_argument("--reset", type=float, default=0.01,
                        help="random reset probability per frame")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-frames", type=int, default=None)
    args = parser.parse_args(argv)

    import torch
    from .. import native, prng
    from ..config import LayerConfig
    from ..flow import Direction
    from ..model import FlowTransferModel
    from ..ops.image import rgb_to_gray

    source = int(args.source) if args.source.isdigit() else args.source
    width = height = 0
    if args.size:
        width, height = (int(x) for x in args.size.lower().split("x"))
    reader = native.NativeReader(source, width, height, gray=False)
    h, w = reader.height, reader.width
    print(f"source: {w}x{h} @ {reader.fps:.1f} fps")

    model = FlowTransferModel(
        h, w, [LayerConfig(0, reset_mode="random",
                           reset_random_factor=args.reset)],
        {0: [(3, np.ones((h, w), bool))]},
        method=args.method, direction=Direction.BACKWARD,
        framerate=reader.fps, device=device)

    first = reader.read()
    if first is None:
        print("empty source")
        reader.close()
        return 0
    gray_first = np.asarray(
        0.299 * first[..., 0] + 0.587 * first[..., 1]
        + 0.114 * first[..., 2], dtype=np.uint8)
    state = model.init_state(gray_first)
    pixmap = ((torch.from_numpy(first).to(model.device),),)
    frame_numbers = model.default_frame_numbers()
    key = prng.key(args.seed)

    writer = None
    if args.output:
        writer = native.NativeWriter(args.output, w, h, reader.fps or 30.0)

    frames = 0
    started = time.time()
    try:
        for rgb in reader:
            gray = rgb_to_gray(torch.from_numpy(rgb).to(model.device))
            key, sub = prng.split(key)
            state, out = model.step(
                state, gray, pixmap,
                float(np.float32(frames / (reader.fps or 30))), sub,
                frame_numbers)
            frames += 1
            host = out.cpu().numpy()
            if writer is not None:
                writer.feed(host)
                if args.max_frames and frames >= args.max_frames:
                    break
            else:
                pressed = native.display("transflow-tpu", host, wait_ms=1)
                if pressed in (27, ord("q")):
                    break
                if pressed == ord("r"):
                    state["comp"] = model._comp_init()
                if pressed == ord("s"):
                    from ..utils.imageio import imwrite
                    imwrite(f"snapshot-{frames:05d}.png", host)
                if args.max_frames and frames >= args.max_frames:
                    break
    except KeyboardInterrupt:
        pass
    finally:
        elapsed = time.time() - started
        print(f"{frames} frames in {elapsed:.1f}s "
              f"({frames / max(elapsed, 1e-6):.1f} fps end-to-end)")
        reader.close()
        if writer is not None:
            writer.close()
    return frames


if __name__ == "__main__":
    main()

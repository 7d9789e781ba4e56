"""Flow inspector: render any flow source as color maps, or print its
statistics.

Counterpart of extra/viewflow.py over the port. The render mode runs the
port's CLI with ``--view-flow`` (or ``--view-flow-magnitude``), so the
flow renderers run on the card; ``--stats`` prints a line of magnitudes a
frame through the port's ``FlowSource``; ``--play`` opens the
frame-by-frame player (``viewflow_player.py``, a cv2 window).

Usage:
  python -m transflow_tpu_torch.tools.viewflow video.flow.zip -o out/%04d.ppm
  python -m transflow_tpu_torch.tools.viewflow frames/%04d.pgm --magnitude \\
      -o mag/%04d.ppm
  python -m transflow_tpu_torch.tools.viewflow video.flow.zip --stats
"""
import argparse

import numpy as np


def print_stats(path: str) -> None:
    """extra/viewflow.py's ``--stats`` lines over the flow source
    ``path``: its size, rate and length, then each flow's mean and
    maximum magnitude and its share of pixels moving over 0.5 px. A source
    that yields frames (an estimator's) stops at a note."""
    from ..flow.sources.base import FlowItem, FlowSource
    with FlowSource.from_args(path) as source:
        print(f"{source.width}x{source.height} @ {source.framerate} fps, "
              f"{source.length} frames")
        for index, item in enumerate(source):
            if item.kind != FlowItem.FLOW:
                print("(estimator source: use the render mode for "
                      "computed flows)")
                break
            mag = np.linalg.norm(np.asarray(item.array), axis=-1)
            print(f"frame {index:5d}: mean |f| {mag.mean():7.3f}  "
                  f"max |f| {mag.max():7.3f}  "
                  f"moving {np.mean(mag > 0.5):6.1%}")


def main(argv=None, device=None):
    """Run the tool's command line ``argv``; the render mode returns the
    CLI's Pipeline. ``device``: where the render runs, the current CUDA
    device by default; ``"cpu"`` runs it on the CPU."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("source", help="flow source (.flow.zip or an image "
                        "sequence)")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--magnitude", action="store_true",
                        help="render the magnitude instead of the direction")
    parser.add_argument("--scale", type=float, default=0.1)
    parser.add_argument("--colors", type=str, default=None)
    parser.add_argument("--binary", action="store_true")
    parser.add_argument("--stats", action="store_true",
                        help="print per-frame flow statistics instead of "
                        "rendering")
    parser.add_argument("--play", action="store_true",
                        help="interactive frame-by-frame inspector (a cv2 "
                        "window)")
    parser.add_argument("--arrow-step", type=int, default=24,
                        help="arrow overlay grid pitch (--play)")
    args = parser.parse_args(argv)

    if args.play:
        from .viewflow_player import run_player
        return run_player(args.source, arrow_step=args.arrow_step,
                          device=device)
    if args.stats:
        print_stats(args.source)
        return None

    from ..cli import main as cli_main
    cli_argv = [args.source,
                "--view-flow-magnitude" if args.magnitude else "--view-flow",
                "--render-scale", str(args.scale), "--no-exec"]
    if args.colors:
        cli_argv += ["--render-colors", args.colors]
    if args.binary:
        cli_argv.append("--render-binary")
    if args.output:
        cli_argv += ["-o", args.output, "--overwrite"]
    return cli_main(cli_argv, device=device)


if __name__ == "__main__":
    main()

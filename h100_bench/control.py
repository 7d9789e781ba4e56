"""The control of a cell's comparison, and the program's readings beside
it, over several seeds in one process.

    python3 -m h100_bench.control --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed it runs the cell (set-up, a window of ``--seconds``, the
kept steps) and prints one JSON line: the program's numbers against the
reference, and the control's (the reference computed at the precision
below the configuration's, ``precision.control``, in the program's
place) against the same reference. The control has to fail the cell's
limits; the program's readings over a dozen seeds or more set their lower
end (PERF.md gives both). Benchmark runs never run it.
"""
import argparse
import json
import sys
import time

from . import cells, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    cell = cells.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return run.EXIT_REFUSED
    for seed in args.seeds:
        result = run.run_cell(cell, seed, args.seconds, False,
                              torch.device("cuda", 0),
                              started=time.perf_counter(), control=True)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "program": {k: v["value"] for k, v in result["checks"].items()},
            "control": result["control"],
            "setup_s": result["diagnostics"]["setup_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

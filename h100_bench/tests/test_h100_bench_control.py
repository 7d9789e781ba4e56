"""The control of each cell's comparison on the card: the reference, at
the precision below the configuration's, put in the program's place,
fails the cell's limits, while the program passes them. At 270 x 480,
three seeds a cell; ``python -m h100_bench.control`` reads the same at
the cells' own sizes (PERF.md)."""
import copy

import pytest
import torch

from h100_bench import check, run
from tiny import load

CELLS = ["farneback.render_uhd", "liteflownet.render_1080p",
         "liteflownet.live_1080p"]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA card")
    cell = copy.deepcopy(load(name))
    cell.traffic.update(height=270, width=480)
    limits = cell.config["limits"]
    for seed in SEEDS:
        result = run.run_cell(cell, seed, 6.0, False, "cuda", control=True)
        assert result["correct"], result["checks"]
        assert not check.judge(result["control"], limits)[0], \
            result["control"]

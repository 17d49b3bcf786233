"""The control of the comparison comes out as not correct.

The control is the plain reference computed in fp8 (float8 e4m3 inputs
and weights of every linear layer, and keys and values), the next
precision below the configurations' bf16.  Here on the CPU at a tiny
size: on three seeds the bf16 program's widest gap stays under a limit
that every control reading exceeds.  On the card, at a cell's own size,
against the cell's own limit (``servebench/checks/<cell>.json``).
"""
import copy

import pytest
import torch

pytest.importorskip("repro_torch")

from servebench import calibrate  # noqa: E402
from servebench import test_servebench_faults as faults  # noqa: E402

SEEDS = [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3]


def test_the_fp8_control_fails_where_the_program_passes_tiny():
    torch.set_num_threads(1)
    cfg, mix = faults.tiny()
    limit = faults.CHECK["logit_gap_max"]
    got = list(calibrate.readings(cfg, mix, faults.CHECK, SEEDS, 3, 2.0,
                                  "cpu"))
    assert all(r["tokens"] >= 64 for r in got)
    assert max(r["program_gap"] for r in got) <= limit
    assert min(r["control_gap"] for r in got) > limit


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["dsc67b.code"])
def test_the_fp8_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs at its full size")
    cfg, mix, chk = calibrate.cell_files(cell)
    got = list(calibrate.readings(copy.deepcopy(cfg), mix, chk, SEEDS, 3,
                                  15.0))
    assert min(r["control_gap"] for r in got) > chk["logit_gap_max"]

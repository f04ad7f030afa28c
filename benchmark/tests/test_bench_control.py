"""The control: the reference in fp8 (the step below the configurations'
bf16) in the program's place must come out not correct under each cell's
limits.  On the CPU at a small size; on the card (marked `cuda`) at the
cell's own size on three seeds."""

import pytest

from conftest import tiny_spec
from core import check, manifest
from core.cell import Run, as_program, numbers

CELLS = ["nusc_usa_sing.train", "vkitti_skitti.train", "nusc_usa_sing.eval"]


def _control_correct(spec, seed, device) -> bool:
    run = Run(spec, seed, device)
    run.make_pool()
    kind = spec["mix"]["kind"]
    n = numbers(kind, as_program(kind, run.reference_record("fp8")),
                run.reference_record("fp32"))
    return check.judge(n, spec["limits"], spec["not_compared"])[0]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_a_small_size(manifest_data, cell):
    assert _control_correct(tiny_spec(manifest_data, cell), 41, "cpu") is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(manifest_data, cell, cuda_device):
    spec = manifest.cell_spec(manifest_data, cell)
    for seed in (51, 52, 53):
        assert _control_correct(spec, seed, cuda_device) is False

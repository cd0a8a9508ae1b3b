"""The control (the plain reference computed in bfloat16, put in the
program's place) fails each cell's check: at a test size on the CPU here,
and at the cell's own size on three seeds on the card (``cuda``)."""

import json

import pytest
import torch

from portbench import control, spec

from conftest import tiny_cell

CELLS = ["lj_melt_32k.rdf", "lj_melt_32k.adf", "lj_melt_32k.einstein"]


def fails(cell, numbers) -> bool:
    return any(numbers[name] > limit for name, limit in cell.limits.items())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_a_test_size(name):
    cell = tiny_cell(name, n_atoms=400, n_frames=100)
    assert fails(cell, control.readings(cell, seed=99, device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's own size")
    cell = spec.find_cell(name)
    for seed in (31, 32, 33):
        numbers = control.readings(cell, seed=seed, device="cuda")
        print(json.dumps({"cell": name, "control": control.CONTROL_DTYPE, "seed": seed,
                          "numbers": numbers, "limits": cell.limits}))
        assert fails(cell, numbers)

"""On the card: each cell's control (the program one precision step
below the configuration, ``precision("control")``) fails ``correct`` and
the program as configured passes, at the cell's widths and load over a
short window. Skips without a card."""

import pytest

from gpubench import spec
from gpubench.run import run_cell

CELLS = ["qwen3-0.6b.chat", "mistral-7b-v0.3-int8.batch",
         "qwen3-0.6b.batch"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(card, workload):
    cell = spec.cell(workload)
    seed = 2 ** 31 + 606
    program, _, _ = run_cell(cell, seed, 8.0, False)
    assert program["correct"], program["checks"]
    control, _, _ = run_cell(cell, seed, 8.0, False, which="control")
    assert not control["correct"], control["checks"]

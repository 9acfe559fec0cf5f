"""The control of each cell's ``correct``: the reference at the next lower
precision in the program's place (TF32 for the float32 splatting cells,
float8 linears for the bf16 FLUX) must come out not correct.  On the CPU at
the tiny sizes; on the card at the cells' own sizes, three seeds each."""

from __future__ import annotations

import pytest

import control
import tiny


def _fails(checks: dict) -> bool:
    return any(c["limit"] is None or c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct_tiny(cell):
    cfg, wl = tiny.cell(cell)
    out = control.control_checks(cell, 11, "cpu", cfg, wl)
    assert _fails(out["checks"]), out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's own size")
    for seed in (21, 22, 23):
        out = control.control_checks(cell, seed, "cuda")
        assert _fails(out["checks"]), out

"""The control (the plain reference one precision step below the
configuration: fp8 e4m3 products in the AST, TF32 in the float32 parts) is
refused by each cell's limits, and the program is not: on the CPU at tiny
widths, and on a CUDA card at the cell's own size."""

from __future__ import annotations

import pytest
import torch

from portbench import control, manifest
from portbench.tests import tiny

CELLS = ("infer.b32", "infer.clips", "stage1.q8")


def _refused(values: dict, limits: dict) -> bool:
    return any(values[k] > limits[k] for k in limits)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_refused_at_tiny_widths(name):
    cell = tiny.cell(name)
    limits = cell.settings["check"]["limits"]
    cpu = torch.device("cpu")
    assert _refused(control.control_reading(cell, 5, cpu), limits)
    assert not _refused(control.program_reading(cell, 5, cpu), limits)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs its kernels")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_refused_at_the_cells_size(name, cuda):
    cell = manifest.cell(tiny.ROOT, name)
    limits = cell.settings["check"]["limits"]
    for seed in (101, 102, 103):
        assert _refused(control.control_reading(cell, seed, cuda), limits), seed
    assert not _refused(control.program_reading(cell, 101, cuda), limits)

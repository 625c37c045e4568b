"""On the card, at each cell's own size: the fp8 control comes out not
correct by the committed limits on three seeds, and the program correct
on three.  ``python -m pytest benchmark/tests -m cuda`` on a machine with
an H100 (about 10 minutes); skipped without one."""

from __future__ import annotations

import pytest

from benchmark.run import judge
from benchmark.spec import Spec

from .conftest import REPO

CELLS = [c["name"] for c in Spec(REPO).bench["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_holds(card, cell):
    from benchmark.calibrate import readings
    from benchmark.reference.lowp import Rounding

    limits = Spec(REPO).limits(cell)
    for seed in (3900000001, 3900000002, 3900000003):
        assert judge(readings(cell, seed, 3.0)["numbers"], limits)[0]
        ctrl = readings(cell, seed, 3.0, control=Rounding())["numbers"]
        assert not judge(ctrl, limits)[0]

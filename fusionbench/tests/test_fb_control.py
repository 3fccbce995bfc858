"""The control (the reference in bfloat16 in the program's place) comes
out not correct under every cell's limits, at a size the CPU holds."""

import pytest
import torch

from fusionbench import control
from fusionbench.harness import registry
from fusionbench.judge import common
from fusionbench.tests import tiny

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    _, _, cfg, tr, lim = tiny.cell(name)
    nums = control.readings(cfg, tr, 5, "cpu", ftype=torch.bfloat16)
    lim = {k: v for k, v in lim["numbers"].items() if k in nums}
    ok, checks = common.verdict(nums, lim)
    assert not ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_reference_passes_itself(name):
    """The same comparison with the reference in its own precision in the
    program's place reads nothing: the control's failure is its
    precision's."""
    _, _, cfg, tr, lim = tiny.cell(name)
    nums = control.readings(cfg, tr, 5, "cpu", ftype=torch.float32)
    lim = {k: v for k, v in lim["numbers"].items() if k in nums}
    ok, checks = common.verdict(nums, lim)
    assert ok, checks

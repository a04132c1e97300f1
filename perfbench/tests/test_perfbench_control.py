"""The control (the reference in the program's place, in bfloat16) comes out
not correct under every cell's limits, at a size a test run holds."""

import pytest

from perfbench import harness
from perfbench.tests.small import CELLS, run


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    r = run(name, controls=True)
    assert r["correct"] is True, r["checks"]
    limits = harness.load_cell(name).limits
    ctrl = r["control"]["control"]
    failed = [k for k, v in ctrl.items() if v > limits[k]]
    assert failed, ctrl
    assert ctrl.get("step_gap", ctrl.get("round_gap")) > limits.get("step_gap",
                                                                     limits.get("round_gap"))
    assert r["control_correct"] == {"control": False}

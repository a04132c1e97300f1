"""On the card: the small copy of each cell through the captured path, with
the reference's verdict (``pytest -m cuda perfbench/tests`` on a machine
with a CUDA device; skipped here)."""

import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.small import CELLS, SEED, small_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_small_cell_on_the_card(name, card):
    cell = small_cell(name)
    cell.traffic["fused"] = "auto"
    r = harness.run_cell(cell, SEED, 0.5, True, card, time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert r["device"]["busy_s"] > 0 and r["breakdown"]["device_ops"]

"""The frozen work counts: hand-worked at a small shape, the same whatever
route the engine takes, and free of the program's own count."""

import ast
import math
from pathlib import Path

import pytest

from perfbench import work
from perfbench.tests.small import SEED, small_cell
from perfbench import harness

BENCH = Path(__file__).resolve().parents[1]


def test_slot_work_by_hand():
    cfg = {"p": 4, "m": 2}
    n, nnz, updates = 10, 20, 3  # degree 2
    rows = 10 * (1 - (1 - 0.1) ** 9)  # distinct of 3 * (2 + 1) uniform picks
    want = rows * 16 + 3 * (2 * 16 + 2 * 4 + 2 * 8 + 16 + 16)
    nbytes, flops = work.slot_work(cfg, n, nnz, updates)
    assert nbytes == pytest.approx(want)
    assert flops == 3 * (2 * 2 * 4 + 4 * 2 * 4 + 8 * 4)


def test_private_flops_add_the_clip_and_noise():
    cfg = {"p": 4, "m": 2, "private": {"clip": 1.0}}
    assert work.update_flops(cfg, 2.0) == 16 + 32 + 32 + 8 + 16


def test_round_and_mix_work_by_hand():
    cfg = {"p": 4, "m": 2}
    nbytes, flops = work.round_work(cfg, 10, 20)
    assert nbytes == 2 * 10 * 16 + 20 * 8 + 11 * 8 + 10 * (32 + 8) + 10 * 16
    assert flops == 10 * (16 + 32 + 32)
    assert work.mix_work(cfg, 10, 20) == (2 * 10 * 16 + 20 * 8 + 11 * 8, 2 * 20 * 4)


def test_bound_takes_the_larger_term():
    assert work.bound_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert work.bound_seconds(0.0, 67e12) == pytest.approx(1.0)


def test_distinct_limits():
    assert work.distinct(1000, 1) == pytest.approx(1.0)
    assert work.distinct(1000, 1e9) == pytest.approx(1000.0)
    assert work.distinct(10**6, 100) == pytest.approx(100, rel=1e-3)
    assert math.isfinite(work.distinct(500_000, 66_000))


def _mfu(route_fused):
    cell = small_cell("rgg500k_p100.async")
    cell.traffic["fused"] = route_fused
    seeds = harness.agents.stream_seeds(SEED)
    prob = harness.make_problem(cell.config, cell.traffic, seeds, harness.torch.device("cpu"))
    prog = harness.loop(cell).Program(cell.config, cell.traffic, prob, seeds,
                                      harness.torch.device("cpu"), harness.tr.Spans())
    prog.warm()
    u0, s0 = prog.updates(), prog.steps
    for _ in range(4):
        prog.call()
    updates, steps = prog.updates() - u0, prog.steps - s0
    assert prog.engine.fused is route_fused
    ctx = {"config": cell.config, "traffic": cell.traffic, "unit": prog.unit, "n": prob.n,
           "nnz": prob.nnz, "window": {"seconds": 1.0, "updates": updates, "steps": steps}}
    return harness.reader("mfu.update")(ctx), updates


def test_count_equal_for_fused_and_unfused_engine():
    fused, unfused = _mfu(True), _mfu(False)
    assert fused[1] == unfused[1]  # the same draws apply the same updates
    assert fused[0] == unfused[0]


def test_counts_never_read_the_programs_own():
    for path in [BENCH / "work.py", *sorted((BENCH / "metrics").glob("*.py"))]:
        tree = ast.parse(path.read_text())
        names = {a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
                 for a in node.names}
        names |= {node.module or "" for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom)}
        assert not any(n.split(".")[0] == "repro_torch" for n in names), path
        assert "count_slot" not in path.read_text(), path

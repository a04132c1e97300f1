"""The benchmark's sharded cell (``rgg500k_p100_s8_bf16ef.async_sharded``) on the CPU.

``perfbench/reference/halo.py`` against a hand-worked two-silo example of
bf16 rounding (ties to even both ways) and error feedback; the port's
``ShardedAsyncEngine`` as the cell builds it (8 shards, RCM, degree blocks,
the p2p bf16 wire with error feedback) at n = 512 against the reference
over forced and sampled slots: the moved rows within float32's rounding of
the float64 step, the halo rows and the residuals bit for bit; the cell's
small copy (n = 4,096, 512 wakes a slot) ``correct`` with every key of the
result line, untraced and traced; and each control (the slot in bfloat16,
the f32 wire, the bf16 wire without error feedback) failing a limit.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench import trace as tr  # noqa: E402
from perfbench.data import agents  # noqa: E402
from perfbench.data.problem import make_problem  # noqa: E402
from perfbench.reference.eq4 import Eq4Reference  # noqa: E402
from perfbench.reference.halo import HaloReference, bf16_round  # noqa: E402
from perfbench.tests.small import SEED, run, small_cell  # noqa: E402

CELL = "rgg500k_p100_s8_bf16ef.async_sharded"
CONTROLS = ("control", "f32_wire", "bf16_wire_no_ef")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The sharded slot is many small operations: on one thread each, so
    that the test workers sharing the machine's cores do not oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _path4():
    """Agents 0 - 1 - 2 - 3 on a path, weights 1; silos {0, 1} and {2, 3}."""
    indptr = np.array([0, 1, 3, 5, 6])
    indices = np.array([1, 0, 2, 1, 3, 2], dtype=np.int32)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(4, 2, 3)).astype(np.float32)
    y = rng.normal(size=(4, 2)).astype(np.float32)
    ref = HaloReference(indptr, indices, np.ones(6), X, y, 0.5)
    return ref.own(np.array([[0, 1], [2, 3]])), (indptr, indices, X, y)


def test_halo_reference_on_a_hand_worked_two_silo_path():
    ref, (indptr, indices, X, y) = _path4()
    n = 4
    assert ref.border.tolist() == [False, True, True, False]
    assert ref.border_keys.tolist() == [0 * n + 1, 1 * n + 2]  # silo 0 publishes 1, silo 1 2
    assert ref.halo_keys.tolist() == [0 * n + 2, 1 * n + 1]  # silo 0 reads 2, silo 1 reads 1
    # Row 1: a tie between 1 and 1 + 2^-7 (even: 1), one below a tie (1 + 2^-9
    # rounds down), 1 + 3 * 2^-8 a tie between two odd-even neighbours (up to
    # the even 1 + 2^-6). Row 2: 1 + 3 * 2^-9 rounds up to 1 + 2^-7, negated.
    theta = torch.zeros((n, 3), dtype=torch.float32)
    theta[1] = torch.tensor([1 + 2**-8, 1 + 2**-9, 1 + 3 * 2**-8])
    theta[2] = torch.tensor([-(1 + 3 * 2**-9), 0.5, 3.0])
    theta[0], theta[3] = 7.0, 9.0
    q, e = ref.publish(theta, torch.zeros_like(theta))
    assert q[1].tolist() == [1.0, 1.0, 1 + 2**-6]
    assert q[2].tolist() == [-(1 + 2**-7), 0.5, 3.0]
    assert e[1].tolist() == [2**-8, 2**-9, -(2**-8)]
    assert e[2].tolist() == [2**-9, 0.0, 0.0]
    assert torch.equal(q[[0, 3]], theta[[0, 3]]) and not e[[0, 3]].any()
    # The residual re-enters the next payload: 1 + 2^-8 + 2^-8 = 1 + 2^-7 is
    # a bf16 value, so it goes out whole and the residual returns to 0.
    q2, e2 = ref.publish(theta, e)
    assert q2[1, 0].item() == 1 + 2**-7 and e2[1, 0].item() == 0.0
    assert torch.equal(bf16_round(theta), theta.to(torch.bfloat16).float())
    # The step reads its own silo's neighbour exactly and the other's as q:
    # the plain Eq. 4 step over a matrix that holds q in the read rows.
    plain = Eq4Reference(indptr, indices, np.ones(6), X, y, 0.5)
    for rows, mixed in (([1], {2: q[2]}), ([2], {1: q[1]}), ([0, 3], {})):
        th = theta.clone().double()
        for j, v in mixed.items():
            th[j] = v.double()
        got = ref.step(torch.tensor(rows), theta.double(), q.double())
        assert torch.equal(got, plain.step(torch.tensor(rows), [th])), rows


@pytest.mark.parametrize("blocks", [[[0, 1], [1, 3]], [[0, 1], [2, 4]], [[0, 1, 2], [3, 0, 4]]],
                         ids=["repeat", "missing", "twice"])
def test_halo_reference_refuses_what_is_not_a_partition(blocks):
    ref, _ = _path4()
    with pytest.raises(ValueError, match="partition"):
        ref.own(np.array(blocks))


def _cell_program(n: int, slot_wakes: float, seed: int = SEED):
    """The cell's program and reference at ``n`` agents on the CPU."""
    cell = harness.load_cell(CELL, {"n": n, "slot_wakes": slot_wakes})
    lp = harness.loop(cell)
    seeds = agents.stream_seeds(seed)
    prob = make_problem(cell.config, cell.traffic, seeds, "cpu")
    prog = lp.Program(cell.config, cell.traffic, prob, seeds, "cpu", tr.Spans())
    ref = lp.reference(cell.config, prob, "cpu").own(prog.layout().blocks)
    return prog, ref


@pytest.mark.parametrize("mode", ["forced", "sampled"])
def test_engine_slots_equal_the_halo_reference(mode):
    """n = 512, 8 shards: each of six slots from a moving state moves the
    woken rows to the float64 step within float32 rounding, leaves the
    halo rows equal to the reference's bf16 payloads and the residuals to
    its own, bit for bit."""
    torch.manual_seed(0)
    prog, ref = _cell_program(512, 64.0)
    eng, lay = prog.engine, prog.layout()
    meta = eng.report_meta()
    assert (meta["num_shards"], meta["exchange_method"], meta["exchange_dtype"],
            meta["error_feedback"], meta["fused"]) == (8, "p2p", "bf16", True, True)
    assert eng.part.relabel == "rcm" and eng.part.mode == "degree"
    n, p = eng.n, eng.p
    rng = np.random.default_rng(5)
    state = eng.init_state(rng.normal(size=(n, p)).astype(np.float32))
    residuals = 0
    for k in range(6):
        start = lay.snapshot(state, p)
        if mode == "forced":
            mask = rng.random(n) < 0.15  # by the run's names; the engine's are the base graph's
            state = eng.step(state, mask[prog.names])
        else:
            state = eng.advance(state, 1)
        got = lay.snapshot(state, p)
        moved = torch.nonzero((got.theta != start.theta).any(1)).squeeze(1)
        if mode == "forced":
            want = torch.nonzero(torch.as_tensor(mask) & start.active).squeeze(1)
            assert torch.equal(moved, want), k
        assert got.applied - start.applied == moved.numel() > 0
        q, e = ref.publish(start.theta, lay.residuals(start, n))
        assert torch.equal(got.halo, q[lay.halo_agents]), k
        assert torch.equal(got.ef, e[lay.border_agents]), k
        det = ref.step(moved, start.theta.double(), q.double())
        gap = (got.theta[moved].double() - det).abs().max() / det.abs().max()
        assert gap < 1e-6, (k, float(gap))
        residuals += int((got.ef != 0).any(1).sum())
    assert residuals > 0  # the rounding left residuals to feed back


def _line(r: dict) -> dict:
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    return line


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_small_copy_of_the_cell_is_correct(traced, monkeypatch):
    # One traced call, and the phase programs timed once each, not 3 x 32
    # times: CPU times mean nothing, the keys and the check are what count.
    cell = small_cell(CELL)
    cell.traffic["trace_calls"] = 1
    prefixes = harness.loop(cell).Program.phase_prefixes
    monkeypatch.setattr(harness.loop(cell).Program, "phase_prefixes",
                        lambda self: prefixes(self, 1, 1))
    torch.manual_seed(0)
    line = _line(harness.run_cell(cell, SEED, 0.5, traced, "cpu", time.perf_counter()))
    assert line["correct"] is True, line["checks"]
    limits = harness.load_cell(CELL).limits
    assert set(line["checks"]) == set(limits)
    for name, (value, limit) in line["checks"].items():
        assert value <= limit == limits[name], name
    assert line["checks"]["halo_mismatch"] == [0, 0]
    assert line["checks"]["ef_gap"] == [0.0, limits["ef_gap"]]
    assert line["checks"]["chunk_mismatch"] == [0, 0]
    if not traced:
        assert set(line["metrics"]) == {"updates_per_s", "setup_s"}
        rate = line["metrics"]["updates_per_s"]
        assert rate["value"] > 0 and rate["unit"] == "updates/s"
        return
    # The CPU has no device trace: the counted and phase metrics read.
    assert set(line["metrics"]) == {"mfu.update", "phase_us.wake_sample",
                                    "phase_us.halo_exchange", "phase_us.shard_update"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.fixture(scope="module")
def with_controls():
    return run(CELL, controls=True)


@pytest.mark.parametrize("name", CONTROLS)
def test_each_control_fails_a_limit(with_controls, name):
    r = with_controls
    assert r["correct"] is True, r["checks"]
    limits = harness.load_cell(CELL).limits
    ctrl = r["control"][name]
    failed = {k for k, v in ctrl.items() if v > limits[k]}
    assert r["control_correct"] == {k: False for k in CONTROLS}
    # Each fails where it differs from the deployment: the payload, the
    # residual, and the step that reads the payload.
    assert {"step_gap", "halo_mismatch", "ef_gap"} <= failed, ctrl


def test_program_snapshot_is_the_state_in_agent_order():
    """The layout reads the models, flags and residuals where the engine
    keeps them: the engine's own ``global_theta`` and partition agree."""
    prog, _ = _cell_program(512, 64.0)
    eng, lay = prog.engine, prog.layout()
    state = eng.advance(eng.init_state(np.random.default_rng(2).normal(
        size=(eng.n, eng.p)).astype(np.float32)), 3)
    snap = lay.snapshot(state, eng.p)
    run_order = np.argsort(prog.names)  # the engine's agent of each of the run's names
    assert torch.equal(snap.theta, torch.as_tensor(eng.global_theta(state)[run_order]))
    part = eng.part
    for s in range(eng.num_shards):
        b = part.border[s, : int(part.border_sizes[s])]
        want = state.ef[s, : b.size]
        named = torch.as_tensor(prog.names[part.owned[s, b]], dtype=torch.int64)
        got = snap.ef[torch.isin(lay.border_agents, named)]
        assert torch.equal(got, want), s
    s0 = dataclasses.replace(snap, applied=0)
    assert s0.halo.shape == (int(part.halo_sizes.sum()), eng.p)


def test_every_seed_runs_the_deployments_one_silo_cut():
    """The engine holds the configuration's base graph under its own names
    (the generator's, before the run's renaming), so two seeds cut the
    same silos; the layout names them as the run does."""
    import importlib

    a, _ = _cell_program(4096, 512.0)
    b, _ = _cell_program(4096, 512.0, seed=SEED + 1)
    cfg = a.cfg
    g = cfg["graph"]
    indptr, indices, _ = importlib.import_module(f"perfbench.data.{g['generator']}").csr(
        int(cfg["n"]), g, agents.generator(g["seed"], "cpu"))
    for prog in (a, b):
        csr = prog.engine.part.csr
        assert np.array_equal(csr.indptr, indptr) and np.array_equal(csr.indices, indices)
    assert not np.array_equal(a.names, b.names)
    for key in ("order", "owned", "border", "halo", "halo_sizes"):
        assert np.array_equal(getattr(a.engine.part, key), getattr(b.engine.part, key)), key
    for prog in (a, b):  # the layout's ownership in the run's names
        blocks = prog.layout().blocks
        assert sorted(blocks[blocks < prog.engine.n].tolist()) == list(range(prog.engine.n))
        owned = prog.engine.part.owned
        assert np.array_equal(blocks[owned < prog.engine.n], prog.names[owned[owned < 4096]])

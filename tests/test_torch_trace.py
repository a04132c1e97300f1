"""repro_torch.obs.trace, the engines' phase programs and the counted
roofline, against repro.obs.trace and repro.sim on the same inputs.

Counterpart of ``tests/test_obs.py``'s phase-tracing tests: a profile and
its Chrome trace (each package validates the other's), malformed traces
rejected, unknown phases rejected, the report CLI's ``--validate-trace``,
the phase names of every engine configuration equal to the reference's,
the full-slot program equal bit for bit to one eager slot on a copy, a
profile leaving the engine's state and random stream untouched (the
profiled engine equal to an unprofiled twin after 37 more slots), and
the counted bytes and flops of a small slot equal to a hand count.
Everything compared here is exact (names, bits, integer counts) but the
flop and byte counts, which are float64 sums held to 1e-12 relative.
"""

import json
import math

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.sim as jsim
from repro.core import AgentData, knn_graph, make_objective
from repro_torch.convert import objective_from_reference
from repro_torch.obs import SpanRecorder, profile_supertick, validate_trace
from repro_torch.obs import report as report_cli
from repro_torch.obs.roofline import count_slot, supertick_report
from repro_torch.sim import (AsyncEngine, CDUpdate, ChurnConfig, ExchangeSpec, GraphUpdate,
                             Scenario, ShardedAsyncEngine, StragglerConfig)
from repro_torch.sim.capture import clone_state

CPU = dict(device="cpu", dtype=torch.float32)
SCEN = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                straggler=StragglerConfig(drop_prob=0.2))


def _quad_problem(n, p=4, m=3, seed=0):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 8)), k=6)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    data = AgentData(X=X, y=y, mask=np.ones((n, m)))
    ref = make_objective(graph, data, "quadratic", mu=0.5, mix_mode="sparse")
    return ref, objective_from_reference(ref)


def _leaves(state) -> dict:
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if f == "generator":
            out[f] = v.get_state()
        elif isinstance(v, torch.Tensor):
            out[f] = v.clone()
        elif isinstance(v, dict):
            out.update({f"{f}.{k}": t.clone() for k, t in v.items()})
    return out


def _equal(a: dict, b: dict) -> list:
    assert a.keys() == b.keys()
    return [k for k in a if not torch.equal(a[k], b[k])]


ENGINES = {
    "fused": lambda obj: AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, fused=True,
                                     scenario=SCEN, metrics=True, **CPU),
    "unfused": lambda obj: AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, fused=False,
                                       scenario=SCEN, **CPU),
    "sharded_fused": lambda obj: ShardedAsyncEngine(CDUpdate(obj), num_shards=4, slot_wakes=8.0,
                                                    seed=0, fused=True, scenario=SCEN,
                                                    metrics=True, **CPU),
    "sharded_bf16_ef": lambda obj: ShardedAsyncEngine(
        CDUpdate(obj), num_shards=4, slot_wakes=8.0, seed=0, scenario=SCEN, metrics=True,
        exchange=ExchangeSpec(method="p2p", dtype="bf16", error_feedback=True), **CPU),
}


def test_profile_supertick_and_trace_export_read_by_both_packages(tmp_path):
    _, obj = _quad_problem(32, seed=7)
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, metrics=True, **CPU)
    recorder = SpanRecorder(eng.device)
    assert not recorder.nvtx  # NVTX ranges only where the work runs on a CUDA device
    prof = profile_supertick(eng, inner=1, repeats=1, recorder=recorder)
    assert tuple(prof.phases) == eng.phase_names
    assert all(dt >= 0.0 for dt in prof.phases.values())
    np.testing.assert_allclose(sum(prof.phases.values()), prof.total_s)
    rows = prof.rows(prefix="obs_phase")
    assert rows[-1][0] == "obs_phase_total" and "coverage" in rows[-1][2]
    trace = tmp_path / "trace.json"
    recorder.export_chrome_trace(str(trace))
    # live timing spans + one synthetic attribution span per phase
    n = validate_trace(str(trace))
    assert n >= len(prof.phases) and jobs.validate_trace(str(trace)) == n
    events = json.loads(trace.read_text())["traceEvents"]
    assert {e["name"] for e in events if e["tid"] == 1} == {
        f"obs.phase.{name}" for name in eng.phase_names}
    # The reference's recorder, read by the port's loader.
    ref_rec = jobs.SpanRecorder()
    with ref_rec.span("outer", k=np.int64(3)):
        pass
    ref_rec.add("synthetic", 0.0, 2.0, tid=1)
    rtrace = tmp_path / "ref.json"
    ref_rec.export_chrome_trace(str(rtrace))
    assert validate_trace(str(rtrace)) == 2
    # Same format: the same events give the same file content.
    mine = SpanRecorder()
    mine.add("synthetic", 0.0, 2.0, tid=1, k=np.int64(3))
    ref2 = jobs.SpanRecorder()
    ref2.add("synthetic", 0.0, 2.0, tid=1, k=np.int64(3))
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    mine.export_chrome_trace(str(a))
    ref2.export_chrome_trace(str(b))
    assert a.read_text() == b.read_text()


def test_validate_trace_rejects_malformed(tmp_path):
    bad = tmp_path / "bad.json"
    for content, match in (({"no_events": 1}, "Chrome trace"), ({"traceEvents": []}, "Chrome trace"),
                           ([1, 2], "Chrome trace"), ({"traceEvents": [{"ph": "X"}]}, "malformed"),
                           ({"traceEvents": ["x"]}, "malformed")):
        bad.write_text(json.dumps(content))
        with pytest.raises(ValueError, match=match):
            validate_trace(str(bad))
        with pytest.raises(ValueError, match=match):
            jobs.validate_trace(str(bad))


def test_report_cli_validates_either_packages_trace(tmp_path, capsys):
    rec = jobs.SpanRecorder()
    rec.add("span", 0.0, 1.0)
    rec.add("span2", 1.0, 1.0, tid=1)
    good = tmp_path / "ref_trace.json"
    rec.export_chrome_trace(str(good))
    assert report_cli.main(["--validate-trace", str(good)]) == 0
    assert f"{good}: valid Chrome trace, 2 spans" in capsys.readouterr().out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X"}]}))
    with pytest.raises(ValueError, match="malformed"):
        report_cli.main(["--validate-trace", str(bad)])


def test_phase_program_rejects_unknown_phase_and_dynamic_engines():
    _, obj = _quad_problem(24, seed=8)
    for make in ENGINES.values():
        eng = make(obj)
        with pytest.raises(ValueError, match="unknown phase 'not_a_phase'"):
            eng.phase_program("not_a_phase")
    dyn = AsyncEngine(CDUpdate(obj), seed=0, graph_update=GraphUpdate(every=4, k=3), **CPU)
    with pytest.raises(NotImplementedError, match="static-topology path only"):
        dyn.phase_program("wake_sample")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("sharded", [False, True])
def test_phase_names_equal_the_reference(fused, sharded):
    ref, obj = _quad_problem(24, seed=3)
    if sharded:
        want = jsim.ShardedAsyncEngine(jsim.CDUpdate(ref), num_shards=1, seed=0,
                                       fused=fused).phase_names
        got = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, seed=0, fused=fused,
                                 **CPU).phase_names
    else:
        want = jsim.AsyncEngine(jsim.CDUpdate(ref), seed=0, fused=fused).phase_names
        got = AsyncEngine(CDUpdate(obj), seed=0, fused=fused, **CPU).phase_names
    assert got == want


@pytest.mark.parametrize("label", list(ENGINES))
def test_full_program_equals_one_eager_slot_on_a_copy(label):
    _, obj = _quad_problem(40, seed=5)
    eng = ENGINES[label](obj)
    state = eng.advance(eng.init_state(np.zeros((obj.n, obj.p))), 3)
    before = _leaves(state)
    want = _leaves(eng._slot(clone_state(state), None))
    got = eng.phase_program(None)(state)
    assert _equal(_leaves(got), want) == []
    assert _equal(_leaves(state), before) == []  # the given state is only read
    # Every prefix runs on the scratch state and leaves the given one alone.
    for name in eng.phase_names:
        eng.phase_program(name)(state)
    assert _equal(_leaves(state), before) == []
    finalize = eng.phase_program("finalize")(state)  # the last cut is the whole slot
    assert _equal(_leaves(finalize), want) == []


@pytest.mark.parametrize("label", ["fused", "sharded_bf16_ef"])
def test_profile_leaves_the_engine_equal_to_an_unprofiled_twin(label):
    _, obj = _quad_problem(40, seed=6)
    eng, twin = ENGINES[label](obj), ENGINES[label](obj)
    zeros = np.zeros((obj.n, obj.p))
    state = eng.advance(eng.init_state(zeros), 5)
    tstate = twin.advance(twin.init_state(zeros), 5)
    before = _leaves(state)
    profile_supertick(eng, state=state, inner=2, repeats=1)
    assert _equal(_leaves(state), before) == []  # tensors and the generator's position
    state = eng.advance(state, 37)
    tstate = twin.advance(tstate, 37)
    assert _equal(_leaves(state), _leaves(tstate)) == []


def test_counted_bytes_of_a_small_slot_equal_a_hand_count():
    """A fused CD slot without churn at n = 16, p = 2, m = 3: each term
    written out by hand from the slot's code."""
    _, obj = _quad_problem(16, p=2, m=3, seed=2)
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=4.0, seed=0, fused=True, **CPU)
    n, p, m, B, K = 16, 2, 3, eng.batch_size, eng._fidx.shape[1]
    probs = np.asarray(eng.wake_probs)
    deg = np.diff(obj.graph.to_csr().indptr if hasattr(obj.graph, "to_csr")
                  else obj.graph.indptr).astype(np.float64)
    woken = min(B, probs.sum())
    edges = woken * (probs * deg).sum() / probs.sum()
    hand = {
        # rand(n) written + read, wake_p read, mask written; & active read
        "wake_draws": (4 * n + 4 * n + 4 * n + n) + n,
        # two int64 cumsums (bool in, 8 B out), the outside mask, two
        # binary searches of B queries over ceil(log2 n) int64 probes, where
        "compaction": 2 * (n + 8 * n) + (9 * n + n)
                      + 2 * (16 * B + 8 * B * math.ceil(math.log2(n))) + 24 * B,
        # idx/w tables gathered at the slot rows (read + write), the
        # constants alpha/deg/conf/lam, X, y, mask (read + write), coef
        "gathers": 2 * (2 * 4 * B * K) + 2 * B * 4 * (4 + m * p + 2 * m) + 48 * B,
        "fused_row_update": woken * (4 + 2 * K * 4 + 16 + m * p * 4 + 2 * m * 4)
                            + edges * p * 4 + 2 * woken * p * 4,
        "finalize": 16 * B,
    }
    count = count_slot(eng)
    assert count.bytes.keys() == hand.keys()
    for k, v in hand.items():
        assert count.bytes[k] == pytest.approx(v, rel=1e-12), k
    flops = {"wake_draws": n, "fused_row_update": 2 * edges * p + woken * (4 * m * p + 8 * p)}
    assert count.flops.keys() == flops.keys()
    for k, v in flops.items():
        assert count.flops[k] == pytest.approx(v, rel=1e-12), k
    rows = supertick_report(eng, steps=4, measured_s_per_tick=1e-3)
    assert [r[0] for r in rows] == ["roofline_supertick_bound", "roofline_supertick_gap"]
    bound_us = sum(hand.values()) / 3.35e12 * 1e6
    assert rows[0][1] == pytest.approx(bound_us, rel=1e-12)
    assert rows[0][2].startswith("dominant=memory ") and rows[0][2].endswith(" us/slot")
    assert rows[1][1] == pytest.approx(1e3 / bound_us, rel=1e-12)


def test_sharded_count_ships_the_wire_bytes():
    """The halo terms of the stacked slot: the planned rows at the wire's
    bytes per row (f32 against bf16 with error feedback)."""
    _, obj = _quad_problem(48, seed=4)
    f32 = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, seed=0, exchange=ExchangeSpec(method="p2p"), **CPU)
    bf16 = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, seed=0, partition=f32.part,
                              exchange=ExchangeSpec(method="p2p", dtype="bf16",
                                                    error_feedback=True), **CPU)
    rows = f32.part.exchange_rows("p2p")
    p = obj.p
    a, b = count_slot(f32).bytes, count_slot(bf16).bytes
    assert a["halo_collective"] == 2 * rows * p * 4
    assert b["halo_collective"] == 2 * rows * bf16.exchange_spec.payload_bytes_per_row(p)
    assert b["halo_publish"] == rows * p * 4 + rows * bf16.exchange_spec.payload_bytes_per_row(
        p) + 2 * rows * p * 4

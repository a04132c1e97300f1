"""The program's spans on the port's one recorder (``repro_torch.obs.trace``).

With no recorder active, ``span()`` is one shared no-op context that reads
no clock, and a ``torch.profiler`` run over an engine's set-up and
``advance`` sees none of the program's span names. Inside ``recording()``
the set-up spans that the CPU path runs (the graph's validation, the
objective's host passes, the copies to the device, the engine's tables
and state; the sharded build's partition cut and halo plan) are
recorded, on the profiler's clock too, with exclusive seconds that sum
to no more than the wall time around them; a recorded
engine stays equal, bit for bit, to an unrecorded twin. Nested spans give
exclusive seconds, on each thread's own stack. The spans that need the
card (kernel builds, captures, replays) are held in
``tests/test_torch_cuda.py``.
"""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import AgentData, DPConfig, make_objective
from repro_torch.core.graph import knn_graph
from repro_torch.obs import SpanRecorder, recording, span, validate_trace
from repro_torch.obs import trace as obs_trace
from repro_torch.sim import (AsyncEngine, CDUpdate, ChurnConfig, DPCDUpdate, ExchangeSpec,
                             Scenario, ShardedAsyncEngine)
from repro_torch.sim.capture import ChunkGraphs

# Every span the program emits; the CPU path runs the first six.
CPU_SETUP = ("graph.validate", "objective.host", "objective.tensors", "mix.tables",
             "engine.tables", "engine.init_state")
PROGRAM_SPANS = CPU_SETUP + ("kernels.build", "kernels.load", "engine.warm_slot",
                             "capture.graph", "capture.bind", "capture.replay")
# The sharded build's set-up spans.
SHARDED_SETUP = ("partition.cut", "halo.plan", "engine.tables", "engine.init_state")


def _setup(private: bool, n: int = 48, p: int = 4, m: int = 3, seed: int = 0):
    """A small engine made from host arrays, as a run makes it: the graph
    validated, the objective, the update, the engine and its state."""
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 6)), k=5)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)))
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse", clip=1.0 if private else None)
    update = (DPCDUpdate.plan(obj, DPConfig(eps_bar=0.5, delta_bar=np.exp(-5)), 11)
              if private else CDUpdate(obj))
    eng = AsyncEngine(update, slot_wakes=8.0, seed=3, device="cpu", dtype=torch.float32,
                      scenario=Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3)))
    return eng, eng.init_state(np.zeros((n, p)))


def _sharded_setup(n: int = 96, p: int = 4, m: int = 3):
    """A small sharded engine as the benchmark's sharded cell builds it (8
    shards, RCM, degree blocks, the p2p bf16 wire with error feedback) and
    its state."""
    rng = np.random.default_rng(1)
    graph = knn_graph(rng.normal(size=(n, 6)), k=6)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)))
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse")
    eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=8, relabel="rcm", partition_mode="degree",
                             exchange=ExchangeSpec("p2p", "bf16", True), fused=True,
                             slot_wakes=16.0, seed=3, device="cpu")
    return eng, eng.init_state(np.zeros((n, p)))


@pytest.mark.parametrize("recorded", [False, True], ids=["off", "on"])
def test_sharded_build_records_its_setup_spans(recorded):
    """The sharded build's partition cut, halo plan, tables and state are
    spans on the recorder, on the profiler's clock too; with no recorder
    none of their names reaches the profiler."""
    def run():
        eng, state = _sharded_setup()
        eng.advance(state, 3)

    if not recorded:
        assert not _profiled_names(run) & set(SHARDED_SETUP)
        return
    rec = SpanRecorder()
    with recording(rec):
        seen = _profiled_names(run)
    sec = rec.seconds()
    assert set(SHARDED_SETUP) <= set(sec) and set(SHARDED_SETUP) <= seen, sorted(sec)
    assert all(sec[k] >= 0.0 for k in SHARDED_SETUP)
    # ``tools/setup_spans.py`` counts the partition cut and the halo plan as host work.
    split = _setup_spans_tool().phases(sec)
    assert split["host_prep"] == pytest.approx(sum(
        sec.get(k, 0.0) for k in ("graph.validate", "objective.host", "partition.cut",
                                  "halo.plan")))


def _leaves(state) -> dict:
    out = {}
    for f in state._fields:
        v = getattr(state, f)
        if f == "generator":
            out[f] = v.get_state()
        elif isinstance(v, torch.Tensor):
            out[f] = v.clone()
    return out


def _profiled_names(fn) -> set:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_span_without_a_recorder_is_one_shared_noop_that_reads_no_clock(monkeypatch):
    assert obs_trace._ACTIVE is None
    assert span("graph.validate") is span("capture.replay", sync=torch.device("cpu"))

    def no_clock():
        raise AssertionError("a span read the clock with no recorder active")

    monkeypatch.setattr(time, "perf_counter", no_clock)
    monkeypatch.setattr(time, "monotonic", no_clock)
    monkeypatch.setattr(time, "time", no_clock)
    with span("objective.host"), span("engine.tables", sync=torch.device("cpu"), slots=16):
        pass


@pytest.mark.parametrize("private", [False, True], ids=["cd", "dp"])
def test_no_program_span_reaches_the_profiler_without_a_recorder(private):
    def run():
        eng, state = _setup(private)
        eng.advance(state, 5)

    assert not _profiled_names(run) & set(PROGRAM_SPANS)
    with recording(SpanRecorder()):  # the same run recorded: the names are there
        seen = _profiled_names(run)
    assert set(CPU_SETUP) <= seen


@pytest.mark.parametrize("private", [False, True], ids=["cd", "dp"])
def test_recorded_setup_spans_of_the_cpu_path(private, tmp_path):
    rec = SpanRecorder()
    t0 = time.perf_counter()
    with recording(rec) as active:
        assert active is rec and obs_trace._ACTIVE is rec
        eng, state = _setup(private)
        eng.advance(state, 5)
    wall = time.perf_counter() - t0
    assert obs_trace._ACTIVE is None
    sec = rec.seconds()
    assert set(CPU_SETUP) <= set(sec), sorted(sec)
    # The card's spans stay silent on the CPU: no kernel, no graph.
    assert not set(sec) & {"kernels.build", "kernels.load", "engine.warm_slot",
                           "capture.graph", "capture.bind", "capture.replay"}
    assert all(v >= 0.0 for v in sec.values()), sec
    assert sum(sec.values()) <= wall
    assert {e["name"] for e in rec.events} == set(sec)
    path = tmp_path / "trace.json"
    rec.export_chrome_trace(str(path))
    assert validate_trace(str(path)) == len(rec.events)


@pytest.mark.parametrize("private", [False, True], ids=["cd", "dp"])
def test_a_recorded_engine_equals_an_unrecorded_twin(private):
    with recording(SpanRecorder()):
        eng, state = _setup(private)
        state = eng.advance(state, 5)
    twin, tstate = _setup(private)
    tstate = twin.advance(tstate, 5)
    state, tstate = eng.advance(state, 37), twin.advance(tstate, 37)
    a, b = _leaves(state), _leaves(tstate)
    assert a.keys() == b.keys()
    assert [k for k in a if not torch.equal(a[k], b[k])] == []


def test_nested_spans_give_exclusive_seconds():
    rec = SpanRecorder()
    with recording(rec):
        with span("outer"):
            time.sleep(0.002)
            with span("inner"):
                time.sleep(0.003)
                with span("leaf"):
                    time.sleep(0.001)
            with span("inner"):
                pass
    dur = {}
    for e in rec.events:
        dur.setdefault(e["name"], []).append(e["dur"] / 1e6)
    sec = rec.seconds()
    assert sec["leaf"] == pytest.approx(sum(dur["leaf"]), rel=1e-9)
    assert sec["inner"] == pytest.approx(sum(dur["inner"]) - sum(dur["leaf"]), rel=1e-9)
    assert sec["outer"] == pytest.approx(dur["outer"][0] - sum(dur["inner"]), rel=1e-9)
    assert sec["outer"] + sec["inner"] + sec["leaf"] == pytest.approx(dur["outer"][0], rel=1e-9)
    assert sec["outer"] >= 0.0019 and sec["inner"] >= 0.0029 and sec["leaf"] >= 0.0009


def test_recording_restores_the_recorder_before_it():
    a, b = SpanRecorder(), SpanRecorder()
    with recording(a):
        with recording(b):
            with span("x"):
                pass
        with span("y"):
            pass
    assert obs_trace._ACTIVE is None
    assert set(a.seconds()) == {"y"} and set(b.seconds()) == {"x"}


def test_a_failed_section_leaves_the_stack_balanced():
    rec = SpanRecorder()
    with recording(rec):
        with span("outer"):
            with pytest.raises(ValueError):
                with span("broken"):
                    raise ValueError("x")
            with span("after"):
                pass
    assert set(rec.seconds()) == {"outer", "after"}  # a failed span records nothing
    assert rec._local.stack == []


def test_threads_keep_their_own_span_stacks():
    """More threads than cores, switching often: each thread's outer span
    loses exactly its own leaf's seconds, and no addition is lost."""
    rec = SpanRecorder()
    threads, rounds = 16, 60
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(rounds):
                with span(f"outer.{k}"):
                    with span(f"leaf.{k}"):
                        sum(range(200))
                with span("shared"):  # one name that every thread adds to
                    pass

        with recording(rec):
            pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    total = {}
    for e in rec.events:
        total[e["name"]] = total.get(e["name"], 0.0) + e["dur"] / 1e6
    sec = rec.seconds()
    assert len(rec.events) == threads * rounds * 3
    assert sec["shared"] == pytest.approx(total["shared"], rel=1e-9)
    for k in range(threads):
        assert sec[f"leaf.{k}"] == pytest.approx(total[f"leaf.{k}"], rel=1e-9)
        # A stack shared between threads would move another thread's leaf
        # seconds out of this outer span.
        assert sec[f"outer.{k}"] == pytest.approx(total[f"outer.{k}"] - total[f"leaf.{k}"],
                                                  rel=1e-6, abs=1e-9)


def test_binding_another_state_is_a_capture_bind_span():
    """``ChunkGraphs.bind`` (run here without graphs): adopting the first
    state and binding the live one copy nothing and record nothing;
    another state's copy into the live buffers is ``capture.bind``."""
    eng, state = _setup(False)
    graphs = ChunkGraphs(eng)
    rec = SpanRecorder()
    with recording(rec):
        live = graphs.bind(state)
        assert graphs.bind(live) is live
        assert "capture.bind" not in rec.seconds()
        bound = graphs.bind(eng.init_state(np.ones((eng.n, eng.p))))
    assert bound is live and bool((live.Theta == 1.0).all())
    assert [e["name"] for e in rec.events].count("capture.bind") == 1


def _setup_spans_tool():
    """``tools/setup_spans.py`` as a module, the repository's root on the path."""
    import importlib.util

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("setup_spans", root / "tools" / "setup_spans.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("name", ["rgg500k_p100.async", "rgg500k_p100_dp.async",
                                  "rgg500k_p100.sync", "rgg500k_p100.async_delay"])
def test_setup_split_of_a_small_benchmark_cell(name):
    """``tools/setup_spans.py`` over a small copy of each benchmark cell on
    the CPU: the host passes and the copies to the device are read, each
    >= 0, the groups sum to no more than the set-up's seconds, and the
    card's groups (kernels, captures) stay silent."""
    from perfbench.tests.small import SEED, small_cell

    tool = _setup_spans_tool()
    torch.manual_seed(0)
    line = tool.measure(small_cell(name), SEED, 0.2, True, "cpu", time.perf_counter())
    assert obs_trace._ACTIVE is None
    assert set(line["phases"]) == {"host_prep", "to_device"}, line["spans"]
    assert all(v >= 0.0 for v in line["phases"].values())
    assert sum(line["phases"].values()) <= line["setup_s"]
    assert line["rest_s"] == pytest.approx(line["setup_s"] - sum(line["phases"].values()))
    assert 0.0 <= line["imports_s"] <= line["before_s"] <= line["rest_s"]
    assert line["updates_per_s"] > 0 and line["idle_gaps"] == [] == line["gap_spans"]
    assert all(v >= 0.0 for v in line["window_spans"].values())
    assert "setup.inputs" in line["bench_spans"]


def test_setup_split_without_the_recorder_reads_no_span():
    """``--record 0``: the same run with the recorder off records nothing."""
    tool = _setup_spans_tool()
    from perfbench.tests.small import SEED, small_cell

    torch.manual_seed(0)
    line = tool.measure(small_cell("rgg500k_p100.async"), SEED, 0.2, False, "cpu",
                        time.perf_counter(), record=False)
    assert line["spans"] == line["phases"] == line["window_spans"] == {}
    assert line["rest_s"] == line["setup_s"] and line["updates_per_s"] > 0

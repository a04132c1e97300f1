"""repro_torch.obs (device metrics and run reports) against repro.obs.

Held against ``tests/test_obs.py`` on the same inputs: the spec and its
coercion; the refusals of a metrics-off engine (the reference's
messages); forced-wake counters equal to the reference engine's, the
staleness histogram included; the churn departures of a deterministic
schedule; ``dp_budget_stopped`` against the accountant and the
reference's gauge slot by slot; metrics-on runs bit-exact in Theta with
metrics-off; ``run(metrics_every=)`` drains at the reference's slots; a
report file read by the other package both ways; and the report CLI.
Every counter is an integer count, so equal means equal.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.sim as jsim
from repro.core import AgentData, knn_graph, make_objective
from repro.core import DPConfig as JDPConfig
from repro_torch.convert import objective_from_reference
from repro_torch.core import DPConfig
from repro_torch.obs import MetricsAccumulator, MetricsSpec, RunReport, merge_bench_summary
from repro_torch.obs import report as report_cli
from repro_torch.obs import summarize_counters
from repro_torch.sim import AsyncEngine, CDUpdate, ChurnConfig, DPCDUpdate, EngineConfig
from repro_torch.sim import Scenario, StragglerConfig


def _quad_problem(n, p=4, m=3, seed=0, mu=0.5, clip=None):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    data = AgentData(X=X, y=y, mask=np.ones((n, m)))
    ref = make_objective(graph, data, "quadratic", mu=mu, mix_mode="sparse", clip=clip)
    return ref, objective_from_reference(ref)


def _host(counters):
    return {k: np.asarray(v).tolist() for k, v in counters.items()}


# -- spec / config plumbing --------------------------------------------------


def test_metrics_spec_coerce_matches_reference():
    assert MetricsSpec.coerce(None) is None
    assert MetricsSpec.coerce(False) is None
    assert MetricsSpec.coerce(True) == MetricsSpec()
    spec = MetricsSpec(staleness=False)
    assert MetricsSpec.coerce(spec) is spec
    with pytest.raises(TypeError):
        MetricsSpec.coerce("yes")
    with pytest.raises(ValueError, match="staleness_buckets"):
        MetricsSpec(staleness_buckets=0)
    assert EngineConfig(metrics=True, device="cpu").metrics_spec() == MetricsSpec()
    assert EngineConfig(device="cpu").metrics_spec() is None
    fields = [(f.name, f.default) for f in dataclasses.fields(MetricsSpec)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(jobs.MetricsSpec)]


def test_leaves_follow_the_engine_context():
    acc = MetricsAccumulator(MetricsSpec(), 10, churn=True, straggler=True, dp_limit=3)
    m = acc.init("cpu")
    want = {"wakes_realized", "wakes_capacity_dropped", "wakes_applied", "wakes_thinned",
            "churn_departures", "churn_rejoins", "dp_updates_applied", "dp_budget_stopped",
            "staleness_hist", "last_wake"}
    assert set(m) == want
    jm = jobs.MetricsAccumulator(jobs.MetricsSpec(), 10, churn=True, straggler=True,
                                 dp_limit=3).init()
    assert set(jm) == want
    assert acc.leaf_kinds()["last_wake"] == "per_agent"
    assert set(MetricsAccumulator(MetricsSpec(staleness=False, privacy=False), 10,
                                  dp_limit=3).init("cpu")) == {
        "wakes_realized", "wakes_capacity_dropped", "wakes_applied"}


def test_metrics_off_engine_refuses_snapshot_and_drain():
    ref, obj = _quad_problem(n=24)
    eng = AsyncEngine(CDUpdate(obj), seed=0, device="cpu")
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), seed=0)
    for e in (eng, jeng):
        state = e.init_state(np.zeros((24, 4)))
        with pytest.raises(ValueError, match="metrics collection is off") as off:
            e.metrics_snapshot(state)
        with pytest.raises(ValueError, match="metrics_every requires") as drain:
            e.run(np.zeros((24, 4)), slots=2, metrics_every=1)
        if e is eng:
            msgs = (str(off.value), str(drain.value))
    assert msgs == (str(off.value), str(drain.value))  # the reference's messages


# -- counters against the reference -----------------------------------------


@pytest.mark.parametrize("batch_size", [None, 8])
def test_forced_wake_counters_equal_reference(batch_size):
    """The same forced masks through both engines (float64): every counter
    and the staleness histogram equal the reference's; a batch of 8 rows
    overflows (about 12 forced wakes a slot), so capacity drops count too."""
    ref, obj = _quad_problem(n=40, seed=1)
    n, p = obj.n, obj.p
    kw = dict(slot_wakes=40.0, batch_size=batch_size, seed=0, metrics=True)
    eng = AsyncEngine(CDUpdate(obj), dtype=torch.float64, device="cpu", **kw)
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), dtype=jnp.float64, **kw)
    s, js = eng.init_state(np.zeros((n, p))), jeng.init_state(np.zeros((n, p)))
    rng = np.random.default_rng(7)
    for _ in range(12):
        mask = rng.random(n) < 0.3
        s, js = eng.step(s, mask), jeng.step(js, mask)
    counters, _ = eng.metrics_snapshot(s)
    jcounters, _ = jeng.metrics_snapshot(js)
    assert _host(counters) == _host(jcounters)
    assert int(counters["staleness_hist"].sum()) == int(s.applied) == int(js.applied)
    assert (int(counters["wakes_capacity_dropped"]) > 0) == (batch_size is not None)
    np.testing.assert_allclose(s.Theta.numpy(), np.asarray(js.Theta), rtol=1e-10, atol=1e-12)


def test_forced_wakes_bit_exact_metrics_on_vs_off():
    _, obj = _quad_problem(n=40, seed=1)
    n, p = obj.n, obj.p
    states = []
    for metrics in (None, True):
        eng = AsyncEngine(CDUpdate(obj), slot_wakes=40.0, seed=0, dtype=torch.float64,
                          metrics=metrics, device="cpu")
        s = eng.init_state(np.zeros((n, p)))
        rng = np.random.default_rng(7)
        for _ in range(8):
            s = eng.step(s, rng.random(n) < 0.3)
        states.append(s)
    assert torch.equal(states[0].Theta, states[1].Theta)
    assert states[0].metrics is None and states[1].metrics is not None


@pytest.mark.parametrize("fused", [False, True])
def test_sampled_advance_bit_exact_metrics_on_vs_off(fused):
    """Churn and stragglers on: the counters draw nothing, so Theta, the
    churn flags and the generator's position are the same with metrics on."""
    _, obj = _quad_problem(n=48, seed=3)
    scenario = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                        straggler=StragglerConfig(drop_prob=0.2))
    out = []
    for metrics in (None, True):
        eng = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=5, scenario=scenario,
                          metrics=metrics, fused=fused, device="cpu")
        out.append(eng.advance(eng.init_state(np.zeros((48, 4))), 9))
    assert torch.equal(out[0].Theta, out[1].Theta)
    assert torch.equal(out[0].active, out[1].active)
    assert torch.equal(out[0].generator.get_state(), out[1].generator.get_state())
    counters, _ = eng.metrics_snapshot(out[1])
    assert int(counters["wakes_applied"]) == int(out[1].applied)
    assert (int(counters["wakes_realized"]) - int(counters["wakes_thinned"])
            - int(counters["wakes_capacity_dropped"])) == int(out[1].applied)


def test_churn_departures_match_schedule_and_reference():
    """A deterministic departure schedule (leave_prob = 1 on agents 0..16,
    no rejoins): both engines count exactly those agents, once."""
    ref, obj = _quad_problem(n=40, seed=4)
    leavers = np.zeros(40)
    leavers[:17] = 1.0
    scenario = Scenario(churn=ChurnConfig(leave_prob=leavers, rejoin_prob=0.0))
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, scenario=scenario, metrics=True,
                      device="cpu")
    state = eng.advance(eng.init_state(np.zeros((40, 4))), 5)
    counters, _ = eng.metrics_snapshot(state)
    jscenario = jsim.Scenario(churn=jsim.ChurnConfig(leave_prob=leavers, rejoin_prob=0.0))
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, seed=0, scenario=jscenario,
                            metrics=True)
    jcounters, _ = jeng.metrics_snapshot(jeng.advance(jeng.init_state(np.zeros((40, 4))), 5))
    for key in ("churn_departures", "churn_rejoins"):
        assert int(counters[key]) == int(jcounters[key])
    assert int(counters["churn_departures"]) == 17 and int(counters["churn_rejoins"]) == 0
    assert int(state.active.sum()) == 40 - 17


@pytest.mark.parametrize("fused", [False, True])
def test_dp_budget_stopped_matches_accountant_and_reference(fused):
    """Forced all-wake slots: the gauge equals the accountant's count and
    the reference's gauge slot by slot, and the derived eps spend equals
    ``DPCDUpdate.eps_spent``."""
    ref, obj = _quad_problem(n=48, seed=3, clip=1.0)
    n, p, planned = obj.n, obj.p, 3
    dp = DPCDUpdate.plan(obj, DPConfig(eps_bar=1.0), planned_Ti=planned)
    jdp = jsim.DPCDUpdate.plan(ref, JDPConfig(eps_bar=1.0), planned_Ti=planned)
    eng = AsyncEngine(dp, slot_wakes=48.0, seed=0, metrics=True, fused=fused, device="cpu")
    jeng = jsim.AsyncEngine(jdp, slot_wakes=48.0, seed=0, metrics=True)
    s, js = eng.init_state(np.zeros((n, p))), jeng.init_state(np.zeros((n, p)))
    for k in range(planned + 2):
        s = eng.step(s, np.ones(n, bool))
        js = jeng.step(js, np.ones(n, bool))
        counters, derived = eng.metrics_snapshot(s)
        jcounters, jderived = jeng.metrics_snapshot(js)
        gauge = int(counters["dp_budget_stopped"])
        assert gauge == dp.budget_stopped(s.ustate) == int(jcounters["dp_budget_stopped"]), k
        assert int(counters["dp_updates_applied"]) == int(jcounters["dp_updates_applied"])
    assert gauge == n
    np.testing.assert_allclose(derived["dp_eps_spent_max"], dp.eps_spent(s.ustate).max())
    np.testing.assert_allclose(derived["dp_eps_spent_max"], jderived["dp_eps_spent_max"],
                               rtol=1e-12)


# -- run reports --------------------------------------------------------------


def test_run_metrics_every_drains_at_the_reference_slots():
    ref, obj = _quad_problem(n=40, seed=9)
    n, p = obj.n, obj.p
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, metrics=True, device="cpu")
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, seed=0, metrics=True)
    res = eng.run(np.zeros((n, p)), slots=14, metrics_every=4, record_every=6)
    jres = jeng.run(np.zeros((n, p)), slots=14, metrics_every=4, record_every=6)
    slots = [snap["slot"] for snap in res.report.snapshots]
    assert slots == [snap["slot"] for snap in jres.report.snapshots] == [4, 8, 12, 14]
    assert res.report.meta == {**jres.report.meta, "dtype": "float32"}
    assert res.report.meta["engine"] == "AsyncEngine"
    assert len(res.objective) == len(jres.objective) == 4  # start, slots 6, 12, 14
    applied = [s["counters"]["wakes_applied"] for s in res.report.snapshots]
    assert applied == sorted(applied) and applied[-1] == int(res.state.applied)
    assert set(res.report.snapshots[-1]["counters"]) == set(jres.report.snapshots[-1]["counters"])
    plain = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, device="cpu").run(
        np.zeros((n, p)), slots=14)
    np.testing.assert_array_equal(plain.Theta, res.Theta)  # drains do not perturb the run
    again = eng.run(None, 4, state=res.state, metrics_every=4, report=res.report)
    assert again.report is res.report and res.report.snapshots[-1]["slot"] == 18


def _sample_report(cls):
    report = cls(meta={"engine": "AsyncEngine", "n": 8})
    report.add_snapshot(2, {"wakes_applied": np.int64(5), "staleness_hist": np.array([3, 2])},
                        derived={"dp_eps_spent_max": np.float64(0.5)})
    report.add_phase_rows([("obs_phase_total", 12.5, "sum of phases")])
    return report


@pytest.mark.parametrize("writer,reader", [(RunReport, jobs.RunReport),
                                           (jobs.RunReport, RunReport)])
def test_report_jsonl_is_read_by_the_other_package(tmp_path, writer, reader):
    path = tmp_path / "report.jsonl"
    written = _sample_report(writer)
    written.to_jsonl(str(path))
    back = reader.from_jsonl(str(path))
    assert back.meta == written.meta
    assert back.snapshots == written.snapshots
    assert back.phase_rows == [("obs_phase_total", 12.5, "sum of phases")]
    assert back.summary_table() == written.summary_table()
    rows = dict((name, v) for name, v, _ in back.bench_rows())
    assert rows["obs_wakes_applied"] == 5.0 and rows["obs_phase_total"] == 12.5
    assert "obs_staleness_hist" not in rows


def test_summarize_counters_matches_reference():
    snap = {"wakes_applied": np.int64(7), "staleness_hist": np.array([[1, 2], [3, 4]]),
            "exchange_bytes": np.array([1.5, 2.0], dtype=np.float32)}
    assert summarize_counters(snap) == jobs.summarize_counters(snap)


def test_report_cli_renders_and_merges(tmp_path, capsys, monkeypatch):
    report = RunReport(meta={"engine": "AsyncEngine"})
    report.add_snapshot(1, {"wakes_applied": np.int64(3)})
    rpath = tmp_path / "r.jsonl"
    report.to_jsonl(str(rpath))
    bench = tmp_path / "BENCH_torch_summary.json"
    merge_bench_summary(str(bench), [("existing_row", 1.0, "kept")])
    assert report_cli.main([str(rpath), "--merge-bench", str(bench)]) == 0
    out = capsys.readouterr().out
    assert "wakes_applied" in out and "merged 1 obs rows" in out
    merged = json.loads(bench.read_text())
    assert merged["obs_wakes_applied"]["us_per_call"] == 3.0
    assert merged["existing_row"]["us_per_call"] == 1.0  # merge, not clobber

    default = tmp_path / "results" / "default.json"
    monkeypatch.setattr(report_cli, "SUMMARY", default)
    assert report_cli.main([str(rpath), "--merge-bench"]) == 0
    assert json.loads(default.read_text())["obs_wakes_applied"]["derived"] == "through slot 1"
    with pytest.raises(SystemExit):
        report_cli.main([])  # nothing to do
    with pytest.raises(SystemExit):
        report_cli.main([str(rpath), "--validate-trace", "t.json"])
    assert "A10b" in capsys.readouterr().err

"""repro_torch.sim.ShardedAsyncEngine (S shards stacked on one device)
against the reference's engines.

The reference's sharded engine runs one shard per device; in this
process JAX sees one CPU device, so the reference's ``num_shards=1``
engine is the in-process yardstick, and for S > 1 the yardstick is the
reference's single-device ``AsyncEngine``, to which the reference holds
its own sharded engine bit for bit (``tests/test_sharded_engine.py``).
Random streams differ between the packages, so parity goes through
forced wake sets; sampled runs are held to fixed points.

Tolerances: float64 forced wakes 1e-10 and counters exact; the fused /
unfused matrix at S = 4 in float32 1e-6 (the reference's bound), a
compressed wire 0 < error < 5e-2 against the single-device engine; fixed
points 1e-5 of ``solve_exact`` and a further ``advance`` of the optimum
below 1e-9; the bf16 + error-feedback fixed point within the reference
test's bounds. Metrics-on runs equal metrics-off ones bit for bit.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as jsim
from repro.core import AgentData, DPConfig as JDPConfig, erdos_renyi_graph, knn_graph
from repro.core import make_objective, run_private
from repro.sim.engine import ShardedAsyncEngine as RefShardedEngine
from repro_torch.convert import (
    dp_update_from_reference,
    objective_from_reference,
    sharded_sim_state_from_numpy,
)
from repro_torch.obs import ExchangeVolume
from repro_torch.sim import (
    AsyncEngine,
    CDUpdate,
    ChurnConfig,
    DelayConfig,
    EngineConfig,
    ExchangeSpec,
    GraphUpdate,
    PropagationUpdate,
    Scenario,
    ShardedAsyncEngine,
    StragglerConfig,
)
from repro_torch.sim.capture import ChunkGraphs

TOL64 = 1e-10
F64 = dict(dtype=torch.float64, device="cpu")


def _quad(n, p=4, m=3, seed=0):
    """(reference objective, port objective): the reference tests' problem."""
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse")
    return ref, objective_from_reference(ref)


def _forced(engine, Theta0, masks):
    state = engine.init_state(Theta0)
    for mask in masks:
        state = engine.step(state, mask)
    return state


def _ref_theta(engine, state):
    if isinstance(engine, RefShardedEngine):
        return engine.global_theta(state)
    return np.asarray(state.Theta)


@pytest.fixture(scope="module")
def quad64():
    return _quad(64, seed=1)


# -- forced-wake parity ----------------------------------------------------


@pytest.mark.parametrize("relabel", [None, "rcm", "shuffle"])
def test_single_shard_matches_reference_sharded_engine(relabel):
    ref, port = _quad(40, seed=1)
    rl = np.random.default_rng(8).permutation(40) if relabel == "shuffle" else relabel
    masks = [m for m in (np.random.default_rng(7).random((10, 40)) < 0.25)]
    Theta0 = np.random.default_rng(2).normal(size=(40, 4))
    jeng = jsim.ShardedAsyncEngine(jsim.CDUpdate(ref), num_shards=1, relabel=rl,
                                   slot_wakes=8.0, seed=0, dtype=jnp.float64)
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=1, relabel=rl, slot_wakes=8.0, seed=0,
                             **F64)
    js, ts = _forced(jeng, Theta0, masks), _forced(eng, Theta0, masks)
    np.testing.assert_allclose(eng.global_theta(ts), jeng.global_theta(js), rtol=TOL64,
                               atol=TOL64)
    np.testing.assert_array_equal(eng.part.order, jeng.part.order)
    assert eng.batch_size == jeng.batch_size
    assert float(ts.messages.sum()) == float(np.asarray(js.messages).sum())
    assert int(ts.applied.sum()) == int(np.asarray(js.applied).sum())
    assert int(ts.dropped.sum()) == int(np.asarray(js.dropped).sum())


MATRIX = [
    dict(partition_mode="contiguous"),
    dict(partition_mode="degree"),
    dict(partition_mode="degree", exchange=ExchangeSpec(method="p2p")),
    dict(partition_mode="degree", relabel="rcm", exchange=ExchangeSpec(method="all_gather")),
    dict(partition_mode="degree", relabel="rcm", exchange=ExchangeSpec(method="p2p")),
    dict(partition_mode="contiguous", relabel="rcm", exchange=ExchangeSpec()),
]


@pytest.mark.parametrize("kw", MATRIX, ids=[str(i) for i in range(len(MATRIX))])
def test_four_shards_match_reference_single_device_f64(quad64, kw):
    ref, port = quad64
    masks = list(np.random.default_rng(5).random((12, 64)) < 0.3)
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, seed=0, dtype=jnp.float64)
    js = _forced(jeng, np.zeros((64, 4)), masks)
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=4, slot_wakes=8.0, seed=0, **F64, **kw)
    ts = _forced(eng, np.zeros((64, 4)), masks)
    np.testing.assert_allclose(eng.global_theta(ts), np.asarray(js.Theta), rtol=TOL64,
                               atol=TOL64)
    assert float(ts.messages.sum()) == float(js.messages)
    assert int(ts.applied.sum()) == int(js.applied)
    # Against the port's single-device engine as well.
    single = _forced(AsyncEngine(CDUpdate(port), slot_wakes=8.0, seed=0, **F64),
                     np.zeros((64, 4)), masks)
    np.testing.assert_allclose(eng.global_theta(ts), single.Theta.numpy(), rtol=TOL64,
                               atol=TOL64)


def test_propagation_update_sharded_matches_reference(quad64):
    ref, port = quad64
    rng = np.random.default_rng(3)
    loc, conf = rng.normal(size=(64, 4)), rng.uniform(0.5, 1.0, size=64)
    masks = list(rng.random((8, 64)) < 0.4)
    jeng = jsim.AsyncEngine(jsim.PropagationUpdate(ref.graph, loc, 0.7, conf), slot_wakes=8.0,
                            dtype=jnp.float64)
    eng = ShardedAsyncEngine(PropagationUpdate(port.graph, loc, 0.7, conf), num_shards=3,
                             relabel="rcm", slot_wakes=8.0, **F64)
    np.testing.assert_allclose(eng.global_theta(_forced(eng, loc, masks)),
                               np.asarray(_forced(jeng, loc, masks).Theta), rtol=TOL64,
                               atol=TOL64)


def test_dp_budget_stop_under_rcm_and_p2p_matches_run_private():
    rngd = np.random.default_rng(0)
    gd = erdos_renyi_graph(12, 0.5, rngd)
    td = rngd.normal(size=(12, 3))
    Xd = rngd.normal(size=(12, 4, 3))
    yd = np.sign(np.einsum("nmp,np->nm", Xd, td))
    objd = make_objective(gd, AgentData(X=Xd, y=yd, mask=np.ones((12, 4))), "logistic", mu=0.3)
    planned = 3
    cfg = JDPConfig(eps_bar=0.8)
    wake = np.concatenate([np.tile(np.arange(12), planned), np.arange(11)])
    seq = run_private(objd, np.zeros((12, 3)), T=len(wake), cfg=cfg,
                      rng=np.random.default_rng(0), wake_sequence=wake, record_objective=False)
    upd = dp_update_from_reference(jsim.DPCDUpdate.plan(objd, cfg, planned_Ti=planned))
    eng = ShardedAsyncEngine(upd, num_shards=4, slot_wakes=12.0, seed=0, relabel="rcm",
                             exchange=ExchangeSpec(method="p2p"), device="cpu", metrics=True)
    st = eng.init_state(np.zeros((12, 3)))
    for _ in range(5):
        st = eng.step(st, np.ones(12, bool))
    counts = eng.part.unpad_rows(st.ustate.numpy())
    np.testing.assert_array_equal(counts, np.full(12, planned))
    np.testing.assert_allclose(upd.eps_spent(counts), seq.eps_spent, rtol=1e-10)
    frozen, msgs = eng.global_theta(st), float(st.messages.sum())
    st = eng.step(st, np.ones(12, bool))
    np.testing.assert_array_equal(eng.global_theta(st), frozen)
    assert float(st.messages.sum()) == msgs
    counters, derived = eng.metrics_snapshot(st)
    assert int(counters["dp_budget_stopped"].sum()) == upd.budget_stopped(counts) == 12
    assert int(counters["dp_updates_applied"].sum()) == 12 * planned
    np.testing.assert_allclose(derived["dp_eps_spent_max"], seq.eps_spent.max(), rtol=1e-10)
    assert eng.run(np.zeros((12, 3)), slots=2, state=st).update_state.shape == (12,)


# -- fixed points ------------------------------------------------------------


@pytest.fixture(scope="module")
def quad512():
    return _quad(512, seed=0)


@pytest.mark.parametrize("S,kw", [
    (2, {}),
    (4, dict(relabel="rcm", exchange=ExchangeSpec(method="p2p"))),
    (8, dict(relabel="rcm", exchange=ExchangeSpec())),
])
def test_fixed_point_512_agents(quad512, S, kw):
    _, port = quad512
    star = port.solve_exact()
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=S, slot_wakes=128.0, seed=3, **F64,
                             **kw)
    res = eng.run(np.zeros((512, 4)), slots=700)
    assert np.abs(res.Theta - star).max() < 1e-5, (S, eng.exchange_method)
    assert res.slots == 700 and res.wakes_applied > 0
    st = eng.advance(eng.init_state(star), 5)
    assert np.abs(eng.global_theta(st) - star).max() < 1e-9


# -- fused path and compressed wires -----------------------------------------


@pytest.fixture(scope="module")
def quad96():
    return _quad(96, seed=0)


WIRES = ["all_gather", "p2p", "all_gather:bf16", "p2p:bf16", "p2p:bf16:ef", "p2p:int8:ef"]


@pytest.mark.parametrize("wire", WIRES)
def test_fused_matrix_at_four_shards(quad96, wire):
    ref, port = quad96
    masks = list(np.random.default_rng(7).random((4, 96)) < 0.15)
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, fused=False)
    single = _ref_theta(jeng, _forced(jeng, np.zeros((96, 4)), masks))
    spec = ExchangeSpec.from_string(wire)
    outs = {}
    for fused in (False, True):
        eng = ShardedAsyncEngine(CDUpdate(port), num_shards=4, relabel="rcm", exchange=spec,
                                 slot_wakes=8.0, fused=fused, device="cpu")
        assert eng.fused is fused
        outs[fused] = eng.global_theta(_forced(eng, np.zeros((96, 4)), masks))
    assert np.abs(outs[True] - outs[False]).max() < 1e-6
    if spec.dtype == "f32":
        assert np.abs(outs[True] - single).max() < 1e-6
    else:
        assert 0 < np.abs(outs[False] - single).max() < 5e-2


def test_bf16_error_feedback_fixed_point():
    """The reference test's bounds at n = 256, S = 4: error feedback brings
    the bf16 wire to the f32 fixed point where plain bf16 stalls."""
    _, port = _quad(256, seed=0)
    star = port.solve_exact()

    def err(wire):
        eng = ShardedAsyncEngine(CDUpdate(port), num_shards=4, relabel="rcm",
                                 exchange=ExchangeSpec.from_string(wire), slot_wakes=64.0,
                                 seed=7, device="cpu")
        return float(np.abs(eng.run(np.zeros((256, 4)), slots=1000).Theta - star).max())

    e32, ebf, eef = err("p2p"), err("p2p:bf16"), err("p2p:bf16:ef")
    assert e32 < 2e-5, e32
    assert eef <= 1e-4, eef
    assert ebf > 1e-4, ebf
    assert eef < ebf / 1.5, (eef, ebf)


# -- metrics -------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["all_gather", "p2p", "p2p:int8:ef", "all_gather:bf16"])
def test_exchange_counters_are_volume_times_slots(quad96, wire):
    ref, port = quad96
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=4, relabel="rcm", slot_wakes=16.0,
                             seed=1, exchange=ExchangeSpec.from_string(wire), metrics=True,
                             device="cpu")
    vol = eng._exchange_volume()
    # The reference's volume for the same partition and plan.
    jpart = jsim.partition_graph(ref.graph, 4, relabel="rcm")
    jspec = jsim.ExchangeSpec.from_string(wire)
    jsmix = __import__("repro.core.mixing", fromlist=["x"]).sharded_mix_op(jpart, exchange=jspec)
    jvol = RefShardedEngine._exchange_volume(types.SimpleNamespace(
        part=jpart, num_shards=4, exchange_spec=jspec, p=4, smix=jsmix))
    for key in ("border_rows", "rows_shipped", "bytes_shipped", "p2p_rows", "p2p_bytes"):
        a, b = getattr(vol, key), getattr(jvol, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a, b)
    slots = 7
    state = eng.advance(eng.init_state(np.zeros((96, 4))), slots)
    counters, _ = eng.metrics_snapshot(state)
    np.testing.assert_array_equal(counters["exchange_rows"], vol.rows_shipped * slots)
    np.testing.assert_array_equal(counters["exchange_bytes"], vol.bytes_shipped * slots)
    np.testing.assert_array_equal(counters["border_rows_published"], vol.border_rows * slots)
    if vol.p2p_rows is not None:
        np.testing.assert_array_equal(counters["p2p_rows_by_offset"], vol.p2p_rows * slots)
        np.testing.assert_array_equal(counters["p2p_bytes_by_offset"], vol.p2p_bytes * slots)
    assert int(counters["wakes_applied"].sum()) == int(state.applied.sum())
    if ":" in wire:
        q = counters["quant_err_sq"]
        assert np.isfinite(q).all() and (q > 0).all()
        assert ("ef_residual_sq" in counters) and ((counters["ef_residual_sq"] > 0).all()
                                                   == wire.endswith("ef"))
    else:
        assert "quant_err_sq" not in counters
    assert isinstance(vol, ExchangeVolume)


def test_forced_counters_equal_reference_single_device(quad64):
    ref, port = quad64
    masks = list(np.random.default_rng(9).random((10, 64)) < 0.4)
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=40.0, batch_size=64, seed=0,
                            metrics=True, dtype=jnp.float64)
    jcounters, _ = jeng.metrics_snapshot(_forced(jeng, np.zeros((64, 4)), masks))
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=4, relabel="rcm", slot_wakes=40.0,
                             metrics=True, **F64)
    counters, _ = eng.metrics_snapshot(_forced(eng, np.zeros((64, 4)), masks))
    for key in ("wakes_realized", "wakes_applied", "wakes_capacity_dropped"):
        assert int(counters[key].sum()) == int(jcounters[key]), key
    np.testing.assert_array_equal(counters["staleness_hist"].sum(axis=0),
                                  np.asarray(jcounters["staleness_hist"]))


@pytest.mark.parametrize("fused", [False, True])
def test_metrics_on_equals_off_bit_for_bit(quad96, fused):
    _, port = quad96
    scenario = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                        straggler=StragglerConfig(drop_prob=0.2))
    out = []
    for metrics in (None, True):
        eng = ShardedAsyncEngine(CDUpdate(port), num_shards=4, relabel="rcm", slot_wakes=16.0,
                                 seed=5, scenario=scenario, metrics=metrics, fused=fused,
                                 exchange=ExchangeSpec.from_string("p2p:bf16:ef"), device="cpu")
        st = eng.advance(eng.init_state(np.zeros((96, 4))), 9)
        out.append((st, eng))
    (a, _), (b, eng) = out
    for key in ("Theta", "active", "applied", "dropped", "messages", "ptr", "ef", "slab"):
        assert torch.equal(getattr(a, key), getattr(b, key)), key
    assert a.metrics is None
    counters, _ = eng.metrics_snapshot(b)
    assert int(counters["churn_departures"].sum()) > 0 and counters["wakes_thinned"].sum() > 0


# -- state, driver and refusals -------------------------------------------------


def test_state_carries_across_from_reference():
    """A reference state (S = 1, metrics on, after forced slots) carried
    across with sharded_sim_state_from_numpy continues as the reference's."""
    ref, port = _quad(40, seed=4)
    masks = list(np.random.default_rng(1).random((8, 40)) < 0.3)
    jeng = jsim.ShardedAsyncEngine(jsim.CDUpdate(ref), num_shards=1, relabel="rcm",
                                   slot_wakes=8.0, metrics=True, dtype=jnp.float64)
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=1, relabel="rcm", slot_wakes=8.0,
                             metrics=True, **F64)
    js = _forced(jeng, np.random.default_rng(2).normal(size=(40, 4)), masks[:4])
    ts = sharded_sim_state_from_numpy(
        np.asarray(js.Theta), np.asarray(js.active), np.asarray(js.applied),
        np.asarray(js.dropped), np.asarray(js.messages), np.asarray(js.ptr),
        halo_width=eng.smix.halo_width, device="cpu", dtype=torch.float64,
        metrics={k: np.asarray(v) for k, v in js.metrics.items()})
    for mask in masks[4:]:
        js, ts = jeng.step(js, mask), eng.step(ts, mask)
    np.testing.assert_allclose(eng.global_theta(ts), jeng.global_theta(js), rtol=TOL64,
                               atol=TOL64)
    counters, _ = eng.metrics_snapshot(ts)
    jcounters, _ = jeng.metrics_snapshot(js)
    for key, value in jcounters.items():
        np.testing.assert_array_equal(counters[key], np.asarray(value), err_msg=key)
    assert int(ts.ptr[0]) == int(np.asarray(js.ptr)[0]) == 8


def test_foreign_state_binds_into_live_buffers(quad96):
    """ChunkGraphs.bind copies every field of a sharded state, ``ef`` and
    the slab included, into the live buffers (run here eagerly)."""
    _, port = quad96
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=4, relabel="rcm", slot_wakes=16.0,
                             exchange=ExchangeSpec.from_string("p2p:bf16:ef"), metrics=True,
                             seed=2, device="cpu")
    Theta0 = np.random.default_rng(3).normal(size=(96, 4))
    want = eng._eager_slots(eng._eager_slots(eng.init_state(Theta0), 3), 4)
    graphs = ChunkGraphs(eng)
    live = graphs.bind(eng._eager_slots(eng.init_state(np.zeros((96, 4))), 2))
    foreign = eng._eager_slots(eng.init_state(Theta0), 3)
    got = eng._eager_slots(graphs.bind(foreign), 4)
    assert got.slab is live.slab and got.ef is live.ef
    for key in ("Theta", "slab", "ef", "applied", "messages", "ptr", "active"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    for key, leaf in want.metrics.items():
        assert torch.equal(got.metrics[key], leaf), key


def test_run_records_and_reports(quad96):
    ref, port = quad96
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=3, slot_wakes=16.0, seed=0,
                             metrics=True, steps_per_chunk=4, device="cpu")
    res = eng.run(np.zeros((96, 4)), slots=12, record_every=4, metrics_every=6)
    assert res.objective.shape == (4,) and res.objective[-1] < res.objective[0]
    assert res.slots == 12 and res.report is not None and len(res.report.snapshots) == 2
    meta = eng.report_meta()
    assert meta["engine"] == "ShardedAsyncEngine" and meta["num_shards"] == 3
    jmeta_keys = {"engine", "update", "n", "p", "num_shards", "slot_wakes", "batch_size",
                  "fused", "dtype", "exchange_method", "exchange_dtype", "error_feedback"}
    assert set(meta) == jmeta_keys
    assert eng.topology_counters() == {k: (0.0 if k == "last_drift" else 0) for k in
                                       eng.topology_counters()}
    a = eng.run(np.zeros((96, 4)), slots=5).Theta
    b = ShardedAsyncEngine(CDUpdate(port), num_shards=3, slot_wakes=16.0, seed=0,
                           device="cpu").run(np.zeros((96, 4)), slots=5).Theta
    np.testing.assert_array_equal(a, b)  # seeded: the same stream
    blank = eng._blank_state()
    assert blank.Theta.shape == (3, eng.rows_per_shard, 4) and not blank.active.any()


def test_default_batch_follows_owned_agents_under_relabel():
    from repro_torch.sim import default_batch_size

    _, port = _quad(60, seed=6)
    rates = np.where(np.arange(60) % 3 == 0, 25.0, 0.04)
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=3, relabel="rcm", rates=rates,
                             slot_wakes=16.0, device="cpu")
    part = eng.part
    for s in range(3):
        need = default_batch_size(rates[part.owned[s, : int(part.sizes[s])]], eng.tau)
        assert eng.batch_size >= min(need, part.rows_per_shard)


def test_refusals_name_their_items(quad96):
    _, port = quad96
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=2, device="cpu")
    st = eng.init_state(np.zeros((96, 4)))
    # Dynamic topology (A11) is live; a static engine refuses its swaps.
    for call, match in ((lambda: eng.set_topology(st, port.graph), "static-topology"),
                        (lambda: eng.admit(st, [0]), "no arrival"),
                        (lambda: eng._refresh_topology(st, 0), "no graph_update")):
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(NotImplementedError, match="A10b"):
        eng.phase_program("fused_row_update")
    with pytest.raises(NotImplementedError, match="delay"):
        ShardedAsyncEngine(CDUpdate(port), num_shards=2, device="cpu",
                           scenario=Scenario(delay=DelayConfig(max_delay=1)))
    with pytest.raises(ValueError, match="fused=True is static-topology only"):
        ShardedAsyncEngine(CDUpdate(port), num_shards=2, device="cpu", fused=True,
                           graph_update=GraphUpdate(every=2))
    with pytest.raises(ValueError, match="prebuilt partition"):
        ShardedAsyncEngine(CDUpdate(port), num_shards=3, partition=eng.part, device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        ShardedAsyncEngine(CDUpdate(port), num_shards=2, batch_size=97, device="cpu")
    with pytest.raises(ValueError, match="must name"):
        EngineConfig(device="cpu", devices=["cuda:0"]) if torch.cuda.is_available() else \
            EngineConfig(device="cpu", devices=["meta"])
    with pytest.raises(ValueError, match="fused=True"):
        ShardedAsyncEngine(CDUpdate(port), num_shards=2, fused=True, **F64)

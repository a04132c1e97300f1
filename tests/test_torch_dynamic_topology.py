"""Dynamic topology on the port against ``repro``: ``TopologyState``, the
Dada edge refresh (``GraphUpdate``), arrivals (``ArrivalConfig``) and both
engines' ``set_topology``/``_refresh_topology``/``admit``.

Host-side pieces (the slot form's builders, the refresh, the arrival
schedule) are numpy in both packages and must give equal arrays; the
torch edge mutators must give the reference's slots on the same batches.
The engines run in float64 under forced wake sets with explicit refreshes
and admissions and agree with the reference to 1e-10 (sums in another
order); the sharded engine at S = 4 agrees with the single-device dynamic
engine exactly before a refresh and to 1e-12 after it, as in the
reference's multi-device script.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as jsim
from repro.core import AgentData, knn_graph, make_objective
from repro.core.graph import TopologyState as JTopologyState
from repro_torch.convert import objective_from_reference, topology_state_from_numpy
from repro_torch.core.graph import TopologyState, as_csr, csr_from_coo
from repro_torch.sim import (
    ArrivalConfig,
    AsyncEngine,
    CDUpdate,
    ChurnConfig,
    DelayConfig,
    DPCDUpdate,
    EngineConfig,
    GraphUpdate,
    PropagationUpdate,
    Scenario,
    ShardedAsyncEngine,
    partition_graph,
)
from repro_torch.sim import capture, updates

TOL64 = 1e-10
F64 = dict(dtype=torch.float64, device="cpu")


def _quad(n, p=3, m=3, seed=0, mu=0.5, k=6, targets=None):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 6)), k=k)
    if targets is None:
        targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic", mu=mu,
                         mix_mode="sparse")
    return ref, objective_from_reference(ref)


def _csr_equal(a, b, data_tol=0.0):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    if data_tol:
        np.testing.assert_allclose(a.data, b.data, rtol=data_tol, atol=data_tol)
    else:
        np.testing.assert_array_equal(a.data, b.data)


@pytest.fixture(scope="module")
def quad24():
    return _quad(24, seed=1)


# -- TopologyState -----------------------------------------------------------


@pytest.mark.parametrize("slack,capacity", [(0, None), (4, None), (0, 16)])
def test_topology_state_from_csr_matches_reference(quad24, slack, capacity):
    ref, port = quad24
    jt = JTopologyState.from_csr(ref.graph, capacity=capacity, slack=slack, version=3)
    tt = TopologyState.from_csr(as_csr(port.graph), capacity=capacity, slack=slack, version=3)
    for name in ("nbr", "w", "valid", "version"):
        a, b = np.asarray(getattr(jt, name)), np.asarray(getattr(tt, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    _csr_equal(tt.to_csr(), jt.to_csr())
    np.testing.assert_array_equal(tt.degrees(), np.asarray(jt.degrees()))
    np.testing.assert_array_equal(tt.neighbor_counts(), np.asarray(jt.neighbor_counts()))
    csr = as_csr(port.graph)
    with pytest.raises(ValueError, match="capacity"):
        TopologyState.from_csr(csr, capacity=csr.max_degree() - 1)


def _mutation_batches(csr, seed):
    """(rows, cols, vals) batches over live edges and over non-edges, no
    row repeated within a batch (both directions counted)."""
    rng = np.random.default_rng(seed)
    rows = csr.row_ids()
    live = [(int(i), int(j)) for i, j in zip(rows, csr.indices) if i < j]
    edges = {(int(i), int(j)) for i, j in zip(rows, csr.indices)}
    rng.shuffle(live)
    used, pick = set(), []
    for i, j in live:
        if i not in used and j not in used:
            pick.append((i, j))
            used.update((i, j))
        if len(pick) == 3:
            break
    new, used2 = [], set()
    for i in rng.permutation(csr.n):
        for j in rng.permutation(csr.n):
            i, j = int(i), int(j)
            if i != j and (i, j) not in edges and not {i, j} & used2:
                new.append((i, j))
                used2.update((i, j))
                break
        if len(new) == 3:
            break
    return pick, new


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_mutators_match_reference(quad24, seed):
    """with_edge_weights, deactivate_edges and activate_edges (torch) give
    the reference's slots on the same batches: reweight and drop live
    edges, re-activate a freed slot, claim free slots for new edges, and
    drop an activation with no free slot."""
    ref, port = quad24
    csr = as_csr(port.graph)
    live, new = _mutation_batches(csr, seed)
    jt = JTopologyState.from_csr(ref.graph, slack=2)
    tt = TopologyState.from_csr(csr, slack=2)
    lr, lc = np.array([e[0] for e in live]), np.array([e[1] for e in live])
    nr, nc = np.array([e[0] for e in new]), np.array([e[1] for e in new])
    steps = [
        ("with_edge_weights", (lr, lc, np.array([2.5, 0.5, 1.25]))),
        ("with_edge_weights", (nr, nc, np.array([9.0, 9.0, 9.0]))),  # not edges: ignored
        ("deactivate_edges", (lr[:2], lc[:2])),
        ("activate_edges", (lr[:1], lc[:1], np.array([0.75]))),  # reuses the freed slot
        ("activate_edges", (nr, nc, np.array([0.3, 0.6, 0.9]))),  # free slots
        ("activate_edges", (nr[:1], nc[:1], np.array([0.4]))),  # reweights in place
    ]
    for name, args in steps:
        jt = getattr(jt, name)(*args)
        tt = getattr(tt, name)(*args)
        for leaf in ("nbr", "w", "valid", "version"):
            a = np.asarray(getattr(jt, leaf))
            b = getattr(tt, leaf).numpy()
            np.testing.assert_array_equal(a, b, err_msg=f"{name}: {leaf}")
    assert int(tt.version) == len(steps)
    _csr_equal(tt.to_csr(), jt.to_csr())
    # A row with no free slot drops its direction of the activation
    # (capacity growth is host work), as the reference's does.
    i = int(np.argmax(np.diff(csr.indptr)))
    j = next(j for j in range(csr.n) if j != i and j not in set(csr.neighbors(i).tolist()))
    full = TopologyState.from_csr(csr).activate_edges([i], [j], [1.0])
    jfull = JTopologyState.from_csr(ref.graph).activate_edges(
        jnp.asarray([i]), jnp.asarray([j]), jnp.asarray([1.0]))
    assert not bool(((full.nbr[i] == j) & full.valid[i]).any())
    for leaf in ("nbr", "w", "valid"):
        np.testing.assert_array_equal(getattr(full, leaf).numpy(), np.asarray(getattr(jfull, leaf)))


def test_apply_edge_updates_grows_capacity_in_multiples_of_8():
    ref, port = _quad(20, seed=2, k=4)
    topo = TopologyState.from_csr(as_csr(port.graph))
    jtopo = JTopologyState.from_csr(ref.graph)
    others = np.arange(1, 20)
    kw = dict(add_rows=np.zeros_like(others), add_cols=others, add_vals=np.ones(19))
    grown, jgrown = topo.apply_edge_updates(**kw), jtopo.apply_edge_updates(**kw)
    assert grown.capacity >= 19 and grown.capacity % 8 == 0 and grown.capacity >= topo.capacity
    assert int(grown.version) == 1
    for leaf in ("nbr", "w", "valid", "version"):
        np.testing.assert_array_equal(np.asarray(getattr(grown, leaf)),
                                      np.asarray(getattr(jgrown, leaf)))
    nb, _ = grown.to_csr().row(0)
    assert set(nb) == set(range(1, 20))
    # Removing the edges again keeps the grown capacity (it never shrinks).
    shrunk = grown.apply_edge_updates(remove_rows=np.zeros_like(others), remove_cols=others)
    assert shrunk.capacity == grown.capacity and int(shrunk.version) == 2


def test_topology_state_from_numpy_round_trips(quad24):
    ref, _ = quad24
    jt = JTopologyState.from_csr(ref.graph, slack=3, version=5)
    jt = jt.deactivate_edges(jnp.asarray([0]), jnp.asarray([int(ref.graph.neighbors(0)[0])]))
    tt = topology_state_from_numpy(jt.nbr, jt.w, jt.valid, jt.version, device="cpu")
    assert isinstance(tt.nbr, torch.Tensor) and tt.nbr.dtype == torch.int32
    assert tt.w.dtype == torch.float64 and tt.valid.dtype == torch.bool
    assert int(tt.version) == 6 and tt.capacity == jt.capacity
    for leaf in ("nbr", "w", "valid"):
        np.testing.assert_array_equal(getattr(tt, leaf).numpy(), np.asarray(getattr(jt, leaf)))
    _csr_equal(tt.to_csr(), jt.to_csr())
    with pytest.raises(ValueError, match="shape"):
        topology_state_from_numpy(np.zeros((3, 2), np.int32), np.zeros((3, 3)),
                                  np.zeros((3, 2), bool), 0, device="cpu")


# -- GraphUpdate -------------------------------------------------------------


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_refresh_matches_reference_array_for_array(monkeypatch, blocked, masked):
    """Several rounds from the same graph and models give the reference's
    CSR arrays exactly, with and without an ``allowed`` mask, and with the
    distance pass cut into blocks of 7 pairs."""
    if blocked:
        monkeypatch.setattr(updates, "D2_BLOCK_PAIRS", 7)
        monkeypatch.setattr(updates.pair_sq_dists, "__defaults__", (7,))
    ref, port = _quad(40, seed=4)
    jcsr, tcsr = ref.graph, as_csr(port.graph)
    rng = np.random.default_rng(0)
    allowed = None
    if masked:
        allowed = np.ones(40, bool)
        allowed[[4, 11, 27]] = False
    jgu = jsim.GraphUpdate(every=5, k=5, candidates=6, gamma=2.0, seed=9)
    tgu = GraphUpdate(every=5, k=5, candidates=6, gamma=2.0, seed=9)
    for r in range(4):
        Theta = rng.normal(size=(40, 3))
        jcsr = jgu.refresh(jcsr, Theta, round_index=r, allowed=allowed)
        tcsr = tgu.refresh(tcsr, torch.as_tensor(Theta) if r % 2 else Theta, round_index=r,
                           allowed=allowed)
        _csr_equal(tcsr, jcsr)


@pytest.mark.parametrize("p", [3, 8, 100])
@pytest.mark.parametrize("block", [1, 5, 64])
def test_blocked_distances_equal_the_one_pass_expression(p, block):
    rng = np.random.default_rng(p + block)
    Theta = rng.normal(size=(50, p))
    rows, cols = rng.integers(0, 50, size=300), rng.integers(0, 50, size=300)
    one_pass = ((Theta[rows] - Theta[cols]) ** 2).sum(axis=1)
    np.testing.assert_array_equal(updates.pair_sq_dists(Theta, rows, cols, block=block), one_pass)


def test_graph_update_validates_like_the_reference():
    for bad in (dict(every=0), dict(k=0), dict(candidates=-1), dict(gamma=0.0)):
        with pytest.raises(ValueError):
            GraphUpdate(**bad)
        with pytest.raises(ValueError):
            jsim.GraphUpdate(**bad)


def test_edge_delta_matches_reference():
    """The engines' edge churn count equals the reference's, on refreshed
    graphs (sorted unique keys: the fast path) and on a CSR that repeats
    an entry (the general path)."""
    from repro.sim.engine import _edge_delta as jdelta

    from repro_torch.core.graph import CSRGraph
    from repro_torch.sim.engine import _edge_delta

    ref, port = _quad(40, seed=4)
    a = as_csr(port.graph)
    b = GraphUpdate(every=1, k=4, candidates=6, gamma=2.0).refresh(
        a, np.random.default_rng(0).normal(size=(40, 3)), round_index=1)
    assert _edge_delta(a, b) == jdelta(a, b) and _edge_delta(b, a) == jdelta(b, a)
    assert _edge_delta(a, b) != (0, 0) and _edge_delta(a, a) == (0, 0)
    dup = CSRGraph(indptr=np.array([0, 2, 4, 4]), indices=np.array([1, 1, 0, 0], np.int32),
                   data=np.ones(4))
    one = csr_from_coo(3, [0, 1], [2, 2], [1.0, 1.0], symmetrize=True)
    assert _edge_delta(dup, one) == jdelta(dup, one) and _edge_delta(one, dup) == jdelta(one, dup)


# -- ArrivalConfig -----------------------------------------------------------


def test_arrival_config_matches_reference():
    sched = ((5, (18, 19)), (2, (3,)), (5, (7,)))
    kw = dict(schedule=sched, attach_k=3, seed=4, attach={7: (1, 2)})
    ja, ta = jsim.ArrivalConfig(**kw), ArrivalConfig(**kw)
    assert ta.all_ids() == ja.all_ids() and ta.by_slot() == ja.by_slot()
    established = np.arange(30)
    for agent in (18, 19, 3, 7):
        a = ja.neighbors_for(agent, established, np.random.default_rng((4, 11)))
        b = ta.neighbors_for(agent, established, np.random.default_rng((4, 11)))
        np.testing.assert_array_equal(a, b)
    for bad, match in ((dict(schedule=((0, (1,)),)), "1-based"),
                       (dict(schedule=((1, (1,)), (2, (1,)))), "twice"),
                       (dict(attach_k=0), "attach_k"), (dict(warm_rounds=0), "warm_rounds")):
        with pytest.raises(ValueError, match=match):
            ArrivalConfig(**bad)
    with pytest.raises(ValueError, match="no established"):
        ArrivalConfig().neighbors_for(0, [], np.random.default_rng(0))
    assert Scenario(arrival=ta).arrival is ta


# -- the single-device engine ------------------------------------------------


def _dyn_cfg(**kw):
    return EngineConfig(**{**dict(slot_wakes=6.0, seed=3, **F64), **kw})


def test_dynamic_engine_no_refresh_matches_static_bitwise():
    """With a refresh that never fires, the dynamic slot (capacity-padded
    tiles, einsum, row-gathered constants) gives the static engine's bits."""
    _, port = _quad(20, seed=0)
    stat = AsyncEngine(CDUpdate(port), slot_wakes=6.0, seed=7, **F64)
    dyn = AsyncEngine(CDUpdate(port), config=_dyn_cfg(graph_update=GraphUpdate(every=10**9),
                                                      seed=7))
    assert dyn.dynamic and not stat.dynamic and not dyn.fused
    assert dyn._dyn["idx"].shape[1] % 8 == 0
    ss, sd = stat.init_state(np.zeros((20, 3))), dyn.init_state(np.zeros((20, 3)))
    rng = np.random.default_rng(0)
    for _ in range(6):
        mask = rng.random(20) < 0.4
        ss, sd = stat.step(ss, mask), dyn.step(sd, mask)
    assert torch.equal(ss.Theta, sd.Theta)
    assert float(ss.messages) == float(sd.messages) and int(ss.applied) == int(sd.applied)


@pytest.mark.parametrize("update", ["cd", "propagation"])
def test_forced_dynamic_engine_matches_reference(update):
    """Forced wakes with explicit refreshes and an admission between them:
    Theta within 1e-10 of the reference, the same CSR structure (weights to
    1e-10: they are exp of the distances between the two engines' models),
    the same topology log, counters and churn flags."""
    ref, port = _quad(20, seed=0)
    gu = dict(every=5, k=5, candidates=4, gamma=2.0)
    arr = dict(schedule=((5, (18, 19)),), attach_k=3, seed=1)
    if update == "cd":
        jupd, tupd = jsim.CDUpdate(ref), CDUpdate(port)
    else:
        rng = np.random.default_rng(2)
        loc, conf = rng.normal(size=(20, 3)), rng.uniform(0.5, 1.0, size=20)
        jupd = jsim.PropagationUpdate(ref.graph, loc, 0.7, conf)
        tupd = PropagationUpdate(port.graph, loc, 0.7, conf)
    jeng = jsim.AsyncEngine(jupd, config=jsim.EngineConfig(
        slot_wakes=6.0, seed=3, dtype=jnp.float64, graph_update=jsim.GraphUpdate(**gu),
        scenario=jsim.Scenario(arrival=jsim.ArrivalConfig(**arr))))
    teng = AsyncEngine(tupd, config=_dyn_cfg(graph_update=GraphUpdate(**gu),
                                             scenario=Scenario(arrival=ArrivalConfig(**arr))))
    _csr_equal(teng._csr, jeng._csr)
    T0 = np.random.default_rng(5).normal(size=(20, 3))
    js, ts = jeng.init_state(T0), teng.init_state(T0)
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    rng = np.random.default_rng(1)
    for k in range(12):
        mask = rng.random(20) < 0.4
        js, ts = jeng.step(js, mask), teng.step(ts, mask)
        if k in (3, 8):
            js = jeng._refresh_topology(js, k)
            ts = teng._refresh_topology(ts, k)
            _csr_equal(teng._csr, jeng._csr, data_tol=TOL64)
        if k == 5:
            js, ts = jeng.admit(js, [18, 19]), teng.admit(ts, [18, 19])
            _csr_equal(teng._csr, jeng._csr, data_tol=TOL64)
    np.testing.assert_allclose(ts.Theta.numpy(), np.asarray(js.Theta), rtol=TOL64, atol=TOL64)
    assert teng.topology_counters() == jeng.topology_counters()
    assert teng.topo.capacity == jeng.topo.capacity
    np.testing.assert_array_equal(ts.active.numpy(), np.asarray(js.active))
    assert int(ts.applied) == int(js.applied)
    assert float(ts.messages) == float(js.messages)


def test_run_fires_refreshes_on_the_absolute_grid():
    """Refreshes fire at slots 5, 10 and 15 of a 20-slot run (an end never
    refreshes); run(12) then run(state=, 8) fires the same ones, the owed
    one at a resume on a grid slot included; the objective decreases and
    the topology counters reach the metrics."""
    _, port = _quad(20, seed=0)
    gu = GraphUpdate(every=5, k=5, candidates=4, gamma=2.0)
    eng = AsyncEngine(CDUpdate(port), config=_dyn_cfg(graph_update=gu, metrics=True))
    res = eng.run(np.zeros((20, 3)), 20, record_every=10)
    counters = eng.topology_counters()
    assert counters["edge_refreshes"] == 3
    assert counters["edges_added"] > 0 or counters["edges_removed"] > 0
    assert res.objective[-1] <= res.objective[0]
    _, derived = eng.metrics_snapshot(res.state)
    assert {f"topology_{k}" for k in counters} <= set(derived)
    assert derived["topology_edge_refreshes"] == 3
    split = AsyncEngine(CDUpdate(port), config=_dyn_cfg(graph_update=gu))
    first = split.run(np.zeros((20, 3)), 10)
    assert split.topology_counters()["edge_refreshes"] == 1  # slot 5; slot 10 is the end
    split.run(None, 10, state=first.state)
    assert split.topology_counters()["edge_refreshes"] == 3  # the owed slot 10, then 15
    np.testing.assert_array_equal(split._csr.indices, eng._csr.indices)


def test_arrivals_detach_then_admit_with_the_reference_warm_start():
    ref, port = _quad(20, seed=0)
    arr = dict(schedule=((5, (18, 19)),), attach_k=3, seed=1)
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), config=jsim.EngineConfig(
        slot_wakes=6.0, seed=3, dtype=jnp.float64,
        scenario=jsim.Scenario(arrival=jsim.ArrivalConfig(**arr))))
    teng = AsyncEngine(CDUpdate(port), config=_dyn_cfg(
        scenario=Scenario(arrival=ArrivalConfig(**arr))))
    st = teng.init_state(np.zeros((20, 3)))
    assert list(np.flatnonzero(~st.active.numpy())) == [18, 19]
    assert (np.diff(teng._csr.indptr)[[18, 19]] == 0).all()
    T0 = np.random.default_rng(4).normal(size=(20, 3))
    js, ts = jeng.init_state(T0), teng.init_state(T0)
    rng = np.random.default_rng(0)
    for _ in range(4):
        mask = rng.random(20) < 0.5
        js, ts = jeng.step(js, mask), teng.step(ts, mask)
    theta_before = ts.Theta
    np.testing.assert_array_equal(ts.Theta.numpy()[18:], T0[18:])  # pending: never woken
    js, ts = jeng.admit(js, [18, 19]), teng.admit(ts, [18, 19])
    assert ts.Theta is theta_before  # written in place
    np.testing.assert_allclose(ts.Theta.numpy()[18:], np.asarray(js.Theta)[18:], rtol=TOL64,
                               atol=TOL64)
    assert bool(ts.active.all()) and teng.topology_counters()["arrivals"] == 2
    with pytest.raises(ValueError, match="not pending"):
        teng.admit(ts, [18])
    # A sampled run admits them at their slot and keeps them live.
    res = AsyncEngine(CDUpdate(port), config=_dyn_cfg(
        scenario=Scenario(arrival=ArrivalConfig(**arr)))).run(np.zeros((20, 3)), 12)
    assert bool(res.active.all())
    assert (np.abs(res.Theta[[18, 19]]).sum(axis=1) > 0).all()


def test_warm_arrivals_start_closer_than_cold():
    rng = np.random.default_rng(6)
    n, p = 24, 3
    targets = rng.normal(size=(1, p)) + 0.15 * rng.normal(size=(n, p))
    ref, port = _quad(n, seed=6, p=p, targets=targets)
    star = ref.solve_exact()
    ids = (22, 23)

    def admitted_rows(warm):
        arr = ArrivalConfig(schedule=((7, ids),), attach_k=4, seed=1, warm_start=warm)
        eng = AsyncEngine(CDUpdate(port), config=_dyn_cfg(slot_wakes=8.0,
                                                          scenario=Scenario(arrival=arr)))
        st = eng.advance(eng.init_state(np.zeros((n, p))), 6)
        return eng.admit(st, list(ids)).Theta.numpy()[list(ids)]

    warm, cold = admitted_rows(True), admitted_rows(False)
    assert np.allclose(cold, 0.0)
    assert np.linalg.norm(warm - star[list(ids)]) < np.linalg.norm(cold - star[list(ids)])


def test_dynamic_refusals(quad24):
    _, port = quad24
    gu = GraphUpdate(every=4)
    with pytest.raises(ValueError, match="fused"):
        AsyncEngine(CDUpdate(port), config=EngineConfig(graph_update=gu, fused=True,
                                                        device="cpu"))
    with pytest.raises(NotImplementedError, match="delay"):
        AsyncEngine(CDUpdate(port), config=EngineConfig(
            graph_update=gu, scenario=Scenario(delay=DelayConfig(max_delay=1)), device="cpu"))
    eng = AsyncEngine(CDUpdate(port), config=EngineConfig(graph_update=gu, device="cpu"))
    assert eng.fused is False  # "auto" resolves to unfused on a dynamic engine
    with pytest.raises(ValueError, match="keep n"):
        eng.set_topology(as_csr(_quad(8, seed=0)[1].graph))
    csr = as_csr(port.graph)
    rows, cols, vals = csr.row_ids(), csr.indices, csr.data
    keep = (rows != 0) & (cols != 0)
    with pytest.raises(ValueError, match="no neighbours"):
        eng.set_topology(csr_from_coo(24, rows[keep], cols[keep], vals[keep]))
    with pytest.raises(ValueError, match="static-topology"):
        AsyncEngine(CDUpdate(port), device="cpu").set_topology(csr)
    with pytest.raises(ValueError, match="no arrival"):
        eng.admit(eng.init_state(np.zeros((24, 3))), [0])
    with pytest.raises(ValueError, match="outside"):
        AsyncEngine(CDUpdate(port), config=EngineConfig(
            scenario=Scenario(arrival=ArrivalConfig(schedule=((2, (99,)),))), device="cpu"))

    class NoDeg(CDUpdate):
        def agent_constants(self):
            return {k: v for k, v in super().agent_constants().items() if k != "deg"}

    for make in (lambda c: AsyncEngine(NoDeg(port), config=c),
                 lambda c: ShardedAsyncEngine(NoDeg(port), num_shards=2, config=c)):
        with pytest.raises(ValueError, match="'deg'"):
            make(EngineConfig(graph_update=gu, device="cpu"))
    # A prebuilt partition cannot be reused once arrivals detach edges.
    part = partition_graph(csr, 2)
    with pytest.raises(ValueError, match="partition"):
        ShardedAsyncEngine(CDUpdate(port), num_shards=2, config=EngineConfig(
            partition=part, device="cpu",
            scenario=Scenario(arrival=ArrivalConfig(schedule=((2, (15,)),)))))


def test_tiles_stay_in_place_within_capacity_and_reset_the_graphs_beyond(quad24):
    """A swap that keeps the slot capacity writes into the same device
    tiles and keeps the captured graphs; one that grows it allocates new
    tiles and drops the graphs and the live buffers (``ChunkGraphs.reset``,
    held here on the CPU with the graphs' bookkeeping alone)."""
    _, port = quad24
    eng = AsyncEngine(CDUpdate(port), config=_dyn_cfg(graph_update=GraphUpdate(every=4)))
    state = eng.init_state(np.zeros((24, 3)))
    graphs = eng._graphs = capture.ChunkGraphs(eng)
    graphs.bind(state)
    graphs.warm, graphs.warmups, graphs.graphs = True, 1, {16: ("graph", {})}
    tiles = dict(eng._dyn)
    cap = eng.topo.capacity
    csr = eng._csr
    eng.set_topology(type(csr)(indptr=csr.indptr, indices=csr.indices, data=csr.data * 2.0))
    assert all(eng._dyn[k] is tiles[k] for k in tiles) and eng._consts["deg"] is tiles["deg"]
    torch.testing.assert_close(eng._dyn["deg"], 2.0 * torch.as_tensor(csr.degrees))
    assert graphs.graphs and graphs.live is state and graphs.recaptures == 0
    hub = np.arange(1, 24)
    grown = csr_from_coo(24, np.concatenate([csr.row_ids(), np.zeros(23, int)]),
                         np.concatenate([csr.indices, hub]),
                         np.concatenate([csr.data, np.ones(23)]), symmetrize=True)
    eng.set_topology(grown)
    assert eng.topo.capacity == 24 > cap and eng._dyn["idx"].shape == (24, 24)
    assert eng._dyn["idx"] is not tiles["idx"] and eng._consts["deg"] is eng._dyn["deg"]
    assert not graphs.graphs and graphs.live is None and not graphs.warm
    assert eng.topology_counters()["edges_added"] == 23 - int(np.diff(csr.indptr)[0])
    # The slot runs on the grown tiles.
    out = eng.step(state, np.ones(24, bool))
    assert torch.isfinite(out.Theta).all()


# -- the sharded engine ------------------------------------------------------


def test_sharded_single_shard_matches_single_device_dynamic():
    _, port = _quad(24, seed=1)
    cfg = _dyn_cfg(seed=5, graph_update=GraphUpdate(every=4, k=5, candidates=4, gamma=2.0))
    single = AsyncEngine(CDUpdate(port), config=cfg)
    shard = ShardedAsyncEngine(CDUpdate(port), num_shards=1, config=cfg)
    ss, sh = single.init_state(np.zeros((24, 3))), shard.init_state(np.zeros((24, 3)))
    rng = np.random.default_rng(0)
    for _ in range(3):
        mask = rng.random(24) < 0.4
        ss, sh = single.step(ss, mask), shard.step(sh, mask)
    np.testing.assert_array_equal(ss.Theta.numpy(), shard.global_theta(sh))
    ss, sh = single._refresh_topology(ss, 1), shard._refresh_topology(sh, 1)
    _csr_equal(single._csr, shard._csr)
    for _ in range(3):
        mask = rng.random(24) < 0.4
        ss, sh = single.step(ss, mask), shard.step(sh, mask)
    np.testing.assert_allclose(ss.Theta.numpy(), shard.global_theta(sh), atol=1e-12, rtol=0.0)
    assert shard.topology_counters()["edge_refreshes"] == 1


def _prob48():
    return _quad(48, seed=0, k=6)


@pytest.mark.parametrize("relabel", [None, "rcm"])
def test_four_shards_match_single_device_dynamic_with_arrivals(relabel):
    """The reference's multi-device parity at S = 4, in process (the shards
    are stacked): exact before a refresh, identical refreshed graphs,
    1e-12 after; an admission on both then keeps them within 1e-12, and
    the single-device port stays within 1e-10 of the reference."""
    ref, port = _prob48()
    gu = dict(every=4, k=6, candidates=4, gamma=2.0)
    arr = dict(schedule=((6, (46, 47)),), attach_k=3, seed=1)
    cfg = _dyn_cfg(slot_wakes=8.0, seed=5, graph_update=GraphUpdate(**gu),
                   scenario=Scenario(arrival=ArrivalConfig(**arr)), drift_threshold=0.25)
    single = AsyncEngine(CDUpdate(port), config=cfg)
    shard = ShardedAsyncEngine(CDUpdate(port), num_shards=4, config=cfg.replace(relabel=relabel))
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), config=jsim.EngineConfig(
        slot_wakes=8.0, seed=5, dtype=jnp.float64, graph_update=jsim.GraphUpdate(**gu),
        scenario=jsim.Scenario(arrival=jsim.ArrivalConfig(**arr))))
    T0 = np.zeros((48, 3))
    ss, sh, js = single.init_state(T0), shard.init_state(T0), jeng.init_state(T0)
    np.testing.assert_array_equal(shard.part.unpad_rows(sh.active.numpy()), ss.active.numpy())
    rng = np.random.default_rng(0)

    def steps(k):
        nonlocal ss, sh, js
        for _ in range(k):
            mask = rng.random(48) < 0.4
            ss, sh, js = single.step(ss, mask), shard.step(sh, mask), jeng.step(js, mask)

    steps(3)
    assert np.abs(ss.Theta.numpy() - shard.global_theta(sh)).max() == 0.0
    ss, sh = single._refresh_topology(ss, 1), shard._refresh_topology(sh, 1)
    js = jeng._refresh_topology(js, 1)
    _csr_equal(single._csr, shard._csr)
    steps(3)
    np.testing.assert_allclose(shard.global_theta(sh), ss.Theta.numpy(), atol=1e-12, rtol=0.0)
    ss, sh, js = single.admit(ss, [46, 47]), shard.admit(sh, [46, 47]), jeng.admit(js, [46, 47])
    _csr_equal(single._csr, shard._csr)
    steps(3)
    np.testing.assert_allclose(shard.global_theta(sh), ss.Theta.numpy(), atol=1e-12, rtol=0.0)
    np.testing.assert_allclose(ss.Theta.numpy(), np.asarray(js.Theta), atol=TOL64, rtol=TOL64)
    assert bool(sh.active.sum() == 48) and shard.topology_counters()["arrivals"] == 2
    c = shard.topology_counters()
    assert c["weight_patches"] + c["structural_patches"] + c["repartitions"] == 2


def test_sharded_set_topology_tiers():
    """Weight-only patch, structural patch and a drift-forced repartition
    each land in their own counter; the state is kept, re-slabbed or
    re-laid out, and a forced step afterwards matches the single-device
    engine on the same graph."""
    _, port = _quad(24, seed=2)
    base = _dyn_cfg(seed=5, graph_update=GraphUpdate(every=4))
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=2, config=base.replace(relabel="rcm"))
    st = eng.init_state(np.random.default_rng(1).normal(size=(24, 3)))
    csr = eng._csr
    same = eng.set_topology(st, type(csr)(indptr=csr.indptr, indices=csr.indices,
                                          data=csr.data * 2.0))
    assert same.slab is st.slab and eng.topology_counters()["weight_patches"] == 1
    gu = GraphUpdate(every=1, k=5, candidates=2, gamma=1.0)
    theta = eng.global_theta(same)
    moved = eng.set_topology(same, gu.refresh(eng._csr, np.zeros((24, 3))))
    assert eng.topology_counters()["structural_patches"] == 1
    assert moved.slab.shape[0] == eng.smix.slab_rows
    np.testing.assert_array_equal(eng.global_theta(moved), theta)
    forced = ShardedAsyncEngine(CDUpdate(port), num_shards=2,
                                config=base.replace(drift_threshold=-10.0))
    st2 = forced.init_state(theta)
    st2 = forced._refresh_topology(st2, 1)
    assert forced.topology_counters()["repartitions"] == 1
    np.testing.assert_array_equal(forced.global_theta(st2), theta)
    single = AsyncEngine(CDUpdate(port), config=base)
    ss = single.init_state(theta)
    single.set_topology(forced._csr)
    mask = np.random.default_rng(3).random(24) < 0.5
    st2, ss = forced.step(st2, mask), single.step(ss, mask)
    np.testing.assert_allclose(forced.global_theta(st2), ss.Theta.numpy(), atol=1e-12, rtol=0)


def test_sharded_sampled_run_with_churn_refreshes_and_arrivals():
    """16 sampled slots at S = 4 with churn, refreshes every 4 slots and
    two arrivals: finite, every refresh and admission applied, the
    objective not higher at the end than at the start."""
    _, port = _prob48()
    cfg = _dyn_cfg(slot_wakes=8.0, seed=5,
                   graph_update=GraphUpdate(every=4, k=6, candidates=4, gamma=2.0),
                   scenario=Scenario(arrival=ArrivalConfig(schedule=((6, (46, 47)),),
                                                           attach_k=3, seed=1),
                                     churn=ChurnConfig(leave_prob=0.05)),
                   drift_threshold=0.25, metrics=True)
    eng = ShardedAsyncEngine(CDUpdate(port), num_shards=4, config=cfg)
    res = eng.run(np.zeros((48, 3)), 16, record_every=8)
    c = eng.topology_counters()
    assert c["edge_refreshes"] == 3 and c["arrivals"] == 2
    assert c["weight_patches"] + c["structural_patches"] + c["repartitions"] == 4
    assert np.isfinite(res.Theta).all()
    assert res.objective[-1] <= res.objective[0]
    _, derived = eng.metrics_snapshot(res.state)
    assert derived["topology_arrivals"] == 2


def test_dp_sharded_dynamic_keeps_budgets_through_a_repartition():
    """The private counts travel with their agents through a re-layout."""
    from repro_torch.core import DPConfig

    _, port = _quad(24, seed=3)
    upd = DPCDUpdate.plan(dataclasses.replace(port, clip=1.0), DPConfig(eps_bar=1.0), 5)
    cfg = _dyn_cfg(seed=2, graph_update=GraphUpdate(every=3, k=4, candidates=3, gamma=2.0),
                   drift_threshold=-10.0)
    eng = ShardedAsyncEngine(upd, num_shards=3, config=cfg)
    single = AsyncEngine(upd, config=cfg)
    sh, ss = eng.init_state(np.zeros((24, 3))), single.init_state(np.zeros((24, 3)))
    rng = np.random.default_rng(9)
    for k in range(6):
        # The engines draw their noise in other shapes: compare the counts,
        # which the wake sets and the budgets decide.
        mask = rng.random(24) < 0.5
        sh, ss = eng.step(sh, mask), single.step(ss, mask)
        if k == 2:
            sh, ss = eng._refresh_topology(sh, 1), single._refresh_topology(ss, 1)
    assert eng.topology_counters()["repartitions"] == 1
    np.testing.assert_array_equal(eng.part.unpad_rows(sh.ustate.numpy()), ss.ustate.numpy())


# -- the bench -----------------------------------------------------------------


def test_dynamic_topology_bench_matches_reference(tmp_path):
    """``repro_torch.bench.dynamic_topology.run`` against the reference's
    runner at n = 3000: the same rows, the same drift (host numpy on the
    same graph), halo parity asserted; the seconds are not compared. The
    row merges into the summary file."""
    import importlib.util
    import json
    from pathlib import Path

    from repro_torch.bench import dynamic_topology

    path = Path(__file__).resolve().parents[1] / "benchmarks" / "bench_dynamic_topology.py"
    spec = importlib.util.spec_from_file_location("bench_dynamic_topology", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    out = tmp_path / "summary.json"
    got = dynamic_topology.run(n=3000, shards=4, verbose=False, out=out)
    want = ref.run(n=3000, shards=4, verbose=False)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    g, w = dict((r[0], r[1]) for r in got), dict((r[0], r[1]) for r in want)
    assert g["dyntopo_drift"] == w["dyntopo_drift"]
    assert g["dyntopo_halo_parity"] == w["dyntopo_halo_parity"] == 1.0
    row = json.loads(out.read_text())["dynamic_topology"]
    assert row["n"] == 3000 and [r[0] for r in row["rows"]] == [r[0] for r in got]

"""repro_torch.sim.AsyncEngine against repro.sim.AsyncEngine, and the
engine's own invariants.

The two packages' random streams differ (torch.Generator vs jax.random),
so parity goes through forced wake sets (``AsyncEngine.step``) and the
carried-over state; sampled runs are held to distributions and fixed
points. Tolerances: float32 forced-wake runs agree to 1e-5 after 20
slots (float32 reduction order); float64 ones to 1e-10; fixed points to
1e-5 of ``solve_exact``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as jsim
from repro.core import AgentData, knn_graph, make_objective, ring_graph
from repro_torch.convert import (
    objective_from_reference,
    sim_state_from_numpy,
    sim_state_to_numpy,
)
from repro_torch.core.coordinate_descent import _cd_step
from repro_torch.sim import (
    AsyncEngine,
    CDUpdate,
    ChurnConfig,
    DelayConfig,
    EngineConfig,
    Scenario,
    StragglerConfig,
    make_engine,
)

TOL32 = 1e-5
TOL64 = 1e-10


def _quad(n, p=4, m=3, seed=0, mix_mode="auto", mu=0.5, graph=None, loss="quadratic"):
    rng = np.random.default_rng(seed)
    if graph is None:
        graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    if loss == "logistic":
        y = np.sign(y)
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), loss, mu=mu,
                         mix_mode=mix_mode)
    return ref, objective_from_reference(ref)


def _masks(n, slots, seed, frac=0.3):
    rng = np.random.default_rng(seed)
    return [rng.random(n) < frac for _ in range(slots)]


def _forced(engine, Theta0, masks, state=None):
    state = engine.init_state(Theta0) if state is None else state
    for mask in masks:
        state = engine.step(state, mask)
    return state


def _theta(state):
    t = state.Theta
    return np.asarray(t) if not isinstance(t, torch.Tensor) else t.to("cpu", copy=True).numpy()


@pytest.fixture(scope="module")
def small():
    return _quad(24, seed=1)


# ---------------------------------------------------------------------------
# Forced-wake parity with the reference engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mix_mode", ["dense", "sparse"])
@pytest.mark.parametrize("fused", [False, True])
def test_forced_wakes_match_reference_f32(mix_mode, fused):
    """fused=True: the reference runs its Pallas kernel interpreted, the
    port the kernel's plain version (the CPU route)."""
    ref, port = _quad(40, seed=2, mix_mode=mix_mode)
    masks = _masks(40, 20, seed=3)
    Theta0 = np.random.default_rng(4).normal(size=(40, 4))
    je = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, fused=fused)
    te = AsyncEngine(CDUpdate(port), slot_wakes=8.0, fused=fused, device="cpu")
    assert je.fused == te.fused == fused
    js, ts = _forced(je, Theta0, masks), _forced(te, Theta0, masks)
    np.testing.assert_allclose(_theta(ts), _theta(js), rtol=TOL32, atol=TOL32)
    assert int(ts.applied) == int(js.applied) and int(ts.dropped) == int(js.dropped)
    assert float(ts.messages) == float(js.messages)


def test_forced_wakes_match_reference_f64_with_capacity_overflow(small):
    ref, port = small
    masks = _masks(ref.n, 20, seed=5, frac=0.5)
    Theta0 = np.random.default_rng(6).normal(size=(ref.n, ref.p))
    je = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=4.0, batch_size=9, dtype=jnp.float64)
    te = AsyncEngine(CDUpdate(port), slot_wakes=4.0, batch_size=9, dtype=torch.float64,
                     device="cpu")
    js, ts = _forced(je, Theta0, masks), _forced(te, Theta0, masks)
    np.testing.assert_allclose(_theta(ts), _theta(js), rtol=TOL64, atol=TOL64)
    assert int(ts.dropped) == int(js.dropped) > 0
    assert int(ts.applied) == int(js.applied)


def test_delay_forced_wakes_match_reference():
    ref, port = _quad(30, seed=7)
    K = ref.graph.max_degree()
    delays = np.random.default_rng(8).integers(0, 4, size=(30, K))
    jsc = jsim.Scenario(delay=jsim.DelayConfig(max_delay=3, edge_delays=delays))
    tsc = Scenario(delay=DelayConfig(max_delay=3, edge_delays=delays))
    masks = _masks(30, 12, seed=9)
    Theta0 = np.random.default_rng(10).normal(size=(30, 4))
    je = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, scenario=jsc, dtype=jnp.float64)
    te = AsyncEngine(CDUpdate(port), slot_wakes=8.0, scenario=tsc, dtype=torch.float64,
                     device="cpu")
    js, ts = _forced(je, Theta0, masks), _forced(te, Theta0, masks)
    np.testing.assert_allclose(_theta(ts), _theta(js), rtol=TOL64, atol=TOL64)
    np.testing.assert_allclose(ts.hist.numpy(), np.asarray(js.hist), rtol=TOL64, atol=TOL64)


@pytest.mark.parametrize("fused", [False, True])
def test_state_carries_across_from_reference(fused):
    """Advance the reference k forced slots, carry its state over, then
    continue both with the same wake sets."""
    ref, port = _quad(32, seed=11, mix_mode="sparse")
    masks = _masks(32, 20, seed=12)
    je = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, fused=fused)
    te = AsyncEngine(CDUpdate(port), slot_wakes=8.0, fused=fused, device="cpu")
    js = _forced(je, np.zeros((32, 4)), masks[:8])
    leaves = {k: np.asarray(getattr(js, k))
              for k in ("Theta", "hist", "ptr", "active", "applied", "dropped", "messages")}
    ts = sim_state_from_numpy(**leaves, device="cpu", seed=5)
    js, ts = _forced(je, None, masks[8:], js), _forced(te, None, masks[8:], ts)
    np.testing.assert_allclose(_theta(ts), _theta(js), rtol=TOL32, atol=TOL32)
    back = sim_state_to_numpy(ts)
    assert back["ptr"] == int(js.ptr) == 20
    assert back["applied"] == int(js.applied) and back["messages"] == float(js.messages)


# ---------------------------------------------------------------------------
# Sampled runs: distributions, determinism, fixed points
# ---------------------------------------------------------------------------


def test_thinned_wake_rate_matches_expectation(small):
    _, port = small
    eng = AsyncEngine(CDUpdate(port), slot_wakes=6.0, seed=0, device="cpu")
    slots = 300
    res = eng.run(np.zeros((port.n, port.p)), slots=slots)
    mu = eng.wake_probs.sum() * slots
    assert abs(res.wakes_applied - mu) < 6 * np.sqrt(mu)
    assert res.wakes_dropped == 0
    # The reference's sampled run draws from the same law: the two counts
    # differ by less than 6 standard deviations of their difference.
    ref_eng = jsim.AsyncEngine(jsim.CDUpdate(small[0]), slot_wakes=6.0, seed=0)
    np.testing.assert_allclose(ref_eng.wake_probs, eng.wake_probs, rtol=1e-15)
    ref_res = ref_eng.run(np.zeros((port.n, port.p)), slots=slots)
    assert abs(res.wakes_applied - ref_res.wakes_applied) < 6 * np.sqrt(2 * mu)


def test_seeded_determinism_and_resume(small):
    _, port = small
    eng = AsyncEngine(CDUpdate(port), slot_wakes=6.0, seed=11, device="cpu")
    r1 = eng.run(np.zeros((port.n, port.p)), slots=40)
    r2 = eng.run(np.zeros((port.n, port.p)), slots=40)
    np.testing.assert_array_equal(r1.Theta, r2.Theta)
    assert r1.messages == r2.messages and r1.wakes_applied == r2.wakes_applied
    half = eng.run(np.zeros((port.n, port.p)), slots=25)
    resumed = eng.run(None, slots=15, state=half.state)
    np.testing.assert_array_equal(resumed.Theta, r1.Theta)
    assert resumed.slots == 40
    r3 = AsyncEngine(CDUpdate(port), slot_wakes=6.0, seed=12, device="cpu").run(
        np.zeros((port.n, port.p)), slots=40)
    assert not np.array_equal(r1.Theta, r3.Theta)


def test_slot_capacity_overflow_is_counted(small):
    _, port = small
    eng = AsyncEngine(CDUpdate(port), slot_wakes=4.0, batch_size=2, seed=0, device="cpu")
    mask = np.zeros(port.n, dtype=bool)
    mask[:5] = True
    Theta0 = np.random.default_rng(0).normal(size=(port.n, port.p))
    state = eng.step(eng.init_state(Theta0), mask)
    assert int(state.applied) == 2 and int(state.dropped) == 3
    changed = np.any(_theta(state) != Theta0.astype(np.float32), axis=1)
    np.testing.assert_array_equal(np.flatnonzero(changed), [0, 1])  # ascending, first B


def test_compaction_gives_distinct_rows():
    _, port = _quad(10, seed=3)
    eng = AsyncEngine(CDUpdate(port), slot_wakes=4.0, batch_size=6, device="cpu")
    wake = torch.tensor([0, 1, 1, 0, 0, 1, 0, 0, 0, 1], dtype=torch.bool)
    woken, slot_rows, valid, dropped = eng._compact(wake)
    assert woken.tolist() == [1, 2, 5, 9, 10, 10]
    assert valid.tolist() == [True] * 4 + [False] * 2
    assert sorted(set(slot_rows.tolist())) == sorted(slot_rows.tolist())
    assert slot_rows[:4].tolist() == [1, 2, 5, 9] and int(dropped) == 0
    woken, _, _, dropped = eng._compact(torch.ones(10, dtype=torch.bool))
    assert woken.tolist() == list(range(6)) and int(dropped) == 4


@pytest.mark.parametrize("mix_mode", ["dense", "sparse"])
def test_engine_reaches_exact_fixed_point_512(mix_mode):
    _, port = _quad(512, seed=0, mix_mode=mix_mode)
    star = port.solve_exact()
    eng = AsyncEngine(CDUpdate(port), slot_wakes=128.0, seed=3, dtype=torch.float64, device="cpu")
    res = eng.run(np.zeros((port.n, port.p)), slots=700)
    assert np.abs(res.Theta - star).max() < 1e-5
    state = eng.advance(eng.init_state(star), 5)
    assert np.abs(_theta(state) - star).max() < 1e-9


def test_fused_plain_route_reaches_the_same_fixed_point():
    _, port = _quad(64, seed=4, mix_mode="sparse")
    star = port.solve_exact()
    eng = AsyncEngine(CDUpdate(port), slot_wakes=16.0, seed=1, fused=True, device="cpu")
    res = eng.run(np.zeros((port.n, port.p)), slots=600, record_every=200)
    assert np.abs(res.Theta - star).max() < 1e-5
    assert np.all(np.diff(res.objective) < 0)


def test_dense_and_sparse_backends_agree():
    _, dense = _quad(48, seed=2, mix_mode="dense")
    _, sparse = _quad(48, seed=2, mix_mode="sparse")
    kw = dict(slot_wakes=8.0, seed=4, dtype=torch.float64, device="cpu")
    rd = AsyncEngine(CDUpdate(dense), **kw).run(np.zeros((48, 4)), slots=60)
    rs = AsyncEngine(CDUpdate(sparse), **kw).run(np.zeros((48, 4)), slots=60)
    np.testing.assert_allclose(rd.Theta, rs.Theta, rtol=1e-9, atol=1e-11)


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


def test_churned_agents_are_frozen(small):
    _, port = small
    n = port.n
    leavers = np.zeros(n)
    leavers[[2, 5, 11]] = 1.0  # depart deterministically at slot 0
    sc = Scenario(churn=ChurnConfig(leave_prob=leavers, rejoin_prob=0.0))
    eng = AsyncEngine(CDUpdate(port), slot_wakes=8.0, seed=1, scenario=sc, device="cpu")
    Theta0 = np.random.default_rng(0).normal(size=(n, port.p)).astype(np.float32)
    res = eng.run(Theta0, slots=80)
    np.testing.assert_array_equal(res.Theta[[2, 5, 11]], Theta0[[2, 5, 11]])
    assert not res.active[[2, 5, 11]].any()
    others = np.setdiff1d(np.arange(n), [2, 5, 11])
    assert np.abs(res.Theta[others] - Theta0[others]).max() > 1e-3
    # A forced wake cannot wake a departed agent either.
    state = eng.step(res.state, np.ones(n, dtype=bool))
    np.testing.assert_array_equal(_theta(state)[[2, 5, 11]], Theta0[[2, 5, 11]])


def test_straggler_drop_prob_one_loses_everything(small):
    _, port = small
    sc = Scenario(straggler=StragglerConfig(drop_prob=1.0))
    eng = AsyncEngine(CDUpdate(port), slot_wakes=8.0, seed=1, scenario=sc, device="cpu")
    Theta0 = np.random.default_rng(0).normal(size=(port.n, port.p)).astype(np.float32)
    res = eng.run(Theta0, slots=30)
    np.testing.assert_array_equal(res.Theta, Theta0)
    assert res.wakes_applied == 0 and res.messages == 0.0


def test_delayed_messages_lag_and_arrive_in_order():
    """Per-edge delay d: a woken agent mixes neighbour state from d slots
    ago, and successive broadcasts arrive in send order (FIFO)."""
    n, p, d = 3, 2, 2
    _, port = _quad(n, p=p, m=2, seed=3, graph=ring_graph(n), mix_mode="dense")
    sc = Scenario(delay=DelayConfig(max_delay=d, edge_delays=d))
    eng = AsyncEngine(CDUpdate(port), slot_wakes=1.0, scenario=sc, dtype=torch.float64,
                      device="cpu")
    state = eng.init_state(np.random.default_rng(4).normal(size=(n, p)))

    def wake(state, i):
        mask = np.zeros(n, dtype=bool)
        mask[i] = True
        return eng.step(state, mask)

    snapshots = [_theta(state)]
    state = wake(state, 0)
    snapshots.append(_theta(state))
    state = wake(state, 0)

    def expected_row1(state, lagged):
        view = lagged.copy()
        view[1] = _theta(state)[1]  # own block is always current
        return _cd_step(port, torch.as_tensor(view), 1)[1].numpy()

    exp = expected_row1(state, snapshots[0])  # slot 2 sees slot 0's theta_0
    state = wake(state, 1)
    np.testing.assert_allclose(_theta(state)[1], exp, rtol=1e-12)
    exp = expected_row1(state, snapshots[1])  # slot 3: the slot-1 broadcast lands next
    state = wake(state, 1)
    np.testing.assert_allclose(_theta(state)[1], exp, rtol=1e-12)


def test_zero_delay_and_full_scenario(small):
    _, port = small
    kw = dict(slot_wakes=8.0, seed=9, dtype=torch.float64, device="cpu")
    sc = Scenario(delay=DelayConfig(max_delay=0, edge_delays=0))
    r_delay = AsyncEngine(CDUpdate(port), scenario=sc, **kw).run(np.zeros((24, 4)), slots=40)
    r_plain = AsyncEngine(CDUpdate(port), **kw).run(np.zeros((24, 4)), slots=40)
    # Same draws, same wakes: the zero-delay ring reads the current snapshot.
    np.testing.assert_allclose(r_delay.Theta, r_plain.Theta, rtol=1e-9, atol=1e-11)
    full = Scenario(
        churn=ChurnConfig(leave_prob=0.02, rejoin_prob=0.3),
        delay=DelayConfig(max_delay=2, edge_delays=1),
        straggler=StragglerConfig(drop_prob=0.2),
    )
    res = AsyncEngine(CDUpdate(port), slot_wakes=8.0, seed=5, scenario=full, device="cpu").run(
        np.zeros((24, 4)), slots=150, record_every=150)
    assert res.objective[-1] < 0.75 * res.objective[0]
    assert np.isfinite(res.Theta).all()


# ---------------------------------------------------------------------------
# Configuration: the device rule, the fused gate, later slices
# ---------------------------------------------------------------------------


def test_default_device_raises_without_cuda(monkeypatch, small):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="EngineConfig.device"):
        EngineConfig()
    with pytest.raises(RuntimeError, match="EngineConfig.device"):
        AsyncEngine(CDUpdate(small[1]), slot_wakes=4.0)
    assert EngineConfig(device="cpu").device == "cpu"


def test_config_overrides_and_later_slices(small):
    _, port = small
    cfg = EngineConfig(slot_wakes=8.0, seed=1, fused=False, device="cpu")
    a = _forced(AsyncEngine(CDUpdate(port), config=cfg), np.zeros((24, 4)), _masks(24, 5, 1))
    b = _forced(make_engine(CDUpdate(port), cfg.replace(seed=7), seed=1),
                np.zeros((24, 4)), _masks(24, 5, 1))
    np.testing.assert_array_equal(_theta(a), _theta(b))
    with pytest.raises(TypeError, match="unknown engine option"):
        AsyncEngine(CDUpdate(port), device="cpu", slotwakes=3.0)
    with pytest.raises(ValueError, match="fused"):
        EngineConfig(fused="yes", device="cpu")
    for field, value, item in [("metrics", True, "A10"), ("graph_update", object(), "A11"),
                               ("exchange", "p2p", "A9"), ("partition", object(), "A9"),
                               ("devices", [0], "A9")]:
        with pytest.raises(NotImplementedError, match=item):
            EngineConfig(device="cpu", **{field: value})
    with pytest.raises(NotImplementedError, match="A9"):
        make_engine(CDUpdate(port), device="cpu", shards=2)
    with pytest.raises(NotImplementedError, match="A11"):
        Scenario(arrival=object())
    port_fields = {f.name for f in dataclasses.fields(EngineConfig)}
    ref_fields = {f.name for f in dataclasses.fields(jsim.EngineConfig)}
    # steps_per_chunk sized the reference's compiled scan chunks; the port
    # loops slot by slot and has no such setting.
    assert port_fields - ref_fields == {"device"}
    assert ref_fields - port_fields == {"steps_per_chunk"}
    with pytest.raises(TypeError, match="unknown engine option"):
        AsyncEngine(CDUpdate(port), device="cpu", steps_per_chunk=16)


def test_fused_gate():
    _, quad = _quad(16, seed=6)
    _, logistic = _quad(16, seed=6, loss="logistic")
    assert not AsyncEngine(CDUpdate(quad), device="cpu").fused  # auto: CUDA only
    assert AsyncEngine(CDUpdate(quad), fused=True, device="cpu").fused
    assert not AsyncEngine(CDUpdate(logistic), device="cpu").fused
    with pytest.raises(ValueError, match="CDUpdate"):
        AsyncEngine(CDUpdate(logistic), fused=True, device="cpu")
    with pytest.raises(ValueError, match="delay"):
        AsyncEngine(CDUpdate(quad), fused=True, device="cpu",
                    scenario=Scenario(delay=DelayConfig()))
    with pytest.raises(ValueError, match="float32"):
        AsyncEngine(CDUpdate(quad), fused=True, device="cpu", dtype=torch.float64)


@pytest.mark.parametrize("p,m,fits", [(100, 8, True), (1024, 2048, True), (1025, 8, False),
                                      (100, 2049, False), (1025, 2049, False)])
def test_fused_auto_respects_the_kernel_limits(p, m, fits):
    """On a CUDA device (named, no card needed) ``"auto"`` takes the fused
    kernel only within its limits, p <= 1024 and m <= 2048, and the
    unfused path outside them; ``fused=True`` raises there, naming them."""
    from repro_torch.sim.engine import _resolve_fused

    _, quad = _quad(16, seed=6)
    upd, cuda, f32 = CDUpdate(quad), torch.device("cuda"), torch.float32
    assert _resolve_fused(upd, "auto", cuda, f32, False, p, m) == fits
    assert not _resolve_fused(upd, "auto", torch.device("cpu"), f32, False, p, m)
    assert not _resolve_fused(upd, False, cuda, f32, False, p, m)
    if fits:
        assert _resolve_fused(upd, True, cuda, f32, False, p, m)
    else:
        with pytest.raises(ValueError, match="p <= 1024 and m <= 2048"):
            _resolve_fused(upd, True, cuda, f32, False, p, m)


def test_fused_true_refuses_a_wide_problem_at_construction():
    """The engine passes its p and the data's m: a p = 1025 problem refuses
    ``fused=True`` when the engine is built, and runs unfused otherwise."""
    _, wide = _quad(12, p=1025, m=2, seed=7)
    with pytest.raises(ValueError, match="got p=1025, m=2"):
        AsyncEngine(CDUpdate(wide), fused=True, device="cpu")
    eng = AsyncEngine(CDUpdate(wide), slot_wakes=4.0, device="cpu")
    assert not eng.fused
    state = eng.step(eng.init_state(np.zeros((12, 1025))), np.ones(12, dtype=bool))
    assert bool(torch.isfinite(state.Theta).all()) and float(state.Theta.abs().max()) > 0


def test_record_every_needs_an_objective(small):
    _, port = small

    class NoObjective:
        def __init__(self, inner):
            self._inner = inner
            self.n, self.p, self.graph, self.mix = inner.n, inner.p, inner.graph, inner.mix

        def init_state(self):
            return ()

        def apply(self, *args):
            return self._inner.apply(*args)

    eng = AsyncEngine(NoObjective(CDUpdate(port)), slot_wakes=4.0, device="cpu")
    with pytest.raises(ValueError, match="record_every"):
        eng.run(np.zeros((24, 4)), slots=4, record_every=2)
    res = eng.run(np.zeros((24, 4)), slots=4)
    assert res.objective is None and res.slots == 4


@pytest.mark.parametrize("slots,every", [(10, 4), (12, 3), (5, 7)])
def test_record_every_cadence_matches_reference(small, slots, every):
    """The objective is recorded at the start, every ``every`` slots and at
    the end, as the reference records it."""
    ref, port = small
    Theta0 = np.random.default_rng(2).normal(size=(ref.n, ref.p))
    res = AsyncEngine(CDUpdate(port), slot_wakes=4.0, seed=0, device="cpu").run(
        Theta0, slots=slots, record_every=every)
    ref_res = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=4.0, seed=0).run(
        Theta0, slots=slots, record_every=every)
    assert res.objective.shape == ref_res.objective.shape == (1 + -(-slots // every),)
    np.testing.assert_allclose(res.objective[0], ref_res.objective[0], rtol=TOL32)
    assert res.slots == slots

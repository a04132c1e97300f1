"""The private and propagation update rules of the engine against the
reference's ``repro.sim.DPCDUpdate`` and ``PropagationUpdate``.

The private step draws noise inside the slot, from each package's own
generator, so parity goes through injected draws: the test makes the
reference's ``jax.random`` draws from the key the reference uses and
hands them to the port's ``draws=``. Tolerances: float64 rows 1e-10,
float32 rows and slabs 1e-5 (float32 reduction order; the fused kernel's
plain version against the Pallas kernel run with ``interpret=True``).
Budget counts, applied masks, spends and message counts are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as jsim
from repro.core import AgentData, DPConfig, erdos_renyi_graph, knn_graph, make_objective
from repro_torch.convert import (
    dp_update_from_reference,
    objective_from_reference,
    sim_state_from_numpy,
    sim_state_to_numpy,
)
from repro_torch.core import dp_cd as tdp
from repro_torch.sim import AsyncEngine, DPCDUpdate, PropagationUpdate

TOL32 = 1e-5
TOL64 = 1e-10
FUSED_TOL = 1e-6  # the reference's own fused-vs-unfused bound (tests/test_fused_engine.py)


def _quad(n, p=4, m=3, seed=0, mix_mode="sparse", clip=1.0):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)) / np.sqrt(p))
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode=mix_mode, clip=clip)
    return ref, objective_from_reference(ref)


def _logistic(n=8, p=3, m=4, seed=0):
    rng = np.random.default_rng(seed)
    graph = erdos_renyi_graph(n, 0.5, rng)
    X = rng.normal(size=(n, m, p))
    y = np.sign(np.einsum("nmp,np->nm", X, rng.normal(size=(n, p))))
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "logistic", mu=0.3)
    return ref, objective_from_reference(ref)


def _tcfg(**kw):
    return tdp.DPConfig(**kw)


def _forced(engine, Theta0, masks, state=None):
    state = engine.init_state(Theta0) if state is None else state
    for mask in masks:
        state = engine.step(state, mask)
    return state


def _np(t):
    return t.to("cpu", copy=True).numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# The row steps with the reference's draws
# ---------------------------------------------------------------------------


def _batch(n, p, seed):
    rng = np.random.default_rng(seed)
    rows = np.array([1, 4, 7, 2, 0, n, n], dtype=np.int32)  # sentinel-padded
    valid = rows < n
    Theta = rng.normal(size=(n, p))
    neigh = rng.normal(size=(len(rows), p))
    counts = np.array([0, 2, 1, 0, 2, 1, 0, 1, 2, 0, 1, 0][:n], dtype=np.int32)
    return rows, valid, Theta, neigh, counts


@pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_apply_rows_matches_reference(mechanism, dtype):
    ref, port = _quad(12, p=3, seed=1)
    n, p = ref.n, ref.p
    jupd = jsim.DPCDUpdate.plan(ref, DPConfig(eps_bar=0.6, mechanism=mechanism), planned_Ti=2)
    tupd = dp_update_from_reference(jupd)
    rows, valid, Theta, neigh, counts = _batch(n, p, seed=2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    theta_rows = Theta[np.minimum(rows, n - 1)]
    key = jax.random.PRNGKey(7)
    fn = jax.random.normal if mechanism == "gaussian" else jax.random.laplace
    draws = np.asarray(fn(key, shape=neigh.shape, dtype=jdt))  # what apply_rows draws
    want, japplied, jstate = jupd.apply_rows(
        jnp.asarray(theta_rows, jdt), jnp.asarray(rows), jnp.asarray(valid),
        jnp.asarray(neigh, jdt), key, jnp.asarray(counts))
    state = torch.tensor(counts)
    got, applied, tstate = tupd.apply_rows(
        torch.as_tensor(theta_rows, dtype=tdt), torch.as_tensor(rows).long(),
        torch.as_tensor(valid), torch.as_tensor(neigh, dtype=tdt), None, state, draws=draws)
    tol = TOL64 if dtype == "float64" else TOL32
    assert got.dtype == tdt
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_array_equal(applied.numpy(), np.asarray(japplied))
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
    assert tstate is state  # counts updated in place
    assert applied.numpy().tolist() == [False, False, True, True, True, False, False]


def test_apply_fused_matches_reference_kernel():
    """The fused route (its plain version on the CPU) against the
    reference's Pallas kernel in interpret mode, same draws: sentinels for
    padding and for budget-stopped rows alike."""
    ref, port = _quad(12, p=3, seed=3, mix_mode="sparse")
    n, p = ref.n, ref.p
    jupd = jsim.DPCDUpdate.plan(ref, DPConfig(eps_bar=0.6), planned_Ti=2)
    tupd = dp_update_from_reference(jupd)
    rows, valid, Theta, _, counts = _batch(n, p, seed=4)
    safe = np.minimum(rows, n - 1)
    cols, w = np.asarray(ref.mix.idx)[safe], np.asarray(ref.mix.w)[safe]
    key = jax.random.PRNGKey(11)
    draws = np.asarray(jax.random.laplace(key, (len(rows), p), jnp.float32))
    want, japplied, jstate = jupd.apply_fused(
        jnp.asarray(Theta, jnp.float32), jnp.asarray(rows), jnp.asarray(valid), key,
        jnp.asarray(counts), jnp.asarray(cols, jnp.int32), jnp.asarray(w, jnp.float32),
        interpret=True)
    slab = torch.as_tensor(Theta, dtype=torch.float32)
    got, applied, tstate = tupd.apply_fused(
        slab, torch.as_tensor(rows).long(), torch.as_tensor(valid), None,
        torch.tensor(counts), torch.as_tensor(cols, dtype=torch.int32),
        torch.as_tensor(w, dtype=torch.float32), draws=draws)
    assert got is slab
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL32, atol=TOL32)
    np.testing.assert_array_equal(applied.numpy(), np.asarray(japplied))
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))
    stopped = np.setdiff1d(np.arange(n), rows[applied.numpy()])
    np.testing.assert_array_equal(got.numpy()[stopped], Theta.astype(np.float32)[stopped])


def test_plan_and_accounting_equal_the_reference():
    ref, port = _quad(10, seed=5)
    jupd = jsim.DPCDUpdate.plan(ref, DPConfig(eps_bar=0.9, mechanism="gaussian"), planned_Ti=4)
    tupd = DPCDUpdate.plan(port, _tcfg(eps_bar=0.9, mechanism="gaussian"), planned_Ti=4)
    conv = dp_update_from_reference(jupd)
    for u in (tupd, conv):
        assert u.eps_step == jupd.eps_step and u.planned_Ti == 4
        np.testing.assert_array_equal(u.scales, jupd.scales)
    counts = np.array([0, 1, 4, 5, 2, 4, 0, 3, 9, 1], dtype=np.int32)
    np.testing.assert_array_equal(tupd.eps_spent(torch.as_tensor(counts)),
                                  jupd.eps_spent(jnp.asarray(counts)))
    assert tupd.budget_stopped(torch.as_tensor(counts)) == jupd.budget_stopped(counts) == 4
    assert conv.cfg.mechanism == "gaussian" and conv.cfg.delta_step == 1e-6


# ---------------------------------------------------------------------------
# Counterparts of tests/test_sim_engine.py's DP tests
# ---------------------------------------------------------------------------


def test_dp_budget_stop_parity_with_dp_cd():
    ref, port = _logistic()
    n = port.n
    planned_Ti = 3
    cfg = _tcfg(eps_bar=0.8)
    wake = np.concatenate([np.tile(np.arange(n), planned_Ti), np.arange(n - 1)])
    seq = tdp.run_private(port, np.zeros((n, port.p)), len(wake), cfg,
                          np.random.default_rng(0), wake_sequence=wake,
                          record_objective=False, device="cpu")
    upd = DPCDUpdate.plan(port, cfg, planned_Ti=planned_Ti)
    assert upd.planned_Ti == len(wake) // n
    eng = AsyncEngine(upd, slot_wakes=float(n), seed=0, device="cpu")
    state = _forced(eng, np.zeros((n, port.p)), [np.ones(n, dtype=bool)] * 5)
    assert state.ustate.dtype == torch.int32
    np.testing.assert_array_equal(state.ustate.numpy(), np.full(n, planned_Ti))
    eps = upd.eps_spent(state.ustate)
    np.testing.assert_allclose(eps, seq.eps_spent, rtol=1e-10)
    assert np.all(eps <= cfg.eps_bar + 1e-9)
    assert upd.budget_stopped(state.ustate) == n


def test_dp_exhausted_agents_freeze():
    _, port = _logistic(seed=1)
    n = port.n
    upd = DPCDUpdate.plan(port, _tcfg(eps_bar=0.5), planned_Ti=2)
    eng = AsyncEngine(upd, slot_wakes=float(n), seed=0, device="cpu")
    state = _forced(eng, np.zeros((n, port.p)), [np.ones(n, dtype=bool)] * 2)
    frozen = state.Theta.clone()
    msgs = float(state.messages)
    state = eng.step(state, np.ones(n, dtype=bool))  # budget spent: no-ops
    assert torch.equal(state.Theta, frozen)
    assert float(state.messages) == msgs
    assert int(state.applied) == 2 * n


def test_dp_plan_rejects_prop2_schedule():
    _, port = _logistic(seed=2)
    with pytest.raises(NotImplementedError):
        DPCDUpdate.plan(port, _tcfg(eps_bar=0.5, schedule="prop2"), planned_Ti=3)


def test_fused_dp_parity_including_budget_stop():
    """Fused route (the kernel's plain version here) against the unfused
    one: the same generator gives both the same draws, and agents freeze
    after planned_Ti wakes on both."""
    _, port = _quad(24, seed=2)
    n = port.n
    masks = [np.ones(n, bool)] * 5  # 5 all-wake slots > planned_Ti = 3
    runs = {}
    for fused in (False, True):
        upd = DPCDUpdate.plan(port, _tcfg(eps_bar=0.8), planned_Ti=3)
        eng = AsyncEngine(upd, slot_wakes=float(n), fused=fused, device="cpu")
        assert eng.fused == fused
        runs[fused] = _forced(eng, np.zeros((n, port.p)), masks)
    np.testing.assert_allclose(runs[True].Theta.numpy(), runs[False].Theta.numpy(),
                               rtol=0, atol=FUSED_TOL)
    assert torch.equal(runs[True].ustate, runs[False].ustate)
    assert torch.equal(runs[True].ustate, torch.full((n,), 3, dtype=torch.int32))
    assert int(runs[True].applied) == int(runs[False].applied) == 3 * n


def test_sampled_private_runs_are_seeded_and_stop_agents():
    _, port = _quad(40, seed=6)
    # planned_Ti: the expected wakes per agent over the run (30 * 10 / 40).
    upd = DPCDUpdate.plan(port, _tcfg(eps_bar=0.5), planned_Ti=7)
    res = [AsyncEngine(upd, slot_wakes=10.0, seed=s, device="cpu").run(
        np.zeros((40, port.p)), slots=30) for s in (1, 1, 2)]
    np.testing.assert_array_equal(res[0].Theta, res[1].Theta)
    assert np.abs(res[0].Theta - res[2].Theta).max() > 0
    stopped = upd.budget_stopped(res[0].update_state)
    assert 0 < stopped < 40
    assert res[0].wakes_applied == int(res[0].update_state.sum())
    assert np.isfinite(res[0].Theta).all()


def test_dp_state_carries_across_from_reference():
    """Advance the reference engine with a private update, carry Theta and
    the counts over, continue both on the same wake sets: the budget
    bookkeeping matches exactly (the noise differs, so Theta is held to
    finiteness only)."""
    ref, port = _quad(20, seed=7)
    n = ref.n
    jupd = jsim.DPCDUpdate.plan(ref, DPConfig(eps_bar=0.5), planned_Ti=3)
    tupd = dp_update_from_reference(jupd)
    rng = np.random.default_rng(8)
    masks = [rng.random(n) < 0.5 for _ in range(8)]
    je = jsim.AsyncEngine(jupd, slot_wakes=10.0)
    te = AsyncEngine(tupd, slot_wakes=10.0, device="cpu")
    js = _forced(je, np.zeros((n, ref.p)), masks[:4])
    leaves = {k: np.asarray(getattr(js, k))
              for k in ("Theta", "hist", "ptr", "active", "applied", "dropped", "messages",
                        "ustate")}
    ts = sim_state_from_numpy(**leaves, device="cpu", seed=5)
    assert ts.ustate.dtype == torch.int32
    js, ts = _forced(je, None, masks[4:], js), _forced(te, None, masks[4:], ts)
    back = sim_state_to_numpy(ts)
    np.testing.assert_array_equal(back["ustate"], np.asarray(js.ustate))
    assert back["ustate"].dtype == np.int32
    assert back["applied"] == int(js.applied)
    assert back["messages"] == float(js.messages)
    np.testing.assert_array_equal(tupd.eps_spent(ts.ustate), jupd.eps_spent(js.ustate))
    assert np.isfinite(back["Theta"]).all()
    with pytest.raises(TypeError, match="ustate"):
        sim_state_from_numpy(**{**leaves, "ustate": np.zeros(n)}, device="cpu")


# ---------------------------------------------------------------------------
# PropagationUpdate in the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mix_mode", ["dense", "sparse"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_propagation_forced_wakes_match_reference(mix_mode, dtype):
    ref, port = _quad(30, seed=9, mix_mode=mix_mode)
    n, p = ref.n, ref.p
    loc = np.random.default_rng(10).normal(size=(n, p))
    jupd = jsim.PropagationUpdate(ref.graph, loc, 0.4, ref.confidences, mix_mode=mix_mode)
    tupd = PropagationUpdate(port.graph, loc, 0.4, port.confidences, mix_mode=mix_mode)
    rng = np.random.default_rng(11)
    masks = [rng.random(n) < 0.3 for _ in range(15)]
    je = jsim.AsyncEngine(jupd, slot_wakes=8.0, dtype=jnp.dtype(dtype))
    te = AsyncEngine(tupd, slot_wakes=8.0, dtype=getattr(torch, dtype), device="cpu")
    assert not te.fused and tupd.init_state() == ()
    js, ts = _forced(je, loc, masks), _forced(te, loc, masks)
    tol = TOL64 if dtype == "float64" else TOL32
    np.testing.assert_allclose(_np(ts.Theta), np.asarray(js.Theta), rtol=tol, atol=tol)
    assert int(ts.applied) == int(js.applied)
    np.testing.assert_allclose(tupd.objective(ts.Theta), jupd.objective(js.Theta), rtol=tol)


def test_propagation_engine_reaches_the_exact_solve():
    ref, port = _quad(24, seed=12)
    loc = np.random.default_rng(13).normal(size=(24, port.p))
    upd = PropagationUpdate(port.graph, loc, 0.4, port.confidences)
    res = AsyncEngine(upd, slot_wakes=6.0, seed=1, dtype=torch.float64, device="cpu").run(
        loc, slots=600, record_every=100)
    from repro_torch.core.model_propagation import propagation_objective

    _, solve = propagation_objective(port.graph, loc, 0.4, port.confidences)
    assert np.abs(res.Theta - solve()).max() < 1e-6
    assert np.all(np.diff(res.objective) <= 1e-12)

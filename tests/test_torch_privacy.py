"""repro_torch.core.privacy, local_dp and dp_cd against the reference.

The accounting and local perturbation are numpy in both packages: their
arrays must be bit-equal. ``run_private`` runs its tick loop in float32 in
both, so with the reference's ``jax.random`` draws injected as
``noise_draws`` Theta and Q agree to 1e-5 (float32 reduction order over T
ticks); noise scales are bit-equal and the composed spend agrees to 1e-12.
The rest holds the port to the reference's own DP tests
(``tests/test_dp_accounting.py``, ``tests/test_privacy.py``) and checks
the port's one Laplace draw: finite at both ends of its uniform input,
and Laplace(0, 1) in distribution.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dp_cd as jdp
import repro.core.local_dp as jldp
import repro.core.privacy as jpriv
import repro_torch.core.dp_cd as tdp
import repro_torch.core.local_dp as tldp
import repro_torch.core.privacy as tpriv
from repro.core import AgentData, erdos_renyi_graph, make_objective
from repro.data.synthetic import linear_classification_problem
from repro_torch.convert import objective_from_reference
from repro_torch.core import run_scan
from repro_torch.core.coordinate_descent import laplace_from_uniform, standard_laplace

TOL32 = 1e-5


def _problem(n=10, p=3, m=4, seed=0, loss="logistic", clip=None, mu=0.3):
    rng = np.random.default_rng(seed)
    graph = erdos_renyi_graph(n, 0.5, rng)
    targets = rng.normal(size=(n, p))
    X = rng.normal(size=(n, m, p))
    y = np.einsum("nmp,np->nm", X, targets)
    if loss == "logistic":
        y = np.sign(y)
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), loss, mu=mu,
                         clip=clip)
    return ref, objective_from_reference(ref)


def _cfgs(**kw):
    return jdp.DPConfig(**kw), tdp.DPConfig(**kw)


# ---------------------------------------------------------------------------
# The standard Laplace draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_laplace_transform_is_finite_at_both_ends(dtype):
    eps = torch.finfo(dtype).eps
    u = torch.tensor([-1.0, -1.0 + eps, 0.0, 1.0 - eps, 1.0], dtype=dtype)
    z = laplace_from_uniform(u)
    assert bool(torch.isfinite(z).all())
    assert float(z[0]) == float(z[1]) == -float(z[3]) == -float(z[4]) > 15.0
    assert float(z[2]) == 0.0
    # Inside the interval it is the transform of jax.random.laplace.
    v = torch.linspace(-0.999, 0.999, 41, dtype=dtype)
    w = v.double().numpy()
    np.testing.assert_allclose(laplace_from_uniform(v).double().numpy(),
                               np.sign(w) * np.log1p(-np.abs(w)), rtol=1e-6)


def test_laplace_draws_are_standard_laplace():
    """10^6 draws of the recipe run_scan, run_private and DPCDUpdate share:
    mean within 5 sigma of 0, variance within 5 sigma of 2, none infinite."""
    n = 10**6
    gen = torch.Generator().manual_seed(123)
    z = standard_laplace((n,), gen, torch.device("cpu"), torch.float32).double()
    assert bool(torch.isfinite(z).all())
    mean, var = float(z.mean()), float(z.var())
    assert abs(mean) < 5 * np.sqrt(2.0 / n)
    assert abs(var - 2.0) < 5 * np.sqrt(20.0 / n)  # Var(z^2) = E z^4 - 4 = 20
    # run_scan draws from the same recipe with its seeded generator.
    ref, port = _problem(n=4, p=2, loss="quadratic", seed=9)
    wake = np.zeros(3, dtype=np.int64)
    res = run_scan(port, np.zeros((4, 2)), 3, None, wake_sequence=wake,
                   noise_scales=np.ones(3), noise_seed=7, device="cpu")
    assert np.isfinite(res.Theta).all()


# ---------------------------------------------------------------------------
# privacy.py and local_dp.py: bit-equal
# ---------------------------------------------------------------------------


def test_privacy_functions_are_bit_equal():
    rng = np.random.default_rng(0)
    steps = rng.uniform(1e-3, 0.5, size=40)
    for delta in (0.0, 1e-6, np.exp(-5.0)):
        assert tpriv.compose_kairouz(steps, delta) == jpriv.compose_kairouz(steps, delta)
        counts = rng.integers(0, 30, size=12)
        eps = rng.uniform(0.01, 0.6, size=12)
        np.testing.assert_array_equal(tpriv.compose_uniform(eps, counts, delta),
                                      jpriv.compose_uniform(eps, counts, delta))
        np.testing.assert_array_equal(tpriv.compose_uniform(0.07, counts, delta),
                                      jpriv.compose_uniform(0.07, counts, delta))
    for eps_bar, T_i in ((0.5, 1), (0.55, 10), (1.0, 37), (3.0, 300)):
        assert (tpriv.invert_uniform_budget(eps_bar, T_i, np.exp(-5.0))
                == jpriv.invert_uniform_budget(eps_bar, T_i, np.exp(-5.0)))
    assert tpriv.laplace_scale(1.3, 0.2, 7) == jpriv.laplace_scale(1.3, 0.2, 7)
    assert tpriv.gaussian_scale(1.3, 0.2, 1e-6, 7) == jpriv.gaussian_scale(1.3, 0.2, 1e-6, 7)
    np.testing.assert_array_equal(tpriv.proposition2_allocation(2.0, 500, 0.99),
                                  jpriv.proposition2_allocation(2.0, 500, 0.99))
    ticks = np.arange(0, 500, 7)
    assert (tpriv.schedule_renormalization(ticks, 500, 0.99)
            == jpriv.schedule_renormalization(ticks, 500, 0.99))
    noise_sq = rng.uniform(0, 1, size=60)
    np.testing.assert_array_equal(tpriv.theorem2_bound(3.0, 60, 10, 5.0, 1.0, 0.2, noise_sq),
                                  jpriv.theorem2_bound(3.0, 60, 10, 5.0, 1.0, 0.2, noise_sq))
    assert tpriv.uniform_noise_limit(0.3, 0.01) == jpriv.uniform_noise_limit(0.3, 0.01)
    a, b = tpriv.PrivacyAccountant(1e-3), jpriv.PrivacyAccountant(1e-3)
    for e in steps[:9]:
        a.spend(e)
        b.spend(e)
    assert a.eps_bar == b.eps_bar
    assert a.can_spend(0.1, 1.0) == b.can_spend(0.1, 1.0)
    assert a.can_spend(10.0, 1.0) == b.can_spend(10.0, 1.0)


@pytest.mark.parametrize("feature_bound", [None, 2.0])
def test_perturb_dataset_is_bit_equal(feature_bound):
    rng = np.random.default_rng(4)
    n, m, p = 6, 5, 3
    mask = (rng.random((n, m)) < 0.7).astype(float)
    X = rng.normal(size=(n, m, p)) * mask[..., None]
    y = np.sign(rng.normal(size=(n, m))) * mask
    from repro_torch.core.objective import AgentData as TAgentData

    a = jldp.perturb_dataset(AgentData(X=X, y=y, mask=mask), 0.8, np.random.default_rng(1),
                             feature_bound=feature_bound)
    b = tldp.perturb_dataset(TAgentData(X=X, y=y, mask=mask), 0.8, np.random.default_rng(1),
                             feature_bound=feature_bound)
    for k in ("X", "y", "mask"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    with pytest.raises(ValueError):
        tldp.perturb_dataset(TAgentData(X=X, y=y, mask=mask), 0.0, np.random.default_rng(1))


# ---------------------------------------------------------------------------
# dp_cd planning: equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
def test_plans_and_schedules_equal_the_reference(mechanism):
    ref, port = _problem(seed=1)
    jcfg, tcfg = _cfgs(eps_bar=0.7, mechanism=mechanism)
    l0 = ref.lipschitz_l1()
    assert port.lipschitz_l1() == l0
    m = np.maximum(ref.data.num_examples, 1.0)
    np.testing.assert_array_equal(tdp.mechanism_scales(tcfg, l0, 0.037, m),
                                  jdp.mechanism_scales(jcfg, l0, 0.037, m))
    assert tdp.mechanism_scale(tcfg, l0, 0.037, 4.0) == jdp.mechanism_scale(jcfg, l0, 0.037, 4.0)
    for planned in (1, 5):
        te, ts = tdp.uniform_noise_plan(port, tcfg, planned)
        je, js = jdp.uniform_noise_plan(ref, jcfg, planned)
        assert te == je
        np.testing.assert_array_equal(ts, js)
    n = ref.n
    wake = np.random.default_rng(3).choice(n, size=4 * n, p=np.r_[np.ones(n - 2), 0.2, 0.0]
                                           / (n - 1.8))
    for got, want in zip(tdp._uniform_tick_schedule(port, tcfg, wake, m, l0, 4),
                         jdp._uniform_tick_schedule(ref, jcfg, wake, m, l0, 4)):
        np.testing.assert_array_equal(got, want)
    ticks = np.array([0, 3, 9, 17])
    pj, pt = _cfgs(eps_bar=0.7, schedule="prop2", T_total=40)
    np.testing.assert_array_equal(pt.per_step_eps(port, ticks), pj.per_step_eps(ref, ticks))


def test_unbounded_loss_needs_a_clip():
    _, port = _problem(loss="quadratic", seed=2)
    with pytest.raises(ValueError, match="clip"):
        tdp.uniform_noise_plan(port, tdp.DPConfig(eps_bar=1.0), 3)
    with pytest.raises(ValueError, match="clip"):
        tdp.run_private(port, np.zeros((port.n, port.p)), 5, tdp.DPConfig(eps_bar=1.0),
                        np.random.default_rng(0), device="cpu")


# ---------------------------------------------------------------------------
# run_private with the reference's draws
# ---------------------------------------------------------------------------


def _reference_draws(mechanism, seed, n, T, p, wake_given):
    """The draws the reference's run_private makes from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    if not wake_given:
        rng.integers(0, n, size=T)
    key = jax.random.PRNGKey(int(rng.integers(2**31 - 1)))
    fn = jax.random.normal if mechanism == "gaussian" else jax.random.laplace
    return np.asarray(fn(key, shape=(T, p), dtype=jnp.float32))


@pytest.mark.parametrize("schedule", ["uniform", "prop2"])
@pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
@pytest.mark.parametrize("record_every", [1, 7])
def test_run_private_matches_reference(schedule, mechanism, record_every):
    ref, port = _problem(n=10, p=3, seed=5, clip=1.0)
    n, p, T = ref.n, ref.p, 45
    jcfg, tcfg = _cfgs(eps_bar=0.8, schedule=schedule, mechanism=mechanism)
    Theta0 = np.random.default_rng(6).normal(size=(n, p))
    a = jdp.run_private(ref, Theta0, T, jcfg, np.random.default_rng(11),
                        record_every=record_every)
    draws = _reference_draws(mechanism, 11, n, T, p, wake_given=False)
    b = tdp.run_private(port, Theta0, T, tcfg, np.random.default_rng(11),
                        record_every=record_every, noise_draws=draws, device="cpu")
    np.testing.assert_array_equal(b.wake_sequence, a.wake_sequence)
    assert (np.bincount(a.wake_sequence, minlength=n) > T // n).any()  # some agents stop
    np.testing.assert_array_equal(b.noise_scales, a.noise_scales)
    np.testing.assert_allclose(b.eps_spent, a.eps_spent, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(b.Theta, a.Theta, rtol=TOL32, atol=TOL32)
    np.testing.assert_allclose(b.objective, a.objective, rtol=TOL32)
    np.testing.assert_array_equal(b.messages, a.messages)


def test_run_private_given_wakes_and_no_objective():
    ref, port = _problem(n=8, p=2, seed=7)
    T = 30
    wake = np.random.default_rng(2).integers(0, 8, size=T)
    jcfg, tcfg = _cfgs(eps_bar=0.5)
    a = jdp.run_private(ref, np.zeros((8, 2)), T, jcfg, np.random.default_rng(3),
                        wake_sequence=wake, record_objective=False)
    draws = _reference_draws("laplace", 3, 8, T, 2, wake_given=True)
    b = tdp.run_private(port, np.zeros((8, 2)), T, tcfg, np.random.default_rng(3),
                        wake_sequence=wake, record_objective=False, noise_draws=draws,
                        device="cpu")
    np.testing.assert_allclose(b.Theta, a.Theta, rtol=TOL32, atol=TOL32)
    assert b.objective.shape == a.objective.shape and not b.objective.any()
    with pytest.raises(ValueError, match="noise_draws"):
        tdp.run_private(port, np.zeros((8, 2)), T, tcfg, np.random.default_rng(3),
                        noise_draws=draws[:-1], device="cpu")


def test_run_private_draws_are_seeded_from_rng():
    _, port = _problem(n=6, p=2, seed=8)
    cfg = tdp.DPConfig(eps_bar=0.5)
    runs = [tdp.run_private(port, np.zeros((6, 2)), 20, cfg, np.random.default_rng(s),
                            record_objective=False, device="cpu") for s in (1, 1, 2)]
    np.testing.assert_array_equal(runs[0].Theta, runs[1].Theta)
    assert np.abs(runs[0].Theta - runs[2].Theta).max() > 0
    assert all(np.isfinite(r.Theta).all() for r in runs)


# ---------------------------------------------------------------------------
# Counterparts of tests/test_dp_accounting.py
# ---------------------------------------------------------------------------


def _loop_schedule(obj, cfg, wake, planned_Ti):
    """The per-tick accountant loop the vectorized schedule replaced."""
    n, T = obj.n, len(wake)
    l0 = obj.lipschitz_l1()
    m = np.maximum(obj.data.num_examples, 1.0)
    cfg = dataclasses.replace(cfg, T_total=T)
    accountants = [tpriv.PrivacyAccountant(cfg.delta_bar) for _ in range(n)]
    noise_scales = np.zeros(T)
    count = np.zeros(n, dtype=int)
    per_agent = {i: cfg.per_step_eps(obj, np.nonzero(wake == i)[0][:planned_Ti])
                 for i in range(n)}
    for t in range(T):
        i = int(wake[t])
        if count[i] >= len(per_agent[i]):
            continue
        eps_t = per_agent[i][count[i]]
        noise_scales[t] = tdp.mechanism_scale(cfg, l0, eps_t, m[i])
        accountants[i].spend(eps_t)
        count[i] += 1
    return noise_scales, np.array([a.eps_bar for a in accountants])


@pytest.mark.parametrize("mechanism", ["laplace", "gaussian"])
def test_vectorized_uniform_accounting_matches_loop(mechanism):
    _, port = _problem()
    n = port.n
    cfg = tdp.DPConfig(eps_bar=0.7, mechanism=mechanism)
    T = 4 * n
    probs = np.concatenate([np.full(n - 2, 1.0), [0.2, 0.0]])
    wake = np.random.default_rng(3).choice(n, size=T, p=probs / probs.sum())
    want_scales, want_eps = _loop_schedule(port, cfg, wake, T // n)
    res = tdp.run_private(port, np.zeros((n, port.p)), T, cfg, np.random.default_rng(0),
                          wake_sequence=wake, record_objective=False, device="cpu")
    np.testing.assert_array_equal(res.noise_scales, want_scales)
    np.testing.assert_allclose(res.eps_spent, want_eps, rtol=1e-12)


def test_prop2_schedule_spends_full_budget():
    _, port = _problem(seed=2)
    cfg = tdp.DPConfig(eps_bar=0.5, schedule="prop2")
    res = tdp.run_private(port, np.zeros((port.n, port.p)), 3 * port.n, cfg,
                          np.random.default_rng(1), record_objective=False, device="cpu")
    woke = np.bincount(res.wake_sequence, minlength=port.n) > 0
    np.testing.assert_allclose(res.eps_spent[woke], cfg.eps_bar, rtol=1e-6)


# ---------------------------------------------------------------------------
# Counterparts of tests/test_privacy.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eps_step,k,delta", [(1e-3, 0, 0.0), (0.05, 1, 1e-6),
                                              (0.3, 17, np.exp(-5.0)), (1.0, 50, 1e-6)])
def test_compose_uniform_matches_kairouz(eps_step, k, delta):
    want = tpriv.compose_kairouz(np.full(k, eps_step), delta)
    np.testing.assert_allclose(tpriv.compose_uniform(eps_step, np.array([k]), delta), [want],
                               rtol=1e-12, atol=1e-15)


def test_composition_and_allocation_properties():
    assert tpriv.compose_kairouz(np.array([0.5]), 0.0) == pytest.approx(0.5)
    assert tpriv.compose_kairouz(np.array([0.5]), 1e-3) <= 0.5 + 1e-12
    assert tpriv.compose_kairouz(np.full(200, 0.05), 1e-5) < 10.0
    for eps_bar, T_i in ((0.05, 1), (0.5, 11), (2.0, 300)):
        e = tpriv.invert_uniform_budget(eps_bar, T_i, np.exp(-5.0))
        assert tpriv.compose_kairouz(np.full(T_i, e), np.exp(-5.0)) <= eps_bar + 1e-9
        assert e >= eps_bar / T_i - 1e-12
    assert tpriv.laplace_scale(1.0, 0.5, 10) == pytest.approx(0.4)
    sched = tpriv.proposition2_allocation(2.0, T=500, C=0.99)
    assert sched.sum() == pytest.approx(2.0, rel=1e-9) and np.all(np.diff(sched) < 0)
    assert 0 < tpriv.schedule_renormalization(np.arange(0, 500, 5), 500, 0.99) <= 1.0 + 1e-12
    acc = tpriv.PrivacyAccountant(delta_bar=1e-3)
    for _ in range(5):
        acc.spend(0.1)
    assert acc.eps_bar <= 0.5 + 1e-12
    assert acc.can_spend(0.1, budget=1.0) and not acc.can_spend(10.0, budget=1.0)


@pytest.fixture(scope="module")
def fig2_problem():
    prob = linear_classification_problem(n=10, p=6, m_low=50, m_high=100, seed=7)
    ref = make_objective(prob.graph, prob.train, "logistic", mu=0.3, clip=1.0)
    return prob, ref, objective_from_reference(ref)


def test_private_cd_respects_budget(fig2_problem):
    _, _, port = fig2_problem
    cfg = tdp.DPConfig(eps_bar=1.0, delta_bar=np.exp(-5.0))
    res = tdp.run_private(port, np.zeros((port.n, port.p)), 200, cfg,
                          np.random.default_rng(0), device="cpu")
    assert np.all(res.eps_spent <= 1.0 + 1e-9) and np.all(res.eps_spent > 0)


def test_private_improves_then_pays_noise_cost(fig2_problem):
    """Fig. 2(a): the private run descends early and never beats the
    non-private one on the same wakes."""
    _, _, port = fig2_problem
    T = 100
    rng = np.random.default_rng(2)
    wake = rng.integers(0, port.n, size=T)
    Theta0 = 2.0 * np.ones((port.n, port.p))
    nonpriv = run_scan(port, Theta0, T, rng, wake_sequence=wake, device="cpu")
    priv = tdp.run_private(port, Theta0, T, tdp.DPConfig(eps_bar=1.0),
                           np.random.default_rng(3), wake_sequence=wake, device="cpu")
    q0 = priv.objective[0]
    descent = q0 - nonpriv.objective.min()
    assert descent > 0
    assert q0 - priv.objective.min() > 0.25 * descent
    assert priv.objective.min() >= nonpriv.objective.min() - 1e-6


def test_theorem2_bound_holds(fig2_problem):
    """Mean gap of the noisy loop (6 seeds) below Thm. 2's bound."""
    prob, _, _ = fig2_problem
    X = prob.train.X
    y = np.einsum("nmp,np->nm", X, prob.targets) * prob.train.mask
    ref = make_objective(prob.graph, AgentData(X=X, y=y, mask=prob.train.mask), "quadratic",
                         mu=0.3, clip=1.0)
    port = objective_from_reference(ref)
    q_star = float(port.value(torch.as_tensor(port.solve_exact())))
    T, n, p = 150, port.n, port.p
    scales = 2.0 * port.lipschitz_l1() / (0.5 * np.maximum(port.data.num_examples, 1.0))
    gaps = []
    for s in range(6):
        rng = np.random.default_rng(50 + s)
        wake = rng.integers(0, n, size=T)
        res = run_scan(port, np.zeros((n, p)), T, rng, wake_sequence=wake,
                       noise_scales=scales[wake], device="cpu", dtype=torch.float64)
        gaps.append(res.objective - q_star)
    mean_gap = np.mean(gaps, axis=0)
    L = port.block_lipschitz()
    noise_sq = np.full(T, p * np.sum((port.mu * port.degrees * port.confidences * scales) ** 2))
    bound = tpriv.theorem2_bound(mean_gap[0], T, n, float(L.max()), float(L.min()),
                                 port.strong_convexity(), noise_sq)
    assert np.all(mean_gap <= bound * 1.5 + 1e-6)

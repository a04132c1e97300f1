"""repro_torch.core.coordinate_descent against repro.core.coordinate_descent.

``run`` and ``run_scan`` with the same numpy wake sequence: both packages
run them in float32, so Theta and Q agree to 1e-5 (float32 reduction
order over T ticks) and the message counts exactly. The float64 paths
(``synchronous_round``, ``cd_update``, the Eq. 4 row batch) agree to
1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.coordinate_descent as jcd
import repro_torch.core.coordinate_descent as tcd
from repro.core import AgentData, knn_graph, make_objective
from repro_torch.convert import objective_from_reference

TOL32 = 1e-5
TOL64 = 1e-10


def _problem(n=20, p=4, m=3, seed=0, mix_mode="sparse", loss="quadratic"):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 6)), k=5)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = rng.normal(size=(n, m))
    if loss == "logistic":
        y = np.sign(y)
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), loss, mu=0.5,
                         mix_mode=mix_mode)
    return ref, objective_from_reference(ref), rng


@pytest.mark.parametrize("mix_mode", ["dense", "sparse"])
@pytest.mark.parametrize("record_every", [1, 7])
def test_run_matches_reference(mix_mode, record_every):
    ref, port, rng = _problem(mix_mode=mix_mode)
    wake = jcd.sample_wake_sequence(ref.n, 40, rng)
    Theta0 = rng.normal(size=(ref.n, ref.p))
    a = jcd.run(ref, Theta0, 40, None, record_every=record_every, wake_sequence=wake)
    b = tcd.run(port, Theta0, 40, None, record_every=record_every, wake_sequence=wake,
                device="cpu")
    np.testing.assert_allclose(b.Theta, a.Theta, rtol=TOL32, atol=TOL32)
    np.testing.assert_allclose(b.objective, a.objective, rtol=TOL32)
    np.testing.assert_array_equal(b.messages, a.messages)
    np.testing.assert_array_equal(b.wake_sequence, a.wake_sequence)


@pytest.mark.parametrize("loss", ["quadratic", "logistic"])
def test_run_scan_matches_reference(loss):
    ref, port, rng = _problem(loss=loss, seed=1)
    wake = rng.integers(0, ref.n, size=50)
    Theta0 = np.zeros((ref.n, ref.p))
    a = jcd.run_scan(ref, Theta0, 50, None, record_every=10, wake_sequence=wake)
    b = tcd.run_scan(port, Theta0, 50, None, record_every=10, wake_sequence=wake, device="cpu")
    np.testing.assert_allclose(b.Theta, a.Theta, rtol=TOL32, atol=TOL32)
    np.testing.assert_allclose(b.objective, a.objective, rtol=TOL32)
    np.testing.assert_array_equal(b.messages, a.messages)
    c = tcd.run_scan(port, Theta0, 50, None, wake_sequence=wake, device="cpu",
                     record_objective=False)
    assert len(c.objective) == 51 and not c.objective.any()
    np.testing.assert_array_equal(c.Theta, b.Theta)


def test_run_scan_noise_is_seeded_and_zero_scale_is_exact():
    ref, port, rng = _problem(seed=2)
    wake = rng.integers(0, ref.n, size=30)
    zeros = np.zeros((ref.n, ref.p))
    plain = tcd.run_scan(port, zeros, 30, None, wake_sequence=wake, device="cpu")
    silent = tcd.run_scan(port, zeros, 30, None, wake_sequence=wake, device="cpu",
                          noise_scales=np.zeros(30), noise_seed=1)
    np.testing.assert_array_equal(silent.Theta, plain.Theta)
    n1 = tcd.run_scan(port, zeros, 30, None, wake_sequence=wake, device="cpu",
                      noise_scales=np.full(30, 0.1), noise_seed=1)
    n2 = tcd.run_scan(port, zeros, 30, None, wake_sequence=wake, device="cpu",
                      noise_scales=np.full(30, 0.1), noise_seed=1)
    np.testing.assert_array_equal(n1.Theta, n2.Theta)
    assert np.abs(n1.Theta - plain.Theta).max() > 1e-4


@pytest.mark.parametrize("mix_mode", ["dense", "sparse"])
def test_float64_steps_match_reference(mix_mode):
    ref, port, rng = _problem(mix_mode=mix_mode, seed=3)
    Theta = rng.normal(size=(ref.n, ref.p))
    jt, tt = jnp.asarray(Theta), torch.as_tensor(Theta)
    np.testing.assert_allclose(tcd.synchronous_round(port, tt).numpy(),
                               np.asarray(jcd.synchronous_round(ref, jt)), rtol=TOL64, atol=TOL64)
    np.testing.assert_allclose(tcd.cd_update(port, tt, 4).numpy(),
                               np.asarray(jcd.cd_update(ref, jt, 4)), rtol=TOL64, atol=TOL64)
    assert np.array_equal(tt.numpy(), Theta)  # cd_update leaves its input alone
    rows = np.array([1, 4, 9, ref.n], dtype=np.int32)  # with the sentinel n
    neigh = rng.normal(size=(4, ref.p))
    got = tcd.eq4_rows(port, tt, torch.as_tensor(rows), torch.as_tensor(neigh)).numpy()
    want = np.asarray(jcd.eq4_rows(ref, jt, jnp.asarray(rows), jnp.asarray(neigh)))
    np.testing.assert_allclose(got, want, rtol=TOL64, atol=TOL64)
    for k, v in tcd.eq4_agent_constants(port).items():
        np.testing.assert_array_equal(v, jcd.eq4_agent_constants(ref)[k])


def test_sequential_helpers_match_reference():
    ref, port, _ = _problem(seed=4)
    a = tcd.sample_wake_sequence(20, 15, np.random.default_rng(9))
    b = jcd.sample_wake_sequence(20, 15, np.random.default_rng(9))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(tcd.proposition1_bound(port, 2.0, 30),
                               jcd.proposition1_bound(ref, 2.0, 30), rtol=1e-12)


def test_run_reaches_exact_optimum():
    ref, port, rng = _problem(n=12, seed=5)
    star = port.solve_exact()
    res = tcd.run(port, np.zeros((12, 4)), 2000, rng, record_every=500, device="cpu",
                  dtype=torch.float64)
    assert np.abs(res.Theta - star).max() < 1e-6
    assert np.all(np.diff(res.objective) <= 1e-12)


def test_run_defaults_to_cuda(monkeypatch):
    _, port, rng = _problem(n=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcd.run(port, np.zeros((8, 4)), 3, rng)

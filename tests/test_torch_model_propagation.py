"""repro_torch.core.model_propagation against repro.core.model_propagation.

The sequential propagation, Q_MP and the output perturbation are numpy
in both packages: bit-equal under the same ``rng`` (the exact solve to
1e-12). The batched Eq. 16 row step agrees to 1e-12 in float64. The
local models train in float32 in both (the reference by ``jax.grad`` of
a ``lax.scan``, the port with the gradient written out), so they and the
private warm start built on them agree to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.model_propagation as jmp
import repro_torch.core.model_propagation as tmp
from repro.core import AgentData, knn_graph, make_objective
from repro.core.objective import LOSSES as JLOSSES
from repro_torch.convert import objective_from_reference
from repro_torch.core.objective import LOSSES as TLOSSES

TOL32 = 1e-5
TOL64 = 1e-12


def _problem(n=16, p=3, m=5, seed=0, loss="quadratic", mix_mode="sparse"):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 4)), k=4)
    mask = (rng.random((n, m)) < 0.8).astype(float)
    mask[:, 0] = 1.0
    X = rng.normal(size=(n, m, p)) / np.sqrt(p) * mask[..., None]
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p))) * mask
    if loss == "logistic":
        y = np.sign(y) * mask
    ref = make_objective(graph, AgentData(X=X, y=y, mask=mask), loss, mu=0.4,
                         clip=1.0 if loss == "quadratic" else None, mix_mode=mix_mode)
    return ref, objective_from_reference(ref), rng


def test_propagation_objective_and_update_equal_the_reference():
    ref, port, rng = _problem()
    loc = rng.normal(size=(ref.n, ref.p))
    Theta = rng.normal(size=(ref.n, ref.p))
    jv, js = jmp.propagation_objective(ref.graph, loc, 0.4, ref.confidences)
    tv, ts = tmp.propagation_objective(port.graph, loc, 0.4, port.confidences)
    assert tv(Theta) == jv(Theta)
    np.testing.assert_allclose(ts(), js(), rtol=TOL64, atol=TOL64)
    for i in (0, 5, ref.n - 1):
        np.testing.assert_array_equal(
            tmp.propagation_update(port.graph, Theta, loc, 0.4, port.confidences, i),
            jmp.propagation_update(ref.graph, Theta, loc, 0.4, ref.confidences, i))


def test_propagation_rows_match_the_reference():
    ref, port, rng = _problem(seed=1)
    n, p = ref.n, ref.p
    loc = rng.normal(size=(n, p))
    rows = np.array([3, 0, 11, n, n], dtype=np.int32)  # with sentinels
    neigh = rng.normal(size=(5, p))
    want = np.asarray(jmp.propagation_rows(ref.graph.degrees, loc, 0.4, ref.confidences,
                                           jnp.asarray(rows), jnp.asarray(neigh)))
    got = tmp.propagation_rows(port.graph.degrees, loc, 0.4, port.confidences,
                               torch.as_tensor(rows), torch.as_tensor(neigh))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL64, atol=TOL64)
    safe = np.minimum(rows, n - 1)
    d, c = ref.graph.degrees[safe], ref.confidences[safe]
    want_from = np.asarray(jmp.propagation_rows_from(0.4, d, c, loc[safe], jnp.asarray(neigh)))
    got_from = tmp.propagation_rows_from(0.4, d, c, loc[safe], torch.as_tensor(neigh))
    np.testing.assert_allclose(got_from.numpy(), want_from, rtol=TOL64, atol=TOL64)


def test_run_propagation_is_bit_equal_and_reaches_the_solve():
    ref, port, rng = _problem(seed=2)
    loc = rng.normal(size=(ref.n, ref.p))
    a = jmp.run_propagation(ref.graph, loc, 0.4, ref.confidences, 300, np.random.default_rng(4))
    b = tmp.run_propagation(port.graph, loc, 0.4, port.confidences, 300,
                            np.random.default_rng(4))
    np.testing.assert_array_equal(b, a)
    _, solve = tmp.propagation_objective(port.graph, loc, 0.4, port.confidences)
    long = tmp.run_propagation(port.graph, loc, 0.4, port.confidences, 4000,
                               np.random.default_rng(5))
    assert np.abs(long - solve()).max() < 1e-6


@pytest.mark.parametrize("loss", ["quadratic", "logistic"])
def test_train_local_models_matches_reference(loss):
    ref, port, _ = _problem(seed=3, loss=loss)
    want = jmp.train_local_models(ref.data, JLOSSES[loss], ref.lambdas)
    got = tmp.train_local_models(port.data, TLOSSES[loss], port.lambdas, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL32, atol=TOL32)
    short = tmp.train_local_models(port.data, TLOSSES[loss], port.lambdas, steps=20, lr=0.1,
                                   device="cpu")
    np.testing.assert_allclose(
        short, jmp.train_local_models(ref.data, JLOSSES[loss], ref.lambdas, steps=20, lr=0.1),
        rtol=TOL32, atol=TOL32)


def test_private_local_models_is_bit_equal():
    ref, port, rng = _problem(seed=4)
    loc = rng.normal(size=(ref.n, ref.p)).astype(np.float32)
    a = jmp.private_local_models(loc, 1.0, ref.lambdas, ref.data.num_examples, 0.5,
                                 np.random.default_rng(9))
    b = tmp.private_local_models(loc, 1.0, port.lambdas, port.data.num_examples, 0.5,
                                 np.random.default_rng(9))
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("ticks", [None, 37])
def test_private_warm_start_matches_reference(ticks):
    ref, port, _ = _problem(seed=5)
    a = jmp.private_warm_start(ref, 0.5, np.random.default_rng(6), propagation_ticks=ticks)
    b = tmp.private_warm_start(port, 0.5, np.random.default_rng(6), propagation_ticks=ticks,
                               device="cpu")
    np.testing.assert_allclose(b, a, rtol=TOL32, atol=TOL32)


def test_train_local_models_defaults_to_cuda(monkeypatch):
    _, port, _ = _problem(seed=6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmp.train_local_models(port.data, port.loss, port.lambdas)

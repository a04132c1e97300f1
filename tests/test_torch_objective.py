"""repro_torch.core.objective against repro.core.objective in float64.

Tolerance 1e-10 (float64 on both sides; the two differ only in summation
order). Both losses, with and without the per-point L1 clip, dense and
sparse neighbour sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AgentData, knn_graph, make_objective
from repro_torch.convert import objective_from_reference

TOL = 1e-10


def _problem(loss, clip, mix_mode, n=30, p=5, m=6, seed=0):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 4)), k=4)
    X = rng.normal(size=(n, m, p))
    mask = (rng.random((n, m)) < 0.8).astype(np.float64)
    mask[:, 0] = 1.0
    if loss == "logistic":
        y = np.sign(rng.normal(size=(n, m)))
    else:
        y = rng.normal(size=(n, m))
    data = AgentData(X=X, y=y, mask=mask)
    ref = make_objective(graph, data, loss, mu=0.7, clip=clip, mix_mode=mix_mode)
    return ref, objective_from_reference(ref), rng.normal(size=(n, p))


CASES = [
    (loss, clip, mode)
    for loss in ("quadratic", "logistic")
    for clip in (None, 0.5)
    for mode in ("dense", "sparse")
]


@pytest.mark.parametrize("loss,clip,mix_mode", CASES)
def test_values_and_gradients_match_reference(loss, clip, mix_mode):
    ref, port, Theta = _problem(loss, clip, mix_mode)
    jt, tt = jnp.asarray(Theta), torch.as_tensor(Theta)
    assert port.mix.kind == ref.mix.kind == mix_mode
    np.testing.assert_allclose(float(port.value(tt)), float(ref.value(jt)), rtol=TOL, atol=TOL)
    for name in ("local_loss", "local_grad", "block_grad"):
        got = getattr(port, name)(tt).numpy()
        want = np.asarray(getattr(ref, name)(jt))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("loss,clip", [("quadratic", None), ("logistic", 0.5)])
def test_theory_constants_match_reference(loss, clip):
    ref, port, _ = _problem(loss, clip, "sparse")
    for name in ("alphas", "block_lipschitz", "local_smoothness", "local_strong_convexity"):
        np.testing.assert_allclose(getattr(port, name)(), getattr(ref, name)(), rtol=TOL)
    for name in ("contraction", "strong_convexity", "lipschitz_l1"):
        np.testing.assert_allclose(getattr(port, name)(), getattr(ref, name)(), rtol=TOL)
    np.testing.assert_array_equal(port.degrees, ref.degrees)


@pytest.mark.parametrize("mix_mode", ["dense", "sparse"])
def test_solve_exact_matches_reference_and_zeroes_gradient(mix_mode):
    ref, port, _ = _problem("quadratic", None, mix_mode, n=20, p=3)
    star = port.solve_exact()
    np.testing.assert_allclose(star, ref.solve_exact(), rtol=TOL, atol=TOL)
    assert np.abs(port.block_grad(torch.as_tensor(star)).numpy()).max() < 1e-9
    with pytest.raises(ValueError, match="quadratic"):
        _problem("logistic", None, mix_mode)[1].solve_exact()


def test_block_grad_is_the_gradient_of_value():
    """Autograd of Q(Theta) equals the explicit block gradient (Eq. 3)."""
    for loss in ("quadratic", "logistic"):
        _, port, Theta = _problem(loss, None, "sparse", n=12)
        tt = torch.as_tensor(Theta).requires_grad_(True)
        port.value(tt).backward()
        np.testing.assert_allclose(tt.grad.numpy(), port.block_grad(torch.as_tensor(Theta)).numpy(),
                                   rtol=1e-9, atol=1e-9)
    assert port.data.num_examples.shape == (12,)


def test_device_copies_are_cached_per_dtype():
    _, port, _ = _problem("quadratic", None, "sparse", n=10)
    a = port.tensors("cpu", torch.float32)
    assert port.tensors("cpu", torch.float32) is a
    b = port.tensors("cpu", torch.float64)
    assert b["X"].dtype == torch.float64 and a["X"].dtype == torch.float32
    assert b["X"].shape == (10, 6, 5)

"""Property tests (hypothesis): dense/sparse mixing and CD trajectories on
random graphs, the port against the reference.

Counterpart of ``tests/test_sparse_properties.py``, on the same generated
graphs and with its example counts (25 and 10): the port's dense and
sparse ``MixOp`` agree with each other at the reference's tolerances
(float32: 1e-5 for the sums, 1e-4 for the smoothness term) and with the
reference's sparse operator on the same float32 Theta within 1e-5; whole
coordinate-descent trajectories (dense and sparse, forced wake
sequences) agree with each other at the reference's tolerances and with
the reference's sparse trajectory within 1e-5 (both run the scan in
float32; the port's float32 bound, ``src/repro_torch/DEVIATIONS.md``).
The reference runs one mode per example, its sparse one, so the file
costs about half the reference file's JAX compilations.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="hypothesis not installed (see requirements-dev.txt)")
import jax.numpy as jnp
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as jcore
from repro_torch.core import AgentData, AgentGraph, make_objective, mix_op, run_scan


def random_weights(n: int, density: float, seed: int) -> np.ndarray:
    """The reference's random symmetric weighted graph, every degree >= 1."""
    rng = np.random.default_rng(seed)
    upper = np.triu((rng.random((n, n)) < density) * rng.random((n, n)), 1)
    w = upper + upper.T
    for i in range(n):  # guarantee D_ii > 0
        if w[i].sum() == 0.0:
            j = (i + 1) % n
            w[i, j] = w[j, i] = 1.0
    return w


graph_params = st.tuples(
    st.integers(min_value=2, max_value=24),  # n
    st.floats(min_value=0.05, max_value=0.9),  # density
    st.integers(min_value=0, max_value=2**31 - 1),  # seed
)


@settings(max_examples=25, deadline=None)
@given(graph_params, st.integers(min_value=1, max_value=64))
def test_mix_parity_on_random_graphs(params, p):
    n, density, seed = params
    w = random_weights(n, density, seed)
    g = AgentGraph(w)
    theta = np.random.default_rng(seed ^ 0xABCDEF).normal(size=(n, p)).astype(np.float32)
    Theta = torch.as_tensor(theta)
    dense, sparse = mix_op(g, mode="dense"), mix_op(g, mode="sparse")
    np.testing.assert_allclose(dense.all(Theta).numpy(), sparse.all(Theta).numpy(),
                               rtol=1e-5, atol=1e-5)
    i = seed % n
    np.testing.assert_allclose(dense.row(Theta, i).numpy(), sparse.row(Theta, i).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(dense.pairwise_smoothness(Theta)),
                               float(sparse.pairwise_smoothness(Theta)), rtol=1e-4, atol=1e-4)
    ref = jcore.mix_op(jcore.AgentGraph(w), mode="sparse")
    jt = jnp.asarray(theta, jnp.float32)
    np.testing.assert_allclose(sparse.all(Theta).numpy(), np.asarray(ref.all(jt)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sparse.row(Theta, i).numpy(), np.asarray(ref.row(jt, i)),
                               rtol=1e-5, atol=1e-5)


@settings(max_examples=10, deadline=None)
@given(graph_params, st.integers(min_value=1, max_value=60))
def test_cd_trajectory_parity_on_random_graphs(params, T):
    n, density, seed = params
    w = random_weights(n, density, seed)
    g = AgentGraph(w)
    rng = np.random.default_rng(seed)
    p, m = 4, 5
    targets = rng.normal(size=(n, p))
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    wake = rng.integers(0, n, size=T)
    data = AgentData(X=X, y=y, mask=np.ones((n, m)))
    obj_d = make_objective(g, data, "quadratic", mu=0.4, mix_mode="dense")
    obj_s = make_objective(g.to_csr(), data, "quadratic", mu=0.4, mix_mode="sparse")
    kw = dict(T=T, wake_sequence=wake, device="cpu")
    rd = run_scan(obj_d, np.zeros((n, p)), rng=np.random.default_rng(seed), **kw)
    rs = run_scan(obj_s, np.zeros((n, p)), rng=np.random.default_rng(seed), **kw)
    np.testing.assert_allclose(rd.Theta, rs.Theta, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rd.objective, rs.objective, rtol=1e-4, atol=1e-5)

    jdata = jcore.AgentData(X=X, y=y, mask=np.ones((n, m)))
    jobj = jcore.make_objective(jcore.AgentGraph(w).to_csr(), jdata, "quadratic", mu=0.4,
                                mix_mode="sparse")
    want = jcore.run_scan(jobj, np.zeros((n, p)), T=T, rng=np.random.default_rng(seed),
                          wake_sequence=wake)
    np.testing.assert_allclose(rs.Theta, np.asarray(want.Theta), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rs.objective, np.asarray(want.objective), rtol=1e-5, atol=1e-5)

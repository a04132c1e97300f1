"""repro_torch.core.mixing and the kernels' plain versions against the
reference.

* MixOp (dense and sparse) against repro.core.mixing.MixOp in float64:
  tolerance 1e-10.
* Each kernel's plain version against the JAX Pallas kernel run with
  ``interpret=True`` on the same float32 inputs: rtol = atol = 4e-6, the
  JAX suite's own bound for these kernels (float32 sums in another
  order). n <= 64 wherever a Pallas kernel runs interpreted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn_graph, mix_op
from repro.kernels import ops as jops
from repro_torch.core.graph import csr_from_coo
from repro_torch.core.mixing import kernel_auto
from repro_torch.core.mixing import mix_op as port_mix_op
from repro_torch.kernels import ops, ref

TOL64 = 1e-10
KTOL = 4e-6


def _graphs(n, seed=0):
    rng = np.random.default_rng(seed)
    g = knn_graph(rng.normal(size=(n, 5)), k=5)
    # The same graph in the port's own CSR type.
    pg = csr_from_coo(n, g.row_ids(), g.indices, g.data)
    return g, pg, rng


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_mixop_matches_reference_f64(kind):
    g, pg, rng = _graphs(40)
    jm, tm = mix_op(g, mode=kind), port_mix_op(pg, mode=kind)
    assert jm.kind == tm.kind == kind
    Theta = rng.normal(size=(40, 6))
    jt, tt = jnp.asarray(Theta), torch.as_tensor(Theta)
    np.testing.assert_allclose(tm.all(tt).numpy(), np.asarray(jm.all(jt)), rtol=TOL64, atol=TOL64)
    for i in (0, 17, 39):
        np.testing.assert_allclose(tm.row(tt, i).numpy(), np.asarray(jm.row(jt, i)),
                                   rtol=TOL64, atol=TOL64)
    # A woken batch padded with the sentinel n (gathers clamp it to n - 1).
    idx = np.array([3, 7, 8, 39, 40, 40], dtype=np.int32)
    got = tm.gather_rows(tt, torch.as_tensor(idx)).numpy()
    want = np.asarray(jm.gather_rows(jt, jnp.asarray(idx)))
    np.testing.assert_allclose(got, want, rtol=TOL64, atol=TOL64)
    np.testing.assert_allclose(float(tm.pairwise_smoothness(tt)),
                               float(jm.pairwise_smoothness(jt)), rtol=TOL64)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_mixop_kernel_route_matches_reference_kernels(kind):
    """use_kernel=True: the reference runs its Pallas kernel interpreted,
    the port its kernel wrapper, which takes the plain version for a CPU
    tensor."""
    g, pg, rng = _graphs(48, seed=1)
    jm, tm = mix_op(g, mode=kind), port_mix_op(pg, mode=kind)
    Theta = rng.normal(size=(48, 8)).astype(np.float32)
    jt, tt = jnp.asarray(Theta, jnp.float32), torch.as_tensor(Theta)
    got = tm.all(tt, use_kernel=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.all(jt, use_kernel=True)),
                               rtol=KTOL, atol=KTOL)
    idx = np.array([0, 5, 47, 48], dtype=np.int32)
    got = tm.gather_rows(tt, torch.as_tensor(idx), use_kernel=True).numpy()
    want = np.asarray(jm.gather_rows(jt, jnp.asarray(idx), use_kernel=True))
    np.testing.assert_allclose(got, want, rtol=KTOL, atol=KTOL)
    assert not kernel_auto(tt) and not kernel_auto(tt.double())


def _sparse_instance(R, n, K, p, rng):
    idx = rng.integers(0, n, size=(R, K)).astype(np.int32)
    w = rng.random((R, K)).astype(np.float32)
    w[:, -1] = 0.0  # a pad entry: weight 0
    theta = rng.normal(size=(n, p)).astype(np.float32)
    return idx, w, theta


@pytest.mark.parametrize("R,n,K,p", [(16, 16, 3, 8), (7, 64, 5, 33), (64, 64, 9, 130),
                                     (1, 10, 1, 4)])
def test_sparse_mix_plain_matches_pallas(R, n, K, p):
    rng = np.random.default_rng(R + p)
    idx, w, theta = _sparse_instance(R, n, K, p, rng)
    got = ops.sparse_mix(torch.as_tensor(idx), torch.as_tensor(w), torch.as_tensor(theta))
    want = jops.sparse_mix(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(theta), interpret=True)
    assert tuple(got.shape) == (R, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KTOL, atol=KTOL)
    # Pad entries (weight 0) contribute nothing, whatever row they point at.
    idx2 = idx.copy()
    idx2[:, -1] = 0
    again = ref.sparse_mix_ref(torch.as_tensor(idx2), torch.as_tensor(w), torch.as_tensor(theta))
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("n,p", [(16, 8), (50, 37), (64, 130)])
def test_graph_mix_plain_matches_pallas(n, p):
    rng = np.random.default_rng(n)
    A = rng.random((n, n)).astype(np.float32)
    theta = rng.normal(size=(n, p)).astype(np.float32)
    got = ops.graph_mix(torch.as_tensor(A), torch.as_tensor(theta))
    want = jops.graph_mix(jnp.asarray(A), jnp.asarray(theta), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KTOL, atol=KTOL)


def _fused_instance(B, K, m, p, nt, rng, sentinels=0):
    """Random fused-update operands; the last ``sentinels`` rows are >= limit."""
    rows = rng.choice(nt, size=B, replace=False).astype(np.int32)
    limit = nt
    if sentinels:
        rows[-sentinels:] = nt
    idx = rng.integers(0, nt, size=(B, K)).astype(np.int32)
    w = rng.random((B, K)).astype(np.float32)
    coef = np.stack(
        [
            rng.uniform(0.2, 0.9, B),  # alpha
            rng.uniform(1.0, K, B),  # degree
            rng.uniform(0.05, 0.5, B),  # mu * confidence
            rng.uniform(0.0, 0.3, B),  # 2 * lambda
        ],
        axis=1,
    ).astype(np.float32)
    X = rng.normal(size=(B, m, p)).astype(np.float32)
    y = rng.normal(size=(B, m)).astype(np.float32)
    mask = (rng.random((B, m)) < 0.8).astype(np.float32)
    noise = (rng.normal(size=(B, p)) * 0.01).astype(np.float32)
    theta = rng.normal(size=(nt, p)).astype(np.float32)
    return (rows, idx, w, coef, X, y, mask, noise, theta), limit


@pytest.mark.parametrize("B,K,m,p,nt", [(8, 4, 3, 8, 64), (17, 7, 5, 100, 64),
                                        (1, 3, 2, 128, 32), (40, 10, 4, 37, 50)])
@pytest.mark.parametrize("clip", [None, 0.7])
def test_fused_row_update_plain_matches_pallas(B, K, m, p, nt, clip):
    rng = np.random.default_rng(B + p)
    args, limit = _fused_instance(B, K, m, p, nt, rng, sentinels=2 if B > 4 else 0)
    want = jops.fused_row_update(*(jnp.asarray(a) for a in args), limit=limit, clip=clip,
                                 interpret=True)
    theta = torch.as_tensor(args[-1].copy())
    out = ops.fused_row_update(*(torch.as_tensor(a) for a in args[:-1]), theta, limit, clip)
    assert out is theta  # updated in place
    np.testing.assert_allclose(theta.numpy(), np.asarray(want), rtol=KTOL, atol=KTOL)
    # Rows never scattered (untouched and sentinel) pass through bit-identically.
    rows = args[0]
    untouched = np.setdiff1d(np.arange(nt), rows[rows < limit])
    np.testing.assert_array_equal(theta.numpy()[untouched], args[-1][untouched])


def test_fused_row_update_reads_the_start_of_call_slab():
    """Two woken rows that are each other's neighbour both read the old
    values (the snapshot rule), though the port writes in place."""
    rng = np.random.default_rng(4)
    args, limit = _fused_instance(2, 1, 2, 6, 8, rng)
    rows, idx = args[0], args[1]
    rows[:] = [2, 5]
    idx[:, 0] = [5, 2]
    want = jops.fused_row_update(*(jnp.asarray(a) for a in args), limit=limit, interpret=True)
    theta = torch.as_tensor(args[-1].copy())
    ops.fused_row_update(*(torch.as_tensor(a) for a in args[:-1]), theta, limit)
    np.testing.assert_allclose(theta.numpy(), np.asarray(want), rtol=KTOL, atol=KTOL)
    # noise=None is the zero perturbation.
    zero = list(args)
    zero[7] = np.zeros_like(args[7])
    t0 = torch.as_tensor(args[-1].copy())
    t1 = torch.as_tensor(args[-1].copy())
    ops.fused_row_update(*(torch.as_tensor(a) for a in zero[:-1]), t0, limit)
    ops.fused_row_update(*(torch.as_tensor(a) for a in zero[:7]), None, t1, limit)
    np.testing.assert_array_equal(t0.numpy(), t1.numpy())

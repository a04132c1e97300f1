"""The port's ``ssm_chunk`` (plain version and ``ssm_chunk_ad``) against the
JAX package's Pallas kernel (interpret mode) and its oracle.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: float32 1e-5 (sums over at most 128 positions and 64 state
columns, in another order than XLA's); bfloat16 inputs are widened to
float32 by both, so the same bound holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = 1e-5
SHAPES = [(2, 16, 8, 16), (4, 64, 64, 64), (1, 128, 64, 64), (3, 32, 16, 128)]


def _inputs(G, Q, N, P, seed, Gc=None):
    rng = np.random.default_rng(seed)
    Gc = G if Gc is None else Gc
    C = rng.normal(size=(Gc, Q, N)).astype(np.float32)
    B = rng.normal(size=(Gc, Q, N)).astype(np.float32)
    cum = np.cumsum(-np.abs(rng.normal(size=(G, Q)) * 0.1), axis=1).astype(np.float32)
    dt = (np.abs(rng.normal(size=(G, Q))) * 0.5).astype(np.float32)
    x = rng.normal(size=(G, Q, P)).astype(np.float32)
    return C, B, cum, dt, x


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("G,Q,N,P", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_and_oracle(G, Q, N, P, dtype):
    C, B, cum, dt, x = _inputs(G, Q, N, P, seed=G * Q + N + P)
    jd = getattr(jnp, dtype)
    jC, jB, jx = (jnp.asarray(a, jd) for a in (C, B, x))
    y_k, s_k = jops.ssm_chunk(jC, jB, jnp.asarray(cum), jnp.asarray(dt), jx, interpret=True)
    y_r, s_r = jref.ssm_chunk_ref(jC, jB, jnp.asarray(cum), jnp.asarray(dt), jx)
    td = getattr(torch, dtype)
    # The same (rounded) values on the port's side: bf16 numpy -> float32 -> bf16 is exact.
    tC, tB, tx = (torch.as_tensor(np.array(a, np.float32)).to(td) for a in (jC, jB, jx))
    y, s = ops.ssm_chunk(tC, tB, torch.as_tensor(cum), torch.as_tensor(dt), tx)
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (G, Q, P) and s.shape == (G, P, N)
    for got, pallas, oracle in ((y, y_k, y_r), (s, s_k, s_r)):
        _close(got.numpy(), pallas)
        _close(got.numpy(), oracle)
    assert ops.launch_counts()["ssm_chunk"] == 0  # CPU tensors never launch


def test_causality():
    """y at position q does not depend on x at t > q."""
    C, B, cum, dt, x = (torch.as_tensor(a) for a in _inputs(1, 32, 16, 16, seed=3))
    y1, _ = ops.ssm_chunk(C, B, cum, dt, x)
    x2 = x.clone()
    x2[:, 16:] = 999.0
    y2, _ = ops.ssm_chunk(C, B, cum, dt, x2)
    assert torch.equal(y1[:, :16], y2[:, :16])


@pytest.mark.parametrize("G,heads", [(6, 3), (64, 16), (8, 1)])
def test_head_shared_entry_matches_expanded(G, heads):
    """C and B given once per block of ``heads`` groups equal the
    reference's layout with each block repeated for every head."""
    C, B, cum, dt, x = (torch.as_tensor(a) for a in _inputs(G, 32, 16, 8, seed=G, Gc=G // heads))
    y, s = ref.ssm_chunk_ref(C, B, cum, dt, x, heads)
    Ce, Be = (t.repeat_interleave(heads, dim=0) for t in (C, B))
    y_e, s_e = ref.ssm_chunk_ref(Ce, Be, cum, dt, x)
    _close(y.numpy(), y_e.numpy())
    _close(s.numpy(), s_e.numpy())
    y_j, s_j = jref.ssm_chunk_ref(*(jnp.asarray(t.numpy()) for t in (Ce, Be, cum, dt, x)))
    _close(y.numpy(), y_j)
    _close(s.numpy(), s_j)


@pytest.mark.parametrize("heads", [1, 4])
def test_ssm_chunk_ad_gradients_match_reference_vjp(heads):
    """``ssm_chunk_ad``'s backward (the plain version's autograd) against
    ``jax.vjp`` of the reference oracle, for random cotangents."""
    G, Q, N, P = 8, 16, 8, 12
    C, B, cum, dt, x = _inputs(G, Q, N, P, seed=11, Gc=G // heads)
    rng = np.random.default_rng(12)
    gy = rng.normal(size=(G, Q, P)).astype(np.float32)
    gs = rng.normal(size=(G, P, N)).astype(np.float32)
    leaves = [torch.tensor(a, requires_grad=True) for a in (C, B, cum, dt, x)]
    y, s = ops.ssm_chunk_ad(*leaves, heads)
    torch.autograd.backward((y, s), (torch.as_tensor(gy), torch.as_tensor(gs)))
    Ce, Be = (np.repeat(a, heads, axis=0) for a in (C, B))
    (y_r, s_r), vjp = jax.vjp(jref.ssm_chunk_ref, *(jnp.asarray(a) for a in (Ce, Be, cum, dt, x)))
    gC, gB, gcum, gdt, gx = (np.asarray(g) for g in vjp((jnp.asarray(gy), jnp.asarray(gs))))
    # The expanded C and B's gradients summed over each block of heads.
    gC = gC.reshape(G // heads, heads, Q, N).sum(axis=1)
    gB = gB.reshape(G // heads, heads, Q, N).sum(axis=1)
    _close(y.detach().numpy(), y_r)
    _close(s.detach().numpy(), s_r)
    for leaf, want in zip(leaves, (gC, gB, gcum, gdt, gx)):
        _close(leaf.grad.numpy(), want)

"""The launch planning of the ssm_chunk and fused_row_update kernels, in Python.

The CUDA kernels run only on a card, but what surrounds them is planned
here and reached by these CPU tests:

* ``ssm_chunk.head_plan``: the heads per block divide ``heads`` (1 for
  ``heads = 1``), every group is computed by exactly one block, a block's
  groups share one C/B block, and the grid fills the SMs at the zamba2
  prefill; the kernel's arithmetic written out (C.B^T once per block of
  heads, reused by each) agrees with the JAX Pallas kernel in interpret
  mode at the port's 1e-5;
* ``fused_row_update.row_plan``: every woken row is computed by exactly
  one warp, the passes cover p, the float4 instance is chosen exactly
  when p % 4 == 0 and Theta, X and noise start on 16-byte boundaries,
  and the grid fills the SMs at the main path's slot; the kernel's order
  written out (only the nonzero-weight neighbours, the data points in
  chunks of 8 / passes) agrees with the JAX Pallas kernel at 4e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fused_row_update as fru
from repro_torch.kernels import ssm_chunk

KTOL = 4e-6  # the JAX suite's bound for the fused kernel
SSM_TOL = 1e-5  # tests/test_torch_ssm_chunk.py's bound
H100_SMS = 132


@pytest.mark.parametrize("heads", [1, 2, 3, 7, 16, 64])
@pytest.mark.parametrize("chunks,sms", [(1, 132), (3, 132), (64, 132), (64, 16), (5, 1)])
@pytest.mark.parametrize("Q,N,P", [(128, 64, 64), (128, 128, 128), (77, 40, 96)])
def test_head_plan_covers_every_group_once(heads, chunks, sms, Q, N, P):
    G = chunks * heads
    hg = ssm_chunk.head_plan(G, heads, sms, Q, N, P)
    assert heads % hg == 0 and 1 <= hg <= heads
    if heads == 1:
        assert hg == 1
    blocks = ssm_chunk.blocks_of(G, hg)
    assert len(blocks) == G // hg
    assert sorted(g for block in blocks for g in block) == list(range(G))  # each group once
    for block in blocks:  # one C/B block per kernel block
        assert len({g // heads for g in block}) == 1
    slots = ssm_chunk.blocks_per_sm(Q, N, P) * sms
    assert -(-(G // hg) // slots) <= -(-G // slots)  # never more waves than hg = 1


def test_head_plan_fills_the_card_at_the_prefill():
    # zamba2-1.2b prefill: 4 prompts x 16 chunks x 64 heads, two blocks an SM.
    shape = (128, 64, 64)
    assert ssm_chunk.blocks_per_sm(*shape) == 2
    hg = ssm_chunk.head_plan(4 * 16 * 64, 64, H100_SMS, *shape)
    assert hg == 16 and H100_SMS <= 4096 // hg <= 2 * H100_SMS  # one wave, every SM busy
    assert ssm_chunk.head_plan(4096, 1, H100_SMS, *shape) == 1
    assert ssm_chunk.head_plan(64 * 3, 64, H100_SMS, *shape) == 1  # 192 groups: every block counts
    with pytest.raises(ValueError, match="heads=3"):
        ssm_chunk.head_plan(4, 3, H100_SMS, *shape)


@pytest.mark.parametrize("Q,N,P,kb,per_sm", [(128, 64, 64, 105984, 2), (77, 40, 96, 79040, 1),
                                             (128, 128, 128, 171520, 1), (16, 8, 16, 5568, 2),
                                             (128, 128, 64, 138752, 1)])
def test_shared_memory_and_blocks_per_sm(Q, N, P, kb, per_sm):
    """The kernel's layout (phase 3 of chip_smoke.py holds it to the C
    function's): under the 227 KB a block may take up to Q = N = P = 128,
    and two blocks an SM at the prefill shape."""
    assert ssm_chunk.smem_bytes(Q, N, P) == kb <= 232448
    assert ssm_chunk.blocks_per_sm(Q, N, P) == per_sm


def _ssm_kernel_order(C, B, cum, dt, x, heads, hg):
    """csrc/ssm_chunk.cu's arithmetic, block by block: C.B^T once per block
    of hg heads (causal), then each head's S, y and s_loc from it."""
    G, Q, P = x.shape
    y = torch.empty((G, Q, P))
    s_loc = torch.empty((G, P, C.shape[2]))
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    for block in ssm_chunk.blocks_of(G, hg):
        gc = block[0] // heads
        cb = torch.where(causal, C[gc] @ B[gc].T, 0.0)  # once for the block
        for g in block:
            decay = torch.exp(torch.clamp(cum[g][:, None] - cum[g][None, :], -60.0, 0.0))
            S = torch.where(causal, cb * decay * dt[g][None, :], 0.0)
            y[g] = S @ x[g]
            w_end = torch.exp(torch.clamp(cum[g][-1] - cum[g], -60.0, 0.0)) * dt[g]
            s_loc[g] = (w_end[:, None] * x[g]).T @ B[gc]
    return y, s_loc


@pytest.mark.parametrize("G,Q,N,P,heads,hg", [(8, 32, 16, 8, 4, 2), (6, 16, 8, 12, 3, 3),
                                              (4, 64, 64, 64, 4, 4), (3, 20, 9, 5, 1, 1)])
def test_ssm_kernel_order_matches_pallas(G, Q, N, P, heads, hg):
    rng = np.random.default_rng(G + Q)
    C = rng.normal(size=(G // heads, Q, N)).astype(np.float32)
    B = rng.normal(size=(G // heads, Q, N)).astype(np.float32)
    cum = np.cumsum(-np.abs(rng.normal(size=(G, Q)) * 0.1), axis=1).astype(np.float32)
    dt = (np.abs(rng.normal(size=(G, Q))) * 0.5).astype(np.float32)
    x = rng.normal(size=(G, Q, P)).astype(np.float32)
    got = _ssm_kernel_order(*(torch.as_tensor(a) for a in (C, B, cum, dt, x)), heads, hg)
    Ce, Be = (np.repeat(a, heads, axis=0) for a in (C, B))
    want = jops.ssm_chunk(*(jnp.asarray(a) for a in (Ce, Be, cum, dt, x)), interpret=True)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= SSM_TOL * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("B", [1, 3, 4, 5, 127, 4471])
def test_row_plan_covers_every_woken_row_once(B):
    plan = fru.row_plan(B, 100, ())
    rows = [b for k in range(plan.blocks) for b in plan.rows(k, B)]
    assert rows == list(range(B))  # each row once, one warp each, in order
    assert all(len(plan.rows(k, B)) <= fru.ROWS_PER_BLOCK for k in range(plan.blocks))


@pytest.mark.parametrize("p,passes", [(1, 1), (100, 1), (128, 1), (129, 2), (257, 4),
                                      (512, 4), (513, 8), (1024, 8)])
def test_row_plan_passes_cover_p(p, passes):
    plan = fru.row_plan(8, p, ())
    assert plan.passes == passes and plan.passes * fru.PASS_COLS >= p
    with pytest.raises(ValueError, match="p <= "):
        fru.row_plan(8, fru.MAX_P + 1, ())


def test_row_plan_fills_the_card_at_the_main_path():
    # rgg500k_p100: 4471 woken slots (4097 valid) of p = 100, a warp each.
    plan = fru.row_plan(4471, 100, ())
    assert plan.blocks == 1118 >= H100_SMS and plan.passes == 1


def _at_offset(shape, offset):
    n = int(np.prod(shape))
    buf = torch.zeros(n + 8)
    assert buf.data_ptr() % 16 == 0
    t = buf[offset:offset + n].view(*shape)
    assert t.is_contiguous() and t.storage_offset() == offset
    return t


@pytest.mark.parametrize("p", [3, 4, 100, 102, 257])
@pytest.mark.parametrize("which", ["theta", "X", "noise", "none"])
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_row_plan_float4_exactly_when_aligned(p, which, offset):
    """The float4 instance exactly when p % 4 == 0 and each of Theta, X and
    noise starts on a 16-byte boundary (a storage offset of a multiple of
    4 floats from an aligned buffer); noise may be absent."""
    offs = {name: (offset if name == which else 0) for name in ("theta", "X", "noise")}
    theta = _at_offset((16, p), offs["theta"])
    X = _at_offset((4, 3, p), offs["X"])
    noise = _at_offset((4, p), offs["noise"])
    want = p % 4 == 0 and (which == "none" or offset % 4 == 0)
    assert fru.row_plan(4, p, (theta, X, noise)).vec == want
    assert fru.row_plan(4, p, (theta, X, None)).vec == (
        p % 4 == 0 and (which in ("none", "noise") or offset % 4 == 0))


def _fused_kernel_order(rows, idx, w, coef, X, y, mask, noise, theta, limit, clip, passes):
    """csrc/fused_row_update.cu's order, row by row: the residuals of data
    points in chunks of 8 / passes, the gradient sum in ascending i, the
    neighbour sum over the nonzero weights only in ascending k, then the
    scatter after every row is computed (the snapshot rule)."""
    chunk = 8 // passes
    new = {}
    for b, row in enumerate(rows.tolist()):
        if not 0 <= row < limit:
            continue
        th = theta[row]
        g = torch.zeros_like(th)
        mass = torch.tensor(0.0)
        for i0 in range(0, X.shape[1], chunk):
            for i in range(i0, min(i0 + chunk, X.shape[1])):
                r = 2.0 * (X[b, i] @ th - y[b, i])
                if clip is not None:
                    l1 = r.abs() * X[b, i].abs().sum()
                    r = r * torch.clamp(clip / torch.clamp(l1, min=1e-12), max=1.0)
                mass = mass + mask[b, i]
                g = g + (r * mask[b, i]) * X[b, i]
        neigh = torch.zeros_like(th)
        for k in range(idx.shape[1]):
            if w[b, k] != 0:
                neigh = neigh + w[b, k] * theta[idx[b, k]]
        alpha, deg, cmu, lam2 = coef[b, :4]
        grad = g / torch.clamp(mass, min=1.0) + lam2 * th + noise[b]
        new[row] = (1.0 - alpha) * th + alpha * (neigh / deg - cmu * grad)
    out = theta.clone()
    for row, v in new.items():
        out[row] = v
    return out


@pytest.mark.parametrize("B,K,m,p,passes", [(6, 5, 3, 8, 1), (5, 7, 11, 100, 1),
                                            (4, 4, 9, 130, 2), (3, 38, 8, 100, 1)])
@pytest.mark.parametrize("clip", [None, 0.7])
def test_fused_kernel_order_matches_pallas(B, K, m, p, passes, clip):
    """On finite Theta the skipped weight-0 terms change nothing: the
    kernel's order agrees with the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(B * K + p)
    nt = 40
    rows = rng.permutation(nt)[:B].astype(np.int32)
    rows[-1] = nt  # a sentinel
    rows[0] = 3
    idx = rng.integers(0, nt, size=(B, K)).astype(np.int32)
    idx[1, 0] = 3  # a woken row read by another
    w = rng.random((B, K)).astype(np.float32)
    w[rng.random((B, K)) < 0.6] = 0.0
    coef = np.stack([rng.uniform(0.2, 0.9, B), rng.uniform(1.0, K + 1.0, B),
                     rng.uniform(0.05, 0.5, B), rng.uniform(0.0, 0.3, B)], axis=1)
    coef = coef.astype(np.float32)
    X = rng.normal(size=(B, m, p)).astype(np.float32)
    y = rng.normal(size=(B, m)).astype(np.float32)
    mask = (rng.random((B, m)) < 0.8).astype(np.float32)
    noise = (rng.normal(size=(B, p)) * 0.01).astype(np.float32)
    theta = rng.normal(size=(nt, p)).astype(np.float32)
    assert fru.row_plan(B, p, ()).passes == passes
    args = (rows, idx, w, coef, X, y, mask, noise, theta)
    got = _fused_kernel_order(*(torch.as_tensor(a) for a in args), nt, clip, passes)
    want = jops.fused_row_update(*(jnp.asarray(a) for a in args), limit=nt, clip=clip,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=KTOL, atol=KTOL)

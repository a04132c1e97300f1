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
  chunks of 8 / passes) agrees with the JAX Pallas kernel at 4e-6;
* ``dp_clip_noise.clip_plan``: every row and column is covered by
  exactly one block, a cluster of at most 8 blocks spans D, the grid is
  about one wave of the SMs at (256, 4096) float32 (no longer 16 column
  blocks), ragged N and D leave no block empty, and the kernel's order
  written out agrees with the JAX Pallas kernel in
  interpret mode at the port's 1e-5 (3e-2 in bfloat16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import dp_clip_noise as dcn
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


CLIP_SHAPES = [(256, 4096, 4, True), (200, 1000, 2, True), (4097, 1000, 4, True),
               (3, 65537, 4, False), (3, 65537, 2, False), (1, 1, 4, False), (1500, 5, 4, False),
               (77, 301, 4, False), (8, 128, 4, True), (9, 8193, 4, False), (1, 16384, 2, True),
               (33, 20000, 4, True), (256, 4096, 4, False), (256, 4096, 2, True),
               (2, 70000, 4, True)]


@pytest.mark.parametrize("N,D,itemsize,vec", CLIP_SHAPES)
def test_clip_plan_covers_every_row_and_column_once(N, D, itemsize, vec):
    plan = dcn.clip_plan(N, D, itemsize, vec)
    assert 1 <= plan.cluster <= dcn.MAX_CLUSTER and 1 <= plan.rows <= min(dcn.MAX_ROWS, N)
    assert plan.per == (16 // itemsize if vec else 1)
    rows = [r for y in range(plan.row_blocks) for r in plan.rows_of(y)]
    assert rows == list(range(N))  # each row once, no row block empty
    cols = [c for x in range(plan.cluster) for c in plan.columns_of(x)]
    assert cols == list(range(D))  # the cluster spans D, each column once
    assert all(len(plan.columns_of(x)) > 0 for x in range(plan.cluster))
    assert plan.partial_floats == (plan.row_blocks * D if plan.row_blocks > 1 else 0)
    if plan.row_blocks > 1:
        assert plan.combine_blocks * dcn.COMBINE_COLS >= D > (plan.combine_blocks - 1) * 32
    else:
        assert plan.combine_blocks == 0  # one row block writes the result itself

    def cluster_of(passes):
        return -(-D // (passes * dcn.THREADS * plan.per))

    if plan.resident:  # the tile fills the registers: the smallest cluster, then fewest passes
        assert plan.passes in (1, 2, 4, 8) and plan.rows == min(dcn.SLOTS // plan.passes, N)
        fits = [q for q in (1, 2, 4, 8) if cluster_of(q) <= dcn.MAX_CLUSTER]
        assert (plan.cluster, plan.passes) == min((cluster_of(q), q) for q in fits)
    else:  # too wide for eight passes of eight blocks: streamed, the widest cluster
        assert cluster_of(8) > dcn.MAX_CLUSTER and plan.rows == min(dcn.MAX_ROWS, N)
        assert plan.cluster <= dcn.MAX_CLUSTER < cluster_of(plan.passes - 1)


def test_clip_plan_fills_the_card_at_the_bench_shape():
    """(256, 4096) float32: a block holds two whole rows in registers (4
    passes of 1024 columns, grads read once, no cluster), 128 blocks: one
    wave of the H100's 132 SMs, where the earlier column pass had 16; the
    combine also has 128 blocks."""
    plan = dcn.clip_plan(256, 4096, 4, True)
    assert (plan.cluster, plan.rows, plan.row_blocks, plan.passes) == (1, 2, 128, 4)
    assert 0.9 * H100_SMS <= plan.blocks <= H100_SMS and plan.resident
    assert plan.combine_blocks == 128 and plan.partial_floats == 128 * 4096
    bf16 = dcn.clip_plan(200, 1000, 2, True)  # phase 3's bfloat16 shape
    assert (bf16.cluster, bf16.rows, bf16.passes) == (1, 8, 1) and bf16.resident
    scalar = dcn.clip_plan(256, 4096, 4, False)  # a misaligned copy: a cluster of 2
    assert (scalar.cluster, scalar.rows, scalar.passes, scalar.blocks) == (2, 1, 8, 512)


@pytest.mark.parametrize("N,D,rows,last", [(4097, 1000, 8, 1), (1500, 5, 8, 4), (77, 301, 4, 1)])
def test_clip_plan_ragged_edges(N, D, rows, last):
    plan = dcn.clip_plan(N, D, 4, D % 4 == 0)
    assert plan.rows == rows
    assert len(plan.rows_of(plan.row_blocks - 1)) == last
    wide = dcn.clip_plan(3, 65537, 4, False)  # the scalar instance, streamed
    assert (wide.cluster, wide.passes, wide.rows, wide.resident) == (8, 33, 3, False)
    assert len(wide.columns_of(7)) == 65537 - 7 * 33 * 256
    with pytest.raises(ValueError, match="at least one row"):
        dcn.clip_plan(0, 5, 4, False)


def _clip_inputs(N, D, dtype, seed):
    rng = np.random.default_rng(seed)
    grads = jnp.asarray(rng.normal(size=(N, D)) * 3.0, dtype)
    noise = jnp.asarray(rng.laplace(size=(D,)), jnp.float32)
    tg = torch.tensor(np.asarray(grads.astype(jnp.float32)))
    return grads, noise, tg.to(torch.bfloat16) if dtype == jnp.bfloat16 else tg, \
        torch.tensor(np.asarray(noise))


def _clip_kernel_order(grads, noise, clip, noise_scale, plan):
    """The kernel's arithmetic written out in its order, in float32 on the
    CPU: each row's squared norm as the sum over the cluster's blocks in
    rank order of the block's partial, each block's scaled rows summed in
    ascending order into a partial row, and the partial rows summed by
    8 contiguous groups (a warp each) in order. Lane and warp order
    within a block's partial norm is not reproduced (a tree of shuffles),
    so this agrees with the kernel to rounding, not bit for bit."""
    f32 = torch.float32
    g = grads.to(f32)
    N, D = g.shape
    norms = torch.zeros(N, dtype=f32)
    for x in range(plan.cluster):
        cols = plan.columns_of(x)
        norms = norms + (g[:, cols.start:cols.stop] ** 2).sum(dim=1)
    scale = torch.clamp(float(clip) / torch.sqrt(norms.clamp(min=1e-24)).clamp(min=1e-12),
                        max=1.0)
    partial = torch.zeros((plan.row_blocks, D), dtype=f32)
    for y in range(plan.row_blocks):
        for r in plan.rows_of(y):
            partial[y] = partial[y] + scale[r] * g[r]
    warps = dcn.THREADS // 32
    per = -(-plan.row_blocks // warps)
    total = torch.zeros(D, dtype=f32)
    for w in range(warps):
        lo, hi = min(plan.row_blocks, w * per), min(plan.row_blocks, w * per + per)
        group = torch.zeros(D, dtype=f32)
        for y in range(lo, hi):
            group = group + partial[y]
        total = total + group
    return total / float(N) + float(noise_scale) * noise.to(f32)


@pytest.mark.parametrize("N,D,itemsize,vec", [(256, 4096, 4, True), (33, 200, 4, True),
                                              (77, 301, 4, False), (200, 1000, 2, True),
                                              (9, 8193, 4, False), (3, 2000, 4, True),
                                              (5, 20000, 4, True)])
def test_clip_kernel_order_matches_pallas(N, D, itemsize, vec):
    dtype = jnp.float32 if itemsize == 4 else jnp.bfloat16
    grads, noise, tg, tn = _clip_inputs(N, D, dtype, N + D)
    plan = dcn.clip_plan(N, D, itemsize, vec)
    got = _clip_kernel_order(tg, tn, 1.5, 0.37, plan)
    want = np.asarray(jops.dp_clip_noise(grads, noise, 1.5, 0.37, interpret=True))
    tol = 1e-5 if itemsize == 4 else 3e-2
    assert np.abs(got.numpy() - want).max() <= tol * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), dcn.dp_clip_noise_plain(tg, tn, 1.5, 0.37).numpy(),
                               rtol=1e-5, atol=1e-6)

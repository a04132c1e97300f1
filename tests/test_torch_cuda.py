"""The CUDA kernels on the card: each against its plain version over a
shape grid, launch counting, refusal of what a kernel does not take, the
engine's fused and unfused routes (non-private and private) against the
CPU route, and the zamba2 path (a Mamba2 block through ``ssm_chunk``, a
2-layer full-width hybrid's prefill against its decode loop).

Marked ``cuda``: every test skips where there is no CUDA device. Run on a
GPU machine with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``
(add ``--noconftest`` where JAX is not installed: the suite's conftest
imports it, this file does not).
Tolerance 1e-5 relative to the largest output: float32 sums taken in
another order than the plain version's; 1e-4 (``MODEL_TOL``) for whole
Mamba2 blocks and models, whose float32 routes differ in many sums.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import AgentData, DPConfig, knn_graph, make_objective, random_geometric_graph
from repro_torch.core.mixing import mix_op
from repro_torch.kernels import _build, ops, ref
from repro_torch.models import ssm
from repro_torch.models.registry import build_model
from repro_torch.sim import AsyncEngine, CDUpdate, DPCDUpdate

pytestmark = pytest.mark.cuda
TOL = 1e-5
MODEL_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want, tol=TOL):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("R,n,K,p", [(1, 8, 1, 1), (37, 500, 7, 100), (300, 300, 40, 257),
                                     (1000, 64, 3, 33)])
def test_sparse_mix_matches_plain(dev, R, n, K, p):
    g = torch.Generator(device=dev).manual_seed(R)
    idx = torch.randint(0, n, (R, K), generator=g, device=dev, dtype=torch.int32)
    w = torch.rand((R, K), generator=g, device=dev)
    theta = torch.randn((n, p), generator=g, device=dev)
    before = ops.launch_counts()["sparse_mix"]
    got = ops.sparse_mix(idx, w, theta)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sparse_mix"] == before + 1
    _close(got, ref.sparse_mix_ref(idx, w, theta))


@pytest.mark.parametrize("n,p", [(1, 1), (33, 100), (257, 31), (700, 129)])
def test_graph_mix_matches_plain(dev, n, p):
    g = torch.Generator(device=dev).manual_seed(n)
    A = torch.rand((n, n), generator=g, device=dev)
    theta = torch.randn((n, p), generator=g, device=dev)
    _close(ops.graph_mix(A, theta), ref.graph_mix_ref(A, theta))


@pytest.mark.parametrize("B,K,m,p,nt", [(1, 1, 1, 1, 4), (40, 9, 8, 100, 300),
                                        (200, 5, 33, 257, 500), (64, 3, 0, 16, 64)])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_fused_row_update_matches_plain(dev, B, K, m, p, nt, clip):
    g = torch.Generator(device=dev).manual_seed(B + p)
    rows = torch.randperm(nt, generator=g, device=dev)[:B].to(torch.int32)
    rows[B // 2:] = torch.where(torch.arange(B - B // 2, device=dev) % 3 == 0, nt, rows[B // 2:])
    idx = torch.randint(0, nt, (B, K), generator=g, device=dev, dtype=torch.int32)
    idx[:, 0] = rows.clamp(max=nt - 1).flip(0)  # woken rows read each other
    w = torch.rand((B, K), generator=g, device=dev)
    coef = torch.stack([torch.rand(B, generator=g, device=dev) * 0.7 + 0.2,
                        torch.rand(B, generator=g, device=dev) * K + 1.0,
                        torch.rand(B, generator=g, device=dev) * 0.4,
                        torch.rand(B, generator=g, device=dev) * 0.3], dim=1)
    X = torch.randn((B, m, p), generator=g, device=dev)
    y = torch.randn((B, m), generator=g, device=dev)
    mask = (torch.rand((B, m), generator=g, device=dev) < 0.8).float()
    noise = 0.01 * torch.randn((B, p), generator=g, device=dev)
    theta = torch.randn((nt, p), generator=g, device=dev)
    a, b = theta.clone(), theta.clone()
    ops.fused_row_update(rows, idx, w, coef, X, y, mask, noise, a, nt, clip)
    ref.fused_row_update_ref(rows, idx, w, coef, X, y, mask, noise, b, nt, clip)
    _close(a, b)
    untouched = torch.ones(nt, dtype=torch.bool, device=dev)
    untouched[rows[rows < nt].long()] = False
    assert torch.equal(a[untouched], theta[untouched])


def test_wrappers_refuse_on_the_card(dev):
    theta = torch.randn((8, 4), device=dev)
    with pytest.raises(TypeError, match="int32"):
        ops.sparse_mix(torch.zeros((2, 2), device=dev, dtype=torch.long),
                       torch.rand((2, 2), device=dev), theta)
    with pytest.raises(TypeError, match="float32"):
        ops.graph_mix(torch.eye(8, device=dev, dtype=torch.float64), theta)
    with pytest.raises(ValueError, match="contiguous"):
        ops.graph_mix(torch.eye(4, device=dev), theta.t())


@pytest.mark.parametrize("mix_mode", ["dense", "sparse"])
def test_engine_routes_on_the_card_match_the_cpu(dev, mix_mode):
    rng = np.random.default_rng(0)
    n, p, m = 200, 8, 4
    graph = knn_graph(rng.normal(size=(n, 6)), k=6)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)))
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode=mix_mode)
    masks = [rng.random(n) < 0.3 for _ in range(20)]

    def forced(device, fused):
        eng = AsyncEngine(CDUpdate(obj), slot_wakes=32.0, fused=fused, device=device)
        state = eng.init_state(np.zeros((n, p)))
        for mask in masks:
            state = eng.step(state, mask)
        return eng, state.Theta.cpu().numpy()

    ops.reset_launch_counts()
    eng_f, fused = forced(dev, "auto")
    eng_u, unfused = forced(dev, False)
    _, cpu = forced("cpu", False)
    counts = ops.launch_counts()
    assert eng_f.fused and not eng_u.fused
    assert counts["fused_row_update"] == 20
    assert counts["sparse_mix"] == (20 if mix_mode == "sparse" else 0)
    assert np.abs(fused - cpu).max() < TOL and np.abs(unfused - cpu).max() < TOL


def test_engine_beyond_the_fused_limits_runs_unfused_on_the_card(dev):
    """p = 1025 is past the fused kernel's width: ``fused="auto"`` builds an
    unfused card engine that runs and matches the CPU route."""
    rng = np.random.default_rng(8)
    n, p, m = 40, 1025, 2
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    obj = make_objective(knn_graph(rng.normal(size=(n, 6)), k=5),
                         AgentData(X=X, y=rng.normal(size=(n, m)), mask=np.ones((n, m))),
                         "quadratic", mu=0.5)
    masks = [rng.random(n) < 0.3 for _ in range(5)]
    outs = []
    for device in (dev, "cpu"):
        eng = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, device=device)
        assert not eng.fused
        state = eng.init_state(np.zeros((n, p)))
        for mask in masks:
            state = eng.step(state, mask)
        outs.append(state.Theta.cpu().numpy())
    assert np.abs(outs[0] - outs[1]).max() < TOL


@pytest.mark.parametrize("N,D", [(8, 128), (33, 200), (128, 512), (200, 1000), (1, 128),
                                 (256, 4096), (77, 301), (1, 3), (1500, 5), (4097, 1000),
                                 (3, 65537), (1, 1), (33, 20000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dp_clip_noise_matches_plain(dev, N, D, dtype):
    g = torch.Generator(device=dev).manual_seed(N * 1000 + D)
    grads = (3.0 * torch.randn((N, D), generator=g, device=dev)).to(dtype)
    noise = torch.randn(D, generator=g, device=dev)
    before = ops.launch_counts()["dp_clip_noise"]
    got = ops.dp_clip_noise(grads, noise, 1.5, 0.37)
    torch.cuda.synchronize()
    assert ops.launch_counts()["dp_clip_noise"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (D,)
    _close(got, ref.dp_clip_noise_ref(grads, noise, 1.5, 0.37))
    # The sum order is fixed: a second launch gives the same bits.
    assert torch.equal(ops.dp_clip_noise(grads, noise, 1.5, 0.37), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dp_clip_noise_scalar_instance_at_a_storage_offset(dev, dtype):
    """grads one element into its storage: not 16-byte aligned, so the
    wrapper plans the scalar instance; it agrees with the plain version at
    the same tolerance and repeats its bits."""
    g = torch.Generator(device=dev).manual_seed(5)
    N, D = 256, 4096
    base = (3.0 * torch.randn(N * D + 1, generator=g, device=dev)).to(dtype)
    grads = base[1:].view(N, D)
    assert grads.is_contiguous() and not _build.vector_loads(grads)
    noise = torch.randn(D, generator=g, device=dev)
    got = ops.dp_clip_noise(grads, noise, 1.5, 0.37)
    _close(got, ref.dp_clip_noise_ref(grads, noise, 1.5, 0.37))
    assert torch.equal(ops.dp_clip_noise(grads, noise, 1.5, 0.37), got)
    aligned = ops.dp_clip_noise(grads.clone(), noise, 1.5, 0.37)  # the 16-byte instance
    _close(got, aligned)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dp_clip_noise_every_plan_layout_matches_plain(dev, dtype):
    """Every layout of the tile at (256, 4096): no cluster, clusters of 2
    and 4 across D, resident and streamed, agrees with the plain version
    and repeats its bits; a plan for another shape is refused."""
    from repro_torch.kernels.dp_clip_noise import ClipPlan, dp_clip_noise_cuda

    g = torch.Generator(device=dev).manual_seed(6)
    N, D = 256, 4096
    grads = (3.0 * torch.randn((N, D), generator=g, device=dev)).to(dtype)
    noise = torch.randn(D, generator=g, device=dev)
    want = ref.dp_clip_noise_ref(grads, noise, 1.5, 0.37)
    per = 16 // grads.element_size()
    for passes, rows in ((4, 2), (4, 8), (2, 4), (1, 8), (1, 3)):
        passes = max(1, passes * 4 // per)  # bf16: twice the columns a pass
        cluster = -(-D // (passes * 256 * per))
        plan = ClipPlan(N=N, D=D, vec=True, per=per, passes=passes, cluster=cluster, rows=rows)
        got = dp_clip_noise_cuda(grads, noise, 1.5, 0.37, plan=plan)
        _close(got, want)
        assert torch.equal(dp_clip_noise_cuda(grads, noise, 1.5, 0.37, plan=plan), got)
    with pytest.raises(ValueError, match="does not fit"):
        dp_clip_noise_cuda(grads[:8].contiguous(), noise, 1.5, 0.37, plan=plan)


def test_dp_clip_noise_clips_and_refuses(dev):
    grads = 100.0 * torch.randn((16, 256), device=dev)
    out = ops.dp_clip_noise(grads, torch.zeros(256, device=dev), 1.0, 0.0)
    assert float(torch.linalg.norm(out)) <= 1.0 + 1e-5
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.dp_clip_noise(grads.double(), torch.zeros(256, device=dev), 1.0, 0.0)
    with pytest.raises(TypeError, match="float32"):
        ops.dp_clip_noise(grads, torch.zeros(256, device=dev, dtype=torch.float64), 1.0, 0.0)
    with pytest.raises(ValueError, match="shape"):
        ops.dp_clip_noise(grads, torch.zeros(255, device=dev), 1.0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        ops.dp_clip_noise(grads[:, ::2], torch.zeros(128, device=dev), 1.0, 0.0)


def _dp_problem(n=200, p=8, m=4, seed=0):
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 6)), k=6)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)))
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, clip=1.0, mix_mode="sparse")
    return obj, rng


def test_dp_fused_slot_with_budget_sentinels_matches_plain(dev):
    """One private fused slot on the card against its plain route on the
    CPU, the same draws injected: woken rows at their budget are kernel
    sentinels and keep their row."""
    obj, rng = _dp_problem()
    n, p = obj.n, obj.p
    upd = DPCDUpdate.plan(obj, DPConfig(eps_bar=0.5), planned_Ti=2)
    rows = np.sort(rng.choice(n, size=60, replace=False))
    rows = np.concatenate([rows, np.full(4, n)])  # sentinel padding
    valid = rows < n
    counts = rng.integers(0, 3, size=n).astype(np.int32)
    idx, w = obj.mix.idx, obj.mix.w
    safe = np.minimum(rows, n - 1)
    Theta = rng.normal(size=(n, p)).astype(np.float32)
    draws = rng.laplace(size=(len(rows), p)).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        args = [torch.as_tensor(a).to(d) for a in (Theta, rows, valid)]
        slab, applied, state = upd.apply_fused(
            args[0], args[1].long(), args[2], None, torch.tensor(counts).to(d),
            torch.as_tensor(idx[safe], dtype=torch.int32).to(d),
            torch.as_tensor(w[safe], dtype=torch.float32).to(d), draws=torch.as_tensor(draws))
        out[d.type] = [t.cpu() for t in (slab, applied, state)]
    stopped = valid & (counts[safe] >= 2)
    assert stopped.any() and (valid & ~stopped).any()
    _close(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert torch.equal(out["cuda"][2], out["cpu"][2])
    keep = rows[stopped]
    assert torch.equal(out["cuda"][0][keep], torch.as_tensor(Theta)[keep])


def test_dp_engine_routes_on_the_card_match(dev):
    """Forced all-wake private slots: the fused and unfused routes on the
    card share one generator stream, so they see the same noise; budget
    counts end at planned_Ti on both."""
    obj, _ = _dp_problem(seed=1)
    n = obj.n
    out = {}
    ops.reset_launch_counts()
    for fused in ("auto", False):
        upd = DPCDUpdate.plan(obj, DPConfig(eps_bar=0.5), planned_Ti=3)
        eng = AsyncEngine(upd, slot_wakes=float(n), fused=fused, device=dev)
        state = eng.init_state(np.zeros((n, obj.p)))
        for _ in range(5):
            state = eng.step(state, np.ones(n, dtype=bool))
        out[fused] = (eng.fused, state.Theta.cpu(), state.ustate.cpu())
    counts = ops.launch_counts()
    assert out["auto"][0] and not out[False][0]
    assert counts["fused_row_update"] == 5 and counts["sparse_mix"] == 5
    _close(out["auto"][1], out[False][1])
    assert torch.equal(out["auto"][2], out[False][2])
    assert torch.equal(out["auto"][2], torch.full((n,), 3, dtype=torch.int32))


def _ssm_inputs(dev, G, Q, N, P, heads, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    C = torch.randn((G // heads, Q, N), generator=g, device=dev).to(dtype)
    B = torch.randn((G // heads, Q, N), generator=g, device=dev).to(dtype)
    cum = torch.cumsum(-0.1 * torch.rand((G, Q), generator=g, device=dev), dim=1)
    dt = 0.5 * torch.rand((G, Q), generator=g, device=dev)
    x = torch.randn((G, Q, P), generator=g, device=dev).to(dtype)
    return C, B, cum, dt, x


# (4096, 128, 64, 64, 64) is the zamba2-1.2b prefill: 4 x 16 chunks x 64 heads.
@pytest.mark.parametrize("G,Q,N,P,heads", [(4096, 128, 64, 64, 64), (2, 16, 8, 16, 1),
                                           (4, 64, 64, 64, 2), (3, 32, 16, 128, 1),
                                           (6, 77, 40, 96, 3), (5, 1, 1, 1, 5),
                                           (2, 128, 128, 128, 1), (7, 33, 64, 17, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_chunk_matches_plain(dev, G, Q, N, P, heads, dtype):
    args = _ssm_inputs(dev, G, Q, N, P, heads, dtype, seed=G + Q + N + P)
    before = ops.launch_counts()["ssm_chunk"]
    y, s = ops.ssm_chunk(*args, heads=heads)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssm_chunk"] == before + 1
    assert y.dtype == s.dtype == torch.float32 and y.shape == (G, Q, P) and s.shape == (G, P, N)
    y_p, s_p = ref.ssm_chunk_ref(*args, heads)
    _close(y, y_p)
    _close(s, s_p)
    # The sum order is fixed: a second launch gives the same bits.
    y2, s2 = ops.ssm_chunk(*args, heads=heads)
    assert torch.equal(y, y2) and torch.equal(s, s2)


def test_ssm_chunk_head_shared_entry_equals_expanded(dev):
    C, B, cum, dt, x = _ssm_inputs(dev, 128, 128, 64, 64, 64, torch.float32, seed=9)
    y, s = ops.ssm_chunk(C, B, cum, dt, x, heads=64)
    y_e, s_e = ops.ssm_chunk(C.repeat_interleave(64, 0), B.repeat_interleave(64, 0), cum, dt, x)
    assert torch.equal(y, y_e) and torch.equal(s, s_e)


def test_ssm_chunk_refuses_on_the_card(dev):
    C, B, cum, dt, x = _ssm_inputs(dev, 4, 129, 8, 8, 1, torch.float32, seed=1)
    before = ops.launch_counts()["ssm_chunk"]
    with pytest.raises(ValueError, match="Q <= "):
        ops.ssm_chunk(C, B, cum, dt, x)
    C, B, cum, dt, x = _ssm_inputs(dev, 4, 16, 8, 8, 1, torch.float32, seed=1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ssm_chunk(C.double(), B.double(), cum, dt, x.double())
    with pytest.raises(TypeError, match="cum must be torch.float32"):
        ops.ssm_chunk(C, B, cum.double(), dt, x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssm_chunk(C, B, cum, dt, x.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="heads=3"):
        ops.ssm_chunk(C, B, cum, dt, x, heads=3)
    assert ops.launch_counts()["ssm_chunk"] == before


def _full_width(num_layers, every):
    """zamba2-1.2b at its full width, cut to ``num_layers`` layers, float32."""
    return dataclasses.replace(get_config("zamba2-1.2b"), num_layers=num_layers,
                               shared_attn_every=every, dtype="float32")


def test_mamba2_block_launches_the_kernel_and_matches_the_einsums(dev):
    cfg = _full_width(1, None)
    block = ssm.Mamba2(cfg, device=dev, dtype=torch.float32,
                       generator=torch.Generator(device=dev).manual_seed(0))
    x = torch.randn((2, 256, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    with torch.inference_mode():
        before = ops.launch_counts()["ssm_chunk"]
        got = ssm.mamba2_forward(block, x, cfg)
        assert ops.launch_counts()["ssm_chunk"] == before + 1
        want = ssm.mamba2_forward(block, x, cfg, use_kernel=False)
    _close(got, want, MODEL_TOL)


def test_full_width_hybrid_prefill_matches_its_decode_loop(dev):
    """Two full-width layers (the shared block after the second), float32
    with TF32 off: the chunked prefill through the kernel over two chunks
    against the same 256 tokens fed one at a time through decode."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = _full_width(2, 2)
    bundle = build_model(cfg)
    model = bundle.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    before = ops.launch_counts()["ssm_chunk"]
    logits, _ = bundle.prefill(model, {"tokens": tokens})
    assert ops.launch_counts()["ssm_chunk"] == before + 2
    caches = bundle.init_cache(model, 2, 256)
    for pos in range(256):
        step, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
    assert logits.shape == step.shape == (2, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    _close(step, logits, MODEL_TOL)


# The redesigned graph_mix (split-K, cp.async ring) and sparse_mix (only the
# real entries walked, float4 and scalar instances).


@pytest.mark.parametrize("n,p,layout", [
    (2047, 100, "aligned"),  # the dense main path: odd row stride of A, 16 parts
    (50, 100, "aligned"),    # under one 128-row tile and one part
    (300, 37, "aligned"),    # p % 4 != 0: 4-byte copies of Theta
    (700, 129, "aligned"),
    (129, 1, "aligned"),
    (4000, 64, "aligned"),   # 32 row tiles, 8 parts
    (1000, 100, "offset"),   # Theta at a storage offset of one float: unaligned
])
def test_graph_mix_split_k_matches_plain_and_repeats_its_bits(dev, n, p, layout):
    g = torch.Generator(device=dev).manual_seed(n + p)
    A = torch.rand((n, n), generator=g, device=dev)
    if layout == "offset":
        theta = torch.randn(n * p + 1, generator=g, device=dev)[1:].view(n, p)
        assert not _build.vector_loads(theta)
    else:
        theta = torch.randn((n, p), generator=g, device=dev)
    before = ops.launch_counts()["graph_mix"]
    got = ops.graph_mix(A, theta)
    again = ops.graph_mix(A, theta)
    torch.cuda.synchronize()
    assert ops.launch_counts()["graph_mix"] == before + 2
    _close(got, ref.graph_mix_ref(A, theta))
    assert torch.equal(got, again)  # fixed summation order: the same bits


def _zero_scattered(R, n, K, p, dev, seed, zero_share=0.5):
    """Tables whose weight-0 entries lie anywhere in a row (not only at its
    end), rows 0 and R // 2 all padding."""
    g = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, n, (R, K), generator=g, device=dev, dtype=torch.int32)
    w = torch.rand((R, K), generator=g, device=dev) + 0.1
    w[torch.rand((R, K), generator=g, device=dev) < zero_share] = 0.0
    w[0] = 0.0
    w[R // 2] = 0.0
    theta = torch.randn((n, p), generator=g, device=dev)
    return idx, w, theta


@pytest.mark.parametrize("R,n,K,p", [(500, 800, 38, 100), (300, 300, 1, 100), (300, 300, 33, 100),
                                     (200, 400, 64, 100), (257, 300, 33, 37), (100, 200, 64, 129),
                                     (64, 100, 38, 3), (40, 60, 70, 260)])
def test_sparse_mix_walks_only_real_entries(dev, R, n, K, p):
    idx, w, theta = _zero_scattered(R, n, K, p, dev, seed=R + K + p)
    before = ops.launch_counts()["sparse_mix"]
    got = ops.sparse_mix(idx, w, theta)
    again = ops.sparse_mix(idx, w, theta)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sparse_mix"] == before + 2
    _close(got, ref.sparse_mix_ref(idx, w, theta))
    assert torch.equal(got, again)  # fixed summation order: the same bits
    assert torch.equal(got[0], torch.zeros(p, device=dev))  # all padding: zero
    assert torch.equal(got[R // 2], torch.zeros(p, device=dev))


def test_sparse_mix_scalar_instance_at_a_storage_offset(dev):
    """A Theta view one float into its buffer is not 16-byte aligned: the
    wrapper launches the scalar instance, which sums in the same order as
    the float4 one, so the bits agree."""
    R, n, K, p = 300, 500, 38, 100
    idx, w, aligned = _zero_scattered(R, n, K, p, dev, seed=7)
    buf = torch.empty(n * p + 1, device=dev)
    buf[1:] = aligned.flatten()
    shifted = buf[1:].view(n, p)
    assert _build.vector_loads(aligned) and not _build.vector_loads(shifted)
    got = ops.sparse_mix(idx, w, shifted)
    _close(got, ref.sparse_mix_ref(idx, w, shifted))
    assert torch.equal(got, ops.sparse_mix(idx, w, aligned))


def test_sparse_mix_full_neighbour_sum_on_a_random_geometric_graph(dev):
    """R = n on a 20k-agent random geometric graph (MixOp.all's tables):
    against the plain version and against the COO index_add_ route."""
    n, p = 20_000, 100
    mix = mix_op(random_geometric_graph(n, np.random.default_rng(0), avg_degree=16.0), "sparse")
    theta = torch.randn((n, p), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    idx, w = mix.table("idx", dev, torch.int32), mix.table("w", dev, torch.float32)
    assert float((w == 0).float().mean()) > 0.3  # padding is there to skip
    before = ops.launch_counts()["sparse_mix"]
    got = mix.all(theta)
    torch.cuda.synchronize()
    assert ops.launch_counts()["sparse_mix"] == before + 1
    _close(got, ref.sparse_mix_ref(idx, w, theta))
    _close(got, mix.all(theta, use_kernel=False))
    assert torch.equal(got, mix.all(theta))


def test_sparse_mix_nan_reached_only_at_weight_zero_stays_out(dev):
    """The recorded deviation: a non-finite Theta row that a row reaches
    only through weight-0 entries leaves that output finite (the kernel
    skips the entry), where the plain version gives NaN (0 * NaN). A row
    that reaches it at a nonzero weight is NaN on both routes."""
    n, p = 50, 100
    theta = torch.randn((n, p), device=dev)
    theta[7] = float("nan")
    idx = torch.tensor([[3, 7, 9], [7, 2, 7], [1, 2, 3]], dtype=torch.int32, device=dev)
    w = torch.tensor([[0.5, 0.0, 0.25], [0.0, 1.0, 0.0], [0.1, 0.2, 0.3]], device=dev)
    got = ops.sparse_mix(idx, w, theta)
    plain = ref.sparse_mix_ref(idx, w, theta)
    assert bool(torch.isfinite(got[:2]).all()) and bool(torch.isnan(plain[:2]).all())
    torch.testing.assert_close(got[0], 0.5 * theta[3] + 0.25 * theta[9])
    assert torch.equal(got[1], theta[2])
    _close(got[2], plain[2])
    w[0, 1] = 0.5
    assert bool(torch.isnan(ops.sparse_mix(idx, w, theta)[0]).all())


def _fused_case(dev, B, K, m, p, nt, seed, zero_share=0.58):
    """A woken batch like the engine's: distinct rows with sentinels (nt)
    among them, weight-0 padding anywhere in a row, row 0 all padding,
    woken rows that are each other's neighbours."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randperm(nt, generator=g, device=dev)[:B].to(torch.int32)
    rows[torch.arange(B, device=dev) % 11 == 5] = nt  # sentinels
    idx = torch.randint(0, nt, (B, K), generator=g, device=dev, dtype=torch.int32)
    idx[:, 0] = rows.clamp(max=nt - 1).flip(0)  # woken rows read each other
    w = torch.rand((B, K), generator=g, device=dev) + 0.05
    w[torch.rand((B, K), generator=g, device=dev) < zero_share] = 0.0
    w[:, 0] = 0.5
    w[0] = 0.0  # all padding
    coef = torch.stack([torch.rand(B, generator=g, device=dev) * 0.7 + 0.2,
                        torch.rand(B, generator=g, device=dev) * K + 1.0,
                        torch.rand(B, generator=g, device=dev) * 0.4,
                        torch.rand(B, generator=g, device=dev) * 0.3], dim=1)
    X = torch.randn((B, m, p), generator=g, device=dev) / p ** 0.5
    y = torch.randn((B, m), generator=g, device=dev)
    mask = (torch.rand((B, m), generator=g, device=dev) < 0.8).float()
    noise = 0.01 * torch.randn((B, p), generator=g, device=dev)
    theta = torch.randn((nt, p), generator=g, device=dev)
    return rows, idx, w, coef, X, y, mask, noise, theta


# (4471, 38, 8, 100) is the main path's slot (rgg500k_p100: 4097 valid rows).
@pytest.mark.parametrize("B,K,m,p,nt", [(4471, 38, 8, 100, 20_000), (300, 70, 8, 100, 900),
                                        (200, 38, 5, 257, 600), (200, 38, 8, 102, 600),
                                        (100, 33, 20, 64, 400), (64, 1, 3, 1000, 200)])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_fused_row_update_warp_per_row(dev, B, K, m, p, nt, clip):
    """Against the plain version at 2e-5 (phase 3's tolerance): only the
    real entries walked, X held in registers (chunks beyond 8 / passes
    points), the snapshot rule, an all-padding row, sentinels untouched,
    and the same bits on a second launch."""
    rows, idx, w, coef, X, y, mask, noise, theta = _fused_case(dev, B, K, m, p, nt, B + K + p)
    a, b, c = theta.clone(), theta.clone(), theta.clone()
    before = ops.launch_counts()["fused_row_update"]
    ops.fused_row_update(rows, idx, w, coef, X, y, mask, noise, a, nt, clip)
    ops.fused_row_update(rows, idx, w, coef, X, y, mask, noise, c, nt, clip)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_row_update"] == before + 2
    ref.fused_row_update_ref(rows, idx, w, coef, X, y, mask, noise, b, nt, clip)
    _close(a, b, 2e-5)
    assert torch.equal(a, c)  # fixed summation order: the same bits
    untouched = torch.ones(nt, dtype=torch.bool, device=dev)
    untouched[rows[rows < nt].long()] = False
    assert torch.equal(a[untouched], theta[untouched])


def test_fused_row_update_scalar_instance_at_a_storage_offset(dev):
    """Theta one float into its buffer is not 16-byte aligned: the wrapper
    launches the scalar instance. Its lanes hold columns 32 apart, not 4
    consecutive ones, so the residual dots reduce in another order: it
    agrees with the plain version and the float4 instance at 2e-5."""
    from repro_torch.kernels.fused_row_update import row_plan

    B, K, m, p, nt = 500, 38, 8, 100, 2000
    rows, idx, w, coef, X, y, mask, noise, theta = _fused_case(dev, B, K, m, p, nt, 3)
    buf = torch.empty(nt * p + 1, device=dev)
    buf[1:] = theta.flatten()
    shifted = buf[1:].view(nt, p)
    assert row_plan(B, p, (theta, X, noise)).vec and not row_plan(B, p, (shifted, X, noise)).vec
    aligned = theta.clone()
    want = theta.clone()
    ops.fused_row_update(rows, idx, w, coef, X, y, mask, noise, shifted, nt)
    ops.fused_row_update(rows, idx, w, coef, X, y, mask, noise, aligned, nt)
    ref.fused_row_update_ref(rows, idx, w, coef, X, y, mask, noise, want, nt)
    _close(shifted, want, 2e-5)
    _close(shifted, aligned, 2e-5)


def test_fused_row_update_nan_reached_only_at_weight_zero_stays_out(dev):
    """The recorded deviation, as for sparse_mix: a non-finite Theta row
    that a woken row reaches only through weight-0 entries leaves its new
    row finite (the kernel skips the entry), where the plain version's is
    NaN; at a nonzero weight both are NaN."""
    B, K, m, p, nt = 3, 3, 4, 100, 50
    rows, _, _, coef, X, y, mask, noise, theta = _fused_case(dev, B, K, m, p, nt, 5)
    rows = torch.tensor([10, 11, 12], dtype=torch.int32, device=dev)
    theta[7] = float("nan")
    idx = torch.tensor([[3, 7, 9], [7, 2, 7], [1, 2, 3]], dtype=torch.int32, device=dev)
    w = torch.tensor([[0.5, 0.0, 0.25], [0.0, 1.0, 0.0], [0.1, 0.2, 0.3]], device=dev)
    got, plain = theta.clone(), theta.clone()
    ops.fused_row_update(rows, idx, w, coef, X, y, mask, noise, got, nt)
    ref.fused_row_update_ref(rows, idx, w, coef, X, y, mask, noise, plain, nt)
    assert bool(torch.isfinite(got[10:12]).all()) and bool(torch.isnan(plain[10:12]).all())
    _close(got[12], plain[12], 2e-5)
    w[0, 1] = 0.5
    again = theta.clone()
    ops.fused_row_update(rows, idx, w, coef, X, y, mask, noise, again, nt)
    assert bool(torch.isnan(again[10]).all())


@pytest.mark.parametrize("G,Q,N,P,heads", [(4096, 128, 64, 64, 64), (12, 77, 40, 96, 1),
                                           (21, 128, 128, 128, 3), (14, 64, 64, 64, 7),
                                           (64, 33, 16, 20, 64)])
def test_ssm_chunk_every_head_group_gives_the_same_bits(dev, G, Q, N, P, heads):
    """Each divisor of ``heads`` as the heads per block (what head_plan may
    choose): against the plain version, and the same bits for all of
    them, C.B^T shared or not."""
    from repro_torch.kernels.ssm_chunk import head_plan, ssm_chunk_cuda

    args = _ssm_inputs(dev, G, Q, N, P, heads, torch.float32, seed=G + N)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = [d for d in range(1, heads + 1) if heads % d == 0]
    assert head_plan(G, heads, sms, Q, N, P) in groups
    y_p, s_p = ref.ssm_chunk_ref(*args, heads)
    first = None
    for hg in groups:
        y, s = ssm_chunk_cuda(*args, heads=heads, head_group=hg)
        torch.cuda.synchronize()
        _close(y, y_p, 2e-5)
        _close(s, s_p, 2e-5)
        if first is None:
            first = (y, s)
        assert torch.equal(y, first[0]) and torch.equal(s, first[1])

"""The CUDA kernels on the card: each against its plain version over a
shape grid, launch counting, refusal of what a kernel does not take, the
engine's fused and unfused routes (non-private and private, single-device
and sharded) against the CPU route, the captured chunks against the eager
slots, and the zamba2 path (a Mamba2 block through ``ssm_chunk``, a
2-layer full-width hybrid's prefill against its decode loop).

Then checkpoints and serving on the card: resume through the captured
chunk (into a fresh engine and into the same one), dynamic resume across
a refresh and an admission, snapshots isolated from later replays,
``predict`` on a second thread while the engine trains, and checkpoint
serving on the card and the CPU. Then the phase programs captured on the
card (equal to the eager slot, leaving the state and its generator as they
were), the reference kernel bench's shapes, the training round, and last
the transformer families (dense, MoE, enc-dec: a bf16 forward against
float32, the MoE prefill and its routing against the CPU, an enc-dec
prefill against its decode loop, a reduced round of each against the
CPU) and the xLSTM family (a full-width 2-block prefill against its decode
loop, the reduced forward and gradients against the CPU, a reduced round),
which launch no kernel of ours.

Marked ``cuda``: every test skips where there is no CUDA device. Run on a
GPU machine with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``
(add ``--noconftest`` where JAX is not installed: the suite's conftest
imports it, this file does not).
Tolerance 1e-5 relative to the largest output: float32 sums taken in
another order than the plain version's; 1e-4 (``MODEL_TOL``) for whole
Mamba2 blocks and models, whose float32 routes differ in many sums.
"""

import contextlib
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


# ---------------------------------------------------------------------------
# The captured chunk (repro_torch.sim.capture): replayed CUDA graphs against
# the eager slots, bit for bit
# ---------------------------------------------------------------------------

CAPTURE_CASES = ["fused", "unfused", "dp_fused", "dp_unfused", "delay", "churn_straggler",
                 "propagation", "fused_metrics", "dp_unfused_metrics"]


def _capture_engine(dev, case, n=512, steps_per_chunk=16):
    """A card engine for one case of the captured-chunk gate: n = 512,
    k-NN graph, quadratic loss, 64 expected wakes a slot; the private
    cases plan 3 updates an agent, so budgets run out within 37 slots."""
    from repro_torch.sim import ChurnConfig, DelayConfig, PropagationUpdate, Scenario
    from repro_torch.sim import StragglerConfig

    rng = np.random.default_rng(11)
    p, m = 8, 4
    graph = knn_graph(rng.normal(size=(n, 6)), k=6)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)))
    clip = 1.0 if case.startswith("dp") else None
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, clip=clip, mix_mode="sparse")
    kw = dict(slot_wakes=64.0, seed=5, device=dev, steps_per_chunk=steps_per_chunk,
              fused="auto" if "fused" in case and "unfused" not in case else False,
              metrics=case.endswith("metrics"))
    if case == "delay":
        kw["scenario"] = Scenario(delay=DelayConfig(max_delay=3, edge_delays=2))
    elif case in ("churn_straggler", "fused_metrics", "dp_unfused_metrics"):
        kw["scenario"] = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                                  straggler=StragglerConfig(drop_prob=0.2))
    if case.startswith("dp"):
        upd = DPCDUpdate.plan(obj, DPConfig(eps_bar=0.5), planned_Ti=3)
    elif case == "propagation":
        upd = PropagationUpdate(graph, rng.normal(size=(n, p)), 0.4, obj.confidences)
    else:
        upd = CDUpdate(obj)
    eng = AsyncEngine(upd, **kw)
    assert eng.fused == (kw["fused"] == "auto")
    return eng, rng.normal(size=(n, p))


def _assert_states_equal(a, b):
    for name in ("Theta", "hist", "ptr", "active", "applied", "dropped", "messages"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    if isinstance(a.ustate, torch.Tensor):
        assert torch.equal(a.ustate, b.ustate)
    assert (a.metrics is None) == (b.metrics is None)
    for k in (a.metrics or {}):
        assert torch.equal(a.metrics[k], b.metrics[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("case", CAPTURE_CASES)
def test_captured_chunk_equals_eager_bit_for_bit(dev, case):
    """37 slots at steps_per_chunk = 16 (one eager warm-up slot, two chunk
    replays, four replays of the one-slot graph) from the same state and
    seed as 37 eager slots: every state tensor, the metrics and the
    generator's position are equal bit for bit."""
    eng, Theta0 = _capture_engine(dev, case)
    captured = eng.advance(eng.init_state(Theta0), 37)
    eager = eng._eager_slots(eng.init_state(Theta0), 37)
    torch.cuda.synchronize()
    assert sorted(eng._graphs.graphs) == [1, 16]
    assert int(captured.ptr) == 37 and int(captured.applied) > 0
    _assert_states_equal(captured, eager)
    assert not torch.equal(captured.Theta, torch.as_tensor(Theta0, dtype=torch.float32,
                                                           device=dev))


@pytest.mark.parametrize("case", ["fused", "dp_unfused_metrics"])
def test_captured_resume_and_foreign_states_equal_eager(dev, case):
    """A run resumed from ``SimResult.state``, a second ``init_state`` (its
    tensors and generator copied into the live buffers) and another
    engine's state all give the eager result; nothing is captured anew."""
    eng, Theta0 = _capture_engine(dev, case)
    want = eng._eager_slots(eng.init_state(Theta0), 37)
    first = eng.run(Theta0, 20)
    resumed = eng.run(None, 17, state=first.state)
    _assert_states_equal(resumed.state, want)
    graphs = dict(eng._graphs.graphs)
    fresh = eng.advance(eng.init_state(Theta0), 37)  # a foreign state, copied in
    _assert_states_equal(fresh, want)
    assert fresh.Theta is first.state.Theta  # the live buffers
    other, _ = _capture_engine(dev, case)
    half = other.advance(other.init_state(Theta0), 20)
    again = eng.advance(half, 17)  # another engine's state, copied in
    _assert_states_equal(again, want)
    assert eng._graphs.graphs == graphs


@pytest.mark.parametrize("case", ["fused", "unfused", "dp_fused", "delay"])
def test_captured_launch_counts_equal_eager(dev, case):
    """The counts after k captured slots equal those after k eager slots:
    the capture's recorded launches are taken out and each replay adds its
    own."""
    eng, Theta0 = _capture_engine(dev, case)
    counts = []
    for run in (eng.advance, eng._eager_slots):
        state = eng.init_state(Theta0)
        ops.reset_launch_counts()
        run(state, 37)
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
    assert counts[0] == counts[1]
    kernel = "fused_row_update" if eng.fused else "sparse_mix"
    assert counts[0][kernel] == (37 if case != "delay" else 0)


def test_metrics_on_card_agree_with_the_state_and_theta_is_unchanged(dev):
    """Metrics on and off give the same Theta captured; the counters agree
    with the engine's own (applied wakes, budget-stopped agents)."""
    on, Theta0 = _capture_engine(dev, "dp_unfused_metrics")
    off = AsyncEngine(on.update, config=on.config.replace(metrics=None))
    a = on.advance(on.init_state(Theta0), 37)
    b = off.advance(off.init_state(Theta0), 37)
    assert torch.equal(a.Theta, b.Theta) and b.metrics is None
    counters, derived = on.metrics_snapshot(a)
    assert int(counters["wakes_applied"]) == int(a.applied)
    assert int(counters["dp_budget_stopped"]) == on.update.budget_stopped(a.ustate)
    assert int(counters["staleness_hist"].sum()) == int(a.applied)
    assert derived["dp_eps_spent_max"] > 0


def test_a_capture_failure_raises_and_nothing_runs_eagerly(dev):
    """A slot that reads a device value on the host cannot be captured: the
    engine raises (it never carries on eagerly), and the launch counts and
    the current stream are as before the capture."""
    obj, _ = _dp_problem(seed=3)

    class HostRead(CDUpdate):
        def apply(self, Theta, rows, valid, neigh, generator, state):
            if bool(valid.any()):  # a host read: no graph can hold it
                return super().apply(Theta, rows, valid, neigh, generator, state)
            return neigh, valid, state

    eng = AsyncEngine(HostRead(obj), slot_wakes=32.0, fused=False, device=dev)
    state = eng.init_state(np.zeros((obj.n, obj.p)))
    stream = torch.cuda.current_stream(dev)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        eng.advance(state, 5)
    assert torch.cuda.current_stream(dev) == stream
    assert ops.launch_counts()["sparse_mix"] == 1  # the eager warm-up slot only
    assert int(state.ptr) == 1 and not eng._graphs.graphs


# ---------------------------------------------------------------------------
# The sharded engine on the card: S shards stacked on one device
# ---------------------------------------------------------------------------

SHARDED_CASES = ["fused", "unfused", "fused_bf16_ef_metrics", "dp_fused", "unfused_int8_churn"]


def _sharded_engine(dev, case, n=384):
    """A card ShardedAsyncEngine for one case: S = 4, RCM relabel, k-NN
    graph, quadratic loss, 64 expected wakes a slot."""
    from repro_torch.sim import (ChurnConfig, ExchangeSpec, Scenario, ShardedAsyncEngine,
                                 StragglerConfig)

    rng = np.random.default_rng(13)
    p, m = 8, 4
    graph = knn_graph(rng.normal(size=(n, 6)), k=6)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)))
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, clip=1.0 if case.startswith("dp") else None, mix_mode="sparse")
    wire = {"fused_bf16_ef_metrics": "p2p:bf16:ef", "unfused_int8_churn": "all_gather:int8"}
    kw = dict(num_shards=4, relabel="rcm", slot_wakes=64.0, seed=5, device=dev,
              fused="auto" if "unfused" not in case else False,
              exchange=ExchangeSpec.from_string(wire.get(case, "auto")),
              metrics=case.endswith("metrics"))
    if case.endswith("churn"):
        kw["scenario"] = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                                  straggler=StragglerConfig(drop_prob=0.2))
    upd = (DPCDUpdate.plan(obj, DPConfig(eps_bar=0.5), planned_Ti=3) if case.startswith("dp")
           else CDUpdate(obj))
    eng = ShardedAsyncEngine(upd, **kw)
    assert eng.fused == (kw["fused"] == "auto")
    return eng, rng.normal(size=(n, p))


def _assert_sharded_states_equal(a, b):
    for name in ("Theta", "slab", "ptr", "active", "applied", "dropped", "messages"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name in ("ef", "ustate"):
        if isinstance(getattr(a, name), torch.Tensor):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    for k in (a.metrics or {}):
        assert torch.equal(a.metrics[k], b.metrics[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("case", [c for c in SHARDED_CASES if not c.startswith("dp")])
def test_sharded_forced_slots_on_the_card_match_the_cpu(dev, case):
    """Forced wakes at S = 4 on the card against the same engine on the CPU
    (the plain versions there), and the fused kernel launched once a slot.
    (The private case draws its noise from each device's generator, so it
    is held captured against eager only.)"""
    from repro_torch.sim import ShardedAsyncEngine

    eng, Theta0 = _sharded_engine(dev, case)
    cpu = ShardedAsyncEngine(eng.update, num_shards=4,
                             config=eng.config.replace(device="cpu", fused=eng.fused))
    masks = list(np.random.default_rng(3).random((10, eng.n)) < 0.2)
    ops.reset_launch_counts()
    a = eng.init_state(Theta0)
    for mask in masks:
        a = eng.step(a, mask)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_row_update"] == (len(masks) if eng.fused else 0)
    b = cpu.init_state(Theta0)
    for mask in masks:
        b = cpu.step(b, mask)
    _close(torch.as_tensor(eng.global_theta(a)), torch.as_tensor(cpu.global_theta(b)))
    assert int(a.applied.sum()) == int(b.applied.sum())


@pytest.mark.parametrize("case", SHARDED_CASES)
def test_sharded_captured_chunk_equals_eager_bit_for_bit(dev, case):
    """37 sampled slots of the stacked S = 4 slot through the captured
    graphs and eagerly: every state tensor (the slab, ``ef``, the metrics),
    the generator's position and the launch counts are equal."""
    eng, Theta0 = _sharded_engine(dev, case)
    counts = []
    states = []
    for run in (eng.advance, eng._eager_slots):
        ops.reset_launch_counts()
        states.append(run(eng.init_state(Theta0), 37))
        torch.cuda.synchronize()
        counts.append(ops.launch_counts())
    assert sorted(eng._graphs.graphs) == [1, 16]
    assert int(states[0].ptr[0]) == 37 and int(states[0].applied.sum()) > 0
    _assert_sharded_states_equal(*states)
    assert counts[0] == counts[1]
    assert counts[0]["fused_row_update"] == (37 if eng.fused else 0)


@pytest.mark.parametrize("p", [8, 5])
def test_sharded_fused_slot_against_single_device_fused_on_the_card(dev, p):
    """The sharded fused slot (S = 4, one launch over the stacked slab)
    against the single-device fused slot on the card, forced wakes: the
    float4 instance at p = 8, the scalar one at p = 5 on both."""
    from repro_torch.kernels.fused_row_update import row_plan
    from repro_torch.sim import ShardedAsyncEngine

    rng = np.random.default_rng(17)
    n, m = 300, 3
    graph = knn_graph(rng.normal(size=(n, 6)), k=6)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)))
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse")
    masks = list(rng.random((6, n)) < 0.2)
    Theta0 = rng.normal(size=(n, p))
    single = AsyncEngine(CDUpdate(obj), slot_wakes=64.0, device=dev)
    sharded = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, relabel="rcm", slot_wakes=64.0,
                                 device=dev)
    assert single.fused and sharded.fused
    a, b = single.init_state(Theta0), sharded.init_state(Theta0)
    assert row_plan(1, p, (b.slab,)).vec == (p % 4 == 0)
    for mask in masks:
        a, b = single.step(a, mask), sharded.step(b, mask)
    _close(torch.as_tensor(sharded.global_theta(b)), a.Theta.cpu(), tol=2e-5)


# Dynamic topology (repro_torch.sim: GraphUpdate, ArrivalConfig, set_topology,
# admit) on the card: the dynamic slot gathers with an einsum over
# capacity-padded tiles, which the captured chunk reads in place.

DYN_IDS = (500, 501, 502, 503)


def _dyn_obj(n=512):
    rng = np.random.default_rng(1)
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    X = rng.normal(size=(n, 3, 4)) / 2.0
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, 4)) / 2.0)
    return make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, 3))), "quadratic",
                          mu=0.5, mix_mode="sparse")


def _dyn_engine(obj, device, sharded=False, **kw):
    from repro_torch.sim import (ArrivalConfig, ChurnConfig, GraphUpdate, Scenario,
                                 ShardedAsyncEngine, StragglerConfig)

    cfg = dict(slot_wakes=64.0, seed=2, device=device,
               scenario=Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                                 straggler=StragglerConfig(drop_prob=0.2),
                                 arrival=ArrivalConfig(schedule=((10**6, DYN_IDS),), seed=3)),
               graph_update=GraphUpdate(every=10**6, k=3, candidates=4, gamma=2.0, seed=1))
    cfg.update(kw)
    if sharded:
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=4, relabel="rcm", **cfg)
    return AsyncEngine(CDUpdate(obj), **cfg)


def _leaves(state):
    out = {n: getattr(state, n) for n in state._fields
           if isinstance(getattr(state, n), torch.Tensor)}
    out["generator"] = state.generator.get_state()
    return out


def _hub(csr, agent=1, count=60):
    from repro_torch.core.graph import csr_from_coo

    others = np.array([j for j in range(csr.n) if j != agent and j not in DYN_IDS][:count])
    return csr_from_coo(csr.n, np.concatenate([csr.row_ids(), np.full(len(others), agent)]),
                        np.concatenate([csr.indices, others]),
                        np.concatenate([csr.data, np.ones(len(others))]), symmetrize=True)


def test_dynamic_slot_matches_static_and_the_cpu_on_the_card(dev):
    """A dynamic engine whose refresh never fires against the static
    unfused engine (einsum against sparse_mix: 1e-5), and forced runs with
    an explicit refresh and admission on the card against the CPU (1e-5,
    the same graph and log)."""
    from repro_torch.sim import GraphUpdate

    obj = _dyn_obj()
    rng = np.random.default_rng(4)
    masks = list(rng.random((16, 512)) < 0.25)
    Theta0 = rng.normal(size=(512, 4))

    def forced(eng, events=False):
        state = eng.init_state(Theta0)
        for k, mask in enumerate(masks):
            state = eng.step(state, mask)
            if events and k == 5:
                state = eng._refresh_topology(state, 1)
            if events and k == 10:
                state = eng.admit(state, DYN_IDS)
        return state.Theta.cpu() if not hasattr(eng, "num_shards") else \
            torch.as_tensor(eng.global_theta(state))

    static = forced(AsyncEngine(CDUpdate(obj), slot_wakes=64.0, fused=False, device=dev))
    dynamic = forced(AsyncEngine(CDUpdate(obj), slot_wakes=64.0, device=dev,
                                 graph_update=GraphUpdate(every=10**9)))
    _close(dynamic, static)
    for sharded in (False, True):
        card, cpu = _dyn_engine(obj, dev, sharded), _dyn_engine(obj, "cpu", sharded)
        _close(forced(card, True), forced(cpu, True))
        np.testing.assert_array_equal(card._csr.indices, cpu._csr.indices)
        a, b = card.topology_counters(), cpu.topology_counters()
        # The drift is a ratio of edge weights, exp(-d2 / gamma) of float32
        # models that differ in their last bits between the two devices.
        assert abs(a.pop("last_drift") - b.pop("last_drift")) <= 1e-6 and a == b


@pytest.mark.parametrize("sharded", [False, True])
def test_dynamic_captured_equals_eager_across_swaps(dev, sharded):
    """37 slots before and after each swap, captured and eager from the same
    seed: every state tensor equal. Single-device: a refresh within the
    slot capacity keeps the graphs, a hub that grows it recaptures once,
    an admission; sharded (S = 4): a weight-only patch, a structural patch
    and an admission each recapture (the slab changes), and a repartition
    forced by drift_threshold=-10 on a second pair."""

    def refresh(e, s):
        return e._refresh_topology(s, 1)

    def admit(e, s):
        return e.admit(s, DYN_IDS)

    def grow(e, s):
        e.set_topology(_hub(e._csr))
        return s

    def reweight(e, s):
        c = e._csr
        return e.set_topology(s, type(c)(indptr=c.indptr, indices=c.indices, data=c.data * 1.5))

    obj = _dyn_obj()
    if sharded:
        plans = [(dict(drift_threshold=10.0), [("weight", reweight, 1), ("structural", refresh, 1),
                                               ("admit", admit, 1)]),
                 (dict(drift_threshold=-10.0), [("repartition", refresh, 1)])]
    else:
        plans = [({}, [("refresh", refresh, 0), ("grow", grow, 1), ("admit", admit, 0)])]
    for kw, swaps in plans:
        cap, eag = _dyn_engine(obj, dev, sharded, **kw), _dyn_engine(obj, dev, sharded, **kw)
        zeros = np.zeros((512, 4), dtype=np.float32)
        sc, se = cap.advance(cap.init_state(zeros), 37), eag._eager_slots(eag.init_state(zeros), 37)
        for name, fn, recaptures in swaps:
            before = cap._graphs.recaptures
            sc, se = fn(cap, sc), fn(eag, se)
            sc, se = cap.advance(sc, 37), eag._eager_slots(se, 37)
            a, b = _leaves(sc), _leaves(se)
            assert all(torch.equal(a[k], b[k]) for k in a), (name, [k for k in a
                                                                    if not torch.equal(a[k], b[k])])
            assert cap.topology_counters() == eag.topology_counters(), name
            assert cap._graphs.recaptures - before == recaptures, name
            assert sorted(cap._graphs.graphs) == [1, 16]
    if sharded:
        assert cap.topology_counters()["repartitions"] == 1


# ---------------------------------------------------------------------------
# Checkpoints and serving on the card (repro_torch.checkpoint, repro_torch.serve)
# ---------------------------------------------------------------------------


def _copy_leaves(state):
    """Every tensor of a state and the generator's state, copied (a live
    state's tensors are overwritten by later replays)."""
    from repro_torch.checkpoint.checkpoint import _flatten_with_paths

    return {p: (leaf.get_state().clone() if isinstance(leaf, torch.Generator)
                else leaf.detach().clone()) for p, leaf in _flatten_with_paths(state)}


def _assert_leaves_equal(got, want):
    assert got.keys() == want.keys()
    bad = [k for k in got if not torch.equal(got[k].cpu(), want[k].cpu())]
    assert not bad, bad


@pytest.mark.parametrize("case", ["fused", "dp_unfused_metrics", "churn_straggler",
                                  "sharded_fused_bf16_ef_metrics"])
def test_checkpoint_resume_through_the_captured_chunk(dev, case, tmp_path):
    """37 captured slots, save, then 21 more: restored into a fresh engine
    (adopted as its live buffers) and into the same engine after it moved
    on (copied in through ``ChunkGraphs.bind``), both equal the
    uninterrupted 58 captured slots in every tensor and the generator's
    state; the entry restores on the CPU only where no stream must cross."""
    from repro_torch.checkpoint import CheckpointError, restore, save_engine_checkpoint

    def make():
        if case.startswith("sharded"):
            return _sharded_engine(dev, case.removeprefix("sharded_"))
        return _capture_engine(dev, case)

    ref_eng, Theta0 = make()
    want = _copy_leaves(ref_eng.advance(ref_eng.init_state(Theta0), 58))
    eng, _ = make()
    state = eng.advance(eng.init_state(Theta0), 37)
    ck = str(tmp_path / "ck")
    save_engine_checkpoint(eng, state, ck)
    fresh, _ = make()
    st, step = restore(fresh, ck)
    assert step == 37
    _assert_leaves_equal(_copy_leaves(fresh.advance(st, 21)), want)
    assert sorted(fresh._graphs.graphs) == [1, 16]
    eng.advance(state, 9)  # the live buffers move on
    st, _ = restore(eng, ck)
    again = eng.advance(st, 21)
    assert again.Theta is state.Theta  # copied into the live buffers
    _assert_leaves_equal(_copy_leaves(again), want)
    cpu = type(eng)(eng.update, **({"num_shards": eng.num_shards} if case.startswith("sharded")
                                   else {}), config=eng.config.replace(device="cpu"))
    with pytest.raises(CheckpointError, match="generator"):
        restore(cpu, ck)


def test_dynamic_checkpoint_resume_through_the_captured_chunk(dev, tmp_path):
    """A dynamic engine's run cut before and after a refresh and an
    admission, restored into a fresh engine: the resumed run equals the
    uninterrupted one in every tensor, the generator, the graph and the
    topology log, single-device and sharded."""
    from repro_torch.checkpoint import restore, save_engine_checkpoint
    from repro_torch.sim import ArrivalConfig, ChurnConfig, GraphUpdate, Scenario

    obj = _dyn_obj()
    scen = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                    arrival=ArrivalConfig(schedule=((30, DYN_IDS),), seed=3))
    gu = GraphUpdate(every=20, k=3, candidates=4, gamma=2.0, seed=1)
    zeros = np.zeros((512, 4), dtype=np.float32)
    for sharded in (False, True):
        def make():
            return _dyn_engine(obj, dev, sharded, scenario=scen, graph_update=gu)

        ref = make()
        want = _copy_leaves(ref.run(zeros, 50).state)
        for cut in (20, 25, 40):
            eng = make()
            half = eng.run(zeros, cut)
            save_engine_checkpoint(eng, half.state, str(tmp_path / f"ck{sharded}{cut}"))
            res = make()
            st, _ = restore(res, str(tmp_path / f"ck{sharded}{cut}"))
            fin = res.run(None, 50 - cut, state=st)
            _assert_leaves_equal(_copy_leaves(fin.state), want)
            assert res.topology_counters() == ref.topology_counters(), (sharded, cut)
            assert res._csr.digest() == ref._csr.digest()


def test_snapshots_are_isolated_from_later_replays(dev):
    """A published snapshot is a copy: replays of the captured chunk, which
    write the live buffers in place, leave it unchanged."""
    from repro_torch.serve import ServeHandle

    for eng, Theta0 in (_capture_engine(dev, "fused"), _sharded_engine(dev, "fused")):
        handle = ServeHandle.for_engine(eng)
        state = eng.advance(eng.init_state(Theta0), 20)
        handle.publish(state)
        snap = handle.snapshot()
        kept = snap.tiles.clone()
        live = state.Theta if snap.tiles.shape[0] > 1 else state.Theta.unsqueeze(0)
        assert snap.tiles.data_ptr() != live.data_ptr()
        eng.advance(state, 48)
        torch.cuda.synchronize()
        assert torch.equal(snap.tiles, kept) and not torch.equal(live, kept)
        assert handle.publish_device_seconds() > 0


@pytest.mark.parametrize("sharded", [False, True])
def test_predict_on_a_second_thread_while_the_engine_trains(dev, sharded):
    """run(snapshot_every=1) in a trainer thread through the captured chunk
    while this thread predicts from pinned snapshots: every answer equals a
    recomputation from its version's snapshot bit for bit (warm rows, K =
    1), versions only grow, and the last one is the trainer's final slot."""
    import threading

    from repro_torch.serve import ServeHandle

    eng, Theta0 = _sharded_engine(dev, "fused") if sharded else _capture_engine(dev, "fused")
    handle = ServeHandle.for_engine(eng)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, eng.n, 256)
    X = rng.normal(size=(256, eng.p)).astype(np.float32)
    box, done = {}, threading.Event()

    def train():
        try:
            box["result"] = eng.run(Theta0, 96, snapshot_every=1, serve=handle)
        finally:
            done.set()

    trainer = threading.Thread(target=train)
    trainer.start()
    answers = []
    while not done.is_set():
        if handle.published:
            snap = handle.snapshot()
            answers.append((snap, handle.predict(ids, X, at=snap)))
    trainer.join()
    snap = handle.snapshot()
    answers.append((snap, handle.predict(ids, X, at=snap)))
    assert "result" in box and len(answers) > 1
    sids = np.zeros_like(ids) if snap.shard_of is None else snap.shard_of[ids]
    lids = ids if snap.local_of is None else snap.local_of[ids]
    versions = []
    for snap, res in answers:
        rows = snap.tiles[torch.as_tensor(sids, device=dev), torch.as_tensor(lids, device=dev)]
        want = (rows * torch.as_tensor(X, device=dev)).sum(dim=-1).cpu().numpy()
        assert res.version == snap.version and np.array_equal(res.values, want)
        versions.append(res.version)
    assert versions == sorted(versions)
    assert handle.version == box["result"].slots == 96


def test_serve_from_checkpoint_on_the_card_and_the_cpu(dev, tmp_path):
    """A card run's entry served on the card (its default device) and on
    the CPU: warm rows are the run's final Theta exactly on both,
    predictions agree within 1e-6, cold rows within 1e-6."""
    from repro_torch.serve import serve_from_checkpoint

    for eng, Theta0 in (_capture_engine(dev, "fused"), _sharded_engine(dev, "fused")):
        ck = str(tmp_path / type(eng).__name__)
        res = eng.run(Theta0, 40, checkpoint_every=20, checkpoint_dir=ck, checkpoint_keep_last=2)
        card = serve_from_checkpoint(ck)
        cpu = serve_from_checkpoint(ck, device="cpu")
        assert card.snapshot().tiles.is_cuda and card.version == cpu.version == 40
        ids = np.arange(eng.n)
        assert np.array_equal(card.rows(ids).values, res.Theta.astype(np.float32))
        assert np.array_equal(cpu.rows(ids).values, res.Theta.astype(np.float32))
        X = np.random.default_rng(1).normal(size=(eng.n, eng.p))
        np.testing.assert_allclose(card.predict(ids, X).values, cpu.predict(ids, X).values,
                                   rtol=1e-6, atol=1e-6)
        nb = {eng.n + 1: (0, 5, 9)}
        np.testing.assert_allclose(card.rows([eng.n + 1], neighbors=nb).values,
                                   cpu.rows([eng.n + 1], neighbors=nb).values, rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# Phase programs, traces and the kernel bench on the card (A10b, A14)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["fused", "unfused", "fused_bf16_ef_metrics"])
def test_captured_phase_programs_on_the_card(dev, case):
    """Each prefix is a captured graph on the scratch state: the full-slot
    program equals one eager slot on a copy, bit for bit; every prefix
    leaves the given state and its generator as they were and counts its
    launches; the engine's chunk graphs are untouched; a profile leaves
    the engine equal to an unprofiled twin after 37 more slots."""
    from repro_torch.obs import SpanRecorder, profile_supertick
    from repro_torch.sim import ShardedAsyncEngine
    from repro_torch.sim.capture import clone_state

    eng, Theta0 = _sharded_engine(dev, case)
    twin = ShardedAsyncEngine(eng.update, num_shards=4, config=eng.config)
    state = eng.advance(eng.init_state(Theta0), 5)
    tstate = twin.advance(twin.init_state(Theta0), 5)
    chunk_graphs = dict(eng._graphs.graphs)
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in _leaves(state).items()}
    want = eng._slot(clone_state(state), None)
    full = eng.phase_program(None)
    full.load(state)  # the first load warms up eagerly (a launch) and captures
    ops.reset_launch_counts()
    got = full(state)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_row_update"] == (1 if eng.fused else 0)
    _assert_sharded_states_equal(got, want)
    for name in eng.phase_names:
        eng.phase_program(name)(state)
        assert eng.phase_program(name).graph is not None
    recorder = SpanRecorder(dev)
    assert recorder.nvtx
    prof = profile_supertick(eng, state=state, inner=2, repeats=2, recorder=recorder)
    assert tuple(prof.phases) == eng.phase_names and 0.5 < prof.coverage < 2.0
    assert eng._graphs.graphs == chunk_graphs
    after = _leaves(state)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    state, tstate = eng.advance(state, 37), twin.advance(tstate, 37)
    _assert_sharded_states_equal(state, tstate)


@pytest.mark.parametrize("case", ["fused_metrics", "unfused", "dp_unfused_metrics"])
def test_single_device_phase_programs_on_the_card(dev, case):
    """The single-device prefixes captured on the card: the full-slot
    program equals one eager slot on a copy bit for bit, every prefix
    leaves the state it was given as it was, and the engine then equals an
    unprofiled twin after 37 more captured slots."""
    from repro_torch.obs import profile_supertick
    from repro_torch.sim.capture import clone_state

    eng, Theta0 = _capture_engine(dev, case)
    twin, _ = _capture_engine(dev, case)
    state = eng.advance(eng.init_state(Theta0), 5)
    tstate = twin.advance(twin.init_state(Theta0), 5)
    want = eng._slot(clone_state(state), None)
    _assert_states_equal(eng.phase_program(None)(state), want)
    profile_supertick(eng, state=state, inner=2, repeats=2)
    _assert_states_equal(state, tstate)
    _assert_states_equal(eng.advance(state, 37), twin.advance(tstate, 37))


def test_kernel_bench_shapes_on_the_card(dev):
    """The reference kernel bench's four shapes: each kernel within its
    tolerance of its plain version (``measure`` raises otherwise)."""
    from repro_torch.bench import kernels

    res = kernels.measure(dev)
    assert set(res) == {"dp_clip_noise", "graph_mix", "ssm_chunk", "fused_row_update"}
    for r in res.values():
        assert r["max_abs_err"] <= r["tol"] and r["ms"] > 0 and r["bound_ms"] > 0


class _Cycle:
    """A reference cycle holding ``items``: only the garbage collector frees it."""

    def __init__(self, items):
        self.items, self.me = items, self


def test_a_capture_survives_the_collector_freeing_another_engines_graphs(dev):
    """An engine holds its graphs in a reference cycle, so only the garbage
    collector frees a dropped engine's graphs, and a graph destroyed while
    another stream captures invalidates that capture. ``capture`` keeps the
    collector off: a captured engine's two graphs, held by a young cycle
    alone, become garbage inside the captured function with the collector
    set to run at every allocation, and the capture holds; the graphs go at
    the next collection."""
    import gc
    import weakref

    from repro_torch.sim.capture import capture

    eng, Theta0 = _capture_engine(dev, "fused_metrics")
    eng.advance(eng.init_state(Theta0), 20)  # a 16-slot graph and a one-slot graph
    graphs = [graph for graph, _ in eng._graphs.graphs.values()]
    assert len(graphs) == 2
    eng._graphs.reset()  # the graphs now live only in the cycle below
    box = [_Cycle(graphs)]
    gone = weakref.ref(box[0])
    del graphs, eng
    y = torch.zeros(8, device=dev)
    threshold = gc.get_threshold()

    def fn():
        box.clear()  # the cycle is garbage from here on
        gc.set_threshold(1, 1, 1)
        for _ in range(200):
            [[] for _ in range(8)]
        return y.add_(1)

    try:
        graph, _, _ = capture(fn, torch.Generator(device=dev), torch.cuda.Stream(dev))
    finally:
        gc.set_threshold(*threshold)
    assert gone() is not None  # nothing was collected while capturing
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, torch.ones(8, device=dev))
    gc.collect()
    assert gone() is None


# The P2P-DP training round (core/spmd.py) on the card. The small shape is
# G = 2 batch rows x 2 chunks x 4 heads; (2048, 128, 64, 64, 64) is the
# zamba2-1.2b training shape: 2 x 16 chunks x 64 heads.
@pytest.mark.parametrize("G,Q,N,P,heads", [(16, 16, 16, 16, 4), (2048, 128, 64, 64, 64)])
def test_ssm_chunk_ad_kernel_forward_plain_backward_matches_plain_autograd(dev, G, Q, N, P,
                                                                           heads):
    """``ssm_chunk_ad`` on the card: the kernel's forward (one launch) and
    the plain version's backward (none), against the plain version's
    autograd on the same inputs and upstream gradients: outputs 1e-5,
    gradients 2e-5 relative to max(1, max |g|)."""
    from repro_torch.kernels.ssm_chunk import ssm_chunk_plain

    args = _ssm_inputs(dev, G, Q, N, P, heads, torch.float32, seed=G + 5)
    g = torch.Generator(device=dev).manual_seed(11)
    wy = torch.randn((G, Q, P), generator=g, device=dev)
    ws = torch.randn((G, P, N), generator=g, device=dev)
    ours = [a.clone().requires_grad_(True) for a in args]
    plain = [a.clone().requires_grad_(True) for a in args]
    before = ops.launch_counts()["ssm_chunk"]
    y, s = ops.ssm_chunk_ad(*ours, heads)
    ((y * wy).sum() + (s * ws).sum()).backward()
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssm_chunk"] == before + 1
    y_p, s_p = ssm_chunk_plain(*plain, heads)
    ((y_p * wy).sum() + (s_p * ws).sum()).backward()
    _close(y.detach(), y_p.detach())
    _close(s.detach(), s_p.detach())
    for a, b in zip(ours, plain):
        _close(a.grad, b.grad, 2e-5)


def _reduced_training(device, remat=True):
    """zamba2's reduced float32 config, 4 agents drawn on the CPU (copied to
    ``device``), 2 x 33 tokens each, and its bundle on ``device``."""
    from repro_torch.configs import get_reduced
    from repro_torch.utils.tree import tree_map

    cfg = get_reduced("zamba2-1.2b", dtype="float32")
    params = build_model(cfg, device="cpu").init_agents(4, 0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2, 33), generator=torch.Generator().manual_seed(1))
    return (build_model(cfg, remat=remat, device=device),
            tree_map(lambda x: x.to(device), params), tokens.to(device))


def _round(bundle, params, tokens, route="ppermute"):
    from repro_torch.configs.base import P2PConfig
    from repro_torch.core import spmd

    p2p = P2PConfig(dp_enabled=False, mu=0.2, neighbor_offsets=(1,), gossip_dtype=None)
    step, _, _ = spmd.make_train_step(bundle, p2p, 4, 2, alpha=0.5, gossip=route)
    return step(params, {"tokens": tokens})


@pytest.mark.parametrize("route", ["ppermute", "dense", "sparse"])
def test_training_round_on_the_card_matches_the_cpu(dev, route):
    """One reduced round through the kernel on the card against the same
    round through the einsums on the CPU: every agent's parameters and
    both metrics within 1e-5."""
    from repro_torch.utils.tree import tree_flatten_with_path

    got, got_m = _round(*_reduced_training(dev), route)
    want, want_m = _round(*_reduced_training("cpu"), route)
    for (name, a), (_, b) in zip(tree_flatten_with_path(got), tree_flatten_with_path(want)):
        _close(a.cpu(), b)
    for k in ("loss", "grad_norm"):
        _close(got_m[k].cpu(), want_m[k])


def test_training_gradients_with_remat_on_and_off_give_the_same_bits(dev):
    from repro_torch.core import spmd
    from repro_torch.utils.tree import tree_flatten_with_path

    bundle, params, tokens = _reduced_training(dev, remat=True)
    on = spmd.agent_losses_and_grads(bundle, params, {"tokens": tokens})
    off = spmd.agent_losses_and_grads(build_model(bundle.cfg, remat=False, device=dev), params,
                                      {"tokens": tokens})
    assert torch.equal(on[0], off[0])
    for (name, a), (_, b) in zip(tree_flatten_with_path(on[1]), tree_flatten_with_path(off[1])):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("remat", [True, False])
def test_training_round_launches_ssm_chunk_twice_a_layer_and_agent(dev, remat):
    """2 L A launches a round with remat (forward, then the recompute in
    the backward), L A without; the backward itself launches none."""
    bundle, params, tokens = _reduced_training(dev, remat=remat)
    before = ops.launch_counts()["ssm_chunk"]
    _round(bundle, params, tokens)
    torch.cuda.synchronize()
    L = bundle.cfg.num_layers
    assert ops.launch_counts()["ssm_chunk"] - before == (2 if remat else 1) * L * 4


# The transformer families (dense, MoE, VLM, enc-dec): plain PyTorch on the
# card, no kernel of ours, as in the JAX package.

BF16_TOL = 3e-2  # bf16 keeps about 3 significant digits (tests/test_torch_hybrid.py)


def _family_full_width(arch, num_layers, dtype="float32", **kw):
    return dataclasses.replace(get_config(arch), num_layers=num_layers, dtype=dtype, **kw)


def test_llama_bf16_forward_matches_float32_on_the_card(dev):
    """llama3.2-1b at full width cut to 2 layers: the bf16 model (the
    float32 weights rounded) against the float32 one, 2 x 128 tokens."""
    from repro_torch.models import transformer

    f32 = build_model(_family_full_width("llama3.2-1b", 2), device=dev)
    model = f32.init(0)
    cfg16 = _family_full_width("llama3.2-1b", 2, dtype="bfloat16")
    model16 = transformer.TransformerLM(cfg16, device=dev)
    model16.load_state_dict({k: v.to(torch.bfloat16) for k, v in model.state_dict().items()})
    tokens = torch.randint(0, cfg16.vocab_size, (2, 128),
                           generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    before = ops.launch_counts()
    with torch.inference_mode():
        want, _ = transformer.forward(model, tokens, f32.cfg)
        got, _ = transformer.forward(model16, tokens, cfg16)
    assert ops.launch_counts() == before
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    _close(got.float(), want, BF16_TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_prefill_on_the_card_matches_the_cpu(dev, cf):
    """granite-moe-3b-a800m at full width, one layer, float32: the prefill
    of 2 x 256 tokens on the card against the same weights on the CPU
    (1e-5), and the layer's chosen experts and kept mask equal."""
    from repro_torch.models import moe

    cfg = _family_full_width("granite-moe-3b-a800m", 1)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    card, cpu = build_model(cfg, device=dev), build_model(cfg, device="cpu")
    model = card.init(0)
    model_cpu = type(model)(cfg, device="cpu")
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    got, _ = card.prefill(model, {"tokens": tokens})
    want, _ = cpu.prefill(model_cpu, {"tokens": tokens.cpu()})
    _close(got.cpu(), want)
    x = torch.randn((2, 256, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    with torch.inference_mode():
        r = moe.route(model.layers[0].ffn, moe._groups(x, cfg.moe.group_size)[0], cfg)
        r_cpu = moe.route(model_cpu.layers[0].ffn, moe._groups(x.cpu(), cfg.moe.group_size)[0],
                          cfg)
    assert torch.equal(r.top_idx.cpu(), r_cpu.top_idx) and torch.equal(r.keep.cpu(), r_cpu.keep)
    if cf == 0.5:  # C = 26 slots an expert for 2,048 choices over 40 experts
        assert not bool(r.keep.all())


def test_encdec_prefill_matches_its_decode_loop_on_the_card(dev):
    """seamless-m4t-medium at full width cut to 2 + 2 layers, float32: the
    prefill's last logits against the decode loop over the same 64 tokens
    (the memory's cross K/V from a prefill of the first token)."""
    cfg = _family_full_width("seamless-m4t-medium", 2, encoder_layers=2)
    bundle = build_model(cfg, device=dev)
    model = bundle.init(0)
    gen = torch.Generator(device=dev).manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=dev)
    embeds = torch.randn((2, 16, cfg.d_model), generator=gen, device=dev)
    logits, _ = bundle.prefill(model, {"tokens": tokens, "embeds": embeds})
    _, caches = bundle.prefill(model, {"tokens": tokens[:, :1], "embeds": embeds}, max_len=64)
    for pos in range(1, 64):
        step, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
    assert bool(torch.isfinite(logits).all())
    _close(step, logits, MODEL_TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m", "seamless-m4t-medium",
                                  "xlstm-1.3b"])
def test_family_training_round_on_the_card_matches_the_cpu(dev, arch):
    """One reduced float32 DP-off round of each family on the card against
    the CPU: every agent's parameters and both metrics within 1e-5."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import P2PConfig
    from repro_torch.core import spmd
    from repro_torch.utils.tree import tree_flatten_with_path, tree_map

    cfg = get_reduced(arch, dtype="float32")
    p2p = P2PConfig(dp_enabled=False, mu=0.2, neighbor_offsets=(1,), gossip_dtype=None)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (4, 2, 17)).astype(np.int32)}
    if cfg.is_encdec:
        batch["embeds"] = rng.normal(size=(4, 2, 4, cfg.d_model)).astype(np.float32)
    on_cpu = build_model(cfg, device="cpu")
    start = on_cpu.init_agents(4, 0)
    outs = []
    for device, params in ((dev, tree_map(lambda x: x.to(dev, copy=True), start)),
                           ("cpu", start)):
        bundle = build_model(cfg, device=device)
        step, _, _ = spmd.make_train_step(bundle, p2p, 4, 2, alpha=0.5)
        outs.append(step(params, {k: torch.as_tensor(v, device=device) for k, v in batch.items()}))
    (got, got_m), (want, want_m) = outs
    for (name, a), (_, b) in zip(tree_flatten_with_path(got), tree_flatten_with_path(want)):
        _close(a.cpu(), b)
    for k in ("loss", "grad_norm"):
        _close(got_m[k].cpu(), want_m[k])


# The recurrent xLSTM family: plain PyTorch on the card, no kernel of ours,
# as in the JAX package.


def test_xlstm_prefill_matches_its_decode_loop_on_the_card(dev):
    """xlstm-1.3b at full width (d_model 2048, 4 heads, mLSTM heads of 1024)
    cut to 2 blocks with ``slstm_every=2`` (one mLSTM, one sLSTM), float32,
    TF32 off: the prefill of 2 x 256 tokens (two chunks of 128: the
    chunkwise form with its inter-chunk scan) against the same tokens fed
    one at a time through decode (the recurrent form); no launch of ours."""
    cfg = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                              xlstm=dataclasses.replace(cfg.xlstm, slstm_every=2))
    bundle = build_model(cfg, device=dev)
    model = bundle.init(0)
    assert (len(model.mlstm), len(model.slstm)) == (1, 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator(device=dev).manual_seed(8), device=dev)
    before = ops.launch_counts()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        logits, _ = bundle.prefill(model, {"tokens": tokens})
        caches = bundle.init_cache(model, 2, 256)
        for pos in range(256):
            step, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert ops.launch_counts() == before
    assert bool(torch.isfinite(logits).all())
    _close(step, logits, MODEL_TOL)


def test_xlstm_reduced_forward_and_gradients_on_the_card_match_the_cpu(dev):
    """The reduced float32 xLSTM (2 blocks, chunk 16), one agent, 2 x 33
    tokens (two chunks): the loss and every leaf's gradient through
    ``spmd.agent_losses_and_grads`` on the card against the CPU (1e-5 and
    1e-4, as the CPU tests hold them to the reference), and the prefill's
    logits (1e-5); no launch of ours."""
    from repro_torch.configs import get_reduced
    from repro_torch.core import spmd
    from repro_torch.utils.tree import tree_flatten_with_path, tree_map

    cfg = get_reduced("xlstm-1.3b", dtype="float32")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (1, 2, 33)).astype(np.int32)
    on_cpu = build_model(cfg, device="cpu")
    start = on_cpu.init_agents(1, 0)
    before = ops.launch_counts()
    outs = []
    for device, params in ((dev, tree_map(lambda x: x.to(dev, copy=True), start)),
                           ("cpu", start)):
        bundle = build_model(cfg, device=device)
        losses, grads = spmd.agent_losses_and_grads(
            bundle, params, {"tokens": torch.as_tensor(tokens, device=device)})
        logits, _ = bundle.prefill(bundle.bind(tree_map(lambda x: x[0], params)),
                                   {"tokens": tokens[0, :, :-1]})
        outs.append((losses, grads, logits))
    assert ops.launch_counts() == before
    (l_card, g_card, p_card), (l_cpu, g_cpu, p_cpu) = outs
    _close(l_card.cpu(), l_cpu)
    _close(p_card.cpu(), p_cpu)
    for (name, a), (_, b) in zip(tree_flatten_with_path(g_card), tree_flatten_with_path(g_cpu)):
        _close(a.cpu(), b, MODEL_TOL)


@pytest.mark.parametrize("T", [64, 150, 7])
def test_slstm_captured_scan_equals_eager_bit_for_bit(dev, T):
    """The sLSTM time scan (``xlstm.SLSTMScan``) at xlstm-1.3b's head shape
    (4 heads of 512, batch 3): its captured graphs (chunks of
    ``SCAN_CHUNK`` steps and a tail) against its eager loops inside
    ``eager_scan()``, forward and backward, every output and gradient
    equal bit for bit; the graphs replay, none is captured in the
    backward."""
    from repro_torch.models import xlstm

    g = np.random.default_rng(T)
    H, B, hd = 4, 3, 512

    def t(*shape, scale=1.0):
        return torch.tensor(g.normal(size=shape) * scale, dtype=torch.float32, device=dev)

    r32, bias, x = t(H, hd, 4 * hd, scale=hd ** -0.5), t(H, 1, 4 * hd), t(H, B, T, 4 * hd)
    state = {k: t(H, B, hd) for k in "cnh"}
    state["m"] = t(H, B, 1)
    w = t(H, B, T, hd)
    one = torch.ones((), device=dev)
    leaves = [r32, bias, x] + [state[k] for k in "cnhm"]
    outs = []
    for eager in (False, True):
        inputs = [v.clone().requires_grad_() for v in leaves]
        st = dict(zip("cnhm", inputs[3:]))
        with xlstm.eager_scan() if eager else contextlib.nullcontext():
            hs = xlstm.slstm_scan(*inputs[:3], st, one)
        grads = torch.autograd.grad((hs * w).sum(), inputs)
        outs.append((hs, grads))
    graphs = xlstm.scan_graphs()[(H, B, hd, dev)]
    assert set(graphs.forward_graphs) == set(graphs.backward_graphs) >= {min(T, 64)}
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    assert graphs.replays >= 2 * -(-T // xlstm.SCAN_CHUNK)


def test_xlstm_captured_training_equals_eager_bit_for_bit(dev):
    """xlstm-1.3b at full width cut to 2 blocks (``slstm_every=2``),
    float32: the loss and every gradient of one agent's 2 x 129 tokens
    (remat on, so the sLSTM block's forward runs again in the backward)
    through the captured scan equal those through the eager loops."""
    from repro_torch.core import spmd
    from repro_torch.models import xlstm

    cfg = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(cfg, num_layers=2, dtype="float32",
                              xlstm=dataclasses.replace(cfg.xlstm, slstm_every=2))
    bundle = build_model(cfg, device=dev)
    params = bundle.init_agents(1, 0)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2, 129),
                           generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    outs = []
    for eager in (False, True):
        with xlstm.eager_scan() if eager else contextlib.nullcontext():
            outs.append(spmd.agent_losses_and_grads(bundle, params, {"tokens": tokens}))
    (l_cap, g_cap), (l_eager, g_eager) = outs
    assert torch.equal(l_cap, l_eager)
    from repro_torch.utils.tree import tree_leaves

    for a, b in zip(tree_leaves(g_cap), tree_leaves(g_eager)):
        assert torch.equal(a, b)

"""The CUDA kernels on the card: each against its plain version over a
shape grid, launch counting, refusal of what a kernel does not take, and
the engine's fused and unfused routes (non-private and private) against
the CPU route.

Marked ``cuda``: every test skips where there is no CUDA device. Run on a
GPU machine with ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``
(add ``--noconftest`` where JAX is not installed: the suite's conftest
imports it, this file does not).
Tolerance 1e-5 relative to the largest output: float32 sums taken in
another order than the plain version's.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import AgentData, DPConfig, knn_graph, make_objective
from repro_torch.kernels import ops, ref
from repro_torch.sim import AsyncEngine, CDUpdate, DPCDUpdate

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _close(got, want):
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= TOL * scale


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


@pytest.mark.parametrize("N,D", [(8, 128), (33, 200), (128, 512), (200, 1000), (1, 128),
                                 (256, 4096), (77, 301), (1, 3), (1500, 5)])
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

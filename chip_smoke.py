#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); it exits non-zero, and
prints no result, without them or without the repository's ``src/``.
Phases, one line each (any failure ends the run with a non-zero code):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
   all started together) and report the seconds;
3. kernel checks at the main path's shapes: each kernel against its
   plain PyTorch version on the same inputs (stated tolerance), with
   CUDA-event medians of the kernel, the plain version and, where one
   PyTorch call computes the same function, that call, beside the bound
   (the larger of bytes over 3.35 TB/s and flops over 67 TFLOP/s);
   ``sparse_mix`` at R = B and R = n with ``gather_ms`` beside the bound
   (every real entry's Theta row over HBM bandwidth: what the access
   pattern allows); ``graph_mix`` with its split-K plan, its library
   call with TF32 off (printed);
   ``dp_clip_noise`` at the (256, 4096) float32 shape of
   ``benchmarks/bench_kernels.py`` and at (200, 1000) in bfloat16, the
   same bits on a second launch; at the float32 shape, as context, the
   other tile layouts of its plan (``plan_ms``), the two-call composite
   ``vector_norm`` + ``addmv`` (``composite_ms``) and one near-empty
   launch (``launch_floor_ms``);
   ``ssm_chunk`` at the zamba2-1.2b prefill's shape (G = 4 x 16 chunks x
   64 heads, Q = 128, N = P = 64, float32, C and B shared by the heads)
   and at a small ragged shape in bfloat16;
4. the main path at a deployment size, config ``rgg500k_p100``: the
   batched engine on 500k agents (random geometric graph, average degree
   16, p = 100, m = 8, quadratic loss, mu = 0.5, 4096 expected wakes per
   slot, churn on), fused (``fused="auto"``, the fused kernel) and
   unfused (neighbour sums through ``sparse_mix``); the private Eq. 6
   engine on the same problem with the per-point clip 1.0 (``DPCDUpdate``,
   eps_bar = 0.5, delta_bar = exp(-5), Laplace, each agent planning for
   the expected wakes of the whole leg, so agents that wake more often stop
   at their budget), fused and unfused; the dense path (synchronous
   rounds at n = 2047 through ``graph_mix``); and the paper's synchronous
   baseline on the 500k problem (``synchronous_round``: ``MixOp.all``
   through ``sparse_mix`` at R = n). After a warm-up the six legs
   take turns over 7 timed windows of 200 slots (rounds) each; each rate is
   the median window's, printed with the slowest and fastest, and the
   fused/unfused ratio is taken window by window. Launch counts are reset
   before and read after every window, and each leg must launch its own
   kernel in every window. Then 16 slots of each engine leg, and 16
   rounds of each synchronous leg, run under torch.profiler (traces in
   ``build/repro_torch/``): device time per slot (round) by kernel, and the
   device idle share. Last, the ``dp_clip_noise`` leg:
   200 DP aggregation rounds of (256, 4096) per-example gradients through
   ``ops.dp_clip_noise``, the path by which the kernel is reached (no engine
   path calls it, as in the JAX package);
5. parity: at n = 512, forced-wake runs fused vs unfused on the card vs
   the same run on the CPU, and the engine's fixed point vs the exact
   solution; a private forced-wake run fused vs unfused on the card;
   ``DPCDUpdate.apply_rows`` on the card vs the CPU with injected draws;
   ``run_private`` and ``private_warm_start`` at the Fig. 2 size (n = 100,
   p = 100, logistic, clip 1.0, eps 0.55, T = 1000) on the card vs the CPU,
   with injected draws;
6. zamba2-1.2b serving at its full width and depth (38 layers, d_model
   2048, bfloat16, random weights from a seeded generator on the card):
   4 prompts of 2048 tokens through ``bundle.prefill`` (a warm-up, then 5
   timed prefills, each of which must launch ``ssm_chunk`` once per layer,
   38 times; one more traced with torch.profiler: device time by block
   and kernel kind, device idle share), then 64 greedy ``bundle.decode``
   steps (2 more traced: device time and idle share per step); and two
   correctness gates on a float32 instance of the same
   config: the prefill of 2 x 256 tokens against the same tokens fed one
   at a time through decode, and the prefill through the kernel against
   the einsum route;
7. the paper's benches on the card (``repro_torch.bench``): Fig. 1, CD
   against gossip ADMM at the reference bench's size (n = p = 100,
   logistic, mu = 0.3, T_cd = 3000, T_admm = 300, seed 0), and Table 1 on
   the MovieLens twin at the size of ``BENCH_summary.json``'s row (150
   users, 400 items, p = 20, 40 ticks a user, eps 1, 0.5, 0.1). Each
   derived quantity is printed beside the reference's CPU row, with the
   seconds each bench took; the run fails unless CD beats ADMM per
   message, CD beats the local models on accuracy and on RMSE, and every
   private RMSE is finite. These benches launch none of the kernels;
8. a JSON line of every ported kernel (launches, error, times, bound),
   then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores

# rgg500k_p100: the main-path deployment (see PERF.md, "Cells").
MAIN = dict(n=500_000, p=100, m=8, avg_degree=16.0, mu=0.5, slot_wakes=4096.0, seed=0)
DENSE_N = 2047  # just under the dense/sparse crossover of 2048 agents

# max |kernel - plain| allowed, relative to max(1, max |plain|): float32
# sums taken in another order (<= 38 neighbour terms, <= 2047 terms for
# graph_mix, m = 8 data points in the fused step, N = 256 rows for
# dp_clip_noise).
TOL = {"sparse_mix": 1e-5, "fused_row_update": 2e-5, "graph_mix": 1e-5, "dp_clip_noise": 1e-5,
       "ssm_chunk": 2e-5}  # ssm_chunk: up to 128 + 64 terms per output
PARITY_TOL = 1e-5
# The private legs (see PERF.md, "Cells"): the budget of bench_privacy_utility.py's
# Fig. 2/3 sweeps and the paper's delta; the per-point clip makes L0 finite.
DP = dict(eps_bar=0.5, delta_bar=math.exp(-5.0), clip=1.0)
DP_CLIP_SHAPE = (256, 4096)  # benchmarks/bench_kernels.py
DP_CLIP_ROUNDS = 200
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's ~2 GHz: the head start of time_ms
PROFILE_SLOTS = 16
# Phase 4 timing: each leg warms up, then runs WINDOWS timed windows of
# WINDOW_STEPS slots (dense: rounds), the legs taking turns; rates are the
# median window's, with the slowest and fastest beside it.
WARM_STEPS = 8
WINDOWS = 7
WINDOW_STEPS = 200
# Phase 6: zamba2-1.2b serving (see PERF.md, "Cells").
ZAMBA = dict(arch="zamba2-1.2b", seed=0, batch=4, prompt=2048, prefills=5, decode_steps=64)
ZAMBA_GATE = dict(batch=2, tokens=256)  # two chunks of 128: the inter-chunk recurrence runs
DECODE_TRACED = 2  # decode steps traced with torch.profiler
# max |a - b| of the float32 gates, relative to max(1, max |logit|): 38
# layers whose two routes take their float32 sums in different orders.
MODEL_TOL = 1e-4
# Phase 7: the paper benches, at the reference's sizes, and the reference's
# CPU rows (BENCH_summary.json) printed beside the card's.
FIG1 = dict(n=100, p=100, mu=0.3, T_cd=3000, T_admm=300, seed=0)
TABLE1 = dict(fast=True, seed=0)  # 150 users, 400 items, p = 20, 40 ticks a user
REFERENCE_ROWS = {"fig1_cd_vs_admm": "cd_beats_admm_per_message=True",
                  "table1_movielens": "rmse_local=1.490,rmse_cd=1.345"}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, calls: int = 20, runs: int = 7) -> float:
    """Device time of one call of ``fn``: CUDA events around ``calls``
    back-to-back calls, over the count; the median of ``runs`` such runs.

    A spin kernel queued first keeps the card busy while the host enqueues
    the calls, so the events time the device's work, not the host's
    Python between launches.
    """
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the float32 operations over the peak rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOP_PER_S * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return dict(bound_ms=max(bytes_ms, ops_ms), bound_by=by, bytes_ms=bytes_ms, ops_ms=ops_ms)


def quadratic_rgg_problem(n, p, m, avg_degree, mu, seed, mix_mode="auto"):
    """Quadratic objective over a random geometric graph, data from ``seed``."""
    import numpy as np

    from repro_torch.core import AgentData, make_objective, random_geometric_graph

    rng = np.random.default_rng(seed)
    graph = random_geometric_graph(n, rng, avg_degree=avg_degree)
    targets = (rng.standard_normal((n, p), dtype=np.float32) / np.sqrt(p)).astype(np.float32)
    X = rng.standard_normal((n, m, p), dtype=np.float32)
    X *= np.float32(1.0 / np.sqrt(p))
    y = np.einsum("nmp,np->nm", X, targets)
    data = AgentData(X=X, y=y, mask=np.ones((n, m), dtype=np.float32))
    return make_objective(graph, data, "quadratic", mu=mu, mix_mode=mix_mode)


def ptxas_summary(logs: dict) -> list:
    """``kernel<template arguments>: registers, spill bytes`` for every
    entry function in nvcc's ``-Xptxas -v`` output."""
    import re

    out, name, stores = [], "?", 0
    for text in logs.values():
        for line in text.splitlines():
            hit = re.search(r"Compiling entry function '(.*)'", line)
            if hit:
                m = re.search(r"\d+([a-z_]+_kernel)(I.*?EE)?", hit.group(1))
                args = ",".join(re.findall(r"L[a-z](\d+)E", m.group(2) or "")) if m else ""
                name = (m.group(1) if m else hit.group(1)) + (f"<{args}>" if args else "")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if spill:
                stores = int(spill.group(1)) + int(spill.group(2))
            regs = re.search(r"Used (\d+) registers", line)
            if regs:
                out.append(f"{name}: {regs.group(1)} regs, {stores} B spill")
    return out


def fmt(values: dict) -> str:
    return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in values.items())


def check_kernel(name, got, want, results, **timing):
    import torch

    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all())
    ok = finite and err <= TOL[name] * scale
    results[name] = dict(max_abs_err=err, **timing)
    log(f"[3] {name}: max_abs_err={err:.3e} (tol {TOL[name]:.0e} x {scale:.3g}) {fmt(timing)}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version "
                         f"(err {err}, finite {finite})")


def kernel_checks(obj, engine, dense_obj, results) -> None:
    """Phase 3: each kernel at the main path's shapes, against its plain version."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels._build import vector_loads
    from repro_torch.kernels.fused_row_update import row_plan
    from repro_torch.kernels.graph_mix import split_plan
    from repro_torch.sim.updates import _eq4_fused_args, fused_rows

    dev = engine.device
    f32 = torch.float32
    n, p = obj.n, obj.p
    mix = obj.mix
    gen = torch.Generator(device=dev).manual_seed(1)
    theta = torch.randn((n, p), generator=gen, device=dev, dtype=f32)
    # One slot's woken batch, as the engine compacts it.
    wake = torch.rand(n, generator=gen, device=dev) < engine._wake_p
    woken, slot_rows, valid, _ = engine._compact(wake)
    safe = torch.clamp(woken, max=n - 1)
    nvalid = int(valid.sum())

    # sparse_mix at R = B (the unfused slot) and R = n (MixOp.all).
    idx_n, w_n = mix.table("idx", dev, torch.int32), mix.table("w", dev, f32)
    for label, idx, w in (("B", idx_n[safe], w_n[safe]), ("n", idx_n, w_n)):
        R, K = idx.shape
        got = ops.sparse_mix(idx, w, theta)
        want = ref.sparse_mix_ref(idx, w, theta)
        real = w != 0
        rows_read = int(torch.unique(idx[real]).numel())
        nbytes = idx.numel() * 4 + w.numel() * 4 + rows_read * p * 4 + R * p * 4
        # The same function as one PyTorch call: a CSR sparse product.
        counts = real.sum(dim=1)
        crow = torch.zeros(R + 1, dtype=torch.long, device=dev)
        crow[1:] = torch.cumsum(counts, 0)
        csr = torch.sparse_csr_tensor(crow, idx[real].long(), w[real], size=(R, n),
                                      check_invariants=True)
        lib_err = float((torch.sparse.mm(csr, theta) - want).abs().max())
        edges = int(real.sum())
        timing = dict(
            R=R, K=K, edges=edges, float4=vector_loads(theta),
            ms=time_ms(lambda: ops.sparse_mix(idx, w, theta)),
            plain_ms=time_ms(lambda: ref.sparse_mix_ref(idx, w, theta)),
            library_ms=time_ms(lambda: torch.sparse.mm(csr, theta)),
            library_err=lib_err,
            # What the access pattern allows: every real entry's row from HBM.
            gather_ms=edges * p * 4 / HBM_BYTES_PER_S * 1e3,
            **bound(nbytes, 2.0 * edges * p),
        )
        check_kernel("sparse_mix", got, want, results, **timing)
        results[f"sparse_mix_R{label}"] = results["sparse_mix"]
    results["sparse_mix"] = results["sparse_mix_RB"]  # the main path's shape

    # fused_row_update on the full slab, its inputs packed by the engine's own
    # code (the calls CDUpdate.apply_fused makes).
    krows, consts = fused_rows(obj, woken, valid, dev)
    cols = engine._fidx[slot_rows]
    ww = engine._fw[slot_rows]
    args = _eq4_fused_args(obj, krows, cols, ww, consts, None)
    got = ops.fused_row_update(*args, theta.clone(), n)
    want = ref.fused_row_update_ref(*args, theta.clone(), n)
    B, K = cols.shape
    m = args[4].shape[1]
    vmask = valid[:, None]
    real = (ww != 0) & vmask
    rows_read = int(torch.unique(torch.cat([cols[real].long(), woken[valid]])).numel())
    nbytes = (nvalid * (4 + 2 * K * 4 + 4 * 4 + m * p * 4 + 2 * m * 4)
              + rows_read * p * 4 + nvalid * p * 4)
    flops = 2.0 * int(real.sum()) * p + nvalid * (4.0 * m * p + 8.0 * p)
    slab_k, slab_p = theta.clone(), theta.clone()
    plan = row_plan(B, p, (theta, args[4], args[7]))
    timing = dict(
        B=B, K=K, valid=nvalid, passes=plan.passes, float4=plan.vec,
        ms=time_ms(lambda: ops.fused_row_update(*args, slab_k, n)),
        plain_ms=time_ms(lambda: ref.fused_row_update_ref(*args, slab_p, n)),
        library_ms=None, **bound(nbytes, flops),
    )
    check_kernel("fused_row_update", got, want, results, **timing)

    # graph_mix: dense A @ Theta at n = 2047, p = 100 (MixOp.all, dense); the
    # library call in full float32.
    A = dense_obj.mix.table("W", dev, f32)
    th = torch.randn((dense_obj.n, p), generator=gen, device=dev, dtype=f32)
    got = ops.graph_mix(A, th)
    want = ref.graph_mix_ref(A, th)
    dn = dense_obj.n
    plan = split_plan(dn, p, torch.cuda.get_device_properties(dev).multi_processor_count)
    torch.backends.cuda.matmul.allow_tf32 = False
    timing = dict(
        n=dn, p=p, splits=plan.splits, chunk=plan.chunk, theta_float4=vector_loads(th),
        ms=time_ms(lambda: ops.graph_mix(A, th)),
        plain_ms=time_ms(lambda: ref.graph_mix_ref(A, th)),
        library_ms=time_ms(lambda: torch.matmul(A, th)),
        library_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        **bound((dn * dn + 2 * dn * p) * 4, 2.0 * dn * dn * p),
    )
    check_kernel("graph_mix", got, want, results, **timing)

    # dp_clip_noise: the (256, 4096) float32 shape of bench_kernels.py, then
    # one bfloat16 shape of tests/test_kernels.py. No single PyTorch call
    # computes the clip-mean-noise function, so there is no library time;
    # the two-call composite (vector_norm, then addmv) is timed as context.
    from repro_torch.kernels.dp_clip_noise import ClipPlan, clip_plan, dp_clip_noise_cuda

    for label, (N, D), dt in (("f32", DP_CLIP_SHAPE, f32), ("bf16", (200, 1000), torch.bfloat16)):
        grads = (3.0 * torch.randn((N, D), generator=gen, device=dev)).to(dt)
        noise = torch.randn(D, generator=gen, device=dev)
        got = ops.dp_clip_noise(grads, noise, 1.5, 0.37)
        want = ref.dp_clip_noise_ref(grads, noise, 1.5, 0.37)
        if not torch.equal(ops.dp_clip_noise(grads, noise, 1.5, 0.37), got):
            raise SystemExit(f"dp_clip_noise {label}: a second launch gave other bits")
        plan = clip_plan(N, D, grads.element_size(), vector_loads(grads))
        timing = dict(
            N=N, D=D, dtype=str(dt).replace("torch.", ""), cluster=plan.cluster, rows=plan.rows,
            row_blocks=plan.row_blocks, blocks=plan.blocks, passes=plan.passes, vec=plan.vec,
            combine_blocks=plan.combine_blocks,
            ms=time_ms(lambda: ops.dp_clip_noise(grads, noise, 1.5, 0.37)),
            plain_ms=time_ms(lambda: ref.dp_clip_noise_ref(grads, noise, 1.5, 0.37)),
            library_ms=None,
            **bound(grads.numel() * grads.element_size() + 2 * D * 4, 4.0 * N * D),
        )
        if dt == f32:
            # The other layouts of the tile at this shape: a cluster across D
            # lets a block take more rows and leaves fewer partial rows.
            alt = {f"c{c}_p{q}_r{r}": ClipPlan(N=N, D=D, vec=plan.vec, per=plan.per, passes=q,
                                                cluster=c, rows=r)
                   for c, q, r in ((1, 4, 2), (1, 4, 1), (2, 2, 4), (4, 1, 8), (4, 1, 4))}
            plan_ms = {}
            for key, p_alt in alt.items():
                out_alt = dp_clip_noise_cuda(grads, noise, 1.5, 0.37, plan=p_alt)
                if float((out_alt - want).abs().max()) > TOL["dp_clip_noise"] * max(
                        1.0, float(want.abs().max())):
                    raise SystemExit(f"dp_clip_noise plan {key} disagrees with the plain version")
                plan_ms[key] = time_ms(lambda: dp_clip_noise_cuda(grads, noise, 1.5, 0.37,
                                                                  plan=p_alt))
            log(f"[3] dp_clip_noise plans (cluster, passes, rows) at {N} x {D}: {fmt(plan_ms)}")
            timing["plan_ms"] = plan_ms

            def composite():
                scale = (1.5 / torch.linalg.vector_norm(grads, dim=1).clamp(min=1e-12)).clamp(max=1.0)
                return torch.addmv(noise, grads.t(), scale, beta=0.37, alpha=1.0 / N)
            tiny = torch.zeros(16, device=dev)
            timing.update(composite_ms=time_ms(composite),
                          composite_err=float((composite() - want).abs().max()),
                          launch_floor_ms=time_ms(lambda: tiny.zero_()))  # one empty-ish launch
        check_kernel("dp_clip_noise", got, want, results, **timing)
        results[f"dp_clip_noise_{label}"] = results["dp_clip_noise"]
    results["dp_clip_noise"] = results["dp_clip_noise_f32"]  # the bench shape


def ssm_chunk_checks(dev, results) -> None:
    """Phase 3, ``ssm_chunk``: at the zamba2-1.2b prefill's shape (batch 4 x
    16 chunks x 64 heads, Q = 128, N = P = 64, float32, C and B given once
    per (batch, chunk) and shared by its 64 heads, as the Mamba2 block
    passes them), then at a small ragged bfloat16 shape. The bound counts
    the causal float32 work the function needs, C.B^T once per C/B block:
    2 [(G / heads) Q(Q+1)/2 N + G Q(Q+1)/2 P + G Q P N] flops, and each
    distinct input read once; ``gflop_cb_per_group`` is the earlier count,
    which took C.B^T once per group, printed so older rows compare. At the
    prefill shape every divisor of the 64 heads is timed as the heads per
    block (``hg_ms``) beside the plan's choice. No single PyTorch call
    computes the function, so there is no library time."""
    import torch

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.ssm_chunk import blocks_per_sm, head_plan, smem_bytes, ssm_chunk_cuda

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem = _build.load("ssm_chunk").ssm_chunk_smem_bytes
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, (G, Q, N, P, heads), dt in (("prefill", (4 * 16 * 64, 128, 64, 64, 64), torch.float32),
                                           ("bf16", (6, 77, 40, 96, 3), torch.bfloat16)):
        C = torch.randn((G // heads, Q, N), generator=gen, device=dev).to(dt)
        B = torch.randn((G // heads, Q, N), generator=gen, device=dev).to(dt)
        cum = torch.cumsum(-0.1 * torch.rand((G, Q), generator=gen, device=dev), dim=1)
        dtv = 0.5 * torch.rand((G, Q), generator=gen, device=dev)
        x = torch.randn((G, Q, P), generator=gen, device=dev).to(dt)
        args = (C, B, cum, dtv, x, heads)
        got = torch.cat([t.flatten() for t in ops.ssm_chunk(*args)])
        want = torch.cat([t.flatten() for t in ref.ssm_chunk_ref(*args)])
        tri = Q * (Q + 1) / 2
        flops = 2.0 * (G // heads * tri * N + G * tri * P + G * Q * P * N)
        nbytes = ((2 * C.numel() + x.numel()) * C.element_size() + 2 * G * Q * 4
                  + (G * Q * P + G * P * N) * 4)
        hg = head_plan(G, heads, sms, Q, N, P)
        if smem(Q, N, P) != smem_bytes(Q, N, P):
            raise SystemExit(f"ssm_chunk: the plan's shared memory {smem_bytes(Q, N, P)} is not "
                             f"the kernel's {smem(Q, N, P)}")
        if label == "prefill":
            hg_ms = {d: time_ms(lambda: ssm_chunk_cuda(*args[:5], heads=heads, head_group=d))
                     for d in range(1, heads + 1) if heads % d == 0}
            log(f"[3] ssm_chunk heads per block at the prefill: {fmt(hg_ms)} (plan: {hg})")
        timing = dict(
            G=G, Q=Q, N=N, P=P, heads=heads, dtype=str(dt).replace("torch.", ""),
            head_group=hg, blocks=G // hg, smem_bytes=smem(Q, N, P),
            blocks_per_sm=blocks_per_sm(Q, N, P),
            gflop=flops / 1e9, gflop_cb_per_group=2.0 * G * (tri * (N + P) + Q * P * N) / 1e9,
            ms=time_ms(lambda: ops.ssm_chunk(*args)),
            plain_ms=time_ms(lambda: ref.ssm_chunk_ref(*args)),
            library_ms=None, **bound(nbytes, flops),
        )
        check_kernel("ssm_chunk", got, want, results, **timing)
        results[f"ssm_chunk_{label}"] = results["ssm_chunk"]
    results["ssm_chunk"] = results["ssm_chunk_prefill"]  # the main path's shape


def _device_events(events) -> list:
    """The device's events of a Chrome trace: kernels, copies and fills."""
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


# The __global__ functions of src/repro_torch/csrc, as the trace names them.
OUR_KERNELS = ("sparse_mix_kernel", "fused_rows_kernel", "scatter_rows_kernel",
               "graph_mix_kernel", "split_sum_kernel", "clip_partial_kernel",
               "combine_kernel", "ssm_chunk_kernel")


def report_trace(label, events, wall_ms, steps, unit, ms_per_step):
    """Print and return the device time per step by kernel name, from a
    Chrome trace's kernel, memcpy and memset events, and the device idle
    share: of the traced window, and of the untraced step time
    ``ms_per_step`` measured before (the tracer itself slows the host);
    ``our_kernels_us`` sums the kernels of ``src/repro_torch/csrc``."""
    by_name: dict = {}
    for e in _device_events(events):
        us, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + float(e["dur"]), count + 1)
    busy_us = sum(us for us, _ in by_name.values())
    if busy_us <= 0:
        raise SystemExit(f"{label}: the profiler saw no device time")
    busy_ms = busy_us / steps / 1e3
    ours = sum(us for name, (us, _) in by_name.items() if any(k in name for k in OUR_KERNELS))
    out = {f"traced_ms_per_{unit}": wall_ms / steps, f"device_busy_ms_per_{unit}": busy_ms,
           f"our_kernels_us_per_{unit}": ours / steps,
           f"device_ops_per_{unit}": sum(c for _, c in by_name.values()) / steps,
           "idle_share_traced": 1.0 - busy_us / 1e3 / wall_ms,
           "idle_share_untraced": 1.0 - busy_ms / ms_per_step}
    log(f"[4p] {label}: {steps} traced {unit}s: {fmt(out)}")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[4p]   {us / steps:9.2f} us/{unit}  x{count / steps:5.2f}/{unit}  {name[:110]}")
    return out


def profile_slots(label, engine, state, slots: int, out_dir: Path, ms_per_slot: float):
    """Trace ``slots`` sampled super-ticks with torch.profiler (Chrome trace
    in ``out_dir``) and report them (:func:`report_trace`)."""
    box = [state]

    def run():
        box[0] = engine.advance(box[0], slots)

    events, wall_ms = traced(run, out_dir / f"trace_{label.replace(' ', '_')}.json")
    report_trace(label, events, wall_ms, slots, "slot", ms_per_slot)
    return box[0]


def profile_rounds(label, obj, rounds: int, out_dir: Path, ms_per_round: float, dev) -> dict:
    """Trace ``rounds`` synchronous rounds from zeros on ``obj`` (after one
    untraced warm-up round) and report them (:func:`report_trace`)."""
    import torch

    from repro_torch.core.coordinate_descent import synchronous_round

    box = [synchronous_round(obj, torch.zeros((obj.n, obj.p), device=dev, dtype=torch.float32))]

    def run():
        for _ in range(rounds):
            box[0] = synchronous_round(obj, box[0])

    events, wall_ms = traced(run, out_dir / f"trace_{label.replace(' ', '_')}.json")
    return report_trace(label, events, wall_ms, rounds, "round", ms_per_round)


def timed_windows(legs: dict, launches: dict) -> dict:
    """Time each leg over ``WINDOWS`` windows of ``WINDOW_STEPS`` steps.

    ``legs`` maps a label to ``(step, applied)``: ``step(k)`` runs k steps
    of the leg, ``applied()`` reads its applied-wake counter (or None). The
    legs take turns window by window, so a slow spell of the shared host
    falls on every leg alike. Launch counts are reset just before each
    window and read just after it, into the leg's per-window list, its
    total and ``launches``. Returns per leg the steps/s and wakes/s of
    every window and its counts.
    """
    import torch

    from repro_torch.kernels import ops

    out = {label: dict(rates=[], wakes=[], counts={}, windows=[]) for label in legs}
    for _ in range(WINDOWS):
        for label, (step, applied) in legs.items():
            torch.cuda.synchronize()
            a0 = applied() if applied else 0
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            step(WINDOW_STEPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = ops.launch_counts()
            r = out[label]
            r["windows"].append(counts)
            for k, v in counts.items():
                r["counts"][k] = r["counts"].get(k, 0) + v
                launches[k] = launches.get(k, 0) + v
            r["rates"].append(WINDOW_STEPS / secs)
            r["wakes"].append(((applied() if applied else 0) - a0) / secs)
    return out


def spread(values) -> dict:
    """The median of ``values`` with its smallest and largest."""
    return dict(median=statistics.median(values), min=min(values), max=max(values))


# The kernel each path of phase 4 must launch in every window (dp_clip_noise
# in its own leg: no engine path calls it).
PATH_KERNEL = {"fused": "fused_row_update", "unfused": "sparse_mix",
               "dp_fused": "fused_row_update", "dp_unfused": "sparse_mix",
               "dense": "graph_mix", "sparse_sync": "sparse_mix",
               "dp_clip_noise": "dp_clip_noise", "zamba2_prefill": "ssm_chunk"}
ENGINE_LEGS = ("fused", "unfused", "dp_fused", "dp_unfused")
SYNC_LEGS = ("dense", "sparse_sync")  # synchronous_round: graph_mix, sparse_mix at R = n


def check_windows(label: str, timed_leg: dict) -> None:
    """Fail unless the leg launched its path's kernel in every window."""
    want = PATH_KERNEL[label]
    per = [w.get(want, 0) for w in timed_leg["windows"]]
    if not per or min(per) <= 0:
        raise SystemExit(f"{label} leg: {want} not launched in every window ({per})")


def drive_main_path(engines, dense_obj, sparse_obj, dev):
    """Phase 4: the engine legs of ``engines`` (``ENGINE_LEGS``: the fused
    and unfused slots, non-private and private), dense synchronous rounds
    (``graph_mix``) and synchronous rounds on the sparse main-path
    objective (the paper's synchronous baseline: ``MixOp.all`` through
    ``sparse_mix`` at R = n), warmed up, then timed in interleaved windows.
    Fails unless each leg launched its kernel in every window and kept
    Theta finite, and each non-private leg lowered its objective. Returns
    the legs' numbers, the engine states and the launch counts of the
    timed windows."""
    import numpy as np
    import torch

    from repro_torch.core.coordinate_descent import synchronous_round

    states = {}
    for key in ENGINE_LEGS:
        eng = engines[key]
        state = eng.init_state(np.zeros((eng.n, eng.p), dtype=np.float32))
        q0 = eng._objective_value(state)
        states[key] = dict(q0=q0, state=eng.advance(state, WARM_STEPS))
    sync = {}  # the synchronous legs: objective, iterate, starting value
    for key, o in (("dense", dense_obj), ("sparse_sync", sparse_obj)):
        Theta = torch.zeros((o.n, o.p), device=dev, dtype=torch.float32)
        sync[key] = dict(obj=o, Theta=Theta, q0=float(o.value(Theta)))

    def slots(key):
        def step(k):
            states[key]["state"] = engines[key].advance(states[key]["state"], k)
        return step, lambda: int(states[key]["state"].applied)

    def rounds(key):
        def step(k):
            leg = sync[key]
            for _ in range(k):
                leg["Theta"] = synchronous_round(leg["obj"], leg["Theta"])
        return step, None

    launches: dict = {}
    legs = {key: slots(key) for key in ENGINE_LEGS}
    for key in SYNC_LEGS:
        legs[key] = rounds(key)
        legs[key][0](WARM_STEPS)
    timed = timed_windows(legs, launches)

    main_path = {}
    for key in ENGINE_LEGS:
        eng, st, t = engines[key], states[key], timed[key]
        state = st["state"]
        rate = spread(t["rates"])
        out = dict(
            slots_per_s=rate["median"], slots_per_s_min=rate["min"], slots_per_s_max=rate["max"],
            wakes_per_s=statistics.median(t["wakes"]), ms_per_slot=1e3 / rate["median"],
            windows=WINDOWS, window_slots=WINDOW_STEPS, dropped=int(state.dropped),
            finite=bool(torch.isfinite(state.Theta).all()), Q0=st["q0"],
            Q=eng._objective_value(state),
        )
        main_path[key] = out
        log(f"[4] rgg500k_p100 {key}: fused={eng.fused} batch={eng.batch_size} {fmt(out)} "
            f"launches={t['counts']}")
        if not out["finite"]:
            raise SystemExit(f"{key} leg: Theta is not finite")
        check_windows(key, t)
        if not key.startswith("dp_") and not out["Q"] < out["Q0"]:
            raise SystemExit(f"{key} leg: the objective did not decrease")
    for a, b in (("fused", "unfused"), ("dp_fused", "dp_unfused")):
        ratios = [f / u for f, u in zip(timed[a]["rates"], timed[b]["rates"])]
        main_path[f"{a}_over_{b}"] = spread(ratios)
        log(f"[4] {a} / {b} slots/s, window by window: {fmt(spread(ratios))}")
    for key in SYNC_LEGS:
        leg = sync[key]
        rate = spread(timed[key]["rates"])
        q1 = float(leg["obj"].value(leg["Theta"]))
        finite = bool(torch.isfinite(leg["Theta"]).all())
        main_path[key] = dict(rounds_per_s=rate["median"], rounds_per_s_min=rate["min"],
                              rounds_per_s_max=rate["max"], ms_per_round=1e3 / rate["median"],
                              Q0=leg["q0"], Q=q1, finite=finite)
        log(f"[4] {key} n={leg['obj'].n} synchronous rounds ({leg['obj'].mix.kind} mix): "
            f"{fmt(main_path[key])} launches={timed[key]['counts']}")
        check_windows(key, timed[key])
        if not q1 < leg["q0"] or not finite:
            raise SystemExit(f"{key} leg: Q not decreasing, or Theta not finite")
    return main_path, {k: v["state"] for k, v in states.items()}, launches


def budget_check(engines, states, main_path) -> None:
    """The private legs at their end: the count of budget-stopped agents,
    which must lie strictly between 0 and n (the leg exercised the fused
    kernel's budget sentinels at scale without stopping everyone)."""
    for key in ("dp_fused", "dp_unfused"):
        upd, state = engines[key].update, states[key]
        stopped = upd.budget_stopped(state.ustate)
        counts = state.ustate
        main_path[key].update(budget_stopped=stopped, planned_Ti=upd.planned_Ti,
                              updates_max=int(counts.max()), eps_step=upd.eps_step,
                              eps_spent_max=float(upd.eps_spent(counts).max()))
        log(f"[4] rgg500k_p100 {key}: budget_stopped={stopped} of n={upd.n} "
            f"planned_Ti={upd.planned_Ti} eps_step={upd.eps_step:.6g} "
            f"eps_spent_max={main_path[key]['eps_spent_max']:.6g} (eps_bar {DP['eps_bar']})")
        if not 0 < stopped < upd.n:
            raise SystemExit(f"{key} leg: {stopped} budget-stopped agents, not in (0, n)")
        if int(counts.max()) > upd.planned_Ti:
            raise SystemExit(f"{key} leg: an agent applied more than planned_Ti updates")


def dp_clip_noise_leg(dev, launches: dict) -> dict:
    """The ``dp_clip_noise`` path: ``DP_CLIP_ROUNDS`` private aggregation
    rounds of (256, 4096) per-example gradients through ``ops.dp_clip_noise``
    (clip 1, fresh standard Laplace noise each round, scale 0.1), counts
    reset just before and read just after. Fails unless the kernel ran every
    round and each clipped mean, less its noise, lies within the clip."""
    import torch

    from repro_torch.core.coordinate_descent import standard_laplace
    from repro_torch.kernels import ops

    N, D = DP_CLIP_SHAPE
    gen = torch.Generator(device=dev).manual_seed(2)
    grads = 3.0 * torch.randn((N, D), generator=gen, device=dev)
    noises = standard_laplace((DP_CLIP_ROUNDS, D), gen, dev, torch.float32)
    outs = torch.empty((DP_CLIP_ROUNDS, D), device=dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in range(DP_CLIP_ROUNDS):
        outs[r] = ops.dp_clip_noise(grads, noises[r], 1.0, 0.1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    excess = float(torch.linalg.norm(outs - 0.1 * noises, dim=1).max())
    out = dict(rounds=DP_CLIP_ROUNDS, rounds_per_s=DP_CLIP_ROUNDS / secs,
               finite=bool(torch.isfinite(outs).all()), mean_norm_max=excess)
    log(f"[4] dp_clip_noise leg ({N}, {D}) float32: {fmt(out)} launches={counts}")
    if counts.get("dp_clip_noise", 0) != DP_CLIP_ROUNDS:
        raise SystemExit(f"dp_clip_noise leg: {counts} launches for {DP_CLIP_ROUNDS} rounds")
    if not out["finite"] or excess > 1.0 + 1e-5:
        raise SystemExit("dp_clip_noise leg: output not finite or clipped mean above the clip")
    return out


def parity(dev) -> dict:
    """Phase 5: n = 512 forced-wake runs on the card vs the CPU; fixed point;
    the private path on the card vs its plain route and the CPU."""
    import numpy as np
    import torch

    from repro_torch.core import AgentData, knn_graph, make_objective
    from repro_torch.sim import AsyncEngine, CDUpdate

    n, p, m = 512, 4, 3
    rng = np.random.default_rng(0)
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse")
    masks = [rng.random(n) < 0.25 for _ in range(20)]
    Theta0 = rng.normal(size=(n, p))

    def forced(device, fused):
        eng = AsyncEngine(CDUpdate(obj), slot_wakes=128.0, fused=fused, device=device)
        state = eng.init_state(Theta0)
        for mask in masks:
            state = eng.step(state, mask)
        return eng, state.Theta.to("cpu", copy=True).numpy()

    eng_f, th_f = forced(dev, "auto")
    eng_u, th_u = forced(dev, False)
    _, th_c = forced("cpu", False)
    if not (eng_f.fused and not eng_u.fused):
        raise SystemExit("parity: fused='auto' did not pick the kernel on the card")
    errs = dict(fused_vs_cpu=float(np.abs(th_f - th_c).max()),
                unfused_vs_cpu=float(np.abs(th_u - th_c).max()),
                fused_vs_unfused=float(np.abs(th_f - th_u).max()))
    star = obj.solve_exact()
    res = AsyncEngine(CDUpdate(obj), slot_wakes=128.0, seed=3, device=dev).run(
        np.zeros((n, p)), slots=700)
    errs["fixed_point_vs_exact"] = float(np.abs(res.Theta - star).max())
    errs.update(private_parity(obj, masks[:10], Theta0, dev))
    log("[5] parity: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {PARITY_TOL:.0e}; the private errors relative to max(1, max |Theta|))")
    bad = {k: v for k, v in errs.items() if not v <= PARITY_TOL}
    if bad:
        raise SystemExit(f"parity failed: {bad}")
    return errs


def _rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


def private_parity(obj, masks, Theta0, dev) -> dict:
    """The private path on the card against its other route and the CPU.

    (a) n = 512 forced wakes (``masks``, then all-wake slots past the plan)
    with ``DPCDUpdate``, fused against unfused on the card: one generator
    stream, so both routes get the same noise; the budget counts must be
    identical and all equal ``planned_Ti``. (b) one ``DPCDUpdate.apply_rows``
    on the card against the CPU, numpy-made draws injected. (c)
    ``run_private`` at the Fig. 2 size on the card against the CPU with
    injected draws (equal ``eps_spent``), and ``private_warm_start`` (its
    local models trained on each device). Errors are relative to
    max(1, max |Theta|)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import DPConfig, make_objective, private_warm_start, run_private
    from repro_torch.data.synthetic import linear_classification_problem
    from repro_torch.sim import AsyncEngine, DPCDUpdate

    errs = {}
    dp_obj = dataclasses.replace(obj, clip=DP["clip"])
    n, p = dp_obj.n, dp_obj.p
    cfg = DPConfig(eps_bar=DP["eps_bar"], delta_bar=DP["delta_bar"])
    planned = 3
    runs = {}
    for fused in ("auto", False):
        eng = AsyncEngine(DPCDUpdate.plan(dp_obj, cfg, planned), slot_wakes=float(n),
                          batch_size=n, fused=fused, device=dev)  # no wake is dropped
        state = eng.init_state(Theta0)
        for mask in list(masks) + [np.ones(n, dtype=bool)] * (planned + 2):
            state = eng.step(state, mask)
        runs[fused] = (eng.fused, state.Theta.cpu().numpy(), state.ustate.cpu().numpy())
    if not (runs["auto"][0] and not runs[False][0]):
        raise SystemExit("private parity: fused='auto' did not pick the kernel on the card")
    if not (np.array_equal(runs["auto"][2], runs[False][2])
            and (runs["auto"][2] == planned).all()):
        raise SystemExit("private parity: the budget counts differ or miss planned_Ti")
    errs["dp_fused_vs_unfused"] = _rel_err(runs["auto"][1], runs[False][1])

    upd = DPCDUpdate.plan(dp_obj, cfg, planned)
    rng = np.random.default_rng(4)
    rows = np.concatenate([np.sort(rng.choice(n, size=100, replace=False)), [n] * 28])
    counts = rng.integers(0, planned + 1, size=n).astype(np.int32)
    theta = rng.normal(size=(n, p)).astype(np.float32)
    neigh = rng.normal(size=(len(rows), p)).astype(np.float32)
    draws = rng.laplace(size=(len(rows), p)).astype(np.float32)
    outs = []  # the card's, then the CPU's
    for d in (dev, torch.device("cpu")):
        r = torch.as_tensor(rows).to(d)
        got, applied, state = upd.apply_rows(
            torch.as_tensor(theta).to(d)[r.clamp(max=n - 1)], r, r < n,
            torch.as_tensor(neigh).to(d), None, torch.tensor(counts).to(d),
            draws=torch.as_tensor(draws))
        outs.append((got.cpu().numpy(), applied.cpu().numpy(), state.cpu().numpy()))
    (card, card_applied, card_counts), (cpu, cpu_applied, cpu_counts) = outs
    if not (np.array_equal(card_applied, cpu_applied) and np.array_equal(card_counts, cpu_counts)
            and card_applied.any() and not card_applied.all()):
        raise SystemExit("private parity: apply_rows budget masks or counts differ")
    errs["dp_apply_rows_vs_cpu"] = _rel_err(card, cpu)

    # Fig. 2 (bench_privacy_utility.fig2a_b): n = p = 100, logistic, clip 1.
    prob = linear_classification_problem(n=100, p=100, seed=0)
    fig = make_objective(prob.graph, prob.train, "logistic", mu=0.3, clip=1.0)
    T = 1000
    fcfg = DPConfig(eps_bar=0.55)
    fdraws = np.random.default_rng(5).laplace(size=(T, fig.p)).astype(np.float32)
    a, b = (run_private(fig, np.ones((fig.n, fig.p)), T, fcfg, np.random.default_rng(1),
                        record_every=20, noise_draws=fdraws, device=d) for d in (dev, "cpu"))
    if not (np.array_equal(a.eps_spent, b.eps_spent) and np.isfinite(a.Theta).all()):
        raise SystemExit("private parity: run_private eps_spent differ or Theta not finite")
    errs["run_private_vs_cpu"] = _rel_err(a.Theta, b.Theta)
    errs["run_private_objective_vs_cpu"] = _rel_err(a.objective, b.objective)
    warm, warm_cpu = (private_warm_start(fig, 0.5, np.random.default_rng(0), device=d)
                      for d in (dev, "cpu"))
    errs["warm_start_vs_cpu"] = _rel_err(warm, warm_cpu)
    log(f"[5] Fig. 2 size on the card: run_private T={T} Q {a.objective[0]:.6g} -> "
        f"min {a.objective.min():.6g}, eps_spent max {a.eps_spent.max():.6g} "
        f"(eps_bar {fcfg.eps_bar}); warm start Q {float(fig.value(torch.as_tensor(warm))):.6g}")
    return errs


def _kernel_kind(name: str) -> str:
    low = name.lower()
    if "ssm_chunk" in low:
        return "ssm_chunk"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmul"
    return "softmax" if "softmax" in low else "other"


def traced(fn, trace: Path):
    """Run ``fn()`` under torch.profiler (host and device), write the Chrome
    trace to ``trace``; return its events and the wall milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    return json.loads(trace.read_text()).get("traceEvents", []), wall_ms


def profile_prefill(bundle, model, batch, out_dir: Path, ms_untraced: float) -> dict:
    """Trace one prefill with torch.profiler. Device time by block (the
    model's "mamba2" and "shared_attn" profiler ranges, "outside" for the
    embedding, final norm and lm head), each kernel assigned to the range
    that launched it, and by kernel kind (``ssm_chunk``, matmul, softmax,
    other); the device idle share of the traced prefill and of the
    untraced one (``ms_untraced``)."""
    trace = out_dir / "trace_zamba2_prefill.json"
    events, wall_ms = traced(lambda: bundle.prefill(model, batch), trace)
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") in ("mamba2", "shared_attn"))
    starts = [r[0] for r in ranges]
    # Host-side CUDA API calls (the launches) by correlation id.
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}

    def block(e) -> str:
        t = launched.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return ranges[i][2] if i >= 0 and t <= ranges[i][1] else "outside"

    by_key, by_name = {}, {}
    for e in _device_events(events):
        key = f"{block(e)}/{_kernel_kind(e['name'])}"
        by_key[key] = by_key.get(key, 0.0) + float(e["dur"]) / 1e3
        us, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + float(e["dur"]), count + 1)
    busy_ms = sum(by_key.values())
    if busy_ms <= 0:
        raise SystemExit("zamba2 prefill: the profiler saw no device time")
    out = dict(traced_ms=wall_ms, device_busy_ms=busy_ms,
               device_ops=sum(c for _, c in by_name.values()),
               idle_share_traced=1.0 - busy_ms / wall_ms,
               idle_share_untraced=1.0 - busy_ms / ms_untraced,
               ms_by_block_and_kind=dict(sorted(by_key.items(), key=lambda kv: -kv[1])))
    log(f"[6p] zamba2 prefill traced: {fmt({k: v for k, v in out.items() if k != 'ms_by_block_and_kind'})} "
        f"trace={trace}")
    for key, ms in out["ms_by_block_and_kind"].items():
        log(f"[6p]   {ms:9.3f} ms  {key}")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[6p]   {us / 1e3:9.3f} ms  x{count:4d}  {name[:110]}")
    return out


def zamba2_serve(dev, launches: dict) -> dict:
    """Phase 6: zamba2-1.2b serving at full width and depth, bfloat16.

    Prefill: a warm-up, then ``prefills`` timed prefills of the same batch
    (host clock around a synchronize), launch counts reset just before each
    and read just after: each must launch ``ssm_chunk`` once per layer.
    One more prefill is traced. Decode: ``decode_steps`` greedy steps from
    the prefill's argmax tokens on a fresh cache, each step timed (after a
    2-step warm-up on its own cache). Then the float32 gates (see
    :func:`zamba2_gates`). Fails on a count, shape, non-finite value or gate."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.models.registry import build_model

    z = ZAMBA
    cfg = get_config(z["arch"])
    t0 = time.perf_counter()
    bundle = build_model(cfg, device=dev)
    model = bundle.init(z["seed"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[6] set-up {cfg.name}: layers={cfg.num_layers} d_model={cfg.d_model} "
        f"heads={cfg.num_heads}x{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.padded_vocab} "
        f"ssm(state={cfg.ssm.state_dim} head_dim={cfg.ssm.head_dim} chunk={cfg.ssm.chunk}) "
        f"shared attention every {cfg.shared_attn_every} dtype={cfg.dtype} params={n_params} "
        f"(config's count {cfg.param_count()}) in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(z["seed"] + 1)
    B, S = z["batch"], z["prompt"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)}
    bundle.prefill(model, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(z["prefills"]):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = bundle.prefill(model, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        counts = ops.launch_counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if counts[PATH_KERNEL["zamba2_prefill"]] != cfg.num_layers:
            raise SystemExit(f"zamba2 prefill: {counts} launches, not one ssm_chunk per layer "
                             f"({cfg.num_layers})")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if logits.shape != (B, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"zamba2 prefill: logits {tuple(logits.shape)} or not finite")
    ms = spread(times)
    out = dict(params=n_params, batch=B, prompt=S, prefill_ms=ms["median"],
               prefill_ms_min=ms["min"], prefill_ms_max=ms["max"],
               prefill_tokens_per_s=B * S / ms["median"] * 1e3,
               prefill_tokens_per_s_min=B * S / ms["max"] * 1e3,
               prefill_tokens_per_s_max=B * S / ms["min"] * 1e3,
               ssm_chunk_launches_per_prefill=cfg.num_layers, prefill_peak_gb=peak_gb)
    log(f"[6] {cfg.name} prefill {B} x {S}: {fmt(out)}")
    out["prefill_trace"] = profile_prefill(bundle, model, batch, _build.build_dir() / "traces",
                                           ms["median"])

    first = logits[:, -1].argmax(dim=-1, keepdim=True)  # (B, 1) greedy tokens
    # Warm-up and traced steps on a cache of their own: 2 warm-up steps,
    # then DECODE_TRACED steps under the profiler (positions 2 and 3).
    warm = bundle.init_cache(model, B, 2 + DECODE_TRACED)
    for pos in range(2):
        bundle.decode(model, first, warm, pos)

    def traced_steps():
        for pos in range(2, 2 + DECODE_TRACED):
            bundle.decode(model, first, warm, pos)

    events, wall_ms = traced(traced_steps,
                             _build.build_dir() / "traces" / "trace_zamba2_decode.json")
    dev_events = _device_events(events)
    decode_trace = dict(traced_ms_per_step=wall_ms / DECODE_TRACED,
                        device_busy_ms_per_step=sum(float(e["dur"]) for e in dev_events)
                        / 1e3 / DECODE_TRACED,
                        device_ops_per_step=len(dev_events) / DECODE_TRACED)
    del warm
    steps = z["decode_steps"]
    caches = bundle.init_cache(model, B, steps + 1)
    token, step_ms = first, []
    for pos in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_logits, caches = bundle.decode(model, token, caches, pos)
        token = step_logits[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(step_logits).all()):
        raise SystemExit("zamba2 decode: logits not finite")
    ms = spread(step_ms)
    decode_trace["idle_share_traced"] = (1.0 - decode_trace["device_busy_ms_per_step"]
                                         / decode_trace["traced_ms_per_step"])
    decode_trace["idle_share_untraced"] = 1.0 - decode_trace["device_busy_ms_per_step"] / ms["median"]
    out.update(decode_steps=steps, decode_ms_per_step=ms["median"],
               decode_ms_per_step_min=ms["min"], decode_ms_per_step_max=ms["max"],
               decode_tokens_per_s=B / ms["median"] * 1e3,
               decode_tokens_per_s_min=B / ms["max"] * 1e3,
               decode_tokens_per_s_max=B / ms["min"] * 1e3)
    log(f"[6] {cfg.name} decode {B} x {steps} greedy steps: "
        f"{fmt({k: v for k, v in out.items() if k.startswith('decode')})}")
    log(f"[6p] zamba2 decode, {DECODE_TRACED} traced steps: {fmt(decode_trace)}")
    out["decode_trace"] = decode_trace
    del model, bundle, caches, logits, step_logits
    torch.cuda.empty_cache()
    out["gates"] = zamba2_gates(cfg, dev, gen)
    return out


def zamba2_gates(cfg, dev, gen) -> dict:
    """The float32 correctness gates at full width and depth (TF32 off):
    (1) the prefill of ``ZAMBA_GATE`` tokens (through ``ssm_chunk``) against
    the same tokens fed one at a time through decode, last-token logits;
    (2) the prefill through the kernel against the einsum route on the
    card. Errors relative to max(1, max |logit|), each at most MODEL_TOL."""
    import torch

    from repro_torch.models import hybrid
    from repro_torch.models.registry import build_model

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    bundle = build_model(cfg32, device=dev)
    model = bundle.init(ZAMBA["seed"])
    B, S = ZAMBA_GATE["batch"], ZAMBA_GATE["tokens"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    prefill, _ = bundle.prefill(model, {"tokens": tokens})
    caches = bundle.init_cache(model, B, S)
    for pos in range(S):
        step, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
    with torch.inference_mode():
        einsum, _ = hybrid.forward(model, tokens, cfg32, last_only=True, use_kernel=False)
    scale = max(1.0, float(prefill.abs().max()))
    gates = dict(prefill_vs_decode=float((prefill - step).abs().max()) / scale,
                 kernel_vs_einsum=float((prefill - einsum).abs().max()) / scale,
                 max_abs_logit=float(prefill.abs().max()), batch=B, tokens=S)
    finite = all(bool(torch.isfinite(t).all()) for t in (prefill, step, einsum))
    log(f"[6] {cfg.name} float32 gates: {fmt(gates)} (tol {MODEL_TOL:.0e} relative)")
    if not finite or not (gates["prefill_vs_decode"] <= MODEL_TOL
                          and gates["kernel_vs_einsum"] <= MODEL_TOL):
        raise SystemExit(f"zamba2 float32 gates failed: {gates}, finite={finite}")
    del model, bundle, caches
    torch.cuda.empty_cache()
    return gates


def paper_benches(dev) -> dict:
    """Phase 7: Fig. 1 and Table 1 through the port's runners on the card,
    each beside the reference's CPU row. Launch counts are reset before and
    read after: the benches run none of the kernels. Fails unless CD beats
    ADMM per message, CD beats the local models (accuracy, RMSE), and every
    private RMSE is finite."""
    from repro_torch.bench import cd_vs_admm, movielens
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    fig = cd_vs_admm.run(verbose=False, device=dev, **FIG1)
    fig1 = {k: fig[k] for k in ("n", "p", "mu", "acc_local", "acc_cd", "acc_admm", "obj_init",
                                "obj_cd_final", "obj_admm_final", "messages_admm",
                                "obj_cd_at_admm_budget", "cd_beats_admm_per_message",
                                "elapsed_s")}
    log(f"[7] fig1_cd_vs_admm on the card: {fmt(fig1)}; "
        f"reference CPU row: {REFERENCE_ROWS['fig1_cd_vs_admm']}")
    tab = movielens.run(verbose=False, device=dev, **TABLE1)
    table1 = {k: v for k, v in tab.items() if k not in ("name", "device", "derived")}
    log(f"[7] table1_movielens on the card: {fmt(table1)}; "
        f"reference CPU row: {REFERENCE_ROWS['table1_movielens']} "
        f"(the private rows use the port's own random stream: printed, not compared)")
    counts = ops.launch_counts()
    private = [table1[k] for k in table1 if k.startswith("rmse_eps_")]
    fails = [msg for ok, msg in (
        (fig1["cd_beats_admm_per_message"], "CD does not beat ADMM per message"),
        (fig1["acc_cd"] > fig1["acc_local"], "CD accuracy not above the local models'"),
        (table1["rmse_cd"] < table1["rmse_local"], "CD RMSE not below the local models'"),
        (len(private) == 3 and all(math.isfinite(r) for r in private),
         "a private RMSE is not finite"),
        (not any(counts.values()), f"the benches launched kernels: {counts}"),
    ) if not ok]
    if fails:
        raise SystemExit(f"paper benches: {'; '.join(fails)}")
    return {"fig1_cd_vs_admm": fig1, "table1_movielens": table1}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import DPConfig
    from repro_torch.kernels import _build
    from repro_torch.sim import AsyncEngine, CDUpdate, ChurnConfig, DPCDUpdate, Scenario

    warnings.filterwarnings("ignore", message="Sparse CSR tensor support is in beta")
    warnings.filterwarnings("ignore", message="Sparse invariant checks are implicitly disabled")
    torch.backends.cuda.matmul.allow_tf32 = False  # library_ms of graph_mix: full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # [1] the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[1] device={kind} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")

    # [2] build
    t0 = time.perf_counter()
    logs = _build.build(ptxas_info=True)
    secs = time.perf_counter() - t0
    log(f"[2] built {len(logs)} kernels in {secs:.2f} s; ptxas: {'; '.join(ptxas_summary(logs))}")

    # The main-path problem (host set-up) and the dense problem.
    t0 = time.perf_counter()
    c = MAIN
    obj = quadratic_rgg_problem(c["n"], c["p"], c["m"], c["avg_degree"], c["mu"], c["seed"],
                                mix_mode="sparse")
    dense_obj = quadratic_rgg_problem(DENSE_N, c["p"], c["m"], c["avg_degree"], c["mu"],
                                      c["seed"] + 1)
    scenario = Scenario(churn=ChurnConfig(leave_prob=0.01, rejoin_prob=0.2))
    # The private legs' objective: the same problem with the per-point clip.
    # The clip changes neither the device tensors nor the neighbour tables,
    # so the clipped objective shares the unclipped one's.
    obj.tensors(dev, torch.float32)
    dp_obj = dataclasses.replace(obj, clip=DP["clip"])
    dp_obj.__dict__.update(mix=obj.mix, _tensor_cache=obj.__dict__["_tensor_cache"])
    # Each agent plans for its expected wakes over the whole leg (as
    # run_private plans T // n): warm-up, timed windows and traced slots.
    leg_slots = WARM_STEPS + WINDOWS * WINDOW_STEPS + PROFILE_SLOTS
    planned_Ti = max(int(leg_slots * c["slot_wakes"] // c["n"]), 1)
    dp_cfg = DPConfig(eps_bar=DP["eps_bar"], delta_bar=DP["delta_bar"])

    def engine(update, fused):
        return AsyncEngine(update, slot_wakes=c["slot_wakes"], scenario=scenario,
                           seed=c["seed"], fused=fused, device=dev)

    engines = {"fused": engine(CDUpdate(obj), "auto"), "unfused": engine(CDUpdate(obj), False),
               "dp_fused": engine(DPCDUpdate.plan(dp_obj, dp_cfg, planned_Ti), "auto"),
               "dp_unfused": engine(DPCDUpdate.plan(dp_obj, dp_cfg, planned_Ti), False)}
    torch.cuda.synchronize()
    log(f"[4] set-up rgg500k_p100: n={obj.n} p={obj.p} m={c['m']} "
        f"max_degree={obj.graph.max_degree()} mean_degree={obj.graph.nnz / obj.n:.3f} "
        f"batch={engines['fused'].batch_size} dense n={dense_obj.n} kind={dense_obj.mix.kind} "
        f"private: clip={DP['clip']} eps_bar={DP['eps_bar']} delta_bar={DP['delta_bar']:.6g} "
        f"planned_Ti={planned_Ti} in {time.perf_counter() - t0:.1f} s")
    if not (engines["fused"].fused and engines["dp_fused"].fused
            and not engines["dp_unfused"].fused) or dense_obj.mix.kind != "dense":
        raise SystemExit("set-up: fused='auto' did not pick the kernel, or no dense path")

    # [3] kernel checks (these launches are not the main path's)
    results: dict = {}
    kernel_checks(obj, engines["fused"], dense_obj, results)
    ssm_chunk_checks(dev, results)

    # [4] the main path: each path's counts are reset before it and read after
    main_path, states, launches = drive_main_path(engines, dense_obj, obj, dev)

    # [4p] where a slot's device time goes, traced after every timed leg
    # (an attached tracer slows what runs after it).
    for key in ENGINE_LEGS:
        states[key] = profile_slots(f"rgg500k_p100 {key}", engines[key], states[key],
                                    PROFILE_SLOTS, _build.build_dir() / "traces",
                                    main_path[key]["ms_per_slot"])
    for key, o in (("dense", dense_obj), ("sparse_sync", obj)):
        main_path[key]["trace"] = profile_rounds(
            f"{key} n={o.n}", o, PROFILE_SLOTS, _build.build_dir() / "traces",
            main_path[key]["ms_per_round"], dev)
    budget_check(engines, states, main_path)
    main_path["dp_clip_noise"] = dp_clip_noise_leg(dev, launches)
    missing = [k for k in _build.KERNELS if k not in PATH_KERNEL.values()]
    if missing:
        raise SystemExit(f"no path of phase 4 launches {missing}")

    # [5] parity on the card
    parity(dev)

    # [6] zamba2-1.2b serving: the prefill's counts are reset before each
    # prefill and read after it
    serve = zamba2_serve(dev, launches)

    # [7] the paper benches on the card
    benches = paper_benches(dev)

    # [8] the kernel table and the result
    src = {"sparse_mix": "src/repro/kernels/sparse_mix.py:60",
           "fused_row_update": "src/repro/kernels/fused_row_update.py:133",
           "graph_mix": "src/repro/kernels/graph_mix.py:38",
           "dp_clip_noise": "src/repro/kernels/dp_clip_noise.py:67",
           "ssm_chunk": "src/repro/kernels/ssm_scan.py:43"}
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": src[name],
            "launches": int(launches[name]),
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"],
            "plain_ms": results[name]["plain_ms"],
            "bound_ms": results[name]["bound_ms"],
            "bound_by": results[name]["bound_by"],
            "library_ms": results[name]["library_ms"],
        }
        for name in _build.KERNELS
    ]
    log(json.dumps({"main_path": main_path, "sparse_mix_Rn": results["sparse_mix_Rn"],
                    "dp_clip_noise_bf16": results["dp_clip_noise_bf16"],
                    "ssm_chunk_bf16": results["ssm_chunk_bf16"]}))
    log(json.dumps({"zamba2_serve": serve}))
    log(json.dumps({"paper_benches": benches}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

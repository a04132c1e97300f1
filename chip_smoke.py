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
   and at a small ragged shape in bfloat16; ``fused_row_update`` again at
   the sharded engine's shape (S * B_s woken rows over the stacked
   S * (R + Hmax)-row slab of the ``rgg500k_p100`` partition);
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
   through ``sparse_mix`` at R = n); and the sharded engine on the same
   problem (``ShardedAsyncEngine``, S = 8 shards stacked on the card,
   ``relabel="rcm"``, ``partition_mode="degree"``, one partition shared by
   its legs): ``sharded_fused`` (exchange ``"auto"``, metrics on),
   ``sharded_unfused`` (the reference's einsum gather over the slab: no
   kernel of ours) and ``sharded_fused_bf16_ef`` (a p2p bf16 wire with
   error feedback), each printed with B_s, R, Hmax, the halo fraction,
   the method ``"auto"`` chose, the rows and bytes shipped a slot and the
   partition's build seconds, and its slots/s against the single-device
   leg's window by window; ``sharded_fused``'s ``exchange`` counters must
   equal the plan's volume times the slots, and its ``wakes_applied``
   the state's count. The engine legs run through
   ``AsyncEngine.advance``, which on the card replays the engine's captured
   chunk (a CUDA graph of 16 slots and one of 1 slot); each engine leg is
   also run eagerly, slot by slot (``_eager_slots``), on a state of its
   own from the same start, as a leg of its own. After a warm-up (which
   captures both graphs) the sixteen legs take turns over 7 timed windows of
   200 slots (rounds) each; each rate is the median window's, printed with
   the slowest and fastest, and the fused/unfused and captured/eager
   ratios are taken window by window. Launch counts are reset before and
   read after every window (a replay adds what its capture recorded), and
   each leg must launch its own kernel in every window. The private fused
   engine runs with metrics on: its ``dp_budget_stopped`` must equal the
   accountant's count and its ``wakes_applied`` the state's. Then 16
   slots of each engine leg, captured and eager, and 16 rounds of each
   synchronous leg run under torch.profiler (traces in
   ``build/repro_torch/``): device time per slot (round) by kernel, and the
   device idle share. Last, the ``dp_clip_noise`` leg:
   200 DP aggregation rounds of (256, 4096) per-example gradients through
   ``ops.dp_clip_noise``, the path by which the kernel is reached (no engine
   path calls it, as in the JAX package);
4c. checkpoints and serving on the same problem (``repro_torch.checkpoint``,
   ``repro_torch.serve``): the ``fused``, ``dp_fused`` (metrics on),
   ``unfused`` and ``sharded_fused_bf16_ef`` legs' phase-4 states (their
   captured live buffers) are each saved into a rotation under
   ``build/ckpt`` (at most 2 entries, removed after the leg; the free
   space is printed first), restored into a fresh engine of the same
   config, and both engines advance 37 captured slots: every state
   tensor and the generator's state must be ``torch.equal``, and the
   leg's kernel must launch once a slot on each (counts reset before each
   leg and read after). Printed: seconds to save and to restore, bytes on
   disk, save MB/s; the S = 8 entry restored at S = 4 (its seconds, the
   rows, and the run totals, which must be kept). Then live serving on
   the ``fused`` leg: windows of 800 slots through ``run``, serving off
   and on in turns (on: ``run(snapshot_every=16, serve=handle)`` in a
   trainer thread while this thread issues ``predict`` batches of 1024
   ids, a tenth of them cold with 4 neighbours); every 25th answer is
   held against a recomputation from its pinned snapshot. Printed: the
   slot rates off and on, p50 and p99 ms, predictions/s, device us a
   publication, the largest version lag. Last, ``python -m
   repro_torch.serve --live`` once at its default size, its summary
   parsed;
4d. dynamic topology on the same problem, uncut and unfused by the rule:
   ``GraphUpdate(every=400, k=10, candidates=4, gamma=4.0)`` (the refresh
   of ``benchmarks/bench_dynamic_topology.py``: one interior refresh in 800
   slots) and 1,000 arrivals at slots 100 and 500 from a seeded draw
   (``attach_k=4``, a 2-round Eq. 16 warm start), in three legs of 800
   slots through the segment driver ``_drive_dynamic``: ``dynamic``
   (captured), ``dynamic_eager`` (a second engine, eager) and
   ``sharded_dynamic`` (S = 8 stacked, RCM, degree blocks), taking turns
   in windows of 100 slots that the events bound. Per leg: the window
   rates (topology calls and captures timed apart, synchronized), the
   host seconds of each refresh and admission with the ``set_topology``
   inside it (its tier, the cut's drift, the capacity after it), the
   captures and recaptures, the topology log, and 16 traced slots. The
   dynamic slot gathers with the reference's einsum: no kernel of ours,
   checked to launch none; ``dynamic`` must equal ``dynamic_eager`` bit
   for bit, topology logs included;
5. parity: the captured chunk against the eager slots, bit for bit: 37
   slots (2 chunk replays, 4 one-slot replays) of each engine leg at
   ``rgg500k_p100`` (fresh states, copied into the engines' live buffers)
   and at n = 512 with churn and stragglers (and an S = 4 sharded engine
   at n = 512), every state tensor compared
   with ``torch.equal``; the sharded engine at S = 4 on the card against
   the single-device port under forced wakes at n = 96 (fused and unfused
   within 1e-6, a compressed wire between 0 and 5e-2), and its n = 512
   fixed point at S = 2, 4 and 8 within 1e-5; at n = 512, forced-wake runs fused vs unfused on
   the card vs the same run on the CPU, and the engine's fixed point vs
   the exact solution; a private forced-wake run fused vs unfused on the card;
   ``DPCDUpdate.apply_rows`` on the card vs the CPU with injected draws;
   ``run_private`` and ``private_warm_start`` at the Fig. 2 size (n = 100,
   p = 100, logistic, clip 1.0, eps 0.55, T = 1000) on the card vs the CPU,
   with injected draws; dynamic topology at n = 512: a dynamic engine whose
   refresh never fires vs the static unfused one, captured == eager across
   a refresh within capacity (no recapture), a capacity-growing swap (one),
   an admission and, sharded at S = 4, a weight-only patch, a structural
   patch and a forced repartition, and the card vs the CPU with explicit
   refreshes and admissions; a dynamic run at n = 512 saved at slots 20
   (a refresh boundary), 25 and 40 (after an admission), restored into a
   fresh engine and run to slot 50, bit for bit against the
   uninterrupted run (single-device and S = 4), and its last entry
   served on the card and on the CPU (predictions within 1e-5);
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
   private RMSE is finite. Then Figs. 2-4 and the ablations at the
   reference runners' fast size (``BENCH_summary.json``'s rows): the
   deterministic fields (Fig. 2c's last row, Fig. 3's local split, Fig.
   4's clean accuracy, the personalization ablation) must equal the
   reference's CPU values within 0.005, non-private CD must beat the local
   models in every Fig. 2c row, the warm start's private run must end
   below the constant init's, personalized must beat global, and every
   private accuracy must be finite and in [0, 1]. These benches launch
   none of the kernels. Last, ``repro_torch.bench.dynamic_topology`` at
   n = 200,000 (host-side: patch against rebuild, the drift), which must
   hold its halo parity; ``repro_torch.bench.checkpoint`` at its
   reference default (n = 200,000, S = 8) and ``repro_torch.bench.serving``
   (n = 100,000, S = 8, batch 1024), each row beside the reference's CPU
   row in ``BENCH_summary.json``;
8. a JSON line of every ported kernel (launches, error, times, bound),
   then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
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
WARM_STEPS = 18  # an eager slot, then a chunk of 16 and a tail slot: both graphs captured
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
                  "table1_movielens": "rmse_local=1.490,rmse_cd=1.345",
                  "fig2_privacy_utility": "acc_local=0.791,acc_nonpriv=0.868",
                  "ablations": "personalized=0.897,global=0.890"}
# The deterministic fields of Figs. 2-4 and the ablations at the fast size,
# from the JAX package's runners on a CPU (benchmarks/bench_privacy_utility.py,
# benchmarks/bench_ablations.py, run(fast=True)); the card must agree within
# BENCH_ACC_TOL (a test point or two).
REFERENCE_FAST = {"fig2c_acc_local": 0.7906667, "fig2c_acc_nonprivate": 0.8683333,
                  "fig3_acc_local_small_m": 0.742, "fig3_acc_local_large_m": 0.8393333,
                  "fig4_acc_local_clean": 0.7913333, "acc_personalized": 0.8975,
                  "acc_global": 0.89}
BENCH_ACC_TOL = 0.005
# Phase 5: the captured chunk against the eager slots.
CAPTURE_PARITY_SLOTS = 37  # 2 chunks of 16 and 5 single slots (the first one eager)
# The sharded legs (see PERF.md, "Cells"): benchmarks/bench_sharded_engine.py's
# shard count and defaults, its S shards stacked on the one card.
SHARDED = dict(num_shards=8, relabel="rcm", partition_mode="degree")
SHARDED_PARITY_TOL = 1e-6  # the reference's sharded-against-single-device bound
SHARDED_WIRE_TOL = 5e-2  # a compressed wire against the single-device engine


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


def sharded_kernel_check(obj, engine, results) -> None:
    """Phase 3, ``fused_row_update`` at the sharded engine's shape: one
    slot's S * B_s woken rows over the stacked S * (R + Hmax)-row slab
    (limit S * R), its inputs packed by the engine's own code, against the
    plain version; stored as ``fused_row_update_sharded``."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.fused_row_update import row_plan
    from repro_torch.sim.updates import _eq4_fused_args, fused_rows

    dev = engine.device
    S, R, p = engine.num_shards, engine.rows_per_shard, obj.p
    gen = torch.Generator(device=dev).manual_seed(4)
    slab = torch.randn((engine.smix.slab_rows, p), generator=gen, device=dev)
    wake = torch.rand((S, R), generator=gen, device=dev) < engine._wake_p
    _, slot_rows, valid, _ = engine._compact(wake)
    rows = (slot_rows + engine._shard_base).reshape(-1)
    valid = valid.reshape(-1)
    consts = {k: v[rows] for k, v in engine._consts.items()}
    krows, consts = fused_rows(obj, engine._owned[rows], valid, dev, rows, S * R, consts)
    cols, ww = engine._fidx[rows], engine._fw[rows]
    args = _eq4_fused_args(obj, krows, cols, ww, consts, None)
    limit = S * R
    got = ops.fused_row_update(*args, slab.clone(), limit)
    want = ref.fused_row_update_ref(*args, slab.clone(), limit)
    B, K = cols.shape
    m = args[4].shape[1]
    nvalid = int(valid.sum())
    real = (ww != 0) & valid[:, None]
    rows_read = int(torch.unique(torch.cat([cols[real].long(), rows[valid]])).numel())
    nbytes = (nvalid * (4 + 2 * K * 4 + 4 * 4 + m * p * 4 + 2 * m * 4)
              + rows_read * p * 4 + nvalid * p * 4)
    flops = 2.0 * int(real.sum()) * p + nvalid * (4.0 * m * p + 8.0 * p)
    slab_k, slab_p = slab.clone(), slab.clone()
    plan = row_plan(B, p, (slab, args[4], args[7]))
    single = results["fused_row_update"]
    timing = dict(
        shards=S, B=B, K=K, valid=nvalid, slab_rows=slab.shape[0], limit=limit,
        passes=plan.passes, float4=plan.vec,
        ms=time_ms(lambda: ops.fused_row_update(*args, slab_k, limit)),
        plain_ms=time_ms(lambda: ref.fused_row_update_ref(*args, slab_p, limit)),
        library_ms=None, **bound(nbytes, flops),
    )
    check_kernel("fused_row_update", got, want, results, **timing)
    results["fused_row_update_sharded"] = results["fused_row_update"]
    results["fused_row_update"] = single  # the kernel table keeps the main path's shape


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


def profile_slots(label, advance, state, slots: int, out_dir: Path, ms_per_slot: float):
    """Trace ``advance(state, slots)`` (the captured chunk, or the eager
    slot loop) with torch.profiler (Chrome trace in ``out_dir``); returns
    the state and the report (:func:`report_trace`)."""
    box = [state]

    def run():
        box[0] = advance(box[0], slots)

    events, wall_ms = traced(run, out_dir / f"trace_{label.replace(' ', '_')}.json")
    return box[0], report_trace(label, events, wall_ms, slots, "slot", ms_per_slot)


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
# The sharded unfused leg gathers with the reference's einsum: it launches none
# of the kernels (None), and the check holds it to that.
PATH_KERNEL = {"fused": "fused_row_update", "unfused": "sparse_mix",
               "dp_fused": "fused_row_update", "dp_unfused": "sparse_mix",
               "sharded_fused": "fused_row_update", "sharded_unfused": None,
               "sharded_fused_bf16_ef": "fused_row_update",
               "dense": "graph_mix", "sparse_sync": "sparse_mix",
               "dp_clip_noise": "dp_clip_noise", "zamba2_prefill": "ssm_chunk"}
SHARDED_LEGS = ("sharded_fused", "sharded_unfused", "sharded_fused_bf16_ef")
ENGINE_LEGS = ("fused", "unfused", "dp_fused", "dp_unfused") + SHARDED_LEGS
PATH_KERNEL.update({f"{key}_eager": PATH_KERNEL[key] for key in ENGINE_LEGS})
SYNC_LEGS = ("dense", "sparse_sync")  # synchronous_round: graph_mix, sparse_mix at R = n


def check_windows(label: str, timed_leg: dict) -> None:
    """Fail unless the leg launched its path's kernel in every window (a leg
    whose path has none: unless it launched no kernel in any window)."""
    want = PATH_KERNEL[label]
    if want is None:
        per = [sum(w.values()) for w in timed_leg["windows"]]
        if not per or max(per) > 0:
            raise SystemExit(f"{label} leg: launched kernels its path has none of ({per})")
        return
    per = [w.get(want, 0) for w in timed_leg["windows"]]
    if not per or min(per) <= 0:
        raise SystemExit(f"{label} leg: {want} not launched in every window ({per})")


def drive_main_path(engines, dense_obj, sparse_obj, dev):
    """Phase 4: the engine legs of ``engines`` (``ENGINE_LEGS``: the fused
    and unfused slots, non-private and private) through ``advance`` (the
    captured chunk on the card) and each again through the eager slot loop
    on a state of its own from the same start (``<leg>_eager``), dense
    synchronous rounds (``graph_mix``) and synchronous rounds on the sparse
    main-path objective (the paper's synchronous baseline: ``MixOp.all``
    through ``sparse_mix`` at R = n), warmed up, then timed in interleaved
    windows. Fails unless each leg launched its kernel in every window and
    kept Theta finite, and each non-private leg lowered its objective.
    Returns the legs' numbers, the engine states (captured, then eager) and
    the launch counts of the timed windows."""
    import numpy as np
    import torch

    from repro_torch.core.coordinate_descent import synchronous_round

    states = {}
    for key in ENGINE_LEGS:
        eng = engines[key]
        for label, run in ((key, eng.advance), (f"{key}_eager", eng._eager_slots)):
            state = eng.init_state(np.zeros((eng.n, eng.p), dtype=np.float32))
            q0 = eng._objective_value(state)
            states[label] = dict(q0=q0, run=run, eng=eng, state=run(state, WARM_STEPS))
    sync = {}  # the synchronous legs: objective, iterate, starting value
    for key, o in (("dense", dense_obj), ("sparse_sync", sparse_obj)):
        Theta = torch.zeros((o.n, o.p), device=dev, dtype=torch.float32)
        sync[key] = dict(obj=o, Theta=Theta, q0=float(o.value(Theta)))

    def slots(label):
        leg = states[label]

        def step(k):
            leg["state"] = leg["run"](leg["state"], k)
        return step, lambda: int(leg["state"].applied.sum())

    def rounds(key):
        def step(k):
            leg = sync[key]
            for _ in range(k):
                leg["Theta"] = synchronous_round(leg["obj"], leg["Theta"])
        return step, None

    launches: dict = {}
    legs = {label: slots(label) for label in states}
    for key in SYNC_LEGS:
        legs[key] = rounds(key)
        legs[key][0](WARM_STEPS)
    timed = timed_windows(legs, launches)

    main_path = {}
    for label, st in states.items():
        eng, t = st["eng"], timed[label]
        state = st["state"]
        rate = spread(t["rates"])
        out = dict(
            slots_per_s=rate["median"], slots_per_s_min=rate["min"], slots_per_s_max=rate["max"],
            wakes_per_s=statistics.median(t["wakes"]), ms_per_slot=1e3 / rate["median"],
            windows=WINDOWS, window_slots=WINDOW_STEPS, dropped=int(state.dropped.sum()),
            finite=bool(torch.isfinite(state.Theta).all()), Q0=st["q0"],
            Q=eng._objective_value(state),
        )
        if hasattr(eng, "num_shards"):
            out.update(sharded_layout(eng))
        main_path[label] = out
        log(f"[4] rgg500k_p100 {label}: fused={eng.fused} batch={eng.batch_size} {fmt(out)} "
            f"launches={t['counts']}")
        if not out["finite"]:
            raise SystemExit(f"{label} leg: Theta is not finite")
        check_windows(label, t)
        if not label.startswith("dp_") and not out["Q"] < out["Q0"]:
            raise SystemExit(f"{label} leg: the objective did not decrease")
    pairs = [("fused", "unfused"), ("dp_fused", "dp_unfused")]
    pairs += [(key, f"{key}_eager") for key in ENGINE_LEGS]
    # The cost of sharding on one card: each sharded leg against the
    # single-device leg of its route, captured and eager.
    for key, single in (("sharded_fused", "fused"), ("sharded_unfused", "unfused"),
                        ("sharded_fused_bf16_ef", "fused")):
        pairs += [(key, single), (f"{key}_eager", f"{single}_eager")]
    for a, b in pairs:
        ratios = [f / u for f, u in zip(timed[a]["rates"], timed[b]["rates"])]
        main_path[f"{a}_over_{b}"] = dict(spread(ratios), windows=ratios)
        log(f"[4] {a} / {b} slots/s, window by window: "
            f"{' '.join(f'{r:.4g}' for r in ratios)} ({fmt(spread(ratios))})")
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


def sharded_layout(eng) -> dict:
    """A sharded engine's layout and wire: S, B_s, R, Hmax, the halo
    fraction, the method ``"auto"`` (or the spec) chose, the rows and bytes
    shipped a slot over all shards, and the partition's build seconds."""
    vol = eng._exchange_volume()
    return dict(shards=eng.num_shards, batch_per_shard=eng.batch_size,
                R=eng.rows_per_shard, Hmax=eng.smix.halo_width,
                halo_fraction=eng.part.halo_fraction(), method=eng.exchange_method,
                wire=eng.smix.dtype, error_feedback=bool(eng._use_ef),
                rows_per_slot=int(vol.rows_shipped.sum()),
                bytes_per_slot=int(vol.bytes_shipped.astype("int64").sum()),
                partition_s=getattr(eng, "partition_seconds", None))


def sharded_metrics_check(engines, states, main_path) -> None:
    """``sharded_fused`` (metrics on) at its end: its ``exchange`` counters
    must equal the plan's per-slot volume times the slots the state ran,
    and its ``wakes_applied`` the state's applied count."""
    eng, state = engines["sharded_fused"], states["sharded_fused"]
    counters, _ = eng.metrics_snapshot(state)
    vol = eng._exchange_volume()
    slots = eng._ptr_of(state)
    got = dict(exchange_rows=int(counters["exchange_rows"].sum()),
               exchange_bytes=int(counters["exchange_bytes"].sum()),
               border_rows_published=int(counters["border_rows_published"].sum()),
               wakes_applied=int(counters["wakes_applied"].sum()))
    want = dict(exchange_rows=int(vol.rows_shipped.sum()) * slots,
                exchange_bytes=int(vol.bytes_shipped.astype("int64").sum()) * slots,
                border_rows_published=int(vol.border_rows.sum()) * slots,
                wakes_applied=int(state.applied.sum()))
    main_path["sharded_fused"]["metrics"] = dict(got, slots=slots)
    log(f"[4] rgg500k_p100 sharded_fused metrics after {slots} slots: {fmt(got)} "
        f"(plan x slots and state: {fmt(want)})")
    if got != want:
        raise SystemExit(f"sharded_fused: the exchange counters disagree: {got} != {want}")


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
        if engines[key].metrics_spec is None:
            continue
        # The device counters, updated inside the captured slots.
        counters, derived = engines[key].metrics_snapshot(state)
        metrics = dict(dp_budget_stopped=int(counters["dp_budget_stopped"]),
                       wakes_applied=int(counters["wakes_applied"]),
                       wakes_realized=int(counters["wakes_realized"]),
                       churn_departures=int(counters["churn_departures"]),
                       staleness_hist=[int(x) for x in counters["staleness_hist"]],
                       dp_eps_spent_max=derived["dp_eps_spent_max"])
        main_path[key]["metrics"] = metrics
        log(f"[4] rgg500k_p100 {key} metrics: {fmt(metrics)} (state: applied="
            f"{int(state.applied)}, budget_stopped={stopped})")
        if metrics["dp_budget_stopped"] != stopped or metrics["wakes_applied"] != int(state.applied):
            raise SystemExit(f"{key} leg: the metrics disagree with the state: {metrics}")


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


# The dynamic legs (see PERF.md, "Cells"): the 500k problem with the
# refresh parameters of benchmarks/bench_dynamic_topology.py every 400
# slots (one interior refresh in 800: the end never refreshes) and 1,000
# arrivals at slots 100 and 500 from a seeded draw.
DYN_GU = dict(every=400, k=10, candidates=4, gamma=4.0, seed=0)
DYN_ARRIVALS = dict(slots=(100, 500), per_slot=1000, attach_k=4, warm_rounds=2, seed=0)
DYN_SLOTS = 800
DYN_WINDOW = 100
DYN_LEGS = ("dynamic", "dynamic_eager", "sharded_dynamic")
# max |card - CPU| of the n = 512 forced dynamic runs, and of the dynamic
# slot (einsum) against the static one (sparse_mix): float32 sums in
# another order.
DYN_TOL = 1e-5


def dynamic_arrivals(csr):
    """The arrival scenario of the dynamic legs: ``per_slot`` agents at each
    of ``slots``, drawn without replacement from a numpy generator. A draw
    ``_detach_edges`` refuses (an established agent left with no
    neighbour until the arrivals join: the reference's rule) is logged and
    the next seed taken."""
    import numpy as np

    from repro_torch.sim import ArrivalConfig
    from repro_torch.sim.engine import _detach_edges

    a = DYN_ARRIVALS
    seed = a["seed"]
    while True:
        ids = np.random.default_rng(seed).choice(csr.n, a["per_slot"] * len(a["slots"]),
                                                 replace=False)
        try:
            _detach_edges(csr, np.sort(ids))
        except ValueError as e:
            log(f"[4d] arrival draw seed {seed} refused by _detach_edges ({e}); next seed")
            seed += 1
            continue
        chunks = np.split(ids, len(a["slots"]))
        schedule = tuple((s, tuple(int(i) for i in c)) for s, c in zip(a["slots"], chunks))
        return ArrivalConfig(schedule=schedule, attach_k=a["attach_k"], warm_start=True,
                             warm_rounds=a["warm_rounds"], seed=seed), seed


def dynamic_engines(obj, churn, dev) -> dict:
    """The three dynamic legs on the 500k problem (churn as the other legs):
    ``dynamic`` (captured) and ``dynamic_eager`` (the eager slots, a second
    engine run in turns with it) single-device, unfused by the rule, and
    ``sharded_dynamic`` (S = 8 stacked, RCM, degree blocks, captured), all
    with the same refresh and arrivals."""
    from repro_torch.sim import (AsyncEngine, CDUpdate, GraphUpdate, Scenario,
                                 ShardedAsyncEngine)

    arrival, seed = dynamic_arrivals(obj.graph)
    c = MAIN
    kw = dict(slot_wakes=c["slot_wakes"], seed=c["seed"], device=dev,
              scenario=Scenario(churn=churn, arrival=arrival),
              graph_update=GraphUpdate(**DYN_GU))
    out = {}
    for label in DYN_LEGS:
        t0 = time.perf_counter()
        if label == "sharded_dynamic":
            eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=SHARDED["num_shards"],
                                     relabel=SHARDED["relabel"],
                                     partition_mode=SHARDED["partition_mode"], **kw)
        else:
            eng = AsyncEngine(CDUpdate(obj), **kw)
        eng.setup_seconds = time.perf_counter() - t0
        out[label] = eng
    log(f"[4d] set-up dynamic legs: arrival seed {seed}, "
        f"{len(arrival.all_ids())} arrivals at slots {DYN_ARRIVALS['slots']}, refresh "
        f"{DYN_GU}; " + " ".join(f"{k}_setup_s={e.setup_seconds:.3f}" for k, e in out.items()))
    return out


def _instrument(eng, calls: list):
    """Wrap the engine's topology calls (and its graphs' capture) on the
    instance, so that each call the segment driver makes appends a dict to
    ``calls``: its name, synchronized host seconds, depth (0: a call of
    the driver's; 1: inside one, as a refresh's or an admission's
    ``set_topology``), and for ``set_topology`` the tier it took
    (``retile`` on the single-device engine), the capacity after it and
    the cut's drift it measured (a structural swap of the sharded engine)."""
    import torch

    depth = [0]
    tiers = ("weight_patches", "structural_patches", "repartitions")

    def wrap(obj, name):
        orig = getattr(obj, name)

        def timed(*a, **k):
            if name == "_graph" and a[0] in obj.graphs:
                return orig(*a, **k)  # a replay of a graph already captured
            before = dict(eng.topology_log)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = orig(*a, **k)
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            entry = dict(name=name, seconds=time.perf_counter() - t0, depth=depth[0])
            if name == "set_topology":
                moved = [t for t in tiers if eng.topology_log[t] > before[t]]
                entry.update(tier=moved[0] if moved else "retile", capacity=_capacity(eng),
                             drift=eng.topology_log["last_drift"] if moved[:1] != [
                                 "weight_patches"] and moved else None)
            calls.append(entry)
            return out

        setattr(obj, name, timed)

    for name in ("_refresh_topology", "set_topology", "admit"):
        wrap(eng, name)
    if eng._graphs is not None:
        wrap(eng._graphs, "_graph")


def _events(calls: list) -> list:
    """The driver's calls of ``calls`` (depth 0) in order, each with the
    ``set_topology`` made inside it: ``(name, seconds, inner)``."""
    out, inner = [], None
    for c in calls:
        if c["depth"] > 0:
            inner = c
            continue
        if c["name"] == "set_topology":
            inner = c
        out.append(dict(name=c["name"], seconds=c["seconds"],
                        **{k: None if inner is None else inner[v] for k, v in (
                            ("set_topology_s", "seconds"), ("tier", "tier"),
                            ("capacity", "capacity"), ("drift", "drift"))}))
        inner = None
    return out


def _capacity(eng) -> dict:
    """The slot capacity: the single-device tiles' width, or the sharded
    tiles' width with R and Hmax."""
    if hasattr(eng, "num_shards"):
        return dict(K=int(eng.part.tile_width), R=eng.rows_per_shard, Hmax=eng.smix.halo_width,
                    method=eng.exchange_method)
    return dict(capacity=int(eng.topo.capacity))


def dynamic_legs(engines, launches: dict):
    """Phase 4, the dynamic legs: ``DYN_SLOTS`` slots of each leg through
    the reference's segment driver (``_drive_dynamic``, what ``run`` calls:
    refresh, then admissions, at their absolute slots), in windows that
    the events bound, the legs taking turns window by window. A window's
    slot rate leaves out its topology calls and captures (each timed on
    its own, synchronized). Launch counts are reset before and read after
    every window: the dynamic slot launches none of the kernels (the
    reference's einsum gather). Fails unless ``dynamic`` equals
    ``dynamic_eager`` bit for bit (every state tensor, the topology logs,
    the counters), every leg admitted both batches and refreshed once, and
    Theta stays finite. Returns the legs' numbers and their states."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sim.engine import _drive_dynamic

    every = DYN_GU["every"]
    events = sorted({s - 1 for s in DYN_ARRIVALS["slots"]} | set(range(every, DYN_SLOTS, every)))
    cuts = {0, DYN_SLOTS} | set(events)
    for a, b in zip([0] + events, events + [DYN_SLOTS]):
        cuts.update(range(a + DYN_WINDOW, b, DYN_WINDOW))
    bounds = sorted(cuts)
    legs = {}
    for label in DYN_LEGS:
        eng = engines[label]
        run = eng._eager_slots if label.endswith("_eager") else eng.advance
        calls: list = []
        _instrument(eng, calls)
        state = eng.init_state(np.zeros((eng.n, eng.p), dtype=np.float32))
        legs[label] = dict(eng=eng, run=run, calls=calls, state=state,
                           q0=eng._objective_value(state), before=_capacity(eng),
                           windows=[], counts={})
    for a, b in zip(bounds[:-1], bounds[1:]):
        for label, leg in legs.items():
            eng, calls = leg["eng"], leg["calls"]
            seen = len(calls)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            leg["state"] = _drive_dynamic(eng, leg["state"], b - a, [], leg["run"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = ops.launch_counts()
            for k, v in counts.items():
                leg["counts"][k] = leg["counts"].get(k, 0) + v
                launches[k] = launches.get(k, 0) + v
            aside = sum(c["seconds"] for c in calls[seen:] if c["depth"] == 0)
            leg["windows"].append(dict(start=a, slots=b - a, slot_seconds=secs - aside))
    out, states = {}, {}
    for label, leg in legs.items():
        eng, state = leg["eng"], leg["state"]
        timed = [w for w in leg["windows"] if w["slots"] >= DYN_WINDOW - 1 and w["start"] > 0]
        rate = spread([w["slots"] / w["slot_seconds"] for w in timed])
        calls = leg["calls"]
        log_ = eng.topology_counters()
        g = getattr(eng, "_graphs", None)
        events = _events(calls)
        row = dict(slots_per_s=rate["median"], slots_per_s_min=rate["min"],
                   slots_per_s_max=rate["max"], ms_per_slot=1e3 / rate["median"],
                   windows=len(timed), window_slots=DYN_WINDOW,
                   window_rates=[w["slots"] / w["slot_seconds"] for w in leg["windows"]],
                   events=[e for e in events if e["name"] != "_graph"],
                   capture_s=[e["seconds"] for e in events if e["name"] == "_graph"],
                   recaptures=None if g is None else g.recaptures,
                   capacity_before=leg["before"], capacity_after=_capacity(eng),
                   topology=log_, slots=eng._ptr_of(state), applied=int(state.applied.sum()),
                   finite=bool(torch.isfinite(state.Theta).all()), Q0=leg["q0"],
                   Q=eng._objective_value(state), launches=leg["counts"],
                   setup_s=eng.setup_seconds)
        out[label] = row
        states[label] = state
        scalars = {k: v for k, v in row.items() if not isinstance(v, (list, dict))}
        log(f"[4d] rgg500k_p100 {label}: {fmt(scalars)} capacity {leg['before']} -> "
            f"{row['capacity_after']} topology={log_} launches={leg['counts']}")
        log(f"[4d]   window slots/s (slots {bounds}): "
            f"{' '.join(f'{r:.5g}' for r in row['window_rates'])}; captures (s): "
            f"{' '.join(f'{c:.4f}' for c in row['capture_s'])}")
        for e in row["events"]:
            log(f"[4d]   {e['name']}: {e['seconds']:.4f} s, of which set_topology "
                f"{e['set_topology_s'] if e['set_topology_s'] is None else round(e['set_topology_s'], 4)} s "
                f"({e['tier']}, drift {e['drift']}, capacity after {e['capacity']})")
        if not row["finite"]:
            raise SystemExit(f"{label} leg: Theta is not finite")
        if any(leg["counts"].values()):
            raise SystemExit(f"{label} leg: launched kernels its path has none of "
                             f"({leg['counts']})")
        if log_["edge_refreshes"] != 1 or log_["arrivals"] != DYN_ARRIVALS["per_slot"] * len(
                DYN_ARRIVALS["slots"]) or row["slots"] != DYN_SLOTS:
            raise SystemExit(f"{label} leg: expected one refresh and every arrival over "
                             f"{DYN_SLOTS} slots, got {log_} after {row['slots']} slots")
        if not bool(state.active.sum() > 0):
            raise SystemExit(f"{label} leg: no agent active")
    a, b = legs["dynamic"], legs["dynamic_eager"]
    la, lb = _state_leaves(a["state"]), _state_leaves(b["state"])
    differ = [k for k in la if not torch.equal(la[k], lb[k])]
    if differ or a["eng"].topology_counters() != b["eng"].topology_counters():
        raise SystemExit(f"dynamic != dynamic_eager: tensors {differ}, topology "
                         f"{a['eng'].topology_counters()} vs {b['eng'].topology_counters()}")
    ratios = [x / y for x, y in zip(out["dynamic"]["window_rates"],
                                    out["dynamic_eager"]["window_rates"])]
    out["dynamic_over_dynamic_eager"] = dict(spread(ratios), windows=ratios)
    out["dynamic_equals_eager"] = dict(tensors=len(la), differ=0)
    log(f"[4d] dynamic == dynamic_eager bit for bit after {DYN_SLOTS} slots ({len(la)} tensors, "
        f"equal topology logs); captured/eager slots/s by window: "
        f"{' '.join(f'{r:.4g}' for r in ratios)}")
    return out, states


def _state_leaves(state) -> dict:
    """Every tensor of an engine state (a ``SimState`` or a
    ``ShardedSimState``: ``slab`` and ``ef`` included), the metrics by
    name, and the generator's state."""
    leaves = {}
    for name in state._fields:
        value = getattr(state, name)
        if name == "generator":
            leaves[name] = value.get_state()
        elif hasattr(value, "shape"):
            leaves[name] = value
        elif isinstance(value, dict):
            leaves.update({f"{name}.{k}": v for k, v in value.items()})
    return leaves


def capture_parity(label, engines) -> dict:
    """Phase 5: ``CAPTURE_PARITY_SLOTS`` slots of each engine leg through the
    captured chunk (``advance``) and through the eager slots, each from a
    fresh state of the same seed: every state tensor (Theta, the counters,
    the churn flags, the DP counts, the metrics, the generator's position)
    must be equal bit for bit. Returns the number of differing tensors by
    leg (all 0) and the slots applied."""
    import numpy as np
    import torch

    out = {}
    for key, eng in engines.items():
        zeros = np.zeros((eng.n, eng.p), dtype=np.float32)
        captured = _state_leaves(eng.advance(eng.init_state(zeros), CAPTURE_PARITY_SLOTS))
        eager = _state_leaves(eng._eager_slots(eng.init_state(zeros), CAPTURE_PARITY_SLOTS))
        differ = [k for k in captured if not torch.equal(captured[k], eager[k])]
        out[key] = dict(differ=len(differ), tensors=len(captured),
                        applied=int(captured["applied"].sum()),
                        graphs=sorted(getattr(eng._graphs, "graphs", {})))
        if differ:
            raise SystemExit(f"capture parity {label} {key}: captured != eager in {differ}")
    log(f"[5] captured == eager bit for bit, {CAPTURE_PARITY_SLOTS} slots at {label}: "
        + " ".join(f"{k}({v['tensors']} tensors, {v['applied']} applied)" for k, v in out.items()))
    return out


def small_engines(dev, n=512) -> dict:
    """The four engine legs at n = 512 (k-NN k = 8, p = 4, m = 3, quadratic,
    64 expected wakes a slot) with churn and stragglers; the private ones
    with clip 1 and 3 planned updates an agent, metrics on for dp_fused."""
    import dataclasses

    import numpy as np

    from repro_torch.core import AgentData, DPConfig, knn_graph, make_objective
    from repro_torch.sim import (AsyncEngine, CDUpdate, ChurnConfig, DPCDUpdate, Scenario,
                                 StragglerConfig)

    rng = np.random.default_rng(1)
    p, m = 4, 3
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)) / np.sqrt(p))
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse")
    dp_obj = dataclasses.replace(obj, clip=DP["clip"])
    scenario = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                        straggler=StragglerConfig(drop_prob=0.2))

    def engine(update, fused, metrics=None):
        return AsyncEngine(update, slot_wakes=64.0, scenario=scenario, seed=2, fused=fused,
                           metrics=metrics, device=dev)

    cfg = DPConfig(eps_bar=DP["eps_bar"], delta_bar=DP["delta_bar"])
    return {"fused": engine(CDUpdate(obj), "auto"), "unfused": engine(CDUpdate(obj), False),
            "dp_fused": engine(DPCDUpdate.plan(dp_obj, cfg, 3), "auto", metrics=True),
            "dp_unfused": engine(DPCDUpdate.plan(dp_obj, cfg, 3), False)}


def small_sharded_engines(dev, n=512) -> dict:
    """The sharded legs at n = 512 and S = 4 (the problem of
    :func:`small_engines`, RCM relabel, churn and stragglers): fused with
    metrics, unfused, and fused over a p2p bf16 wire with error feedback."""
    import numpy as np

    from repro_torch.core import AgentData, knn_graph, make_objective
    from repro_torch.sim import (CDUpdate, ChurnConfig, ExchangeSpec, Scenario,
                                 ShardedAsyncEngine, StragglerConfig)

    rng = np.random.default_rng(1)
    p, m = 4, 3
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)) / np.sqrt(p))
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse")
    scenario = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                        straggler=StragglerConfig(drop_prob=0.2))

    def engine(fused, exchange="auto", metrics=None):
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=4, relabel="rcm", slot_wakes=64.0,
                                  scenario=scenario, seed=2, fused=fused, metrics=metrics,
                                  exchange=ExchangeSpec.from_string(exchange), device=dev)

    return {"sharded_fused": engine("auto", metrics=True), "sharded_unfused": engine(False),
            "sharded_fused_bf16_ef": engine("auto", "p2p:bf16:ef")}


def sharded_parity(dev) -> dict:
    """Phase 5, the sharded engine on the card: (a) forced wakes at n = 96
    and S = 4 (RCM) against the single-device port on the card (unfused),
    fused and unfused, over the f32 wires (within ``SHARDED_PARITY_TOL``)
    and a compressed one (error in (0, ``SHARDED_WIRE_TOL``)); (b) the
    n = 512 fixed point at S = 2, 4 and 8 (float32, ``fused="auto"``: the
    kernel) within 1e-5 of ``solve_exact``."""
    import numpy as np

    from repro_torch.core import AgentData, knn_graph, make_objective
    from repro_torch.sim import AsyncEngine, CDUpdate, ExchangeSpec, ShardedAsyncEngine

    def quad(n, seed):
        rng = np.random.default_rng(seed)
        graph = knn_graph(rng.normal(size=(n, 8)), k=8)
        targets = rng.normal(size=(n, 4)) / 2.0
        X = rng.normal(size=(n, 3, 4)) / 2.0
        y = np.einsum("nmp,np->nm", X, targets)
        return make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, 3))), "quadratic",
                              mu=0.5, mix_mode="sparse")

    obj = quad(96, 0)
    masks = list(np.random.default_rng(7).random((4, 96)) < 0.15)

    def forced(eng):
        state = eng.init_state(np.zeros((96, 4)))
        for mask in masks:
            state = eng.step(state, mask)
        return eng.global_theta(state) if hasattr(eng, "num_shards") else \
            state.Theta.cpu().numpy()

    single = forced(AsyncEngine(CDUpdate(obj), slot_wakes=8.0, fused=False, device=dev))
    errs, bad = {}, {}
    for wire in ("all_gather", "p2p", "p2p:bf16", "p2p:bf16:ef"):
        outs = {}
        for fused in ("auto", False):
            eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, relabel="rcm",
                                     exchange=ExchangeSpec.from_string(wire), slot_wakes=8.0,
                                     fused=fused, device=dev)
            if eng.fused != (fused == "auto"):
                raise SystemExit("sharded parity: fused='auto' did not pick the kernel")
            outs[fused] = forced(eng)
        errs[f"{wire}_fused_vs_unfused"] = float(np.abs(outs["auto"] - outs[False]).max())
        for route in ("auto", False):
            key = f"{wire}_{'fused' if route else 'unfused'}_vs_single"
            errs[key] = float(np.abs(outs[route] - single).max())
            compressed = ":" in wire
            ok = (0.0 < errs[key] < SHARDED_WIRE_TOL) if compressed else (
                errs[key] <= SHARDED_PARITY_TOL)
            if not ok:
                bad[key] = errs[key]
        if errs[f"{wire}_fused_vs_unfused"] > SHARDED_PARITY_TOL:
            bad[f"{wire}_fused_vs_unfused"] = errs[f"{wire}_fused_vs_unfused"]
    big = quad(512, 0)
    star = big.solve_exact()
    for S, kw in ((2, {}), (4, dict(relabel="rcm", exchange=ExchangeSpec(method="p2p"))),
                  (8, dict(relabel="rcm", exchange=ExchangeSpec()))):
        eng = ShardedAsyncEngine(CDUpdate(big), num_shards=S, slot_wakes=128.0, seed=3,
                                 device=dev, **kw)
        res = eng.run(np.zeros((512, 4)), slots=700)
        key = f"fixed_point_S{S}_{eng.exchange_method}_fused{int(eng.fused)}"
        errs[key] = float(np.abs(res.Theta - star).max())
        if not errs[key] <= PARITY_TOL:
            bad[key] = errs[key]
    log("[5] sharded parity on the card: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (f32 wires <= {SHARDED_PARITY_TOL:.0e}, compressed in (0, {SHARDED_WIRE_TOL:.0e}),"
        f" fixed points <= {PARITY_TOL:.0e})")
    if bad:
        raise SystemExit(f"sharded parity failed: {bad}")
    return errs


def _knn512(n=512, seed=1):
    """The n = 512 problem of the small engines: k-NN k = 8, p = 4, m = 3,
    quadratic, mu = 0.5."""
    import numpy as np

    from repro_torch.core import AgentData, knn_graph, make_objective

    rng = np.random.default_rng(seed)
    p, m = 4, 3
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)) / np.sqrt(p))
    return make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                          mu=0.5, mix_mode="sparse")


# Arrivals of the n = 512 dynamic engines, scheduled past any run: the
# parity drives admit itself.
DYN_SMALL_IDS = tuple(range(500, 508))


def _dyn_small(obj, dev, sharded=False, **kw):
    """A dynamic engine at n = 512 with churn, stragglers, pending arrivals
    and a refresh that the parity fires itself."""
    from repro_torch.sim import (ArrivalConfig, AsyncEngine, CDUpdate, ChurnConfig, GraphUpdate,
                                 Scenario, ShardedAsyncEngine, StragglerConfig)

    scenario = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                        straggler=StragglerConfig(drop_prob=0.2),
                        arrival=ArrivalConfig(schedule=((10**6, DYN_SMALL_IDS),), attach_k=4,
                                              seed=3))
    cfg = dict(slot_wakes=64.0, seed=2, device=dev, scenario=scenario,
               graph_update=GraphUpdate(every=10**6, k=3, candidates=4, gamma=2.0, seed=1))
    cfg.update(kw)
    if sharded:
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=4, relabel="rcm", **cfg)
    return AsyncEngine(CDUpdate(obj), **cfg)


def _hub(csr, agent=1, count=60):
    """``csr`` with ``agent`` joined to ``count`` more agents (none pending):
    a swap that grows the slot capacity."""
    import numpy as np

    from repro_torch.core.graph import csr_from_coo

    others = np.array([j for j in range(csr.n) if j != agent and j not in DYN_SMALL_IDS][:count])
    return csr_from_coo(csr.n, np.concatenate([csr.row_ids(), np.full(len(others), agent)]),
                        np.concatenate([csr.indices, others]),
                        np.concatenate([csr.data, np.ones(len(others))]), symmetrize=True)


def _swap_parity(label, make, swaps, slots=CAPTURE_PARITY_SLOTS) -> dict:
    """Two engines from ``make()``, one advanced through the captured chunk
    and one through the eager slots, ``slots`` slots before and after each
    swap of ``swaps`` (``(name, fn(engine, state) -> state)``), applied to
    both: every state tensor and the topology logs must be equal after
    each. Returns per swap the recaptures it caused and the capacity."""
    import numpy as np
    import torch

    cap, eag = make(), make()
    zeros = np.zeros((cap.n, cap.p), dtype=np.float32)
    sc = cap.advance(cap.init_state(zeros), slots)
    se = eag._eager_slots(eag.init_state(zeros), slots)
    out = {}
    for name, fn in swaps:
        rec0, before = cap._graphs.recaptures, _capacity(cap)
        sc, se = fn(cap, sc), fn(eag, se)
        sc, se = cap.advance(sc, slots), eag._eager_slots(se, slots)
        a, b = _state_leaves(sc), _state_leaves(se)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ or cap.topology_counters() != eag.topology_counters():
            raise SystemExit(f"dynamic capture parity {label} {name}: captured != eager in "
                             f"{differ} or topology {cap.topology_counters()} vs "
                             f"{eag.topology_counters()}")
        out[name] = dict(recaptures=cap._graphs.recaptures - rec0, before=before,
                         after=_capacity(cap), tensors=len(a),
                         applied=int(sc.applied.sum()), topology=cap.topology_counters())
    return out


def dynamic_parity(dev) -> dict:
    """Phase 5, dynamic topology at n = 512 on the card: (a) a dynamic
    engine whose refresh never fires against the static unfused engine
    under forced wakes (einsum against ``sparse_mix``: within
    ``DYN_TOL``); (b) captured == eager bit for bit across each kind of
    swap — single-device: a refresh within the slot capacity (no
    recapture), a swap that grows it (one recapture), an admission;
    sharded at S = 4: a weight-only patch, a structural patch, and a
    repartition forced with ``drift_threshold=-10``; (c) forced runs with
    explicit refreshes and admissions on the card against the same run on
    the CPU (within ``DYN_TOL``, the same graphs)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.sim import AsyncEngine, CDUpdate, GraphUpdate

    obj = _knn512()
    n = obj.n
    rng = np.random.default_rng(4)
    masks = [rng.random(n) < 0.25 for _ in range(20)]
    Theta0 = rng.normal(size=(n, obj.p))
    errs, out = {}, {}

    def forced(eng, events=()):
        state = eng.init_state(Theta0)
        for k, mask in enumerate(masks):
            state = eng.step(state, mask)
            for at, fn in events:
                if k == at:
                    state = fn(eng, state)
        theta = eng.global_theta(state) if hasattr(eng, "num_shards") else \
            state.Theta.to("cpu").numpy()
        return eng, theta

    ops.reset_launch_counts()
    _, static = forced(AsyncEngine(CDUpdate(obj), slot_wakes=64.0, fused=False, device=dev))
    static_counts = ops.launch_counts()
    ops.reset_launch_counts()
    _, dynamic = forced(AsyncEngine(CDUpdate(obj), slot_wakes=64.0, device=dev,
                                    graph_update=GraphUpdate(every=10**9)))
    dyn_counts = ops.launch_counts()
    errs["dynamic_no_refresh_vs_static"] = float(np.abs(dynamic - static).max())
    if static_counts["sparse_mix"] != len(masks) or any(dyn_counts.values()):
        raise SystemExit(f"dynamic parity: static {static_counts}, dynamic {dyn_counts} launches")

    def refresh(e, s):
        return e._refresh_topology(s, 1)

    def admit(e, s):
        return e.admit(s, DYN_SMALL_IDS)

    def grow(e, s):
        e.set_topology(_hub(e._csr))
        return s

    def reweight(e, s):
        c = e._csr
        return e.set_topology(s, type(c)(indptr=c.indptr, indices=c.indices, data=c.data * 1.5))

    single = _swap_parity("n=512", lambda: _dyn_small(obj, dev),
                          [("refresh", refresh), ("grow", grow), ("admit", admit)])
    sharded = _swap_parity("n=512 S=4", lambda: _dyn_small(obj, dev, sharded=True,
                                                             drift_threshold=10.0),
                           [("weight_patch", reweight), ("structural_patch", refresh),
                            ("admit", admit)])
    sharded.update(_swap_parity("n=512 S=4 repartition",
                                lambda: _dyn_small(obj, dev, sharded=True, drift_threshold=-10.0),
                                [("repartition", refresh)]))
    fails = []
    if single["refresh"]["recaptures"] != 0 or single["refresh"]["before"] != \
            single["refresh"]["after"]:
        fails.append(f"a refresh within capacity recaptured or grew it: {single['refresh']}")
    if single["grow"]["recaptures"] != 1 or not single["grow"]["after"]["capacity"] > \
            single["grow"]["before"]["capacity"]:
        fails.append(f"a capacity-growing swap did not recapture once: {single['grow']}")
    tiers = sharded["repartition"]["topology"]
    if (sharded["weight_patch"]["topology"]["weight_patches"] != 1
            or sharded["structural_patch"]["topology"]["structural_patches"] != 1
            or tiers["repartitions"] != 1):
        fails.append(f"the sharded swaps did not take their tiers: {sharded}")
    for label, sh in (("single", False), ("sharded", True)):
        events = [(6, refresh), (12, admit)]
        card_eng, card = forced(_dyn_small(obj, dev, sharded=sh), events)
        cpu_eng, cpu = forced(_dyn_small(obj, "cpu", sharded=sh), events)
        errs[f"{label}_card_vs_cpu"] = float(np.abs(card - cpu).max())
        a, b = card_eng.topology_counters(), cpu_eng.topology_counters()
        # last_drift is a ratio of the refreshed weights, exp(-d2 / gamma) of
        # float32 models whose last bits differ between the devices.
        drift = abs(a.pop("last_drift") - b.pop("last_drift"))
        if not (np.array_equal(card_eng._csr.indices, cpu_eng._csr.indices) and a == b
                and drift <= 1e-6):
            fails.append(f"{label}: the card's graph or log differs from the CPU's")
    fails += [f"{k}={v:.3e} above {DYN_TOL}" for k, v in errs.items() if not v <= DYN_TOL]
    out = dict(errors=errs, single=single, sharded=sharded)
    log("[5] dynamic parity at n=512: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" (tol {DYN_TOL:.0e}); captured == eager across swaps: "
        + " ".join(f"{kind}_{k}(recaptures {v['recaptures']}, {v['before']} -> {v['after']})"
                   for kind, swaps in (("single", single), ("sharded", sharded))
                   for k, v in swaps.items()))
    if fails:
        raise SystemExit(f"dynamic parity failed: {fails}")
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
    """Phase 7: Fig. 1, Table 1, Figs. 2-4 and the ablations through the
    port's runners on the card, each beside the reference's CPU row. Launch
    counts are reset before and read after: the benches run none of the
    kernels. Fails unless CD beats ADMM per message, CD beats the local
    models (accuracy, RMSE), every private RMSE is finite, and the gates of
    :func:`privacy_benches` hold."""
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
    private = [table1[k] for k in table1 if k.startswith("rmse_eps_")]
    fails = [msg for ok, msg in (
        (fig1["cd_beats_admm_per_message"], "CD does not beat ADMM per message"),
        (fig1["acc_cd"] > fig1["acc_local"], "CD accuracy not above the local models'"),
        (table1["rmse_cd"] < table1["rmse_local"], "CD RMSE not below the local models'"),
        (len(private) == 3 and all(math.isfinite(r) for r in private),
         "a private RMSE is not finite"),
    ) if not ok]
    out = {"fig1_cd_vs_admm": fig1, "table1_movielens": table1}
    more, more_fails = privacy_benches(dev)
    out.update(more)
    fails += more_fails
    counts = ops.launch_counts()
    if any(counts.values()):
        fails.append(f"the benches launched kernels: {counts}")
    if fails:
        raise SystemExit(f"paper benches: {'; '.join(fails)}")
    return out


def privacy_benches(dev):
    """Figs. 2-4 and the ablations at the reference runners' fast size on the
    card. Returns their rows and the failed gates: the deterministic fields
    equal ``REFERENCE_FAST`` within ``BENCH_ACC_TOL``; non-private CD beats
    the local models in every Fig. 2c row; the warm start's private run ends
    below the constant init's (Fig. 2b); personalized beats global; every
    private accuracy is finite and in [0, 1]."""
    from repro_torch.bench import ablations, privacy_utility

    fig = privacy_utility.run(fast=True, verbose=False, device=dev)
    ab = ablations.run(fast=True, verbose=False, device=dev)
    last, f3, f4, f2 = fig["fig2c"][-1], fig["fig3"], fig["fig4"], fig["fig2ab"]
    pers = ab["personalization"]
    det = {"fig2c_acc_local": last["acc_local"], "fig2c_acc_nonprivate": last["acc_nonprivate"],
           "fig3_acc_local_small_m": f3["acc_local_small_m"],
           "fig3_acc_local_large_m": f3["acc_local_large_m"],
           "fig4_acc_local_clean": f4["acc_local_clean"],
           "acc_personalized": pers["acc_personalized"], "acc_global": pers["acc_global"]}
    private = [v for row in fig["fig2c"] for k, v in row.items() if k.startswith("acc_eps_")]
    private += [f3["acc_priv_small_m"], f3["acc_priv_large_m"], f2["acc_const"], f2["acc_warm"]]
    private += [r["acc_local_dp"] for r in f4["rows"]]
    private += [v for k, v in {**ab["noise_allocation"], **ab["mechanism"]}.items()
                if k != "prop2_better"]
    fig2 = dict(derived=fig["derived"], elapsed_s=fig["elapsed_s"],
                const_init_obj=f2["const_init_obj"], warm_start_obj=f2["warm_start_obj"],
                const_final_obj=f2["const_objective"][-1],
                warm_final_obj=f2["warm_objective"][-1], acc_const=f2["acc_const"],
                acc_warm=f2["acc_warm"])
    log(f"[7] fig2_privacy_utility on the card: {fmt(fig2)}; fig2c {fig['fig2c']}; "
        f"fig3 {f3}; fig4 {f4}; reference CPU row: {REFERENCE_ROWS['fig2_privacy_utility']}")
    fig2.update(fig2c=fig["fig2c"], fig3=f3, fig4=f4)
    abl = dict(derived=ab["derived"], elapsed_s=ab["elapsed_s"], **ab["noise_allocation"],
               **ab["mechanism"], **pers)
    log(f"[7] ablations on the card: {fmt(abl)}; reference CPU row: {REFERENCE_ROWS['ablations']}")
    errs = {k: abs(v - REFERENCE_FAST[k]) for k, v in det.items()}
    log(f"[7] deterministic fields against the reference's CPU values (tol {BENCH_ACC_TOL}): "
        + " ".join(f"{k}={det[k]:.6g}(ref {REFERENCE_FAST[k]:.6g})" for k in det))
    fails = [msg for ok, msg in (
        (max(errs.values()) <= BENCH_ACC_TOL, f"deterministic fields off the reference: {errs}"),
        (all(r["acc_nonprivate"] > r["acc_local"] for r in fig["fig2c"]),
         "non-private CD not above the local models in a Fig. 2c row"),
        (f2["warm_objective"][-1] < f2["const_objective"][-1],
         "the warm start's private run does not end below the constant init's"),
        (pers["acc_personalized"] > pers["acc_global"], "personalized does not beat global"),
        (all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in private),
         "a private accuracy is not finite or not in [0, 1]"),
    ) if not ok]
    return {"fig2_privacy_utility": fig2, "ablations": abl}, fails


def dynamic_bench() -> dict:
    """Phase 7, ``repro_torch.bench.dynamic_topology`` at its default size
    (n = 200,000 RGG of degree about 10, S = 8, degree blocks, RCM, one
    refresh): host-side partition machinery, as in the reference. Fails
    unless the halo parity held (``dyntopo_halo_parity`` == 1)."""
    from repro_torch.bench import dynamic_topology

    rows = {name: v for name, v, _ in dynamic_topology.run(verbose=False)}
    log("[7] dynamic_topology (n=200000, S=8; host seconds): " + fmt(rows)
        + f"; patch_speedup={rows['dyntopo_patch_speedup']:.4g}")
    if rows["dyntopo_halo_parity"] != 1.0:
        raise SystemExit(f"dynamic_topology bench: halo parity {rows['dyntopo_halo_parity']}")
    return rows


# Phase 4c: checkpoints and serving on rgg500k_p100 (see PERF.md, "Cells").
CKPT_LEGS = ("fused", "dp_fused", "unfused", "sharded_fused_bf16_ef")
CKPT_KERNEL = {"fused": "fused_row_update", "dp_fused": "fused_row_update",
               "unfused": "sparse_mix", "sharded_fused_bf16_ef": "fused_row_update"}
CKPT_RESUME_SLOTS = CAPTURE_PARITY_SLOTS  # both engines advance these after the restore
CKPT_KEEP = 2  # entries of a leg on disk at once, at most
ELASTIC_SHARDS = 4  # the S = 8 entry restores into this many shards
SERVE = dict(batch=1024, cold_every=10, cold_neighbors=4, snapshot_every=16, window=800,
             turns=3, check_every=25)


def _entry_bytes(entry) -> int:
    import os

    return sum(os.path.getsize(os.path.join(entry, f)) for f in os.listdir(entry))


def checkpoint_legs(engines, states, make, launches: dict) -> dict:
    """Phase 4c, checkpoints: for each leg of ``CKPT_LEGS`` the phase-4
    state (its captured live buffers) is saved into a rotation under
    ``build/ckpt`` (``keep_last=CKPT_KEEP``), restored into a fresh engine
    of the same config (``make[leg]()``), and both advance
    ``CKPT_RESUME_SLOTS`` captured slots: every state tensor and the
    generator's state must be ``torch.equal``. Launch counts are reset
    before each leg and read after it: the leg's kernel must have run
    once a slot on both engines. Prints the seconds to save and restore,
    the bytes on disk and the save MB/s; the sharded leg's entry is also
    restored at ``ELASTIC_SHARDS`` shards (:func:`elastic_restore`). Each
    leg's entry is removed after it, the directory after the phase. The
    legs' states are their engines' live buffers, advanced in place.
    Returns the rows."""
    import shutil

    import torch

    from repro_torch.checkpoint import restore, save_engine_checkpoint
    from repro_torch.kernels import ops

    root = ROOT / "build" / "ckpt"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    log(f"[4c] free disk under build/: {free / 1e9:.3f} GB; entries kept per leg <= {CKPT_KEEP}")
    out, m = {"free_disk_bytes": free}, CKPT_RESUME_SLOTS
    try:
        for key in CKPT_LEGS:
            eng, state = engines[key], states[key]
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry = save_engine_checkpoint(eng, state, str(root / key), keep_last=CKPT_KEEP)
            save_s = time.perf_counter() - t0
            nbytes = _entry_bytes(entry)
            fresh = make[key]()
            t0 = time.perf_counter()
            restored, step = restore(fresh, str(root / key))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            elastic = (elastic_restore(eng, state, str(root / key), make)
                       if key == "sharded_fused_bf16_ef" else None)
            want = _state_leaves(eng.advance(state, m))
            got = _state_leaves(fresh.advance(restored, m))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            differ = [k for k in want if not torch.equal(want[k], got[k])]
            row = dict(step=step, save_s=save_s, restore_s=restore_s, bytes=nbytes,
                       save_mb_per_s=nbytes / save_s / 1e6, resumed_slots=m, tensors=len(want),
                       launches=counts)
            log(f"[4c] rgg500k_p100 {key}: saved at slot {step}, restored into a fresh engine, "
                f"both advanced {m} captured slots: {fmt({k: v for k, v in row.items() if k != 'launches'})} "
                f"launches={counts}")
            if differ:
                raise SystemExit(f"checkpoint {key}: resumed != uninterrupted in {differ}")
            if counts[CKPT_KERNEL[key]] != 2 * m:
                raise SystemExit(f"checkpoint {key}: {CKPT_KERNEL[key]} launched "
                                 f"{counts[CKPT_KERNEL[key]]} times, not {2 * m}")
            if elastic is not None:
                row["elastic"] = elastic
            out[key] = row
            del fresh, restored, want, got
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(root / key)
    finally:
        shutil.rmtree(root)
    return out


def elastic_restore(eng, state, path, make) -> dict:
    """The S = 8 entry at ``path`` restored into an engine of the same
    config at ``ELASTIC_SHARDS`` shards (its own RCM cut, built here):
    the seconds, the models (each agent's row equal, on the card), and the
    run totals, which must be kept (collapsed into shard 0)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import restore

    t0 = time.perf_counter()
    small = make["elastic"]()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, step = restore(small, path)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    totals = {k: (int(getattr(state, k).sum()) if k != "messages" else
                  float(getattr(state, k).double().sum())) for k in ("applied", "dropped",
                                                                      "messages")}
    got = {k: (int(getattr(restored, k).sum()) if k != "messages" else
               float(getattr(restored, k).double().sum())) for k in totals}
    same_rows = bool(torch.equal(small._agent_theta(restored), eng._agent_theta(state)))
    # ``messages`` is a float32 counter: its collapsed total is the float32
    # nearest the saved shards' exact sum (above 2^24 a float32 holds even
    # counts only), as in the reference.
    kept = dict(totals, messages=float(np.float32(totals["messages"])))
    row = dict(shards=f"{eng.num_shards}->{small.num_shards}", restore_s=secs,
               engine_build_s=build_s, step=step, rows_equal=same_rows, totals=got,
               ptr=int(restored.ptr[0]))
    log(f"[4c] elastic restore S={eng.num_shards} -> S={small.num_shards}: {fmt(row)}; "
        f"saved totals {totals} (messages as float32: {kept['messages']:.1f})")
    if got != kept or not same_rows or row["ptr"] != eng._ptr_of(state):
        raise SystemExit(f"elastic restore: totals {got} != {totals}, rows equal {same_rows}")
    return row


def _serve_batches(n, p, rng):
    """Request batches of ``SERVE["batch"]`` ids, every ``cold_every``-th a
    cold id (n + j, not yet in the swarm) with ``cold_neighbors`` warm
    attachment neighbours; features from ``rng``."""
    import numpy as np

    B = SERVE["batch"]
    cold = n + np.arange(B // SERVE["cold_every"])
    neighbors = {int(c): tuple(int(j) for j in rng.choice(n, SERVE["cold_neighbors"],
                                                          replace=False)) for c in cold}
    batches = []
    for _ in range(8):
        ids = rng.integers(0, n, B)
        ids[:: SERVE["cold_every"]][: cold.size] = cold
        batches.append((ids, rng.normal(size=(B, p)).astype(np.float32)))
    return batches, neighbors


def _recompute(snap, ids, X, neighbors):
    """The scores of ``ids`` from the pinned snapshot's tiles, recomputed in
    plain PyTorch (the Eq. 16 uniform average for cold ids), and the warm
    rows."""
    import numpy as np
    import torch

    n = snap.tiles.shape[1]
    K = max(len(v) for v in neighbors.values())
    gids = np.zeros((ids.size, K), np.int64)
    w = np.zeros((ids.size, K), np.float32)
    for b, i in enumerate(ids.tolist()):
        nb = (i,) if i < n else neighbors[i]
        gids[b, : len(nb)] = nb
        w[b, : len(nb)] = 1.0 / len(nb)
    dev = snap.tiles.device
    rows = snap.tiles[0][torch.as_tensor(gids, device=dev)]
    theta = (torch.as_tensor(w, device=dev).unsqueeze(-1) * rows).sum(dim=1)
    y = (theta * torch.as_tensor(X, device=dev)).sum(dim=-1)
    return y.cpu().numpy(), theta


def live_serving(eng, state) -> dict:
    """Phase 4c, live serving on the ``fused`` leg: windows of
    ``SERVE["window"]`` slots through ``run`` (the captured chunk), with
    serving off and on in turns. On: ``run(snapshot_every=16,
    serve=handle)`` in a trainer thread while this thread issues
    ``predict`` batches of 1024 ids (a tenth cold, with 4 neighbours);
    every ``check_every``-th answer is held against a recomputation from
    its pinned snapshot (equal, and warm rows equal to the snapshot's).
    Returns the slot rates off and on, p50/p99 ms, predictions/s, device
    us a publish (CUDA events around each copy in the trainer's stream) and
    the copy alone (``time_ms`` of the clone, beside its bound), the
    largest version lag and the state reached."""
    import threading

    import numpy as np
    import torch

    from repro_torch.serve import ServeHandle

    handle = ServeHandle.for_engine(eng)
    batches, neighbors = _serve_batches(eng.n, eng.p, np.random.default_rng(5))
    W = SERVE["window"]
    rates, lat, checked = {"off": [], "on": []}, [], 0
    for _ in range(SERVE["turns"]):
        for mode in ("off", "on"):
            torch.cuda.synchronize()
            if mode == "off":
                t0 = time.perf_counter()
                state = eng.run(None, W, state=state).state
                rates[mode].append(W / (time.perf_counter() - t0))
                continue
            box, done = {}, threading.Event()

            def train():
                try:
                    box["result"] = eng.run(None, W, state=state, serve=handle,
                                            snapshot_every=SERVE["snapshot_every"])
                finally:
                    done.set()

            trainer = threading.Thread(target=train, name="trainer")
            first = eng._ptr_of(state)  # the version this window's run publishes first
            t0 = time.perf_counter()
            trainer.start()
            i = 0
            while not done.is_set():
                if not handle.published or handle.version < first:
                    time.sleep(1e-4)  # leave the GIL to the trainer until its first publication
                    continue
                ids, X = batches[i % len(batches)]
                snap = handle.snapshot() if i % SERVE["check_every"] == 0 else None
                t1 = time.perf_counter()
                res = handle.predict(ids, X, neighbors=neighbors, at=snap)
                lat.append(time.perf_counter() - t1)
                if snap is not None:
                    want, theta = _recompute(snap, ids, X, neighbors)
                    warm = ids < eng.n
                    dev = snap.tiles.device
                    rows = snap.tiles[0][torch.as_tensor(ids[warm], device=dev)]
                    if not (np.array_equal(res.values, want) and res.version == snap.version
                            and torch.equal(theta[torch.as_tensor(warm, device=dev)], rows)):
                        raise SystemExit(f"live serving: an answer of version {snap.version} "
                                         "differs from its snapshot's recomputation")
                    checked += 1
                i += 1
            trainer.join()
            secs = time.perf_counter() - t0
            if "result" not in box:
                raise SystemExit("live serving: the trainer thread failed")
            state = box["result"].state
            rates[mode].append(W / secs)
    c = handle.counters()
    lat = np.asarray(lat)
    # The publication's copy alone, as time_ms times a kernel: the (1, n, p)
    # clone, against the bound of its bytes (each read once, written once).
    theta = state.Theta.unsqueeze(0)
    clone_ms = time_ms(lambda: theta.clone())
    clone_bound_ms = 2 * theta.numel() * theta.element_size() / HBM_BYTES_PER_S * 1e3
    out = dict(slots_per_s_off=rates["off"], slots_per_s_on=rates["on"],
               clone_ms=clone_ms, clone_bound_ms=clone_bound_ms,
               on_over_off=[a / b for a, b in zip(rates["on"], rates["off"])],
               requests=int(lat.size), checked=checked,
               p50_ms=float(np.percentile(lat, 50) * 1e3),
               p99_ms=float(np.percentile(lat, 99) * 1e3),
               predictions_per_s=float(SERVE["batch"] * lat.size / lat.sum()),
               publish_device_us=1e6 * handle.publish_device_seconds()
               / c["serve_snapshots_published"],
               publish_host_us=1e6 * c["serve_publish_s_total"] / c["serve_snapshots_published"],
               snapshots=c["serve_snapshots_published"], version_lag_max=c["serve_version_lag_max"],
               cold_rows=c["serve_cold_starts"], version=handle.version)
    log(f"[4c] rgg500k_p100 fused live serving ({SERVE['window']}-slot windows, off and on in "
        f"turns, snapshot_every={SERVE['snapshot_every']}, batch {SERVE['batch']}): "
        f"{fmt({k: v for k, v in out.items() if not isinstance(v, list)})} slots/s off "
        f"{[round(r, 2) for r in rates['off']]} on {[round(r, 2) for r in rates['on']]}")
    if checked < SERVE["turns"] or out["version"] != eng._ptr_of(state):
        raise SystemExit(f"live serving: {checked} answers checked, version {out['version']}")
    return out, state


def serve_cli() -> dict:
    """``python -m repro_torch.serve --live`` once at its default size on
    the card, in a subprocess: its JSON summary, parsed."""
    import os

    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.serve", "--live"],
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    secs = time.perf_counter() - t0
    if run.returncode != 0:
        raise SystemExit(f"python -m repro_torch.serve --live failed: {run.stderr[-2000:]}")
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    keep = ("mode", "n", "p", "version", "slots", "requests", "predictions_per_s", "p50_ms",
            "p99_ms", "publish_device_s_total", "serve_publish_s_total", "serve_version_lag_max",
            "device")
    row = {k: summary[k] for k in keep}
    log(f"[4c] python -m repro_torch.serve --live (default size, {secs:.2f} s with start-up): "
        f"{fmt(row)}")
    if summary["version"] != summary["slots"] or summary["device"] != "cuda":
        raise SystemExit(f"serve CLI: {summary}")
    return row


def dynamic_resume(dev) -> dict:
    """Phase 5: a dynamic run at n = 512 (churn, stragglers, a refresh every
    20 slots, 8 arrivals at slot 30) cut at 20 (the refresh boundary), 25
    and 40 (after the admission), saved, restored into a fresh engine and
    run to 50: every state tensor, the generator, the graph and the
    topology log equal the uninterrupted run's, single-device and sharded
    (S = 4). Then the last entry served on the card and on the CPU:
    predictions within ``PARITY_TOL``."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import restore, save_engine_checkpoint
    from repro_torch.serve import serve_from_checkpoint
    from repro_torch.sim import ArrivalConfig, ChurnConfig, GraphUpdate, Scenario, StragglerConfig

    obj = _knn512()
    scen = Scenario(churn=ChurnConfig(leave_prob=0.05, rejoin_prob=0.3),
                    straggler=StragglerConfig(drop_prob=0.2),
                    arrival=ArrivalConfig(schedule=((30, DYN_SMALL_IDS),), attach_k=4, seed=3))
    gu = GraphUpdate(every=20, k=3, candidates=4, gamma=2.0, seed=1)
    zeros = np.zeros((obj.n, obj.p), dtype=np.float32)
    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as td:
        for label, sharded in (("single", False), ("sharded", True)):
            def make():
                return _dyn_small(obj, dev, sharded=sharded, scenario=scen, graph_update=gu)

            ref = make()
            want = _state_leaves(ref.run(zeros, 50).state)
            for cut in (20, 25, 40):
                eng = make()
                half = eng.run(zeros, cut)
                ck = f"{td}/{label}{cut}"
                save_engine_checkpoint(eng, half.state, ck)
                res = make()
                st, _ = restore(res, ck)
                got = _state_leaves(res.run(None, 50 - cut, state=st).state)
                differ = [k for k in want if not torch.equal(want[k], got[k])]
                if differ or res.topology_counters() != ref.topology_counters() or \
                        res._csr.digest() != ref._csr.digest():
                    raise SystemExit(f"dynamic resume {label} cut {cut}: differs in {differ}")
            out[label] = dict(cuts=[20, 25, 40], tensors=len(want),
                              topology=ref.topology_counters())
            card = serve_from_checkpoint(ck, device=dev)
            cpu = serve_from_checkpoint(ck, device="cpu")
            rng = np.random.default_rng(9)
            ids = rng.integers(0, obj.n, 256)
            ids[:8] = DYN_SMALL_IDS  # admitted by slot 30: warm
            X = rng.normal(size=(256, obj.p))
            err = float(np.abs(card.predict(ids, X).values - cpu.predict(ids, X).values).max())
            out[label]["served_card_vs_cpu"] = err
            if not err <= PARITY_TOL:
                raise SystemExit(f"dynamic resume {label}: served card vs CPU {err}")
    log("[5] dynamic resume at n=512, cut at 20 (refresh boundary), 25, 40 (after the "
        "admission): resumed == uninterrupted bit for bit, "
        + " ".join(f"{k}({v['tensors']} tensors, served card vs CPU "
                   f"{v['served_card_vs_cpu']:.3e})" for k, v in out.items()))
    return out


def checkpoint_benches(dev) -> dict:
    """Phase 7: ``repro_torch.bench.checkpoint`` at its reference default
    (n = 200,000, S = 8; the entry under ``build/``) and
    ``repro_torch.bench.serving`` (n = 100,000, S = 8, batch 1024), each
    row printed beside the reference's CPU row in ``BENCH_summary.json``."""
    from repro_torch.bench import checkpoint, serving

    reference = json.loads((ROOT / "BENCH_summary.json").read_text())
    out = {}
    for name, rows in (("checkpoint", checkpoint.run(device=dev, workdir=ROOT / "build",
                                                      verbose=False)),
                       ("serving", serving.run(device=dev, verbose=False))):
        out[name] = {row: v for row, v, _ in rows}
        log(f"[7] {name} bench on the card: "
            + " ".join(f"{row}={v:.6g} ({note}; reference CPU "
                       f"{reference[row]['us_per_call'] if row in reference else 'none'}"
                       f"{', ' + reference[row]['derived'] if row in reference else ''})"
                       for row, v, note in rows))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import DPConfig
    from repro_torch.kernels import _build
    from repro_torch.sim import (AsyncEngine, CDUpdate, ChurnConfig, DPCDUpdate, ExchangeSpec,
                                 Scenario, ShardedAsyncEngine, partition_graph)

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

    def engine(update, fused, metrics=None):
        return AsyncEngine(update, slot_wakes=c["slot_wakes"], scenario=scenario,
                           seed=c["seed"], fused=fused, metrics=metrics, device=dev)

    engines = {"fused": engine(CDUpdate(obj), "auto"), "unfused": engine(CDUpdate(obj), False),
               "dp_fused": engine(DPCDUpdate.plan(dp_obj, dp_cfg, planned_Ti), "auto",
                                  metrics=True),
               "dp_unfused": engine(DPCDUpdate.plan(dp_obj, dp_cfg, planned_Ti), False)}
    # The sharded legs share one partition (built once, timed).
    t_part = time.perf_counter()
    part = partition_graph(obj.graph, SHARDED["num_shards"], mode=SHARDED["partition_mode"],
                           relabel=SHARDED["relabel"])
    part_s = time.perf_counter() - t_part

    def sharded(fused, exchange, metrics=None):
        eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=SHARDED["num_shards"],
                                 partition=part, exchange=exchange,
                                 slot_wakes=c["slot_wakes"], scenario=scenario, seed=c["seed"],
                                 fused=fused, metrics=metrics, device=dev)
        eng.partition_seconds = part_s
        return eng

    bf16_ef = ExchangeSpec(method="p2p", dtype="bf16", error_feedback=True)
    engines.update(
        sharded_fused=sharded("auto", ExchangeSpec(), metrics=True),
        sharded_unfused=sharded(False, ExchangeSpec()),
        sharded_fused_bf16_ef=sharded("auto", bf16_ef))
    torch.cuda.synchronize()
    log(f"[4] set-up rgg500k_p100: n={obj.n} p={obj.p} m={c['m']} "
        f"max_degree={obj.graph.max_degree()} mean_degree={obj.graph.nnz / obj.n:.3f} "
        f"batch={engines['fused'].batch_size} dense n={dense_obj.n} kind={dense_obj.mix.kind} "
        f"private: clip={DP['clip']} eps_bar={DP['eps_bar']} delta_bar={DP['delta_bar']:.6g} "
        f"planned_Ti={planned_Ti} in {time.perf_counter() - t0:.1f} s")
    sh = engines["sharded_fused"]
    log(f"[4] set-up sharded rgg500k_p100: S={sh.num_shards} relabel={SHARDED['relabel']} "
        f"mode={SHARDED['partition_mode']} partition_s={part_s:.3f} "
        f"{fmt(sharded_layout(sh))} bf16_ef: {fmt(sharded_layout(engines['sharded_fused_bf16_ef']))}")
    if not (engines["fused"].fused and engines["dp_fused"].fused
            and not engines["dp_unfused"].fused and sh.fused
            and engines["sharded_fused_bf16_ef"].fused
            and not engines["sharded_unfused"].fused) or dense_obj.mix.kind != "dense":
        raise SystemExit("set-up: fused='auto' did not pick the kernel, or no dense path")

    # [3] kernel checks (these launches are not the main path's)
    results: dict = {}
    kernel_checks(obj, engines["fused"], dense_obj, results)
    sharded_kernel_check(obj, engines["sharded_fused"], results)
    ssm_chunk_checks(dev, results)

    # [4] the main path: each path's counts are reset before it and read after
    main_path, states, launches = drive_main_path(engines, dense_obj, obj, dev)

    # [4p] where a slot's device time goes, traced after every timed leg
    # (an attached tracer slows what runs after it): the captured chunk and
    # the eager slots of each engine leg.
    for key in ENGINE_LEGS:
        eng = engines[key]
        for label, run in ((key, eng.advance), (f"{key}_eager", eng._eager_slots)):
            states[label], main_path[label]["trace"] = profile_slots(
                f"rgg500k_p100 {label}", run, states[label], PROFILE_SLOTS,
                _build.build_dir() / "traces", main_path[label]["ms_per_slot"])
    for key, o in (("dense", dense_obj), ("sparse_sync", obj)):
        main_path[key]["trace"] = profile_rounds(
            f"{key} n={o.n}", o, PROFILE_SLOTS, _build.build_dir() / "traces",
            main_path[key]["ms_per_round"], dev)
    budget_check(engines, states, main_path)
    sharded_metrics_check(engines, states, main_path)
    main_path["dp_clip_noise"] = dp_clip_noise_leg(dev, launches)

    # [4c] checkpoints and serving: four legs saved, restored into fresh
    # engines and resumed (counts reset before each leg and read after),
    # the S = 8 -> 4 elastic restore, live serving on the fused leg, and
    # the serving CLI
    ckpt_make = {
        "fused": lambda: engine(CDUpdate(obj), "auto"),
        "dp_fused": lambda: engine(DPCDUpdate.plan(dp_obj, dp_cfg, planned_Ti), "auto",
                                   metrics=True),
        "unfused": lambda: engine(CDUpdate(obj), False),
        "sharded_fused_bf16_ef": lambda: sharded("auto", bf16_ef),
        "elastic": lambda: ShardedAsyncEngine(
            CDUpdate(obj), num_shards=ELASTIC_SHARDS, exchange=bf16_ef,
            partition=partition_graph(obj.graph, ELASTIC_SHARDS, mode=SHARDED["partition_mode"],
                                      relabel=SHARDED["relabel"]),
            slot_wakes=c["slot_wakes"], scenario=scenario, seed=c["seed"], fused="auto",
            device=dev),
    }
    ckpt = checkpoint_legs(engines, states, ckpt_make, launches)
    ckpt["live_serving"], states["fused"] = live_serving(engines["fused"], states["fused"])
    ckpt["serve_cli"] = serve_cli()
    main_path["checkpoint_serving"] = ckpt
    del ckpt_make
    gc.collect()
    torch.cuda.empty_cache()

    # [4d] dynamic topology: a refresh and two admissions in 800 slots of
    # each dynamic leg, then 16 traced slots of each
    dyn_engines = dynamic_engines(obj, scenario.churn, dev)
    dyn, dyn_states = dynamic_legs(dyn_engines, launches)
    for label in DYN_LEGS:
        eng = dyn_engines[label]
        run = eng._eager_slots if label.endswith("_eager") else eng.advance
        dyn_states[label], dyn[label]["trace"] = profile_slots(
            f"rgg500k_p100 {label}", run, dyn_states[label], PROFILE_SLOTS,
            _build.build_dir() / "traces", dyn[label]["ms_per_slot"])
    main_path["dynamic"] = dyn
    del dyn_engines, dyn_states
    gc.collect()  # the instrumented engines hold reference cycles
    torch.cuda.empty_cache()
    missing = [k for k in _build.KERNELS if k not in PATH_KERNEL.values()]
    if missing:
        raise SystemExit(f"no path of phase 4 launches {missing}")

    # [5] parity on the card: the captured chunk against the eager slots (at
    # rgg500k_p100 the fresh states are copied into the engines' live
    # buffers, so this comes after every use of phase 4's states), then the
    # routes against the CPU
    capture = {"rgg500k_p100": capture_parity("rgg500k_p100", engines),
               "n512": capture_parity("n=512 churn+stragglers", small_engines(dev)),
               "n512_S4": capture_parity("n=512 S=4 churn+stragglers",
                                         small_sharded_engines(dev))}
    main_path["capture_parity"] = capture
    parity(dev)
    main_path["sharded_parity"] = sharded_parity(dev)
    main_path["dynamic_parity"] = dynamic_parity(dev)
    main_path["dynamic_resume"] = dynamic_resume(dev)

    # [6] zamba2-1.2b serving: the prefill's counts are reset before each
    # prefill and read after it
    serve = zamba2_serve(dev, launches)

    # [7] the paper benches on the card, and the dynamic-topology bench
    benches = paper_benches(dev)
    benches["dynamic_topology"] = dynamic_bench()
    benches.update(checkpoint_benches(dev))

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
                    "fused_row_update_sharded": results["fused_row_update_sharded"],
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

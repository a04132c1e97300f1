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
   ``dp_clip_noise`` at the (256, 4096) float32 shape of
   ``benchmarks/bench_kernels.py`` and at (200, 1000) in bfloat16;
4. the main path at a deployment size, config ``rgg500k_p100``: the
   batched engine on 500k agents (random geometric graph, average degree
   16, p = 100, m = 8, quadratic loss, mu = 0.5, 4096 expected wakes per
   slot, churn on), fused (``fused="auto"``, the fused kernel) and
   unfused (neighbour sums through ``sparse_mix``); the private Eq. 6
   engine on the same problem with the per-point clip 1.0 (``DPCDUpdate``,
   eps_bar = 0.5, delta_bar = exp(-5), Laplace, each agent planning for
   the expected wakes of the whole leg, so agents that wake more often stop
   at their budget), fused and unfused; and the dense path (synchronous
   rounds at n = 2047 through ``graph_mix``). After a warm-up the five legs
   take turns over 7 timed windows of 200 slots (rounds) each; each rate is
   the median window's, printed with the slowest and fastest, and the
   fused/unfused ratio is taken window by window. Launch counts are reset
   before and read after every window, and each leg must launch its own
   kernel in every window. Then 16 slots of each engine leg run under
   torch.profiler (traces in ``build/repro_torch/``): device time per slot
   by kernel, and the device idle share. Last, the ``dp_clip_noise`` leg:
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
6. a JSON line of every ported kernel (launches, error, times, bound),
   then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
TOL = {"sparse_mix": 1e-5, "fused_row_update": 2e-5, "graph_mix": 1e-5, "dp_clip_noise": 1e-5}
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
        timing = dict(
            R=R, K=K,
            ms=time_ms(lambda: ops.sparse_mix(idx, w, theta)),
            plain_ms=time_ms(lambda: ref.sparse_mix_ref(idx, w, theta)),
            library_ms=time_ms(lambda: torch.sparse.mm(csr, theta)),
            library_err=lib_err,
            **bound(nbytes, 2.0 * int(real.sum()) * p),
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
    timing = dict(
        B=B, K=K, valid=nvalid,
        ms=time_ms(lambda: ops.fused_row_update(*args, slab_k, n)),
        plain_ms=time_ms(lambda: ref.fused_row_update_ref(*args, slab_p, n)),
        library_ms=None, **bound(nbytes, flops),
    )
    check_kernel("fused_row_update", got, want, results, **timing)

    # graph_mix: dense A @ Theta at n = 2047, p = 100 (MixOp.all, dense).
    A = dense_obj.mix.table("W", dev, f32)
    th = torch.randn((dense_obj.n, p), generator=gen, device=dev, dtype=f32)
    got = ops.graph_mix(A, th)
    want = ref.graph_mix_ref(A, th)
    dn = dense_obj.n
    timing = dict(
        n=dn, p=p,
        ms=time_ms(lambda: ops.graph_mix(A, th)),
        plain_ms=time_ms(lambda: ref.graph_mix_ref(A, th)),
        library_ms=time_ms(lambda: torch.matmul(A, th)),
        **bound((dn * dn + 2 * dn * p) * 4, 2.0 * dn * dn * p),
    )
    check_kernel("graph_mix", got, want, results, **timing)

    # dp_clip_noise: the (256, 4096) float32 shape of bench_kernels.py, then
    # one bfloat16 shape of tests/test_kernels.py. No single PyTorch call
    # computes the clip-mean-noise function, so there is no library time.
    for label, (N, D), dt in (("f32", DP_CLIP_SHAPE, f32), ("bf16", (200, 1000), torch.bfloat16)):
        grads = (3.0 * torch.randn((N, D), generator=gen, device=dev)).to(dt)
        noise = torch.randn(D, generator=gen, device=dev)
        got = ops.dp_clip_noise(grads, noise, 1.5, 0.37)
        want = ref.dp_clip_noise_ref(grads, noise, 1.5, 0.37)
        timing = dict(
            N=N, D=D, dtype=str(dt).replace("torch.", ""),
            ms=time_ms(lambda: ops.dp_clip_noise(grads, noise, 1.5, 0.37)),
            plain_ms=time_ms(lambda: ref.dp_clip_noise_ref(grads, noise, 1.5, 0.37)),
            library_ms=None,
            **bound(grads.numel() * grads.element_size() + 2 * D * 4, 4.0 * N * D),
        )
        check_kernel("dp_clip_noise", got, want, results, **timing)
        results[f"dp_clip_noise_{label}"] = results["dp_clip_noise"]
    results["dp_clip_noise"] = results["dp_clip_noise_f32"]  # the bench shape


def profile_slots(label, engine, state, slots: int, out_dir: Path, ms_per_slot: float):
    """Trace ``slots`` sampled super-ticks with torch.profiler; print the
    device time per slot by kernel name, from the exported Chrome trace
    (kernel, memcpy and memset events), and the device idle share: of the
    traced window, and of the untraced slot time ``ms_per_slot`` measured
    before (the tracer itself slows the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = engine.advance(state, slots)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = out_dir / f"trace_{label.replace(' ', '_')}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text()).get("traceEvents", [])
    by_name: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            us, count = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (us + float(e["dur"]), count + 1)
    busy_us = sum(us for us, _ in by_name.values())
    if busy_us <= 0:
        raise SystemExit(f"{label}: the profiler saw no device time")
    launches = sum(c for _, c in by_name.values())
    busy_ms = busy_us / slots / 1e3
    log(f"[4p] {label}: {slots} traced slots: traced_ms_per_slot={wall_us / slots / 1e3:.6g} "
        f"device_busy_ms_per_slot={busy_ms:.6g} device_ops_per_slot={launches / slots:.6g} "
        f"idle_share_traced={1.0 - busy_us / wall_us:.6g} "
        f"idle_share_untraced={1.0 - busy_ms / ms_per_slot:.6g} trace={trace}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, count) in top:
        log(f"[4p]   {us / slots:9.2f} us/slot  x{count / slots:5.2f}/slot  {name[:110]}")
    return state


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
               "dense": "graph_mix", "dp_clip_noise": "dp_clip_noise"}
ENGINE_LEGS = ("fused", "unfused", "dp_fused", "dp_unfused")


def check_windows(label: str, timed_leg: dict) -> None:
    """Fail unless the leg launched its path's kernel in every window."""
    want = PATH_KERNEL[label]
    per = [w.get(want, 0) for w in timed_leg["windows"]]
    if not per or min(per) <= 0:
        raise SystemExit(f"{label} leg: {want} not launched in every window ({per})")


def drive_main_path(engines, dense_obj, dev):
    """Phase 4: the engine legs of ``engines`` (``ENGINE_LEGS``: the fused
    and unfused slots, non-private and private) and dense synchronous
    rounds (``graph_mix``), warmed up, then timed in interleaved windows.
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
    dense = dict(Theta=torch.zeros((dense_obj.n, dense_obj.p), device=dev, dtype=torch.float32))
    dense["q0"] = float(dense_obj.value(dense["Theta"]))

    def slots(key):
        def step(k):
            states[key]["state"] = engines[key].advance(states[key]["state"], k)
        return step, lambda: int(states[key]["state"].applied)

    def rounds(k):
        for _ in range(k):
            dense["Theta"] = synchronous_round(dense_obj, dense["Theta"])

    rounds(WARM_STEPS)
    launches: dict = {}
    legs = {key: slots(key) for key in ENGINE_LEGS}
    legs["dense"] = (rounds, None)
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
    rate = spread(timed["dense"]["rates"])
    q1 = float(dense_obj.value(dense["Theta"]))
    main_path["dense"] = dict(rounds_per_s=rate["median"], rounds_per_s_min=rate["min"],
                              rounds_per_s_max=rate["max"], Q0=dense["q0"], Q=q1)
    log(f"[4] dense n={dense_obj.n} synchronous rounds: {fmt(main_path['dense'])} "
        f"launches={timed['dense']['counts']}")
    check_windows("dense", timed["dense"])
    if not q1 < dense["q0"] or not bool(torch.isfinite(dense["Theta"]).all()):
        raise SystemExit("dense leg: Q not decreasing, or Theta not finite")
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
    regs = [line.split("ptxas info    : ")[-1] for text in logs.values()
            for line in text.splitlines() if "registers" in line]
    log(f"[2] built {len(logs)} kernels in {secs:.2f} s; ptxas: {'; '.join(regs)}")

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

    # [4] the main path: each path's counts are reset before it and read after
    main_path, states, launches = drive_main_path(engines, dense_obj, dev)

    # [4p] where a slot's device time goes, traced after every timed leg
    # (an attached tracer slows what runs after it).
    for key in ENGINE_LEGS:
        states[key] = profile_slots(f"rgg500k_p100 {key}", engines[key], states[key],
                                    PROFILE_SLOTS, _build.build_dir() / "traces",
                                    main_path[key]["ms_per_slot"])
    budget_check(engines, states, main_path)
    main_path["dp_clip_noise"] = dp_clip_noise_leg(dev, launches)
    missing = [k for k in _build.KERNELS if k not in PATH_KERNEL.values()]
    if missing:
        raise SystemExit(f"no path of phase 4 launches {missing}")

    # [5] parity on the card
    parity(dev)

    # [6] the kernel table and the result
    src = {"sparse_mix": "src/repro/kernels/sparse_mix.py:60",
           "fused_row_update": "src/repro/kernels/fused_row_update.py:133",
           "graph_mix": "src/repro/kernels/graph_mix.py:38",
           "dp_clip_noise": "src/repro/kernels/dp_clip_noise.py:67"}
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
                    "dp_clip_noise_bf16": results["dp_clip_noise_bf16"]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   captures both graphs) the sixteen legs take turns over 5 timed windows of
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
   ids, a tenth of them cold with 4 neighbours); from every 25th request
   on, the first answer whose snapshot is still the newest ready one is
   held against a recomputation from it. Printed: the slot rates off and
   on, p50 and p99 ms, predictions/s, device us a publication, the
   largest version lag counted at the requests' start, which must be at
   most ``snapshot_every`` (PERF.md section 2), and the one counted at
   their end. Last, ``python -m repro_torch.serve --live`` once at its
   default size, its summary parsed;
4d. dynamic topology on the same problem, uncut and unfused by the rule:
   ``GraphUpdate(every=400, k=10, candidates=4, gamma=4.0)`` (the refresh
   of ``benchmarks/bench_dynamic_topology.py``: one interior refresh in 800
   slots) and 1,000 arrivals at slot 100 from a seeded draw
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
   4 prompts of 2048 tokens through ``bundle.prefill`` (a warm-up, then 3
   timed prefills, each of which must launch ``ssm_chunk`` once per layer,
   38 times; one more traced with torch.profiler: device time by block
   and kernel kind, device idle share), then 64 greedy ``bundle.decode``
   steps (2 more traced: device time and idle share per step), in turns
   with 64 steps of the captured decode (``models.DecodeGraph``) from a
   copy of the same cache (:func:`decode_turns`: every step's logits and
   the final caches equal bit for bit, one capture for every position, no
   kernel launch of ours; captured ms a step beside eager, the capture's
   seconds, the recurrent states' copy, 2 replays traced); and two
   correctness gates on a float32 instance of the same
   config: the prefill of 2 x 256 tokens against the same tokens fed one
   at a time through decode, and the prefill through the kernel against
   the einsum route;
7. the paper's benches on the card (``repro_torch.bench``): Fig. 1, CD
   against gossip ADMM at the reference bench's size (n = p = 100,
   logistic, mu = 0.3, T_cd = 3000, T_admm = 300, seed 0), and Table 1 on
   the MovieLens twin at the size of ``BENCH_summary.json``'s row (150
   users, 400 items, p = 20, 40 ticks a user, eps 1, 0.5, 0.1), through
   ``python -m repro_torch.examples.movielens_recommendation``'s ``main``. Each
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
8. the engine benches and the examples (``repro_torch.bench``,
   ``repro_torch.examples``): first the phase attribution of the
   ``fused``, ``unfused`` and ``sharded_fused`` legs of ``rgg500k_p100``
   (printed beside the captured chunk's time a slot); then
   ``bench.kernels.measure`` at the reference bench's four shapes (each
   kernel against its plain version, with its time, the plain version's,
   the library call's and the bound), the sparse-scale (n = 100,000),
   async-engine (n = 500,000), sharded-engine (n = 1,000,000, S = 8
   stacked, through ``python -m repro_torch.bench.run --full --only
   sharded_engine``, the entry point; the host set-up of the graph, both
   partitions and the engine printed from its rows) and obs (n = 200,000,
   S = 8) runners at ``bench.run``'s full sizes, each with the launch
   counts reset before and read after and required to launch its kernels
   (``RUNNER_KERNELS``); the obs engine's sum of phases over the captured
   chunk's time a slot must lie in [0.85, 1.15], the exported trace
   validate, and the profiled engine equal an unprofiled twin bit for bit
   after the profile and after 37 more slots. Then every other example of
   ``repro_torch.examples`` at its ``--smoke`` size (else its default),
   with its launches;
9. the paper's P2P-DP training round (``repro_torch.core.spmd``) on
   zamba2-1.2b at its full width and depth (38 layers, bfloat16, 1.1 B
   parameters an agent, random weights from seeded generators): 4 agents
   stacked on the card, ring gossip by rolls (offsets (1,), the train
   choice of ``launch/train.py`` for A <= 4), alpha 0.9, mu 0.5, per agent 2 sequences
   of 2049 tokens from ``token_stream``, remat on, DP noise on (the
   noise of eps_bar 1 over the rounds run, clip 1, with one next-token
   example the DP unit, m_i = 4096: not the privacy guarantee of the run,
   and at the reference launcher's one sequence, m_i = 2, this traffic
   diverges). A warm-up round (every agent's every leaf must
   change; its noise, replayed from the generator, read from its update:
   the mean |noise| of every agent within 1% of its scale), 2 timed
   rounds (ms a round, training tokens/s, peak memory),
   each required to launch ``ssm_chunk`` 2 x 38 x 4 = 304 times and to
   give a finite loss and grad_norm; ``eps_step`` and ``noise_scale`` must
   be Theorem 1's. One more round traced: the device idle share and the
   device ms in ``ssm_chunk``, in the backward's plain autograd of it, in
   the GEMMs and in the DP perturbation, gossip and update. Then the
   float32 routes at full width cut to 6 layers (4 agents, 2 x 257 tokens,
   DP off): the kernel route against the einsum route (loss 1e-5, every
   agent's new parameters 1e-4), remat on against off (``torch.equal``),
   the dense and sparse gossip against the roll (1e-6), and the roll
   round with DP on, its clip and noise read from its update against the
   DP-off round's (each agent's clip scale min(1, C / |g|) within 1e-5,
   the clipped norm at most C (1 + 1e-6)); and
   ``tests/test_spmd.py``'s gate on the reduced config (A = 1, mu = 0.3:
   the second round's loss below the first's), its first round against
   the CPU within 1e-5. Phase 3 adds ``ssm_chunk`` at the training shape
   (2 x 16 chunks x 64 heads) with the backward's time and bound;
10. the transformer families (``models/transformer.py``, ``moe.py``,
   ``encdec.py``), bfloat16, random weights from seeded generators, no
   kernel of ours on their paths (the launch counts must stay 0 across
   the phase, as in the JAX package, where they reach no Pallas kernel):
   (a) llama3.2-1b served at its full config (16 layers, d_model 2048,
   32 / 8 heads of 64, d_ff 8192, vocab 128,256 tied): 4 prompts of 2048
   tokens through ``bundle.prefill`` into caches of 2048 + 64 positions (a
   warm-up, 3 timed, one traced: device ms by block, "attention" and
   "ffn", and by kind, the idle share), then 64 greedy decode steps
   continuing the caches (2 more traced) in turns with the captured decode
   (phase 6's :func:`decode_turns`); (b) its P2P-DP training round at
   full width and depth with phase 9's traffic and gates (4 agents, 2 x
   2049 tokens each, ring of rolls, alpha 0.9, mu 0.5, remat, DP noise of
   eps_bar 1 over 4 rounds, m_i = 4096; the noise read from the warm-up
   round's update, peak memory under 80 GB), a traced round's device ms by
   range, its float32 routes on 2 layers (remat on equal to off, dense and
   sparse gossip against the roll, the DP clip read) and the reduced
   rounds; (c) granite-moe-3b-a800m (32 layers, 40 experts top-8) served
   as (a), with the share of (token, choice) pairs capacity kept in a
   prefill and in decode; (d) chameleon-34b at full width with 4 of its 48
   layers (one prefill, 16 decode steps); (e) seamless-m4t-medium (12 + 12
   layers) served as (a) against (4, 512, 1024) frame embeddings; (f) the
   float32 routes at full width, 2 layers: llama's prefill against its
   decode loop (1e-4), its attention chunked at S = 4096 against dense,
   the repeated KV cache against the compact one (1e-5), granite-moe on
   the card against the CPU (1e-5, routing equal);
11. the recurrent xLSTM family (``models/xlstm.py``, ``xlstm_stack.py``),
   bfloat16, random weights from seeded generators, no kernel of ours on
   its path (the launch counts must stay 0 across the phase): (a)
   xlstm-1.3b served at its full config (48 blocks, 42 mLSTM and 6
   sLSTM, d_model 2048, 4 heads, mLSTM heads of 1024, 3,426,883,584
   parameters, checked): 4 prompts of 2048 tokens through
   ``bundle.prefill`` (a warm-up that captures the sLSTM scan's graphs,
   then 2 turns of a prefill through the captured scan and one through
   its eager loops, ``xlstm.eager_scan``: the logits must be equal bit
   for bit), the aten operations of one sLSTM step and of one decode
   step, one prefill cut to 4 x 512 tokens traced (device ms in "mlstm"
   and "slstm" by kind, the idle share), then 64 greedy decode steps from
   ``init_cache`` timed one by one (2 more traced) in turns with the
   captured decode (phase 6's :func:`decode_turns`); (b) its P2P-DP
   training round at full width and depth with phase 9's gates, 2 agents
   (4 do not fit the card), 2 x 257 tokens each (two mLSTM chunks after
   the shift), m_i = 512, a traced round's device ms by range and block,
   the float32 routes on 2 blocks with ``slstm_every=2`` (remat on equal
   to off, dense and sparse gossip against the roll, the DP clip read, the
   DP round through the captured scan equal to the eager loops' on every
   leaf, the noise replayed) and the reduced rounds, the sLSTM graphs'
   capture seconds and replays; (c) float32 at full width, 2 blocks: the prefill
   of 2 x 256 tokens (the chunkwise mLSTM) against its own decode loop
   (the recurrent form, 1e-4), the reduced config on the card against the
   CPU (1e-5);
12. the mesh and launch layer (``launch/mesh.py``, ``models/sharding.py``,
   ``core/spmd.py::jit_train_step``, ``launch/dryrun.py``), no kernel of
   ours launched: (a) llama3.2-1b at full width, bfloat16, one agent with
   phase 10's per-agent batch (2 x 2049), DP on: the round of
   ``jit_train_step`` on a (1, 1) ``make_mesh`` over a one-rank NCCL group
   must equal ``make_train_step``'s stacked round at A = 1 bit for bit on
   the same inputs and Laplace draws; then 2 timed mesh rounds and their
   peak memory; (b) meanwhile, in subprocesses, the dry-run of llama3.2-1b
   x train_4k on 16x16, the hill-climb's ``gossip_dense`` variant, and the
   (1, 1) mesh at (a)'s batch and at 16 x 4096: the (1, 1) row's argument
   bytes must equal (a)'s input bytes, 16 x the 16x16 row's per-device
   flops must lie within 5% of the (1, 1) row's at 16 x 4096, the ring
   gossip must ship fewer collective bytes than the dense one; (a)'s
   measured peak prints beside the predicted argument + temp bytes; and
   the serve rows of llama3.2-1b x prefill_32k and decode_32k on 16x16:
   per-device flops within 5% of the JAX package's counts of the same
   rows (2.556e13 and 3.383e9), temp under 80 GB; two rows the dry-run
   once refused, xlstm-1.3b x train_4k and grok-1-314b x decode_32k on
   16x16 (flops, bytes, argument and temp bytes, trace seconds printed);
   the dry-run's subprocesses start before phase 11;
13. the sharded engine one shard a process on ``rgg500k_p100`` at S = 2
   (RCM, degree blocks, exchange ``auto``): (i) two worker processes on
   the card (``--rank-worker``) in a gloo group through a ``FileStore``,
   the halo staged through host memory: 37 forced slots of the legs
   ``sharded_fused``, ``sharded_unfused`` and ``sharded_fused_bf16_ef``
   must equal the stacked S = 2 engine's, run here, bit for bit, every
   fused rank must launch ``fused_row_update``, a per-rank save restored
   into fresh rank engines must resume bit for bit; per-rank eager ms a
   slot beside the stacked captured one (two ranks on one card over a
   host-staged wire: not a multi-card figure); which gloo collectives
   take CUDA tensors (``--gloo-probe`` pairs); (ii) a one-rank NCCL group
   at S = 1: captured == eager == stacked bit for bit, ms a captured slot,
   each phase prefix captured == eager and the phase coverage within
   ``PHASE_COVERAGE``; on the same two gloo ranks, against stacked S = 2
   engines run here meanwhile: (iii) dynamic topology (phase 4d's refresh
   and 1,000 arrivals: 37 forced slots, a refresh fired by hand, the
   admission, 37 forced slots, a forced repartition): every owned row,
   flag and counter and the live CSR equal, no kernel of ours launched,
   each call's host seconds on each rank; (iv) serving the
   ``sharded_fused`` ranks (``run(snapshot_every=16, serve=handle)``, a
   request thread a rank issuing phase 4c's batches, reads collective
   over the handle's own group): every 25th answer equal to its
   recomputation from the pinned snapshot, phase 4c's lag limits, p50,
   p99 and predictions/s; (v) every phase prefix's output on each rank
   equal to the stacked engine's shard (every agent wakes, so the draws
   depend on no generator), the ranks' phase coverage printed;
14. a JSON line of every ported kernel (launches, error, times, bound),
   the phases' command seconds (each also printed as a ``[time]`` line
   when its phase ends), then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import json
import math
import os
import re
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
WINDOWS = 5
WINDOW_STEPS = 200
# Phase 6: zamba2-1.2b serving (see PERF.md, "Cells").
ZAMBA = dict(arch="zamba2-1.2b", seed=0, batch=4, prompt=2048, prefills=3, decode_steps=64)
ZAMBA_GATE = dict(batch=2, tokens=256)  # two chunks of 128: the inter-chunk recurrence runs
DECODE_TRACED = 2  # decode steps traced with torch.profiler
# max |a - b| of the float32 gates, relative to max(1, max |logit|): 38
# layers whose two routes take their float32 sums in different orders.
MODEL_TOL = 1e-4
# Phase 9: the paper's P2P-DP training round on zamba2-1.2b (see PERF.md,
# "Cells"): A agents stacked on the card, each with `batch` sequences of
# `seq` tokens a round (16 chunks of 128 after the shift), the train
# ring and constants of launch/train.py, DP on over the rounds run. The DP
# unit here is one next-token example: m_i = batch x (seq - 1) = 4096 a
# round, not launch/train.py's one sequence (m_i = 2). Since the round clips
# the aggregated gradient, one token can move it by up to 2C, so eps_bar is
# a noise setting here and not the guarantee the run gives
# (src/repro_torch/DEVIATIONS.md). At the reference's unit this traffic
# diverges: the Laplace scale is 6 a coordinate against weights of 0.02,
# the first round turns the weights into noise and the next round's
# gradient is NaN (PERF.md, Findings).
TRAIN = dict(arch="zamba2-1.2b", seed=0, agents=4, batch=2, seq=2049, alpha=0.9, mu=0.5,
             offsets=(1,), gossip="ppermute", eps_bar=1.0, clip=1.0, warmup=1, rounds=2)
# Its float32 routes at full width cut to 6 layers (one attention site).
TRAIN_ROUTES = dict(num_layers=6, agents=4, batch=2, tokens=257)
# Relative to max(1, max |.|): the kernel route against the einsum route
# (loss, every agent's new parameters), the gossip routes against the roll,
# the card against the CPU on the reduced round; the clipped norm's slack
# and the mean |noise| against the Laplace scale, both read from a round's
# own update; the round's clip scale against min(1, C / |g|), and what is
# left of its perturbation after the clip and the noise, relative to the
# noise (float32: the reading is exact to about 1e-8).
TRAIN_TOL = dict(loss=1e-5, params=1e-4, gossip=1e-6, card_vs_cpu=1e-5, clip=1e-6, noise=0.01,
                 clip_read=1e-5)
# The profiler ranges a traced round's kernels are assigned to, innermost first.
TRAIN_RANGES = ("ssm_chunk_backward", "clip_noise", "gossip", "update", "grad_copy",
                "agent_backward", "agent_forward")
CARD_GB = 80.0  # the H100's device memory: a training round's peak must fit it
# Phase 10: the transformer families (see PERF.md, "Cells"). Serving: 4
# prompts of 2048 tokens into caches of 2048 + 64 positions, then greedy
# decode steps; chameleon-34b at full width with its depth cut to 4 of 48
# layers (34 B bf16 parameters leave no room for activations on one card).
FAMILY_SERVE = (
    dict(arch="llama3.2-1b", num_layers=None, prefills=3, decode_steps=64),
    dict(arch="granite-moe-3b-a800m", num_layers=None, prefills=3, decode_steps=64),
    dict(arch="chameleon-34b", num_layers=4, prefills=1, decode_steps=16),
    dict(arch="seamless-m4t-medium", num_layers=None, prefills=3, decode_steps=64),
)
SERVE_TRAFFIC = dict(seed=0, batch=4, prompt=2048)
# llama3.2-1b's P2P-DP round: phase 9's traffic, agents and constants.
LLAMA_TRAIN = dict(TRAIN, arch="llama3.2-1b")
LLAMA_ROUTES = dict(TRAIN_ROUTES, num_layers=2)  # float32 at full width, 2 layers
# The routes of (f): float32 at full width cut to 2 layers, TF32 off.
FAMILY_GATE = dict(num_layers=2, batch=2, tokens=256, repeat_kv_steps=8)
CHUNKED_GATE = dict(batch=1, tokens=4096, threshold=1024, rtol=2e-4, atol=2e-5)
REPEAT_KV_TOL = 1e-5
MOE_CPU_TOL = 1e-5
# The profiler ranges of a transformer's blocks (models/transformer.py).
BLOCK_RANGES = ("attention", "ffn")
# Phase 11: the xLSTM family (see PERF.md, "Cells"). Serving: phase 6's 4
# prompts of 2048 tokens (a warm-up, then `prefills` timed: the sLSTM's time
# loop is host-bound), one traced prefill cut to `traced_prompt` tokens, and
# greedy decode steps from init_cache. Training: phase 9's constants with 2
# agents (4 full-width agents need about 88 GB) of 2 x 257 tokens (two
# mLSTM chunks after the shift; cut from 2 x 2049 by the sLSTM loop's host
# time), m_i = 512. Routes and gates: float32 at full width cut to 2 blocks
# with slstm_every = 2 (one mLSTM, one sLSTM).
XLSTM_SERVE = dict(arch="xlstm-1.3b", seed=0, batch=4, prompt=2048, prefills=2,
                   traced_prompt=512, decode_steps=64, params=3_426_883_584)
# Each timed prefill runs twice in turn: through the captured sLSTM scan
# (the main path) and through its eager loops (``xlstm.eager_scan``).
XLSTM_TRAIN = dict(TRAIN, arch="xlstm-1.3b", agents=2, seq=257)
XLSTM_CUT = dict(num_layers=2, slstm_every=2)
XLSTM_ROUTES = dict(TRAIN_ROUTES, **XLSTM_CUT, agents=2)
XLSTM_GATE = dict(XLSTM_CUT, batch=2, tokens=256, cpu_tokens=32)
XLSTM_CPU_TOL = 1e-5
# The profiler ranges of the xLSTM's blocks (models/xlstm_stack.py).
XLSTM_RANGES = ("mlstm", "slstm")
# Phase 7: the paper benches, at the reference's sizes, and the reference's
# CPU rows (BENCH_summary.json) printed beside the card's.
FIG1 = dict(n=100, p=100, mu=0.3, T_cd=3000, T_admm=300, seed=0)
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
    # code. The main row is the form the engine's fused slot launches: the
    # whole tables (engine._fidx/_fw/_ftab) read at src = slot_rows (the calls
    # AsyncEngine._slot and CDUpdate.apply_fused make). The row-gathered form
    # (src=None, the reference kernel's contract and the benches') is kept as
    # the row "fused_row_update_gathered"; the two must give the same bits.
    src = slot_rows.to(torch.int32)
    krows, tab = fused_rows(obj, woken, valid, dev, consts=engine._ftab)
    _, consts = fused_rows(obj, woken, valid, dev)
    forms = {
        "gathered": (_eq4_fused_args(obj, krows, engine._fidx[slot_rows], engine._fw[slot_rows],
                                     consts, None), {}),
        "indexed": (_eq4_fused_args(obj, krows, engine._fidx, engine._fw, tab, None, src),
                    {"src": src}),
    }
    B, K = krows.shape[0], engine._fidx.shape[1]
    m = tab["X"].shape[1]
    ww = engine._fw[slot_rows]
    cols = engine._fidx[slot_rows]
    real = (ww != 0) & valid[:, None]
    rows_read = int(torch.unique(torch.cat([cols[real].long(), woken[valid]])).numel())
    flops = 2.0 * int(real.sum()) * p + nvalid * (4.0 * m * p + 8.0 * p)
    outs = {}
    for form, (args, kw) in forms.items():
        got = ops.fused_row_update(*args, theta.clone(), n, **kw)
        want = ref.fused_row_update_ref(*args, theta.clone(), n, **kw)
        outs[form] = got
        # Each valid row reads its krows (and src) entry, its (K,) table rows,
        # its coefficients and points, the rows it mixes, and writes its row.
        nbytes = (nvalid * (4 + 2 * K * 4 + 4 * 4 + m * p * 4 + 2 * m * 4)
                  + 4 * B * len(kw) + rows_read * p * 4 + nvalid * p * 4)
        slab_k, slab_p = theta.clone(), theta.clone()
        plan = row_plan(B, p, (theta, args[4], args[7]))
        timing = dict(
            B=B, K=K, valid=nvalid, passes=plan.passes, float4=plan.vec, form=form,
            ms=time_ms(lambda: ops.fused_row_update(*args, slab_k, n, **kw)),
            plain_ms=time_ms(lambda: ref.fused_row_update_ref(*args, slab_p, n, **kw)),
            library_ms=None, **bound(nbytes, flops),
        )
        check_kernel("fused_row_update", got, want, results, **timing)
        results[f"fused_row_update_{form}"] = results["fused_row_update"]
    if not torch.equal(outs["indexed"], outs["gathered"]):
        raise SystemExit("fused_row_update: the indexed form's bits differ from the gathered's")
    results["fused_row_update"] = results.pop("fused_row_update_indexed")  # the main path's

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
    computes the function, so there is no library time.

    Then the training shape of phase 9 (2 sequences x 16 chunks x 64 heads,
    float32), with the time of the backward the training path runs
    (``ops._SSMChunk.backward``: the plain version recomputed under
    autograd, then its gradient) beside that backward's own bound: its
    inputs (C, B, cum, dt, x and the upstream gy, gs) read once and its
    gradients written once, float32, and the operations the gradient needs,
    twice the forward's products (each product's two operand gradients)
    plus C.B^T once more to form the scores:
    2 x 2 [(G / heads) tri N + G tri P + G Q P N] + 2 (G / heads) tri N."""
    import torch

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.ssm_chunk import (blocks_per_sm, head_plan, smem_bytes,
                                               ssm_chunk_cuda, ssm_chunk_plain)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem = _build.load("ssm_chunk").ssm_chunk_smem_bytes
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, (G, Q, N, P, heads), dt in (("prefill", (4 * 16 * 64, 128, 64, 64, 64), torch.float32),
                                           ("bf16", (6, 77, 40, 96, 3), torch.bfloat16),
                                           ("train", (2 * 16 * 64, 128, 64, 64, 64), torch.float32)):
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
        if label == "train":
            gy = torch.randn((G, Q, P), generator=gen, device=dev)
            gs = torch.randn((G, P, N), generator=gen, device=dev)

            def backward():
                leaves = [t.detach().requires_grad_(True) for t in args[:5]]
                with torch.enable_grad():
                    return torch.autograd.grad(ssm_chunk_plain(*leaves, heads), leaves, (gy, gs))

            bwd_flops = 2 * flops + 2.0 * (G // heads) * tri * N
            bwd = bound(4 * (2 * (2 * C.numel() + 2 * G * Q + x.numel()) + gy.numel() + gs.numel()),
                        bwd_flops)
            timing.update(backward_ms=time_ms(backward), backward_gflop=bwd_flops / 1e9,
                          **{f"backward_{k}": v for k, v in bwd.items()})
        check_kernel("ssm_chunk", got, want, results, **timing)
        results[f"ssm_chunk_{label}"] = results["ssm_chunk"]
    results["ssm_chunk"] = results["ssm_chunk_prefill"]  # the main path's shape


# A Chrome trace file is written beside a trace's analysis only up to this
# many profiler events: writing and parsing one of 10^6 events (a training
# round of the xLSTM's time loops, 2.7 M) takes tens of seconds, so larger
# traces are read from the profiler's results alone.
TRACE_FILE_EVENTS = 200_000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_events(events) -> list:
    """The device's events of a trace: kernels, copies and fills."""
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


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


def rates(ms_key: str, rate_key: str, times, tokens: int) -> dict:
    """The median, fastest and slowest of ``times`` (ms) under ``ms_key``,
    and the tokens/s each gives at ``tokens`` a call under ``rate_key``."""
    ms = spread(times)
    return {ms_key: ms["median"], f"{ms_key}_min": ms["min"], f"{ms_key}_max": ms["max"],
            rate_key: tokens / ms["median"] * 1e3, f"{rate_key}_min": tokens / ms["max"] * 1e3,
            f"{rate_key}_max": tokens / ms["min"] * 1e3}


def timed_calls(fn, n: int):
    """``n`` calls of ``fn()``, each timed alone (host clock around a
    synchronized call): the last result and each call's milliseconds."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def decode_turns(label, tag, bundle, model, token, caches, positions, trace_dir: Path):
    """Greedy decode steps at ``positions`` from ``token`` (B, 1), eager
    (``bundle.decode``) and captured (``models.DecodeGraph``) in turns,
    each leg on its own copy of ``caches`` with its own greedy tokens,
    every step timed alone (host clock around a synchronized step). The
    captured leg's first step is its warm-up and capture, timed apart
    (``capture_s``); the rest are replays. Gates: every step's logits and
    the final caches equal bit for bit (``torch.equal``), one capture for
    every position, no kernel launch of ours. Then the bytes and device ms
    of the recurrent states' copies into the graph's buffers (the step
    returns new states: CUDA events, the median of 5 runs of 5), and
    ``DECODE_TRACED`` replays at the last positions traced (device ms and
    idle share a step). Returns the eager leg's last logits, its step ms
    and the captured leg's report."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import DecodeGraph
    from repro_torch.utils.tree import tree_leaves

    before = ops.launch_counts()
    eager = _clone_tree(caches)
    graph = DecodeGraph(bundle, model, caches)
    tok_e = tok_c = token
    eager_ms, captured_ms, unequal = [], [], []
    for pos in positions:
        given = eager
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, eager = bundle.decode(model, tok_e, eager, pos)
        tok_e = logits[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, _ = graph(tok_c, pos)
        tok_c = got[:, -1].argmax(dim=-1, keepdim=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        eager_ms.append((t1 - t0) * 1e3)
        if pos != positions[0]:  # the first is the warm-up and capture
            captured_ms.append((t2 - t1) * 1e3)
        if not torch.equal(logits, got):
            unequal.append(pos)
    caches_equal = all(torch.equal(a, b)
                       for a, b in zip(tree_leaves(eager), tree_leaves(graph.caches), strict=True))
    launched = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
    n = len(positions)
    out = dict(steps=n, captures=graph.captures, capture_s=graph.capture_s,
               captured_equals_eager=not unequal and caches_equal,
               **rates("captured_ms_per_step", "captured_tokens_per_s", captured_ms,
                       token.shape[0]))
    out["eager_over_captured"] = statistics.median(eager_ms) / out["captured_ms_per_step"]
    moved = [a for a, b in zip(tree_leaves(eager), tree_leaves(given), strict=True) if a is not b]
    out["state_copy_bytes"] = 2 * sum(t.numel() * t.element_size() for t in moved)
    if moved:
        dst = [torch.empty_like(t) for t in moved]

        def copy_states():
            for src, d in zip(moved, dst):
                d.copy_(src)

        out["state_copy_ms"] = time_ms(copy_states, calls=5, runs=5)
        del dst
    log(f"[{tag}] {label} decode {token.shape[0]} x {n} greedy steps, eager and captured in "
        f"turns: eager {fmt(spread(eager_ms))} ms/step; captured {fmt(out)}")
    if unequal or not caches_equal:
        raise SystemExit(f"{label} decode: the captured step differs from the eager one at "
                         f"positions {unequal}; final caches equal: {caches_equal}")
    if graph.captures != 1:
        raise SystemExit(f"{label} decode: {graph.captures} captures for {n} positions, not 1")
    if launched:
        raise SystemExit(f"{label} decode launched kernels of ours: {launched}")

    def traced_steps():
        for pos in positions[-DECODE_TRACED:]:
            graph(tok_c, pos)

    events, wall_ms = traced(traced_steps, trace_dir / f"trace_{label}_captured_decode.json")
    out["trace"] = report_trace(f"{label} captured decode", events, wall_ms, DECODE_TRACED,
                                "step", out["captured_ms_per_step"])
    del graph, eager, given
    return logits, eager_ms, out


# The kernel each path of phase 4 must launch in every window (dp_clip_noise
# in its own leg: no engine path calls it).
# The sharded unfused leg gathers with the reference's einsum: it launches none
# of the kernels (None), and the check holds it to that.
PATH_KERNEL = {"fused": "fused_row_update", "unfused": "sparse_mix",
               "dp_fused": "fused_row_update", "dp_unfused": "sparse_mix",
               "sharded_fused": "fused_row_update", "sharded_unfused": None,
               "sharded_fused_bf16_ef": "fused_row_update",
               "dense": "graph_mix", "sparse_sync": "sparse_mix",
               "dp_clip_noise": "dp_clip_noise", "zamba2_prefill": "ssm_chunk",
               "zamba2_train": "ssm_chunk"}
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
# arrivals at slot 100 from a seeded draw (one admission: a second one
# would repeat the admission's timed leg).
DYN_GU = dict(every=400, k=10, candidates=4, gamma=4.0, seed=0)
DYN_ARRIVALS = dict(slots=(100,), per_slot=1000, attach_k=4, warm_rounds=2, seed=0)
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


def _device_cat(e):
    """A device event's Chrome category (None for the device side of a
    ``record_function`` range, which is no work of the card's)."""
    if hasattr(e, "activity_type"):
        cat = e.activity_type()
        return cat if cat in DEVICE_CATS else None
    if e.is_user_annotation():
        return None
    name = e.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else (
        "gpu_memset" if name.startswith("Memset") else "kernel")


def profile_events(raw) -> list:
    """The events the reports read of a finished profile's kineto events
    ``raw``, as dicts with a Chrome trace's fields (``ts`` and ``dur`` in us):
    the device's kernels, copies and fills, the host's launches of them
    (``cat`` "cuda_runtime"), each with ``args.correlation`` naming the
    host operation that launched it, and the ``record_function`` ranges
    (``cat`` "user_annotation"), read from the profiler's own results."""
    from torch.autograd import DeviceType

    base = min((e.start_ns() for e in raw), default=0)
    out = []
    for e in raw:
        if e.device_type() == DeviceType.CPU:
            link = e.linked_correlation_id()
            if link > 0:
                cat, args = "cuda_runtime", {"correlation": link}
            elif e.is_user_annotation():
                cat, args = "user_annotation", {}
            else:
                continue
        else:
            cat = _device_cat(e)
            if cat is None:
                continue
            args = {"correlation": e.linked_correlation_id()}
        out.append({"ph": "X", "cat": cat, "name": e.name(), "ts": (e.start_ns() - base) / 1e3,
                    "dur": e.duration_ns() / 1e3, "args": args})
    return out


def traced(fn, trace: Path):
    """Run ``fn()`` under torch.profiler (host and device); return its
    events (:func:`profile_events`) and the wall milliseconds. The Chrome
    trace is written to ``trace`` when the profile holds at most
    ``TRACE_FILE_EVENTS`` events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    events = profile_events(raw)
    t3 = time.perf_counter()
    if len(raw) <= TRACE_FILE_EVENTS:
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
    else:
        log(f"[trace] {len(raw)} profiler events, {trace.name} not written: the profiler's "
            f"stop {t2 - t1:.1f} s, reading its events {t3 - t2:.1f} s")
    return events, (t1 - t0) * 1e3


def profile_prefill(bundle, model, batch, out_dir: Path, ms_untraced: float, label="zamba2",
                    blocks=("mamba2", "shared_attn"), tag="6", **kw) -> dict:
    """Trace one prefill with torch.profiler. Device time by block (the
    model's profiler ranges ``blocks``: zamba2's "mamba2" and "shared_attn",
    a transformer's "attention" and "ffn"; "outside" for the embedding,
    final norm and lm head), each kernel assigned to the range that
    launched it, and by kernel kind (``ssm_chunk``, matmul, softmax,
    other); the device idle share of the traced prefill and of the
    untraced one (``ms_untraced``). ``kw`` goes to ``bundle.prefill``."""
    trace = out_dir / f"trace_{label}_prefill.json"
    events, wall_ms = traced(lambda: bundle.prefill(model, batch, **kw), trace)
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") in blocks)
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
        raise SystemExit(f"{label} prefill: the profiler saw no device time")
    out = dict(traced_ms=wall_ms, device_busy_ms=busy_ms,
               device_ops=sum(c for _, c in by_name.values()),
               idle_share_traced=1.0 - busy_ms / wall_ms,
               idle_share_untraced=1.0 - busy_ms / ms_untraced,
               ms_by_block_and_kind=dict(sorted(by_key.items(), key=lambda kv: -kv[1])))
    log(f"[{tag}p] {label} prefill traced: "
        f"{fmt({k: v for k, v in out.items() if k != 'ms_by_block_and_kind'})} trace={trace}")
    for key, ms in out["ms_by_block_and_kind"].items():
        log(f"[{tag}p]   {ms:9.3f} ms  {key}")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[{tag}p]   {us / 1e3:9.3f} ms  x{count:4d}  {name[:110]}")
    return out


def zamba2_serve(dev, launches: dict) -> dict:
    """Phase 6: zamba2-1.2b serving at full width and depth, bfloat16.

    Prefill: a warm-up, then ``prefills`` timed prefills of the same batch
    (host clock around a synchronize), launch counts reset just before each
    and read just after: each must launch ``ssm_chunk`` once per layer.
    One more prefill is traced. Decode: ``decode_steps`` greedy steps from
    the prefill's argmax tokens on a fresh cache, each step timed (after a
    2-step warm-up on its own cache), in turns with the captured decode
    (:func:`decode_turns`). Then the float32 gates (see
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
    out = dict(params=n_params, batch=B, prompt=S,
               **rates("prefill_ms", "prefill_tokens_per_s", times, B * S),
               ssm_chunk_launches_per_prefill=cfg.num_layers, prefill_peak_gb=peak_gb)
    log(f"[6] {cfg.name} prefill {B} x {S}: {fmt(out)}")
    out["prefill_trace"] = profile_prefill(bundle, model, batch, _build.build_dir() / "traces",
                                           out["prefill_ms"])

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
    step_logits, step_ms, out["captured_decode"] = decode_turns(
        "zamba2", "6", bundle, model, first, bundle.init_cache(model, B, steps + 1), range(steps),
        _build.build_dir() / "traces")
    if not bool(torch.isfinite(step_logits).all()):
        raise SystemExit("zamba2 decode: logits not finite")
    out.update(decode_steps=steps, **rates("decode_ms_per_step", "decode_tokens_per_s", step_ms, B))
    decode_trace["idle_share_traced"] = (1.0 - decode_trace["device_busy_ms_per_step"]
                                         / decode_trace["traced_ms_per_step"])
    decode_trace["idle_share_untraced"] = (1.0 - decode_trace["device_busy_ms_per_step"]
                                           / out["decode_ms_per_step"])
    log(f"[6] {cfg.name} decode {B} x {steps} greedy steps: "
        f"{fmt({k: v for k, v in out.items() if k.startswith('decode')})}")
    log(f"[6p] zamba2 decode, {DECODE_TRACED} traced steps: {fmt(decode_trace)}")
    out["decode_trace"] = decode_trace
    del model, bundle, logits, step_logits
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
    from repro_torch.bench import cd_vs_admm
    from repro_torch.examples import movielens_recommendation
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    fig = cd_vs_admm.run(verbose=False, device=dev, **FIG1)
    fig1 = {k: fig[k] for k in ("n", "p", "mu", "acc_local", "acc_cd", "acc_admm", "obj_init",
                                "obj_cd_final", "obj_admm_final", "messages_admm",
                                "obj_cd_at_admm_budget", "cd_beats_admm_per_message",
                                "elapsed_s")}
    log(f"[7] fig1_cd_vs_admm on the card: {fmt(fig1)}; "
        f"reference CPU row: {REFERENCE_ROWS['fig1_cd_vs_admm']}")
    # Table 1 through its example, whose default is the runner's fast size
    # (150 users, 400 items, p = 20, 40 ticks a user, seed 0): phase 8 does
    # not run the example a second time.
    tab = movielens_recommendation.main(["--device", str(dev)])
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
    ``predict`` batches of 1024 ids (a tenth cold, with 4 neighbours) on
    the newest ready snapshot; from every ``check_every``-th request on,
    the first answer whose snapshot is still the newest ready one after
    it returns is held against a recomputation from that snapshot (equal,
    and warm rows equal to the snapshot's). Gates (PERF.md section 2, E =
    ``snapshot_every``): each request's lag at its start at most E; its
    lag at its end (``serve_version_lag``, the reference's count) at most
    E * (3 + 2 * floor(t * r / E)), t its duration and r the fastest
    serving-off slot rate; ``serve_version_lag_max`` the largest end lag.
    Returns the slot rates off and on, p50/p99 ms, predictions/s, device
    us a publish (CUDA events around each copy in the trainer's stream)
    and the copy alone (``time_ms`` of the clone, beside its bound), both
    lags and the state reached."""
    import threading

    import numpy as np
    import torch

    from repro_torch.serve import ServeHandle

    handle = ServeHandle.for_engine(eng)
    batches, neighbors = _serve_batches(eng.n, eng.p, np.random.default_rng(5))
    W = SERVE["window"]
    rates, lat, lags, checked = {"off": [], "on": []}, [], [], 0
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
            i, check = 0, False
            while not done.is_set():
                if not handle.published or handle.version < first:
                    time.sleep(1e-4)  # leave the GIL to the trainer until its first publication
                    continue
                ids, X = batches[i % len(batches)]
                check = check or i % SERVE["check_every"] == 0
                t1 = time.perf_counter()
                res = handle.predict(ids, X, neighbors=neighbors)
                lat.append(time.perf_counter() - t1)
                lags.append((handle.version_lag_start[0], handle.counters()["serve_version_lag"]))
                snap = handle.snapshot() if check else None
                if snap is not None and snap.version == res.version:  # still the one served
                    check = False
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
    # PERF.md section 2: publish(v + E) waits for the copy of v, and the copy
    # of v + E lands E slots of card work later, so two publications are
    # E / r apart at the least and a request of t seconds sees at most
    # 2 * (floor(t * r / E) + 1) of them.
    E, r = SERVE["snapshot_every"], max(rates["off"])
    start_lag, end_lag = np.asarray(lags).T
    end_limit = E * (3 + 2 * np.floor(lat * r / E))
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
               version_lag_start_max=int(start_lag.max()),
               end_lag_p99=float(np.percentile(end_lag, 99)),
               end_limit_at_p99=float(E * (3 + 2 * np.floor(np.percentile(lat, 99) * r / E))),
               end_over_limit_max=float((end_lag / end_limit).max()),
               cold_rows=c["serve_cold_starts"], version=handle.version)
    log(f"[4c] rgg500k_p100 fused live serving ({SERVE['window']}-slot windows, off and on in "
        f"turns, snapshot_every={SERVE['snapshot_every']}, batch {SERVE['batch']}): "
        f"{fmt({k: v for k, v in out.items() if not isinstance(v, list)})} slots/s off "
        f"{[round(r, 2) for r in rates['off']]} on {[round(r, 2) for r in rates['on']]}")
    if checked < SERVE["turns"] or out["version"] != eng._ptr_of(state):
        raise SystemExit(f"live serving: {checked} answers checked, version {out['version']}")
    if not 0 <= out["version_lag_start_max"] <= E:
        raise SystemExit(f"live serving: version lag {out['version_lag_start_max']} slots at a "
                         f"request's start, over snapshot_every={E}")
    if out["version_lag_max"] != end_lag.max() or (end_lag > end_limit).any():
        i = int(np.argmax(end_lag / end_limit))
        raise SystemExit(f"live serving: version lag {end_lag[i]} slots at the end of a request of "
                         f"{lat[i] * 1e3:.3f} ms, over its limit {end_limit[i]:.0f} (r = {r:.1f} "
                         f"slots/s), or serve_version_lag_max {out['version_lag_max']} is not the "
                         f"largest end lag {end_lag.max()}")
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


# Phase 8: the engine benches at repro_torch.bench.run's full sizes (the
# reference's) and the examples at their smoke (else default) sizes.
RUNNER_KERNELS = {"kernels": ("dp_clip_noise", "graph_mix", "ssm_chunk", "fused_row_update"),
                  "sparse_scale": ("graph_mix", "sparse_mix"),  # parity_check at n = 512
                  "async_engine": ("fused_row_update",), "sharded_engine": ("fused_row_update",),
                  "obs": ("fused_row_update",)}
PATH_KERNEL.update({f"bench_{k}": v for k, v in RUNNER_KERNELS.items()})
# Every example but movielens_recommendation, which is phase 7's Table 1 run.
EXAMPLES = (("quickstart", ()), ("p2p_linear_classification", ()), ("sparse_p2p_scale", ()),
            ("async_p2p_simulation", ()), ("sharded_async_simulation", ("--smoke",)),
            ("serve_batched", ("--smoke",)))
PHASE_COVERAGE = (0.85, 1.15)  # obs_phase_total over the separately timed full slot
TWIN_SLOTS = CAPTURE_PARITY_SLOTS  # slots both the profiled engine and its twin advance after


def _path_kernels(label) -> tuple:
    want = PATH_KERNEL[label]
    return () if want is None else (want,) if isinstance(want, str) else want


def _chunk_s_per_slot(eng, state, slots: int = 64, repeats: int = 3) -> float:
    """Seconds a slot of the captured chunk that ``advance`` replays (the
    main path): the best of ``repeats`` synchronized runs of ``slots``
    slots, after one to warm up. Advances ``state``."""
    import torch

    best = math.inf
    for i in range(repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = eng.advance(state, slots)
        torch.cuda.synchronize()
        if i:
            best = min(best, (time.perf_counter() - t0) / slots)
    return best


def _sharded_setup_s(rows, notes, n) -> dict:
    """The sharded runner's host set-up from its rows: the graph and the
    engine (us per agent) and both partitions with RCM (on the halo rows)."""
    part = [float(re.search(r"partition_build=([0-9.]+)s", notes[f"sharded_halo_frac_{k}"])[1])
            for k in ("norelabel", "rcm")]
    return dict(graph_s=rows["sharded_graph_build"] * n / 1e6, partitions_s=sum(part),
                engine_s=rows["sharded_engine_build"] * n / 1e6)


def _profiled_against_twin(keep) -> dict:
    """The obs bench's metrics-on engine, profiled at its run's state,
    against an unprofiled twin (same config and partition) run from the
    same start: equal bit for bit, then after ``TWIN_SLOTS`` more slots."""
    import numpy as np
    import torch

    from repro_torch.sim import ShardedAsyncEngine

    eng, state = keep["engine"], keep["state"]
    twin = ShardedAsyncEngine(eng.update, num_shards=eng.num_shards,
                              config=dataclasses.replace(eng.config, partition=eng.part))
    tstate = twin.run(np.zeros((eng.n, eng.p)), eng._ptr_of(state)).state
    out = {}
    for when in ("after the profile", f"after {TWIN_SLOTS} more slots"):
        a, b = _state_leaves(state), _state_leaves(tstate)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ:
            raise SystemExit(f"obs bench: the profiled engine differs from its twin {when} "
                             f"in {differ}")
        out[when] = len(a)
        state, tstate = eng.advance(state, TWIN_SLOTS), twin.advance(tstate, TWIN_SLOTS)
    return out


def engine_benches(dev, launches: dict) -> dict:
    """Phase 8: ``bench.kernels.measure``, then the sparse-scale,
    async-engine, sharded-engine (through ``python -m
    repro_torch.bench.run --full --only sharded_engine``, the entry point)
    and obs runners at ``bench.run``'s full sizes, each with the launch
    counts reset before it and read after, each required to launch its
    kernels (``RUNNER_KERNELS``); then every example. Gates: every kernel
    of ``bench.kernels`` within its tolerance (the runner raises), the obs
    engine's sum of phases over the captured chunk's time a slot in
    ``PHASE_COVERAGE``, the profiled engine equal to an unprofiled twin,
    the exported trace valid."""
    import importlib

    from repro_torch.bench import async_engine, kernels, obs, sparse_scale
    from repro_torch.bench import run as bench_run
    from repro_torch.obs import RunReport, validate_trace

    work = ROOT / "build" / "bench"
    work.mkdir(parents=True, exist_ok=True)

    def path(label, fn):
        return _counted(label, fn, launches)

    res, secs, counts = path("bench_kernels", lambda: kernels.measure(dev))
    for name, r in res.items():
        log(f"[8] bench.kernels {name} at {r['shape']}: " + fmt({
            k: r[k] for k in ("max_abs_err", "tol", "ms", "plain_ms", "library_ms", "bound_ms",
                              "bound_by", "nbytes", "flops")}))
    out = {"kernel_table": res,
           "kernels": dict(seconds=secs, launches=counts,
                           rows={k: v for k, v, _ in kernels.bench_rows(res)})}
    log(f"[8] bench.kernels ({secs:.2f} s): launches {counts}")

    summary = work / "BENCH_torch_summary.json"

    def entry_point(name):
        summary.unlink(missing_ok=True)
        rc = bench_run.main(["--full", "--only", name, "--device", str(dev),
                             "--out", str(summary)])
        if rc != 0:
            raise SystemExit(f"python -m repro_torch.bench.run --full --only {name}: exit {rc}")
        return [(k, v["us_per_call"], v["derived"])
                for k, v in json.loads(summary.read_text()).items()]

    sizes = {name: dict(bench_run.SIZES[name][True]) for name in
             ("sparse_scale", "async_engine", "sharded_engine", "obs")}
    keep = {}
    runs = {
        "sparse_scale": lambda: sparse_scale.run(device=dev, verbose=False,
                                                 **sizes["sparse_scale"]),
        "async_engine": lambda: async_engine.run(device=dev, verbose=False,
                                                 **sizes["async_engine"]),
        "sharded_engine": lambda: entry_point("sharded_engine"),
        "obs": lambda: obs.run(device=dev, verbose=False, keep=keep,
                               trace_out=str(work / "obs_torch_trace.json"),
                               report_out=str(work / "obs_torch_runreport.jsonl"),
                               **sizes["obs"]),
    }
    for name, fn in runs.items():
        memory(f"before bench {name}")
        rows, secs, counts = path(f"bench_{name}", fn)
        if not all(math.isfinite(v) for _, v, _ in rows):
            raise SystemExit(f"bench {name}: a row is not finite")
        out[name] = dict(size=sizes[name], seconds=secs, launches=counts,
                         rows={k: v for k, v, _ in rows}, notes={k: n for k, _, n in rows})
        log(f"[8] bench {name} {fmt(sizes[name])} ({secs:.2f} s): launches {counts} "
            + " ".join(f"{k}={v:.6g} ({note})" for k, v, note in rows))
    sk = out["sharded_engine"]
    sk["host_setup_s"] = _sharded_setup_s(sk["rows"], sk["notes"], sizes["sharded_engine"]["n"])
    log(f"[8] sharded_engine host set-up at n={sizes['sharded_engine']['n']}: "
        f"{fmt(sk['host_setup_s'])} (graph; both partitions with RCM; engine)")
    prof, eng = keep["profile"], keep["engine"]
    spans = validate_trace(str(work / "obs_torch_trace.json"))
    report = RunReport.from_jsonl(str(work / "obs_torch_runreport.jsonl"))
    twin = _profiled_against_twin(keep)
    chunk_s = _chunk_s_per_slot(eng, keep["state"])
    coverage = prof.total_s / chunk_s
    out["obs"].update(coverage=coverage, coverage_of_the_full_program=prof.coverage,
                      phases_us={k: v * 1e6 for k, v in prof.phases.items()},
                      prefix_us={k: v * 1e6 for k, v in prof.prefix_s.items()},
                      measured_us=prof.measured_s * 1e6, chunk_us_per_slot=chunk_s * 1e6,
                      trace_spans=spans, report_phase_rows=len(report.phase_rows), twin=twin,
                      device=str(eng.device))
    log(f"[8] obs phase attribution (S={eng.num_shards}, captured prefixes, host clock us): "
        f"{fmt(out['obs']['phases_us'])} sum {prof.total_s * 1e6:.6g}, captured chunk "
        f"{chunk_s * 1e6:.6g} a slot: coverage {coverage:.4f} (of the full-slot program "
        f"{prof.coverage:.4f}); trace {spans} spans valid; profiled engine == unprofiled twin "
        f"after the profile and {TWIN_SLOTS} more slots")
    if not PHASE_COVERAGE[0] <= coverage <= PHASE_COVERAGE[1]:
        raise SystemExit(f"obs bench: the phases sum to {coverage:.3f} of the captured chunk's "
                         f"slot, outside {PHASE_COVERAGE}")
    del keep, eng
    memory("after the engine benches")

    examples = {}
    for name, args in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        argv = list(args) + ["--device", str(dev)]
        _, secs, counts = path(f"example_{name}", lambda: mod.main(argv))
        examples[name] = dict(args=list(args), seconds=secs, launches=counts)
        log(f"[8] example {name} {' '.join(args)} ({secs:.2f} s): launches {counts}")
    out["examples"] = examples
    return out


def main_path_phases(engines) -> dict:
    """Phase 8, the phase attribution of the main path's captured slots:
    ``profile_supertick`` on the ``fused``, ``unfused`` and
    ``sharded_fused`` legs of ``rgg500k_p100`` from a fresh state (each
    prefix a captured graph on the engine's scratch state), with the sum
    of its phases over the captured chunk's time a slot, which advances
    that state through the legs' live buffers (their runs are over)."""
    import numpy as np

    from repro_torch.obs import profile_supertick

    out = {}
    for label in ("fused", "unfused", "sharded_fused"):
        eng = engines[label]
        state = eng.init_state(np.zeros((eng.n, eng.p), np.float32))
        prof = profile_supertick(eng, state=state)
        chunk_s = _chunk_s_per_slot(eng, state)
        out[label] = dict(phases_us={k: v * 1e6 for k, v in prof.phases.items()},
                          measured_us=prof.measured_s * 1e6, chunk_us_per_slot=chunk_s * 1e6,
                          coverage=prof.total_s / chunk_s,
                          coverage_of_the_full_program=prof.coverage)
        log(f"[8] rgg500k_p100 {label} phases (captured prefixes, host clock us): "
            f"{fmt(out[label]['phases_us'])} sum {prof.total_s * 1e6:.6g}, captured chunk "
            f"{chunk_s * 1e6:.6g} a slot: coverage {out[label]['coverage']:.4f} (of the "
            f"full-slot program {prof.coverage:.4f})")
    return out


def _rel_tree(a, b) -> float:
    """The largest per-leaf error of two stacked trees, each relative to
    max(1, max |leaf of b|)."""
    from repro_torch.utils.tree import tree_flatten_with_path

    worst = 0.0
    for (_, x), (_, y) in zip(tree_flatten_with_path(a), tree_flatten_with_path(b)):
        x, y = x.double(), y.to(x.device).double()
        worst = max(worst, float((x - y).abs().max()) / max(1.0, float(y.abs().max())))
    return worst


def _clone_tree(tree):
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x: x.clone(), tree)


def train_trace(step, params, batch, gen, ms_untraced: float, label="zamba2",
                tag="9", ranges=TRAIN_RANGES) -> dict:
    """Trace one training round with torch.profiler: the device idle share
    (traced, and against the untraced round ``ms_untraced``) and the device
    ms of each kernel by the innermost of ``ranges`` (innermost first) open
    when the host launched it (the autograd thread's launches included),
    then the round's split: ``ssm_chunk`` (the kernel: forward and remat
    recompute), the backward's plain autograd of it, the GEMMs elsewhere,
    the DP perturbation, gossip and update, the gradient copy, and the
    rest; and the seconds the profiler took to stop and to give its events
    (``trace_stop_read_s``), and the analysis's."""
    from repro_torch.kernels import _build

    trace = _build.build_dir() / "traces" / f"trace_{label}_train_round.json"
    t0 = time.perf_counter()
    events, wall_ms = traced(lambda: step(params, batch, gen), trace)
    t1 = time.perf_counter()
    # One pass over the trace (a round of the xLSTM's time loops is about
    # 10^6 events): the ranges, the launches by correlation id, the
    # device's events.
    spans = {name: [] for name in ranges}
    launched, device = {}, []
    for e in events:
        cat = e.get("cat", "")
        if cat == "user_annotation":
            if e.get("name") in spans:
                spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        elif cat in DEVICE_CATS:
            if e.get("ph") == "X":
                device.append(e)
        elif cat.startswith("cuda_") and "correlation" in e.get("args", {}):
            launched[e["args"]["correlation"]] = e["ts"]
    for iv in spans.values():
        iv.sort()
    starts = {name: [a for a, _ in iv] for name, iv in spans.items()}

    def where(e) -> str:
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is None:
            return "outside"
        for name in ranges:
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and t <= spans[name][i][1]:
                return name
        return "outside"

    by_key: dict = {}
    split = dict(ssm_chunk_ms=0.0, ssm_backward_plain_ms=0.0, gemm_ms=0.0,
                 dp_gossip_update_ms=0.0, grad_copy_ms=0.0, other_ms=0.0)
    for e in device:
        rng, kind, ms = where(e), _kernel_kind(e["name"]), float(e["dur"]) / 1e3
        by_key[f"{rng}/{kind}"] = by_key.get(f"{rng}/{kind}", 0.0) + ms
        if kind == "ssm_chunk":
            split["ssm_chunk_ms"] += ms
        elif rng == "ssm_chunk_backward":
            split["ssm_backward_plain_ms"] += ms
        elif rng in ("clip_noise", "gossip", "update"):
            split["dp_gossip_update_ms"] += ms
        elif rng == "grad_copy":
            split["grad_copy_ms"] += ms
        elif kind == "matmul":
            split["gemm_ms"] += ms
        else:
            split["other_ms"] += ms
    busy = sum(by_key.values())
    if busy <= 0:
        raise SystemExit(f"{label} training round: the profiler saw no device time")
    out = dict(traced_ms=wall_ms, device_busy_ms=busy, idle_share_traced=1.0 - busy / wall_ms,
               idle_share_untraced=1.0 - busy / ms_untraced,
               device_ops=len(device), trace_events=len(events),
               trace_stop_read_s=t1 - t0 - wall_ms / 1e3,
               trace_analysis_s=time.perf_counter() - t1, **split)
    out["ms_by_range"] = {name: sum(ms for key, ms in by_key.items()
                                    if key.startswith(f"{name}/"))
                          for name in ranges + ("outside",)}
    log(f"[{tag}p] {label} training round traced: {fmt(out)} trace={trace}")
    log(f"[{tag}p]   device ms by range: {fmt(out['ms_by_range'])}")
    for key, ms in sorted(by_key.items(), key=lambda kv: -kv[1])[:14]:
        log(f"[{tag}p]   {ms:10.3f} ms  {key}")
    out["ms_by_range_and_kind"] = by_key
    return out


def _replayed_blocks(trees, replay, A: int):
    """The column blocks of the stacked trees ``trees``, one tuple per
    block, in a round's order (leaf order, then ``spmd._column_blocks``),
    each with the standard Laplace draws the round's DP step took for that
    block, drawn again from ``replay`` (a generator set to the round's
    starting state)."""
    import torch

    from repro_torch.core import spmd
    from repro_torch.core.coordinate_descent import standard_laplace
    from repro_torch.utils.tree import tree_flatten_with_path

    leaves = [[x for _, x in tree_flatten_with_path(t)] for t in trees]
    for xs in zip(*leaves):
        for blks in zip(*(spmd._column_blocks(x, A) for x in xs)):
            yield blks, standard_laplace(blks[0].shape, replay, blks[0].device, torch.float32)


def _replay(gen_state, dev):
    import torch

    replay = torch.Generator(device=dev)
    replay.set_state(gen_state)
    return replay


def train_noise_read(before, after, gen_state, gen_end, noise_scale, dev, t=TRAIN,
                     tag="9") -> dict:
    """The DP noise of one full-width round, read from the round's own
    update: the round's draws replayed from its generator's starting state
    ``gen_state`` (the replay must end in the round's end state
    ``gen_end``: the round drew exactly one draw a coordinate, block by
    block), and per agent the noise scale the round applied to them,
    ``beta = <d, N> / <N, N>`` over every coordinate, where ``d = ((1 -
    alpha) theta + alpha mix(theta) - theta') / (alpha mu)`` is the
    perturbed gradient the update used (``theta`` before, ``theta'``
    after, ``mix`` the round's roll gossip). The mean |noise| of an agent,
    ``beta * mean |N|``, must be ``noise_scale`` within 1%. Nothing is
    launched but the replay, the gossip and the sums."""
    import torch

    from repro_torch.core import spmd

    A = t["agents"]
    am = t["alpha"] * t["mu"]
    replay = _replay(gen_state, dev)
    dn = nn = absn = torch.zeros(A, dtype=torch.float64, device=dev)
    count = 0
    with torch.no_grad():
        for (x0, x1), noise in _replayed_blocks((before, after), replay, A):
            mix = spmd.gossip_ppermute(x0, t["offsets"]).float()
            d = ((1.0 - t["alpha"]) * x0.float() + t["alpha"] * mix - x1.float()) / am
            dn = dn + torch.sum(d * noise, dim=1, dtype=torch.float64)
            nn = nn + torch.sum(noise * noise, dim=1, dtype=torch.float64)
            absn = absn + torch.sum(noise.abs(), dim=1, dtype=torch.float64)
            count += noise.shape[1]
            del mix, d, noise
    beta = (dn / nn).tolist()
    mean_abs = (absn / count).tolist()
    ratio = [b * m / noise_scale for b, m in zip(beta, mean_abs)]
    out = dict(draws=A * count, replay_ends_in_round_state=torch.equal(replay.get_state(), gen_end),
               noise_scale=noise_scale, beta_over_scale=[b / noise_scale for b in beta],
               mean_abs_draw=mean_abs, mean_abs_noise_over_scale=ratio)
    log(f"[{tag}] DP noise read from the warm-up round's update: {fmt(out)} "
        f"(tol {TRAIN_TOL['noise']})")
    if not (out["replay_ends_in_round_state"]
            and max(abs(r - 1.0) for r in ratio) <= TRAIN_TOL["noise"]):
        raise SystemExit(f"{t['arch']} training: DP noise gate failed: {out}")
    return out


def train_clip_read(start, off, dp, gen_state, gen_end, clip, noise_scale, dev, t=TRAIN,
                    A=TRAIN_ROUTES["agents"], tag="9") -> dict:
    """The DP clip and noise of one round, read from the round's own update
    (float32, so the reading is exact to about 1e-8): ``off`` and ``dp``
    are the DP-off and DP-on rounds from the same agents ``start`` on the
    same tokens. Per coordinate ``g = ((1 - alpha) theta + alpha mix -
    off) / (alpha mu)`` is the gradient and ``(off - dp) / (alpha mu) =
    g (s - 1) + noise_scale N`` with N the round's draws, replayed (the
    replay must end in the round's end state). Per agent: the round's clip
    scale ``s = 1 + <r, g> / <g, g>`` (``r`` the difference less the
    noise) against ``min(1, C / |g|)`` within 1e-5, the clipped norm ``s
    |g|`` at most C (1 + 1e-6), and what remains of the difference once
    both are taken out, relative to the noise, within 1e-5."""
    import torch

    from repro_torch.core import spmd

    am = t["alpha"] * t["mu"]
    replay = _replay(gen_state, dev)
    f64 = torch.float64
    g2 = y = x = n2 = torch.zeros(A, dtype=f64, device=dev)
    with torch.no_grad():
        for (x0, x1, x2), noise in _replayed_blocks((start, off, dp), replay, A):
            mix = spmd.gossip_ppermute(x0, t["offsets"]).double()
            g = ((1.0 - t["alpha"]) * x0.double() + t["alpha"] * mix - x1.double()) / am
            r = (x1.double() - x2.double()) / am - noise_scale * noise.double()
            g2 = g2 + torch.sum(g * g, dim=1)
            y = y + torch.sum(r * g, dim=1)
            x = x + torch.sum(r * r, dim=1)
            n2 = n2 + torch.sum(torch.square(noise_scale * noise.double()), dim=1)
            del mix, g, r, noise
    norm = torch.sqrt(g2)
    s = 1.0 + y / g2
    want = torch.clamp(clip / norm, max=1.0)
    k = want - 1.0
    rest = torch.sqrt(torch.clamp(x - 2.0 * k * y + k * k * g2, min=0.0)) / torch.sqrt(n2)
    out = dict(clip=clip, grad_norms=norm.tolist(), clip_scale=s.tolist(),
               clip_scale_err=(torch.abs(s - want) / want).tolist(),
               clipped_norms=(s * norm).tolist(), clipped_over_clip=(s * norm / clip).tolist(),
               rest_over_noise=rest.tolist(),
               replay_ends_in_round_state=torch.equal(replay.get_state(), gen_end))
    log(f"[{tag}] DP clip read from a float32 round's update: {fmt(out)} (tol scale "
        f"{TRAIN_TOL['clip_read']:.0e}, norm C (1 + {TRAIN_TOL['clip']:.0e}))")
    if not (out["replay_ends_in_round_state"]
            and max(out["clip_scale_err"]) <= TRAIN_TOL["clip_read"]
            and max(out["clipped_over_clip"]) <= 1 + TRAIN_TOL["clip"]
            and max(out["rest_over_noise"]) <= TRAIN_TOL["clip_read"]):
        raise SystemExit(f"{t['arch']} training: DP clip gate failed: {out}")
    return out


def zamba2_train(dev, launches: dict, card: str, kernel_row: dict) -> dict:
    """Phase 9: the paper's P2P-DP training round on zamba2-1.2b at its full
    width and depth (:func:`p2p_train` with ``TRAIN`` and ``TRAIN_ROUTES``):
    each round must launch ``ssm_chunk`` 2 L A times (the forward and the
    remat recompute; the backward is the plain version's), and the float32
    routes add the kernel route against the einsum route. Phase 3's
    ``ssm_chunk`` row at the training shape (``kernel_row``) prints once
    more beside ``card``."""
    from repro_torch.configs import get_config

    L, A = get_config(TRAIN["arch"]).num_layers, TRAIN["agents"]
    out = p2p_train(TRAIN, TRAIN_ROUTES, dev, launches, card, {"ssm_chunk": 2 * L * A}, "9")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "backward_ms", "backward_bound_ms",
            "backward_bound_by")
    log(f"[9] on {card}: ssm_chunk at the training shape (G = {kernel_row['G']}): "
        f"{fmt({k: kernel_row[k] for k in keys})}")
    return out


def _launched_since(before: dict) -> dict:
    """The launches counted since ``before`` (an earlier ``launch_counts()``)."""
    from repro_torch.kernels import ops

    return {k: v - before.get(k, 0) for k, v in ops.launch_counts().items()}


def p2p_train(t: dict, r: dict, dev, launches: dict, card: str, expect: dict, tag: str,
              ranges=TRAIN_RANGES) -> dict:
    """The paper's P2P-DP training round on ``t["arch"]`` at its full width
    and depth, bfloat16, ``t["agents"]`` agents stacked on the card (random
    weights from seeded generators), through ``core.spmd.make_train_step``
    (ring gossip by rolls, remat on, DP noise on, one next-token example
    the DP unit).

    A warm-up round, then ``t["rounds"]`` timed rounds (host clock around a
    synchronized round), launch counts read just before each and just
    after: each must launch exactly the kernels of ``expect`` that many
    times (``{}``: none). Every round's loss and grad_norm must be
    finite, every agent's every leaf must change in the warm-up round, and
    its noise is read from its update (:func:`train_noise_read`). Then one
    traced round (:func:`train_trace` over ``ranges``), the float32 routes with the DP clip
    read from a round (:func:`train_routes`) and the reduced rounds
    (:func:`train_reduced`). The headline numbers print once more beside
    ``card``, the name and power limit ``nvidia-smi`` gave."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import P2PConfig
    from repro_torch.core import spmd
    from repro_torch.core.privacy import invert_uniform_budget
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels import ops
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_flatten_with_path, tree_size

    cfg = get_config(t["arch"])
    A, B, label = t["agents"], t["batch"], cfg.name.split("-")[0]
    memory(f"before phase {tag}'s training")
    t0 = time.perf_counter()
    bundle = build_model(cfg, device=dev)
    params = bundle.init_agents(A, t["seed"])
    torch.cuda.synchronize()
    n_rounds = t["warmup"] + t["rounds"] + 1  # the traced round too
    p2p = P2PConfig(agent_mode="full", dp_enabled=True, eps_bar=t["eps_bar"],
                    planned_rounds=n_rounds, clip=t["clip"], mu=t["mu"],
                    neighbor_offsets=t["offsets"], gossip_dtype=None)
    m_i = B * (t["seq"] - 1)  # the round's next-token examples an agent
    step, eps_step, noise_scale = spmd.make_train_step(bundle, p2p, A, m_i, alpha=t["alpha"],
                                                       gossip=t["gossip"])
    want_eps = invert_uniform_budget(t["eps_bar"], n_rounds, p2p.delta_bar)
    if eps_step != want_eps or noise_scale != 2.0 * t["clip"] / (want_eps * m_i):
        raise SystemExit(f"{cfg.name} training: eps_step {eps_step} or noise_scale "
                         f"{noise_scale} is not Theorem 1's ({want_eps})")
    gen = torch.Generator(device=dev).manual_seed(t["seed"])
    stream = token_stream(cfg.vocab_size, A * B, t["seq"], t["seed"], A)

    def batch():
        return {"tokens": torch.as_tensor(next(stream).reshape(A, B, t["seq"]), device=dev)}

    per_agent = tree_size(params) // A
    log(f"[{tag}] set-up {cfg.name} training: agents={A} params_per_agent={per_agent} "
        f"dtype={cfg.dtype} batch={B}x{t['seq']} gossip={t['gossip']} offsets={t['offsets']} "
        f"alpha={t['alpha']} mu={t['mu']} eps_bar={t['eps_bar']} over {n_rounds} rounds "
        f"m_i={m_i} eps_step={eps_step:.6g} noise_scale={noise_scale:.6g} clip={t['clip']} remat=on "
        f"in {time.perf_counter() - t0:.1f} s")
    memory("after the agents' set-up")

    def check_counts(counts, what):
        got = {k: v for k, v in counts.items() if v}
        if got != expect:
            raise SystemExit(f"{cfg.name} {what}: launches {got}, want {expect}")

    def counted_round(b):
        torch.cuda.synchronize()
        before = ops.launch_counts()
        t1 = time.perf_counter()
        _, metrics = step(params, b, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        counts = _launched_since(before)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        check_counts(counts, "training round")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise SystemExit(f"{cfg.name} training round: loss {loss}, grad_norm {gnorm}")
        return ms, loss, gnorm

    before, gen_state = _clone_tree(params), gen.get_state()
    warm = counted_round(batch())
    unchanged = [(a, name) for (name, x), (_, x0) in zip(tree_flatten_with_path(params),
                                                          tree_flatten_with_path(before))
                 for a in range(A) if torch.equal(x[a], x0[a])]
    if unchanged:
        raise SystemExit(f"{cfg.name} training: parameters left unchanged by a round: "
                         f"{unchanged[:8]}")
    noise = train_noise_read(before, params, gen_state, gen.get_state(), noise_scale, dev, t,
                             tag)
    del before
    torch.cuda.reset_peak_memory_stats(dev)
    rounds = [counted_round(batch()) for _ in range(t["rounds"])]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    ms = spread([x[0] for x in rounds])
    tokens = A * B * (t["seq"] - 1)
    out = dict(agents=A, params_per_agent=per_agent, tokens_per_round=tokens,
               warmup_ms=warm[0], round_ms=ms["median"], round_ms_min=ms["min"],
               round_ms_max=ms["max"], tokens_per_s=tokens / ms["median"] * 1e3,
               tokens_per_s_min=tokens / ms["max"] * 1e3, tokens_per_s_max=tokens / ms["min"] * 1e3,
               peak_gb=peak_gb, launches_per_round=expect,
               losses=[warm[1]] + [x[1] for x in rounds],
               grad_norms=[warm[2]] + [x[2] for x in rounds], m_i=m_i, eps_step=eps_step,
               noise_scale=noise_scale)
    log(f"[{tag}] {cfg.name} P2P-DP rounds: "
        f"{fmt({k: v for k, v in out.items() if not isinstance(v, (list, dict))})} "
        f"launches_per_round={expect} losses={out['losses']} grad_norms={out['grad_norms']}")
    if peak_gb >= CARD_GB:
        raise SystemExit(f"{cfg.name} training: peak memory {peak_gb:.3f} GB")
    b = batch()
    before = ops.launch_counts()
    out["trace"] = train_trace(step, params, b, gen, ms["median"], label, tag, ranges)
    counts = _launched_since(before)
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    check_counts(counts, "traced training round")
    out["dp_noise"] = noise
    del params, bundle, step, b
    gc.collect()
    torch.cuda.empty_cache()
    out["routes"] = train_routes(cfg, dev, n_rounds, t, r, tag)
    out["reduced"] = train_reduced(dev, t["arch"], tag)
    keys = ("round_ms", "tokens_per_s", "peak_gb")
    log(f"[{tag}] on {card}: {cfg.name} {fmt({k: out[k] for k in keys})} "
        f"idle_share_untraced={out['trace']['idle_share_untraced']:.6g}")
    return out


def _cut(cfg, num_layers: int, slstm_every=None):
    """A float32 copy of ``cfg`` cut to ``num_layers`` layers (an xLSTM's
    sLSTM period set to ``slstm_every``, so the cut keeps a block of each
    type)."""
    cut = dataclasses.replace(cfg, num_layers=num_layers, dtype="float32")
    if slstm_every is not None:
        cut = dataclasses.replace(cut, xlstm=dataclasses.replace(cfg.xlstm,
                                                                 slstm_every=slstm_every))
    return cut


def train_routes(cfg, dev, n_rounds: int, t=TRAIN, r=TRAIN_ROUTES, tag="9") -> dict:
    """The training round's float32 routes at full width cut to
    ``r["num_layers"]`` layers (:func:`_cut`), A agents, DP off, one round each from the
    same agents and tokens: for the hybrid, the kernel route
    (``use_kernel=None``) against the reference's einsum route
    (``use_kernel=False``): the loss within 1e-5 and every agent's new
    parameters within 1e-4; remat on against off: ``torch.equal``; the
    dense and sparse gossip routes against the roll: 1e-6. Each relative
    to max(1, max |.|), TF32 off. Then the roll round with DP on (the
    budget of ``t`` over ``n_rounds``, the clip a quarter of the DP-off
    round's mean gradient norm, so that it binds), its clip and noise read
    from its update (:func:`train_clip_read`). No launch here counts for
    the path."""
    import torch

    from repro_torch.configs.base import P2PConfig
    from repro_torch.core import spmd
    from repro_torch.models import hybrid
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_flatten_with_path

    cfg32 = _cut(cfg, r["num_layers"], r.get("slstm_every"))
    kernel = build_model(cfg32, device=dev)
    A, B = r["agents"], r["batch"]
    start = kernel.init_agents(A, t["seed"])
    tokens = torch.randint(0, cfg.vocab_size, (A, B, r["tokens"]),
                           generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    p2p = P2PConfig(dp_enabled=False, mu=t["mu"], neighbor_offsets=t["offsets"], gossip_dtype=None)

    def round_of(bundle, gossip="ppermute"):
        step, _, _ = spmd.make_train_step(bundle, p2p, A, B, alpha=t["alpha"], gossip=gossip)
        return step(_clone_tree(start), {"tokens": tokens})

    roll, roll_m = round_of(kernel)
    loss = float(roll_m["loss"])
    gates = dict(layers=cfg32.num_layers, agents=A, tokens=B * (r["tokens"] - 1), loss=loss)
    if cfg.family == "hybrid":
        einsum = dataclasses.replace(kernel, loss=lambda p, b: hybrid.loss_fn(
            p, {"tokens": torch.as_tensor(b["tokens"], device=dev).long()}, cfg32,
            use_kernel=False))
        other, other_m = round_of(einsum)
        gates.update(kernel_vs_einsum_loss=abs(loss - float(other_m["loss"])) / max(1.0, abs(loss)),
                     kernel_vs_einsum_params=_rel_tree(roll, other))
    other, other_m = round_of(build_model(cfg32, remat=False, device=dev))
    gates["remat_on_equals_off"] = (
        all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_flatten_with_path(roll),
                                                        tree_flatten_with_path(other)))
        and all(torch.equal(roll_m[k], other_m[k]) for k in roll_m))
    for gossip in ("dense", "sparse"):
        other, _ = round_of(kernel, gossip)
        gates[f"{gossip}_vs_roll"] = _rel_tree(other, roll)
    del other
    clip = 0.25 * float(roll_m["grad_norm"])
    dp = dataclasses.replace(p2p, dp_enabled=True, eps_bar=t["eps_bar"], planned_rounds=n_rounds,
                             clip=clip)
    step, _, noise_scale = spmd.make_train_step(kernel, dp, A, B * (r["tokens"] - 1),
                                                alpha=t["alpha"])
    gen = torch.Generator(device=dev).manual_seed(t["seed"] + 1)
    gen_state = gen.get_state()
    noisy, _ = step(_clone_tree(start), {"tokens": tokens}, gen)
    clip_read = train_clip_read(start, roll, noisy, gen_state, gen.get_state(), clip, noise_scale,
                                dev, t, A, tag)
    if cfg.xlstm is not None:
        # The same DP round, the noise replayed, through the sLSTM scan's
        # eager loops: every agent's new parameters equal bit for bit.
        from repro_torch.models import xlstm

        replay = torch.Generator(device=dev)
        replay.set_state(gen_state)
        with xlstm.eager_scan():
            eager, _ = step(_clone_tree(start), {"tokens": tokens}, replay)
        gates["captured_equals_eager"] = all(
            torch.equal(x, y) for (_, x), (_, y) in zip(tree_flatten_with_path(noisy),
                                                        tree_flatten_with_path(eager)))
        log(f"[{tag}] DP round through the captured sLSTM scan == through its eager loops "
            f"(every agent's new parameters): {gates['captured_equals_eager']}")
        if not gates["captured_equals_eager"]:
            raise SystemExit(f"{cfg.name} training: the captured sLSTM scan's round differs "
                             "from the eager loops'")
        del eager
    del noisy, roll, start
    torch.cuda.empty_cache()
    log(f"[{tag}] float32 routes at full width, {cfg32.num_layers} layers: {fmt(gates)} "
        f"(tol loss {TRAIN_TOL['loss']:.0e}, params {TRAIN_TOL['params']:.0e}, "
        f"gossip {TRAIN_TOL['gossip']:.0e})")
    if not (gates.get("kernel_vs_einsum_loss", 0.0) <= TRAIN_TOL["loss"]
            and gates.get("kernel_vs_einsum_params", 0.0) <= TRAIN_TOL["params"]
            and gates["remat_on_equals_off"] and math.isfinite(loss)
            and gates["dense_vs_roll"] <= TRAIN_TOL["gossip"]
            and gates["sparse_vs_roll"] <= TRAIN_TOL["gossip"]):
        raise SystemExit(f"{cfg.name} training routes failed: {gates}")
    gates["dp_clip"] = clip_read
    return gates


def train_reduced(dev, arch="zamba2-1.2b", tag="9") -> dict:
    """``tests/test_spmd.py``'s gate on ``arch``'s reduced float32 config
    (the reference's is llama3.2-1b): A = 1, mu = 0.3, DP off, two rounds
    on one batch of 2 x 17 tokens; the second round's loss must be below
    the first's. The same first round on the CPU from the same agents
    (drawn there and copied to the card) must agree within 1e-5."""
    import numpy as np
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import P2PConfig
    from repro_torch.core import spmd
    from repro_torch.models.registry import build_model
    from repro_torch.utils.tree import tree_map

    cfg = get_reduced(arch, dtype="float32")
    p2p = P2PConfig(agent_mode="full", dp_enabled=False, mu=0.3)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 2, 17)).astype(np.int32)
    on_cpu = build_model(cfg, device="cpu")
    start = on_cpu.init_agents(1, TRAIN["seed"])
    card_step = spmd.make_train_step(build_model(cfg, device=dev), p2p, 1, 2)[0]
    cpu_step = spmd.make_train_step(on_cpu, p2p, 1, 2)[0]
    card, m1 = card_step(tree_map(lambda x: x.to(dev, copy=True), start), {"tokens": tokens})
    first = _clone_tree(card)
    card, m2 = card_step(card, {"tokens": tokens})
    cpu, c1 = cpu_step(start, {"tokens": tokens})
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    out = dict(loss_round1=l1, loss_round2=l2, card_vs_cpu_params=_rel_tree(first, cpu),
               card_vs_cpu_loss=abs(l1 - float(c1["loss"])) / max(1.0, abs(float(c1["loss"]))))
    log(f"[{tag}] reduced {arch} rounds (A = 1, mu = 0.3): {fmt(out)} "
        f"(tol {TRAIN_TOL['card_vs_cpu']:.0e})")
    if not (l2 < l1 and out["card_vs_cpu_params"] <= TRAIN_TOL["card_vs_cpu"]
            and out["card_vs_cpu_loss"] <= TRAIN_TOL["card_vs_cpu"]):
        raise SystemExit(f"{arch} reduced training gates failed: {out}")
    return out


class _RoutingProbe:
    """While open, every ``moe.moe_ffn`` call also routes its input again
    (``moe.route``) and keeps, per call, the chosen experts and the kept
    mask of its real tokens, on the host. A measurement outside the timed
    runs: the probe's routing is an extra computation."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._inner = moe, moe.moe_ffn

        def probed(params, x, cfg):
            xg, T = moe._groups(x, min(cfg.moe.group_size, x.shape[0] * x.shape[1]))
            r = moe.route(params, xg, cfg)
            k = cfg.moe.top_k
            self.calls.append((r.top_idx.reshape(-1, k)[:T].cpu(), r.keep.reshape(-1, k)[:T].cpu()))
            return self._inner(params, x, cfg)

        moe.moe_ffn = probed
        return self

    def __exit__(self, *exc):
        self._moe.moe_ffn = self._inner

    def kept_share(self, layers: int) -> dict:
        """The kept share over every call, and layer by layer (the calls
        run layer after layer, step after step)."""
        kept = [int(keep.sum()) for _, keep in self.calls]
        total = [keep.numel() for _, keep in self.calls]
        return dict(kept=sum(kept), choices=sum(total), kept_share=sum(kept) / max(sum(total), 1),
                    calls=len(self.calls),
                    by_layer=[round(sum(kept[i::layers]) / max(sum(total[i::layers]), 1), 4)
                              for i in range(layers)])


def _serve_batch(cfg, dev, gen, B, S):
    """Token ids (B, S) from ``gen`` and, for an enc-dec config, the stubbed
    frontend's frame embeddings (B, enc_len(S), d)."""
    import torch

    from repro_torch.models.encdec import enc_len

    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)}
    if cfg.is_encdec:
        batch["embeds"] = torch.randn((B, enc_len(S), cfg.d_model), generator=gen, device=dev)
    return batch


def family_serve(spec: dict, dev) -> dict:
    """Phase 10 (a), (c)-(e): serve ``spec["arch"]`` at its full config
    (``num_layers`` cuts the depth), bfloat16, random weights from a seeded
    generator on the card. ``SERVE_TRAFFIC``'s prompts through
    ``bundle.prefill(max_len=prompt + decode_steps)``: a warm-up, then
    ``prefills`` timed prefills (host clock around a synchronized call);
    one more traced (device time by block, "attention" and "ffn", and by
    kernel kind; the device idle share). Then 2 warm-up and
    ``DECODE_TRACED`` traced greedy decode steps on the warm-up prefill's
    caches, and ``decode_steps`` timed greedy steps continuing the last
    timed prefill's caches, in turns with the captured decode
    (:func:`decode_turns`). An MoE model also reports the share of its
    (token, choice) pairs that capacity kept, in one more prefill and in
    8 decode steps (:class:`_RoutingProbe`). Fails on a shape, a
    non-finite value or a decode past the cache."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import build_model

    cfg = get_config(spec["arch"])
    if spec["num_layers"]:
        cfg = dataclasses.replace(cfg, num_layers=spec["num_layers"])
    z, steps = SERVE_TRAFFIC, spec["decode_steps"]
    B, S = z["batch"], z["prompt"]
    t0 = time.perf_counter()
    bundle = build_model(cfg, device=dev)
    model = bundle.init(z["seed"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    label = cfg.name
    log(f"[10] set-up {label}: family={cfg.family} layers={cfg.num_layers} "
        f"(of {get_config(spec['arch']).num_layers}) encoder_layers={cfg.encoder_layers} "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads}x{cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.padded_vocab} tied={cfg.tie_embeddings} "
        f"moe={dataclasses.asdict(cfg.moe) if cfg.moe else None} dtype={cfg.dtype} "
        f"params={n_params} (config's count {cfg.param_count()}) "
        f"in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(z["seed"] + 1)
    batch = _serve_batch(cfg, dev, gen, B, S)
    max_len = S + steps
    _, warm_caches = bundle.prefill(model, batch, max_len=max_len)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    (logits, caches), times = timed_calls(
        lambda: bundle.prefill(model, batch, max_len=max_len), spec["prefills"])
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if logits.shape != (B, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{label} prefill: logits {tuple(logits.shape)} or not finite")
    out = dict(params=n_params, layers=cfg.num_layers, batch=B, prompt=S, cache_positions=max_len,
               **rates("prefill_ms", "prefill_tokens_per_s", times, B * S), prefill_peak_gb=peak_gb)
    log(f"[10] {label} prefill {B} x {S} ({spec['prefills']} timed): {fmt(out)}")
    trace = profile_prefill(bundle, model, batch, _build.build_dir() / "traces", out["prefill_ms"],
                            label=label, blocks=BLOCK_RANGES, tag="10", max_len=max_len)
    split = trace["ms_by_block_and_kind"]
    trace["attention_ms"] = sum(v for k, v in split.items() if k.startswith("attention/"))
    trace["gemm_ms_outside_attention"] = sum(v for k, v in split.items()
                                             if k.endswith("/matmul")
                                             and not k.startswith("attention/"))
    trace["other_ms"] = trace["device_busy_ms"] - trace["attention_ms"] \
        - trace["gemm_ms_outside_attention"]
    log(f"[10p] {label} prefill by kind: attention {trace['attention_ms']:.6g} ms, bf16 GEMMs "
        f"outside it {trace['gemm_ms_outside_attention']:.6g} ms, "
        f"the rest {trace['other_ms']:.6g} ms")
    out["prefill_trace"] = trace

    first = logits[:, -1].argmax(dim=-1, keepdim=True)  # (B, 1) greedy tokens
    for pos in range(S, S + 2):
        bundle.decode(model, first, warm_caches, pos)

    def traced_steps():
        for pos in range(S + 2, S + 2 + DECODE_TRACED):
            bundle.decode(model, first, warm_caches, pos)

    step_logits, step_ms, out["captured_decode"] = decode_turns(
        label, "10", bundle, model, first, caches, range(S, S + steps),
        _build.build_dir() / "traces")
    if step_logits.shape != (B, 1, cfg.padded_vocab) or not bool(torch.isfinite(step_logits).all()):
        raise SystemExit(f"{label} decode: logits {tuple(step_logits.shape)} or not finite")
    out.update(decode_steps=steps, **rates("decode_ms_per_step", "decode_tokens_per_s", step_ms, B))
    events, wall_ms = traced(traced_steps, _build.build_dir() / "traces"
                             / f"trace_{label}_decode.json")
    out["decode_trace"] = report_trace(f"{label} decode", events, wall_ms, DECODE_TRACED, "step",
                                       out["decode_ms_per_step"])
    log(f"[10] {label} decode {B} x {steps} greedy steps from position {S}: "
        f"{fmt({k: v for k, v in out.items() if k.startswith('decode') and k != 'decode_trace'})}")
    del warm_caches
    if cfg.moe is not None:
        with _RoutingProbe() as probe:
            _, caches = bundle.prefill(model, batch, max_len=S + 8)
        out["prefill_capacity"] = probe.kept_share(cfg.num_layers)
        token = first
        with _RoutingProbe() as probe:
            for pos in range(S, S + 8):
                step_logits, caches = bundle.decode(model, token, caches, pos)
                token = step_logits[:, -1].argmax(dim=-1, keepdim=True)
        out["decode_capacity"] = probe.kept_share(cfg.num_layers)
        log(f"[10] {label} (token, choice) pairs capacity kept: prefill "
            f"{fmt(out['prefill_capacity'])}; decode (8 steps) {fmt(out['decode_capacity'])}")
    del model, bundle, caches, logits, step_logits, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rel_max(got, want) -> float:
    return float((got.double() - want.to(got.device).double()).abs().max()) / max(
        1.0, float(want.abs().max()))


def family_gates(dev) -> dict:
    """Phase 10 (f), each route against its own twin, float32 at full width
    cut to ``FAMILY_GATE["num_layers"]`` layers, TF32 off: llama3.2-1b's
    prefill of 2 x 256 tokens against the same tokens fed one at a time
    through decode (``MODEL_TOL``, phase 6's bound); its attention at S =
    4096 with ``CHUNKED_ATTN_THRESHOLD`` lowered to 1024 against the dense
    path (``tests/test_perf_levers.py``'s rtol and atol); a prefill and 8
    decode steps through the ``REPEAT_KV_IN_CACHE`` layout against the
    compact one (1e-5); granite-moe-3b-a800m's prefill on the card against
    the same weights on the CPU (1e-5), every MoE layer's chosen experts and
    kept mask equal. No kernel of ours runs here."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.registry import build_model

    g = FAMILY_GATE
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=g["num_layers"],
                              dtype="float32")
    bundle = build_model(cfg, device=dev)
    model = bundle.init(SERVE_TRAFFIC["seed"])
    gen = torch.Generator(device=dev).manual_seed(7)
    B, S = g["batch"], g["tokens"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    prefill, _ = bundle.prefill(model, {"tokens": tokens})
    caches = bundle.init_cache(model, B, S)
    for pos in range(S):
        step, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
    out = dict(layers=cfg.num_layers, batch=B, tokens=S,
               llama_prefill_vs_decode=_rel_max(step, prefill),
               max_abs_logit=float(prefill.abs().max()))
    del caches

    c = CHUNKED_GATE
    x = torch.randn((c["batch"], c["tokens"], cfg.d_model), generator=gen, device=dev)
    attn = model.layers[0].attn
    before = attn_mod.CHUNKED_ATTN_THRESHOLD
    with torch.inference_mode():
        attn_mod.CHUNKED_ATTN_THRESHOLD = 10**9
        dense, _ = attn_mod.attention(attn, x, cfg)
        attn_mod.CHUNKED_ATTN_THRESHOLD = c["threshold"]
        try:
            chunked, _ = attn_mod.attention(attn, x, cfg)
        finally:
            attn_mod.CHUNKED_ATTN_THRESHOLD = before
    excess = float(((chunked - dense).abs() - c["atol"] - c["rtol"] * dense.abs()).max())
    out.update(chunked_vs_dense_max_abs=float((chunked - dense).abs().max()),
               chunked_vs_dense_excess=excess, chunked_tokens=c["tokens"])
    del x, dense, chunked

    n = g["repeat_kv_steps"]
    runs = []
    for flag in (False, True):
        attn_mod.set_repeat_kv_cache(flag)
        try:
            logits, caches = bundle.prefill(model, {"tokens": tokens}, max_len=S + n)
            outs, token = [logits], logits[:, -1].argmax(dim=-1, keepdim=True)
            for pos in range(S, S + n):
                logits, caches = bundle.decode(model, token, caches, pos)
                outs.append(logits)
                token = logits[:, -1].argmax(dim=-1, keepdim=True)
            runs.append((caches[0]["k"].shape[2], torch.cat(outs, dim=1)))
        finally:
            attn_mod.set_repeat_kv_cache(False)
    out.update(repeat_kv_heads=runs[1][0], compact_heads=runs[0][0],
               repeat_kv_vs_compact=_rel_max(runs[1][1], runs[0][1]))
    del model, bundle, caches, runs

    mcfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), num_layers=g["num_layers"],
                               dtype="float32")
    card = build_model(mcfg, device=dev)
    on_cpu = build_model(mcfg, device="cpu")
    model = card.init(SERVE_TRAFFIC["seed"])
    model_cpu = type(model)(mcfg, device="cpu")
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, mcfg.vocab_size, (B, S), generator=gen, device=dev)
    with _RoutingProbe() as on_card:
        got, _ = card.prefill(model, {"tokens": tokens})
    with _RoutingProbe() as cpu_probe:
        want, _ = on_cpu.prefill(model_cpu, {"tokens": tokens.cpu()})
    same_routes = len(on_card.calls) == len(cpu_probe.calls) == mcfg.num_layers and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(on_card.calls, cpu_probe.calls))
    out.update(moe_card_vs_cpu=_rel_max(got, want), moe_routing_equal=same_routes,
               moe_kept_share=on_card.kept_share(mcfg.num_layers)["kept_share"])
    log(f"[10] float32 routes at full width, {g['num_layers']} layers: {fmt(out)} (tol "
        f"prefill/decode {MODEL_TOL:.0e}, chunked rtol {c['rtol']:.0e} atol {c['atol']:.0e}, "
        f"repeat KV {REPEAT_KV_TOL:.0e}, MoE card/CPU {MOE_CPU_TOL:.0e})")
    if not (out["llama_prefill_vs_decode"] <= MODEL_TOL and excess <= 0.0
            and out["repeat_kv_heads"] == cfg.num_heads
            and out["compact_heads"] == cfg.num_kv_heads
            and out["repeat_kv_vs_compact"] <= REPEAT_KV_TOL
            and out["moe_card_vs_cpu"] <= MOE_CPU_TOL and same_routes
            and all(bool(torch.isfinite(t).all()) for t in (prefill, step, got))):
        raise SystemExit(f"phase 10 float32 routes failed: {out}")
    del model, model_cpu, card, on_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def transformer_families(dev, launches: dict, card: str) -> dict:
    """Phase 10: the transformer families on the card, through the entry
    points a user calls (``build_model``, ``core.spmd.make_train_step``):
    (a) llama3.2-1b served at its full config; (b) its P2P-DP training
    round, 4 agents at full width and depth (:func:`p2p_train`, phase 9's
    traffic and gates, its float32 routes on 2 layers and the reduced
    rounds); (c) granite-moe-3b-a800m, (d) chameleon-34b at full width and
    4 of its 48 layers, and (e) seamless-m4t-medium served
    (:func:`family_serve`); (f) the float32 routes (:func:`family_gates`);
    (g) no kernel of ours launches anywhere in the phase, as in the
    reference, where these families reach no Pallas kernel (counts reset
    at the start and read at the end)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = {}
    for spec in FAMILY_SERVE:
        out[f"serve_{spec['arch']}"] = family_serve(spec, dev)
        memory(f"after serving {spec['arch']}")
        if spec["arch"] == "llama3.2-1b":
            out["train_llama3.2-1b"] = p2p_train(LLAMA_TRAIN, LLAMA_ROUTES, dev, launches, card,
                                                 {}, "10")
    out["routes"] = family_gates(dev)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    out["kernel_launches"] = counts
    log(f"[10] kernel launches across phase 10: {counts} (none may launch)")
    if counts:
        raise SystemExit(f"phase 10 launched kernels of ours: {counts}")
    return out


def aten_ops(fn) -> dict:
    """The aten operations ``fn()`` dispatches on the host: those called
    from Python (``top``) and all, the nested ones included (a CPU-only
    profile; the card's work is not waited for)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    aten = [e for e in prof.events() if e.name.startswith("aten::")]
    top = [e for e in aten if e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")]
    return dict(top=len(top), all=len(aten))


def xlstm_serve(dev, card: str) -> dict:
    """Phase 11 (a): serve xlstm-1.3b at its full width and depth (48
    blocks, 42 mLSTM and 6 sLSTM, d_model 2048), bfloat16, random weights
    from a seeded generator on the card. ``XLSTM_SERVE``'s prompts through
    ``bundle.prefill`` (the forward's last-token logits): a warm-up (it
    captures the sLSTM scan's graphs), then ``prefills`` turns of two
    timed calls (host clock around a synchronized call): through the
    captured scan, then through its eager loops (``xlstm.eager_scan``);
    the two must give the same logits bit for bit. The aten
    operations of one sLSTM time step and of one decode step. One prefill
    cut to ``traced_prompt`` tokens, timed, then traced (device ms by
    block, "mlstm" and "slstm", and kind; the idle share). Then greedy
    decode steps from ``init_cache`` (the reference's recurrent serving):
    2 warm-up and ``DECODE_TRACED`` traced on a cache of their own, then
    ``decode_steps`` timed one by one, in turns with the captured decode
    (:func:`decode_turns`). Fails on a parameter count, a
    shape or a non-finite logit."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import xlstm
    from repro_torch.models.registry import build_model

    z = XLSTM_SERVE
    cfg = get_config(z["arch"])
    t0 = time.perf_counter()
    bundle = build_model(cfg, device=dev)
    model = bundle.init(z["seed"])
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[11] set-up {cfg.name}: blocks={cfg.num_layers} (mLSTM {len(model.mlstm)}, sLSTM "
        f"{len(model.slstm)}: one every {cfg.xlstm.slstm_every}) d_model={cfg.d_model} "
        f"heads={cfg.num_heads} proj_factor={cfg.xlstm.proj_factor} chunk={cfg.xlstm.chunk} "
        f"vocab={cfg.padded_vocab} tied={cfg.tie_embeddings} dtype={cfg.dtype} params={n_params} "
        f"in {time.perf_counter() - t0:.1f} s")
    if n_params != z["params"]:
        raise SystemExit(f"{cfg.name}: {n_params} parameters, not {z['params']}")
    gen = torch.Generator(device=dev).manual_seed(z["seed"] + 1)
    B, S = z["batch"], z["prompt"]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)}
    t0 = time.perf_counter()
    bundle.prefill(model, batch)  # warm-up: captures the sLSTM scan's graphs
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    times, eager_times = [], []
    for _ in range(z["prefills"]):  # the captured scan and the eager loops in turns
        (logits, _), ms = timed_calls(lambda: bundle.prefill(model, batch), 1)
        times += ms
        with xlstm.eager_scan():
            (eager_logits, _), ms = timed_calls(lambda: bundle.prefill(model, batch), 1)
        eager_times += ms
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if logits.shape != (B, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
        raise SystemExit(f"{cfg.name} prefill: logits {tuple(logits.shape)} or not finite")
    equal = torch.equal(logits, eager_logits)
    out = dict(params=n_params, batch=B, prompt=S,
               **rates("prefill_ms", "prefill_tokens_per_s", times, B * S),
               **rates("eager_prefill_ms", "eager_prefill_tokens_per_s", eager_times, B * S),
               warmup_s=warm_s, captured_equals_eager=equal,
               slstm_steps_per_prefill=len(model.slstm) * S, prefill_peak_gb=peak_gb)
    out["eager_over_captured"] = out["eager_prefill_ms"] / out["prefill_ms"]
    log(f"[11] {cfg.name} prefill {B} x {S} ({z['prefills']} turns, captured sLSTM scan then "
        f"eager loops): {fmt(out)}")
    log(f"[11] on {card}: prefill through the captured scan {out['prefill_ms']:.6g} ms, through "
        f"the eager loops {out['eager_prefill_ms']:.6g} ms (median of {z['prefills']} each); "
        f"logits equal bit for bit: {equal}")
    if not equal:
        raise SystemExit(f"{cfg.name} prefill: the captured sLSTM scan's logits differ from the "
                         f"eager loops' (max |diff| "
                         f"{float((logits.float() - eager_logits.float()).abs().max())})")

    # The aten operations of one sLSTM time step (the loop's body, its
    # inputs hoisted) and of one decode step.
    block = model.slstm[0]
    with torch.inference_mode():
        r32, bias, one = xlstm._step_constants(block, dev)
        xt = xlstm._heads_first(torch.zeros((B, 4 * cfg.d_model), device=dev), cfg)
        state = xlstm._to_step(xlstm.init_slstm_cache(cfg, B, dev))
        out["host_ops_slstm_step"] = aten_ops(lambda: xlstm._slstm_step(r32, bias, xt, state,
                                                                         one))
    first = logits[:, -1].argmax(dim=-1, keepdim=True)  # (B, 1) greedy tokens
    warm = bundle.init_cache(model, B, 0)
    out["host_ops_decode_step"] = aten_ops(lambda: bundle.decode(model, first, warm, 0))
    torch.cuda.synchronize()
    log(f"[11] host aten operations: one sLSTM time step {fmt(out['host_ops_slstm_step'])}, "
        f"one decode step {fmt(out['host_ops_decode_step'])}")

    short = {"tokens": batch["tokens"][:, :z["traced_prompt"]]}
    _, (short_ms,) = timed_calls(lambda: bundle.prefill(model, short), 1)
    trace = profile_prefill(bundle, model, short, _build.build_dir() / "traces", short_ms,
                            label="xlstm", blocks=XLSTM_RANGES, tag="11")
    trace.update(batch=B, prompt=z["traced_prompt"], untraced_ms=short_ms)
    for name in XLSTM_RANGES:
        trace[f"{name}_ms"] = sum(v for k, v in trace["ms_by_block_and_kind"].items()
                                  if k.startswith(f"{name}/"))
    log(f"[11p] xlstm prefill {B} x {z['traced_prompt']} untraced {short_ms:.6g} ms; device ms "
        f"in mlstm {trace['mlstm_ms']:.6g}, in slstm {trace['slstm_ms']:.6g}")
    out["prefill_trace"] = trace

    for pos in range(1, 2):
        _, warm = bundle.decode(model, first, warm, pos)

    def traced_steps():
        state = warm
        for pos in range(2, 2 + DECODE_TRACED):
            _, state = bundle.decode(model, first, state, pos)

    steps = z["decode_steps"]
    step_logits, step_ms, out["captured_decode"] = decode_turns(
        cfg.name, "11", bundle, model, first, bundle.init_cache(model, B, steps), range(steps),
        _build.build_dir() / "traces")
    if step_logits.shape != (B, 1, cfg.padded_vocab) or not bool(torch.isfinite(step_logits).all()):
        raise SystemExit(f"{cfg.name} decode: logits {tuple(step_logits.shape)} or not finite")
    out.update(decode_steps=steps, **rates("decode_ms_per_step", "decode_tokens_per_s", step_ms, B))
    events, wall_ms = traced(traced_steps,
                             _build.build_dir() / "traces" / "trace_xlstm_decode.json")
    out["decode_trace"] = report_trace(f"{cfg.name} decode", events, wall_ms, DECODE_TRACED,
                                       "step", out["decode_ms_per_step"])
    log(f"[11] {cfg.name} decode {B} x {steps} greedy steps from init_cache: "
        f"{fmt({k: v for k, v in out.items() if k.startswith('decode') and k != 'decode_trace'})}")
    del model, bundle, warm, logits, eager_logits, step_logits, batch, short, r32, bias, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def scan_graph_stats() -> dict:
    """The sLSTM scan's captured graphs so far, by (heads, batch, head
    size): the lengths captured (forward and backward), the seconds the
    captures took and the replays."""
    from repro_torch.models import xlstm

    return {f"H{k[0]}_B{k[1]}_hd{k[2]}": dict(lengths=sorted(g.forward_graphs),
                                              capture_s=g.capture_s, replays=g.replays)
            for k, g in xlstm.scan_graphs().items()}


def xlstm_gates(dev) -> dict:
    """Phase 11 (c)'s serving routes, float32, TF32 off: xlstm-1.3b at full
    width cut to 2 blocks with ``slstm_every=2`` (one mLSTM, one sLSTM):
    the prefill of 2 x 256 tokens (two chunks: the chunkwise mLSTM with its
    inter-chunk scan) against the same tokens fed one at a time through
    decode (the recurrent form), ``MODEL_TOL``; the reduced config's
    prefill on the card against the same weights on the CPU, 1e-5. Both
    relative to max(1, max |logit|)."""
    import torch

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models.registry import build_model

    g = XLSTM_GATE
    cfg = _cut(get_config(XLSTM_SERVE["arch"]), g["num_layers"], g["slstm_every"])
    bundle = build_model(cfg, device=dev)
    model = bundle.init(XLSTM_SERVE["seed"])
    gen = torch.Generator(device=dev).manual_seed(11)
    B, S = g["batch"], g["tokens"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    prefill, _ = bundle.prefill(model, {"tokens": tokens})
    caches = bundle.init_cache(model, B, S)
    for pos in range(S):
        step, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
    out = dict(blocks=cfg.num_layers, mlstm=len(model.mlstm), slstm=len(model.slstm), batch=B,
               tokens=S, prefill_vs_decode=_rel_max(step, prefill),
               max_abs_logit=float(prefill.abs().max()))
    del model, bundle, caches

    small = get_reduced(XLSTM_SERVE["arch"], dtype="float32")
    card, on_cpu = build_model(small, device=dev), build_model(small, device="cpu")
    model = card.init(XLSTM_SERVE["seed"])
    model_cpu = type(model)(small, device="cpu")
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, small.vocab_size, (B, g["cpu_tokens"]), generator=gen, device=dev)
    got, _ = card.prefill(model, {"tokens": tokens})
    want, _ = on_cpu.prefill(model_cpu, {"tokens": tokens.cpu()})
    out.update(reduced_card_vs_cpu=_rel_max(got, want), reduced_tokens=g["cpu_tokens"])
    log(f"[11] float32 routes: {fmt(out)} (tol prefill/decode {MODEL_TOL:.0e}, card/CPU "
        f"{XLSTM_CPU_TOL:.0e})")
    if not (out["prefill_vs_decode"] <= MODEL_TOL and out["reduced_card_vs_cpu"] <= XLSTM_CPU_TOL
            and all(bool(torch.isfinite(t).all()) for t in (prefill, step, got))):
        raise SystemExit(f"phase 11 float32 routes failed: {out}")
    del model, model_cpu, card, on_cpu
    gc.collect()
    torch.cuda.empty_cache()
    return out


def xlstm_family(dev, launches: dict, card: str) -> dict:
    """Phase 11: the recurrent xLSTM family on the card, through the entry
    points a user calls (``build_model``, ``core.spmd.make_train_step``):
    (a) xlstm-1.3b served at its full config (:func:`xlstm_serve`); (b) its
    P2P-DP training round, 2 agents at full width and depth
    (:func:`p2p_train` with ``XLSTM_TRAIN``: phase 9's gates, the traced
    round by block, the float32 routes on 2 blocks and the reduced
    rounds); (c) the serving routes (:func:`xlstm_gates`); (d) no kernel of
    ours launches anywhere in the phase, as in the reference, where the
    xLSTM reaches no Pallas kernel (counts reset at the start and read at
    the end)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out = {"serve": xlstm_serve(dev, card)}
    memory("after serving xlstm-1.3b")
    out["train"] = p2p_train(XLSTM_TRAIN, XLSTM_ROUTES, dev, launches, card, {}, "11",
                             XLSTM_RANGES + TRAIN_RANGES)
    out["routes"] = xlstm_gates(dev)
    out["slstm_graphs"] = scan_graph_stats()
    log(f"[11] sLSTM scan graphs (chunks of the forward and the backward, by heads, batch "
        f"and head size): {out['slstm_graphs']}")
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    out["kernel_launches"] = counts
    log(f"[11] kernel launches across phase 11: {counts} (none may launch)")
    if counts:
        raise SystemExit(f"phase 11 launched kernels of ours: {counts}")
    return out


# Phase 12: the mesh and launch layer (see PERF.md, "Cells"). (a) the P2P-DP
# round of llama3.2-1b at full width on a (1, 1) DeviceMesh over a
# one-rank NCCL group, phase 10's per-agent traffic; (b) the dry-run in
# subprocesses (a fake process group cannot share a process with NCCL).
MESH_ROUND = dict(LLAMA_TRAIN, agents=1, rounds=2)
# The dry-run runs: the 16x16 train_4k row, the hill-climb's gossip_dense
# variant of it, and the (1, 1) mesh at (a)'s batch and at the 16x16 row's
# per-agent batch (16 x 4096).
DRYRUN_CALLS = {
    "16x16": ["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b", "--shape", "train_4k"],
    "16x16_dense": ["-m", "repro_torch.launch.hillclimb", "--pair", "llama",
                    "--variant", "gossip_dense"],
    "1x1_card": ["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b", "--shape",
                 "train_4k", "--mesh-shape", "1x1", "--batch", str(MESH_ROUND["batch"]),
                 "--seq", str(MESH_ROUND["seq"] - 1)],
    "1x1_per_agent": ["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b", "--shape",
                      "train_4k", "--mesh-shape", "1x1", "--batch", "16", "--seq", "4096"],
    "16x16_prefill": ["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b", "--shape",
                      "prefill_32k"],
    "16x16_decode": ["-m", "repro_torch.launch.dryrun", "--arch", "llama3.2-1b", "--shape",
                     "decode_32k"],
    # Two rows the dry-run once refused: the sLSTM scan weighted by
    # its trip count, and the MoE decode on the weights' own shards.
    "xlstm_train_16x16": ["-m", "repro_torch.launch.dryrun", "--arch", "xlstm-1.3b", "--shape",
                          "train_4k"],
    "grok_decode_16x16": ["-m", "repro_torch.launch.dryrun", "--arch", "grok-1-314b", "--shape",
                          "decode_32k"],
}
# The rows printed but not gated beyond a finished trace with positive counts.
DRYRUN_PRINTED = ("xlstm_train_16x16", "grok_decode_16x16")
DRYRUN_FLOPS_TOL = 0.05  # 16 x the 16x16 per-device flops against the (1, 1) row's
# The serve rows' gates: per-device flops within DRYRUN_FLOPS_TOL of the
# reference's count of the same row (ROADMAP C8, from the JAX package's
# dry-run of llama3.2-1b on 16x16 on a CPU), and a temp an 80 GB card holds.
DRYRUN_SERVE_FLOPS = {"16x16_prefill": 2.556e13, "16x16_decode": 3.383e9}
DRYRUN_TIMEOUT_S = 600  # from the start of phase 12; the calls start before phase 11


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_start(out_dir: Path) -> dict:
    """Start the dry-run calls of :data:`DRYRUN_CALLS`, each in its own
    process writing its row to ``out_dir``; returns the processes."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = {}
    for label, args in DRYRUN_CALLS.items():
        out = out_dir / f"{label}.jsonl"
        out.unlink(missing_ok=True)
        procs[label] = (subprocess.Popen([sys.executable, *args, "--out", str(out)], cwd=ROOT,
                                         env=env, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), out)
    return procs


def dryrun_rows(procs: dict) -> dict:
    """Wait for the dry-run processes; any that fails fails the phase."""
    rows = {}
    for label, (proc, out) in procs.items():
        try:
            text, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise SystemExit(f"phase 12 dry-run {label}: no row in {DRYRUN_TIMEOUT_S} s")
        if proc.returncode != 0 or not out.exists():
            raise SystemExit(f"phase 12 dry-run {label} failed ({proc.returncode}): "
                             f"{text[-3000:]}")
        rows[label] = json.loads(out.read_text().splitlines()[-1])
    return rows


def mesh_round(dev, launches: dict, card: str) -> dict:
    """(a) The P2P-DP round of llama3.2-1b at full width (bfloat16, random
    weights from a seeded generator, one agent, phase 10's per-agent batch,
    DP on, remat on) through ``spmd.jit_train_step`` on a (1, 1)
    ``make_mesh`` over a one-rank NCCL group, against ``make_train_step``'s
    stacked round at A = 1 on the same inputs and the same Laplace draws
    (``draws=``): every leaf must come out with the same bits. Then
    ``MESH_ROUND["rounds"]`` timed mesh rounds (noise from a generator),
    their peak memory, and no kernel of ours launched."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import P2PConfig
    from repro_torch.core import spmd
    from repro_torch.core.coordinate_descent import standard_laplace
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.models.sharding import batch_specs, param_specs
    from repro_torch.utils.tree import tree_flatten_with_path, tree_map

    t = MESH_ROUND
    B, S = t["batch"], t["seq"]
    ops.reset_launch_counts()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = get_config(t["arch"])
        bundle = build_model(cfg, device=dev)
        p2p = P2PConfig(agent_mode="full", dp_enabled=True, eps_bar=t["eps_bar"],
                        planned_rounds=2 + t["rounds"], clip=t["clip"], mu=t["mu"],
                        neighbor_offsets=t["offsets"], gossip_dtype=None)
        m_i = B * (S - 1)
        step, eps_step, noise_scale = spmd.make_train_step(bundle, p2p, mesh, m_i,
                                                           alpha=t["alpha"], gossip=t["gossip"])
        stacked = bundle.init_agents(1, t["seed"])
        toks = token_stream(cfg.vocab_size, B, S, t["seed"], 1)
        batch = {"tokens": torch.as_tensor(next(toks).reshape(1, B, S), device=dev)}
        mstep = spmd.jit_train_step(step, mesh, param_specs(stacked, mesh, "full", 1),
                                    batch_specs(batch, mesh, "full"))
        params = mstep.shard(tree_map(lambda x: x[0].clone(), stacked))
        gen = torch.Generator(device=dev).manual_seed(t["seed"] + 1)
        draws = {name: standard_laplace(x.shape, gen, dev, torch.float32)
                 for name, x in tree_flatten_with_path(stacked)}
        in_bytes = (sum(x.to_local().numel() * x.element_size()
                        for _, x in tree_flatten_with_path(params))
                    + batch["tokens"].numel() * batch["tokens"].element_size())
        _, want = step(stacked, batch, draws=draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, got = mstep(params, {"tokens": batch["tokens"][0]},
                       draws={k: v[0] for k, v in draws.items()})
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        differ = [name for (name, x), (_, y) in zip(tree_flatten_with_path(params),
                                                    tree_flatten_with_path(stacked))
                  if not torch.equal(x.to_local(), y[0])]
        if differ or float(got["loss"]) != float(want["loss"]):
            raise SystemExit(f"phase 12 mesh round != stacked round: leaves {differ[:8]}, "
                             f"loss {float(got['loss'])} vs {float(want['loss'])}")
        del stacked, draws, want
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        rounds = []
        for _ in range(t["rounds"]):
            b = {"tokens": torch.as_tensor(next(toks).reshape(B, S), device=dev)}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, m = mstep(params, b, gen)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t1) * 1e3)
            if not (math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))):
                raise SystemExit(f"phase 12 mesh round: metrics {m}")
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        dist.destroy_process_group()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    if counts:
        raise SystemExit(f"phase 12 launched kernels of ours: {counts}")
    ms = spread(rounds)
    out = dict(agents=1, batch=B, seq=S, m_i=m_i, eps_step=eps_step, noise_scale=noise_scale,
               equal_bits=True, first_round_ms=first_ms, round_ms=ms["median"],
               round_ms_min=ms["min"], round_ms_max=ms["max"],
               tokens_per_s=B * (S - 1) / ms["median"] * 1e3, input_bytes=in_bytes,
               held_before_bytes=held, peak_bytes=peak, peak_gb=peak / 1e9)
    log(f"[12] on {card}: llama3.2-1b mesh round (1, 1) == stacked round, bit for bit; "
        f"{fmt({k: v for k, v in out.items() if k != 'equal_bits'})}")
    return out


def mesh_layer(dev, launches: dict, card: str, procs: dict) -> dict:
    """Phase 12: the dry-run (``procs``, started in subprocesses before
    phase 11), (a) on the card meanwhile, then the dry-run's gates: the (1, 1) row's argument bytes
    equal the card's input bytes; 16 x the 16x16 row's per-device flops
    within ``DRYRUN_FLOPS_TOL`` of the (1, 1) row's at the same per-agent
    batch; the ring gossip ships fewer collective bytes than the dense
    one; (a)'s measured peak beside the predicted argument + temp bytes."""
    t0 = time.perf_counter()
    out = {"mesh_round": mesh_round(dev, launches, card)}
    rows = dryrun_rows(procs)
    dr_s = time.perf_counter() - t0
    big, dense = rows["16x16"], rows["16x16_dense"]
    card_row, per_agent = rows["1x1_card"], rows["1x1_per_agent"]
    for label, r in rows.items():
        log(f"[12] dry-run {label}: mesh={r['mesh']} gossip={r['gossip']} trace_s={r['trace_s']} "
            f"{fmt(r['memory'])} flops_per_device={r['flops_per_device']:.6g} "
            f"bytes_per_device={r['bytes_per_device']:.6g} "
            f"collective_bytes_per_device={r['collective_bytes_per_device']:.6g} "
            f"compute_s={r['compute_s']:.6g} memory_s={r['memory_s']:.6g} "
            f"collective_s={r['collective_s']:.6g} dominant={r['dominant']} "
            f"useful_ratio={r['useful_ratio']:.6g} collectives={r['collective_breakdown']}")
    mr = out["mesh_round"]
    args_ok = card_row["memory"]["argument_size_in_bytes"] == mr["input_bytes"]
    flops_rel = big["flops_per_device"] * 16 / per_agent["flops_per_device"] - 1.0
    coll_ok = big["collective_bytes_per_device"] < dense["collective_bytes_per_device"]
    mem = card_row["memory"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    out.update(rows=rows, args_equal=args_ok, flops_rel=flops_rel, ppermute_lt_dense=coll_ok,
               predicted_peak_bytes=predicted, measured_over_predicted=mr["peak_bytes"] / predicted,
               seconds=dr_s)
    serve = {label: dict(flops_rel=rows[label]["flops_per_device"] / want - 1.0,
                         temp_bytes=rows[label]["memory"]["temp_size_in_bytes"])
             for label, want in DRYRUN_SERVE_FLOPS.items()}
    serve_ok = all(abs(v["flops_rel"]) <= DRYRUN_FLOPS_TOL and v["temp_bytes"] < CARD_GB * 1e9
                   for v in serve.values())
    out["serve_gates"] = serve
    for label, v in serve.items():
        log(f"[12] serve gate {label}: flops_per_device {rows[label]['flops_per_device']:.6g} vs "
            f"the reference's {DRYRUN_SERVE_FLOPS[label]:.6g} (rel {v['flops_rel']:.6g}, "
            f"tolerance {DRYRUN_FLOPS_TOL}); temp {v['temp_bytes']} B < {CARD_GB:g} GB")
    log(f"[12] gates: argument bytes {card_row['memory']['argument_size_in_bytes']} vs the card's "
        f"{mr['input_bytes']} ({args_ok}); 16 x 16x16 flops / (1, 1) flops - 1 = {flops_rel:.6g} "
        f"(tolerance {DRYRUN_FLOPS_TOL}); ppermute {big['collective_bytes_per_device']:.6g} B < "
        f"dense {dense['collective_bytes_per_device']:.6g} B ({coll_ok}); on {card}: measured peak "
        f"{mr['peak_bytes']} B vs predicted argument + temp {predicted} B "
        f"(ratio {out['measured_over_predicted']:.6g}); phase wall {dr_s:.1f} s")
    printed = {label: dict(flops_per_device=rows[label]["flops_per_device"],
                           bytes_per_device=rows[label]["bytes_per_device"],
                           argument_bytes=rows[label]["memory"]["argument_size_in_bytes"],
                           temp_bytes=rows[label]["memory"]["temp_size_in_bytes"],
                           trace_s=rows[label]["trace_s"]) for label in DRYRUN_PRINTED}
    out["formerly_refused"] = printed
    for label, v in printed.items():
        log(f"[12] formerly refused row {label}: {fmt(v)}")
    printed_ok = all(v["flops_per_device"] > 0 and v["bytes_per_device"] > 0
                     for v in printed.values())
    if not (args_ok and abs(flops_rel) <= DRYRUN_FLOPS_TOL and coll_ok and serve_ok
            and printed_ok):
        raise SystemExit(f"phase 12 dry-run gates failed: args {args_ok}, flops {flops_rel}, "
                         f"ppermute < dense {coll_ok}, serve rows {serve}, "
                         f"formerly refused {printed}")
    return out


# Phase 13: the sharded engine one shard a process (see PERF.md, "Cells").
# The rgg500k_p100 problem uncut at S = 2 with phase 4's sharded placement
# (RCM relabel, degree blocks, exchange "auto"). (i) Two worker processes
# on the one card form a gloo group through a FileStore, the halo staged
# through host memory: each leg's forced-wake slots must equal the stacked
# S = 2 engine's, run here, bit for bit; a per-rank save restores into
# fresh rank engines. This checks per-rank state and per-rank launches on
# one card; it is no measure of an exchange across cards. (ii) A one-rank
# NCCL group runs the fused leg at S = 1, captured.
RANKS = dict(shards=2, relabel="rcm", partition_mode="degree", mask_seed=13, slots=37,
             timed_windows=3, timed_slots=20, nccl_windows=3, nccl_slots=100)
RANK_LEGS = ("sharded_fused", "sharded_unfused", "sharded_fused_bf16_ef")
RANK_TIMEOUT_S = 900
# (iv): windows of slots through run on the sharded_fused ranks, serving
# off and on in turns; a fixed count of requests an on-window (the reads
# are collectives: every rank issues the same ones), every 25th checked.
RANK_SERVE = dict(window=320, turns=2, requests=50, check_every=25)
RANK_DRIFT = -1.0  # (iii)'s last refresh: below any drift, so it repartitions


def _rank_engine_kw(leg: str, c: dict) -> dict:
    """The engine options of a phase-13 leg (phase 4's sharded legs') on
    the problem ``c`` (:data:`MAIN`)."""
    from repro_torch.sim import ChurnConfig, ExchangeSpec, Scenario

    wire = (ExchangeSpec(method="p2p", dtype="bf16", error_feedback=True)
            if leg == "sharded_fused_bf16_ef" else ExchangeSpec())
    return dict(exchange=wire, fused=False if leg == "sharded_unfused" else "auto",
                slot_wakes=c["slot_wakes"], seed=c["seed"],
                scenario=Scenario(churn=ChurnConfig(leave_prob=0.01, rejoin_prob=0.2)))


def _rank_masks(c: dict, r: dict):
    """The forced wake sets of phase 13, the same in every process."""
    import numpy as np

    rng = np.random.default_rng(r["mask_seed"])
    return (rng.random(c["n"]) < c["slot_wakes"] / c["n"] for _ in range(r["slots"]))


def _leaves(state) -> dict:
    """A sharded state's per-shard leaves (L, ...) on the host."""
    out = {k: getattr(state, k) for k in ("Theta", "active", "applied", "dropped", "messages",
                                          "ptr")}
    if state.ef is not None:
        out["ef"] = state.ef
    return {k: v.detach().to("cpu").numpy() for k, v in out.items()}


def _dyn_rank_kw(c: dict, arrival) -> dict:
    """(iii)'s engine options: phase 4d's refresh and arrivals, the legs'
    churn, phase 13's placement at S = 2, ``drift_threshold`` 0.25."""
    from repro_torch.sim import ChurnConfig, GraphUpdate, Scenario

    return dict(slot_wakes=c["slot_wakes"], seed=c["seed"], relabel=RANKS["relabel"],
                partition_mode=RANKS["partition_mode"], drift_threshold=0.25,
                graph_update=GraphUpdate(**DYN_GU),
                scenario=Scenario(churn=ChurnConfig(leave_prob=0.01, rejoin_prob=0.2),
                                  arrival=arrival))


def _dyn_sequence(eng, c: dict, sync) -> tuple:
    """(iii) on a dynamic engine, stacked or a rank: 37 forced slots, a
    refresh fired by hand, the admission of every scheduled arrival, 37
    forced slots, and a refresh with ``drift_threshold`` below any drift
    (a repartition). Returns the state and each call's host seconds
    (``set_topology`` timed inside the refresh and the admission)."""
    import numpy as np

    swaps = []
    set_topology = eng.set_topology

    def timed_swap(state, csr):
        sync()
        t0 = time.perf_counter()
        state = set_topology(state, csr)
        sync()
        swaps.append(time.perf_counter() - t0)
        return state

    eng.set_topology = timed_swap
    secs = {}

    def timed(label, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs[label] = time.perf_counter() - t0
        secs[f"{label}_set_topology"] = swaps[-1]
        return out

    state = eng.init_state(np.zeros((c["n"], c["p"]), np.float32))
    for mask in _rank_masks(c, RANKS):
        state = eng.step(state, mask)
    state = timed("refresh", lambda: eng._refresh_topology(state, 1))
    ids = eng.scenario.arrival.all_ids()
    state = timed("admit", lambda: eng.admit(state, ids))
    for mask in _rank_masks(c, dict(RANKS, mask_seed=RANKS["mask_seed"] + 1)):
        state = eng.step(state, mask)
    eng.config = eng.config.replace(drift_threshold=RANK_DRIFT)
    state = timed("repartition", lambda: eng._refresh_topology(state, 2))
    sync()
    del eng.set_topology
    return state, secs


def _leaf_hash(t) -> str:
    """sha256 of a tensor's bytes, with its shape and dtype."""
    import hashlib

    import torch

    a = t.detach().contiguous().to("cpu")
    raw = a.reshape(-1).view(torch.uint8).numpy().tobytes()
    return f"{hashlib.sha256(raw).hexdigest()[:24]}:{tuple(a.shape)}:{a.dtype}"


def _prefix_hashes(eng, state) -> dict:
    """Every phase prefix's output (``prefix_shards``) hashed leaf by leaf:
    a per-shard leaf shard by shard (a rank: its one; stacked: each of the
    S), the all-gather's pool whole."""
    from repro_torch.sim.capture import prefix_shards

    out = {}
    for upto in list(eng.phase_names) + [None]:
        pairs = prefix_shards(eng, upto, eng.phase_program(upto)(state))
        out[str(upto)] = [[_leaf_hash(t[j]) for j in range(t.shape[0])] if per else _leaf_hash(t)
                          for t, per in pairs]
    return out


def _phase_rank_kw(leg: str, c: dict) -> dict:
    """(v)'s engine options: the leg's, without churn, and every agent
    waking every slot (p = 1 - exp(-64) is 1.0 in float64), so a prefix's
    output depends on no generator."""
    from repro_torch.sim import Scenario

    return dict(_rank_engine_kw(leg, c), slot_wakes=64.0 * c["n"], scenario=Scenario())


def _phase_theta(c: dict):
    """(v)'s seeded initial models (float32)."""
    import numpy as np

    return np.random.default_rng(7).normal(size=(c["n"], c["p"])).astype(np.float32)


def _rank_recompute(reads, snap, ids, X, neighbors):
    """(iv)'s recomputation of ``ids``' scores from the pinned snapshot:
    every rank's tiles gathered (a collective on the handle's group), each
    id's rows by its shard and local row, the Eq. 16 uniform average for
    cold ids, in plain PyTorch."""
    import numpy as np
    import torch

    tiles = reads.all_gather(snap.tiles)
    tiles = tiles.reshape((-1,) + tuple(snap.tiles.shape[1:]))  # (S, R, p)
    n = snap.shard_of.size
    K = max(len(v) for v in neighbors.values())
    gids = np.zeros((ids.size, K), np.int64)
    w = np.zeros((ids.size, K), np.float32)
    for b, i in enumerate(ids.tolist()):
        nb = (i,) if i < n else neighbors[i]
        gids[b, : len(nb)] = nb
        w[b, : len(nb)] = 1.0 / len(nb)
    dev = tiles.device
    rows = tiles[torch.as_tensor(snap.shard_of[gids].astype(np.int64), device=dev),
                 torch.as_tensor(snap.local_of[gids].astype(np.int64), device=dev)]
    theta = (torch.as_tensor(w, device=dev).unsqueeze(-1) * rows).sum(dim=1)
    return (theta * torch.as_tensor(X, device=dev)).sum(dim=-1).cpu().numpy()


def _rank_serving(eng, state, sync) -> tuple:
    """(iv) on a rank: windows of ``RANK_SERVE["window"]`` slots through
    ``run``, serving off and on in turns; on: a trainer thread runs
    ``run(snapshot_every=16, serve=handle)`` while this thread issues
    ``RANK_SERVE["requests"]`` of phase 4c's batches (the same ids on
    every rank, in the same order), every ``check_every``-th answer held
    against :func:`_rank_recompute` when its snapshot is still the newest
    every rank holds. Returns the rates, latencies, lags and checks."""
    import threading

    import numpy as np
    import torch.distributed as dist

    from repro_torch.serve import ServeHandle

    handle = ServeHandle.for_engine(eng)
    batches, neighbors = _serve_batches(eng.n, eng.p, np.random.default_rng(5))
    W, E = RANK_SERVE["window"], SERVE["snapshot_every"]
    rates, lat, lags, checked, equal = {"off": [], "on": []}, [], [], 0, True
    for _ in range(RANK_SERVE["turns"]):
        for mode in ("off", "on"):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            if mode == "off":
                state = eng.run(None, W, state=state).state
                sync()
                rates[mode].append(W / (time.perf_counter() - t0))
                continue
            box = {}

            def train():
                box["result"] = eng.run(None, W, state=state, serve=handle, snapshot_every=E)

            first = eng._ptr_of(state)
            trainer = threading.Thread(target=train, name="trainer")
            trainer.start()
            for i in range(RANK_SERVE["requests"]):
                while not handle.published or handle.version < first:
                    time.sleep(1e-4)
                ids, X = batches[i % len(batches)]
                t1 = time.perf_counter()
                res = handle.predict(ids, X, neighbors=neighbors)
                lat.append(time.perf_counter() - t1)
                lags.append((handle.version_lag_start[0], handle.counters()["serve_version_lag"]))
                if i % RANK_SERVE["check_every"] == 0:
                    snap = handle.snapshot()
                    if snap.version == res.version:  # the same on every rank
                        want = _rank_recompute(handle._reads, snap, ids, X, neighbors)
                        equal &= bool(np.array_equal(res.values, want))
                        checked += 1
            trainer.join()
            sync()
            if "result" not in box:
                raise SystemExit(f"phase 13 (iv) rank {eng.rank}: the trainer thread failed")
            state = box["result"].state
            rates[mode].append(W / (time.perf_counter() - t0))
    r = max(rates["off"])
    lat = np.asarray(lat)
    start_lag, end_lag = np.asarray(lags).T
    end_limit = E * (3 + 2 * np.floor(lat * r / E))
    c = handle.counters()
    out = dict(slots_per_s_off=rates["off"], slots_per_s_on=rates["on"], requests=int(lat.size),
               checked=checked, equal=equal, p50_ms=float(np.percentile(lat, 50) * 1e3),
               p99_ms=float(np.percentile(lat, 99) * 1e3),
               predictions_per_s=float(SERVE["batch"] * lat.size / lat.sum()),
               version_lag_start_max=int(start_lag.max()), version_lag_max=int(end_lag.max()),
               end_over_limit_max=float((end_lag / end_limit).max()),
               snapshots=c["serve_snapshots_published"], cold_rows=c["serve_cold_starts"],
               start_ok=bool(0 <= start_lag.max() <= E), end_ok=bool((end_lag <= end_limit).all()))
    return out, state


GLOO_PROBES = ("all_gather_into_tensor", "all_reduce", "broadcast", "batch_isend_irecv")
GLOO_PROBE_TIMEOUT_S = 90


def gloo_probe_worker(call: str, rank: int, store: str) -> int:
    """One rank of a two-rank gloo group on the card trying one collective
    on CUDA tensors (``chip_smoke.py --gloo-probe``); prints what happened.
    What the exchange uses is chosen by the backend, not by this probe."""
    import datetime

    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    x = torch.ones(4, device=dev)
    try:
        if call == "all_gather_into_tensor":
            dist.all_gather_into_tensor(torch.empty(8, device=dev), x)
        elif call == "all_reduce":
            dist.all_reduce(x)
        elif call == "broadcast":
            dist.broadcast(x, 0)
        else:
            ops_ = [dist.P2POp(dist.isend, x, 1 - rank),
                    dist.P2POp(dist.irecv, torch.empty_like(x), 1 - rank)]
            for w in dist.batch_isend_irecv(ops_):
                w.wait()
        torch.cuda.synchronize()
        print("PROBE takes CUDA tensors", flush=True)
    except Exception as e:  # the finding, recorded as it is
        print(f"PROBE {type(e).__name__}: {str(e).splitlines()[0][:160]}", flush=True)
    return 0


def gloo_probes_start(out_dir: Path) -> dict:
    """Start a two-process gloo group on the card for each collective of
    :data:`GLOO_PROBES`; returns the processes."""
    procs = {}
    for call in GLOO_PROBES:
        store = out_dir / f"probe_{call}"
        procs[call] = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--gloo-probe", call, str(r),
             str(store)], cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    return procs


def gloo_probes_read(procs: dict) -> dict:
    """What each probed collective did on CUDA tensors (a process that died
    or hung is what happened, recorded with its exit code)."""
    out = {}
    for call, pair in procs.items():
        seen = []
        for p in pair:
            try:
                text = p.communicate(timeout=GLOO_PROBE_TIMEOUT_S)[0]
            except subprocess.TimeoutExpired:
                p.kill()
                text = p.communicate()[0] + "\nPROBE hung"
            lines = [ln[6:] for ln in text.splitlines() if ln.startswith("PROBE ")]
            seen.append(lines[-1] if lines else f"the process died (exit {p.returncode})")
        out[call] = seen[0] if seen[0] == seen[1] else " / ".join(seen)
    return out


def rank_worker(rank: int, world: int, store: str, out_dir: str) -> int:
    """One rank of phase 13 (i): ``chip_smoke.py --rank-worker``, with the
    problem, the sizes and the device the parent wrote to ``config.json``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import restore, save_engine_checkpoint
    from repro_torch.kernels import ops
    from repro_torch.obs import profile_supertick
    from repro_torch.sim import CDUpdate, make_engine, partition_graph

    global DYN_GU, DYN_ARRIVALS, RANK_SERVE
    out = Path(out_dir)
    cfg = json.loads((out / "config.json").read_text())
    c, rk, dev = cfg["main"], cfg["ranks"], torch.device(cfg["device"])
    DYN_GU, DYN_ARRIVALS, RANK_SERVE = cfg["dyn_gu"], cfg["dyn_arrivals"], cfg["rank_serve"]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    try:
        report = {}
        t0 = time.perf_counter()
        obj = quadratic_rgg_problem(c["n"], c["p"], c["m"], c["avg_degree"], c["mu"], c["seed"],
                                    mix_mode="sparse")
        part = partition_graph(obj.graph, world, mode=rk["partition_mode"],
                               relabel=rk["relabel"])
        report["setup_s"] = time.perf_counter() - t0
        for leg in RANK_LEGS:
            def make():
                return make_engine(CDUpdate(obj), shards=world, partition=part, device=dev,
                                   **_rank_engine_kw(leg, c))

            eng = make()
            r = dict(rank=eng.rank, fused=bool(eng.fused), method=eng.exchange_method,
                     capture_mode=eng.capture_mode, staged=eng.smix.collective.staged)
            state = eng.init_state(np.zeros((obj.n, obj.p), np.float32))
            ops.reset_launch_counts()
            for mask in _rank_masks(c, rk):
                state = eng.step(state, mask)
            sync()
            r["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
            np.savez(out / f"{leg}_rank{rank}.npz", **_leaves(state))
            # A per-rank save, restored into a fresh rank engine; both advance.
            entry = save_engine_checkpoint(eng, state, str(out / f"ckpt_{leg}"))
            fresh = make()
            back, step = restore(fresh, entry)
            ops.reset_launch_counts()
            a = eng._eager_slots(state, rk["slots"])
            b = fresh._eager_slots(back, rk["slots"])
            sync()
            resume = {k: v for k, v in ops.launch_counts().items() if v}
            la, lb = _leaves(a), _leaves(b)
            r["resume_equal"] = step == rk["slots"] and all(
                np.array_equal(la[k], lb[k]) for k in la)
            r["resume_launches"] = resume
            # The per-rank slot time: eager (the exchange is staged on the host).
            times = []
            for _ in range(rk["timed_windows"]):
                dist.barrier()
                sync()
                t1 = time.perf_counter()
                a = eng._eager_slots(a, rk["timed_slots"])
                sync()
                times.append((time.perf_counter() - t1) * 1e3 / rk["timed_slots"])
            r["ms_per_slot"] = spread(times)
            report[leg] = r
            del eng, fresh, state, back, a, b
            gc.collect()
        # (iii) dynamic topology: no kernel of ours may launch
        arrival, _seed = dynamic_arrivals(obj.graph)
        eng = make_engine(CDUpdate(obj), shards=world, device=dev, **_dyn_rank_kw(c, arrival))
        ops.reset_launch_counts()
        state, secs = _dyn_sequence(eng, c, sync)
        np.savez(out / f"dynamic_rank{rank}.npz", **_leaves(state))
        report["dynamic"] = dict(seconds=secs, log=dict(eng.topology_log), csr=eng._csr.digest(),
                                 launches={k: v for k, v in ops.launch_counts().items() if v},
                                 method=eng.exchange_method, capture_mode=eng.capture_mode)
        del eng, state
        gc.collect()
        # (iv) serving the sharded_fused ranks
        eng = make_engine(CDUpdate(obj), shards=world, partition=part, device=dev,
                          **_rank_engine_kw("sharded_fused", c))
        state = eng.init_state(np.zeros((obj.n, obj.p), np.float32))
        ops.reset_launch_counts()
        report["serving"], state = _rank_serving(eng, state, sync)
        report["serving"]["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
        prof = profile_supertick(eng, state)
        report["coverage"] = dict(coverage=prof.coverage, phases_us={
            k: v * 1e6 for k, v in prof.phases.items()}, measured_us=prof.measured_s * 1e6)
        del eng, state
        gc.collect()
        # (v) the phase prefixes, every agent waking
        report["phases"] = {}
        for leg in ("sharded_fused", "sharded_unfused"):
            eng = make_engine(CDUpdate(obj), shards=world, partition=part, device=dev,
                              **_phase_rank_kw(leg, c))
            state = eng.init_state(_phase_theta(c))
            report["phases"][leg] = dict(hashes=_prefix_hashes(eng, state),
                                         names=list(eng.phase_names), batch=eng.batch_size)
            del eng, state
            gc.collect()
    finally:
        dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(report, default=str))
    return 0


def _nccl_serving(cap, stk, state) -> dict:
    """(ii)'s serving read on the handle's own one-rank NCCL group: a
    trainer thread runs ``RANK_SERVE["window"]`` captured slots through
    ``run(snapshot_every=16, serve=handle)`` (the engine group's NCCL
    chunks) while this thread issues ``RANK_SERVE["requests"]`` of phase
    4c's batches (the handle group's NCCL reads), each on a pinned
    snapshot and held against :func:`_rank_recompute` of it; then the
    final state published on this handle and its models on a handle of
    the stacked S = 1 engine, whose ``predict`` and ``rows`` it must
    equal. Returns the checks, p50 and p99 ms and the state reached."""
    import threading

    import numpy as np

    from repro_torch.serve import ServeHandle

    E = SERVE["snapshot_every"]
    handle = ServeHandle.for_engine(cap)
    batches, neighbors = _serve_batches(cap.n, cap.p, np.random.default_rng(5))
    box = {}

    def train():
        box["result"] = cap.run(None, RANK_SERVE["window"], state=state, serve=handle,
                                snapshot_every=E)

    first = cap._ptr_of(state)
    trainer = threading.Thread(target=train, name="trainer")
    trainer.start()
    lat, equal = [], True
    for i in range(RANK_SERVE["requests"]):
        while not handle.published or handle.version < first:
            time.sleep(1e-4)
        ids, X = batches[i % len(batches)]
        t1 = time.perf_counter()
        snap = handle.snapshot()
        res = handle.predict(ids, X, neighbors=neighbors, at=snap)
        lat.append(time.perf_counter() - t1)
        want = _rank_recompute(handle._reads, snap, ids, X, neighbors)
        equal &= bool(np.array_equal(res.values, want))
    trainer.join()
    if "result" not in box:
        raise SystemExit("phase 13 (ii): the serving leg's trainer thread failed")
    state = box["result"].state
    version = cap._ptr_of(state)
    stacked = ServeHandle.for_engine(stk)
    handle.publish(state, version=version)
    stacked.publish(stk.init_state(cap.global_theta(state)), version=version)
    ids, X = batches[0]
    got, want = (h.predict(ids, X, neighbors=neighbors) for h in (handle, stacked))
    rows = [h.rows(ids, neighbors=neighbors) for h in (handle, stacked)]
    final = dict(predict=bool(np.array_equal(got.values, want.values)),
                 rows=bool(np.array_equal(rows[0].values, rows[1].values)),
                 version=bool(got.version == want.version == rows[0].version == version))
    if not (equal and all(final.values())):
        raise SystemExit(f"phase 13 (ii): serving on NCCL, answers == recomputed {equal}, "
                         f"== the stacked handle {final}")
    lat = np.asarray(lat)
    return dict(requests=int(lat.size), equal=equal, stacked=final,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                snapshots=handle.counters()["serve_snapshots_published"]), state


def _nccl_leg(obj, dev, card: str) -> dict:
    """(ii) The fused leg at S = 1 on a one-rank NCCL group (a "shards"
    DeviceMesh of one card): the captured chunk, the eager slots and the
    stacked S = 1 engine (its generator set to the rank's state) must
    give the same bits; then the captured slot's time."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ops
    from repro_torch.obs import profile_supertick
    from repro_torch.sim import CDUpdate, EngineConfig, ShardedAsyncEngine, partition_graph
    from repro_torch.sim.capture import clone_state, prefix_shards

    part = partition_graph(obj.graph, 1, mode=RANKS["partition_mode"], relabel=RANKS["relabel"])
    kw = dict(_rank_engine_kw("sharded_fused", MAIN), partition=part, device=dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("shards",))
        cfg = EngineConfig(devices=mesh, **kw)
        cap = ShardedAsyncEngine(CDUpdate(obj), num_shards=1, config=cfg)
        eag = ShardedAsyncEngine(CDUpdate(obj), num_shards=1, config=cfg)
        stk = ShardedAsyncEngine(CDUpdate(obj), num_shards=1, **kw)
        if cap.rank != 0 or cap.capture_mode != "captured" or stk.rank is not None:
            raise SystemExit(f"phase 13 (ii): rank {cap.rank}, {cap.capture_mode}")
        Theta0 = np.zeros((obj.n, obj.p), np.float32)
        sc, se, ss = (e.init_state(Theta0) for e in (cap, eag, stk))
        ss.generator.set_state(sc.generator.get_state())
        ops.reset_launch_counts()
        sc = cap.advance(sc, RANKS["slots"])
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        se = eag._eager_slots(se, RANKS["slots"])
        ss = stk._eager_slots(ss, RANKS["slots"])
        lc, le, ls = _leaves(sc), _leaves(se), _leaves(ss)
        equal = all(np.array_equal(lc[k], le[k]) and np.array_equal(lc[k], ls[k]) for k in lc)
        gathered = np.array_equal(cap.global_theta(sc), stk.global_theta(ss))
        if not (equal and gathered and launches.get("fused_row_update", 0) > 0):
            raise SystemExit(f"phase 13 (ii): captured == eager == stacked {equal}, "
                             f"global_theta {gathered}, launches {launches}")
        times = []
        for _ in range(RANKS["nccl_windows"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sc = cap.advance(sc, RANKS["nccl_slots"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / RANKS["nccl_slots"])
        timed = {k: v for k, v in ops.launch_counts().items() if v}
        # Each phase prefix captured (the program) against the same prefix
        # run eagerly on a clone of the state (the generator's position too).
        prefix_equal = {}
        for upto in list(cap.phase_names) + [None]:
            got = prefix_shards(cap, upto, cap.phase_program(upto)(sc))
            want = prefix_shards(cap, upto, cap._slot(clone_state(sc), None, upto=upto))
            prefix_equal[str(upto)] = len(got) == len(want) and all(
                torch.equal(g, w) for (g, _), (w, _) in zip(got, want))
        prof = profile_supertick(cap, sc)
        if not all(prefix_equal.values()) or not \
                PHASE_COVERAGE[0] <= prof.coverage <= PHASE_COVERAGE[1]:
            raise SystemExit(f"phase 13 (ii): captured prefixes == eager {prefix_equal}, coverage "
                             f"{prof.coverage:.4f} outside {PHASE_COVERAGE}")
        serving, sc = _nccl_serving(cap, stk, sc)
    finally:
        dist.destroy_process_group()
    out = dict(equal_bits=True, launches=launches, timed_launches=timed,
               ms_per_slot=spread(times), backend="nccl", capture_mode=cap.capture_mode,
               prefixes_equal=prefix_equal, coverage=prof.coverage,
               phases_us={k: v * 1e6 for k, v in prof.phases.items()}, serving=serving)
    log(f"[13] (ii) on {card}: one-rank NCCL, S = 1 fused, captured == eager == stacked S = 1 "
        f"for {RANKS['slots']} slots, bit for bit; launches {launches}; ms a slot (captured, "
        f"{RANKS['nccl_windows']} windows of {RANKS['nccl_slots']}) {fmt(out['ms_per_slot'])}; "
        f"each phase prefix captured == eager bit for bit; phase coverage {prof.coverage:.4f} "
        f"(us a phase {fmt(out['phases_us'])}); serving on the handle's NCCL group beside the "
        f"captured trainer: {serving['requests']} requests == recomputed, the final "
        f"publication's predict and rows == the stacked handle's, p50 "
        f"{serving['p50_ms']:.3f} ms, p99 {serving['p99_ms']:.3f} ms a batch of "
        f"{SERVE['batch']}")
    return out


def rank_engines(dev, launches: dict, card: str) -> dict:
    """Phase 13: (i) two gloo ranks on the card against the stacked S = 2
    engine run here, (ii) the one-rank NCCL leg. Any worker failure fails
    the run; nothing falls back to the CPU or to the stacked engine."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.sim import CDUpdate, ShardedAsyncEngine, partition_graph

    t0 = time.perf_counter()
    world = RANKS["shards"]
    out_dir = ROOT / "build" / "rank13"
    if out_dir.exists():
        import shutil

        shutil.rmtree(out_dir)
    out_dir.mkdir(parents=True)
    store = out_dir / "store"
    (out_dir / "config.json").write_text(json.dumps({
        "main": MAIN, "ranks": RANKS, "device": str(dev), "dyn_gu": DYN_GU,
        "dyn_arrivals": DYN_ARRIVALS, "rank_serve": RANK_SERVE}))
    env = dict(os.environ, OMP_NUM_THREADS="2")
    probes = gloo_probes_start(out_dir) if dev.type == "cuda" else {}
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank-worker",
                               str(r), str(world), str(store), str(out_dir)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        c = MAIN
        obj = quadratic_rgg_problem(c["n"], c["p"], c["m"], c["avg_degree"], c["mu"], c["seed"],
                                    mix_mode="sparse")
        part = partition_graph(obj.graph, world, mode=RANKS["partition_mode"],
                               relabel=RANKS["relabel"])
        stacked = {}
        for leg in RANK_LEGS:
            eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=world, partition=part, device=dev,
                                     **_rank_engine_kw(leg, c))
            state = eng.init_state(np.zeros((obj.n, obj.p), np.float32))
            for mask in _rank_masks(c, RANKS):
                state = eng.step(state, mask)
            stacked[leg] = (eng, _leaves(state))
        # (iii) and (v) on stacked S = 2 engines, while the ranks run theirs
        arrival, _seed = dynamic_arrivals(obj.graph)
        dyn = ShardedAsyncEngine(CDUpdate(obj), num_shards=world, device=dev,
                                 **_dyn_rank_kw(c, arrival))
        state, dyn_secs = _dyn_sequence(dyn, c, torch.cuda.synchronize
                                        if dev.type == "cuda" else (lambda: None))
        dyn_want = dict(leaves=_leaves(state), csr=dyn._csr.digest(), log=dict(dyn.topology_log),
                        seconds=dyn_secs)
        del dyn, state
        gc.collect()
        prefix_want = {}
        for leg in ("sharded_fused", "sharded_unfused"):
            eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=world, partition=part, device=dev,
                                     **_phase_rank_kw(leg, c))
            prefix_want[leg] = _prefix_hashes(eng, eng.init_state(_phase_theta(c)))
            del eng
            gc.collect()
        texts = []
        for p in procs:
            try:
                texts.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                raise SystemExit(f"phase 13: a rank worker gave no result in {RANK_TIMEOUT_S} s")
        for r, (p, text) in enumerate(zip(procs, texts)):
            if p.returncode != 0 or not (out_dir / f"rank{r}.json").exists():
                raise SystemExit(f"phase 13 rank worker {r} failed ({p.returncode}): "
                                 f"{text[-3000:]}")
        gloo_cuda = gloo_probes_read(probes)
    finally:
        for p in procs + [q for pair in probes.values() for q in pair]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    reports = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]
    result = {"gloo_cuda": gloo_cuda, "worker_setup_s": [
        r["setup_s"] for r in reports], "legs": {}}
    for leg in RANK_LEGS:
        eng, want = stacked[leg]
        legr = {"ranks": [rep[leg] for rep in reports]}
        equal, diff = True, 0.0
        for r in range(world):
            got = dict(np.load(out_dir / f"{leg}_rank{r}.npz"))
            for k, v in want.items():
                same = np.array_equal(v[r:r + 1], got[k])
                equal &= same
                if not same and v.dtype.kind == "f":
                    diff = max(diff, float(np.abs(v[r:r + 1] - got[k]).max()))
        legr["equal_bits"], legr["max_abs_diff"] = bool(equal), diff
        fused_ok = all(rep["launches"].get("fused_row_update", 0) > 0 and
                       rep["resume_launches"].get("fused_row_update", 0) > 0
                       for rep in legr["ranks"]) if leg != "sharded_unfused" else True
        for rep in legr["ranks"]:
            for k, v in rep["launches"].items():
                launches[k] = launches.get(k, 0) + v
        resume_ok = all(rep["resume_equal"] for rep in legr["ranks"])
        legr.update(fused_launches_ok=fused_ok, resume_equal=resume_ok)
        if not (equal and fused_ok and resume_ok):
            raise SystemExit(f"phase 13 (i) {leg}: ranks == stacked S = 2 {equal} (max |diff| "
                             f"{diff}), fused launches in every rank {fused_ok}, per-rank resume "
                             f"{resume_ok}: {legr['ranks']}")
        # The stacked S = 2 leg's slot time on the card (captured chunk),
        # the workers done: the card is this process's alone.
        st = eng.init_state(np.zeros((obj.n, obj.p), np.float32))
        st = eng.advance(st, WARM_STEPS)
        times = []
        ops.reset_launch_counts()
        for _ in range(RANKS["timed_windows"]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st = eng.advance(st, RANKS["nccl_slots"])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3 / RANKS["nccl_slots"])
        legr["stacked_ms_per_slot"] = spread(times)
        result["legs"][leg] = legr
        ranks_ms = [fmt(rep["ms_per_slot"]) for rep in legr["ranks"]]
        log(f"[13] (i) {leg} on {card}: 2 gloo ranks on one card (host-staged wire, not a "
            f"multi-card figure) == stacked S = 2 for {RANKS['slots']} forced slots, bit for bit; "
            f"per-rank resume after a per-rank save equal {resume_ok}; method "
            f"{legr['ranks'][0]['method']}, {legr['ranks'][0]['capture_mode']}; launches "
            f"{[rep['launches'] for rep in legr['ranks']]}; per-rank ms a slot (eager) "
            f"{ranks_ms}; stacked S = 2 ms a slot (captured) {fmt(legr['stacked_ms_per_slot'])}")
        del eng, st
        stacked[leg] = None
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[13] gloo collectives on CUDA tensors (torch {torch.__version__}): "
        f"{result['gloo_cuda']}")
    result.update(_rank_dynamic_gate(reports, dyn_want, out_dir, card),
                  serving=_rank_serving_gate(reports, card),
                  phases=_rank_phase_gate(reports, prefix_want, card))
    for rep in reports:
        for k, v in rep["serving"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    result["nccl"] = _nccl_leg(obj, dev, card)
    for k, v in result["nccl"]["launches"].items():
        launches[k] = launches.get(k, 0) + v
    result["seconds"] = time.perf_counter() - t0
    return result


def _rank_dynamic_gate(reports, want: dict, out_dir: Path, card: str) -> dict:
    """(iii)'s gates: every rank's owned rows, flags and counters, its live
    CSR (sha256) and topology log equal the stacked S = 2 engine's, and no
    kernel of ours launched; prints each call's host seconds by rank."""
    import numpy as np

    equal, csr, launched = True, True, {}
    for r, rep in enumerate(reports):
        got = dict(np.load(out_dir / f"dynamic_rank{r}.npz"))
        equal &= all(np.array_equal(v[r:r + 1], got[k]) for k, v in want["leaves"].items())
        d = rep["dynamic"]
        csr &= d["csr"] == want["csr"] and d["log"] == want["log"]
        launched.update({f"rank{r}:{k}": v for k, v in d["launches"].items()})
    out = dict(equal_bits=bool(equal), csr_equal=bool(csr), launches=launched,
               log=want["log"], seconds=[rep["dynamic"]["seconds"] for rep in reports],
               stacked_seconds=want["seconds"], method=reports[0]["dynamic"]["method"])
    log(f"[13] (iii) dynamic on {card}: 2 gloo ranks == stacked S = 2 (37 forced slots, a refresh, "
        f"{out['log']['arrivals']} arrivals admitted, 37 forced slots, a forced repartition): "
        f"owned rows, flags, counters equal {out['equal_bits']}, live CSR and topology log equal "
        f"{out['csr_equal']}; log {fmt(out['log'])}; launches of ours {launched or 'none'}; host "
        f"s by rank {[fmt(s) for s in out['seconds']]}; stacked {fmt(out['stacked_seconds'])}")
    if not (equal and csr) or launched:
        raise SystemExit(f"phase 13 (iii): ranks == stacked {equal}, CSR and log {csr}, "
                         f"launches {launched}")
    return {"dynamic": out}


def _rank_serving_gate(reports, card: str) -> dict:
    """(iv)'s gates on every rank: the checked answers equal their
    recomputation, phase 4c's lag limits; prints p50, p99, predictions/s."""
    out = [rep["serving"] for rep in reports]
    for r, s in enumerate(out):
        scalars = {k: v for k, v in s.items() if not isinstance(v, (list, dict))}
        log(f"[13] (iv) serving rank {r} on {card}: sharded_fused, {RANK_SERVE['window']}-slot "
            f"windows off and on in turns, snapshot_every={SERVE['snapshot_every']}, batch "
            f"{SERVE['batch']}: {fmt(scalars)} slots/s off "
            f"{[round(x, 2) for x in s['slots_per_s_off']]} on "
            f"{[round(x, 2) for x in s['slots_per_s_on']]}")
        if not (s["equal"] and s["checked"] >= RANK_SERVE["turns"] and s["start_ok"]
                and s["end_ok"]):
            raise SystemExit(f"phase 13 (iv) rank {r}: answers equal {s['equal']} ({s['checked']} "
                             f"checked), start lag {s['version_lag_start_max']} within "
                             f"{SERVE['snapshot_every']} {s['start_ok']}, end lag within its limit "
                             f"{s['end_ok']} ({s['end_over_limit_max']:.3f} of it)")
    return {"ranks": out}


def _rank_phase_gate(reports, want: dict, card: str) -> dict:
    """(v)'s gate: every phase prefix's output on each rank equals the
    stacked S = 2 engine's shard (sha256 leaf by leaf); prints the ranks'
    phase coverage (not gated: an eager rank is host-bound)."""
    out = {}
    for leg, stacked in want.items():
        equal = {}
        for upto, leaves in stacked.items():
            equal[upto] = all(
                len(rep["phases"][leg]["hashes"][upto]) == len(leaves) and all(
                    (g[0] == w[r]) if isinstance(w, list) else (g == w)
                    for g, w in zip(rep["phases"][leg]["hashes"][upto], leaves))
                for r, rep in enumerate(reports))
        out[leg] = equal
        if not all(equal.values()):
            raise SystemExit(f"phase 13 (v) {leg}: prefixes on the ranks == stacked {equal}")
    cov = [rep["coverage"] for rep in reports]
    log(f"[13] (v) phase prefixes on {card}: every prefix of sharded_fused and sharded_unfused "
        f"(every agent waking) on each gloo rank == the stacked S = 2 engine's shard, bit for bit; "
        f"the ranks' phase coverage (eager, host-bound, not gated) "
        f"{[round(x['coverage'], 4) for x in cov]}, us a phase "
        f"{[fmt(x['phases_us']) for x in cov]}")
    return {"equal": out, "coverage": cov}


def memory(when: str) -> None:
    """Print what the card holds allocated and reserved."""
    import torch

    log(f"[mem] {when}: allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB, "
        f"reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB")


def _counted(label, fn, launches):
    """``fn()`` with the launch counts reset before it and read after
    (added into ``launches``); a label of ``PATH_KERNEL`` must launch each
    of its kernels. Returns the result, the seconds and the counts."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    missing = [k for k in _path_kernels(label) if counts.get(k, 0) <= 0] \
        if label in PATH_KERNEL else []
    if missing:
        raise SystemExit(f"{label}: {missing} not launched ({counts})")
    return res, secs, {k: v for k, v in counts.items() if v}


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
    phase_s, last = {}, [time.perf_counter()]

    def mark(label: str) -> None:
        """Print and keep the command seconds of the phase just ended."""
        now = time.perf_counter()
        phase_s[label] = now - last[0]
        last[0] = now
        log(f"[time] {label}: {phase_s[label]:.1f} s")

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
    mark("1-2 card and build")

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

    mark("4 set-up")

    # [3] kernel checks (these launches are not the main path's)
    results: dict = {}
    kernel_checks(obj, engines["fused"], dense_obj, results)
    sharded_kernel_check(obj, engines["sharded_fused"], results)
    ssm_chunk_checks(dev, results)

    mark("3 kernel checks")

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

    mark("4 main path")

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

    mark("4c checkpoints and serving")

    # [4d] dynamic topology: a refresh and an admission in 800 slots of
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
    covered = {k for label in PATH_KERNEL if not label.startswith("bench_")
               for k in _path_kernels(label)}
    missing = [k for k in _build.KERNELS if k not in covered]
    if missing:
        raise SystemExit(f"no path of phase 4 launches {missing}")

    mark("4d dynamic topology")

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

    mark("5 parity")

    # [6] zamba2-1.2b serving: the prefill's counts are reset before each
    # prefill and read after it
    serve = zamba2_serve(dev, launches)

    mark("6 zamba2 serving")

    # [7] the paper benches on the card, and the dynamic-topology bench
    benches = paper_benches(dev)
    benches["dynamic_topology"] = dynamic_bench()
    benches.update(checkpoint_benches(dev))
    mark("7 paper benches")

    # [8] the phase attribution of the main path's captured slots, then
    # the engine benches (bench.run's full sizes) and the examples, with
    # the earlier phases' engines and states freed first
    phases = main_path_phases(engines)
    del engines, states, obj, dp_obj, dense_obj, part, sh, eng, run, o
    memory("before the engine benches")
    engine = engine_benches(dev, launches)
    engine["rgg500k_p100_phases"] = phases
    mark("8 engine benches and examples")

    # [9] zamba2-1.2b P2P-DP training, the earlier phases' memory released:
    # each round's counts are reset before it and read after it
    train = zamba2_train(dev, launches, smi, results["ssm_chunk_train"])
    mark("9 zamba2 P2P training")

    # [10] the transformer families, phase 9's memory released: llama3.2-1b
    # served and trained, granite-moe, chameleon (4 layers) and seamless
    # served, the float32 routes; no kernel of ours may launch
    gc.collect()
    torch.cuda.empty_cache()
    families = transformer_families(dev, launches, smi)
    mark("10 transformer families")

    # [11] the xLSTM family, phase 10's memory released: xlstm-1.3b served
    # and trained, the float32 routes; no kernel of ours may launch. Phase
    # 12's dry-run starts first, in subprocesses on the host's other cores
    # (its xlstm-1.3b training row traces for minutes on a CPU)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_procs = dryrun_start(ROOT / "build" / "dryrun")
    xl = xlstm_family(dev, launches, smi)
    mark("11 xLSTM family")

    # [12] the mesh and launch layer, phase 11's memory released: the
    # llama3.2-1b round on a (1, 1) mesh against the stacked round, and the
    # dry-run's rows and gates; no kernel of ours may launch
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_layer(dev, launches, smi, dryrun_procs)
    mark("12 mesh and launch layer")

    # [13] the sharded engine one shard a process: two gloo ranks on the
    # card against the stacked S = 2 engine, and a one-rank NCCL group
    gc.collect()
    torch.cuda.empty_cache()
    ranks = rank_engines(dev, launches, smi)
    mark("13 sharded engine one shard a process")

    # [14] the kernel table and the result
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
                    "fused_row_update_gathered": results["fused_row_update_gathered"],
                    "fused_row_update_sharded": results["fused_row_update_sharded"],
                    "dp_clip_noise_bf16": results["dp_clip_noise_bf16"],
                    "ssm_chunk_bf16": results["ssm_chunk_bf16"]}))
    log(json.dumps({"zamba2_serve": serve}))
    log(json.dumps({"paper_benches": benches}))
    log(json.dumps({"engine_benches": engine}, default=str))
    log(json.dumps({"zamba2_train": train, "ssm_chunk_train": results["ssm_chunk_train"]}))
    log(json.dumps({"transformer_families": families}))
    log(json.dumps({"xlstm": xl}))
    log(json.dumps({"mesh_layer": mesh}))
    log(json.dumps({"rank_engines": ranks}))
    log(json.dumps({"phase_seconds": phase_s, "total_s": sum(phase_s.values())}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:  # phase 13's ranks
        sys.exit(rank_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--gloo-probe"]:  # phase 13's probes of gloo on CUDA tensors
        sys.exit(gloo_probe_worker(sys.argv[2], int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())

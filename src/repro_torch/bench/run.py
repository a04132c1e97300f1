"""Bench entry point of the port: the ported benches in the reference's order.

Port of ``benchmarks/run.py`` over the benches ``repro_torch.bench``
holds, registered in the reference's order (``roofline``, last, formats
the LLM dry-run's rows: ``results/dryrun_torch.jsonl`` from
``python -m repro_torch.launch.dryrun``):

    python -m repro_torch.bench.run                 # fast sizes (the reference's)
    python -m repro_torch.bench.run --full          # the reference's full sizes
    python -m repro_torch.bench.run --list          # the bench names
    python -m repro_torch.bench.run --only obs      # one bench

Prints ``name,us_per_call,derived`` lines, one per bench (its wall time
and its headline), plus the rows the reference also keeps (the kernel,
sharded-engine, obs, dynamic-topology, checkpoint and serving rows), and
merges them into ``results/BENCH_torch_summary.json`` (``--out``) in the
reference's ``name -> {us_per_call, derived}`` form. The JAX package's
``BENCH_summary.json`` is never written. ``--device`` as every runner's
(the card unless ``cpu`` is asked for). Every bench runs in this process:
the port needs no forced host devices.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.bench import SUMMARY

# Each bench's (fast, full) arguments: the reference's ``kw`` in
# ``benchmarks/run.py``. The obs bench keeps a loaded slot (>= 2048 wakes)
# at the fast size too: its overhead divides a small metrics delta by the
# slot time.
SIZES = {
    "fig1": (dict(n=30, p=20, T_cd=800, T_admm=80), {}),
    "sparse_scale": (dict(n=5_000, ticks=200), dict(n=100_000, ticks=2_000)),
    "async_engine": (dict(n=20_000, slots=4, slot_wakes=512.0),
                     dict(n=500_000, slots=12, slot_wakes=4096.0)),
    "sharded_engine": (dict(n=100_000, shards=8, slots=4, slot_wakes=2048.0),
                       dict(n=1_000_000, shards=8, slots=8, slot_wakes=8192.0)),
    "obs": (dict(n=50_000, shards=8, slots=6, slot_wakes=2048.0),
            dict(n=200_000, shards=8, slots=8, slot_wakes=4096.0)),
    "dynamic_topology": (dict(n=20_000, shards=8), dict(n=200_000, shards=8)),
    "checkpoint": (dict(n=20_000, shards=8), dict(n=200_000, shards=8)),
    "serving": (dict(n=100_000, shards=8, slots=4, slot_wakes=2048.0, batch=512),
                dict(n=1_000_000, shards=8, slots=6, slot_wakes=8192.0, batch=1024)),
}


def _bench_fig1(full, dev, rows, record):
    from repro_torch.bench import cd_vs_admm

    t0 = time.perf_counter()
    r = cd_vs_admm.run(verbose=False, device=dev, **SIZES["fig1"][full])
    record("fig1_cd_vs_admm", t0, f"cd_beats_admm_per_message={r['cd_beats_admm_per_message']}")


def _bench_fig2(full, dev, rows, record):
    from repro_torch.bench import privacy_utility

    t0 = time.perf_counter()
    r = privacy_utility.run(fast=not full, verbose=False, device=dev)
    acc = r["fig2c"][-1]
    record("fig2_privacy_utility", t0,
           f"acc_local={acc['acc_local']:.3f},acc_nonpriv={acc['acc_nonprivate']:.3f}")


def _bench_table1(full, dev, rows, record):
    from repro_torch.bench import movielens

    t0 = time.perf_counter()
    r = movielens.run(fast=not full, verbose=False, device=dev)
    record("table1_movielens", t0, f"rmse_local={r['rmse_local']:.3f},rmse_cd={r['rmse_cd']:.3f}")


def _bench_ablations(full, dev, rows, record):
    from repro_torch.bench import ablations

    t0 = time.perf_counter()
    r = ablations.run(fast=not full, verbose=False, device=dev)
    record("ablations", t0,
           f"personalized={r['personalization']['acc_personalized']:.3f},"
           f"global={r['personalization']['acc_global']:.3f}")


def _bench_kernels(full, dev, rows, record):
    from repro_torch.bench import kernels

    t0 = time.perf_counter()
    ks = kernels.run(device=dev, verbose=False)
    rows.extend(ks)
    record("kernels", t0, f"{len(ks)} kernels timed")


def _bench_sparse_scale(full, dev, rows, record):
    from repro_torch.bench import sparse_scale

    t0 = time.perf_counter()
    kw = SIZES["sparse_scale"][full]
    ss = sparse_scale.run(verbose=False, device=dev, **kw)
    tick_us = next(v for name, v, _ in ss if name == "sparse_cd_tick")
    record("sparse_scale", t0, f"n={kw['n']},us_per_seq_tick={tick_us:.3g}")


def _bench_async_engine(full, dev, rows, record):
    from repro_torch.bench import async_engine

    t0 = time.perf_counter()
    kw = SIZES["async_engine"][full]
    ae = async_engine.run(churn=True, verbose=False, device=dev, **kw)
    rate = next(v for name, v, _ in ae if name == "async_equiv_ticks_per_s")
    record("async_engine", t0, f"n={kw['n']},churn=1,equiv_ticks_per_s={rate:.4g}")


def _bench_sharded_engine(full, dev, rows, record):
    from repro_torch.bench import sharded_engine

    t0 = time.perf_counter()
    kw = SIZES["sharded_engine"][full]
    sub = sharded_engine.run(verbose=False, device=dev, **kw)
    rows.extend(sub)
    rate = next(v for name, v, _ in sub if name == "sharded_equiv_ticks_per_s")
    record("sharded_engine", t0, f"n={kw['n']},shards=8,equiv_ticks_per_s={rate:.4g}")


def _bench_obs(full, dev, rows, record):
    from repro_torch.bench import obs

    t0 = time.perf_counter()
    kw = SIZES["obs"][full]
    sub = obs.run(verbose=False, device=dev, **kw)
    rows.extend(sub)
    over = next(v for name, v, _ in sub if name == "obs_overhead")
    record("obs", t0, f"n={kw['n']},shards=8,overhead_pct={over:.3g}")


def _bench_dynamic_topology(full, dev, rows, record):
    from repro_torch.bench import dynamic_topology

    t0 = time.perf_counter()
    kw = SIZES["dynamic_topology"][full]
    dt = dynamic_topology.run(verbose=False, **kw)
    rows.extend(dt)
    speedup = next(v for name, v, _ in dt if name == "dyntopo_patch_speedup")
    record("dynamic_topology", t0, f"n={kw['n']},patch_speedup={speedup:.3g}")


def _bench_checkpoint(full, dev, rows, record):
    from repro_torch.bench import checkpoint

    t0 = time.perf_counter()
    kw = SIZES["checkpoint"][full]
    sub = checkpoint.run(verbose=False, device=dev, **kw)
    rows.extend(sub)
    save_s = next(v for name, v, _ in sub if name == "ckpt_save_s")
    nbytes = next(v for name, v, _ in sub if name == "ckpt_bytes")
    record("checkpoint", t0, f"n={kw['n']},shards=8,save_s={save_s:.3g},bytes={int(nbytes)}")


def _bench_serving(full, dev, rows, record):
    from repro_torch.bench import serving

    t0 = time.perf_counter()
    kw = SIZES["serving"][full]
    sub = serving.run(verbose=False, device=dev, **kw)
    rows.extend(sub)
    rate = next(v for name, v, _ in sub if name == "serving_predictions_per_s")
    record("serving", t0,
           f"n={kw['n']},shards=8,batch={kw['batch']},predictions_per_s={rate:.4g}")


def _bench_roofline(full, dev, rows, record):
    from repro_torch.bench import roofline

    t0 = time.perf_counter()
    rs = roofline.run()
    if not rs:
        # No dry-run rows: say so (run() did) and record nothing.
        return
    record("roofline", t0, f"{len(rs)} dry-run rows")


# Registration order is execution order, the reference's; roofline stays
# last so its dry-run rows print after the measured ones they contextualize.
BENCHES = {
    "fig1": _bench_fig1,
    "fig2": _bench_fig2,
    "table1": _bench_table1,
    "ablations": _bench_ablations,
    "kernels": _bench_kernels,
    "sparse_scale": _bench_sparse_scale,
    "async_engine": _bench_async_engine,
    "sharded_engine": _bench_sharded_engine,
    "obs": _bench_obs,
    "dynamic_topology": _bench_dynamic_topology,
    "checkpoint": _bench_checkpoint,
    "serving": _bench_serving,
    "roofline": _bench_roofline,
}


def main(argv=None) -> int:
    """CLI entry point; returns the exit code."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="the reference's full sizes")
    ap.add_argument("--only", default=None, metavar="NAME", help="run a single bench (see --list)")
    ap.add_argument("--list", action="store_true", help="list bench names and exit")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    ap.add_argument("--out", default=str(SUMMARY), help="summary JSON to merge the rows into")
    args = ap.parse_args(argv)

    if args.list:
        for name in BENCHES:
            print(name)
        return 0
    if args.only is not None and args.only not in BENCHES:
        print(f"unknown bench {args.only!r}; valid names: {', '.join(BENCHES)}", file=sys.stderr)
        return 2

    from repro_torch.obs.report import merge_bench_summary

    rows = []

    def record(name, t0, derived):
        us = (time.perf_counter() - t0) * 1e6
        rows.append((name, us, derived))
        print(f"{name},{us:.0f},{derived}", flush=True)

    for name, bench in BENCHES.items():
        if args.only in (None, name):
            bench(args.full, args.device, rows, record)
    merge_bench_summary(args.out, rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Sharded async-engine scale bench on the port: S agent blocks stacked on one card.

Port of ``benchmarks/bench_sharded_engine.py``. The reference shards the
agents across S devices under ``shard_map``; the port's
:class:`repro_torch.sim.ShardedAsyncEngine` stacks the S shards on one
device, as it always runs (no host devices to force, no subprocess).
Per-shard wake batches, the halo exchange of the start-of-slot border
rows and shard-local gather/mix/scatter run as one stacked slot (on the
card with ``fused="auto"``: one ``fused_row_update`` launch over the
slab). The bench asserts no O(n^2) array exists, reports the partition
and communication stats beside the super-tick and
equivalent-sequential-tick rates, and places the slot on the roofline
(:func:`repro_torch.obs.roofline.supertick_report`, counted bytes).

Communication sweep (:func:`exchange_stats`, pure numpy, the reference's
rows exactly): for {no relabel, RCM} x {all_gather, p2p} the halo
fraction and the bytes shipped a super-tick at f32 and bf16. The timed
run uses ``--relabel``/``--exchange`` (default RCM + auto) and reuses the
sweep's partition.

    python -m repro_torch.bench.sharded_engine [--n 1000000] [--shards 8] [--slots 8] [--slot-wakes 8192] [--device D] [--fast] [--out PATH]

``--fast`` is the reference runner's fast size (n = 100,000, 4 slots,
2048 wakes a slot). The rows merge into
``results/BENCH_torch_summary.json`` under ``sharded_engine``.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import parser, write_row
from repro_torch.bench.async_engine import sync
from repro_torch.bench.sparse_scale import _make_problem, leak_check


def exchange_stats(graph, shards: int, p: int, partition_mode: str = "degree"):
    """Halo fraction + exchanged bytes/super-tick for the relabel x method grid.

    Pure-numpy partition analysis (no engine build): returns CSV-style
    rows ``(name, value, note)`` for {norelabel, rcm} x {all_gather, p2p},
    plus the built partitions keyed by relabel mode so the caller can
    reuse one for the engine instead of rebuilding it. Bytes assume the
    f32 engine dtype (4 bytes) and count padded rows, because static
    shapes ship them.
    """
    from repro_torch.core.mixing import ExchangeSpec, sharded_mix_op
    from repro_torch.sim import partition_graph

    rows, parts = [], {}
    for label, relabel in (("norelabel", None), ("rcm", "rcm")):
        t0 = time.perf_counter()
        part = partition_graph(graph, shards, mode=partition_mode, relabel=relabel)
        build_s = time.perf_counter() - t0
        parts[relabel] = part
        auto = sharded_mix_op(part).method
        rows.append(
            (f"sharded_halo_frac_{label}", part.halo_fraction(),
             f"S={shards} mode={partition_mode} auto_method={auto} "
             f"partition_build={build_s:.1f}s")
        )
        for method in ("all_gather", "p2p"):
            xrows = part.exchange_rows(method)
            for dtype in ("f32", "bf16"):
                spec = ExchangeSpec(method=method, dtype=dtype)
                nbytes = xrows * spec.payload_bytes_per_row(p)
                suffix = "" if dtype == "f32" else f"_{dtype}"
                rows.append(
                    (f"sharded_exchange_bytes_{label}_{method}{suffix}",
                     float(nbytes),
                     f"rows={xrows} p={p} {dtype} bytes/super-tick")
                )
    return rows, parts


def run(n: int = 1_000_000, p: int = 8, m: int = 4, shards: int = 8, slots: int = 8,
        slot_wakes: float = 8192.0, seed: int = 0, churn: bool = True,
        partition_mode: str = "degree", relabel: str | None = "rcm", exchange: str = "auto",
        fused="auto", metrics: bool = False, roofline: bool = True, device="cuda",
        verbose: bool = True, out=None):
    """Time the stacked sharded engine and report the comm sweep rows.

    ``exchange`` takes an :class:`ExchangeSpec` or a spec string
    (``"auto"``, ``"p2p:bf16"``, ``"p2p:int8:ef"`` ...); ``fused`` is the
    ``EngineConfig`` knob. Returns the rows (merged into ``out`` when
    given)."""
    from repro_torch.core.mixing import ExchangeSpec
    from repro_torch.sim import CDUpdate, ChurnConfig, Scenario, ShardedAsyncEngine

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    graph, obj = _make_problem(n, p, m, rng)
    build_s = time.perf_counter() - t0

    stats_rows, parts = exchange_stats(graph, shards, p, partition_mode)

    scenario = Scenario(churn=ChurnConfig(leave_prob=0.01, rejoin_prob=0.2) if churn else None)
    spec = exchange if isinstance(exchange, ExchangeSpec) else ExchangeSpec.from_string(exchange)
    t0 = time.perf_counter()
    engine = ShardedAsyncEngine(
        CDUpdate(obj), num_shards=shards, partition_mode=partition_mode, relabel=relabel,
        exchange=spec, partition=parts.get(relabel), slot_wakes=slot_wakes, scenario=scenario,
        seed=seed, fused=fused, metrics=metrics, device=device)
    part_s = time.perf_counter() - t0
    part = engine.part

    mix = obj.mix
    leak_check(n, (mix.idx, mix.w, mix.rows, mix.cols, mix.vals,
                   part.idx, part.w, part.border, part.halo_src, part.owned))

    state = engine.init_state(np.zeros((n, p)))
    t0 = time.perf_counter()
    state = engine.advance(state, slots)
    sync(engine.device)
    compile_s = time.perf_counter() - t0
    warm_applied = int(state.applied.sum())

    t0 = time.perf_counter()
    state = engine.advance(state, slots)
    sync(engine.device)
    steady_s = time.perf_counter() - t0

    assert np.isfinite(engine.global_theta(state)).all()
    applied = int(state.applied.sum())
    steady_applied = applied - warm_applied
    assert steady_applied > 0
    ticks_per_s = steady_applied / max(steady_s, 1e-9)
    deg = np.diff(graph.indptr)
    wire = engine.exchange_spec
    xbytes = part.exchange_rows(engine.exchange_method) * wire.payload_bytes_per_row(p)
    rows = [
        ("sharded_graph_build", build_s * 1e6 / max(n, 1), f"n={n} deg~{deg.mean():.1f} us/agent"),
        ("sharded_engine_build", part_s * 1e6 / max(n, 1),
         f"S={shards} mode={partition_mode} relabel={relabel} R={part.rows_per_shard} "
         f"halo_frac={part.halo_fraction():.3f} us/agent "
         "(partition reused from the sweep; per-config partition_build "
         "times are on the halo_frac rows)"),
        ("sharded_super_tick", steady_s * 1e6 / slots,
         f"n={n} S={shards} B={engine.batch_size} churn={int(churn)} "
         f"exchange={engine.exchange_method}:{wire.dtype}"
         f"{':ef' if wire.error_feedback else ''} fused={int(engine.fused)} "
         f"xbytes={xbytes} us/slot"),
        ("sharded_equiv_ticks_per_s", ticks_per_s,
         f"{applied} wakes applied, {int(state.dropped.sum())} dropped, "
         f"compile {compile_s:.1f}s"),
    ] + stats_rows
    if metrics:
        from repro_torch.obs import summarize_counters

        counters, _derived = engine.metrics_snapshot(state)
        totals = summarize_counters(counters)
        for key in ("wakes_realized", "exchange_bytes", "churn_departures"):
            if key in totals:
                rows.append((f"sharded_metrics_{key}", float(totals[key]),
                             f"telemetry total over {2 * slots} slots, summed over shards"))
    if roofline:
        from repro_torch.obs.roofline import supertick_report

        rows += supertick_report(engine, state=state, steps=slots,
                                 measured_s_per_tick=steady_s / slots,
                                 prefix="sharded_roofline_supertick")
    if verbose:
        for name, v, note in rows:
            print(f"{name},{v:.4g},{note}")
    if out is not None:
        write_row(out, "sharded_engine", {"n": n, "shards": shards, "slots": slots,
                                          "device": str(device), "fused": bool(engine.fused),
                                          "rows": [[k, float(v), note] for k, v, note in rows]})
    return rows


def main(argv=None):
    """CLI entry point."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--slot-wakes", type=float, default=8192.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-churn", action="store_true")
    ap.add_argument("--mode", default="degree", choices=["degree", "contiguous"])
    ap.add_argument("--relabel", default="rcm", choices=["rcm", "none"])
    ap.add_argument("--exchange", default="auto",
                    help="ExchangeSpec string: method[:dtype[:ef]] with method "
                         "auto|all_gather|p2p and dtype f32|bf16|int8 "
                         "(e.g. p2p:bf16, p2p:int8:ef)")
    ap.add_argument("--fused", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--metrics", action="store_true",
                    help="run with device telemetry on and report its totals")
    ap.add_argument("--no-roofline", action="store_true")
    args = ap.parse_args(argv)
    size = (dict(n=100_000, slots=4, slot_wakes=2048.0) if args.fast
            else dict(n=args.n, slots=args.slots, slot_wakes=args.slot_wakes))
    run(shards=args.shards, seed=args.seed, churn=not args.no_churn, partition_mode=args.mode,
        relabel=None if args.relabel == "none" else args.relabel, exchange=args.exchange,
        fused={"auto": "auto", "on": True, "off": False}[args.fused], metrics=args.metrics,
        roofline=not args.no_roofline, device=args.device, out=args.out, **size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Async-engine scale bench on the port: batched super-ticks at n agents, churn on.

Port of ``benchmarks/bench_async_engine.py``. Where ``sparse_scale``
drives the sequential Eq. 4 scan, this bench drives the batched
:class:`repro_torch.sim.AsyncEngine`: each super-tick wakes about
``slot_wakes`` agents by Poisson thinning, mixes only the woken rows and
writes their updates back, with churn on (and optionally per-edge
delays). It asserts nothing holds an (n, n) array, runs a warm-up half
(on the card: the captured chunk's warm-up and captures) and a timed half
through ``advance`` (on the card: replays of the captured chunk). With
``fused="auto"`` on the card the slot is one ``fused_row_update`` launch;
with ``--delay`` it is the unfused slot, whose delayed gather is the
reference's einsum over the snapshot ring (no kernel of ours, as the
reference runs none there). Rows, under the reference's names:

* ``async_graph_build``: host seconds of the problem, us per agent;
* ``async_super_tick``: us per slot of the timed half;
* ``async_equiv_ticks_per_s``: applied wakes per second of the timed half;
* ``async_metrics_*`` (``--metrics``): device counter totals.

    python -m repro_torch.bench.async_engine [--n 500000] [--slots 12] [--slot-wakes 4096] [--delay] [--metrics] [--device D] [--fast] [--out PATH]

``--fast`` is the reference runner's fast size (n = 20,000, 4 slots, 512
wakes a slot). The rows merge into ``results/BENCH_torch_summary.json``
under ``async_engine``.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import parser, write_row
from repro_torch.bench.sparse_scale import _make_problem, leak_check


def sync(device) -> None:
    """Wait for the card (no-op on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(n: int = 500_000, p: int = 8, m: int = 4, slots: int = 12, slot_wakes: float = 4096.0,
        seed: int = 0, churn: bool = True, delay: bool = False, metrics: bool = False,
        device="cuda", verbose: bool = True, out=None):
    """Returns the ``(name, value, note)`` rows (merged into ``out`` when given)."""
    from repro_torch.sim import AsyncEngine, CDUpdate, ChurnConfig, DelayConfig, Scenario

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    graph, obj = _make_problem(n, p, m, rng)
    build_s = time.perf_counter() - t0

    scenario = Scenario(
        churn=ChurnConfig(leave_prob=0.01, rejoin_prob=0.2) if churn else None,
        delay=DelayConfig(max_delay=2, edge_delays=1) if delay else None,
    )
    engine = AsyncEngine(CDUpdate(obj), slot_wakes=slot_wakes, scenario=scenario, seed=seed,
                         metrics=metrics, device=device)
    mix = obj.mix
    leak_check(n, [mix.idx, mix.w, mix.rows, mix.cols, mix.vals]
               + [None if a is None else a.cpu().numpy() for a in (engine._idx, engine._w)])

    state = engine.init_state(np.zeros((n, p)))
    t0 = time.perf_counter()
    state = engine.advance(state, slots)
    sync(engine.device)
    compile_s = time.perf_counter() - t0
    warm_applied = int(state.applied)  # warm-up half: captures and churn burn-in

    t0 = time.perf_counter()
    state = engine.advance(state, slots)
    sync(engine.device)
    steady_s = time.perf_counter() - t0

    assert bool(state.Theta.isfinite().all())
    applied = int(state.applied)
    steady_applied = applied - warm_applied  # only wakes from the timed half
    assert steady_applied > 0
    ticks_per_s = steady_applied / max(steady_s, 1e-9)
    deg = np.diff(graph.indptr)
    rows = [
        ("async_graph_build", build_s * 1e6 / max(n, 1), f"n={n} deg~{deg.mean():.1f} us/agent"),
        ("async_super_tick", steady_s * 1e6 / slots,
         f"n={n} B={engine.batch_size} churn={int(churn)} delay={int(delay)} us/slot"),
        ("async_equiv_ticks_per_s", ticks_per_s,
         f"{applied} wakes applied, {int(state.dropped)} dropped, compile {compile_s:.1f}s"),
    ]
    if metrics:
        from repro_torch.obs import summarize_counters

        counters, _derived = engine.metrics_snapshot(state)
        totals = summarize_counters(counters)
        for key in ("wakes_realized", "wakes_thinned", "churn_departures"):
            if key in totals:
                rows.append((f"async_metrics_{key}", float(totals[key]),
                             f"telemetry total over {2 * slots} slots"))
    if verbose:
        for name, v, note in rows:
            print(f"{name},{v:.4g},{note}")
    if out is not None:
        write_row(out, "async_engine", {"n": n, "slots": slots, "device": str(device),
                                        "fused": bool(engine.fused),
                                        "rows": [[k, float(v), note] for k, v, note in rows]})
    return rows


def main(argv=None):
    """CLI entry point."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--slots", type=int, default=12)
    ap.add_argument("--slot-wakes", type=float, default=4096.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-churn", action="store_true")
    ap.add_argument("--delay", action="store_true", help="enable per-edge delays")
    ap.add_argument("--metrics", action="store_true",
                    help="run with device telemetry on and report its totals")
    args = ap.parse_args(argv)
    size = (dict(n=20_000, slots=4, slot_wakes=512.0) if args.fast
            else dict(n=args.n, slots=args.slots, slot_wakes=args.slot_wakes))
    run(seed=args.seed, churn=not args.no_churn, delay=args.delay, metrics=args.metrics,
        device=args.device, out=args.out, **size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Observability bench on the port: telemetry overhead + super-tick phase attribution.

Port of ``benchmarks/bench_obs.py``, on the sharded engine (its S shards
stacked on one device, as the port runs them):

* **What does telemetry cost?** The same sharded run is timed
  metrics-off and metrics-on (full :class:`repro_torch.obs.MetricsSpec`),
  the two taking turns (:func:`_steady_s_per_slot`); ``obs_overhead`` is
  the steady-state super-tick overhead in percent.
* **Where does the super-tick's time go?**
  :func:`repro_torch.obs.profile_supertick` times the engine's phase
  programs (on the card each a captured CUDA graph on a scratch copy of
  the state) and differences them: the ``obs_phase_*`` rows, and
  ``obs_phase_total`` with its coverage of the separately timed full
  slot.

Artifacts: a Chrome/Perfetto trace (the timing spans and the synthetic
per-phase track) and a :class:`repro_torch.obs.RunReport` JSONL with the
drained counters and phase rows, by default
``results/obs_torch_trace.json`` and ``results/obs_torch_runreport.jsonl``
(``results/`` is not committed); render either with
``python -m repro_torch.obs.report``.

    python -m repro_torch.bench.obs [--n 200000] [--shards 8] [--slots 6] [--slot-wakes 2048] [--device D] [--fast] [--out PATH]

``--fast`` is the reference runner's fast size (n = 50,000). The rows
merge into ``results/BENCH_torch_summary.json`` under ``obs``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from repro_torch.bench import SUMMARY, parser, write_row
from repro_torch.bench.async_engine import sync
from repro_torch.bench.sparse_scale import _make_problem

TRACE_OUT = str(SUMMARY.parent / "obs_torch_trace.json")
REPORT_OUT = str(SUMMARY.parent / "obs_torch_runreport.jsonl")


def _steady_s_per_slot(engines, n: int, p: int, slots: int, repeats: int = 5):
    """Steady-state seconds per super-tick for each engine, measured
    **interleaved**: every engine is warmed (captures and burn-in) first,
    then the timed ``slots``-long advances alternate engine by engine
    across ``repeats`` rounds (best of), so drift in the machine's load
    cannot land on one side alone."""
    states = []
    for engine in engines:
        state = engine.init_state(np.zeros((n, p)))
        state = engine.advance(state, slots)
        sync(engine.device)
        states.append(state)
    best = [float("inf")] * len(engines)
    for _ in range(repeats):
        for i, engine in enumerate(engines):
            t0 = time.perf_counter()
            states[i] = engine.advance(states[i], slots)
            sync(engine.device)
            best[i] = min(best[i], (time.perf_counter() - t0) / slots)
    return best


def run(n: int = 200_000, p: int = 8, m: int = 4, shards: int = 8, slots: int = 6,
        slot_wakes: float = 2048.0, seed: int = 0, exchange: str = "auto",
        trace_out: str = TRACE_OUT, report_out: str = REPORT_OUT, device="cuda",
        verbose: bool = True, out=None, keep: dict | None = None):
    """Measure telemetry overhead and phase attribution; write the
    artifacts. ``keep``, when given, receives the metrics-on engine, its
    state and the :class:`PhaseProfile`. Returns the rows (merged into
    ``out`` when given)."""
    from repro_torch.core.mixing import ExchangeSpec
    from repro_torch.obs import SpanRecorder, profile_supertick
    from repro_torch.sim import CDUpdate, ShardedAsyncEngine

    _, obj = _make_problem(n, p, m, np.random.default_rng(seed))
    kw = dict(num_shards=shards, relabel="rcm", exchange=ExchangeSpec.from_string(exchange),
              slot_wakes=slot_wakes, seed=seed, device=device)
    eng_off = ShardedAsyncEngine(CDUpdate(obj), **kw)
    # The same cut, so the two engines differ only by the metrics leaves.
    eng_on = ShardedAsyncEngine(CDUpdate(obj), partition=eng_off.part, metrics=True, **kw)

    t_off, t_on = _steady_s_per_slot((eng_off, eng_on), n, p, slots)
    overhead_pct = 100.0 * (t_on - t_off) / max(t_off, 1e-12)
    rows = [
        (
            "obs_overhead",
            overhead_pct,
            f"metrics-on super-tick overhead % (on {t_on * 1e6:.4g}us, "
            f"off {t_off * 1e6:.4g}us, n={n} S={shards}; target <=5%)",
        )
    ]

    # Drained run -> RunReport; phase profile -> trace + obs_phase_* rows.
    result = eng_on.run(np.zeros((n, p)), slots, metrics_every=max(slots // 2, 1))
    recorder = SpanRecorder(eng_on.device)
    prof = profile_supertick(eng_on, state=result.state, recorder=recorder)
    result.report.add_phase_rows(prof.rows(prefix="obs_phase"))
    for path in (trace_out, report_out):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
    recorder.export_chrome_trace(trace_out)
    result.report.to_jsonl(report_out)
    rows += result.report.bench_rows()
    if keep is not None:
        keep.update(engine=eng_on, state=result.state, profile=prof)

    if verbose:
        for name, v, note in rows:
            print(f"{name},{v:.4g},{note}")
        print(f"# trace: {trace_out}  report: {report_out}", file=sys.stderr)
    if out is not None:
        write_row(out, "obs", {"n": n, "shards": shards, "slots": slots, "device": str(device),
                               "rows": [[k, float(v), note] for k, v, note in rows]})
    return rows


def main(argv=None):
    """CLI entry point."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--slots", type=int, default=6)
    ap.add_argument("--slot-wakes", type=float, default=2048.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--exchange", default="auto", help="ExchangeSpec string: method[:dtype[:ef]]")
    ap.add_argument("--trace-out", default=TRACE_OUT)
    ap.add_argument("--report-out", default=REPORT_OUT)
    args = ap.parse_args(argv)
    run(n=50_000 if args.fast else args.n, shards=args.shards, slots=args.slots,
        slot_wakes=args.slot_wakes, seed=args.seed, exchange=args.exchange,
        trace_out=args.trace_out, report_out=args.report_out, device=args.device, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

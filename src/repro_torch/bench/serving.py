"""Serving bench on the port: batched predict() while the swarm trains.

Port of ``benchmarks/bench_serving.py::run``. Trains the sharded engine
in a background thread with ``snapshot_every=1`` (a publication every
slot) and issues batched ``predict`` calls on the live
:class:`repro_torch.serve.ServeHandle` from the foreground. Rows:

* ``serving_predictions_per_s``: rows scored per wall second, over the
  window concurrent with training;
* ``serving_p50_ms`` / ``serving_p99_ms``: per-batch predict latency;
* ``serving_publish_us_per_tick``: publication's host time per slot (the
  slot counter read and the snapshot's copy enqueued);
* ``serving_publish_device_us``: the copy's device time per publication
  (CUDA events; 0 on the CPU);
* ``serving_version_lag_max``: the worst staleness any request saw, in
  slots.

The last snapshot's rows are checked bit for bit against the trainer's
final Theta before any row is printed.

    python -m repro_torch.bench.serving [--n 100000] [--shards 8] [--batch 1024] [--device D] [--fast] [--out PATH]

``--fast`` is n = 10,000. The rows merge into
``results/BENCH_torch_summary.json`` under ``serving``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from repro_torch.bench import parser, write_row
from repro_torch.bench.checkpoint import _problem


def run(n=100_000, shards=8, slots=4, slot_wakes=2048.0, batch=1024, seed=0, device="cuda",
        verbose=True, out=None):
    """Serve while training; returns the ``(name, value, note)`` rows
    (merged into ``out`` when given)."""
    from repro_torch.serve import ServeHandle
    from repro_torch.sim import CDUpdate, EngineConfig, make_engine

    rng = np.random.default_rng(seed)
    obj = _problem(n, 8, 4, seed)
    cfg = EngineConfig(slot_wakes=slot_wakes, seed=seed, relabel="rcm", device=device)
    eng = make_engine(CDUpdate(obj), cfg, shards=shards)
    handle = ServeHandle.for_engine(eng)

    done = threading.Event()
    box = {}

    def _train():
        try:
            box["result"] = eng.run(np.zeros((n, obj.p)), slots, snapshot_every=1, serve=handle)
        finally:
            done.set()

    ids = rng.integers(0, n, size=batch)
    Xq = rng.normal(size=(batch, obj.p))
    trainer = threading.Thread(target=_train, name="trainer")
    trainer.start()
    while not (handle.published or done.is_set()):  # run publishes its start first
        time.sleep(0.002)
    handle.predict(ids, Xq)  # first use (the reader stream) outside the timed window
    lat = []
    while not done.is_set():
        t0 = time.perf_counter()
        handle.predict(ids, Xq)
        lat.append(time.perf_counter() - t0)
    trainer.join()
    if "result" not in box:
        raise RuntimeError("training thread died")
    result = box["result"]
    while len(lat) < 16:  # a few samples after training, so small sizes still measure
        t0 = time.perf_counter()
        handle.predict(ids, Xq)
        lat.append(time.perf_counter() - t0)

    # Served values must be the last snapshot's rows, bit for bit.
    snap = handle.snapshot()
    check = handle.rows(ids[:256], at=snap)
    if snap.version != result.slots or not np.array_equal(
            check.values, result.Theta[ids[:256]].astype(np.float32)):
        raise RuntimeError("served rows diverged from the published snapshot")

    lat = np.asarray(lat)
    c = handle.counters()
    published = max(c["serve_snapshots_published"], 1)
    rows = [
        ("serving_predictions_per_s", batch * lat.size / lat.sum(),
         f"n={n},shards={shards},batch={batch}"),
        ("serving_p50_ms", float(np.percentile(lat, 50) * 1e3), f"batch={batch}"),
        ("serving_p99_ms", float(np.percentile(lat, 99) * 1e3), f"batch={batch}"),
        ("serving_publish_us_per_tick", 1e6 * c["serve_publish_s_total"] / max(result.slots, 1),
         f"snapshots={c['serve_snapshots_published']},slots={result.slots}"),
        ("serving_publish_device_us", 1e6 * handle.publish_device_seconds() / published,
         "device time of one snapshot copy (CUDA events; 0 on the CPU)"),
        ("serving_version_lag_max", float(c["serve_version_lag_max"]),
         "slots behind trainer; bound=snapshot_every=1 while training"),
    ]
    if verbose:
        for name, val, note in rows:
            print(f"{name},{val:.6g},{note}")
    if out is not None:
        write_row(out, "serving", {"n": n, "shards": shards, "slots": slots, "batch": batch,
                                   "device": device,
                                   "rows": [[name, float(v), note] for name, v, note in rows]})
    return rows


def main(argv=None):
    """CLI entry point."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--slot-wakes", type=float, default=2048.0)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(n=10_000 if args.fast else args.n, shards=args.shards, slots=args.slots,
        slot_wakes=args.slot_wakes, batch=args.batch, seed=args.seed, device=args.device,
        out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

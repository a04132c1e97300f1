"""``python -m repro_torch.serve``: batched personalized inference CLI.

Two modes, one JSON summary line on stdout:

    # read-only serving from a checkpoint rotation written by
    # run(..., checkpoint_every=, checkpoint_dir=)
    python -m repro_torch.serve --checkpoint-dir ckpts --batch 256 --requests 32

    # live: train a synthetic swarm and serve it concurrently
    python -m repro_torch.serve --live --n 20000 --shards 8 --slots 6 \
        --snapshot-every 2 --batch 256

Both run on the card unless ``--device cpu`` asks for the CPU. The live
mode trains the engine in a background thread and keeps issuing batched
``predict`` calls against whatever version is newest; the summary reports
predictions/s, p50/p99 batch latency, the versions served, the
publication's host seconds (and its device seconds on the card), the
version lag, and the ``serve_*`` counters.
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve", description=__doc__)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--checkpoint-dir", default=None, metavar="PATH",
                      help="serve read-only from a repro_torch.checkpoint engine entry")
    mode.add_argument("--live", action="store_true",
                      help="train a synthetic swarm and serve it concurrently")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    ap.add_argument("--batch", type=int, default=256, help="rows per predict()")
    ap.add_argument("--requests", type=int, default=32,
                    help="predict() calls to issue (live mode: minimum)")
    ap.add_argument("--n", type=int, default=20_000, help="live: swarm size")
    ap.add_argument("--p", type=int, default=8, help="live: model dimension")
    ap.add_argument("--shards", type=int, default=1, help="live: shard count")
    ap.add_argument("--slots", type=int, default=6, help="live: training slots")
    ap.add_argument("--slot-wakes", type=float, default=0.0,
                    help="live: mean wakes per slot (0 = n/20)")
    ap.add_argument("--snapshot-every", type=int, default=2,
                    help="live: publication period in slots")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _measure(handle, rng, batch, requests, stop=None):
    """Issue batched predicts until ``requests`` (and ``stop``, if given)."""
    ids = rng.integers(0, handle.n, size=batch)
    X = rng.normal(size=(batch, handle.p))
    handle.predict(ids, X)  # first use (the reader stream) outside the timed window
    lat, versions = [], set()
    while len(lat) < requests or (stop is not None and not stop.is_set()):
        t0 = time.perf_counter()
        r = handle.predict(ids, X)
        lat.append(time.perf_counter() - t0)
        versions.add(int(r.version))
    return np.asarray(lat), versions


def _summary(mode, handle, batch, lat, versions, extra=None):
    counters = handle.counters()
    out = {
        "mode": mode,
        "n": handle.n,
        "p": handle.p,
        "version": handle.version,
        "requests": int(lat.size),
        "predictions_per_s": float(batch * lat.size / lat.sum()),
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "versions_served": sorted(versions),
        "publish_device_s_total": handle.publish_device_seconds(),
        **(extra or {}),
        **counters,
    }
    print(json.dumps(out))


def _serve_checkpoint(args) -> int:
    from repro_torch.serve import serve_from_checkpoint

    handle = serve_from_checkpoint(args.checkpoint_dir, device=args.device)
    rng = np.random.default_rng(args.seed)
    lat, versions = _measure(handle, rng, args.batch, args.requests)
    _summary("checkpoint", handle, args.batch, lat, versions, extra={"device": args.device})
    return 0


def _serve_live(args) -> int:
    from repro_torch.core import AgentData, make_objective, random_geometric_graph
    from repro_torch.serve import ServeHandle
    from repro_torch.sim import CDUpdate, EngineConfig, make_engine

    rng = np.random.default_rng(args.seed)
    n, p, m = args.n, args.p, 4
    graph = random_geometric_graph(n, rng, avg_degree=12.0)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    data = AgentData(X=X, y=np.einsum("nmp,np->nm", X, targets), mask=np.ones((n, m)))
    update = CDUpdate(make_objective(graph, data, "quadratic", mu=0.5, mix_mode="sparse"))
    cfg = EngineConfig(slot_wakes=args.slot_wakes or n / 20.0, seed=args.seed,
                       relabel="rcm" if args.shards > 1 else None, device=args.device)
    engine = make_engine(update, cfg, shards=args.shards if args.shards > 1 else None)
    handle = ServeHandle.for_engine(engine)

    done = threading.Event()
    box = {}

    def _train():
        try:
            box["result"] = engine.run(np.zeros((n, p)), args.slots,
                                       snapshot_every=args.snapshot_every, serve=handle)
        finally:
            done.set()

    trainer = threading.Thread(target=_train, name="trainer")
    trainer.start()
    while not (handle.published or done.is_set()):  # run publishes its start first
        time.sleep(0.002)
    lat, versions = _measure(handle, rng, args.batch, args.requests, stop=done)
    trainer.join()
    if "result" not in box:
        raise SystemExit("training thread died before finishing")
    final = handle.predict(rng.integers(0, n, size=args.batch), rng.normal(size=(args.batch, p)))
    versions.add(int(final.version))
    if int(final.version) != int(box["result"].slots):
        raise SystemExit(f"latest served version {final.version} != final trainer slot "
                         f"{box['result'].slots}")
    _summary("live", handle, args.batch, lat, versions,
             extra={"shards": args.shards, "slots": args.slots, "device": args.device})
    return 0


def main(argv=None) -> int:
    """CLI entry point."""
    args = _parse(argv)
    if args.live:
        return _serve_live(args)
    return _serve_checkpoint(args)


if __name__ == "__main__":
    raise SystemExit(main())

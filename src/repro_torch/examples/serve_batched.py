"""Serve personalized predictions while the swarm trains (the port).

Port of ``examples/serve_batched.py``. A 2,000-agent swarm trains in a
background thread and publishes a version-tagged Theta snapshot every
``snapshot_every`` slots into a :class:`repro_torch.serve.ServeHandle`;
the foreground keeps answering batched ``predict(agent_ids, X)`` requests
against the newest ready version, including one cold id that is not in
the swarm at all, whose row is synthesized as the Eq. 16 neighbour
average. At the end the final snapshot is pinned and the served rows are
asserted equal to the trainer's final Theta, bit for bit.

    python -m repro_torch.examples.serve_batched [--smoke] [--device D]
"""

import argparse
import threading
import time

import numpy as np

from repro_torch.core import AgentData, make_objective, random_geometric_graph
from repro_torch.serve import ServeHandle
from repro_torch.sim import CDUpdate, EngineConfig, make_engine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="CI-sized run")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    n, p, m = (500, 4, 4) if args.smoke else (2_000, 8, 6)
    slots, snapshot_every = (6, 2) if args.smoke else (16, 4)

    graph = random_geometric_graph(n, rng, avg_degree=12.0)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    data = AgentData(X=X, y=np.einsum("nmp,np->nm", X, targets), mask=np.ones((n, m)))
    obj = make_objective(graph, data, "quadratic", mu=0.5, mix_mode="sparse")
    engine = make_engine(CDUpdate(obj), EngineConfig(slot_wakes=n / 10.0, seed=1,
                                                     device=args.device))
    handle = ServeHandle.for_engine(engine)

    done = threading.Event()
    box = {}

    def _train():
        try:
            box["result"] = engine.run(np.zeros((n, p)), slots, snapshot_every=snapshot_every,
                                       serve=handle)
        finally:
            done.set()

    trainer = threading.Thread(target=_train)
    trainer.start()
    while not (handle.published or done.is_set()):  # run publishes version 0 as it starts
        time.sleep(0.005)

    batch = 64
    ids = rng.integers(0, n, size=batch)
    Xq = rng.normal(size=(batch, p))
    requests = 0
    while not done.is_set():
        handle.predict(ids, Xq)
        requests += 1
    trainer.join()
    if "result" not in box:
        raise RuntimeError("the training thread failed")
    result = box["result"]

    # Pin the final version: served rows are the trainer's rows, bit for bit.
    snap = handle.snapshot()
    assert snap.version == result.slots
    rows = handle.rows(ids, at=snap)
    assert np.array_equal(rows.values, result.Theta[ids].astype(np.float32))

    # Cold start: an id outside the swarm gets the Eq. 16 average of the
    # neighbours it is attached to, the row a real arrival would
    # warm-start from at admission.
    cold_id = n + 7
    nbrs = (0, 1, 2)
    cold = handle.predict([cold_id], Xq[:1], neighbors={cold_id: nbrs})
    want = result.Theta[list(nbrs)].mean(axis=0).astype(np.float32) @ Xq[0].astype(np.float32)
    assert cold.cold[0] and np.allclose(cold.values[0], want, rtol=1e-5)

    c = handle.counters()
    print(f"trained {result.slots} slots; served {requests} mid-training "
          f"batches of {batch} (+1 cold start)")
    print(f"versions published: {c['serve_snapshots_published']}, "
          f"final served version: {snap.version}, "
          f"worst version lag: {c['serve_version_lag_max']} slots "
          f"({handle.version_lag_start[1]} at the requests' start)")
    print("served rows bit-exact vs final Theta: OK")
    return dict(slots=result.slots, requests=requests, version=snap.version,
                published=c["serve_snapshots_published"], lag_max=c["serve_version_lag_max"],
                lag_start_max=handle.version_lag_start[1], snapshot_every=snapshot_every)


if __name__ == "__main__":
    main()

"""Sharded async engine walkthrough on the port: S agent blocks stacked on one card.

Port of ``examples/sharded_async_simulation.py``. Shards a 20,000-agent
random geometric collaboration graph into 4 agent blocks, stacked on one
device as :class:`repro_torch.sim.ShardedAsyncEngine` runs them (the
reference places one block on each of 4 host devices): a reverse
Cuthill-McKee relabel co-locates graph neighbours so the cut shrinks,
agent blocks carry their own slice of the dataset, and the halo exchange
goes point to point. One :class:`repro_torch.sim.EngineConfig` drives
both engines through :func:`repro_torch.sim.make_engine`; the wire
format is an :class:`repro_torch.sim.ExchangeSpec` (also shown with bf16
payloads + error feedback, half the halo bytes). Under forced wake sets
the result is held against the single-device engine: within 1e-6, since
the stacked slot and the single-device slot sum a row's neighbours in
their own float32 orders (``src/repro_torch/DEVIATIONS.md``).

    python -m repro_torch.examples.sharded_async_simulation [--smoke] [--device D]

Crash-safe resume (checkpoints through :mod:`repro_torch.checkpoint`)::

    # write rotating checkpoints, then die mid-run (exit code 7)
    python -m repro_torch.examples.sharded_async_simulation --smoke \\
        --checkpoint-dir ckpts --checkpoint-every 4 --kill-after 8
    # pick up from the newest valid entry and finish
    python -m repro_torch.examples.sharded_async_simulation --smoke \\
        --checkpoint-dir ckpts --checkpoint-every 4 --resume
"""

import argparse
import os

import numpy as np

from repro_torch.core import AgentData, make_objective, random_geometric_graph
from repro_torch.sim import (
    CDUpdate,
    ChurnConfig,
    EngineConfig,
    ExchangeSpec,
    Scenario,
    make_engine,
    partition_graph,
)

PARITY_TOL = 1e-6  # forced slots, stacked against single-device (DEVIATIONS.md)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="CI-sized problem")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="slots between rotating engine checkpoints (0 = off)")
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid entry and finish the run")
    ap.add_argument("--kill-after", type=int, default=0,
                    help="checkpoint through this many slots then os._exit(7)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    a = ap.parse_args(argv)

    from repro_torch.checkpoint import restore

    rng = np.random.default_rng(0)
    n, p, m, shards = (2_000, 4, 8, 4) if a.smoke else (20_000, 8, 16, 4)
    slots, record_every = (12, 6) if a.smoke else (40, 10)
    graph = random_geometric_graph(n, rng, avg_degree=16.0)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    data = AgentData(X=X, y=y, mask=np.ones((n, m)))
    obj = make_objective(graph, data, "quadratic", mu=0.5, mix_mode="sparse")
    Theta0 = np.zeros((n, p))
    update = CDUpdate(obj)

    print(f"device: {a.device}, shards: {shards} (stacked)")
    # One config, both engines. Placement fields (relabel, exchange) are
    # no-ops on the single-device side, so the parity pair shares it.
    cfg = EngineConfig(
        slot_wakes=n / 20.0,
        seed=1,
        relabel="rcm",
        exchange=ExchangeSpec(method="auto"),
        scenario=Scenario(churn=ChurnConfig(leave_prob=0.005, rejoin_prob=0.2)),
        device=a.device,
    )
    # Locality matters: agent ids carry no spatial information, so plain
    # contiguous blocks read mostly remote rows; the RCM relabel shrinks
    # the cut by an order of magnitude and unlocks the p2p exchange.
    base = partition_graph(graph, shards)
    eng = make_engine(update, cfg, shards=shards)
    part = eng.part
    print(f"partition: mode={part.mode} rows/shard<={part.rows_per_shard} "
          f"tile K={part.tile_width}")
    print(f"halo fraction: {base.halo_fraction():.2f} (no relabel) -> "
          f"{part.halo_fraction():.2f} (RCM); exchange={eng.exchange_method}, "
          f"{part.exchange_rows(eng.exchange_method)} rows/super-tick vs "
          f"{base.exchange_rows('all_gather')} unrelabeled all_gather")

    if a.kill_after > 0:
        # Crash rehearsal: checkpoint every few slots, then die hard
        # mid-run (no atexit, no cleanup), as a preempted node does.
        assert a.checkpoint_dir is not None and a.checkpoint_every > 0
        eng.run(Theta0, slots=min(a.kill_after, slots), checkpoint_every=a.checkpoint_every,
                checkpoint_dir=a.checkpoint_dir, checkpoint_keep_last=a.keep_last)
        print(f"[kill]     checkpointed through slot {min(a.kill_after, slots)}, dying now",
              flush=True)
        os._exit(7)

    state0, start = None, 0
    if a.resume:
        state0, start = restore(eng, a.checkpoint_dir)
        print(f"[resume]   picked up slot {start} from {a.checkpoint_dir}")
    res = eng.run(
        Theta0,
        slots=slots - start,
        record_every=record_every,
        state=state0,
        checkpoint_every=a.checkpoint_every,
        checkpoint_dir=a.checkpoint_dir if a.checkpoint_every > 0 else None,
        checkpoint_keep_last=a.keep_last,
    )
    print("[sharded]  Q:", " -> ".join(f"{q:.1f}" for q in res.objective))
    print(f"           {res.wakes_applied} wakes over {res.slots} super-ticks, "
          f"{res.messages:.0f} p-vectors broadcast, "
          f"{int((~res.active).sum())} agents currently departed")

    # Compressed halos: the border rows as bf16 with an error-feedback
    # accumulator: half the halo bytes, the same fixed point.
    wire = ExchangeSpec(method="p2p", dtype="bf16", error_feedback=True)
    ceng = make_engine(update, cfg, shards=shards, exchange=wire)
    cres = ceng.run(Theta0, slots=slots)
    drift = float(np.abs(cres.Theta - res.Theta).max())
    f32_bytes = part.exchange_rows("p2p") * ExchangeSpec().payload_bytes_per_row(p)
    bf16_bytes = part.exchange_rows("p2p") * wire.payload_bytes_per_row(p)
    print(f"[bf16+ef]  halo payload {f32_bytes} -> {bf16_bytes} bytes/super-tick "
          f"({f32_bytes / bf16_bytes:.1f}x less wire), |Theta - f32 Theta| <= {drift:.1e}")

    # Forced wake sets: the stacked engine is the single-device engine,
    # under any relabeling and either exchange method.
    single = make_engine(update, cfg, slot_wakes=64.0)
    s1 = single.init_state(Theta0)
    sS = eng.init_state(Theta0)
    mask_rng = np.random.default_rng(7)
    for _ in range(3):
        mask = mask_rng.random(n) < 0.005
        s1 = single.step(s1, mask)
        sS = eng.step(sS, mask)
    err = float(np.abs(s1.Theta.cpu().numpy() - eng.global_theta(sS)).max())
    print(f"[parity]   forced wake sets against AsyncEngine: max |diff| {err:.1e} "
          f"(tol {PARITY_TOL:.0e})")
    assert err <= PARITY_TOL, "sharded engine diverged from AsyncEngine under forced wakes"
    return dict(slots=res.slots, start=start, objective=res.objective.tolist(),
                wakes_applied=res.wakes_applied, exchange=eng.exchange_method,
                halo_fraction=[base.halo_fraction(), part.halo_fraction()], wire_drift=drift,
                parity_err=err)


if __name__ == "__main__":
    main()

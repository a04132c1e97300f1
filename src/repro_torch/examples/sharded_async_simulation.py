"""Sharded async engine walkthrough on the port: S agent blocks stacked on one card,
or one a process.

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

Under ``torchrun`` it runs one shard a rank (the reference's one block a
device): each process joins the default process group (gloo with
``--device cpu``, NCCL on ``cuda:<local rank>`` otherwise), and
``make_engine`` hands it its rank's shard. Rank 0 prints, and the parity
check holds the ranks against the stacked engine, which they must equal
bit for bit::

    torchrun --standalone --nproc_per_node 4 -m repro_torch.examples.sharded_async_simulation \
        --smoke --device cpu

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

    ranked = int(os.environ.get("WORLD_SIZE", "1")) > 1  # started by torchrun
    if ranked:
        import torch
        import torch.distributed as dist

        if not dist.is_initialized():
            dist.init_process_group("gloo" if a.device == "cpu" else "nccl")
        if a.device != "cpu":
            a.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
            torch.cuda.set_device(a.device)
    rank0 = not ranked or int(os.environ.get("RANK", "0")) == 0
    say = print if rank0 else (lambda *args, **kw: None)

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

    say(f"device: {a.device}, shards: {shards} "
        f"({'one a rank' if ranked else 'stacked'})")
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
    eng = make_engine(update, cfg, shards=shards)  # one a rank under torchrun
    part = eng.part
    say(f"partition: mode={part.mode} rows/shard<={part.rows_per_shard} "
          f"tile K={part.tile_width}")
    say(f"halo fraction: {base.halo_fraction():.2f} (no relabel) -> "
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
        say(f"[resume]   picked up slot {start} from {a.checkpoint_dir}")
    res = eng.run(
        Theta0,
        slots=slots - start,
        record_every=record_every,
        state=state0,
        checkpoint_every=a.checkpoint_every,
        checkpoint_dir=a.checkpoint_dir if a.checkpoint_every > 0 else None,
        checkpoint_keep_last=a.keep_last,
    )
    say("[sharded]  Q:", " -> ".join(f"{q:.1f}" for q in res.objective))
    say(f"           {res.wakes_applied} wakes over {res.slots} super-ticks, "
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
    say(f"[bf16+ef]  halo payload {f32_bytes} -> {bf16_bytes} bytes/super-tick "
          f"({f32_bytes / bf16_bytes:.1f}x less wire), |Theta - f32 Theta| <= {drift:.1e}")

    # Forced wake sets: the stacked engine is the single-device engine,
    # under any relabeling and either exchange method; the ranks are the
    # stacked engine, bit for bit.
    if ranked:
        from repro_torch.sim import ShardedAsyncEngine

        yard, name, tol = ShardedAsyncEngine(update, num_shards=shards, config=cfg), \
            "the stacked engine", 0.0
    else:
        yard, name, tol = make_engine(update, cfg, slot_wakes=64.0), "AsyncEngine", PARITY_TOL
    s1 = yard.init_state(Theta0)
    sS = eng.init_state(Theta0)
    mask_rng = np.random.default_rng(7)
    for _ in range(3):
        mask = mask_rng.random(n) < 0.005
        s1 = yard.step(s1, mask)
        sS = eng.step(sS, mask)
    want = yard.global_theta(s1) if ranked else s1.Theta.cpu().numpy()
    err = float(np.abs(want - eng.global_theta(sS)).max())
    say(f"[parity]   forced wake sets against {name}: max |diff| {err:.1e} (tol {tol:.0e})")
    assert err <= tol, f"sharded engine diverged from {name} under forced wakes"
    if ranked:
        import torch.distributed as dist

        dist.destroy_process_group()
    return dict(slots=res.slots, start=start, objective=res.objective.tolist(),
                wakes_applied=res.wakes_applied, exchange=eng.exchange_method,
                halo_fraction=[base.halo_fraction(), part.halo_fraction()], wire_drift=drift,
                parity_err=err, ranks=shards if ranked else 1)


if __name__ == "__main__":
    main()

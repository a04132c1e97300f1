"""Checkpoint bench on the port: save and restore time, bytes on disk.

Port of ``benchmarks/bench_checkpoint.py::run``. Times one
:func:`repro_torch.checkpoint.save_engine_checkpoint` +
:func:`repro_torch.checkpoint.restore` round trip of the sharded engine's
full resume closure (Theta tiles, churn flags, update state, counters,
metrics, the generator's state) at the reference bench's size, without
ever making the (n, p) model matrix one host array: the per-shard layout
holds O(n / S) rows on the host per shard file. Rows:

* ``ckpt_save_s``: the state dict (device to host), the staged fsynced
  write and the atomic rename;
* ``ckpt_restore_s``: hash verification, re-tiling the shard files, the
  state rebuilt on the device;
* ``ckpt_bytes``: the entry's size on disk;
* ``ckpt_mb_per_s``: save throughput (bytes over save seconds).

    python -m repro_torch.bench.checkpoint [--n 200000] [--shards 8] [--device D] [--fast] [--out PATH]

``--fast`` is n = 20,000. The rows merge into
``results/BENCH_torch_summary.json`` under ``checkpoint``, each
``[name, value, note]`` as the reference's.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from repro_torch.bench import parser, write_row


def _problem(n, p, m, seed):
    """The reference bench's quadratic problem on a random geometric graph."""
    from repro_torch.core import AgentData, make_objective, random_geometric_graph

    rng = np.random.default_rng(seed)
    graph = random_geometric_graph(n, rng, avg_degree=16.0)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    return make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                          mu=0.5, mix_mode="sparse")


def run(n=200_000, shards=8, slots=2, slot_wakes=2048.0, seed=0, device="cuda", workdir=None,
        verbose=True, out=None):
    """One save + restore round trip; returns the ``(name, value, note)``
    rows (merged into ``out`` when given). ``workdir`` holds the entry
    while it is timed (default: a temporary directory), removed after."""
    import torch

    from repro_torch.checkpoint import restore, save_engine_checkpoint
    from repro_torch.sim import CDUpdate, ShardedAsyncEngine

    obj = _problem(n, 8, 4, seed)

    def engine():
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=shards, slot_wakes=slot_wakes,
                                  seed=seed, relabel="rcm", metrics=True, dtype=torch.float32,
                                  device=device)

    eng = engine()
    state = eng.run(np.zeros((n, obj.p)), slots=slots).state
    fresh = engine()
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        ck = os.path.join(td, "ck")
        t0 = time.perf_counter()
        entry = save_engine_checkpoint(eng, state, ck)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(entry, f)) for f in os.listdir(entry))
        t0 = time.perf_counter()
        restored, step = restore(fresh, ck)
        if restored.Theta.is_cuda:
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if step != slots or not torch.equal(restored.Theta, state.Theta):
        raise AssertionError("the restored Theta differs from the saved one")
    note = f"n={n},shards={shards}"
    rows = [
        ("ckpt_save_s", save_s, note),
        ("ckpt_restore_s", restore_s, note),
        ("ckpt_bytes", float(nbytes), note),
        ("ckpt_mb_per_s", nbytes / save_s / 1e6, f"{note},save throughput"),
    ]
    if verbose:
        for name, v, note in rows:
            print(f"{name},{v:.4g},{note}")
    if out is not None:
        write_row(out, "checkpoint", {"n": n, "shards": shards, "slots": slots, "device": device,
                                      "rows": [[name, float(v), note] for name, v, note in rows]})
    return rows


def main(argv=None):
    """CLI entry point."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--slot-wakes", type=float, default=2048.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(n=20_000 if args.fast else args.n, shards=args.shards, slots=args.slots,
        slot_wakes=args.slot_wakes, seed=args.seed, device=args.device, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

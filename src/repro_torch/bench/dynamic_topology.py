"""Dynamic-topology bench on the port: patch against rebuild, the drift
gauge, halo parity.

Port of ``benchmarks/bench_dynamic_topology.py::run``. The claim it
measures: a Dada edge refresh should not pay for a full
``partition_graph`` every round; while the cut drifts little,
:meth:`GraphPartition.patch` rebinds the halo tiles under frozen
ownership. On a random geometric graph churned by one
:class:`repro_torch.sim.GraphUpdate` refresh it reports (host seconds,
numpy partition machinery, as in the reference):

* ``dyntopo_refresh_s`` — the edge-refresh round;
* ``dyntopo_drift`` — the cut-fraction drift the repartition policy reads
  (``EngineConfig.drift_threshold``);
* ``dyntopo_patch_s`` / ``dyntopo_rebuild_s`` — rebinding the standing
  partition against cutting the new graph from scratch (each with its
  point-to-point plan);
* ``dyntopo_patch_speedup`` — rebuild over patch (> 1: the patch is
  cheaper);
* ``dyntopo_halo_parity`` — 1.0 once the patched partition's halo and
  exchange tiles were asserted equal to a from-scratch cut under the same
  frozen layout (contiguous bounds, the standing order, the same tile
  width: where the two are defined to coincide).

    python -m repro_torch.bench.dynamic_topology [--n 200000] [--shards 8] [--fast] [--out PATH]

``--fast`` is the reference runner's fast size (n = 20,000). The rows
merge into ``results/BENCH_torch_summary.json`` under
``dynamic_topology``, each ``[name, value, note]`` as the reference's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.bench import SUMMARY, write_row


def _churned_graph(csr, refresh, Theta, rounds: int = 1):
    """Apply ``rounds`` edge-refresh steps and return the final graph."""
    for r in range(rounds):
        csr = refresh.refresh(csr, Theta, round_index=r + 1)
    return csr


def _assert_halo_parity(base, patched, new_csr) -> None:
    """The patched tiles must equal a from-scratch cut under the frozen
    layout: contiguous bounds (independent of the weights), the standing
    relabel order and the (never-shrinking) tile width pinned, so a fresh
    ``partition_graph`` of the new graph coincides field for field, the
    point-to-point plan included."""
    from repro_torch.sim import partition_graph

    fresh = partition_graph(new_csr, base.num_shards, mode="contiguous", relabel=base.order,
                            tile_width=patched.tile_width)
    for name in ("halo", "halo_sizes", "halo_owner", "border", "border_sizes", "halo_src",
                 "idx", "w"):
        if not np.array_equal(np.asarray(getattr(patched, name)), np.asarray(getattr(fresh, name))):
            raise AssertionError(f"halo parity: field {name} diverged after patch()")
    for name, a, b in zip(("offsets", "sends", "dsts"), patched.p2p_plan, fresh.p2p_plan):
        if not (len(a) == len(b) and all(np.array_equal(np.asarray(x), np.asarray(y))
                                         for x, y in zip(a, b))):
            raise AssertionError(f"halo parity: p2p plan {name} diverged after patch()")


def run(n: int = 200_000, shards: int = 8, k: int = 10, seed: int = 0, verbose=True, out=None):
    """Patch against rebuild on one refresh round; returns the
    ``(name, value, note)`` rows (merged into ``out`` when given)."""
    from repro_torch.core import random_geometric_graph
    from repro_torch.sim import GraphUpdate, partition_graph

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    # Random geometric graph: O(n) memory, the sharded engine benches'
    # constructor (a k-NN build would dominate the partition timings).
    csr = random_geometric_graph(n, rng, avg_degree=float(k))
    graph_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    part = partition_graph(csr, shards, mode="degree", relabel="rcm")
    build_s = time.perf_counter() - t0

    refresh = GraphUpdate(every=1, k=k, candidates=4, gamma=4.0, seed=seed)
    Theta = rng.normal(size=(n, 8))
    t0 = time.perf_counter()
    new_csr = _churned_graph(csr, refresh, Theta)
    refresh_s = time.perf_counter() - t0

    drift = part.drift(new_csr)
    t0 = time.perf_counter()
    patched = part.patch(new_csr)
    patched.p2p_plan  # the plan is part of what a swap rebinds: timed
    patch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rebuilt = partition_graph(new_csr, shards, mode="degree", relabel="rcm")
    rebuilt.p2p_plan
    rebuild_s = time.perf_counter() - t0
    assert rebuilt.n == patched.n

    # Halo parity on a contiguous-mode base: patch() freezes the block
    # bounds, and only contiguous bounds are weight-independent.
    cbase = partition_graph(csr, shards, mode="contiguous", relabel="rcm")
    _assert_halo_parity(cbase, cbase.patch(new_csr), new_csr)

    rows = [
        ("dyntopo_graph_build", graph_s, f"random_geometric_graph n={n} deg~{k}"),
        ("dyntopo_partition_build", build_s, f"S={shards} mode=degree relabel=rcm"),
        ("dyntopo_refresh_s", refresh_s, "GraphUpdate round with 4 candidates/row"),
        ("dyntopo_drift", drift, "cut-fraction drift gauge after one refresh"),
        ("dyntopo_patch_s", patch_s, "GraphPartition.patch + p2p plan rebind"),
        ("dyntopo_rebuild_s", rebuild_s, "full partition_graph + p2p plan"),
        ("dyntopo_patch_speedup", rebuild_s / max(patch_s, 1e-9),
         "rebuild_s / patch_s (>1 = patch cheaper)"),
        ("dyntopo_halo_parity", 1.0,
         "patched tiles == from-scratch cut under frozen layout (asserted)"),
    ]
    if verbose:
        for name, v, note in rows:
            print(f"{name},{v:.4g},{note}")
    if out is not None:
        write_row(out, "dynamic_topology",
                  {"n": n, "shards": shards, "k": k, "seed": seed,
                   "rows": [[name, float(v), note] for name, v, note in rows]})
    return rows


def main(argv=None):
    """CLI entry point (host-side partition machinery: no device needed)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fast", action="store_true", help="the reference runner's fast size")
    ap.add_argument("--out", default=str(SUMMARY), help="summary JSON to merge the rows into")
    args = ap.parse_args(argv)
    run(n=20_000 if args.fast else args.n, shards=args.shards, k=args.k, seed=args.seed,
        out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

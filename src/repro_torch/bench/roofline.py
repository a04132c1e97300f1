"""Roofline table of the dry-run: reads ``results/dryrun_torch.jsonl``.

Port of ``benchmarks/bench_roofline.py``: prints the per-(arch x shape x
mesh) three-term roofline with the dominant bottleneck and the
MODEL_FLOPS / counted-FLOPS usefulness ratio, then the three rows with
the worst roofline fraction and what to cut there. The rows come from
``python -m repro_torch.launch.dryrun`` (counts against the H100's
datasheet peaks, not times measured on a card); this module only formats
them.

    python -m repro_torch.bench.run --only roofline
"""

from __future__ import annotations

import json
import os

from repro_torch.launch.dryrun import DEFAULT_OUT


def load(path=DEFAULT_OUT):
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                rows.append(json.loads(line))
    return rows


def advice(row):
    d = row["dominant"]
    if d == "collective":
        cb = row.get("collective_breakdown", {})
        top = max(cb, key=cb.get) if cb else "?"
        return f"cut {top} traffic (seq-parallel norms / bf16 payloads / layout)"
    if d == "memory":
        return "reduce HBM traffic (fusion, chunked attention, smaller remat set)"
    return "compute-bound: increase per-chip arithmetic intensity or accept"


def table(rows, mesh=None):
    out = []
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':8s} {'dom':10s} {'compute_s':>10s} "
           f"{'memory_s':>10s} {'coll_s':>10s} {'useful':>7s}")
    out.append(hdr)
    out.append("-" * len(hdr))
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if mesh and r["mesh"] != mesh:
            continue
        out.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['mesh']:8s} {r['dominant']:10s} "
            f"{r['compute_s']:10.3f} {r['memory_s']:10.3f} {r['collective_s']:10.3f} "
            f"{r['useful_ratio']:7.2f}"
        )
    return "\n".join(out)


def run(path=DEFAULT_OUT, verbose=True):
    rows = load(path)
    if verbose:
        if not rows:
            print(f"[roofline] no dry-run results at {path}; run "
                  "PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out " + path)
        else:
            print(table(rows))
            worst = sorted(
                (r for r in rows if r["compute_s"] > 0),
                key=lambda r: r["compute_s"] / max(r["compute_s"], r["memory_s"],
                                                   r["collective_s"]),
            )[:3]
            print("\nworst roofline fraction (hillclimb candidates):")
            for r in worst:
                frac = r["compute_s"] / max(r["compute_s"], r["memory_s"], r["collective_s"])
                print(f"  {r['arch']} x {r['shape']} ({r['mesh']}): {frac:.3f} — {advice(r)}")
    return rows


if __name__ == "__main__":
    run()

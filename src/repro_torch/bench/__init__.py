"""The JAX package's benches on the port, as runners inside the package.

Each runs as ``python -m repro_torch.bench.<name> [--device D] [--fast]
[--out PATH]`` and reports the same fields as its counterpart in the JAX
package's ``benchmarks/``: ``cd_vs_admm`` (Fig. 1), ``movielens``
(Table 1), ``privacy_utility`` (Figs. 2a/b, 2c, 3 and 4) and
``ablations`` (noise allocation, mechanism, personalization), each row
with the reference's ``derived`` string; ``dynamic_topology`` (patch
against rebuild after a Dada refresh, the reference's ``dyntopo_*``
rows) takes no device; ``checkpoint``, ``serving``, ``sparse_scale``,
``async_engine``, ``kernels``, ``sharded_engine`` and ``obs`` return the
reference's ``(name, value, note)`` rows. A run merges its row, under
the bench's name, into the JSON file ``--out`` (default
``results/BENCH_torch_summary.json`` at the repository root), so the
runners share one summary; ``python -m repro_torch.bench.run`` runs them
in the reference's order (:mod:`repro_torch.bench.run`).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

# src/repro_torch/bench/__init__.py -> the repository root.
SUMMARY = Path(__file__).resolve().parents[3] / "results" / "BENCH_torch_summary.json"


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    ap.add_argument("--fast", action="store_true", help="the reference runner's fast size")
    ap.add_argument("--out", default=str(SUMMARY), help="summary JSON to merge the row into")
    return ap


def write_row(out, name: str, row: dict) -> None:
    """Merge ``row`` under ``name`` into the JSON object in ``out``."""
    path = Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    summary = json.loads(path.read_text()) if path.exists() else {}
    summary[name] = row
    path.write_text(json.dumps(summary, indent=2, sort_keys=True) + "\n")

"""Run reports: periodic metric drains, JSONL export, and the report CLI.

Port of ``repro.obs.report``. The engine accumulates counters on the
device (:mod:`repro_torch.obs.metrics`); ``run(..., metrics_every=N)``
drains them to the host every N slots and appends each drain to a
:class:`RunReport` — the one record of a run's metadata, its counter
trajectory and (where a phase profile ran) per-phase timing rows.
Reports round-trip through JSONL (one ``kind``-tagged object per line,
the reference's format, so each package reads the other's files) and
merge their rows into a bench summary under ``obs_*`` names.

CLI::

    python -m repro_torch.obs.report results/obs_runreport.jsonl
    python -m repro_torch.obs.report report.jsonl --merge-bench [PATH]
    python -m repro_torch.obs.report --validate-trace results/obs_torch_trace.json

The first form renders the run summary table (metadata, final counter
totals, per-phase rows); ``--merge-bench`` folds the report's ``obs_*``
rows into a bench summary file, by default the port's
``results/BENCH_torch_summary.json`` (the JAX package's
``BENCH_summary.json`` is the reference's and is never written here);
``--validate-trace`` loads a Chrome trace (either package's) with
:func:`repro_torch.obs.trace.validate_trace` and prints its span count.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from repro_torch.bench import SUMMARY
from repro_torch.obs.metrics import summarize_counters


def merge_bench_summary(path, rows) -> None:
    """Merge ``(name, us_per_call, derived)`` rows into a bench summary.

    The ``name -> {us_per_call, derived}`` map of the reference: merging
    (not clobbering) lets partial runs update their own entries without
    erasing the other rows of the file.
    """
    data = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            data = {}
    if not isinstance(data, dict):
        data = {}
    data.update({n: {"us_per_call": float(u), "derived": str(d)} for n, u, d in rows})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)


@dataclasses.dataclass
class RunReport:
    """One run's telemetry: metadata, drained snapshots, phase rows."""

    meta: dict = dataclasses.field(default_factory=dict)
    snapshots: list = dataclasses.field(default_factory=list)
    phase_rows: list = dataclasses.field(default_factory=list)

    def add_snapshot(self, slot: int, counters: dict, derived: dict | None = None):
        """Append one drained metrics snapshot (host-side dict of arrays)."""
        self.snapshots.append(
            {
                "slot": int(slot),
                "counters": summarize_counters(counters),
                "derived": {k: _jsonable(v) for k, v in (derived or {}).items()},
            }
        )

    def add_phase_rows(self, rows) -> None:
        """Attach per-phase bench rows (``(name, us, note)`` triples)."""
        self.phase_rows.extend((str(n), float(v), str(note)) for n, v, note in rows)

    # -- serialization -----------------------------------------------------
    def to_jsonl(self, path) -> None:
        """Write the report as kind-tagged JSONL (meta, snapshots, rows)."""
        with open(path, "w") as f:
            f.write(json.dumps({"kind": "meta", **self.meta}) + "\n")
            for snap in self.snapshots:
                f.write(json.dumps({"kind": "snapshot", **snap}) + "\n")
            for name, value, note in self.phase_rows:
                f.write(json.dumps({"kind": "phase_row", "name": name, "value": value,
                                    "note": note}) + "\n")

    @classmethod
    def from_jsonl(cls, path) -> "RunReport":
        """Load a report written by :meth:`to_jsonl` (either package's)."""
        report = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                kind = obj.pop("kind", None)
                if kind == "meta":
                    report.meta = obj
                elif kind == "snapshot":
                    report.snapshots.append(obj)
                elif kind == "phase_row":
                    report.phase_rows.append((obj["name"], obj["value"], obj["note"]))
                else:
                    raise ValueError(f"{path}: unknown report line kind {kind!r}")
        return report

    # -- rendering ---------------------------------------------------------
    def bench_rows(self) -> list:
        """The report's rows for a bench summary: phase rows as they are,
        and the final snapshot's scalar counters as ``obs_<counter>`` rows
        with the slot count in the note."""
        rows = list(self.phase_rows)
        if self.snapshots:
            last = self.snapshots[-1]
            for name, value in last["counters"].items():
                if isinstance(value, (int, float)):
                    rows.append((f"obs_{name}", float(value), f"through slot {last['slot']}"))
        return rows

    def summary_table(self) -> str:
        """Human-readable run summary (the report CLI's default output)."""
        lines = ["== run =="]
        for k, v in sorted(self.meta.items()):
            lines.append(f"  {k:<24} {v}")
        if self.snapshots:
            last = self.snapshots[-1]
            lines.append(f"== counters (slot {last['slot']}, {len(self.snapshots)} drains) ==")
            for k, v in sorted(last["counters"].items()):
                lines.append(f"  {k:<24} {v}")
            for k, v in sorted(last.get("derived", {}).items()):
                lines.append(f"  {k:<24} {v}")
        if self.phase_rows:
            lines.append("== phases ==")
            for name, value, note in self.phase_rows:
                lines.append(f"  {name:<32} {value:>12.1f}us  {note}")
        return "\n".join(lines)


def _jsonable(v):
    if isinstance(v, (np.generic, np.ndarray)):
        return np.asarray(v).tolist()
    return v


def main(argv=None) -> int:
    """Entry point for ``python -m repro_torch.obs.report``."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a RunReport JSONL, or merge its rows into a bench summary.",
    )
    ap.add_argument("report", nargs="?", default=None, help="RunReport JSONL path")
    ap.add_argument(
        "--merge-bench", action="append", nargs="?", const=str(SUMMARY), default=[],
        metavar="PATH",
        help=f"merge the report's obs_* rows into this summary (repeatable; without "
        f"PATH: {SUMMARY})",
    )
    ap.add_argument("--validate-trace", default=None, metavar="TRACE",
                    help="assert a Chrome trace.json loads and carries spans")
    args = ap.parse_args(argv)
    if args.report is None and args.validate_trace is None:
        ap.error("nothing to do: pass a report JSONL and/or --validate-trace")
    if args.validate_trace is not None:
        from repro_torch.obs.trace import validate_trace

        n = validate_trace(args.validate_trace)
        print(f"{args.validate_trace}: valid Chrome trace, {n} spans")
    if args.report is not None:
        report = RunReport.from_jsonl(args.report)
        print(report.summary_table())
        rows = report.bench_rows()
        for path in args.merge_bench:
            merge_bench_summary(path, rows)
            print(f"merged {len(rows)} obs rows into {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Every control of a benchmark cell beside the program, seed by seed, on the chip.

    python3 tools/cell_controls.py --workload <cell> --seeds 11,12,13 [--seconds 2] [--out f.jsonl]

from the root of a checkout, on a machine with a CUDA card. For each seed:
the cell's set-up, a window of ``--seconds`` at the cell's own load, then
the comparison's numbers of the program and of each control that the
cell's loop puts in its place (``controls()`` of ``perfbench/loops/``),
read from the same checked starts. One JSON line a seed: the program's
numbers and verdict, each control's numbers and verdict under the cell's
limits (each has to come out false), the limits, the end-to-end metrics
and the peak bytes. ``perfbench/control.py`` prints the one control named
``control``; this prints them all.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                             controls=True)
        line = {"workload": cell.name, "seed": seed, "correct": r["correct"],
                "program": {k: v[0] for k, v in r["checks"].items()},
                "controls": r["control"], "controls_correct": r["control_correct"],
                "limits": cell.limits,
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del r
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that a cell's limits are set from, on the chip, in one process.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 --seconds 2 [--out f.jsonl]

For each seed: the cell's set-up, a short window at the cell's own load,
then the comparison's numbers of the program and of the control (the
reference in the program's place, in bfloat16; ``reference/control.py``)
read from the same checked starts. One JSON line a seed: the program's
numbers (lower readings) and verdict, the control's (upper readings) and
its verdict under the harness's own comparison (``control_correct``, which
has to come out false), the cell's limits and its end-to-end metrics. The
benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

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
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda", t0, controls=True)
        line = {"workload": cell.name, "seed": seed, "correct": r["correct"],
                "control_correct": r["control_correct"]["control"],
                "program": {k: v[0] for k, v in r["checks"].items()},
                "control": r["control"]["control"], "limits": cell.limits,
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

"""Where a benchmark cell's set-up goes, read from the port's own spans.

    python3 tools/setup_spans.py --workload <cell> --seed <n> [--seconds 10] [--trace 0|1]
                                 [--record 0|1]

from the root of a checkout, on a machine with a CUDA card. Runs the cell
as ``perfbench/harness.py::run_cell`` does up to the end of its window
(the inputs from the seed, the program's objects, the warm-up of the
mix's shapes, then ``--seconds`` of timed calls), with the port's recorder
(``repro_torch.obs.trace.recording``) active from the first line
(``--record 0`` leaves it off: the same run, for the recorder's cost), and
with ``--trace 1`` a profiled stretch of the mix's own calls whose idle
gaps are named by the innermost span over them, the program's spans
(``capture.replay``, ``capture.bind``) included. Prints one JSON line:

* ``setup_s``: the process's start to the first timed call, as the
  benchmark's ``setup_s``, here with the recorder on;
* ``spans``: each program span's exclusive seconds before the window;
* ``phases``: their sums by the groups of :data:`PHASES`, and ``rest_s``,
  what they leave of ``setup_s`` (the interpreter, the imports, CUDA's
  lazy start, the benchmark's own inputs and warm-up driving);
* ``imports_s``: of ``rest_s``, the process's start to the run's first
  line (the interpreter and the imports), and ``before_s`` to the card's
  context (CUDA's lazy start besides);
* ``bench_spans``: the benchmark's own spans (``setup.inputs`` ...);
* ``updates_per_s``: the window's applied updates over its time, with the
  recorder on, and ``window_spans``: the program spans' exclusive seconds
  in the window;
* with ``--trace 1``, ``idle_gaps`` as the benchmark names them, and
  ``gap_spans``: for each of those gaps, its start in us from the traced
  stretch's first device event and every span over it, the outermost
  first, as ``[name, us from the span's start, span us]``.

It checks nothing: the benchmark's own run decides ``correct``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# The program's set-up spans by what they do.
PHASES = {
    "host_prep": ("graph.validate", "objective.host", "partition.cut", "halo.plan"),
    "to_device": ("objective.tensors", "mix.tables", "engine.tables", "engine.init_state"),
    "kernels": ("kernels.build", "kernels.load"),
    "capture": ("engine.warm_slot", "capture.graph"),
}


def phases(spans: dict) -> dict:
    """The sums of :data:`PHASES` over ``{name: exclusive seconds}``; a group
    none of whose spans was recorded is left out."""
    return {k: sum(spans[n] for n in names if n in spans)
            for k, names in PHASES.items() if any(n in spans for n in names)}


def gap_spans(device_events, spans, k: int = 10) -> list:
    """For the ``k`` longest gaps between device work (those that
    ``perfbench/trace.py::idle_gaps`` names), ``[seconds, start, covers]``:
    the gap's start in us from the first device event, and every span over
    it, outermost first, as ``[name, us from its start, its us]``."""
    from perfbench import trace as tr

    iv = tr.busy_intervals(device_events)
    gaps = sorted(((iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)
                   if iv[i + 1][0] > iv[i][1]), key=lambda g: g[0] - g[1])[:k]
    first = iv[0][0] if iv else 0.0
    return [[(e - s) / 1e6, s - first,
             [[n, s - t, d] for n, t, d in sorted(spans, key=lambda x: -x[2]) if t <= s < t + d]]
            for s, e in gaps]


def measure(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
            record: bool = True) -> dict:
    """One run of ``cell`` through the end of its window (and its traced
    stretch) with the port's recorder active (``record``); the fields of
    the line."""
    import contextlib

    import torch

    from perfbench import harness
    from perfbench import trace as tr
    from perfbench.data import agents
    from perfbench.data.problem import make_problem
    from repro_torch.obs import SpanRecorder, recording

    device = torch.device(device)
    lp = harness.loop(cell)
    bench = tr.Spans()
    rec = SpanRecorder(device)
    gaps = covers = None
    imports_s = time.perf_counter() - t_start
    with recording(rec) if record else contextlib.nullcontext():
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.cuda.synchronize(device)
        before_s = time.perf_counter() - t_start
        seeds = agents.stream_seeds(seed)
        with bench.span("setup.inputs"):
            prob = make_problem(cell.config, cell.traffic, seeds, device)
        prog = lp.Program(cell.config, cell.traffic, prob, seeds, device, bench)
        prog.warm()
        u0 = prog.updates()
        harness.sync(device)
        t0 = time.perf_counter()
        setup = rec.seconds()
        calls = 0
        while True:
            prog.call()
            calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        harness.sync(device)
        window_s = time.perf_counter() - t0
        updates = prog.updates() - u0
        window = {k: v - setup.get(k, 0.0) for k, v in rec.seconds().items()}
        if traced:
            ctx, breakdown = harness._traced_stretch(prog, device, bench)
            gaps = breakdown["idle_gaps"]
            covers = gap_spans(ctx["device"], ctx["spans"])
    setup_s = t0 - t_start
    split = phases(setup)
    return {"cell": cell.name, "seed": seed, "device": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "setup_s": setup_s, "phases": split, "rest_s": setup_s - sum(split.values()),
            "imports_s": imports_s, "before_s": before_s, "spans": setup, "bench_spans": bench.seconds, "calls": calls,
            "window_s": window_s, "updates_per_s": updates / window_s, "window_spans": window,
            "idle_gaps": gaps, "gap_spans": covers}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"{cell.name} needs a CUDA device", file=sys.stderr)
        return 2
    line = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                   bool(args.record))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The harness: one cell of BENCHMARK.json, set up, measured and checked.

A cell names a configuration (``configs/<config>.json``: the deployment's
shapes and guarantees, its graph's generator ``data/<generator>.py``) and a
traffic mix (``traffic/<mix>.json``: the window's parameters as data),
which names its loop (``loops/<loop>.py``); its limits sit in
``limits/<cell>.json`` and each metric, end-to-end or per-layer, is read
by ``metrics/<metric>.py``. Adding a cell, a mix, a loop or a metric adds
files and entries; nothing here names one.

A loop module holds what one way of driving the program needs:
``Program(cfg, traffic, problem, seeds, device, spans)`` (its ``unit``,
``steps``, ``warm()``, the timed ``call()``, ``updates()``, ``dropped()``,
``finish(window)``: the window's own numbers, and optionally
``phase_prefixes()``), ``reference(cfg, problem, device)``, ``check(...)``:
the comparison's numbers of the program and of any controls, and
``controls(...)``: the control in the program's place.

A run: the inputs from the seed (``data/``), the program's objects
(``repro_torch``: the system under test), a warm-up of the shapes the mix
uses, the timed window (host clock from the first timed call to the
synchronize after the last), with ``--trace 1`` a profiled stretch and the
loop's phase programs, then the comparison with the plain reference
(``reference/``) on states that the timed path produced.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from perfbench import trace as tr
from perfbench.data import agents
from perfbench.data.problem import make_problem

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
FOREIGN = ("jax", "jaxlib", "flax", "repro")  # top-level names no run may load


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def load_cell(name: str, config_overrides=None, traffic_overrides=None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files; the overrides
    replace top-level keys (the tests' small copies)."""
    bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = {**_json(ROOT / files[w["config"]]), **(config_overrides or {})}
    traffic = {**_json(BENCH / "traffic" / f"{w['traffic']}.json"), **(traffic_overrides or {})}
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in names else [])]
    return Cell(name, config, traffic, int(w["chips"]), _json(BENCH / "limits" / f"{name}.json"),
                e2e, per_layer)


def foreign_modules() -> list:
    """Modules loaded in this process whose top-level name is a forbidden one."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FOREIGN})


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- the run -----------------------------------------------------------------

_MODULES: dict = {}


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` (a loop or a metric's reader), loaded
    once by its path: names may hold dots."""
    key = (kind, name)
    if key not in _MODULES:
        path = BENCH / kind / f"{name}.py"
        if not path.is_file():
            raise SystemExit(f"no {kind} {name!r}: {path.relative_to(ROOT)} is missing")
        spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod  # a dataclass looks its module up there
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def reader(name: str):
    """The reader of the metric ``name``: ``read(ctx)``, None where it finds
    nothing to read."""
    return module("metrics", name).read


def loop(cell: Cell):
    """The loop module that the cell's traffic mix names."""
    return module("loops", cell.traffic["loop"])


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit."""
    return all(numbers[k] <= limits[k] for k in numbers)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             controls: bool = False) -> dict:
    """One run of ``cell``; returns the result line's fields. With
    ``controls`` the control's numbers are read from the same starts too
    (under ``"control"``, with its verdict under ``"control_correct"``),
    for control.py."""
    device = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    lp = loop(cell)
    spans = tr.Spans()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.synchronize(device)  # the context exists before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    seeds = agents.stream_seeds(seed)
    with spans.span("setup.inputs"):
        prob = make_problem(cfg, traffic, seeds, device)
    prog = lp.Program(cfg, traffic, prob, seeds, device, spans)
    prog.warm()
    u0, d0, s0 = prog.updates(), prog.dropped(), prog.steps
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    calls = 0
    while True:
        prog.call()
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    updates, steps = prog.updates() - u0, prog.steps - s0
    dropped = prog.dropped() - d0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window = {"seconds": window_s, "updates": updates, "calls": calls, "steps": steps}
    own = prog.finish(window)
    log(f"[run] {cell.name} seed={seed} setup_s={setup_s:.3f} window_s={window_s:.3f} "
        f"calls={calls} updates={updates} peak_bytes={peak} spans={spans.seconds}")
    ctx = {"config": cfg, "traffic": traffic, "unit": prog.unit, "n": prob.n, "nnz": prob.nnz,
           "setup_seconds": setup_s, "window": window, "trace": None, "phases": None}
    result = {"correct": None, "attempted": updates + dropped, "failed": dropped}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        ctx["trace"], breakdown = _traced_stretch(prog, device, spans)
        device_info["busy_s"] = ctx["trace"]["busy_s"]
        device_info["window_s"] = ctx["trace"]["seconds"]
        if hasattr(prog, "phase_prefixes"):
            ctx["phases"] = prog.phase_prefixes()
            log(f"[phases] {cell.name} prefix us a {prog.unit}: "
                + " ".join(f"{k}={v * 1e6:.3f}" for k, v in ctx["phases"].items())
                + f"; the window's {prog.unit} {window_s / max(steps, 1) * 1e6:.3f}")
    # The comparison, once the window has closed and the peak has been read.
    ref = lp.reference(cfg, prob, device)
    ctrl = lp.controls(cfg, prog, ref, device) if controls else ()
    check = lp.check(prog, cfg, traffic, ref, seeds, ctrl)
    numbers = {**check["program"], **own}
    limits = cell.limits
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise SystemExit(f"{cell.name}: no limit for {missing} in limits/{cell.name}.json")
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result.update(correct=verdict(numbers, limits), metrics=metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: [numbers[k], limits[k]] for k in sorted(numbers)}
    if controls:
        result["control"] = {k: v for k, v in check.items() if k != "program"}
        result["control_correct"] = {k: verdict(v, limits) for k, v in result["control"].items()}
    return result


def _traced_stretch(prog, device, spans):
    """Profile ``traffic.trace_calls`` timed calls; returns the readers'
    trace context and the breakdown."""
    from torch.profiler import ProfilerActivity, profile

    calls = int(prog.traffic["trace_calls"])
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    u0, s0 = prog.updates(), prog.steps
    with profile(activities=acts) as prof:
        sync(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            prog.call()
        sync(device)
        wall = time.perf_counter() - t0
    updates, steps = prog.updates() - u0, prog.steps - s0
    ev = tr.read_profile(prof)
    busy = tr.busy_seconds(ev["device"])
    ctx = {"seconds": wall, "updates": updates, "calls": calls, "steps": steps,
           "busy_s": busy, "device": ev["device"], "spans": ev["spans"]}
    breakdown = {"device_ops": tr.top_ops(ev["device"]),
                 "idle_gaps": tr.idle_gaps(ev["device"], ev["spans"])}
    log(f"[trace] {calls} calls, {wall:.6f} s, device busy {busy:.6f} s, "
        f"{len(ev['device'])} device events, {updates} updates")
    return ctx, breakdown

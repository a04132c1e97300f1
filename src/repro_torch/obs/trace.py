"""Super-tick phase tracing: host span recorder + prefix-timing profiler.

Port of ``repro.obs.trace``. The ``sharded_roofline_supertick_gap`` row
says how far the measured super-tick sits from its bound, not which phase
takes the difference; two mechanisms say that:

* :class:`SpanRecorder` spans are annotated for ``torch.profiler``
  (``record_function``) and, when the recorder's device is a CUDA device,
  as NVTX ranges, so device traces line up with the host spans;
* :func:`profile_supertick` measures per-phase time **by prefix
  differencing**: the engines expose ``phase_program(upto)``, the sampled
  slot cut after a named phase (on the card a captured CUDA graph of its
  own, on a scratch copy of the state), so timing each prefix and
  differencing consecutive prefixes attributes the slot's time phase by
  phase. The phase times sum to the last prefix's time by construction
  (up to the clamping of timing noise).

:meth:`SpanRecorder.export_chrome_trace` writes the reference's
Chrome/Perfetto ``trace.json``; :func:`validate_trace` is its loader, and
each package reads the other's trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import numpy as np
import torch


class SpanRecorder:
    """Lightweight host-side span recorder with Chrome-trace export.

    Spans land in the ``traceEvents`` "X" (complete-event) form; wall
    times are ``time.perf_counter`` microseconds relative to the
    recorder's creation. ``tid`` separates tracks (0 = live host spans,
    1 = synthetic per-phase attribution). ``device``: where the traced
    work runs; on a CUDA device every live span is also an NVTX range.
    """

    def __init__(self, device=None):
        self._t0 = time.perf_counter()
        self.events: list[dict] = []
        self.nvtx = device is not None and torch.device(device).type == "cuda"

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, tid: int = 0, **args):
        """Record a live span around a host-side section (also annotated
        for ``torch.profiler``, and for NVTX on a CUDA device)."""
        start = self._now_us()
        with torch.profiler.record_function(name):
            if self.nvtx:
                torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                if self.nvtx:
                    torch.cuda.nvtx.range_pop()
        self.add(name, start, self._now_us() - start, tid=tid, **args)

    def add(self, name: str, start_us: float, dur_us: float, tid: int = 0, **args):
        """Append one complete event (used for synthetic attribution spans)."""
        self.events.append(
            {
                "name": name,
                "ph": "X",
                "ts": float(start_us),
                "dur": float(max(dur_us, 0.0)),
                "pid": 0,
                "tid": int(tid),
                "args": {k: _jsonable(v) for k, v in args.items()},
            }
        )

    def export_chrome_trace(self, path: str) -> None:
        """Write the collected spans as a Chrome/Perfetto ``trace.json``."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events, "displayTimeUnit": "ms"}, f, indent=1)


def _jsonable(v):
    if isinstance(v, (np.generic, np.ndarray)):
        return np.asarray(v).tolist()
    return v


def validate_trace(path: str) -> int:
    """Load a ``trace.json`` and return its span count.

    Raises ``ValueError`` when the file is not a Chrome-trace object or
    carries no spans, or when an event lacks its name or phase.
    """
    with open(path) as f:
        data = json.load(f)
    events = data.get("traceEvents") if isinstance(data, dict) else None
    if not isinstance(events, list) or not events:
        raise ValueError(f"{path} is not a Chrome trace with events")
    for e in events:
        if not isinstance(e, dict) or "name" not in e or "ph" not in e:
            raise ValueError(f"{path} carries a malformed trace event: {e!r}")
    return len(events)


@dataclasses.dataclass
class PhaseProfile:
    """Per-phase wall-clock attribution of one engine super-tick."""

    phases: dict  # name -> seconds per slot (prefix-differenced)
    total_s: float  # sum of the phase times (last prefix time + noise clamps)
    measured_s: float  # independently timed full-slot wall-clock
    prefix_s: dict  # name -> seconds of the cumulative prefix program

    def rows(self, prefix: str = "obs_phase") -> list:
        """CSV-style ``(name, us, note)`` rows for the bench summary."""
        out = [
            (f"{prefix}_{name}", s * 1e6, f"{100.0 * s / max(self.total_s, 1e-12):.1f}% of slot")
            for name, s in self.phases.items()
        ]
        cov = self.total_s / max(self.measured_s, 1e-12)
        out.append(
            (
                f"{prefix}_total",
                self.total_s * 1e6,
                f"sum of phases; measured full slot {self.measured_s * 1e6:.4g}us "
                f"(coverage {cov:.2f})",
            )
        )
        return out

    @property
    def coverage(self) -> float:
        """Sum of the phases over the independently timed full slot."""
        return self.total_s / max(self.measured_s, 1e-12)


def profile_supertick(
    engine,
    state=None,
    inner: int = 4,
    repeats: int = 3,
    recorder: SpanRecorder | None = None,
) -> PhaseProfile:
    """Attribute one sampled super-tick's time to its phases.

    Each prefix program is loaded with ``state`` once (on the card that
    captures it), run once to warm, then timed best-of-``repeats`` over
    ``inner`` back-to-back runs on the engine's scratch state (host clock,
    the device synchronized at the end of each loop); consecutive prefixes
    are differenced. ``state`` and its generator are left as they were. A
    ``recorder`` collects the live timing spans and a synthetic per-phase
    track laid out as one reconstructed super-tick; pass the same recorder
    across calls to accumulate one trace file.
    """
    if state is None:
        state = engine.init_state(np.zeros((engine.n, engine.p)))
    recorder = SpanRecorder(engine.device) if recorder is None else recorder
    names = list(engine.phase_names)
    cuda = engine.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(engine.device)

    def timed(program, label):
        program.load(state)
        program.run()  # warm
        sync()
        best = float("inf")
        for _ in range(repeats):
            with recorder.span(f"obs.time.{label}"):
                t0 = time.perf_counter()
                for _ in range(inner):
                    program.run()
                sync()
                best = min(best, (time.perf_counter() - t0) / inner)
        return best

    prefix_s = {}
    for name in names:
        prefix_s[name] = timed(engine.phase_program(name), f"prefix.{name}")
    measured = timed(engine.phase_program(None), "full_slot")

    phases, prev, cursor = {}, 0.0, 0.0
    for name in names:
        dt = max(prefix_s[name] - prev, 0.0)
        phases[name] = dt
        prev = prefix_s[name]
        recorder.add(f"obs.phase.{name}", cursor * 1e6, dt * 1e6, tid=1)
        cursor += dt
    return PhaseProfile(
        phases=phases,
        total_s=sum(phases.values()),
        measured_s=measured,
        prefix_s=prefix_s,
    )

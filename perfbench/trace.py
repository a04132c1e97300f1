"""Host spans and the device trace of a traced stretch.

Spans are ``torch.profiler.record_function`` ranges recorded from the
benchmark's own files around the calls into the program, so the profiler
puts them on the device events' clock. The reading of the profiler's
results follows the port's ``chip_smoke.py`` (kernels, copies and fills are
the device's work; a ``record_function`` range's device shadow is not).
"""

from __future__ import annotations

import contextlib
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Named host spans: seconds by name always; on the profiler's timeline
    while a profile runs."""

    def __init__(self):
        self.seconds: dict = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0


def _device_cat(e):
    if hasattr(e, "activity_type"):
        cat = e.activity_type()
        return cat if cat in DEVICE_CATS else None
    if e.is_user_annotation():
        return None
    name = e.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else (
        "gpu_memset" if name.startswith("Memset") else "kernel")


def read_profile(prof) -> dict:
    """``{"device": [(name, start_us, dur_us)], "spans": [(name, start_us, dur_us)]}``
    of a finished profile, on one clock."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                spans.append((e.name(), start, dur))
        elif _device_cat(e) is not None:
            device.append((e.name(), start, dur))
    return {"device": device, "spans": spans}


def busy_intervals(device_events) -> list:
    """The union of the device events' intervals, sorted, as (start, end) us."""
    out = []
    for _, s, d in sorted(device_events, key=lambda e: e[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return out


def busy_seconds(device_events) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in busy_intervals(device_events)) / 1e6


def top_ops(device_events, k: int = 10) -> list:
    """The ``k`` device operations that took most time: [[name, seconds]]."""
    by: dict = {}
    for name, _, d in device_events:
        by[name] = by.get(name, 0.0) + d / 1e6
    return [[n[:200], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(device_events, spans, k: int = 10) -> list:
    """The ``k`` longest gaps between device work, each named by the
    innermost host span that covers the gap's start ("host" where none
    does): [[name, seconds]]."""
    iv = busy_intervals(device_events)
    gaps = [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1) if iv[i + 1][0] > iv[i][1]]
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for s, e in gaps[:k]:
        cover = [(d, n) for n, t, d in spans if t <= s < t + d]
        out.append([min(cover)[1] if cover else "host", (e - s) / 1e6])
    return out

"""``repro_torch.obs`` — the engine's device telemetry and run reports.

Port of the parts of ``repro.obs`` the engines need:

* :mod:`repro_torch.obs.metrics` — :class:`MetricsSpec` selects counter
  groups; the engine carries the resulting metrics leaves through its
  captured super-ticks (``EngineConfig(metrics=...)``), updated in place
  on the device, so collection adds no host reads and leaves Theta
  bit-exact; :class:`ExchangeVolume` is the sharded engine's per-slot
  halo volume its ``exchange`` counters add;
* :mod:`repro_torch.obs.trace` — :class:`SpanRecorder` (spans annotated
  for ``torch.profiler``, and as NVTX ranges on a CUDA device) with the
  reference's Chrome-trace export, and :func:`profile_supertick`, which
  attributes a super-tick's time to its named phases by differencing the
  engines' phase programs;
* :mod:`repro_torch.obs.roofline` — the slot's counted bytes and flops
  placed on the card's peaks (``supertick_report``);
* :mod:`repro_torch.obs.report` — :class:`RunReport` (periodic metric
  drains and phase rows, JSONL round trip in the reference's format) and
  the ``python -m repro_torch.obs.report`` CLI.

The dynamic-topology counters (``TOPOLOGY_COUNTERS``) are host-side:
both engines keep them in ``topology_counters()`` and add them to a
dynamic engine's ``metrics_snapshot`` derived dict as ``topology_*``.
The serving counters (``SERVE_COUNTERS``, :func:`serve_counters_init`)
are host-side too: :class:`repro_torch.serve.ServeHandle` keeps them.
"""

from repro_torch.obs.metrics import (
    SERVE_COUNTERS,
    TOPOLOGY_COUNTERS,
    ExchangeVolume,
    MetricsAccumulator,
    MetricsSpec,
    serve_counters_init,
    summarize_counters,
    topology_log_init,
)
from repro_torch.obs.report import RunReport, merge_bench_summary
from repro_torch.obs.trace import PhaseProfile, SpanRecorder, profile_supertick, validate_trace

__all__ = [
    "ExchangeVolume",
    "MetricsAccumulator",
    "MetricsSpec",
    "PhaseProfile",
    "RunReport",
    "SERVE_COUNTERS",
    "SpanRecorder",
    "TOPOLOGY_COUNTERS",
    "merge_bench_summary",
    "profile_supertick",
    "serve_counters_init",
    "summarize_counters",
    "topology_log_init",
    "validate_trace",
]

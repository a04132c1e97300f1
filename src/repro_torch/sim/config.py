"""Typed engine configuration (port of ``repro.sim.config``).

:class:`EngineConfig` is the one frozen bundle of clock, batching,
scenario and device knobs the :class:`repro_torch.sim.AsyncEngine` takes
(``config=...``); keyword arguments to the engine or to
:func:`make_engine` override its fields. The port adds ``device``,
which defaults to ``"cuda"``: building a config for CUDA on a machine
without a CUDA device raises and names the field. ``steps_per_chunk``
sizes the engine's chunks as in the reference: there a jitted
``lax.scan``, here a captured CUDA graph replayed on the card.

The reference's fields for the parts not ported yet are kept so that a
config naming them fails loudly instead of being ignored: setting any of
them raises ``NotImplementedError`` with its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.sim.scenarios import Scenario

# Field -> (value that means "off", the ROADMAP item that ports it).
_LATER_FIELDS = {
    "partition_mode": ("degree", "A9 (sharded engine)"),
    "relabel": (None, "A9 (sharded engine)"),
    "coords": (None, "A9 (sharded engine)"),
    "exchange": (None, "A9 (sharded engine)"),
    "partition": (None, "A9 (sharded engine)"),
    "devices": (None, "A9 (sharded engine)"),
    "graph_update": (None, "A11 (dynamic topology)"),
    "drift_threshold": (0.25, "A11 (dynamic topology)"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything an engine run needs besides the update rule itself.

    * ``slot_wakes``: expected wake-ups per super-tick (sets tau);
    * ``rates``: per-agent Poisson rates (None = all 1.0);
    * ``batch_size``: static woken-rows batch B (None = mean + 6 sigma);
    * ``scenario``: churn / delay / straggler bundle (None = none);
    * ``seed``: seed of the engine's ``torch.Generator`` on ``device``;
    * ``dtype``: model dtype (torch.float32 by default);
    * ``steps_per_chunk``: super-ticks per chunk — on a CUDA device
      ``AsyncEngine.advance`` replays a CUDA graph of this many slots
      (and a graph of one slot for a remainder); on the CPU the slots run
      one by one, the chunking only setting when ``run`` may stop;
    * ``fused``: woken-row hot path — ``"auto"`` runs the fused CUDA kernel
      for a float32 engine on a CUDA device with a quadratic-loss update
      and no delay scenario, ``True`` asks for the fused path wherever it
      is supported (its plain version on the CPU), ``False`` keeps the
      unfused gather / mix / update / scatter;
    * ``metrics``: device telemetry — a
      :class:`repro_torch.obs.MetricsSpec` selecting counter groups,
      ``True`` for the default spec, ``None``/``False`` (default) for no
      collection. Metrics-on runs are bit-exact in Theta with metrics-off;
    * ``device``: where the engine runs, ``"cuda"`` unless the caller
      asks for ``"cpu"``.
    """

    slot_wakes: float = 64.0
    rates: Any = None
    batch_size: int | None = None
    scenario: Scenario | None = None
    seed: int = 0
    dtype: Any = torch.float32
    steps_per_chunk: int = 16
    fused: Any = "auto"  # False | True | "auto"
    device: Any = "cuda"
    metrics: Any = None  # MetricsSpec | True | False | None
    partition_mode: str = "degree"
    relabel: Any = None
    coords: Any = None
    exchange: Any = None
    partition: Any = None
    devices: Any = None
    graph_update: Any = None
    drift_threshold: float = 0.25

    def __post_init__(self):
        if self.fused not in (False, True, "auto"):
            raise ValueError(f"fused must be False, True, or 'auto', got {self.fused!r}")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or torch.float64, got {self.dtype!r}")
        if int(self.steps_per_chunk) < 1:
            raise ValueError(f"steps_per_chunk must be >= 1, got {self.steps_per_chunk!r}")
        for name, (off, item) in _LATER_FIELDS.items():
            value = getattr(self, name)
            if (value is not None) if off is None else (value != off):
                raise NotImplementedError(
                    f"EngineConfig.{name} belongs to ROADMAP item {item}, "
                    "which is not ported yet"
                )
        resolve_device(self.device, "EngineConfig.device")

    def metrics_spec(self):
        """The coerced telemetry spec (None = collection off, the default)."""
        from repro_torch.obs.metrics import MetricsSpec

        return MetricsSpec.coerce(self.metrics)

    def replace(self, **overrides) -> "EngineConfig":
        """A copy with the given fields replaced (dataclasses.replace)."""
        return dataclasses.replace(self, **overrides)


def resolve_config(config: EngineConfig | None, overrides: dict) -> EngineConfig:
    """Merge constructor ``**kwargs`` overrides into a (default) config."""
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = sorted(set(overrides) - fields)
    if unknown:
        raise TypeError(f"unknown engine option(s) {unknown}")
    if config is None:
        return EngineConfig(**overrides)
    return dataclasses.replace(config, **overrides) if overrides else config


def make_engine(update, config: EngineConfig | None = None, *, shards=None, **overrides):
    """Build the engine: the single-device :class:`AsyncEngine`. ``shards``
    (the sharded engine) is ROADMAP item A9, not ported yet."""
    from repro_torch.sim.engine import AsyncEngine

    if shards:
        raise NotImplementedError(
            "make_engine(shards=...) needs the sharded engine, ROADMAP item A9, "
            "which is not ported yet"
        )
    return AsyncEngine(update, config=resolve_config(config, overrides))

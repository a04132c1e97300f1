"""Typed engine configuration (port of ``repro.sim.config``).

:class:`EngineConfig` is the one frozen bundle of clock, batching,
scenario, placement and device knobs the engines take (``config=...``);
keyword arguments to an engine or to :func:`make_engine` override its
fields. The port adds ``device``, which defaults to ``"cuda"``: building
a config for CUDA on a machine without a CUDA device raises and names the
field. ``steps_per_chunk`` sizes the engine's chunks as in the reference:
there a jitted ``lax.scan``, here a captured CUDA graph replayed on the
card.

The sharded engine's fields (``partition_mode``, ``relabel``,
``coords``, ``exchange``, ``partition``, ``devices``) are live. Its S
shards are stacked on ``device``, or held one a process: ``devices`` a
1-D ``torch.distributed`` ``DeviceMesh`` named ``"shards"`` (the
reference's ``Mesh(devices, ("shards",))``) puts shard ``rank`` on this
process's ``device``. A list of several devices raises: in the port one
process drives one device. ``graph_update`` and ``drift_threshold``
drive dynamic topology in both engines.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.mixing import ExchangeSpec
from repro_torch.device import resolve_device
from repro_torch.sim.scenarios import Scenario

def _device_key(device) -> tuple:
    """A device named by ``device`` as (type, index), a CUDA device without
    an index taken as the current one (or 0 without CUDA)."""
    dev = torch.device(device)
    index = dev.index
    if dev.type == "cuda" and index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() else 0
    return dev.type, index


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

    The sharded engine's placement and exchange (ignored by the
    single-device engine):

    * ``partition_mode``: ``"degree"`` | ``"contiguous"`` block cutting;
    * ``relabel``: ``"rcm"`` | ``"sfc"`` | ``"hilbert"`` | an explicit
      permutation | None;
    * ``coords``: (n, 2) agent positions for the space-filling curves;
    * ``exchange``: :class:`repro_torch.core.mixing.ExchangeSpec` (None =
      defaults; bare strings coerce with a deprecation warning);
    * ``partition``: a prebuilt ``GraphPartition`` to reuse;
    * ``devices``: None, or a list naming ``device`` alone: the S shards
      are stacked on one device; or a 1-D ``DeviceMesh`` whose dimension
      is named ``"shards"``: one shard a rank of it, on ``device``. A
      list of more than one distinct device raises
      ``NotImplementedError``: one process drives one device.

    Dynamic topology (both engines; an engine is dynamic when
    ``graph_update`` is set or the scenario has arrivals):

    * ``graph_update``: a :class:`repro_torch.sim.GraphUpdate` edge
      refresh fired every ``graph_update.every`` slots (None = static);
    * ``drift_threshold``: the sharded engine's repartition trigger — a
      structural swap whose cut-fraction drift exceeds it rebuilds the
      partition, anything at or below it patches the standing one.
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
        resolve_device(self.device, "EngineConfig.device")
        if self.devices is not None and hasattr(self.devices, "mesh_dim_names"):
            names = tuple(self.devices.mesh_dim_names or ())
            if names != ("shards",):
                raise ValueError(
                    f"EngineConfig.devices as a DeviceMesh must be 1-D with its dimension "
                    f"named 'shards' (one shard a rank), got dimensions {names}")
        elif self.devices is not None:
            named = {_device_key(d) for d in self.devices}
            if len(named) > 1:
                raise NotImplementedError(
                    f"EngineConfig.devices names {len(named)} devices, but in the port one "
                    "process drives one device: stack the shards on EngineConfig.device, "
                    "or run one process a device and give EngineConfig.devices a 1-D "
                    "DeviceMesh named 'shards' (one shard a rank)"
                )
            if named and named != {_device_key(self.device)}:
                raise ValueError(
                    f"EngineConfig.devices={list(self.devices)!r} must name "
                    f"EngineConfig.device={str(self.device)!r}: the shards are stacked on it"
                )

    def exchange_spec(self) -> ExchangeSpec:
        """The coerced exchange spec (warns on deprecated bare strings)."""
        return ExchangeSpec.coerce(self.exchange)

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
    """Build the right engine for ``shards``: None/0 -> the single-device
    :class:`AsyncEngine`, otherwise :class:`ShardedAsyncEngine` with that
    many shards: one a rank when ``devices`` is a ``"shards"`` mesh or a
    default process group of more than one rank is initialized (the
    shard count and the group's size must agree), else stacked on
    ``device``. ``overrides`` replace fields of ``config``."""
    from repro_torch.sim.engine import AsyncEngine, ShardedAsyncEngine

    cfg = resolve_config(config, overrides)
    if not shards:
        return AsyncEngine(update, config=cfg)
    group = None
    if not hasattr(cfg.devices, "get_group"):
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            group = dist.group.WORLD
    return ShardedAsyncEngine(update, num_shards=int(shards), config=cfg, group=group)

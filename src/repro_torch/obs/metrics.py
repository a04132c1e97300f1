"""Device-side engine telemetry: the metrics leaves and their accumulator.

Port of ``repro.obs.metrics``. The engines run whole chunks of
super-ticks as captured CUDA graphs on the card
(:mod:`repro_torch.sim.capture`); anything worth observing (realized
wake rates against the Poisson clocks, halo traffic, quantization error,
DP budget burn-down, churn, staleness) therefore has to be accumulated
*inside* the captured slot: a host read per slot would end the graph.
This module provides:

* :class:`MetricsSpec` — a small frozen selector of counter groups,
  carried on :class:`repro_torch.sim.EngineConfig` (``metrics=``;
  ``True`` coerces to the default spec, ``None``/``False`` disables
  collection entirely — the default, so runs pay nothing unless asked);
* :class:`ExchangeVolume` — the sharded engine's static per-shard wire
  volume of one slot's halo exchange;
* :class:`MetricsAccumulator` — built once per engine with the static
  context (row count, shard count, churn/straggler presence, DP budget
  limit, exchange-plan shape), it owns the metrics leaves: :meth:`init`
  makes the zeroed tensors on the device it is given (``SimState.metrics``;
  the sharded engine's leaves carry a leading (S,) shard axis), and
  :meth:`tick` advances them IN PLACE inside the slot, so a captured
  graph keeps updating the same buffers.

Every counter is computed from values the super-tick already produces —
no extra random draws, no host reads — so a metrics-on run is bit-exact
in Theta with a metrics-off run (``tests/test_torch_obs.py``,
``tests/test_torch_sharded_engine.py``).

Counter groups (leaves present only when the spec selects them and the
engine context supports them):

* ``wakes``: ``wakes_realized`` (wake mask sum before straggler/capacity
  losses), ``wakes_thinned`` (straggler drops), ``wakes_capacity_dropped``
  (static-batch overflow), ``wakes_applied`` (rows actually written);
* ``churn``: cumulative ``churn_departures`` / ``churn_rejoins``
  (active-flag transitions of the churn Markov chain);
* ``privacy``: ``dp_updates_applied`` (cumulative private updates) and
  ``dp_budget_stopped`` (gauge: agents at their planned budget now);
* ``exchange`` (sharded engine only): ``border_rows_published`` plus
  ``exchange_rows`` / ``exchange_bytes`` shipped per shard (padded rows:
  static shapes ship them), and per-ring-offset ``p2p_rows_by_offset`` /
  ``p2p_bytes_by_offset`` under the point-to-point plan, added from the
  :meth:`ExchangeVolume.tiles` each slot;
* ``quantization`` (sharded engine, compressed wire): cumulative squared
  quantization error ``quant_err_sq`` and the current error-feedback
  residual energy ``ef_residual_sq`` (a gauge), float32 as in the
  reference;
* ``staleness``: a log2-bucketed histogram of slots-since-last-update
  per applied wake plus the ``last_wake`` slot marker it needs (dropped
  from drains: it is state, not a counter).

The counting leaves are int64 tensors, byte counts included (the
reference's are int32, its byte counts float32): the engine's own
counters are int64 too, and a float32 byte count stops being exact past
2^24 bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """Selects which counter groups the engine accumulates on the device.

    Fields toggle groups (see the module docstring for the leaves each
    one contributes); ``staleness_buckets`` sizes the staleness
    histogram (bucket b collects staleness in slots ``[2^b, 2^(b+1))``,
    the last bucket open-ended). ``exchange`` and ``quantization`` select
    the sharded engine's groups, kept so that a spec built for either
    package means the same thing.
    """

    wakes: bool = True
    exchange: bool = True
    quantization: bool = True
    privacy: bool = True
    churn: bool = True
    staleness: bool = True
    staleness_buckets: int = 8

    def __post_init__(self):
        if self.staleness_buckets < 1:
            raise ValueError("staleness_buckets must be >= 1")

    @classmethod
    def coerce(cls, value) -> "MetricsSpec | None":
        """Accept a spec, ``True`` (defaults), or ``None``/``False`` (off)."""
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        raise TypeError(
            f"metrics must be a MetricsSpec, True, False, or None, got {type(value)!r}"
        )


@dataclasses.dataclass(frozen=True)
class ExchangeVolume:
    """Per-shard static interconnect volume of one slot's halo exchange.

    Built once at engine build from the partition's plan, as in the
    reference; every array carries a leading shard axis (per-shard border
    sizes differ). Rows are padded rows, because static shapes ship them.
    """

    border_rows: np.ndarray  # (S,) real border rows published per slot
    rows_shipped: np.ndarray  # (S,) padded rows sent on the wire per slot
    bytes_shipped: np.ndarray  # (S,) rows_shipped * payload bytes per row
    p2p_rows: np.ndarray | None = None  # (S, O) padded P_d per ring offset
    p2p_bytes: np.ndarray | None = None  # (S, O)

    @property
    def num_offsets(self) -> int:
        """O: ring offsets in the point-to-point plan (0 for all_gather)."""
        return 0 if self.p2p_rows is None else int(self.p2p_rows.shape[1])

    def tiles(self, device) -> dict:
        """The (S, ...) volumes as int64 tensors on ``device``, the
        per-slot increments of the ``exchange`` counters."""
        def t(a):
            return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)

        out = {"border_rows": t(self.border_rows), "rows_shipped": t(self.rows_shipped),
               "bytes_shipped": t(self.bytes_shipped)}
        if self.p2p_rows is not None:
            out["p2p_rows"] = t(self.p2p_rows)
            out["p2p_bytes"] = t(self.p2p_bytes)
        return out


class MetricsAccumulator:
    """Owns the metrics leaves for one engine instance.

    ``rows`` is the scatter domain (n for the single-device engine, R per
    shard for the sharded one, whose ``shards`` S gives every leaf a
    leading (S,) axis). Optional context enables groups:
    ``churn``/``straggler`` flags, ``dp_limit`` (the planned per-agent
    update budget ``planned_Ti``), ``exchange_offsets`` (None = no halo
    exchange; an int = the point-to-point plan's offset count, 0 for the
    all_gather wire) and ``quantized`` (the halo wire is lossy and reports
    error stats). Groups whose context is absent contribute no leaves,
    whatever the spec says — the set of leaves is fixed at engine build.
    """

    def __init__(
        self,
        spec: MetricsSpec,
        rows: int,
        *,
        churn: bool = False,
        straggler: bool = False,
        dp_limit: int | None = None,
        exchange_offsets: int | None = None,
        quantized: bool = False,
        shards: int | None = None,
    ):
        self.spec = spec
        self.rows = int(rows)
        self.churn = bool(churn) and spec.churn
        self.straggler = bool(straggler) and spec.wakes
        self.dp_limit = dp_limit if spec.privacy else None
        self.exchange_offsets = exchange_offsets if spec.exchange else None
        self.quantized = bool(quantized) and spec.quantization
        self.shards = None if shards is None else int(shards)

    # -- leaves ------------------------------------------------------------
    def _layout(self) -> dict:
        """Each leaf's shape (without the shard axis) and dtype."""
        i64, f32 = torch.int64, torch.float32
        m: dict = {}
        if self.spec.wakes:
            for k in ("wakes_realized", "wakes_capacity_dropped", "wakes_applied"):
                m[k] = ((), i64)
            if self.straggler:
                m["wakes_thinned"] = ((), i64)
        if self.churn:
            m["churn_departures"] = ((), i64)
            m["churn_rejoins"] = ((), i64)
        if self.dp_limit is not None:
            m["dp_updates_applied"] = ((), i64)
            m["dp_budget_stopped"] = ((), i64)
        if self.exchange_offsets is not None:
            for k in ("border_rows_published", "exchange_rows", "exchange_bytes"):
                m[k] = ((), i64)
            if self.exchange_offsets > 0:
                m["p2p_rows_by_offset"] = ((self.exchange_offsets,), i64)
                m["p2p_bytes_by_offset"] = ((self.exchange_offsets,), i64)
        if self.quantized:
            m["quant_err_sq"] = ((), f32)
            m["ef_residual_sq"] = ((), f32)
        if self.spec.staleness:
            m["staleness_hist"] = ((self.spec.staleness_buckets,), i64)
            m["last_wake"] = ((self.rows,), i64)
        return m

    def init(self, device) -> dict:
        """The zeroed metrics leaves on ``device`` (given by the caller:
        the engine passes its own)."""
        lead = () if self.shards is None else (self.shards,)
        return {k: torch.zeros(lead + shape, dtype=dt, device=device)
                for k, (shape, dt) in self._layout().items()}

    def leaf_kinds(self) -> dict:
        """Classify each metrics leaf for a checkpoint layer:
        ``"per_agent"`` leaves are keyed by agent row (``last_wake``),
        ``"counter"`` leaves are additive accumulators."""
        return {k: "per_agent" if k == "last_wake" else "counter" for k in self._layout()}

    # -- in-slot update ----------------------------------------------------
    def tick(
        self,
        m: dict,
        *,
        ptr,
        wake_pre,
        wake,
        applied,
        slot_rows,
        capacity_dropped,
        active_prev=None,
        active_new=None,
        dp_counts=None,
        exchange=None,
        quant_stats=None,
    ) -> dict:
        """Advance the metrics leaves by one slot, in place; returns ``m``.

        ``ptr`` is the slot counter before this slot; ``wake_pre`` the wake
        mask before straggler thinning, ``wake`` the realized mask;
        ``slot_rows`` the slot's (B,) distinct in-range scatter rows (equal
        to the woken agents where ``applied``; see
        ``AsyncEngine._compact``), ``applied`` their applied mask;
        ``capacity_dropped`` the static-batch overflow count; ``dp_counts``
        the private update's applied-update counts after this slot. The
        sharded engine passes every input with its shard axis: ``ptr``,
        ``capacity_dropped`` (S,), the masks and counts (S, R), and
        ``slot_rows`` as flat rows ``s * R + r`` of all S shards, with
        ``exchange`` (:meth:`ExchangeVolume.tiles`) and ``quant_stats``
        (the halo wire's (S,) error stats). All are values the slot already
        computed: the accumulator draws no randomness, never touches Theta
        and reads nothing on the host.
        """
        if self.shards is None:
            def count(x):
                return x.sum()
        else:
            S = self.shards

            def count(x):
                return x.reshape(S, -1).sum(dim=1)
        applied_count = count(applied)
        if self.spec.wakes:
            m["wakes_realized"].add_(count(wake_pre))
            m["wakes_capacity_dropped"].add_(capacity_dropped)
            m["wakes_applied"].add_(applied_count)
            if self.straggler:
                m["wakes_thinned"].add_(count(wake_pre & ~wake))
        if self.churn and active_prev is not None:
            m["churn_departures"].add_(count(active_prev & ~active_new))
            m["churn_rejoins"].add_(count(~active_prev & active_new))
        if self.dp_limit is not None and dp_counts is not None:
            m["dp_updates_applied"].add_(applied_count)
            m["dp_budget_stopped"].copy_(count(dp_counts >= self.dp_limit))  # a gauge
        if self.exchange_offsets is not None and exchange is not None:
            m["border_rows_published"].add_(exchange["border_rows"])
            m["exchange_rows"].add_(exchange["rows_shipped"])
            m["exchange_bytes"].add_(exchange["bytes_shipped"])
            if self.exchange_offsets > 0:
                m["p2p_rows_by_offset"].add_(exchange["p2p_rows"])
                m["p2p_bytes_by_offset"].add_(exchange["p2p_bytes"])
        if self.quantized and quant_stats is not None:
            m["quant_err_sq"].add_(quant_stats["quant_err_sq"])
            m["ef_residual_sq"].copy_(quant_stats["ef_residual_sq"])  # a gauge
        if self.spec.staleness:
            nb = self.spec.staleness_buckets
            last = m["last_wake"].view(-1)
            hist = m["staleness_hist"].view(-1)
            seen = last[slot_rows]
            if self.shards is None:
                now, base = ptr, 0
            else:
                shard = torch.div(slot_rows, self.rows, rounding_mode="floor")
                now, base = ptr[shard], shard * nb
            stale = (now - seen).to(torch.float32)
            bucket = torch.clamp(
                torch.floor(torch.log2(torch.clamp(stale, min=1.0))), 0, nb - 1
            ).to(torch.int64)
            # Integer adds at in-range buckets; a row not applied adds 0 (no
            # drop-mode scatter in torch, as for the DP counts).
            hist.index_add_(0, base + bucket, applied.reshape(-1).to(torch.int64))
            # slot_rows are distinct: a row not applied writes back its own value.
            last.index_copy_(0, slot_rows, torch.where(applied.reshape(-1), now + 1, seen))
        return m

    # -- host drain --------------------------------------------------------
    def snapshot(self, m: dict) -> dict:
        """Device metrics -> host dict of numpy arrays (drain helper). The
        internal ``last_wake`` marker is dropped — it is state, not a
        counter."""
        return {k: v.to("cpu", copy=True).numpy() for k, v in m.items() if k != "last_wake"}


# Host-side dynamic-topology counters, kept in a plain dict by both engines
# (``topology_counters()``; ``topology_<key>`` in a dynamic engine's derived
# metrics), in the reference's layout. A static engine leaves them at zero.
TOPOLOGY_COUNTERS = (
    "edge_refreshes",  # GraphUpdate.refresh rounds fired
    "edges_added",  # undirected edges created across all topology swaps
    "edges_removed",  # undirected edges dropped across all topology swaps
    "weight_patches",  # same-structure partition rebinds (weights only)
    "structural_patches",  # GraphPartition.patch() calls (ownership frozen)
    "repartitions",  # full partition_graph rebuilds (drift over threshold)
    "arrivals",  # agents admitted mid-run
    "last_drift",  # gauge: cut-fraction drift measured at the last swap
)


def topology_log_init() -> dict:
    """A fresh host-side dynamic-topology counter dict (all zeros)."""
    return {k: (0.0 if k == "last_drift" else 0) for k in TOPOLOGY_COUNTERS}


# Host-side serving counters, in the reference's layout: serving happens on
# the host (snapshot publication from run() events, batched predict() calls
# against the latest published version), so repro_torch.serve.ServeHandle
# keeps a plain dict of these.
SERVE_COUNTERS = (
    "serve_requests",  # predict()/rows() calls answered
    "serve_predictions",  # total rows scored across all batches
    "serve_batch_rows_max",  # gauge: largest request batch seen
    "serve_cold_starts",  # rows synthesized via the Eq. 16 neighbour average
    "serve_snapshots_published",  # publish() calls (one per snapshot_every slots)
    "serve_version_lag",  # gauge: newest published slot minus the slot just served
    "serve_version_lag_max",  # worst version lag any request observed
    "serve_publish_s_total",  # wall seconds spent publishing snapshots (float)
)


def serve_counters_init() -> dict:
    """A fresh host-side serving counter dict (all zeros)."""
    return {k: (0.0 if k == "serve_publish_s_total" else 0) for k in SERVE_COUNTERS}


def summarize_counters(snapshot: dict) -> dict:
    """Collapse a snapshot into JSON-ready totals.

    Scalar counters become Python numbers; histogram and per-offset
    vectors keep their own axis (returned as lists), summed over a
    leading shard axis where one is present, as the reference does.
    """
    vector = ("staleness_hist", "p2p_rows_by_offset", "p2p_bytes_by_offset")
    out: dict = {}
    for k, v in snapshot.items():
        a = np.asarray(v)
        if k in vector:
            collapsed = a.sum(axis=0) if a.ndim > 1 else a
            cast = float if collapsed.dtype.kind == "f" else int
            out[k] = [cast(x) for x in collapsed]
        else:
            out[k] = float(a.sum()) if a.dtype.kind == "f" else int(a.sum())
    return out

"""Device-side engine telemetry: the metrics leaves and their accumulator.

Port of ``repro.obs.metrics`` (the groups the single-device engine has).
The engine runs whole chunks of super-ticks as captured CUDA graphs on
the card (:mod:`repro_torch.sim.capture`); anything worth observing
(realized wake rates against the Poisson clocks, DP budget burn-down,
churn, staleness) therefore has to be accumulated *inside* the captured
slot: a host read per slot would end the graph. This module provides:

* :class:`MetricsSpec` — a small frozen selector of counter groups,
  carried on :class:`repro_torch.sim.EngineConfig` (``metrics=``;
  ``True`` coerces to the default spec, ``None``/``False`` disables
  collection entirely — the default, so runs pay nothing unless asked);
* :class:`MetricsAccumulator` — built once per engine with the static
  context (row count, churn/straggler presence, DP budget limit), it
  owns the metrics leaves: :meth:`init` makes the zeroed tensors that
  ride in ``SimState.metrics``, and :meth:`tick` advances them IN PLACE
  inside the slot, so a captured graph keeps updating the same buffers.

Every counter is computed from values the super-tick already produces —
no extra random draws, no host reads — so a metrics-on run is bit-exact
in Theta with a metrics-off run (``tests/test_torch_obs.py``).

Counter groups (leaves present only when the spec selects them and the
engine context supports them):

* ``wakes``: ``wakes_realized`` (wake mask sum before straggler/capacity
  losses), ``wakes_thinned`` (straggler drops), ``wakes_capacity_dropped``
  (static-batch overflow), ``wakes_applied`` (rows actually written);
* ``churn``: cumulative ``churn_departures`` / ``churn_rejoins``
  (active-flag transitions of the churn Markov chain);
* ``privacy``: ``dp_updates_applied`` (cumulative private updates) and
  ``dp_budget_stopped`` (gauge: agents at their planned budget now);
* ``staleness``: a log2-bucketed histogram of slots-since-last-update
  per applied wake plus the ``last_wake`` slot marker it needs (dropped
  from drains: it is state, not a counter).

The reference's ``exchange`` and ``quantization`` groups belong to the
sharded engine (ROADMAP A9); the single-device engine has none of their
leaves, in the reference as here. Counters are int64 tensors (the
reference's are int32): the engine's own counters are int64 too.
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


class MetricsAccumulator:
    """Owns the metrics leaves for one engine instance.

    ``rows`` is the scatter domain (n for the single-device engine).
    Optional context enables groups: ``churn``/``straggler`` flags and
    ``dp_limit`` (the planned per-agent update budget ``planned_Ti``).
    Groups whose context is absent contribute no leaves, whatever the
    spec says — the set of leaves is fixed at engine build.
    """

    def __init__(
        self,
        spec: MetricsSpec,
        rows: int,
        *,
        churn: bool = False,
        straggler: bool = False,
        dp_limit: int | None = None,
    ):
        self.spec = spec
        self.rows = int(rows)
        self.churn = bool(churn) and spec.churn
        self.straggler = bool(straggler) and spec.wakes
        self.dp_limit = dp_limit if spec.privacy else None

    # -- leaves ------------------------------------------------------------
    def init(self, device="cpu") -> dict:
        """The zeroed metrics leaves on ``device``."""
        def zeros(shape=()):
            return torch.zeros(shape, dtype=torch.int64, device=device)

        m: dict = {}
        if self.spec.wakes:
            m["wakes_realized"] = zeros()
            m["wakes_capacity_dropped"] = zeros()
            m["wakes_applied"] = zeros()
            if self.straggler:
                m["wakes_thinned"] = zeros()
        if self.churn:
            m["churn_departures"] = zeros()
            m["churn_rejoins"] = zeros()
        if self.dp_limit is not None:
            m["dp_updates_applied"] = zeros()
            m["dp_budget_stopped"] = zeros()
        if self.spec.staleness:
            m["staleness_hist"] = zeros((self.spec.staleness_buckets,))
            m["last_wake"] = zeros((self.rows,))
        return m

    def leaf_kinds(self) -> dict:
        """Classify each metrics leaf for a checkpoint layer:
        ``"per_agent"`` leaves are keyed by agent row (``last_wake``),
        ``"counter"`` leaves are additive accumulators."""
        return {k: "per_agent" if k == "last_wake" else "counter" for k in self.init()}

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
    ) -> dict:
        """Advance the metrics leaves by one slot, in place; returns ``m``.

        ``ptr`` is the slot counter before this slot; ``wake_pre`` the wake
        mask before straggler thinning, ``wake`` the realized mask;
        ``slot_rows`` the slot's (B,) distinct in-range scatter rows (equal
        to the woken agents where ``applied``; see
        ``AsyncEngine._compact``), ``applied`` their applied mask;
        ``capacity_dropped`` the static-batch overflow count; ``dp_counts``
        the private update's (n,) applied-update counts after this slot.
        All are values the slot already computed: the accumulator draws no
        randomness, never touches Theta and reads nothing on the host.
        """
        applied_count = applied.sum()
        if self.spec.wakes:
            m["wakes_realized"].add_(wake_pre.sum())
            m["wakes_capacity_dropped"].add_(capacity_dropped)
            m["wakes_applied"].add_(applied_count)
            if self.straggler:
                m["wakes_thinned"].add_((wake_pre & ~wake).sum())
        if self.churn and active_prev is not None:
            m["churn_departures"].add_((active_prev & ~active_new).sum())
            m["churn_rejoins"].add_((~active_prev & active_new).sum())
        if self.dp_limit is not None and dp_counts is not None:
            m["dp_updates_applied"].add_(applied_count)
            m["dp_budget_stopped"].copy_((dp_counts >= self.dp_limit).sum())  # a gauge
        if self.spec.staleness:
            nb = self.spec.staleness_buckets
            last = m["last_wake"]
            seen = last[slot_rows]
            stale = (ptr - seen).to(torch.float32)
            bucket = torch.clamp(
                torch.floor(torch.log2(torch.clamp(stale, min=1.0))), 0, nb - 1
            ).to(torch.int64)
            # Integer adds at in-range buckets; a row not applied adds 0 (no
            # drop-mode scatter in torch, as for the DP counts).
            m["staleness_hist"].index_add_(0, bucket, applied.to(torch.int64))
            # slot_rows are distinct: a row not applied writes back its own value.
            last.index_copy_(0, slot_rows, torch.where(applied, ptr + 1, seen))
        return m

    # -- host drain --------------------------------------------------------
    def snapshot(self, m: dict) -> dict:
        """Device metrics -> host dict of numpy arrays (drain helper). The
        internal ``last_wake`` marker is dropped — it is state, not a
        counter."""
        return {k: v.to("cpu", copy=True).numpy() for k, v in m.items() if k != "last_wake"}


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

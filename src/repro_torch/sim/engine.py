"""Batched asynchronous simulation engine: Poisson super-ticks on a device.

Port of ``repro.sim.engine``'s static-topology engines: the single-device
:class:`AsyncEngine` and the sharded :class:`ShardedAsyncEngine`, whose S
agent blocks are stacked on one device (see its docstring). The n i.i.d. Poisson clocks are time-slotted by
binomial thinning (:mod:`repro_torch.sim.clocks`): each **super-tick**
wakes a random subset of agents, computes their updates (Eq. 4, the
private Eq. 6 or Eq. 16, by the ``LocalUpdate``) from the start-of-slot
snapshot and writes them back. Two paths run the woken rows:

* unfused — ``MixOp.gather_rows`` (the ``sparse_mix`` CUDA kernel on a
  sparse graph) → ``LocalUpdate.apply`` → scatter;
* fused — one ``fused_row_update`` CUDA kernel call that gathers, mixes,
  updates and scatters (``fused="auto"`` picks it for a float32 engine on
  a CUDA device with a quadratic-loss update and no delay scenario).

Deviations from pure Poisson semantics, as in the reference: slotted
thinning (at most one update per agent per slot), bounded staleness (one
slot), a static slot capacity B whose overflow is dropped and counted,
churn caching, and FIFO per-edge delays (``src/repro_torch/DEVIATIONS.md``
lists them and the port's own).

The slot keeps static shapes and never reads a device value on the host
(no ``.item()``, ``nonzero()`` or Python branch on a tensor), so a whole
slot is a fixed sequence of launches, and it updates every state tensor
in place (``Theta``, the delay history, the counters, the churn flags,
the update's state and the metrics): a state passed to
:meth:`AsyncEngine.step` or :meth:`AsyncEngine.advance` is consumed by it
(clone what you want to keep). That is what lets :meth:`AsyncEngine.advance`
replay a chunk of slots as a captured CUDA graph on the card
(:mod:`repro_torch.sim.capture`), the counterpart of the reference's
jitted ``lax.scan`` chunk; on the CPU the slots run one by one. Random
draws come from one ``torch.Generator`` on the engine's device, seeded
from ``EngineConfig.seed``; they are not the reference's ``jax.random``
draws, so runs agree with the reference through forced wake sets and in
distribution, not draw for draw. With ``EngineConfig(metrics=...)`` the
slot also advances the device counters of :mod:`repro_torch.obs`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import as_csr, neighbor_counts
from repro_torch.core.mixing import sharded_mix_op
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_row_update import MAX_M, MAX_P
from repro_torch.obs.metrics import ExchangeVolume, MetricsAccumulator, topology_log_init
from repro_torch.obs.report import RunReport
from repro_torch.sim import clocks
from repro_torch.sim.capture import ChunkGraphs
from repro_torch.sim.config import EngineConfig, resolve_config
from repro_torch.sim.partition import partition_graph
from repro_torch.sim.scenarios import Scenario
from repro_torch.sim.updates import LocalUpdate


def _resolve_fused(update, fused, device: torch.device, dtype, has_delay: bool, p: int,
                   m: int) -> bool:
    """Resolve the tri-state ``fused`` knob against what the kernel serves.

    ``"auto"`` engages the fused kernel on a CUDA device for a float32
    engine whose update implements the fused row math (CD or DP-CD with
    the quadratic loss), has no per-edge delays, and whose width ``p`` and
    points per agent ``m`` the kernel takes (``p <= MAX_P``,
    ``m <= MAX_M``); anything else keeps the unfused path. ``True`` asks
    for the fused path wherever the update supports it — the kernel on
    CUDA, its plain version on the CPU — and raises at construction where
    it cannot serve (a delay scenario, another loss, a float64 engine: the
    kernel computes in float32, or p or m beyond the kernel's limits, on
    either device, so a CPU run refuses what the card would). ``False``
    keeps the unfused path.
    """
    supported = bool(getattr(update, "fused_supported", False)) and not has_delay
    fits = p <= MAX_P and m <= MAX_M
    if fused == "auto":
        return supported and fits and device.type == "cuda" and dtype == torch.float32
    if fused:
        if not supported:
            reason = "a delay scenario" if has_delay else type(update).__name__
            raise ValueError(f"fused=True but the fused path does not serve {reason}")
        if dtype != torch.float32:
            raise ValueError(f"fused=True runs the float32 kernel; the engine dtype is {dtype}")
        if not fits:
            raise ValueError(f"fused=True but the fused kernel takes p <= {MAX_P} and "
                             f"m <= {MAX_M}, got p={p}, m={m}")
        return True
    return False


class SimState(NamedTuple):
    """Engine state carried from slot to slot (tensors on the engine's
    device, each updated in place by the slot)."""

    Theta: torch.Tensor  # (n, p) current models
    hist: torch.Tensor  # (depth, n, p) start-of-slot snapshot ring (delay only)
    ptr: torch.Tensor  # () int64 slot counter
    active: torch.Tensor  # (n,) bool churn state
    generator: torch.Generator  # the engine's random stream
    ustate: object  # LocalUpdate state
    applied: torch.Tensor  # () int64: updates actually written
    dropped: torch.Tensor  # () int64: wakes lost to slot capacity
    messages: torch.Tensor  # () float32: cumulative p-vectors transmitted
    metrics: object = None  # dict of device counters (None: EngineConfig.metrics
    # is off; see repro_torch.obs.metrics)


@dataclasses.dataclass
class SimResult:
    """Outcome of an engine run (counters are totals since ``init_state``)."""

    Theta: np.ndarray  # final (n, p)
    objective: np.ndarray | None  # recorded Q values (None if not recorded)
    messages: float
    wakes_applied: int
    wakes_dropped: int
    slots: int
    active: np.ndarray  # final (n,) churn state
    update_state: object  # final LocalUpdate state
    state: SimState  # full engine state, resumable via ``run(state=...)``
    report: object = None  # repro_torch.obs.RunReport when run(metrics_every=) drained


def _check_recordable(update, record_every: int) -> None:
    """Recording needs an objective; asking for one the update cannot
    produce is an error, not a silent no-op."""
    if record_every > 0 and not hasattr(update, "objective"):
        raise ValueError(
            f"record_every={record_every} requires the update to expose an "
            f"objective method; {type(update).__name__} has none"
        )


def _drive_slots(state, slots: int, stride: int, advance, events=()):
    """Run ``slots`` super-ticks through ``advance(state, steps)`` in
    ``stride``-sized chunks, the tail one slot at a time, so that only two
    chunk lengths ever run (on the card: two captured graphs). ``events``
    is a list of ``(every, callback)`` pairs; each callback fires with the
    state whenever the completed slot count hits a multiple of its period,
    and once more at the end when ``slots`` is not a multiple (a run always
    closes with a final record or drain). ``stride`` must divide every
    period, or fire points fall between chunks (callers pass the gcd).
    The reference's driver, unchanged."""
    events = [(int(every), cb) for every, cb in events if cb is not None and every > 0]
    done = 0
    while done < slots:
        steps = min(stride, slots - done)
        if steps == stride:
            state = advance(state, stride)
        else:
            for _ in range(steps):
                state = advance(state, 1)
        done += steps
        for every, cb in events:
            if done % every == 0 or done == slots:
                cb(state)
    return state


def _event_stride(events, default: int) -> int:
    """The chunk stride serving ``(every, cb)`` events: gcd of the periods
    (so every fire point lands on a chunk boundary), or ``default``."""
    periods = [int(every) for every, cb in events if cb is not None and every > 0]
    return math.gcd(*periods) if periods else default


def _run_driver(engine, Theta0, slots: int, *, record_every: int = 0, state=None,
                metrics_every: int = 0, report=None):
    """The run loop behind ``AsyncEngine.run``: objective recording every
    ``record_every`` slots and metric drains into a
    :class:`repro_torch.obs.RunReport` every ``metrics_every``, as
    ``(every, callback)`` events of :func:`_drive_slots`, chunked at
    :func:`_event_stride`. Returns ``(state, objective, report)``."""
    _check_recordable(engine.update, record_every)
    if metrics_every > 0 and engine._macc is None:
        raise ValueError(
            "metrics_every requires metrics collection on; construct the "
            "engine with EngineConfig(metrics=True) (or a MetricsSpec)"
        )
    state = engine.init_state(Theta0) if state is None else state
    objective = [engine._objective_value(state)] if record_every > 0 else None
    if metrics_every > 0 and report is None:
        report = RunReport(meta=engine.report_meta())
    events = []
    if objective is not None:
        events.append((record_every, lambda s: objective.append(engine._objective_value(s))))
    if metrics_every > 0:

        def _drain(s):
            counters, derived = engine.metrics_snapshot(s)
            report.add_snapshot(engine._ptr_of(s), counters, derived)

        events.append((metrics_every, _drain))
    stride = _event_stride(events, engine.steps_per_chunk)
    state = _drive_slots(state, slots, stride, engine.advance, events)
    return state, objective, report


class AsyncEngine:
    """Batched event-driven driver for any :class:`LocalUpdate`, on one device.

    Configured by :class:`repro_torch.sim.EngineConfig` (``config=...``);
    keyword arguments (``slot_wakes``, ``rates``, ``batch_size``,
    ``scenario``, ``seed``, ``dtype``, ``steps_per_chunk``, ``fused``,
    ``metrics``, ``device``) override its fields.
    """

    def __init__(self, update: LocalUpdate, *, config: EngineConfig | None = None, **kw):
        cfg = resolve_config(config, kw)
        self.config = cfg
        self.update = update
        self.device = resolve_device(cfg.device, "EngineConfig.device")
        dev = self.device
        self.n, self.p = update.n, update.p
        self.dtype = cfg.dtype
        self._seed = int(cfg.seed)
        self.steps_per_chunk = int(cfg.steps_per_chunk)
        self.rates = clocks.normalize_rates(cfg.rates, self.n)
        self.tau = clocks.slot_duration(self.rates, cfg.slot_wakes)
        self.wake_probs = clocks.wake_probs(self.rates, self.tau)
        self.batch_size = (
            int(cfg.batch_size)
            if cfg.batch_size is not None
            else clocks.default_batch_size(self.rates, self.tau)
        )
        if not (0 < self.batch_size <= self.n):
            raise ValueError("batch_size must lie in (0, n]")
        self.scenario = cfg.scenario or Scenario()

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        self._wake_p = f32(self.wake_probs)
        self._deg_counts = f32(neighbor_counts(update.graph))
        churn = self.scenario.churn
        self._leave = f32(churn.leave_vector(self.n)) if churn else None
        self._rejoin = f32(churn.rejoin_vector(self.n)) if churn else None
        strag = self.scenario.straggler
        self._drop = f32(strag.drop_vector(self.n)) if strag else None
        self._arange_b = torch.arange(self.batch_size, device=dev)

        delay = self.scenario.delay
        self.depth = (delay.max_delay + 1) if delay else 1
        if delay:
            # Delayed mixing always runs over padded neighbour tiles: the
            # per-edge (delay, neighbour) pair gather has no dense form.
            idx, w = self._padded_tables(update)
            self._idx = torch.as_tensor(idx, dtype=torch.long, device=dev)
            self._w = torch.as_tensor(w, dtype=self.dtype, device=dev)
            self._delays = torch.as_tensor(
                delay.delay_tiles(idx.shape), dtype=torch.long, device=dev
            )
        else:
            self._idx = self._w = self._delays = None

        obj = getattr(update, "obj", None)  # the data of the updates the kernel serves
        self.fused = _resolve_fused(update, cfg.fused, dev, self.dtype, delay is not None,
                                    self.p, obj.data.X.shape[1] if obj is not None else 0)
        if self.fused:
            # The fused kernel consumes padded (n, K) neighbour tables
            # whatever the MixOp backend (dense graphs go through the CSR form).
            idx, w = self._padded_tables(update)
            self._fidx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
            self._fw = torch.as_tensor(w, dtype=torch.float32, device=dev)
        else:
            self._fidx = self._fw = None

        self.metrics_spec = cfg.metrics_spec()
        self._macc = (
            None
            if self.metrics_spec is None
            else MetricsAccumulator(
                self.metrics_spec,
                self.n,
                churn=self._leave is not None,
                straggler=self._drop is not None,
                dp_limit=getattr(update, "planned_Ti", None),
            )
        )
        # The captured chunks (sim/capture.py): on a CUDA device only.
        self._graphs = ChunkGraphs(self) if dev.type == "cuda" else None

    @staticmethod
    def _padded_tables(update):
        mix = update.mix
        if getattr(mix, "kind", None) == "sparse":
            return np.asarray(mix.idx), np.asarray(mix.w)
        return as_csr(update.graph).padded_neighbors()

    # -- state ------------------------------------------------------------
    def init_state(self, Theta0, seed: int | None = None) -> SimState:
        """Fresh engine state from an (n, p) initial model matrix (copied)."""
        dev = self.device
        if not isinstance(Theta0, torch.Tensor):
            Theta0 = torch.as_tensor(np.asarray(Theta0))
        Theta = Theta0.to(device=dev, dtype=self.dtype).clone()
        if Theta.shape != (self.n, self.p):
            raise ValueError(f"Theta0 must be {(self.n, self.p)}, got {tuple(Theta.shape)}")
        if self._delays is not None:
            hist = Theta.unsqueeze(0).repeat(self.depth, 1, 1)
        else:
            hist = torch.zeros((0, 0, 0), dtype=self.dtype, device=dev)  # no-delay placeholder
        gen = torch.Generator(device=dev)
        gen.manual_seed(self._seed if seed is None else int(seed))
        ustate = self.update.init_state()
        if isinstance(ustate, torch.Tensor):
            ustate = ustate.to(dev)
        return SimState(
            Theta=Theta,
            hist=hist,
            ptr=torch.zeros((), dtype=torch.long, device=dev),
            active=torch.ones(self.n, dtype=torch.bool, device=dev),
            generator=gen,
            ustate=ustate,
            applied=torch.zeros((), dtype=torch.long, device=dev),
            dropped=torch.zeros((), dtype=torch.long, device=dev),
            messages=torch.zeros((), dtype=torch.float32, device=dev),
            metrics=None if self._macc is None else self._macc.init(dev),
        )

    # -- one super-tick ----------------------------------------------------
    def _compact(self, wake):
        """The woken batch of a slot, at static shape (B,).

        Returns ``(woken, slot_rows, valid, dropped)``: ``woken`` holds the
        woken agents in ascending order, padded with the sentinel n;
        ``valid`` marks the real entries; wakes past the capacity B are
        ``dropped`` (a 0-d count). ``slot_rows`` equals ``woken`` on the
        valid entries and fills the padding with distinct agents outside
        the batch, so it is a set of B distinct in-range rows: gathers at
        it need no clamp and a scatter at it never writes a row twice.
        """
        B = self.batch_size
        csum = torch.cumsum(wake, dim=0)  # number woken up to and including i
        total = csum[-1]
        nvalid = torch.clamp(total, max=B)
        woken = torch.searchsorted(csum, self._arange_b + 1)  # n where fewer woke
        valid = woken < self.n
        outside = torch.cumsum(~(wake & (csum <= B)), dim=0)
        spare = torch.searchsorted(outside, self._arange_b - nvalid + 1)
        slot_rows = torch.where(valid, woken, spare)
        return woken, slot_rows, valid, total - nvalid

    def _slot(self, state: SimState, wake_mask) -> SimState:
        """One super-tick, in place; ``wake_mask`` forces the wake set (None
        samples it)."""
        n, dev = self.n, self.device
        gen = state.generator
        active_prev = active = state.active
        if wake_mask is None:
            if self._leave is not None:
                leave = torch.rand(n, generator=gen, device=dev) < self._leave
                rejoin = torch.rand(n, generator=gen, device=dev) < self._rejoin
                active = torch.where(active_prev, ~leave, rejoin)
            wake_pre = wake = (torch.rand(n, generator=gen, device=dev) < self._wake_p) & active
            if self._drop is not None:
                wake = wake_pre & (torch.rand(n, generator=gen, device=dev) >= self._drop)
        else:
            # Forced wake sets (tests/diagnostics): no churn transition, no
            # straggler losses — but departed agents still cannot wake.
            wake_pre = wake = wake_mask & active
        woken, slot_rows, valid, dropped = self._compact(wake)

        Theta = state.Theta
        hist = state.hist
        if self.fused:
            # One kernel call: gather + mix + Eq. 4 + masked scatter, in place.
            Theta, applied, ustate = self.update.apply_fused(
                Theta, woken, valid, gen, state.ustate, self._fidx[slot_rows], self._fw[slot_rows]
            )
        else:
            if self._delays is not None:
                hist.index_copy_(0, (state.ptr % self.depth).reshape(1), Theta.unsqueeze(0))
                cols = self._idx[slot_rows]  # (B, K)
                lag = torch.remainder(state.ptr - self._delays[slot_rows], self.depth)
                neigh = torch.einsum("bk,bkp->bp", self._w[slot_rows], hist[lag, cols])
            else:
                neigh = self.update.mix.gather_rows(Theta, woken)
            new_rows, applied, ustate = self.update.apply(
                Theta, woken, valid, neigh, gen, state.ustate
            )
            # Every new row is computed before any is written (the
            # start-of-slot snapshot); rows not applied write back their
            # own value, so the scatter touches B distinct rows.
            keep = torch.where(applied[:, None], new_rows.to(Theta.dtype), Theta[slot_rows])
            Theta.index_copy_(0, slot_rows, keep)

        if self._macc is not None:
            self._macc.tick(
                state.metrics,
                ptr=state.ptr,
                wake_pre=wake_pre,
                wake=wake,
                applied=applied,
                slot_rows=slot_rows,
                capacity_dropped=dropped,
                active_prev=active_prev,
                active_new=active,
                dp_counts=ustate if self._macc.dp_limit is not None else None,
            )
        # The counters and the churn flags, in place (a captured graph
        # replays these very tensors).
        deg = self._deg_counts[slot_rows]
        state.messages.add_(torch.where(applied, deg, 0.0).sum())
        state.applied.add_(applied.sum())
        state.dropped.add_(dropped)
        state.ptr.add_(1)
        if active is not active_prev:
            state.active.copy_(active)
        return state._replace(Theta=Theta, ustate=ustate)

    # -- drivers -----------------------------------------------------------
    def step(self, state: SimState, wake_mask) -> SimState:
        """One super-tick with an explicit (n,) boolean wake set."""
        if not isinstance(wake_mask, torch.Tensor):
            wake_mask = torch.as_tensor(np.asarray(wake_mask, dtype=bool))
        return self._slot(state, wake_mask.to(device=self.device, dtype=torch.bool))

    def advance(self, state: SimState, slots: int) -> SimState:
        """Run ``slots`` sampled super-ticks: on a CUDA device as replays of
        the captured chunk graphs (``slots // steps_per_chunk`` of the chunk,
        the rest of the one-slot graph; :mod:`repro_torch.sim.capture`), on
        the CPU one eager slot at a time. Both give the same bits."""
        if self._graphs is None:
            return self._eager_slots(state, slots)
        return self._graphs.advance(state, int(slots))

    def _eager_slots(self, state: SimState, slots: int) -> SimState:
        """``slots`` sampled super-ticks, one eager slot at a time (the CPU
        path; on the card, the yardstick of the captured chunk)."""
        for _ in range(int(slots)):
            state = self._slot(state, None)
        return state

    def _objective_value(self, state: SimState) -> float:
        """The update's objective at ``state`` (recording hook)."""
        return self.update.objective(state.Theta)

    def _ptr_of(self, state: SimState) -> int:
        """Host value of the slot counter (drain bookkeeping)."""
        return int(state.ptr)

    # -- telemetry -----------------------------------------------------------
    def metrics_snapshot(self, state: SimState) -> tuple:
        """Drain the device counters: ``(counters, derived)`` host dicts.

        ``counters`` are the accumulated leaves (numpy); ``derived`` adds
        host-computed values — the DP accountant's composed eps spend —
        that need update-rule context the device counters don't carry.
        """
        if self._macc is None:
            raise ValueError(
                "metrics collection is off; construct the engine with "
                "EngineConfig(metrics=True) (or a MetricsSpec)"
            )
        return self._macc.snapshot(state.metrics), self._derived_metrics(state.ustate)

    def _derived_metrics(self, ustate) -> dict:
        derived: dict = {}
        if self.metrics_spec.privacy and hasattr(self.update, "eps_spent"):
            eps = np.asarray(self.update.eps_spent(ustate))
            derived["dp_eps_spent_mean"] = float(eps.mean())
            derived["dp_eps_spent_max"] = float(eps.max())
        return derived

    def report_meta(self) -> dict:
        """Run metadata stamped into a :class:`repro_torch.obs.RunReport`."""
        return {
            "engine": type(self).__name__,
            "update": type(self.update).__name__,
            "n": self.n,
            "p": self.p,
            "slot_wakes": float(self.config.slot_wakes),
            "batch_size": int(self.batch_size),
            "fused": bool(self.fused),
            "dtype": str(self.dtype).replace("torch.", ""),
        }

    def run(
        self,
        Theta0,
        slots: int,
        record_every: int = 0,
        state: SimState | None = None,
        metrics_every: int = 0,
        report=None,
    ) -> SimResult:
        """Drive ``slots`` super-ticks from ``Theta0`` (or a resumed ``state``).

        ``record_every`` > 0 records the update's objective every that many
        slots (and at the start and the end). ``metrics_every`` > 0 drains
        the device metrics every that many slots (requires collection on —
        ``EngineConfig(metrics=...)``) into a
        :class:`repro_torch.obs.RunReport` returned as ``SimResult.report``;
        pass ``report=`` to keep appending to an existing one across resumed
        runs. The slots run in chunks of ``steps_per_chunk`` (of the gcd of
        the periods when any is set), as in the reference.
        """
        state, objective, report = _run_driver(
            self, Theta0, slots, record_every=record_every, state=state,
            metrics_every=metrics_every, report=report,
        )
        return SimResult(
            Theta=state.Theta.to("cpu", copy=True).numpy(),
            objective=np.asarray(objective) if objective is not None else None,
            messages=float(state.messages),
            wakes_applied=int(state.applied),
            wakes_dropped=int(state.dropped),
            slots=int(state.ptr),
            active=state.active.to("cpu", copy=True).numpy(),
            update_state=state.ustate,
            state=state,
            report=report,
        )


# ---------------------------------------------------------------------------
# The sharded engine: S agent blocks stacked on one device
# ---------------------------------------------------------------------------


class ShardedSimState(NamedTuple):
    """Sharded engine state: the S shards' leaves stacked (S, ...) on the
    engine's device, each updated in place by the slot."""

    Theta: torch.Tensor  # (S, R, p) agent blocks: a view of slab's first S * R rows
    active: torch.Tensor  # (S, R) bool churn state (padding rows: False)
    generator: torch.Generator  # the engine's random stream (all shards)
    ustate: object  # LocalUpdate state: () or (S, R) tiles of its (n,) leaf
    applied: torch.Tensor  # (S,) int64
    dropped: torch.Tensor  # (S,) int64
    messages: torch.Tensor  # (S,) float32
    ptr: torch.Tensor  # (S,) int64 slot counter (identical across shards)
    slab: torch.Tensor  # (S * (R + Hmax), p): the owned rows (Theta), then the halo rows
    ef: torch.Tensor | None = None  # (S, Bmax, p) error-feedback accumulator of the
    # compressed halo exchange (None unless the ExchangeSpec threads one)
    metrics: object = None  # dict of (S, ...) device counters (None: metrics off)


class ShardedAsyncEngine:
    """The sharded :class:`AsyncEngine`: S agent blocks stacked on one device.

    Port of the reference's ``ShardedAsyncEngine``, whose super-tick runs
    as one SPMD program over a ``shards`` mesh axis. Here the S shards'
    state and tiles are stacked (S, ...) tensors on ``EngineConfig.device``
    and one slot serves all of them: every shard samples its own wake set
    (static batch B_s each, compacted over S at once), publishes its
    border rows of the start-of-slot snapshot, the halo exchange
    (:class:`repro_torch.core.mixing.ShardedMixOp`: ``all_gather`` is the
    stacked pool, ``ppermute`` a roll along S) fills every shard's halo
    rows, and the woken rows are updated through the same Eq. 4 / Eq. 6 /
    Eq. 16 row formulas as the single-device engine and written back
    shard-locally.

    The shards' rows live in one slab: all owned rows (S * R), then all
    halo rows (S * Hmax); ``ShardedSimState.Theta`` is a view of the
    owned part. A fused slot is one ``fused_row_update`` launch over the
    whole slab (``limit`` S * R, sentinel S * R, the tiles remapped to
    slab rows), which writes the owned rows in place. An unfused slot
    gathers its neighbour sums with the reference's einsum over the slab
    (``ShardedMixOp.gather_rows``; the single-device engine's unfused
    gather is ``sparse_mix``).

    Locality and communication, as in the reference: ``relabel`` permutes
    agent positions before the block cut (ids seen by callers stay
    original), ``exchange`` (an :class:`ExchangeSpec`) picks the method
    and the wire's dtype and error feedback. Per-agent data and constants
    are tiled into the shard blocks (``update.agent_constants()``).
    Random draws come from one ``torch.Generator`` for all shards (the
    reference folds a key per shard), so sampled runs agree with the
    reference in distribution; forced wake sets (:meth:`step`) reproduce
    the single-device engine. Chunks of slots replay as captured CUDA
    graphs on the card, as for :class:`AsyncEngine`. Refused, each naming
    its ROADMAP item: per-edge delays (as in the reference), dynamic
    topology (A11), checkpoints (A12) and phase programs (A10b).
    """

    def __init__(self, update: LocalUpdate, *, num_shards: int, config: EngineConfig | None = None,
                 **kw):
        cfg = resolve_config(config, kw)
        self.config = cfg
        self.update = update
        self.device = resolve_device(cfg.device, "EngineConfig.device")
        self.n, self.p = update.n, update.p
        self.dtype = cfg.dtype
        self._seed = int(cfg.seed)
        self.steps_per_chunk = int(cfg.steps_per_chunk)
        self.scenario = cfg.scenario or Scenario()
        if self.scenario.delay is not None:
            raise NotImplementedError(
                "per-edge delays are single-device only (the snapshot-ring "
                "gather has no halo-exchange form yet); use AsyncEngine"
            )
        # Static topology only: EngineConfig refuses graph_update and
        # Scenario refuses arrivals (ROADMAP A11), and with them the
        # reference's refusal of fused=True on a dynamic graph.
        self.topology_log = topology_log_init()
        csr = as_csr(update.graph)
        self._csr = csr
        partition = cfg.partition
        if partition is not None:
            if partition.n != self.n or partition.num_shards != num_shards:
                raise ValueError(
                    f"prebuilt partition is (n={partition.n}, S={partition.num_shards}), "
                    f"engine needs (n={self.n}, S={num_shards})"
                )
            self.part = partition
        else:
            self.part = partition_graph(csr, num_shards, mode=cfg.partition_mode,
                                        relabel=cfg.relabel, coords=cfg.coords)
        self.exchange_spec = cfg.exchange_spec()
        self.smix = sharded_mix_op(self.part, exchange=self.exchange_spec)
        self.exchange_method = self.smix.method
        self.num_shards = self.part.num_shards

        self.rates = clocks.normalize_rates(cfg.rates, self.n)
        self.tau = clocks.slot_duration(self.rates, cfg.slot_wakes)
        self.wake_probs = clocks.wake_probs(self.rates, self.tau)
        R = self.part.rows_per_shard
        if cfg.batch_size is not None:
            if not (0 < cfg.batch_size <= R):
                raise ValueError(f"batch_size must lie in (0, R={R}]")
            self.batch_size = int(cfg.batch_size)
        else:
            # B_s from each shard's *owned agents'* rates (under a relabel the
            # bounds index positions, not ids), as in the reference.
            per_shard = max(
                clocks.default_batch_size(
                    self.rates[self.part.owned[s, : int(self.part.sizes[s])]], self.tau)
                for s in range(self.num_shards)
            )
            self.batch_size = int(min(per_shard, R))
        churn = self.scenario.churn
        self._leave_v = churn.leave_vector(self.n) if churn else None
        self._rejoin_v = churn.rejoin_vector(self.n) if churn else None
        strag = self.scenario.straggler
        self._drop_v = strag.drop_vector(self.n) if strag else None

        self.metrics_spec = cfg.metrics_spec()
        consts_fn = getattr(update, "agent_constants", None)
        self._consts_base = None if consts_fn is None else consts_fn()
        obj = getattr(update, "obj", None)
        self.fused = _resolve_fused(update, cfg.fused, self.device, self.dtype, False, self.p,
                                    obj.data.X.shape[1] if obj is not None else 0)
        self._use_ef = self.smix.error_feedback
        self._rebuild_static()
        self._graphs = ChunkGraphs(self) if self.device.type == "cuda" else None

    def _exchange_volume(self) -> ExchangeVolume:
        """Per-shard static wire volume of the configured halo exchange."""
        part, S = self.part, self.num_shards
        per_row = self.exchange_spec.payload_bytes_per_row(self.p)
        if self.smix.method == "p2p":
            widths = [int(d.shape[1]) for d in self.smix.p2p_dst]
            rows = int(sum(widths))
            if widths:
                p2p_rows = np.tile(np.asarray(widths, np.int32)[None], (S, 1))
                p2p_bytes = (p2p_rows * per_row).astype(np.float32)
            else:
                p2p_rows = p2p_bytes = None
        else:
            rows = int(self.smix.border.shape[1]) * (S - 1)
            p2p_rows = p2p_bytes = None
        rows_shipped = np.full(S, rows, np.int32)
        return ExchangeVolume(
            border_rows=np.asarray(part.border_sizes, np.int64).astype(np.int32),
            rows_shipped=rows_shipped,
            bytes_shipped=(rows_shipped * per_row).astype(np.float32),
            p2p_rows=p2p_rows,
            p2p_bytes=p2p_bytes,
        )

    def _rebuild_static(self) -> None:
        """The shard-resident device tiles, flat over the S * R owned rows:
        the wake, churn and straggler probabilities, the owned ids, the
        message degrees, the update's constants (float leaves in the engine
        dtype, padding rows 0), the fused kernel's slab tables and the
        exchange-volume tiles of the metrics."""
        part, dev, S = self.part, self.device, self.num_shards
        R, B = part.rows_per_shard, self.batch_size
        self.rows_per_shard = R
        owned = part.owned.reshape(-1).astype(np.int64)
        real = owned < self.n
        self._owned = torch.as_tensor(owned, device=dev)
        # Agent i's row of the (S * R, p) owned rows.
        self._agent_rows = torch.as_tensor(
            part.shard_of.astype(np.int64) * R + part.local_of, device=dev)
        real_t = torch.as_tensor(real, device=dev)
        take = torch.as_tensor(np.where(real, owned, 0), device=dev)

        def tile(a, dtype=torch.float32):
            """(n, ...) host array -> (S * R, ...) on the device, padding rows 0
            (``dtype`` None keeps an integer array's own)."""
            t = torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)[take]
            keep = real_t.view((-1,) + (1,) * (t.dim() - 1))
            return torch.where(keep, t, torch.zeros((), dtype=t.dtype, device=dev))

        def maybe(v):
            return None if v is None else tile(v).view(S, R)

        self._wake_p = tile(self.wake_probs).view(S, R)
        self._leave, self._rejoin, self._drop = (maybe(v) for v in
                                                  (self._leave_v, self._rejoin_v, self._drop_v))
        self._deg = tile(neighbor_counts(self._csr))
        self._consts = None
        if self._consts_base is not None:
            self._consts = {}
            for k, a in self._consts_base.items():
                a = np.asarray(a)
                self._consts[k] = tile(a, self.dtype if np.issubdtype(a.dtype, np.floating)
                                       else None)
        if self.fused:
            self._fidx = self.smix.table("flat_idx", dev, torch.int32)
            self._fw = self.smix.table("flat_w", dev, torch.float32)
        else:
            self._fidx = self._fw = None
        self._shard_base = (torch.arange(S, device=dev) * R)[:, None]
        self._arange_sb = torch.arange(B, device=dev).repeat(S, 1)

        if self.metrics_spec is None:
            self._macc = None
            self._mstatic = None
        else:
            vol = self._exchange_volume()
            self._macc = MetricsAccumulator(
                self.metrics_spec,
                R,
                churn=self._leave is not None,
                straggler=self._drop is not None,
                dp_limit=getattr(self.update, "planned_Ti", None),
                exchange_offsets=vol.num_offsets if self.smix.method == "p2p" else 0,
                quantized=self.smix.dtype != "f32",
                shards=S,
            )
            self._mstatic = None if self._macc.exchange_offsets is None else vol.tiles(dev)

    # -- state ------------------------------------------------------------
    def _state(self, Theta_rows, active, ustate) -> ShardedSimState:
        """A state around the (S * R, p) owned rows, the (S, R) churn flags
        and the update state, everything else zero."""
        dev, S, R = self.device, self.num_shards, self.rows_per_shard
        slab = torch.zeros((self.smix.slab_rows, self.p), dtype=self.dtype, device=dev)
        slab[: S * R] = Theta_rows
        gen = torch.Generator(device=dev)
        gen.manual_seed(self._seed)

        def zeros(dt):
            return torch.zeros(S, dtype=dt, device=dev)

        return ShardedSimState(
            Theta=slab[: S * R].view(S, R, self.p),
            active=active,
            generator=gen,
            ustate=ustate,
            applied=zeros(torch.long),
            dropped=zeros(torch.long),
            messages=zeros(torch.float32),
            ptr=zeros(torch.long),
            slab=slab,
            ef=self.smix.init_error_feedback(self.p, self.dtype, dev),
            metrics=None if self._macc is None else self._macc.init(dev),
        )

    def _shard_leaf(self, x) -> torch.Tensor:
        """An (n, ...) update-state leaf as its (S, R, ...) tiles."""
        x = x.to("cpu").numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if x.ndim == 0 or x.shape[0] != self.n:
            raise ValueError(
                "sharded engine needs per-agent update-state leaves with "
                f"leading dim n={self.n}, got shape {x.shape}"
            )
        return torch.as_tensor(self.part.pad_rows(x)).to(self.device)

    def init_state(self, Theta0, seed: int | None = None) -> ShardedSimState:
        """Fresh sharded state from an (n, p) initial model matrix (original
        agent order; the partition maps it to the shard blocks)."""
        if isinstance(Theta0, torch.Tensor):
            Theta0 = Theta0.to("cpu").numpy()
        Theta = np.asarray(Theta0)
        if Theta.shape != (self.n, self.p):
            raise ValueError(f"Theta0 must be {(self.n, self.p)}, got {Theta.shape}")
        S, R = self.num_shards, self.rows_per_shard
        rows = torch.as_tensor(self.part.pad_rows(Theta)).to(self.device, self.dtype)
        active = torch.as_tensor(self.part.pad_rows(np.ones(self.n, bool), fill=False))
        ustate = self.update.init_state()
        if not (isinstance(ustate, tuple) and not ustate):
            ustate = self._shard_leaf(ustate)
        state = self._state(rows.view(S * R, self.p), active.to(self.device), ustate)
        if seed is not None:
            state.generator.manual_seed(int(seed))
        return state

    def _blank_state(self) -> ShardedSimState:
        """An ``init_state``-shaped zero template built in the (S, R, ...)
        tile space, never assembling an (n, p) host Theta."""
        S, R, dev = self.num_shards, self.rows_per_shard, self.device
        ustate = self.update.init_state()
        if not (isinstance(ustate, tuple) and not ustate):
            ustate = torch.zeros((S, R) + tuple(ustate.shape[1:]), dtype=ustate.dtype, device=dev)
        return self._state(torch.zeros((S * R, self.p), dtype=self.dtype, device=dev),
                           torch.zeros((S, R), dtype=torch.bool, device=dev), ustate)

    def state_dict(self, state: ShardedSimState, step: int | None = None):
        """The per-shard checkpoint closure: ROADMAP item A12, not ported yet."""
        raise NotImplementedError(
            "ShardedAsyncEngine.state_dict (per-shard checkpoints) is ROADMAP item A12, "
            "which is not ported yet"
        )

    # -- one stacked super-tick ---------------------------------------------
    def _compact(self, wake):
        """Each shard's woken batch at static shape (S, B): ``AsyncEngine._compact``
        over the (S, R) wake mask at once (a cumsum along R and a batched
        searchsorted). Returns ``(woken, slot_rows, valid, dropped)``, local
        rows (sentinel R in ``woken``; ``slot_rows`` B distinct in-range rows
        a shard) and the (S,) capacity overflow."""
        B, R = self.batch_size, self.rows_per_shard
        csum = torch.cumsum(wake, dim=1)
        total = csum[:, -1]
        nvalid = torch.clamp(total, max=B)
        woken = torch.searchsorted(csum, self._arange_sb + 1)  # R where fewer woke
        valid = woken < R
        outside = torch.cumsum(~(wake & (csum <= B)), dim=1)
        spare = torch.searchsorted(outside, self._arange_sb - nvalid[:, None] + 1)
        slot_rows = torch.where(valid, woken, spare)
        return woken, slot_rows, valid, total - nvalid

    def _slot(self, state: ShardedSimState, wake_mask) -> ShardedSimState:
        """One super-tick of all S shards, in place; ``wake_mask`` (S, R)
        forces the wake set (None samples it)."""
        S, R, dev = self.num_shards, self.rows_per_shard, self.device
        gen = state.generator
        active_prev = active = state.active
        if wake_mask is None:
            if self._leave is not None:
                leave = torch.rand((S, R), generator=gen, device=dev) < self._leave
                rejoin = torch.rand((S, R), generator=gen, device=dev) < self._rejoin
                active = torch.where(active_prev, ~leave, rejoin)
            wake_pre = wake = (torch.rand((S, R), generator=gen, device=dev) < self._wake_p) & active
            if self._drop is not None:
                wake = wake_pre & (torch.rand((S, R), generator=gen, device=dev) >= self._drop)
        else:
            # Forced wake sets: no churn transition, no straggler losses —
            # but departed agents still cannot wake.
            wake_pre = wake = wake_mask & active
        _, slot_rows, valid, dropped = self._compact(wake)
        rows = (slot_rows + self._shard_base).reshape(-1)  # (S * B,) flat owned rows
        valid = valid.reshape(-1)
        grows = torch.where(valid, self._owned[rows], self.n)  # global ids, sentinel n

        slab = state.slab
        stats = self.smix.exchange_halo(
            slab, state.ef if self._use_ef else None,
            collect_stats=self._macc is not None and self._macc.quantized)
        ustate = state.ustate
        flat_u = ustate.view(S * R) if isinstance(ustate, torch.Tensor) else ustate
        consts = None if self._consts is None else {k: v[rows] for k, v in self._consts.items()}
        if self.fused:
            # One kernel call over the stacked slab: gather + mix + Eq. 4 +
            # scatter of the owned rows (limit S * R), in place.
            _, applied, _ = self.update.apply_fused(
                slab, grows, valid, gen, flat_u, self._fidx[rows], self._fw[rows],
                srows=rows, ssize=S * R, consts=consts)
        else:
            neigh = self.smix.gather_rows(slab, rows)
            owned = slab[: S * R]
            theta_rows = owned[rows]
            new_rows, applied, _ = self.update.apply_rows(
                theta_rows, grows, valid, neigh, gen, flat_u, srows=rows, ssize=S * R,
                consts=consts)
            # Every new row is computed before any is written; rows not
            # applied write back their own value (B distinct rows a shard).
            owned.index_copy_(0, rows, torch.where(applied[:, None],
                                                   new_rows.to(slab.dtype), theta_rows))

        if self._macc is not None:
            self._macc.tick(
                state.metrics,
                ptr=state.ptr,
                wake_pre=wake_pre,
                wake=wake,
                applied=applied,
                slot_rows=rows,
                capacity_dropped=dropped,
                active_prev=active_prev,
                active_new=active,
                dp_counts=ustate if self._macc.dp_limit is not None else None,
                exchange=self._mstatic,
                quant_stats=stats,
            )
        deg = torch.where(applied, self._deg[rows], 0.0)
        state.messages.add_(deg.view(S, -1).sum(dim=1))
        state.applied.add_(applied.view(S, -1).sum(dim=1))
        state.dropped.add_(dropped)
        state.ptr.add_(1)
        if active is not active_prev:
            state.active.copy_(active)
        return state

    # -- drivers -----------------------------------------------------------
    def step(self, state: ShardedSimState, wake_mask) -> ShardedSimState:
        """One super-tick with an explicit global (n,) wake set."""
        if isinstance(wake_mask, torch.Tensor):
            wake_mask = wake_mask.to("cpu").numpy()
        mask = self.part.pad_rows(np.asarray(wake_mask, dtype=bool), fill=False)
        return self._slot(state, torch.as_tensor(mask).to(self.device))

    def advance(self, state: ShardedSimState, slots: int) -> ShardedSimState:
        """Run ``slots`` sampled super-ticks: on a CUDA device as replays of
        the captured chunk graphs, on the CPU one eager slot at a time."""
        if self._graphs is None:
            return self._eager_slots(state, slots)
        return self._graphs.advance(state, int(slots))

    def _eager_slots(self, state: ShardedSimState, slots: int) -> ShardedSimState:
        """``slots`` sampled super-ticks, one eager slot at a time."""
        for _ in range(int(slots)):
            state = self._slot(state, None)
        return state

    def _agent_theta(self, state: ShardedSimState) -> torch.Tensor:
        """The (n, p) models in agent order, gathered on the device."""
        return state.Theta.reshape(-1, self.p)[self._agent_rows]

    def global_theta(self, state: ShardedSimState) -> np.ndarray:
        """Reassemble the (n, p) model matrix from the shard blocks."""
        return self._agent_theta(state).to("cpu").numpy()

    def _objective_value(self, state: ShardedSimState) -> float:
        """The update's objective at ``state`` (recording hook)."""
        return self.update.objective(self._agent_theta(state))

    def _ptr_of(self, state: ShardedSimState) -> int:
        """Host value of the slot counter (identical across shards)."""
        return int(state.ptr[0])

    # -- topology and observability -------------------------------------------
    def set_topology(self, state, new_csr):
        """Dynamic topology: ROADMAP item A11, not ported yet."""
        raise NotImplementedError(
            "ShardedAsyncEngine.set_topology (dynamic topology) is ROADMAP item A11, "
            "which is not ported yet")

    def _refresh_topology(self, state, round_index: int):
        """Dynamic topology: ROADMAP item A11, not ported yet."""
        raise NotImplementedError(
            "ShardedAsyncEngine._refresh_topology (edge refresh) is ROADMAP item A11, "
            "which is not ported yet")

    def admit(self, state, ids):
        """Arrivals: ROADMAP item A11, not ported yet."""
        raise NotImplementedError(
            "ShardedAsyncEngine.admit (arrivals) is ROADMAP item A11, which is not ported yet")

    def topology_counters(self) -> dict:
        """Host-side dynamic-topology counters (all zeros: static topology)."""
        return dict(self.topology_log)

    def phase_program(self, upto: str | None = None):
        """The slot cut after a named phase: ROADMAP item A10b, not ported yet."""
        raise NotImplementedError(
            "ShardedAsyncEngine.phase_program (phase programs and traces) is ROADMAP "
            "item A10b, which is not ported yet")

    def metrics_snapshot(self, state: ShardedSimState) -> tuple:
        """Drain the device counters: ``(counters, derived)`` host dicts.

        Counter leaves keep their leading (S,) shard axis; ``derived`` adds
        the DP accountant's composed eps spend over the owned agents.
        """
        if self._macc is None:
            raise ValueError(
                "metrics collection is off; construct the engine with "
                "EngineConfig(metrics=True) (or a MetricsSpec)"
            )
        counters = self._macc.snapshot(state.metrics)
        derived: dict = {}
        if self.metrics_spec.privacy and hasattr(self.update, "eps_spent"):
            counts = self.part.unpad_rows(state.ustate.to("cpu", copy=True).numpy())
            eps = np.asarray(self.update.eps_spent(counts))
            derived["dp_eps_spent_mean"] = float(eps.mean())
            derived["dp_eps_spent_max"] = float(eps.max())
        return counters, derived

    def report_meta(self) -> dict:
        """Run metadata stamped into a :class:`repro_torch.obs.RunReport`."""
        return {
            "engine": type(self).__name__,
            "update": type(self.update).__name__,
            "n": self.n,
            "p": self.p,
            "num_shards": int(self.num_shards),
            "slot_wakes": float(self.config.slot_wakes),
            "batch_size": int(self.batch_size),
            "fused": bool(self.fused),
            "dtype": str(self.dtype).replace("torch.", ""),
            "exchange_method": self.exchange_method,
            "exchange_dtype": self.smix.dtype,
            "error_feedback": bool(self._use_ef),
        }

    def run(
        self,
        Theta0,
        slots: int,
        record_every: int = 0,
        state: ShardedSimState | None = None,
        metrics_every: int = 0,
        report=None,
    ) -> SimResult:
        """Drive ``slots`` super-ticks; same contract as :meth:`AsyncEngine.run`."""
        state, objective, report = _run_driver(
            self, Theta0, slots, record_every=record_every, state=state,
            metrics_every=metrics_every, report=report,
        )
        part = self.part
        ustate = state.ustate
        if isinstance(ustate, torch.Tensor):
            ustate = part.unpad_rows(ustate.to("cpu", copy=True).numpy())
        return SimResult(
            Theta=self.global_theta(state),
            objective=np.asarray(objective) if objective is not None else None,
            messages=float(state.messages.sum()),
            wakes_applied=int(state.applied.sum()),
            wakes_dropped=int(state.dropped.sum()),
            slots=self._ptr_of(state),
            active=part.unpad_rows(state.active.to("cpu", copy=True).numpy()),
            update_state=ustate,
            state=state,
            report=report,
        )

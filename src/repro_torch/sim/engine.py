"""Batched asynchronous simulation engine: Poisson super-ticks on a device.

Port of ``repro.sim.engine``'s engines: the single-device
:class:`AsyncEngine` and the sharded :class:`ShardedAsyncEngine`, whose S
agent blocks are stacked on one device (see its docstring), each with
static or dynamic topology. The n i.i.d. Poisson clocks are time-slotted by
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

Dynamic topology (``EngineConfig(graph_update=...)`` or a scenario with
arrivals): the graph becomes mutable state. The live CSR and its slot
form (:class:`repro_torch.core.graph.TopologyState`) stay on the host;
``run`` drives the slots through the reference's segment driver
(:func:`_drive_dynamic`), which applies a :class:`GraphUpdate` refresh and
the scheduled admissions between chunks, never inside one. The dynamic
slot gathers with the reference's einsum over capacity-padded neighbour
tiles held on the device; a swap that keeps their capacity copies into
them, so the captured chunk stays valid, and one that grows it (or a
sharded relayout) drops the graphs, which are captured again at the next
``advance``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import TopologyState, as_csr, csr_from_coo, neighbor_counts
from repro_torch.core.mixing import sharded_mix_op
from repro_torch.core.model_propagation import propagation_rows_from
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_row_update import MAX_M, MAX_P
from repro_torch.obs.metrics import ExchangeVolume, MetricsAccumulator, topology_log_init
from repro_torch.obs.report import RunReport
from repro_torch.sim import clocks
from repro_torch.sim.capture import ChunkGraphs, PhaseProgram, phase_program
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
                metrics_every: int = 0, report=None, checkpoint_every: int = 0,
                checkpoint_dir: str | None = None, checkpoint_keep_last: int = 3,
                snapshot_every: int = 0, serve=None):
    """The run loop behind both engines' ``run``, the reference's.

    Validates the periodic side effects (the same messages from either
    engine) and registers each as an ``(every, callback)`` event of
    :func:`_drive_slots`, chunked at :func:`_event_stride`, or of
    :func:`_drive_dynamic` for a dynamic-topology engine: objective
    recording every ``record_every`` slots, metric drains into a
    :class:`repro_torch.obs.RunReport` every ``metrics_every``, crash-safe
    checkpoints (:func:`repro_torch.checkpoint.save_engine_checkpoint`)
    every ``checkpoint_every`` into the ``checkpoint_keep_last`` rotation
    at ``checkpoint_dir``, and snapshots published to the
    :class:`repro_torch.serve.ServeHandle` ``serve`` every
    ``snapshot_every``, plus once before the first slot, so readers have
    a version from the start. Every event runs between chunks: the
    captured chunk replays ``stride`` slots at a time between them.
    Returns ``(state, objective, report)``."""
    _check_recordable(engine.update, record_every)
    if metrics_every > 0 and engine._macc is None:
        raise ValueError(
            "metrics_every requires metrics collection on; construct the "
            "engine with EngineConfig(metrics=True) (or a MetricsSpec)"
        )
    if (checkpoint_every > 0) != (checkpoint_dir is not None):
        raise ValueError(
            "checkpoint_every and checkpoint_dir come together: pass both "
            "(periodic checkpoints) or neither"
        )
    if (snapshot_every > 0) != (serve is not None):
        raise ValueError(
            "snapshot_every and serve come together: pass both (a "
            "repro_torch.serve.ServeHandle receiving the published snapshots) "
            "or neither"
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
    if checkpoint_every > 0:
        from repro_torch.checkpoint.engine_io import save_engine_checkpoint

        events.append((checkpoint_every, lambda s: save_engine_checkpoint(
            engine, s, checkpoint_dir, keep_last=checkpoint_keep_last)))
    advance = engine.advance
    if snapshot_every > 0:
        # The publications' versions, counted on the host as the slots are
        # driven: one read of the slot counter, not one per publication.
        slot = [engine._ptr_of(state)]

        def advance(s, k):
            slot[0] += k
            return engine.advance(s, k)

        serve.publish(state, version=slot[0])
        events.append((snapshot_every, lambda s: serve.publish(s, version=slot[0])))
    if engine.dynamic:
        state = _drive_dynamic(engine, state, slots, events, advance)
    else:
        stride = _event_stride(events, engine.steps_per_chunk)
        state = _drive_slots(state, slots, stride, advance, events)
    return state, objective, report


# ---------------------------------------------------------------------------
# Dynamic-topology host helpers (shared by both engines; the reference's)
# ---------------------------------------------------------------------------


def _csr_triples(csr):
    """Directed ``(rows, cols, vals)`` triples of a CSR graph."""
    rows = csr.row_ids().astype(np.int64)
    return rows, np.asarray(csr.indices, dtype=np.int64), np.asarray(csr.data)


def _slot_capacity(csr) -> int:
    """Neighbour-slot capacity for a live topology: the max degree rounded
    up to a multiple of 8, so moderate edge churn keeps the tiles' shapes
    (and the captured chunk) between refreshes."""
    need = max(1, int(csr.max_degree()))
    return ((need + 7) // 8) * 8


def _edge_delta(old, new) -> tuple[int, int]:
    """Undirected ``(added, removed)`` edge counts between two CSR graphs.

    A CSR's ``row * n + col`` keys are sorted and unique when its rows
    hold sorted distinct columns (``csr_from_coo``'s output), and then the
    set differences skip ``np.unique``, which some numpy builds (2.3) run
    through a hash table at seconds per 8 M keys; the counts are the same.
    """
    ro, co, _ = _csr_triples(old)
    rn, cn, _ = _csr_triples(new)
    ko = ro * old.n + co
    kn = rn * new.n + cn
    unique = bool(np.all(ko[1:] > ko[:-1]) and np.all(kn[1:] > kn[:-1]))
    return (int(np.setdiff1d(kn, ko, assume_unique=unique).size) // 2,
            int(np.setdiff1d(ko, kn, assume_unique=unique).size) // 2)


def _check_topology(n: int, new_csr, pending) -> None:
    """Validate a topology swap: same n, and no agent outside the pending
    arrival set may end up with zero neighbours (Eq. 4 / Eq. 16 divide by
    the degree the moment the agent wakes)."""
    if new_csr.n != n:
        raise ValueError(f"topology must keep n={n}, got n={new_csr.n}")
    orphans = np.setdiff1d(np.flatnonzero(np.diff(new_csr.indptr) == 0), sorted(pending))
    if orphans.size:
        raise ValueError(
            f"agents {orphans[:8].tolist()} would have no neighbours "
            "(Eq. 4 / Eq. 16 divide by the degree)"
        )


def _detach_edges(csr, ids, *, require_connected: bool = True):
    """Drop every edge incident to ``ids`` (the not-yet-arrived agents).

    With ``require_connected`` (default) every *other* agent must keep at
    least one neighbour: an established agent whose edges all ran through
    scheduled arrivals would wake into a division by zero.
    """
    rows, cols, vals = _csr_triples(csr)
    drop = np.isin(rows, ids) | np.isin(cols, ids)
    out = csr_from_coo(csr.n, rows[~drop], cols[~drop], vals[~drop], symmetrize=True)
    if require_connected:
        bad = np.setdiff1d(np.flatnonzero(np.diff(out.indptr) == 0), ids)
        if bad.size:
            raise ValueError(
                f"agents {bad[:8].tolist()} would have no neighbours until the "
                "scheduled arrivals join; established agents need edges that "
                "do not run through not-yet-arrived agents"
            )
    return out


def _attach_edges(csr, rows, cols, vals):
    """A CSR graph with the given undirected edges added (max-weight dedupe)."""
    r0, c0, v0 = _csr_triples(csr)
    return csr_from_coo(
        csr.n,
        np.concatenate([r0, np.asarray(rows, np.int64)]),
        np.concatenate([c0, np.asarray(cols, np.int64)]),
        np.concatenate([v0, np.asarray(vals, np.float64)]),
        symmetrize=True,
        dedupe="max",
    )


def _arrival_edges(arrival, ids, established, rng):
    """Attachment edges for an admission batch: ``(rows, cols, vals)``."""
    rows: list[int] = []
    cols: list[int] = []
    for i in ids:
        nbrs = arrival.neighbors_for(int(i), established, rng)
        rows.extend([int(i)] * len(nbrs))
        cols.extend(int(j) for j in nbrs)
    vals = np.full(len(rows), float(arrival.attach_weight))
    return np.asarray(rows, np.int64), np.asarray(cols, np.int64), vals


def _allowed(n: int, pending) -> np.ndarray | None:
    """The refresh's (n,) mask of agents whose edges it may re-select: all
    but the pending arrivals (None when there are none)."""
    if not pending:
        return None
    allowed = np.ones(n, dtype=bool)
    allowed[sorted(pending)] = False
    return allowed


def _warm_start_rows(csr, Theta, ids, rounds: int) -> np.ndarray:
    """Eq. 16 warm start for arriving agents (host side): their (len(ids), p)
    float64 rows.

    The model-propagation step with confidence ``c_i = 0`` is a weighted
    neighbour average, iterated ``rounds`` times over the arrival rows only
    (the others stay fixed), through :func:`propagation_rows_from`, as in
    the reference. ``Theta``: the (n, p) models, an array or a tensor on
    any device; only the rows of the arrivals and their neighbours are
    taken to the host, in float64 (the reference copies all of Theta; the
    rows it reads are the same, so are the bits).
    """
    ids = np.asarray(ids, dtype=np.int64)
    spans = [(int(csr.indptr[i]), int(csr.indptr[i + 1])) for i in ids]
    need = np.unique(np.concatenate([ids] + [csr.indices[lo:hi] for lo, hi in spans]))
    if isinstance(Theta, torch.Tensor):
        taken = Theta[torch.as_tensor(need, device=Theta.device)].to("cpu").numpy()
    else:
        taken = np.asarray(Theta)[need]
    local = np.array(taken, dtype=np.float64, copy=True)
    at_ids = np.searchsorted(need, ids)
    cols = [np.searchsorted(need, csr.indices[lo:hi]) for lo, hi in spans]
    p = local.shape[1]
    for _ in range(rounds):
        neigh = np.zeros((ids.size, p))
        d = np.zeros(ids.size)
        for j, (lo, hi) in enumerate(spans):
            w = np.asarray(csr.data[lo:hi])
            neigh[j] = w @ local[cols[j]]
            d[j] = w.sum()
        if np.any(d <= 0):
            raise ValueError("arriving agents must attach with positive-weight edges")
        f64 = torch.float64
        rows = propagation_rows_from(1.0, torch.as_tensor(d), torch.zeros(ids.size, dtype=f64),
                                     torch.zeros((ids.size, p), dtype=f64),
                                     torch.as_tensor(neigh))
        local[at_ids] = rows.numpy()
    return local[at_ids]


def _drive_dynamic(engine, state, slots: int, events, advance):
    """Segment driver for dynamic-topology runs (both engines; the
    reference's).

    Splits the run at every absolute slot where anything fires — the
    periodic ``(every, cb)`` events, a :class:`GraphUpdate` refresh, or a
    scheduled arrival — advances between the fire points with
    :func:`_drive_slots` (captured chunks on the card), and applies the
    topology work at the boundaries. Order at a shared boundary: edge
    refresh, then admissions (new agents attach to the refreshed graph),
    then the periodic callbacks.
    """
    gu = engine.config.graph_update
    arrival = engine.scenario.arrival
    start = engine._ptr_of(state)
    end = start + slots
    points = {end}
    for every, _cb in events:
        points.update(range(start + every, end, every))
    if gu is not None:
        # The refresh grid is absolute (multiples of gu.every in slot
        # time), so a run split across resumes fires the same refreshes at
        # the same slots as one run.
        first = (start // gu.every + 1) * gu.every
        points.update(range(first, end, gu.every))
    admissions: dict[int, tuple[int, ...]] = {}
    if arrival is not None:
        for slot, ids in arrival.by_slot().items():
            t = slot - 1  # agents join at the *start* of their slot
            pend = tuple(i for i in ids if i in engine._pending)
            if pend and start <= t < end:
                admissions[t] = pend
    points.update(admissions)
    if (
        gu is not None
        and start > 0
        and start % gu.every == 0
        and engine.topology_log["edge_refreshes"] < start // gu.every
    ):
        # Resuming exactly on a grid slot whose refresh has not fired yet
        # (the previous segment ended there, and an end never refreshes):
        # the refresh is owed before the first super-tick. The
        # edge_refreshes count tells a pre-refresh end from a post-refresh one.
        state = engine._refresh_topology(state, start // gu.every)
    prev = start
    for t in sorted(points):
        if t > prev:
            state = _drive_slots(state, t - prev, engine.steps_per_chunk, advance)
        prev = t
        rel = t - start
        if gu is not None and start < t < end and t % gu.every == 0:
            state = engine._refresh_topology(state, t // gu.every)
        if t in admissions:
            state = engine.admit(state, admissions[t])
        for every, cb in events:
            if rel % every == 0 or t == end:
                cb(state)
    return state


class AsyncEngine:
    """Batched event-driven driver for any :class:`LocalUpdate`, on one device.

    Configured by :class:`repro_torch.sim.EngineConfig` (``config=...``);
    keyword arguments (``slot_wakes``, ``rates``, ``batch_size``,
    ``scenario``, ``seed``, ``dtype``, ``steps_per_chunk``, ``fused``,
    ``metrics``, ``device``, ``graph_update``) override its fields.

    With dynamic topology (``dynamic``: a ``graph_update``, or arrivals in
    the scenario) the slot gathers through the live topology's device
    tiles (:meth:`_load_tiles`); ``set_topology``, ``_refresh_topology``
    and ``admit`` change it between slots, and ``fused=True`` or a delay
    scenario is refused, as in the reference.
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
        self.dynamic = cfg.graph_update is not None or self.scenario.arrival is not None
        self.topology_log = topology_log_init()
        if self.dynamic and self.scenario.delay is not None:
            raise NotImplementedError(
                "dynamic topology and per-edge delays do not compose yet: the "
                "snapshot-ring delay tiles are baked per graph"
            )
        if self.dynamic and cfg.fused is True:
            raise ValueError(
                "fused=True is static-topology only (the fused kernel's tables "
                "bake the neighbour lists); leave fused='auto' for dynamic runs"
            )

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

        self._wake_p = f32(self.wake_probs)
        self._deg_counts = f32(neighbor_counts(update.graph))
        churn = self.scenario.churn
        self._leave = f32(churn.leave_vector(self.n)) if churn else None
        self._rejoin_v = churn.rejoin_vector(self.n) if churn else None
        self._rejoin = f32(self._rejoin_v) if churn else None
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
        fused_knob = False if self.dynamic else cfg.fused
        self.fused = _resolve_fused(update, fused_knob, dev, self.dtype, delay is not None,
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
        if self.fused:
            self._phases = ("wake_sample", "fused_row_update", "finalize")
        else:
            self._phases = ("wake_sample", "gather_mix", "row_update", "scatter", "finalize")
        self._phase_cache: dict = {}  # upto -> PhaseProgram (sim/capture.py)
        self._phase_scratch = None  # the state the phase programs run on
        # The captured chunks (sim/capture.py): on a CUDA device only.
        self._graphs = ChunkGraphs(self) if dev.type == "cuda" else None

        # Dynamic topology: the live CSR and its slot form stay on the
        # host; the slot reads the device tiles of _load_tiles.
        self._pending: set[int] = set()
        self._csr = self.topo = self._dyn = None
        if self.dynamic:
            self._init_dynamic()

    def _init_dynamic(self) -> None:
        """The pending arrivals (edge-detached), the update's constants as
        device tiles (``deg`` re-derived from the live topology) and the
        topology's tiles."""
        arrival = self.scenario.arrival
        csr = as_csr(self.update.graph)
        if arrival is not None:
            self._pending = {int(i) for i in arrival.all_ids()}
            bad = [i for i in self._pending if not 0 <= i < self.n]
            if bad:
                raise ValueError(f"arrival ids {bad} outside [0, n={self.n})")
            csr = _detach_edges(csr, sorted(self._pending))
        consts_fn = getattr(self.update, "agent_constants", None)
        base = None if consts_fn is None else consts_fn()
        if not isinstance(base, dict) or "deg" not in base:
            raise ValueError(
                "dynamic topology needs update.agent_constants() to return "
                "a dict with a 'deg' entry (the graph-dependent constant "
                "the engine re-derives from the live topology)"
            )
        # Float leaves in the engine dtype: the cast commutes with the row
        # gather, so this is the reference's cast-after-gather bit for bit.
        self._consts = {}
        for k, a in base.items():
            if k != "deg":
                a = np.asarray(a)
                dt = self.dtype if np.issubdtype(a.dtype, np.floating) else None
                self._consts[k] = torch.as_tensor(a).to(device=self.device, dtype=dt)
        self._csr = csr
        self.topo = TopologyState.from_csr(csr, capacity=_slot_capacity(csr))
        self._load_tiles()
        if self._rejoin is not None and self._pending:
            # Churn rejoin must not resurrect a not-yet-arrived agent: its
            # rows are edge-detached (zero degree). Admission restores it.
            self._rejoin[torch.as_tensor(sorted(self._pending), device=self.device)] = 0.0

    def _load_tiles(self) -> None:
        """The live topology's device tiles: ``idx``/``w`` the
        capacity-padded neighbour slots (a free slot points at its own row
        with weight 0, so the einsum adds exact zeros), ``counts`` the live
        |N_i| for message accounting, ``deg`` the weighted degrees (the
        update's ``deg`` constant). Tiles of the same capacity are
        overwritten in place (``copy_``), so a captured chunk keeps reading
        them; a larger capacity allocates new ones and drops the captured
        graphs (:meth:`ChunkGraphs.reset`), captured again at the next
        ``advance``."""
        t = self.topo
        valid = np.asarray(t.valid)
        w = np.where(valid, np.asarray(t.w), 0.0)
        host = {"idx": (np.asarray(t.nbr), torch.long), "w": (w, self.dtype),
                "counts": (valid.sum(axis=1), torch.float32), "deg": (w.sum(axis=1), self.dtype)}
        old = self._dyn
        if old is not None and tuple(old["idx"].shape) == host["idx"][0].shape:
            for k, (a, _) in host.items():
                old[k].copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return
        self._dyn = {k: torch.as_tensor(np.ascontiguousarray(a)).to(device=self.device, dtype=dt)
                     for k, (a, dt) in host.items()}
        self._consts["deg"] = self._dyn["deg"]
        if self._graphs is not None:
            self._graphs.reset()

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
        active = torch.ones(self.n, dtype=torch.bool, device=dev)
        if self._pending:
            # Scheduled arrivals are in the arrays but not in the system yet:
            # inactive (never woken) and edge-detached until admitted.
            active[torch.as_tensor(sorted(self._pending), device=dev)] = False
        return SimState(
            Theta=Theta,
            hist=hist,
            ptr=torch.zeros((), dtype=torch.long, device=dev),
            active=active,
            generator=gen,
            ustate=ustate,
            applied=torch.zeros((), dtype=torch.long, device=dev),
            dropped=torch.zeros((), dtype=torch.long, device=dev),
            messages=torch.zeros((), dtype=torch.float32, device=dev),
            metrics=None if self._macc is None else self._macc.init(dev),
        )

    def state_dict(self, state: SimState, step: int | None = None):
        """The complete resume closure as ``(files, manifest)``: every state
        leaf (the generator's state as ``.generator``) plus the live topology
        and its host log; what
        :func:`repro_torch.checkpoint.save_engine_checkpoint` writes."""
        from repro_torch.checkpoint.engine_io import engine_state_dict

        return engine_state_dict(self, state, step=step)

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

    def _slot(self, state: SimState, wake_mask, upto: str | None = None):
        """One super-tick, in place; ``wake_mask`` forces the wake set (None
        samples it). ``upto`` cuts the slot after a named phase and returns
        that phase's live intermediates, as the reference's ``_slot`` does
        (the prefix programs of :meth:`phase_program`); None runs it all."""
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
        if upto == "wake_sample":
            return wake, woken, slot_rows, valid, dropped, active

        Theta = state.Theta
        hist = state.hist
        if self.fused:
            # One kernel call: gather + mix + Eq. 4 + masked scatter, in place.
            Theta, applied, ustate = self.update.apply_fused(
                Theta, woken, valid, gen, state.ustate, self._fidx[slot_rows], self._fw[slot_rows]
            )
            if upto == "fused_row_update":
                return Theta, applied
        else:
            if self.dynamic:
                # The reference's dynamic gather: an einsum over the live
                # topology's capacity-padded tiles (no kernel of ours), and
                # the update's constants gathered from their tiles.
                dyn = self._dyn
                neigh = torch.einsum("bk,bkp->bp", dyn["w"][slot_rows],
                                     Theta[dyn["idx"][slot_rows]])
                consts = {k: v[slot_rows] for k, v in self._consts.items()}
                new_rows, applied, ustate = self.update.apply_rows(
                    Theta[slot_rows], woken, valid, neigh, gen, state.ustate, srows=woken,
                    ssize=n, consts=consts)
            else:
                if self._delays is not None:
                    hist.index_copy_(0, (state.ptr % self.depth).reshape(1), Theta.unsqueeze(0))
                    cols = self._idx[slot_rows]  # (B, K)
                    lag = torch.remainder(state.ptr - self._delays[slot_rows], self.depth)
                    neigh = torch.einsum("bk,bkp->bp", self._w[slot_rows], hist[lag, cols])
                else:
                    neigh = self.update.mix.gather_rows(Theta, woken)
                if upto == "gather_mix":
                    return neigh
                new_rows, applied, ustate = self.update.apply(
                    Theta, woken, valid, neigh, gen, state.ustate
                )
            if upto == "row_update":
                return new_rows, applied
            # Every new row is computed before any is written (the
            # start-of-slot snapshot); rows not applied write back their
            # own value, so the scatter touches B distinct rows.
            keep = torch.where(applied[:, None], new_rows.to(Theta.dtype), Theta[slot_rows])
            Theta.index_copy_(0, slot_rows, keep)
            if upto == "scatter":
                return Theta

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
        deg = (self._dyn["counts"] if self.dynamic else self._deg_counts)[slot_rows]
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
        """Host value of the slot counter (drain and segment bookkeeping)."""
        return int(state.ptr)

    # -- topology ----------------------------------------------------------
    def set_topology(self, new_csr) -> None:
        """Swap the live collaboration graph (host side, between slots).

        Validates the swap (same n; no agent outside the pending arrivals
        may be left without a neighbour), rebuilds the slot form at the
        current capacity (grown to the next multiple of 8 when the new max
        degree needs it, never shrunk), reloads the device tiles
        (:meth:`_load_tiles`: in place while the capacity holds) and adds
        the edge churn to the counters.
        """
        if not self.dynamic:
            raise ValueError(
                "static-topology engine; construct with "
                "EngineConfig(graph_update=...) or an arrival scenario"
            )
        _check_topology(self.n, new_csr, self._pending)
        added, removed = _edge_delta(self._csr, new_csr)
        cap = max(self.topo.capacity, _slot_capacity(new_csr))
        self.topo = TopologyState.from_csr(new_csr, capacity=cap,
                                           version=int(self.topo.version) + 1)
        self._csr = new_csr
        self._load_tiles()
        self.topology_log["edges_added"] += added
        self.topology_log["edges_removed"] += removed

    def _refresh_topology(self, state: SimState, round_index: int) -> SimState:
        """Fire one Dada edge-refresh round against the current models."""
        gu = self.config.graph_update
        if gu is None:
            raise ValueError("no graph_update configured")
        new_csr = gu.refresh(self._csr, state.Theta, round_index=round_index,
                             allowed=_allowed(self.n, self._pending))
        self.set_topology(new_csr)
        self.topology_log["edge_refreshes"] += 1
        return state

    def admit(self, state: SimState, ids) -> SimState:
        """Join scheduled arrivals now: attach, warm start, activate.

        ``ids`` must be pending arrivals. Attachment targets come from the
        :class:`ArrivalConfig` (its explicit map, or a draw over the active
        agents seeded by ``(arrival.seed, slot)``); with ``warm_start`` the
        new rows are the Eq. 16 confidence-0 neighbour average before the
        agent's first wake. The rows and the churn flags are written in
        place (``index_copy_``), so the state keeps its tensors (a captured
        chunk's live buffers).
        """
        arrival = self.scenario.arrival
        if arrival is None:
            raise ValueError("no arrival scenario configured")
        ids = tuple(int(i) for i in ids)
        missing = [i for i in ids if i not in self._pending]
        if missing:
            raise ValueError(f"agents {missing} are not pending arrivals")
        rng = np.random.default_rng((arrival.seed, self._ptr_of(state)))
        established = np.flatnonzero(state.active.to("cpu").numpy())
        rows, cols, vals = _arrival_edges(arrival, ids, established, rng)
        self.set_topology(_attach_edges(self._csr, rows, cols, vals))
        at = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        if arrival.warm_start:
            warm = _warm_start_rows(self._csr, state.Theta, ids, arrival.warm_rounds)
            state.Theta.index_copy_(0, at, torch.as_tensor(warm).to(self.device, self.dtype))
        state.active.index_fill_(0, at, True)
        self._pending -= set(ids)
        if self._rejoin is not None:
            # Admitted agents regain their churn rejoin probability.
            self._rejoin.index_copy_(0, at, torch.as_tensor(
                self._rejoin_v[list(ids)], dtype=torch.float32).to(self.device))
        self.topology_log["arrivals"] += len(ids)
        return state

    def topology_counters(self) -> dict:
        """Host-side dynamic-topology counters (all zeros when static)."""
        return dict(self.topology_log)

    # -- observability -------------------------------------------------------
    @property
    def phase_names(self) -> tuple:
        """The named super-tick phases, in pipeline order (the reference's)."""
        return self._phases

    def phase_program(self, upto: str | None = None) -> PhaseProgram:
        """The sampled slot cut after phase ``upto`` (None = the full slot),
        run on a scratch copy of the state it is given
        (:class:`repro_torch.sim.capture.PhaseProgram`): on the card a
        captured CUDA graph of its own, so a prefix times what the captured
        slot pays. :func:`repro_torch.obs.profile_supertick` times and
        differences them; the live state and its generator are never
        touched."""
        if self.dynamic:
            raise NotImplementedError(
                "phase profiling serves the static-topology path only"
            )
        return phase_program(self, upto)

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
        if self.dynamic:
            derived.update({f"topology_{k}": v for k, v in self.topology_log.items()})
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
        checkpoint_every: int = 0,
        checkpoint_dir: str | None = None,
        checkpoint_keep_last: int = 3,
        snapshot_every: int = 0,
        serve=None,
    ) -> SimResult:
        """Drive ``slots`` super-ticks from ``Theta0`` (or a resumed ``state``).

        ``record_every`` > 0 records the update's objective every that many
        slots (and at the start and the end). ``metrics_every`` > 0 drains
        the device metrics every that many slots (requires collection on —
        ``EngineConfig(metrics=...)``) into a
        :class:`repro_torch.obs.RunReport` returned as ``SimResult.report``;
        pass ``report=`` to keep appending to an existing one across resumed
        runs. ``checkpoint_every`` > 0 with ``checkpoint_dir`` writes a
        crash-safe engine checkpoint every that many slots into a rotation
        keeping the newest ``checkpoint_keep_last`` entries
        (:func:`repro_torch.checkpoint.restore` then ``run(None, k,
        state=...)`` continues bit for bit). ``snapshot_every`` > 0 with
        ``serve`` (a :class:`repro_torch.serve.ServeHandle`) publishes a
        serving snapshot every that many slots and once at the start. The
        slots run in chunks of ``steps_per_chunk`` (of the gcd of the
        periods when any is set), as in the reference.
        """
        state, objective, report = _run_driver(
            self, Theta0, slots, record_every=record_every, state=state,
            metrics_every=metrics_every, report=report, checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir, checkpoint_keep_last=checkpoint_keep_last,
            snapshot_every=snapshot_every, serve=serve,
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
    graphs on the card, as for :class:`AsyncEngine`.

    Dynamic topology, as in the reference: :meth:`set_topology` patches
    the weights alone, patches the frozen ownership when the cut's drift
    is at most ``EngineConfig.drift_threshold``, or cuts a new partition
    and re-lays the state out; the slab's halo part (and on a repartition
    the owned part) changes shape, so every swap drops the captured
    graphs. Refused: per-edge delays (as in the reference).
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
        self.dynamic = cfg.graph_update is not None or self.scenario.arrival is not None
        self.topology_log = topology_log_init()
        if self.dynamic and cfg.fused is True:
            raise ValueError(
                "fused=True is static-topology only (the fused kernel's tables "
                "bake the neighbour lists); leave fused='auto' for dynamic runs"
            )
        self._pending: set[int] = set()
        csr = as_csr(update.graph)
        arrival = self.scenario.arrival
        if arrival is not None:
            self._pending = {int(i) for i in arrival.all_ids()}
            bad = [i for i in self._pending if not 0 <= i < self.n]
            if bad:
                raise ValueError(f"arrival ids {bad} outside [0, n={self.n})")
            csr = _detach_edges(csr, sorted(self._pending))
        self._csr = csr
        partition = cfg.partition
        if partition is not None:
            if self._pending:
                raise ValueError(
                    "partition reuse does not compose with arrival scenarios "
                    "(the engine detaches scheduled arrivals before cutting)"
                )
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
        if self.dynamic and not (isinstance(self._consts_base, dict)
                                 and "deg" in self._consts_base):
            raise ValueError(
                "dynamic topology needs update.agent_constants() to return a "
                "dict with a 'deg' entry (the graph-dependent constant the "
                "engine re-derives from the live topology)"
            )
        obj = getattr(update, "obj", None)
        fused_knob = False if self.dynamic else cfg.fused
        self.fused = _resolve_fused(update, fused_knob, self.device, self.dtype, False, self.p,
                                    obj.data.X.shape[1] if obj is not None else 0)
        self._use_ef = self.smix.error_feedback
        halo = ("wake_sample", "halo_publish", "halo_collective", "halo_scatter")
        if self.fused:
            self._phases = halo + ("fused_row_update", "finalize")
        else:
            self._phases = halo + ("gather_mix", "row_update", "scatter", "finalize")
        self._phase_cache: dict = {}
        self._phase_scratch = None
        self._graphs = ChunkGraphs(self) if self.device.type == "cuda" else None
        self._rebuild_static()

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
        exchange-volume tiles of the metrics. On a dynamic engine the
        ``deg`` constant comes from the live graph and the pending
        arrivals' rejoin probability is 0. Called again after every
        topology swap: the tensors are new, so the captured graphs are
        dropped (:meth:`ChunkGraphs.reset`)."""
        if self._graphs is not None:
            self._graphs.reset()
        self._phase_cache.clear()  # the phase programs read the old tiles too
        self._phase_scratch = None
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

        rejoin_v = self._rejoin_v
        if rejoin_v is not None and self._pending:
            # Churn rejoin must not resurrect a not-yet-arrived agent (its
            # rows are edge-detached: zero degree) until admission.
            rejoin_v = rejoin_v.copy()
            rejoin_v[sorted(self._pending)] = 0.0
        self._wake_p = tile(self.wake_probs).view(S, R)
        self._leave, self._rejoin, self._drop = (maybe(v) for v in
                                                  (self._leave_v, rejoin_v, self._drop_v))
        self._deg = tile(neighbor_counts(self._csr))
        self._consts = None
        if self._consts_base is not None:
            base = dict(self._consts_base)
            if self.dynamic:
                base["deg"] = self._csr.degrees  # the live graph's, as in the reference
            self._consts = {}
            for k, a in base.items():
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
        active_g = np.ones(self.n, bool)
        if self._pending:
            # Scheduled arrivals: inactive and edge-detached until admitted.
            active_g[sorted(self._pending)] = False
        active = torch.as_tensor(self.part.pad_rows(active_g, fill=False))
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
        """The complete resume closure as ``(files, manifest)``: one file per
        shard keyed by original agent ids, the partition's ownership and the
        per-shard scalars (the generator's state among them); what
        :func:`repro_torch.checkpoint.save_engine_checkpoint` writes."""
        from repro_torch.checkpoint.engine_io import engine_state_dict

        return engine_state_dict(self, state, step=step)

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

    def _slot(self, state: ShardedSimState, wake_mask, upto: str | None = None):
        """One super-tick of all S shards, in place; ``wake_mask`` (S, R)
        forces the wake set (None samples it). ``upto`` cuts it after a
        named phase and returns that phase's live intermediates (the
        reference's ``_slot_local(..., upto)``); None runs it all."""
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
        woken, slot_rows, valid, dropped = self._compact(wake)
        if upto == "wake_sample":
            return wake, woken, slot_rows, valid, dropped, active
        rows = (slot_rows + self._shard_base).reshape(-1)  # (S * B,) flat owned rows
        valid = valid.reshape(-1)
        grows = torch.where(valid, self._owned[rows], self.n)  # global ids, sentinel n

        slab = state.slab
        collect = self._macc is not None and self._macc.quantized
        ef = state.ef if self._use_ef else None
        if upto in ("halo_publish", "halo_collective"):
            return self.smix.exchange_halo(slab, ef, collect_stats=collect, upto=upto)
        stats = self.smix.exchange_halo(slab, ef, collect_stats=collect)
        if upto == "halo_scatter":
            return slab
        ustate = state.ustate
        flat_u = ustate.view(S * R) if isinstance(ustate, torch.Tensor) else ustate
        consts = None if self._consts is None else {k: v[rows] for k, v in self._consts.items()}
        if self.fused:
            # One kernel call over the stacked slab: gather + mix + Eq. 4 +
            # scatter of the owned rows (limit S * R), in place.
            _, applied, _ = self.update.apply_fused(
                slab, grows, valid, gen, flat_u, self._fidx[rows], self._fw[rows],
                srows=rows, ssize=S * R, consts=consts)
            if upto == "fused_row_update":
                return state.Theta, applied
        else:
            neigh = self.smix.gather_rows(slab, rows)
            if upto == "gather_mix":
                return neigh
            owned = slab[: S * R]
            theta_rows = owned[rows]
            new_rows, applied, _ = self.update.apply_rows(
                theta_rows, grows, valid, neigh, gen, flat_u, srows=rows, ssize=S * R,
                consts=consts)
            if upto == "row_update":
                return new_rows, applied
            # Every new row is computed before any is written; rows not
            # applied write back their own value (B distinct rows a shard).
            owned.index_copy_(0, rows, torch.where(applied[:, None],
                                                   new_rows.to(slab.dtype), theta_rows))
            if upto == "scatter":
                return state.Theta

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

    # -- topology ----------------------------------------------------------
    def _to_layout(self, g) -> torch.Tensor:
        """An (n, ...) agent-order device tensor as the (S * R, ...) rows of
        the current layout, padding rows 0 (False)."""
        real = self._owned < self.n
        out = g[torch.where(real, self._owned, 0)]
        keep = real.view((-1,) + (1,) * (out.dim() - 1))
        return torch.where(keep, out, torch.zeros((), dtype=out.dtype, device=out.device))

    def set_topology(self, state: ShardedSimState, new_csr) -> ShardedSimState:
        """Swap the live graph and rebind the sharded machinery.

        Three tiers, by how much of the standing cut survives, as in the
        reference:

        * **weight-only** (identical structure) — :meth:`GraphPartition.patch`
          regathers the weights; the plan and every index tile carry over;
        * **structural, drift <= ``config.drift_threshold``** — patch the
          frozen ownership: the halo, border and exchange tiles rebuild,
          the owned rows stay where they are;
        * **drift above the threshold** — cut a new ``partition_graph`` and
          re-lay the state out onto its ownership (old layout -> agent
          order -> new layout, on the device).

        Returns the state: the one given after a weight-only patch, else a
        new one around a slab of the new halo width, with the generator
        and the (S,) counters carried over. Error feedback starts again on
        a structural change; the metrics start again only when the
        rebuild changed their shapes. The captured graphs are dropped
        (:meth:`_rebuild_static`).
        """
        if not self.dynamic:
            raise ValueError(
                "static-topology engine; construct with "
                "EngineConfig(graph_update=...) or an arrival scenario"
            )
        _check_topology(self.n, new_csr, self._pending)
        added, removed = _edge_delta(self._csr, new_csr)
        old_part = self.part
        same_structure = np.array_equal(old_part.csr.indptr, new_csr.indptr) and \
            np.array_equal(old_part.csr.indices, new_csr.indices)
        relayout = False
        if same_structure:
            new_part = old_part.patch(new_csr)
            self.topology_log["weight_patches"] += 1
        else:
            drift = float(old_part.drift(new_csr))
            self.topology_log["last_drift"] = drift
            if drift <= float(self.config.drift_threshold):
                new_part = old_part.patch(new_csr)
                self.topology_log["structural_patches"] += 1
            else:
                new_part = partition_graph(new_csr, self.num_shards,
                                           mode=self.config.partition_mode,
                                           relabel=self.config.relabel, coords=self.config.coords)
                self.topology_log["repartitions"] += 1
                relayout = True
        self._csr = new_csr
        self.topology_log["edges_added"] += added
        self.topology_log["edges_removed"] += removed

        S, p = self.num_shards, self.p
        owned = state.slab[: S * self.rows_per_shard]
        ustate = state.ustate
        if relayout:
            # Ownership changed: every per-agent leaf through agent order.
            at = self._agent_rows
            owned, active = owned[at], state.active.reshape(-1)[at]
            if isinstance(ustate, torch.Tensor):
                ustate = ustate.reshape((-1,) + tuple(ustate.shape[2:]))[at]
        self.part = new_part
        self.smix = self.smix.rebound(new_part)
        self.exchange_method = self.smix.method
        self.batch_size = int(min(self.batch_size, new_part.rows_per_shard))
        self._rebuild_static()
        R = self.rows_per_shard

        ef = state.ef
        if self._use_ef:
            fresh_ef = self.smix.init_error_feedback(p, self.dtype, self.device)
            if not same_structure or ef is None or fresh_ef is None or \
                    ef.shape != fresh_ef.shape:
                ef = fresh_ef
        metrics = state.metrics
        if self._macc is not None:
            fresh = self._macc.init(self.device)
            if fresh.keys() != metrics.keys() or any(
                    fresh[k].shape != metrics[k].shape for k in fresh):
                metrics = fresh
        if same_structure:
            return state._replace(ef=ef, metrics=metrics)
        if relayout:
            owned, active = self._to_layout(owned), self._to_layout(active).view(S, R)
            if isinstance(ustate, torch.Tensor):
                ustate = self._to_layout(ustate).view((S, R) + tuple(ustate.shape[1:]))
        else:
            active = state.active
        slab = torch.zeros((self.smix.slab_rows, p), dtype=self.dtype, device=self.device)
        slab[: S * R] = owned
        return state._replace(Theta=slab[: S * R].view(S, R, p), active=active, ustate=ustate,
                              slab=slab, ef=ef, metrics=metrics)

    def _refresh_topology(self, state: ShardedSimState, round_index: int) -> ShardedSimState:
        """Fire one Dada edge-refresh round against the current models."""
        gu = self.config.graph_update
        if gu is None:
            raise ValueError("no graph_update configured")
        new_csr = gu.refresh(self._csr, self._agent_theta(state), round_index=round_index,
                             allowed=_allowed(self.n, self._pending))
        state = self.set_topology(state, new_csr)
        self.topology_log["edge_refreshes"] += 1
        return state

    def admit(self, state: ShardedSimState, ids) -> ShardedSimState:
        """Join scheduled arrivals now (:meth:`AsyncEngine.admit`'s
        counterpart: attach, warm start, activate). The attach edges go
        through :meth:`set_topology`, so an admission can itself patch or
        repartition; the warm-started rows and flags are then written in
        place into whatever layout results."""
        arrival = self.scenario.arrival
        if arrival is None:
            raise ValueError("no arrival scenario configured")
        ids = tuple(int(i) for i in ids)
        missing = [i for i in ids if i not in self._pending]
        if missing:
            raise ValueError(f"agents {missing} are not pending arrivals")
        rng = np.random.default_rng((arrival.seed, self._ptr_of(state)))
        active_g = state.active.reshape(-1)[self._agent_rows].to("cpu").numpy()
        rows, cols, vals = _arrival_edges(arrival, ids, np.flatnonzero(active_g), rng)
        state = self.set_topology(state, _attach_edges(self._csr, rows, cols, vals))
        at = self._agent_rows[torch.as_tensor(ids, dtype=torch.long, device=self.device)]
        if arrival.warm_start:
            warm = _warm_start_rows(self._csr, self._agent_theta(state), ids,
                                    arrival.warm_rounds)
            state.slab.index_copy_(0, at, torch.as_tensor(warm).to(self.device, self.dtype))
        state.active.view(-1).index_fill_(0, at, True)
        self._pending -= set(ids)
        if self._rejoin is not None:
            # Admitted agents regain their churn rejoin probability.
            self._rejoin.view(-1).index_copy_(0, at, torch.as_tensor(
                self._rejoin_v[list(ids)], dtype=torch.float32).to(self.device))
        self.topology_log["arrivals"] += len(ids)
        return state

    def topology_counters(self) -> dict:
        """Host-side dynamic-topology counters (all zeros when static)."""
        return dict(self.topology_log)

    # -- observability -------------------------------------------------------
    @property
    def phase_names(self) -> tuple:
        """The named super-tick phases, in pipeline order (the reference's)."""
        return self._phases

    def phase_program(self, upto: str | None = None) -> PhaseProgram:
        """The sampled stacked slot cut after phase ``upto`` (None = full),
        on a scratch copy of the state; same contract as
        :meth:`AsyncEngine.phase_program`. The halo's publish, collective
        and scatter are the three steps of ``ShardedMixOp.exchange_halo``."""
        return phase_program(self, upto)

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
        if self.dynamic:
            derived.update({f"topology_{k}": v for k, v in self.topology_log.items()})
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
        checkpoint_every: int = 0,
        checkpoint_dir: str | None = None,
        checkpoint_keep_last: int = 3,
        snapshot_every: int = 0,
        serve=None,
    ) -> SimResult:
        """Drive ``slots`` super-ticks; same contract as :meth:`AsyncEngine.run`."""
        state, objective, report = _run_driver(
            self, Theta0, slots, record_every=record_every, state=state,
            metrics_every=metrics_every, report=report, checkpoint_every=checkpoint_every,
            checkpoint_dir=checkpoint_dir, checkpoint_keep_last=checkpoint_keep_last,
            snapshot_every=snapshot_every, serve=serve,
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

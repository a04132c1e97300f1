"""Batched asynchronous simulation engine: Poisson super-ticks on a device.

Port of ``repro.sim.engine``'s single-device, static-topology
:class:`AsyncEngine`. The n i.i.d. Poisson clocks are time-slotted by
binomial thinning (:mod:`repro_torch.sim.clocks`): each **super-tick**
wakes a random subset of agents, computes their Eq. 4 updates from the
start-of-slot snapshot and writes them back. Two paths run the woken
rows:

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
slot is a fixed sequence of launches. ``Theta`` and the delay history are
updated in place: a state passed to :meth:`AsyncEngine.step` or
:meth:`AsyncEngine.advance` is consumed by it (clone ``state.Theta`` to
keep a copy). Random draws come from one ``torch.Generator`` on the
engine's device, seeded from ``EngineConfig.seed``; they are not the
reference's ``jax.random`` draws, so runs agree with the reference
through forced wake sets and in distribution, not draw for draw.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.graph import as_csr, neighbor_counts
from repro_torch.device import resolve_device
from repro_torch.sim import clocks
from repro_torch.sim.config import EngineConfig, resolve_config
from repro_torch.sim.scenarios import Scenario
from repro_torch.sim.updates import LocalUpdate


def _resolve_fused(update, fused, device: torch.device, dtype, has_delay: bool) -> bool:
    """Resolve the tri-state ``fused`` knob against what the kernel serves.

    ``"auto"`` engages the fused kernel on a CUDA device for a float32
    engine whose update implements the fused row math (quadratic loss)
    and has no per-edge delays. ``True`` asks for the fused path wherever
    the update supports it — the kernel on CUDA, its plain version on the
    CPU — and raises where it cannot serve (a delay scenario, another
    loss, or a float64 engine: the kernel computes in float32). ``False``
    keeps the unfused path.
    """
    supported = bool(getattr(update, "fused_supported", False)) and not has_delay
    if fused == "auto":
        return supported and device.type == "cuda" and dtype == torch.float32
    if fused:
        if not supported:
            reason = "a delay scenario" if has_delay else type(update).__name__
            raise ValueError(f"fused=True but the fused path does not serve {reason}")
        if dtype != torch.float32:
            raise ValueError(f"fused=True runs the float32 kernel; the engine dtype is {dtype}")
        return True
    return False


class SimState(NamedTuple):
    """Engine state carried from slot to slot (tensors on the engine's device)."""

    Theta: torch.Tensor  # (n, p) current models, updated in place
    hist: torch.Tensor  # (depth, n, p) start-of-slot snapshot ring (delay only)
    ptr: torch.Tensor  # () int64 slot counter
    active: torch.Tensor  # (n,) bool churn state
    generator: torch.Generator  # the engine's random stream
    ustate: object  # LocalUpdate state
    applied: torch.Tensor  # () int64: updates actually written
    dropped: torch.Tensor  # () int64: wakes lost to slot capacity
    messages: torch.Tensor  # () float32: cumulative p-vectors transmitted


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


def _check_recordable(update, record_every: int) -> None:
    """Recording needs an objective; asking for one the update cannot
    produce is an error, not a silent no-op."""
    if record_every > 0 and not hasattr(update, "objective"):
        raise ValueError(
            f"record_every={record_every} requires the update to expose an "
            f"objective method; {type(update).__name__} has none"
        )


def _drive_slots(state, slots: int, slot, events=()):
    """Run ``slots`` super-ticks through ``slot(state)``, one at a time
    (the reference's compiled ``lax.scan`` chunks have no counterpart
    here). ``events`` is a list of ``(every, callback)`` pairs; each
    callback fires with the state whenever the completed slot count hits a
    multiple of its period, and once more at the end when ``slots`` is not
    a multiple."""
    events = [(int(every), cb) for every, cb in events if cb is not None and every > 0]
    for done in range(1, int(slots) + 1):
        state = slot(state)
        for every, cb in events:
            if done % every == 0 or done == slots:
                cb(state)
    return state


def _run_driver(engine, Theta0, slots: int, *, record_every: int = 0, state=None):
    """The run loop behind ``AsyncEngine.run``: optional objective
    recording every ``record_every`` slots. Returns ``(state, objective)``."""
    _check_recordable(engine.update, record_every)
    state = engine.init_state(Theta0) if state is None else state
    objective = [engine._objective_value(state)] if record_every > 0 else None
    events = []
    if objective is not None:
        events.append((record_every, lambda s: objective.append(engine._objective_value(s))))
    state = _drive_slots(state, slots, lambda s: engine._slot(s, None), events)
    return state, objective


class AsyncEngine:
    """Batched event-driven driver for any :class:`LocalUpdate`, on one device.

    Configured by :class:`repro_torch.sim.EngineConfig` (``config=...``);
    keyword arguments (``slot_wakes``, ``rates``, ``batch_size``,
    ``scenario``, ``seed``, ``dtype``, ``fused``, ``device``) override its
    fields.
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

        self.fused = _resolve_fused(update, cfg.fused, dev, self.dtype, delay is not None)
        if self.fused:
            # The fused kernel consumes padded (n, K) neighbour tables
            # whatever the MixOp backend (dense graphs go through the CSR form).
            idx, w = self._padded_tables(update)
            self._fidx = torch.as_tensor(idx, dtype=torch.int32, device=dev)
            self._fw = torch.as_tensor(w, dtype=torch.float32, device=dev)
        else:
            self._fidx = self._fw = None

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
        return SimState(
            Theta=Theta,
            hist=hist,
            ptr=torch.zeros((), dtype=torch.long, device=dev),
            active=torch.ones(self.n, dtype=torch.bool, device=dev),
            generator=gen,
            ustate=self.update.init_state(),
            applied=torch.zeros((), dtype=torch.long, device=dev),
            dropped=torch.zeros((), dtype=torch.long, device=dev),
            messages=torch.zeros((), dtype=torch.float32, device=dev),
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
        """One super-tick; ``wake_mask`` forces the wake set (None samples it)."""
        n, dev = self.n, self.device
        gen = state.generator
        active = state.active
        if wake_mask is None:
            if self._leave is not None:
                leave = torch.rand(n, generator=gen, device=dev) < self._leave
                rejoin = torch.rand(n, generator=gen, device=dev) < self._rejoin
                active = torch.where(active, ~leave, rejoin)
            wake = (torch.rand(n, generator=gen, device=dev) < self._wake_p) & active
            if self._drop is not None:
                wake = wake & (torch.rand(n, generator=gen, device=dev) >= self._drop)
        else:
            # Forced wake sets (tests/diagnostics): no churn transition, no
            # straggler losses — but departed agents still cannot wake.
            wake = wake_mask & active
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

        deg = self._deg_counts[slot_rows]
        return SimState(
            Theta=Theta,
            hist=hist,
            ptr=state.ptr + 1,
            active=active,
            generator=gen,
            ustate=ustate,
            applied=state.applied + applied.sum(),
            dropped=state.dropped + dropped,
            messages=state.messages + torch.where(applied, deg, 0.0).sum(),
        )

    # -- drivers -----------------------------------------------------------
    def step(self, state: SimState, wake_mask) -> SimState:
        """One super-tick with an explicit (n,) boolean wake set."""
        if not isinstance(wake_mask, torch.Tensor):
            wake_mask = torch.as_tensor(np.asarray(wake_mask, dtype=bool))
        return self._slot(state, wake_mask.to(device=self.device, dtype=torch.bool))

    def advance(self, state: SimState, slots: int) -> SimState:
        """Run ``slots`` sampled super-ticks."""
        for _ in range(int(slots)):
            state = self._slot(state, None)
        return state

    def _objective_value(self, state: SimState) -> float:
        """The update's objective at ``state`` (recording hook)."""
        return self.update.objective(state.Theta)

    def run(
        self, Theta0, slots: int, record_every: int = 0, state: SimState | None = None
    ) -> SimResult:
        """Drive ``slots`` super-ticks from ``Theta0`` (or a resumed ``state``).

        ``record_every`` > 0 records the update's objective every that many
        slots (and at the start and the end).
        """
        state, objective = _run_driver(
            self, Theta0, slots, record_every=record_every, state=state
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
        )

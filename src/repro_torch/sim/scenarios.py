"""Deployment scenarios for the batched async engine: churn, delay, stragglers, arrivals.

Real P2P deployments (P4, arXiv 2405.17697; P4L, arXiv 2302.13438) are
defined by exactly what the faithful Poisson simulator does not model:
devices joining and leaving mid-training, messages arriving late, and
slow devices whose contributions are lost. Each knob here is a small
frozen config consumed by :class:`repro_torch.sim.AsyncEngine`; all of them
are per-slot processes drawn on the engine's device inside the super-tick.

Semantics (recorded deviations / modelling choices):

* **Churn** — a two-state Markov chain per agent: active agents depart
  with per-slot probability ``leave_prob`` and departed agents rejoin
  with ``rejoin_prob`` (either may be a per-agent array; a degenerate
  prob of 1.0 gives deterministic schedules for tests). Departed agents
  never wake, so their parameters freeze; neighbours keep mixing the
  departed agent's *last broadcast* model — the retained-cache semantics
  already used by ``dp_cd`` when a budget-exhausted agent stops ("it
  keeps broadcasting its last iterate implicitly since neighbours retain
  it").
* **Delay** — per-edge constant message delay measured in slots: agent i
  mixing from neighbour j reads j's model as of ``delay[i, k]`` slots ago
  (a ring-buffered history of start-of-slot snapshots). Constant per-edge
  delay makes every channel FIFO by construction — messages are applied
  in send order, never reordered. Delay 0 reads the current start-of-slot
  snapshot.
* **Stragglers** — a woken agent misses its slot with probability
  ``drop_prob`` (scalar or per-agent): the device rang but was too slow
  to complete the update, so nothing is computed, applied, or charged.
  Statistically this is equivalent to thinning that agent's effective
  clock rate by ``1 - drop_prob``; it exists as a separate knob so that
  device speed classes (``rates``) and loss processes (``drop_prob``)
  can be configured and swept independently.
* **Arrival** — agents the topology has never seen join mid-run at
  scheduled slots, attach to established peers, and (optionally) warm
  start from the Eq. 16 model-propagation step over their new
  neighbours; see :class:`ArrivalConfig`. It needs the engine's
  dynamic-topology mode (a structural graph change between slots).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _prob_vector(p, n: int, name: str) -> np.ndarray:
    v = np.broadcast_to(np.asarray(p, dtype=np.float64), (n,)).copy()
    if np.any(v < 0.0) or np.any(v > 1.0):
        raise ValueError(f"{name} must lie in [0, 1]")
    return v


@dataclasses.dataclass(frozen=True)
class ChurnConfig:
    """Per-slot join/leave process. Scalars broadcast to all agents."""

    leave_prob: float | np.ndarray = 0.01
    rejoin_prob: float | np.ndarray = 0.2

    def leave_vector(self, n: int) -> np.ndarray:
        """(n,) per-slot departure probabilities (scalars broadcast)."""
        return _prob_vector(self.leave_prob, n, "leave_prob")

    def rejoin_vector(self, n: int) -> np.ndarray:
        """(n,) per-slot rejoin probabilities for departed agents."""
        return _prob_vector(self.rejoin_prob, n, "rejoin_prob")


@dataclasses.dataclass(frozen=True)
class DelayConfig:
    """Per-edge message delay in slots.

    ``edge_delays``: scalar, or an (n, K) array aligned with the engine's
    padded neighbour tiles (K = max degree; entry [i, k] delays the
    message from agent i's k-th neighbour). Values clip to
    ``[0, max_delay]``; ``max_delay`` sizes the snapshot history ring.
    """

    max_delay: int = 1
    edge_delays: int | np.ndarray = 1

    def delay_tiles(self, idx_shape: tuple[int, int]) -> np.ndarray:
        """(n, K) per-edge delays in slots, aligned with the neighbour
        tiles of shape ``idx_shape`` and clipped to ``[0, max_delay]``."""
        if self.max_delay < 0:
            raise ValueError("max_delay must be >= 0")
        d = np.broadcast_to(
            np.asarray(self.edge_delays, dtype=np.int32), idx_shape
        ).copy()
        if np.any(d < 0):
            raise ValueError("edge delays must be >= 0")
        return np.minimum(d, self.max_delay).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class StragglerConfig:
    """Per-slot missed-wake process for woken agents (see module docstring)."""

    drop_prob: float | np.ndarray = 0.1

    def drop_vector(self, n: int) -> np.ndarray:
        """(n,) per-slot missed-wake probabilities (scalars broadcast)."""
        return _prob_vector(self.drop_prob, n, "drop_prob")


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """Agents *arriving* mid-run: they join the graph and start learning.

    Where :class:`ChurnConfig` models departure and rejoin of agents the
    graph already knows, arrival adds agents the topology has never seen.
    The engine holds the scheduled ids inactive (never woken, their edges
    detached) until their slot, then attaches them to the live graph and,
    with ``warm_start``, initializes their model by the Eq. 16
    model-propagation step with confidence ``c_i = 0``: a weighted
    neighbour average, iterated ``warm_rounds`` times (the propagation
    fixed point of an agent with no local data yet, arXiv 1610.05202). A
    cold start keeps the agent's initial row.

    ``schedule``: ``(slot, ids)`` pairs in absolute slot-counter terms —
    at the *start* of that slot the listed agents join. ``attach``:
    optional explicit ``{agent id: (neighbour ids,)}`` map; ids without an
    entry attach to ``attach_k`` established agents drawn from a numpy
    generator seeded by ``(seed, slot)``. Numpy only: the reference's
    class, copied.
    """

    schedule: tuple[tuple[int, tuple[int, ...]], ...] = ()
    attach_k: int = 4
    attach_weight: float = 1.0
    attach: dict | None = None
    warm_start: bool = True
    warm_rounds: int = 2
    seed: int = 0

    def __post_init__(self):
        seen: set[int] = set()
        for slot, ids in self.schedule:
            if slot < 1:
                raise ValueError(f"arrival slots are 1-based slot counts, got {slot}")
            dup = seen.intersection(ids)
            if dup:
                raise ValueError(f"agents scheduled to arrive twice: {sorted(dup)}")
            seen.update(ids)
        if self.attach_k < 1:
            raise ValueError("attach_k must be >= 1")
        if self.warm_rounds < 1:
            raise ValueError("warm_rounds must be >= 1")

    def all_ids(self) -> tuple[int, ...]:
        """Every agent id that arrives at some point, in schedule order."""
        return tuple(i for _, ids in self.schedule for i in ids)

    def by_slot(self) -> dict[int, tuple[int, ...]]:
        """{slot: ids arriving at its start}, merged across schedule entries."""
        out: dict[int, tuple[int, ...]] = {}
        for slot, ids in self.schedule:
            out[slot] = out.get(slot, ()) + tuple(ids)
        return dict(sorted(out.items()))

    def neighbors_for(self, agent: int, established, rng) -> np.ndarray:
        """Attachment targets for ``agent``: the explicit map, or a draw of
        ``attach_k`` of the ``established`` ids (active, already joined)
        without replacement, capped at their count."""
        if self.attach and agent in self.attach:
            return np.asarray(self.attach[agent], dtype=np.int64)
        established = np.asarray(established, dtype=np.int64)
        k = min(self.attach_k, len(established))
        if k < 1:
            raise ValueError(f"no established agents for arrival of {agent}")
        return rng.choice(established, size=k, replace=False)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Bundle of deployment conditions; ``None`` disables a dimension."""

    churn: ChurnConfig | None = None
    delay: DelayConfig | None = None
    straggler: StragglerConfig | None = None
    arrival: ArrivalConfig | None = None

    @staticmethod
    def ideal() -> "Scenario":
        """No churn, no delay, no stragglers — the pure thinned-clock model."""
        return Scenario()

"""Deployment scenarios for the batched async engine: churn, delay, stragglers.

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
* **Arrival** — agents joining the topology mid-run need the dynamic
  topology layer, which this package does not have yet (ROADMAP A11):
  ``Scenario(arrival=...)`` raises ``NotImplementedError``.
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
class Scenario:
    """Bundle of deployment conditions; ``None`` disables a dimension."""

    churn: ChurnConfig | None = None
    delay: DelayConfig | None = None
    straggler: StragglerConfig | None = None
    arrival: object = None  # ArrivalConfig: not ported yet (ROADMAP A11)

    def __post_init__(self):
        if self.arrival is not None:
            raise NotImplementedError(
                "Scenario.arrival (ArrivalConfig) needs dynamic topology, "
                "which is ROADMAP item A11 and not ported yet"
            )

    @staticmethod
    def ideal() -> "Scenario":
        """No churn, no delay, no stragglers — the pure thinned-clock model."""
        return Scenario()

"""Poisson clocks, time-slotted: binomial thinning into batched super-ticks.

The paper's asynchrony model gives every agent an i.i.d. Poisson clock
(rate r_i = 1 in the paper; heterogeneous rates model device speed
classes). The faithful simulators replay the induced global clock one
wake-up at a time — an O(T) sequential scan. The batched engine instead
slices time into slots of duration tau and *thins* the superposed process:
over one slot, agent i rings at least once with probability

    p_i = 1 - exp(-r_i * tau)

independently across agents, so a slot's wake set is one Bernoulli draw
per agent and a whole slot runs as a single super-tick.

Recorded deviation from pure Poisson semantics: within a slot an agent
updates **at most once** (the Binomial(1, p_i) thinning collapses multiple
rings), and all agents woken in the same slot read the same start-of-slot
snapshot (bounded staleness of one slot). Both effects vanish as
tau -> 0 (p_i ~ r_i * tau) and neither moves the fixed points — every
update is still an exact Eq. 4/6/16 block step from *some* recent state.
"""

from __future__ import annotations

import numpy as np


def normalize_rates(rates, n: int) -> np.ndarray:
    """Per-agent clock rates as a positive (n,) float64 vector (default 1)."""
    if rates is None:
        return np.ones(n, dtype=np.float64)
    r = np.broadcast_to(np.asarray(rates, dtype=np.float64), (n,)).copy()
    if np.any(r <= 0.0) or not np.all(np.isfinite(r)):
        raise ValueError("clock rates must be positive and finite")
    return r


def slot_duration(rates: np.ndarray, slot_wakes: float) -> float:
    """tau such that one slot carries ~``slot_wakes`` wake-ups in expectation.

    Exact for the superposed count (sum of Poissons with rate sum(r) * tau);
    the per-agent thinned expectation sum_i (1 - exp(-r_i tau)) is slightly
    below it — the collapsed-multiple-rings deviation recorded above.
    """
    if slot_wakes <= 0:
        raise ValueError("slot_wakes must be positive")
    return float(slot_wakes) / float(rates.sum())


def wake_probs(rates: np.ndarray, tau: float) -> np.ndarray:
    """p_i = 1 - exp(-r_i * tau): per-slot wake probability per agent."""
    return -np.expm1(-rates * tau)


def expected_wakes(rates: np.ndarray, tau: float) -> float:
    """Expected thinned wake count per slot: sum_i p_i."""
    return float(wake_probs(rates, tau).sum())


def default_batch_size(rates: np.ndarray, tau: float) -> int:
    """Static woken-rows batch size B with negligible overflow probability.

    The wake count is Poisson-binomial with mean mu = sum p_i and variance
    <= mu; mean + 6 sigma (+ slack for tiny mu) keeps P(overflow) ~ 1e-9.
    Overflowing wakes are dropped and counted (``SimResult.wakes_dropped``).
    """
    mu = expected_wakes(rates, tau)
    b = int(np.ceil(mu + 6.0 * np.sqrt(mu) + 8.0))
    n = len(rates)
    return int(min(max(b, 8), n))

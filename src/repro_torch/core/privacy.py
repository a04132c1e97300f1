"""Differential-privacy machinery (Sec. 3, Thm. 1, Prop. 2, Remark 4).

Port of ``repro.core.privacy``: host-side numpy, copied so the port needs
nothing of the reference; its arrays equal the reference's bit for bit.
Implements:

* Laplace noise scales ``s_i(t) = 2 L0 / (eps_i(t) m_i)`` (Thm. 1) and the
  Gaussian variant (Remark 4).
* The Kairouz–Oh–Viswanath composition of Thm. 1: the three-term min giving
  the overall ``(eps_bar, delta_bar)`` for a sequence of per-step epsilons.
* Budget *inversion*: given an overall budget, find the per-step epsilon
  under equal splitting (bisection on the composition formula) — this is how
  the paper's experiments split budgets ("splits its privacy budget equally
  across T_i iterations using Theorem 1").
* The utility-optimal time-decreasing allocation of Prop. 2 / Lemma 3:
  ``eps_i*(t) ∝ C^{t/3}``.
* A per-agent :class:`PrivacyAccountant` that tracks spend and enforces
  stopping.
* The Thm. 2 utility-loss bound for plotting against empirical curves.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def laplace_scale(l0: float, eps_step: float, m_i: int | float) -> float:
    """Thm. 1: s_i(t) = 2 L0 / (eps_i(t) m_i)."""
    if eps_step <= 0:
        raise ValueError("eps_step must be positive")
    return 2.0 * l0 / (eps_step * max(float(m_i), 1.0))


def gaussian_scale(l0_l2: float, eps_step: float, delta_step: float, m_i: int | float) -> float:
    """Remark 4: s_i(t) >= 2 L0* sqrt(2 ln(2/delta)) / eps (per-example L2)."""
    if eps_step <= 0 or not (0 < delta_step < 1):
        raise ValueError("need eps > 0 and 0 < delta < 1")
    return (
        2.0
        * l0_l2
        * math.sqrt(2.0 * math.log(2.0 / delta_step))
        / (eps_step * max(float(m_i), 1.0))
    )


def compose_kairouz(eps_steps: np.ndarray, delta_bar: float) -> float:
    """Overall eps_bar of Thm. 1 for per-step eps list and slack delta_bar.

    eps_bar = min( sum eps_t,
                   sum (e^e - 1) e / (e^e + 1) + sqrt( sum 2 e^2 log(e + sqrt(sum e^2)/delta) ),
                   sum (e^e - 1) e / (e^e + 1) + sqrt( sum 2 e^2 log(1/delta) ) )
    """
    e = np.asarray(eps_steps, dtype=np.float64)
    if np.any(e < 0):
        raise ValueError("per-step epsilons must be non-negative")
    basic = e.sum()
    if delta_bar <= 0:
        return float(basic)
    kl = np.sum((np.expm1(e)) * e / (np.exp(e) + 1.0))
    sq = np.sum(e**2)
    adv1 = kl + math.sqrt(2.0 * sq * math.log(math.e + math.sqrt(sq) / delta_bar))
    adv2 = kl + math.sqrt(2.0 * sq * math.log(1.0 / delta_bar))
    return float(min(basic, adv1, adv2))


def compose_uniform(eps_step, counts: np.ndarray, delta_bar: float) -> np.ndarray:
    """Vectorized :func:`compose_kairouz` for k equal per-step epsilons.

    ``counts``: (n,) number of spent steps per agent, each spent at that
    agent's constant ``eps_step`` (a scalar, or an array broadcastable
    against ``counts`` — the re-split schedules give under-waking agents a
    larger per-step epsilon). Returns the (n,) composed eps_bar — what n
    separate ``compose_kairouz(np.full(k, eps_step), delta_bar)`` calls
    would give, without the per-agent python loop (the batched engine's
    and ``dp_cd.run_private``'s accounting at large n).
    """
    k = np.asarray(counts, dtype=np.float64)
    e = np.asarray(eps_step, dtype=np.float64)
    basic = k * e
    if delta_bar <= 0:
        return basic
    kl = k * (np.expm1(e) * e / (np.exp(e) + 1.0))
    sq = k * e * e
    adv1 = kl + np.sqrt(2.0 * sq * np.log(math.e + np.sqrt(sq) / delta_bar))
    adv2 = kl + np.sqrt(2.0 * sq * math.log(1.0 / delta_bar))
    return np.where(k > 0, np.minimum(basic, np.minimum(adv1, adv2)), 0.0)


def invert_uniform_budget(eps_bar: float, T_i: int, delta_bar: float) -> float:
    """Largest per-step eps s.t. T_i equal steps compose to <= eps_bar.

    Monotone in eps -> bisection. This is what "split the budget equally
    across T_i iterations using Theorem 1" means operationally.
    """
    if T_i <= 0:
        raise ValueError("T_i must be positive")
    if eps_bar <= 0:
        raise ValueError("eps_bar must be positive")

    def total(eps_step):
        return compose_kairouz(np.full(T_i, eps_step), delta_bar)

    lo, hi = 0.0, eps_bar  # eps_step = eps_bar always overshoots for T_i > 1
    if total(hi) <= eps_bar:
        return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if total(mid) <= eps_bar:
            lo = mid
        else:
            hi = mid
    return lo


def proposition2_allocation(eps_bar: float, T: int, C: float) -> np.ndarray:
    """Lemma 3: eps*(t) = (C^{1/3} - 1) / (C^{T/3} - 1) * C^{t/3} * eps_bar.

    Returns the (T,) schedule over *global* iterations 0..T-1; it sums to
    eps_bar. C = 1 - sigma / (n L_max) in (0, 1).
    """
    if not (0.0 < C < 1.0):
        raise ValueError("contraction factor must be in (0,1)")
    r = C ** (1.0 / 3.0)
    t = np.arange(T, dtype=np.float64)
    coef = (r - 1.0) / (r**T - 1.0)
    return coef * (r**t) * eps_bar


def schedule_renormalization(schedule_t: np.ndarray, T: int, C: float) -> float:
    """lambda_{T_i}(i) of Prop. 2: sum over the agent's wake ticks of the
    Lemma-3 coefficients. Dividing eps*(t) by it makes the realized spend
    exactly eps_bar for this schedule."""
    r = C ** (1.0 / 3.0)
    coef = (r - 1.0) / (r**T - 1.0)
    return float(np.sum(coef * (r ** np.asarray(schedule_t, dtype=np.float64))))


@dataclasses.dataclass
class PrivacyAccountant:
    """Tracks one agent's per-step epsilons and reports the composed spend."""

    delta_bar: float
    steps: list = dataclasses.field(default_factory=list)

    def spend(self, eps_step: float):
        if eps_step < 0:
            raise ValueError("eps must be >= 0")
        self.steps.append(float(eps_step))

    @property
    def eps_bar(self) -> float:
        if not self.steps:
            return 0.0
        return compose_kairouz(np.asarray(self.steps), self.delta_bar)

    def can_spend(self, eps_step: float, budget: float) -> bool:
        trial = np.asarray(self.steps + [float(eps_step)])
        return compose_kairouz(trial, self.delta_bar) <= budget + 1e-12


def theorem2_bound(
    gap0: float,
    T: int,
    n: int,
    L_max: float,
    L_min: float,
    sigma: float,
    noise_sq_per_tick: np.ndarray,
) -> np.ndarray:
    """Thm. 2 upper bound on E[Q(t)] - Q* for t = 0..T.

    ``noise_sq_per_tick[t] = sum_i (mu D_ii c_i s_i(t))^2`` — the expected
    squared scaled-noise magnitude injected at tick t (2x for Laplace
    variance is folded in by the caller via ``2 * s^2`` if desired; we follow
    the theorem statement and take the (mu D c s)^2 terms directly).
    """
    rho = sigma / (n * L_max)
    C = 1.0 - rho
    bound = np.empty(T + 1)
    bound[0] = gap0
    acc = 0.0
    for t in range(1, T + 1):
        acc = C * acc + noise_sq_per_tick[t - 1] / (n * L_min)
        bound[t] = gap0 * (C**t) + acc
    return bound


def uniform_noise_limit(a: float, rho: float) -> float:
    """Supp. B: additive loss a/rho as T -> inf under uniform noise scales."""
    return a / rho

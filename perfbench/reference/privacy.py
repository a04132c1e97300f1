"""Theorem 1's noise scale for the private step (Eq. 6), in plain numpy.

Each agent splits its budget (eps_bar, delta_bar) equally over its T_i
planned updates: the per-step eps is the largest whose T_i-fold composition
(Kairouz et al.'s bound, Thm. 1) stays within eps_bar, found by bisection.
The Laplace mechanism's scale is then s_i = 2 L0 / (eps_step m_i), with L0
the L1 bound of a point gradient: the clip C, as the quadratic loss has no
bound of its own.
"""

from __future__ import annotations

import math

import numpy as np


def composed_eps(eps_step: float, steps: int, delta_bar: float) -> float:
    """The overall eps of ``steps`` equal steps of ``eps_step`` (Thm. 1)."""
    k, e = float(steps), float(eps_step)
    basic = k * e
    if delta_bar <= 0:
        return basic
    kl = k * (math.expm1(e) * e / (math.exp(e) + 1.0))
    sq = k * e * e
    adv1 = kl + math.sqrt(2.0 * sq * math.log(math.e + math.sqrt(sq) / delta_bar))
    adv2 = kl + math.sqrt(2.0 * sq * math.log(1.0 / delta_bar))
    return min(basic, adv1, adv2)


def eps_per_step(eps_bar: float, steps: int, delta_bar: float) -> float:
    """The largest per-step eps whose ``steps``-fold composition is at most
    ``eps_bar`` (bisection, 200 halvings)."""
    lo, hi = 0.0, float(eps_bar)
    if composed_eps(hi, steps, delta_bar) <= eps_bar:
        return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if composed_eps(mid, steps, delta_bar) <= eps_bar:
            lo = mid
        else:
            hi = mid
    return lo


def laplace_scales(eps_bar: float, delta_bar: float, steps: int, clip: float,
                   m: np.ndarray) -> np.ndarray:
    """(n,) Laplace scales s_i = 2 C / (eps_step m_i) of Thm. 1."""
    eps = eps_per_step(eps_bar, steps, delta_bar)
    return 2.0 * float(clip) / (eps * np.maximum(np.asarray(m, dtype=np.float64), 1.0))

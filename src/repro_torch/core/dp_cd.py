"""The differentially-private algorithm (Sec. 3.2, Eq. 6).

Port of ``repro.core.dp_cd``. Each agent i replaces its Eq. 4 update with

    Theta_i <- (1-a) Theta_i + a ( sum_j (W_ij/D_ii) Theta_j
                                   - mu c_i ( grad L_i(Theta_i) + eta_i(t) ) )

with eta_i(t) ~ Laplace(0, s_i(t))^p, s_i(t) = 2 L0 / (eps_i(t) m_i).

The run follows the experiments in Sec. 5: every agent gets an
overall budget (eps_bar, delta_bar), splits it over its expected T_i = T/n
wake-ups (equal split via composition inversion, or the Prop.-2 decreasing
schedule), and *stops updating* once its budget is spent (it keeps
broadcasting its last iterate implicitly since neighbours retain it).

The planning and accounting are host-side numpy, copied from the
reference, so noise scales and spends equal its own. The tick loop is a
Python loop on ``device`` (the reference's ``lax.scan``), and its noise
comes from a ``torch.Generator``: the draws differ from the reference's
``jax.random`` stream, so a test passes the reference's draws in as
``noise_draws``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import privacy
from repro_torch.core.coordinate_descent import (
    CDResult,
    _cd_row,
    _record_ticks,
    sample_wake_sequence,
    standard_laplace,
)
from repro_torch.core.graph import neighbor_counts
from repro_torch.core.objective import Objective
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DPConfig:
    eps_bar: float  # overall per-agent budget
    delta_bar: float = np.exp(-5.0)  # paper Sec. 5: delta = exp(-5)
    schedule: str = "uniform"  # "uniform" | "prop2"
    T_total: int = 0  # planned global ticks (agents plan for T_i = T/n)
    mechanism: str = "laplace"  # "laplace" (Thm. 1) | "gaussian" (Remark 4)
    delta_step: float = 1e-6  # per-step delta for the Gaussian mechanism

    def per_step_eps(self, obj: Objective, wake_ticks: np.ndarray) -> np.ndarray:
        """Per-wake-up epsilon for one agent given its wake ticks."""
        T_i = len(wake_ticks)
        if T_i == 0:
            return np.zeros(0)
        if self.schedule == "uniform":
            eps = privacy.invert_uniform_budget(self.eps_bar, T_i, self.delta_bar)
            return np.full(T_i, eps)
        elif self.schedule == "prop2":
            C = obj.contraction()
            full = privacy.proposition2_allocation(self.eps_bar, self.T_total, C)
            lam = privacy.schedule_renormalization(wake_ticks, self.T_total, C)
            return full[np.asarray(wake_ticks)] / max(lam, 1e-12)
        raise ValueError(f"unknown schedule {self.schedule}")


def mechanism_scale(cfg: DPConfig, l0: float, eps_step: float, m_i: float) -> float:
    """Per-step noise scale for the configured mechanism (Thm. 1 / Remark 4)."""
    if cfg.mechanism == "gaussian":
        # Remark 4: L2 sensitivity; l0 doubles as the L2 bound here.
        return privacy.gaussian_scale(l0, eps_step, cfg.delta_step, m_i)
    return privacy.laplace_scale(l0, eps_step, m_i)


def mechanism_scales(cfg: DPConfig, l0: float, eps_steps, m) -> np.ndarray:
    """Vectorized :func:`mechanism_scale` over per-agent epsilons/samples.

    Same formulas, element-wise (the expressions mirror the scalar code
    exactly so the two paths agree bitwise) — this is what keeps planning
    O(distinct epsilons) instead of an O(n) python loop.
    """
    eps = np.asarray(eps_steps, dtype=np.float64)
    mm = np.maximum(np.asarray(m, dtype=np.float64), 1.0)
    if np.any(eps <= 0):
        raise ValueError("eps_step must be positive")
    if cfg.mechanism == "gaussian":
        if not (0 < cfg.delta_step < 1):
            raise ValueError("need 0 < delta < 1")
        return 2.0 * l0 * np.sqrt(2.0 * np.log(2.0 / cfg.delta_step)) / (eps * mm)
    return 2.0 * l0 / (eps * mm)


def _finite_l0(obj: Objective) -> float:
    l0 = obj.lipschitz_l1()
    if not np.isfinite(l0):
        raise ValueError(
            "loss has unbounded gradient; set Objective.clip (Supp. D.2) "
            "to get a finite sensitivity"
        )
    return l0


def uniform_noise_plan(obj: Objective, cfg: DPConfig, planned_Ti: int):
    """Per-agent uniform-split plan: (eps_step, (n,) noise scales).

    Each agent plans for ``planned_Ti`` wake-ups, splits its overall
    ``(eps_bar, delta_bar)`` budget equally over them via composition
    inversion (Thm. 1), and uses the resulting constant per-step noise
    scale until the budget is spent. Shared by :func:`run_private`'s
    per-tick schedule and the batched engine's ``DPCDUpdate``: agents that
    realize at least ``planned_Ti`` wake-ups stop at identical spend in
    both. (For agents that wake fewer times, :func:`run_private`
    re-splits over the *realized* count — larger per-step eps — while the
    engine keeps the planned scale and under-spends; both stay within
    budget.)
    """
    if planned_Ti <= 0:
        raise ValueError("planned_Ti must be positive")
    l0 = _finite_l0(obj)
    eps_step = privacy.invert_uniform_budget(cfg.eps_bar, planned_Ti, cfg.delta_bar)
    m = np.maximum(obj.data.num_examples, 1.0)
    return eps_step, mechanism_scales(cfg, l0, eps_step, m)


def _uniform_tick_schedule(obj, cfg, wake, m, l0, planned_Ti):
    """Vectorized uniform-split accounting for :func:`run_private`.

    Per-tick noise scales and active flags plus the composed per-agent
    spend, in array passes: each agent plans ``planned_Ti`` wake-ups via
    :func:`uniform_noise_plan`, an agent that realizes fewer re-splits its
    budget over the realized count (one budget inversion per *distinct*
    realized count, not per agent), and every agent freezes once its
    planned steps are spent; spend composes through
    :func:`privacy.compose_uniform`.
    """
    n, T = obj.n, len(wake)
    total = np.bincount(wake, minlength=n)
    spent = np.minimum(total, planned_Ti)
    eps_step, scale_i = uniform_noise_plan(obj, cfg, planned_Ti)
    eps_i = np.full(n, eps_step)
    for k in np.unique(spent[spent < planned_Ti]):
        if k == 0:
            continue  # never woke: nothing spent, eps_i irrelevant
        sel = spent == k
        eps_k = privacy.invert_uniform_budget(cfg.eps_bar, int(k), cfg.delta_bar)
        eps_i[sel] = eps_k
        scale_i[sel] = mechanism_scales(cfg, l0, eps_k, m[sel])
    # Occurrence index of each tick within its agent's wake sequence.
    order = np.argsort(wake, kind="stable")
    starts = np.concatenate([[0], np.cumsum(total)[:-1]])
    occ = np.empty(T, dtype=np.int64)
    occ[order] = np.arange(T) - np.repeat(starts, total)
    active = occ < planned_Ti
    noise_scales = np.where(active, scale_i[wake], 0.0)
    eps_spent = privacy.compose_uniform(eps_i, spent, cfg.delta_bar)
    return noise_scales, active, eps_spent


def _prop2_tick_schedule(obj, cfg, wake, m, l0, planned_Ti):
    """Prop. 2 decreasing schedule: per-step epsilons index the global
    sequential tick, so this stays a per-tick accountant loop."""
    n, T = obj.n, len(wake)
    accountants = [privacy.PrivacyAccountant(cfg.delta_bar) for _ in range(n)]
    noise_scales = np.zeros(T)
    active = np.ones(T, dtype=bool)
    wake_count = np.zeros(n, dtype=int)
    per_agent_eps: dict[int, np.ndarray] = {}
    for i in range(n):
        ticks = np.nonzero(wake == i)[0][:planned_Ti]
        per_agent_eps[i] = cfg.per_step_eps(obj, ticks)
    for t in range(T):
        i = int(wake[t])
        k = wake_count[i]
        if k >= len(per_agent_eps[i]):
            active[t] = False  # budget exhausted: agent skips its update
            continue
        eps_t = per_agent_eps[i][k]
        noise_scales[t] = mechanism_scale(cfg, l0, eps_t, m[i])
        accountants[i].spend(eps_t)
        wake_count[i] += 1
    return noise_scales, active, np.array([a.eps_bar for a in accountants])


@dataclasses.dataclass
class DPCDResult(CDResult):
    eps_spent: np.ndarray  # (n,) composed eps per agent
    noise_scales: np.ndarray  # (T,) Laplace scale used at each tick (0 if agent stopped)


def standard_draws(mechanism: str, shape, generator, device, dtype):
    """Standard noise draws of the mechanism: Laplace(0, 1) (Thm. 1) or
    N(0, 1) (Remark 4)."""
    if mechanism == "gaussian":
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return standard_laplace(shape, generator, device, dtype)


def run_private(
    obj: Objective,
    Theta0: np.ndarray,
    T: int,
    cfg: DPConfig,
    rng: np.random.Generator,
    record_every: int = 1,
    wake_sequence: np.ndarray | None = None,
    record_objective: bool = True,
    noise_draws=None,
    device="cuda",
    dtype=torch.float32,
) -> DPCDResult:
    """Private CD with faithful per-agent budgeting and stopping.

    ``rng`` is consumed as the reference consumes it: the wake sequence
    (unless given), then one integer that seeds the noise. ``noise_draws``:
    optional (T, p) standard draws of the mechanism (Laplace or Gaussian)
    used in place of the generator's, so a test can feed the reference's;
    the tick at ``t`` adds ``noise_scales[t] * noise_draws[t]`` to the
    woken agent's gradient. The loop runs on ``device`` in ``dtype``
    (float32, as the reference runs it).
    """
    dev = resolve_device(device)
    n, p = obj.n, obj.p
    if wake_sequence is None:
        wake_sequence = sample_wake_sequence(n, T, rng)
    wake = np.asarray(wake_sequence)
    l0 = _finite_l0(obj)
    m = np.maximum(obj.data.num_examples, 1.0)

    # Plan: each agent expects T_i = T/n wake-ups and allocates eps for them.
    planned_Ti = max(T // n, 1)
    cfg = dataclasses.replace(cfg, T_total=T)
    schedule = _uniform_tick_schedule if cfg.schedule == "uniform" else _prop2_tick_schedule
    noise_scales, active, eps_spent = schedule(obj, cfg, wake, m, l0, planned_Ti)

    seed = int(rng.integers(2**31 - 1))  # the reference's noise key comes from here
    if noise_draws is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        draws = standard_draws(cfg.mechanism, (T, p), gen, dev, dtype)
    else:
        draws = torch.tensor(np.asarray(noise_draws)).to(device=dev, dtype=dtype)
        if tuple(draws.shape) != (T, p):
            raise ValueError(f"noise_draws must be {(T, p)}, got {tuple(draws.shape)}")
    noise = draws * torch.as_tensor(noise_scales, device=dev, dtype=dtype)[:, None]

    # The tick loop; a stopped agent's tick is the identity.
    Theta = torch.as_tensor(np.asarray(Theta0)).to(device=dev, dtype=dtype).clone()
    marks = [0] + sorted(_record_ticks(T, record_every))
    objective = [float(obj.value(Theta)) if record_objective else 0.0]
    for t in range(T):
        if active[t]:
            i = int(wake[t])
            Theta[i] = _cd_row(obj, Theta, i, noise[t])
        if record_objective and t + 1 in marks:
            objective.append(float(obj.value(Theta)))
    if not record_objective:
        objective = [0.0] * len(marks)
    deg_counts = neighbor_counts(obj.graph)
    messages = np.concatenate([[0.0], np.cumsum(deg_counts[wake] * active)])
    return DPCDResult(
        Theta=Theta.cpu().numpy(),
        objective=np.asarray(objective),
        messages=messages[marks],
        wake_sequence=wake,
        eps_spent=eps_spent,
        noise_scales=noise_scales,
    )

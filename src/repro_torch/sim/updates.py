"""The ``LocalUpdate`` protocol: one engine, three algorithms.

Port of ``repro.sim.updates``. The engine owns time, wake sampling,
scenarios and the gather / mix / scatter plumbing; what a woken agent does
with its neighbour sum is the update's:

* :class:`CDUpdate` — the non-private Eq. 4 block step;
* :class:`DPCDUpdate` — the Eq. 6 private step with a per-agent uniform
  budget split and accountant-style stopping (a budget-exhausted agent
  wakes but applies nothing, like ``dp_cd.run_private``'s inactive ticks);
* :class:`PropagationUpdate` — the Eq. 16 exact block minimizer of model
  propagation (Supp. C), data-free and so compatible with the private
  warm start.

All three reduce to the same contract: given the start-of-slot snapshot,
the woken row indices (padded with the sentinel n) and their raw neighbour
sums, return replacement rows and an ``applied`` mask. The math lives next
to its sequential twin (``eq4_theta_rows`` in ``coordinate_descent``,
``propagation_rows_from`` in ``model_propagation``).

``apply_fused`` (CD and DP, quadratic loss) is the one-launch path: the
``fused_row_update`` CUDA kernel gathers, mixes, updates and scatters the
woken rows into Theta in place; a budget-exhausted DP row is a kernel
sentinel. The private rules draw their noise from the engine's
``torch.Generator``, or take it as ``draws`` so a test can inject the
reference's ``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import privacy
from repro_torch.core.coordinate_descent import eq4_theta_rows
from repro_torch.core.dp_cd import DPConfig, standard_draws, uniform_noise_plan
from repro_torch.core.mixing import MixOp, mix_op
from repro_torch.core.model_propagation import propagation_objective, propagation_rows_from
from repro_torch.core.objective import Objective
from repro_torch.kernels import ops


def _eq4_fused_args(obj, krows, cols, w, consts, noise):
    """The fused kernel's inputs for one Eq. 4/6 woken batch, in the order
    ``ops.fused_row_update`` takes them before the slab.

    ``consts``: the row-gathered float32 constants (each (B, ...)); the
    per-row coefficient pack mirrors the unfused ``eq4_theta_rows_from``
    term grouping — ``[alpha, deg, mu * conf, 2 * lam]`` — so the two paths
    differ only in float32 reduction order. ``noise``: (B, p) gradient
    perturbation, or None for the non-private step.
    """
    f32 = torch.float32
    coef = torch.stack(
        [
            consts["alpha"].to(f32),
            consts["deg"].to(f32),
            obj.mu * consts["conf"].to(f32),
            2.0 * consts["lam"].to(f32),
        ],
        dim=1,
    )
    X, y, mask = (consts[k].to(f32) for k in ("X", "y", "mask"))
    return krows, cols, w, coef, X, y, mask, noise


def fused_rows(obj, rows, valid, device):
    """The fused kernel's row inputs for a woken batch: ``krows`` (B,)
    int32, ``rows`` with the sentinel n where ``valid`` is false (padding,
    or a budget-exhausted private row), and the float32 Eq. 4 constants
    gathered at ``rows``."""
    safe = torch.clamp(rows, max=obj.n - 1)
    t = obj.tensors(device, torch.float32)
    consts = {k: v[safe] for k, v in t.items()}
    krows = torch.where(valid, rows, obj.n).to(torch.int32)
    return krows, consts


def _eq4_fused_slab(obj, Theta_slab, krows, cols, w, consts, noise, limit):
    """Run the fused kernel for one Eq. 4/6 woken batch, in place on the slab
    (inputs as :func:`_eq4_fused_args` packs them)."""
    return ops.fused_row_update(
        *_eq4_fused_args(obj, krows, cols, w, consts, noise),
        Theta_slab,
        limit=limit,
        clip=None if obj.clip is None else float(obj.clip),
    )


@runtime_checkable
class LocalUpdate(Protocol):
    """What the engine needs from an update rule.

    ``apply`` runs inside the super-tick: ``rows`` is the (B,) woken index
    batch (padding sentinel n, clamped for gathers and never scattered),
    ``valid`` its (B,) realness mask, ``neigh`` the (B, p) raw neighbour
    sums from the (possibly delayed) snapshot, ``generator`` the engine's
    ``torch.Generator``. It returns ``(new_rows, applied, state)``: only
    rows with ``applied[b]`` are written back and charged messages.
    """

    @property
    def n(self) -> int:
        """Number of agents."""
        ...

    @property
    def p(self) -> int:
        """Model dimension per agent."""
        ...

    @property
    def graph(self):
        """The collaboration graph (dense or CSR)."""
        ...

    @property
    def mix(self) -> MixOp:
        """The neighbour-sum operator over :attr:`graph`."""
        ...

    def init_state(self):
        """The initial update state: ``()``, or a tensor with leading dim n
        that the engine moves to its device."""
        ...

    def apply(self, Theta, rows, valid, neigh, generator, state):
        """One batched update against the global (n, p) snapshot."""
        ...

    def apply_rows(self, theta_rows, rows, valid, neigh, generator, state):
        """One batched update from pre-gathered rows."""
        ...


@dataclasses.dataclass(frozen=True, eq=False)
class CDUpdate:
    """Non-private Eq. 4 coordinate-descent block step."""

    obj: Objective

    @property
    def n(self) -> int:
        """Number of agents."""
        return self.obj.n

    @property
    def p(self) -> int:
        """Model dimension per agent."""
        return self.obj.p

    @property
    def graph(self):
        """The collaboration graph of the objective."""
        return self.obj.graph

    @property
    def mix(self) -> MixOp:
        """The objective's neighbour-sum operator."""
        return self.obj.mix

    def init_state(self):
        """Stateless: the empty tuple."""
        return ()

    def apply(self, Theta, rows, valid, neigh, generator, state):
        """Gather the woken rows from the global snapshot and update them."""
        safe = torch.clamp(rows, max=self.n - 1)
        return self.apply_rows(Theta[safe], rows, valid, neigh, generator, state)

    def apply_rows(self, theta_rows, rows, valid, neigh, generator, state):
        """Batched Eq. 4 step for the gathered rows."""
        return eq4_theta_rows(self.obj, theta_rows, rows, neigh), valid, state

    @property
    def fused_supported(self) -> bool:
        """The fused kernel implements the quadratic point grad only."""
        return self.obj.loss.name == "quadratic"

    def apply_fused(self, Theta_slab, rows, valid, generator, state, cols, w):
        """Fused-kernel Eq. 4 step over the (n, p) float32 slab, in place.

        ``rows``: (B,) woken agent ids (sentinel n); ``cols``/``w``: (B, K)
        int32 / float32 row-gathered neighbour tables. Returns the updated
        slab (the same tensor), the applied mask and the state.
        """
        if not self.fused_supported:
            raise _fused_unsupported(self.obj)
        krows, consts = fused_rows(self.obj, rows, valid, Theta_slab.device)
        new_slab = _eq4_fused_slab(self.obj, Theta_slab, krows, cols, w, consts, None, self.n)
        return new_slab, valid, state

    def objective(self, Theta) -> float:
        """Q(Theta) of Eq. 2 (used by ``record_every``)."""
        return float(self.obj.value(Theta))


def _fused_unsupported(obj) -> NotImplementedError:
    return NotImplementedError(
        f"fused path supports the quadratic loss only, got {obj.loss.name!r}"
    )


@dataclasses.dataclass(frozen=True, eq=False)
class DPCDUpdate:
    """Eq. 6 private step with per-agent budget stopping.

    Build via :meth:`plan`. Each agent splits ``(eps_bar, delta_bar)``
    equally over ``planned_Ti`` expected wake-ups (Thm. 1 composition
    inversion, shared with ``dp_cd.uniform_noise_plan``) and freezes once
    they are spent. The state is the (n,) int32 count of applied private
    updates, on the engine's device; :meth:`eps_spent` composes it back
    into per-agent spend.

    Only the uniform schedule is supported, as in the reference: the
    Prop. 2 decreasing schedule indexes the *global sequential* tick,
    which a batched slot does not expose (use ``dp_cd.run_private``).

    The slot reads no device value on the host: budget stopping is a
    mask, and the counts are updated by adding ``applied`` at the woken
    rows (clamped; the valid ones are distinct), in place like Theta.
    :meth:`eps_spent` and :meth:`budget_stopped` read the counts when
    called, never inside a slot.
    """

    obj: Objective
    cfg: DPConfig
    planned_Ti: int
    eps_step: float
    scales: np.ndarray  # (n,) per-agent constant noise scale

    @classmethod
    def plan(cls, obj: Objective, cfg: DPConfig, planned_Ti: int) -> "DPCDUpdate":
        """Plan the per-agent uniform budget split for ``planned_Ti`` wake-ups."""
        if cfg.schedule != "uniform":
            raise NotImplementedError(
                "the batched engine supports the uniform budget split only; "
                "the Prop. 2 schedule needs the sequential dp_cd.run_private"
            )
        eps_step, scales = uniform_noise_plan(obj, cfg, planned_Ti)
        return cls(obj=obj, cfg=cfg, planned_Ti=planned_Ti, eps_step=eps_step, scales=scales)

    @property
    def n(self) -> int:
        """Number of agents."""
        return self.obj.n

    @property
    def p(self) -> int:
        """Model dimension per agent."""
        return self.obj.p

    @property
    def graph(self):
        """The collaboration graph of the objective."""
        return self.obj.graph

    @property
    def mix(self) -> MixOp:
        """The objective's neighbour-sum operator."""
        return self.obj.mix

    def init_state(self):
        """(n,) int32 count of applied private updates per agent (on the
        host; the engine moves it to its device)."""
        return torch.zeros(self.n, dtype=torch.int32)

    def _scales(self, device, dtype):
        """The (n,) noise scales on ``device`` in ``dtype``, made once and kept."""
        cache = self.__dict__.setdefault("_scale_cache", {})
        key = (torch.device(device), dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(self.scales).to(device=key[0], dtype=dtype)
        return cache[key]

    def _budget(self, rows, valid, state):
        """Clamped rows and the (B,) mask of woken rows with budget left."""
        safe = torch.clamp(rows, max=self.n - 1)
        return safe, valid & (state[safe] < self.planned_Ti)

    def _draws(self, shape, generator, device, dtype, draws):
        if draws is None:
            return standard_draws(self.cfg.mechanism, shape, generator, device, dtype)
        if not isinstance(draws, torch.Tensor):
            draws = torch.tensor(np.asarray(draws))
        return draws.to(device=device, dtype=dtype)

    def apply(self, Theta, rows, valid, neigh, generator, state, draws=None):
        """Gather the woken rows (sentinel-clamped) and privately update them."""
        safe = torch.clamp(rows, max=self.n - 1)
        return self.apply_rows(Theta[safe], rows, valid, neigh, generator, state, draws)

    def apply_rows(self, theta_rows, rows, valid, neigh, generator, state, draws=None):
        """Batched Eq. 6 step with budget stopping. The (B, p) standard
        draws come from ``generator`` in the rows' dtype, or are ``draws``."""
        dt = theta_rows.dtype
        safe, applied = self._budget(rows, valid, state)
        z = self._draws(neigh.shape, generator, neigh.device, dt, draws)
        noise = z * self._scales(neigh.device, dt)[safe][:, None]
        new_rows = eq4_theta_rows(self.obj, theta_rows, rows, neigh, grad_noise=noise)
        state.index_add_(0, safe, applied.to(state.dtype))
        return new_rows, applied, state

    @property
    def fused_supported(self) -> bool:
        """The fused kernel implements the quadratic point grad only."""
        return self.obj.loss.name == "quadratic"

    def apply_fused(self, Theta_slab, rows, valid, generator, state, cols, w, draws=None):
        """Fused-kernel Eq. 6 step over the (n, p) float32 slab, in place.

        The budget stopping and noise of :meth:`apply_rows` with the row
        math in one kernel call: budget-exhausted agents become kernel
        sentinels (``krows = n``), so their row stays as it was. The draws
        are always float32, and take the same calls from ``generator`` as
        :meth:`apply_rows` in a float32 engine, so the two routes see the
        same noise.
        """
        if not self.fused_supported:
            raise _fused_unsupported(self.obj)
        dev = Theta_slab.device
        safe, applied = self._budget(rows, valid, state)
        f32 = torch.float32
        z = self._draws((rows.shape[0], Theta_slab.shape[1]), generator, dev, f32, draws)
        noise = z * self._scales(dev, f32)[safe][:, None]
        krows, consts = fused_rows(self.obj, rows, applied, dev)
        new_slab = _eq4_fused_slab(self.obj, Theta_slab, krows, cols, w, consts, noise, self.n)
        state.index_add_(0, safe, applied.to(state.dtype))
        return new_slab, applied, state

    def eps_spent(self, state) -> np.ndarray:
        """(n,) composed per-agent spend for the applied-update counts."""
        return privacy.compose_uniform(self.eps_step, _host(state), self.cfg.delta_bar)

    def budget_stopped(self, state) -> int:
        """Agents whose planned per-agent update budget T_i is exhausted."""
        return int((_host(state) >= self.planned_Ti).sum())

    def objective(self, Theta) -> float:
        """Q(Theta) of Eq. 2 (used by ``record_every``)."""
        return float(self.obj.value(Theta))


def _host(a) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    if isinstance(a, torch.Tensor):
        return a.to("cpu", copy=True).numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True, eq=False)
class PropagationUpdate:
    """Eq. 16 model propagation (Supp. C) as an engine update rule."""

    graph: object
    theta_loc: np.ndarray
    mu: float
    confidences: np.ndarray
    mix_mode: str = "auto"

    @cached_property
    def mix(self) -> MixOp:
        """The neighbour-sum operator over :attr:`graph` (built lazily)."""
        return mix_op(self.graph, mode=self.mix_mode)

    @property
    def n(self) -> int:
        """Number of agents."""
        return self.graph.n

    @property
    def p(self) -> int:
        """Model dimension per agent."""
        return self.theta_loc.shape[1]

    def init_state(self):
        """Stateless: the empty tuple."""
        return ()

    def tensors(self, device, dtype) -> dict:
        """Degrees, confidences and local models on ``device`` in ``dtype``,
        made once and kept."""
        cache = self.__dict__.setdefault("_tensor_cache", {})
        key = (torch.device(device), dtype)
        if key not in cache:
            host = {"deg": self.graph.degrees, "conf": self.confidences, "loc": self.theta_loc}
            cache[key] = {
                k: torch.as_tensor(np.asarray(v)).to(device=key[0], dtype=dtype)
                for k, v in host.items()
            }
        return cache[key]

    def apply(self, Theta, rows, valid, neigh, generator, state):
        """Update the woken rows (Eq. 16 reads no row of Theta)."""
        return self.apply_rows(None, rows, valid, neigh, generator, state)

    def apply_rows(self, theta_rows, rows, valid, neigh, generator, state):
        """Batched Eq. 16 exact block minimizer; ``theta_rows`` is unused —
        the update reads only the neighbour sum and the local models."""
        t = self.tensors(neigh.device, neigh.dtype)
        safe = torch.clamp(rows, max=self.n - 1)
        new_rows = propagation_rows_from(self.mu, t["deg"][safe], t["conf"][safe],
                                         t["loc"][safe], neigh)
        return new_rows, valid, state

    def objective(self, Theta) -> float:
        """Q_MP of Eq. 15 (used by ``record_every``)."""
        value, _ = propagation_objective(
            self.graph, np.asarray(self.theta_loc), self.mu, np.asarray(self.confidences)
        )
        return float(value(_host(Theta)))

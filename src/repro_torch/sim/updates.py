"""The ``LocalUpdate`` protocol and the Eq. 4 coordinate-descent update.

Port of ``repro.sim.updates`` for its non-private rule (:class:`CDUpdate`;
the private and propagation rules come with later slices). The engine
owns time, wake sampling, scenarios and the gather / mix / scatter
plumbing; what a woken agent does with its neighbour sum is the update's:
given the start-of-slot snapshot, the woken row indices (padded with the
sentinel n) and their raw neighbour sums, return replacement rows and an
``applied`` mask. The math is ``eq4_theta_rows`` of
:mod:`repro_torch.core.coordinate_descent`, shared with the sequential
loops.

:meth:`CDUpdate.apply_fused` is the one-launch path: the
``fused_row_update`` CUDA kernel gathers, mixes, updates and scatters the
woken rows into Theta in place.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from repro_torch.core.coordinate_descent import eq4_theta_rows
from repro_torch.core.mixing import MixOp
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
        """The initial update state (per-agent leaves, leading dim n)."""
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
            raise NotImplementedError(
                f"fused path supports the quadratic loss only, got {self.obj.loss.name!r}"
            )
        krows, consts = self.fused_rows(rows, valid, Theta_slab.device)
        new_slab = _eq4_fused_slab(self.obj, Theta_slab, krows, cols, w, consts, None, self.n)
        return new_slab, valid, state

    def fused_rows(self, rows, valid, device):
        """The fused kernel's row inputs for a woken batch: ``krows`` (B,)
        int32, the woken ids with the sentinel n where ``valid`` is false,
        and the float32 Eq. 4 constants gathered at those rows."""
        safe = torch.clamp(rows, max=self.n - 1)
        t = self.obj.tensors(device, torch.float32)
        consts = {k: v[safe] for k, v in t.items()}
        krows = torch.where(valid, rows, self.n).to(torch.int32)
        return krows, consts

    def objective(self, Theta) -> float:
        """Q(Theta) of Eq. 2 (used by ``record_every``)."""
        return float(self.obj.value(Theta))

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

:class:`GraphUpdate` is the graph step of dynamic topology: the Dada edge
refresh the engines fire between super-ticks (host numpy, the
reference's CSR array for array).

All three reduce to the same contract: given the start-of-slot snapshot,
the woken row indices (padded with the sentinel n) and their raw neighbour
sums, return replacement rows and an ``applied`` mask. The math lives next
to its sequential twin (``eq4_theta_rows`` in ``coordinate_descent``,
``propagation_rows_from`` in ``model_propagation``).

``apply_fused`` (CD and DP, quadratic loss) is the one-launch path: the
``fused_row_update`` CUDA kernel gathers, mixes, updates and scatters the
woken rows into Theta in place; a budget-exhausted DP row is a kernel
sentinel.

For the sharded engine each update also exposes ``agent_constants`` —
the per-agent host arrays (datasets, theory constants, noise scales) its
row step reads. The engine tiles them along its agent blocks and hands
the row-gathered slice back as ``consts`` to ``apply_rows`` /
``apply_fused``, with the shard-local scatter rows ``srows`` and their
sentinel ``ssize``; ``consts=None`` keeps the single-device path as it
was. The private rules draw their noise from the engine's
``torch.Generator``, or take it as ``draws`` so a test can inject the
reference's ``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from functools import cached_property
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import privacy
from repro_torch.core.coordinate_descent import (
    eq4_agent_constants,
    eq4_theta_rows,
    eq4_theta_rows_from,
)
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


def fused_rows(obj, rows, valid, device, srows=None, ssize=None, consts=None):
    """The fused kernel's row inputs for a woken batch: ``krows`` (B,)
    int32, the slab rows ``srows`` (default ``rows``) with the sentinel
    ``ssize`` (default n) where ``valid`` is false (padding, or a
    budget-exhausted private row), and the Eq. 4 constants: ``consts``
    when given (the sharded engine's row-gathered tiles), else the
    float32 tensors gathered at ``rows``."""
    if srows is None:
        srows, ssize = rows, obj.n
    if consts is None:
        safe = torch.clamp(rows, max=obj.n - 1)
        t = obj.tensors(device, torch.float32)
        consts = {k: v[safe] for k, v in t.items()}
    krows = torch.where(valid, srows, ssize).to(torch.int32)
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

    def agent_constants(self):
        """Per-agent host arrays (leading dim n) the row step reads; the
        sharded engine tiles them into its agent blocks."""
        ...

    def apply(self, Theta, rows, valid, neigh, generator, state):
        """One batched update against the global (n, p) snapshot."""
        ...

    def apply_rows(self, theta_rows, rows, valid, neigh, generator, state, srows=None,
                   ssize=None, consts=None):
        """One batched update from pre-gathered rows. ``srows``/``ssize``:
        the rows of the update state to read and write and their sentinel
        (default ``rows``/n); ``consts``: the row-gathered
        :meth:`agent_constants` as tensors (default: gathered at ``rows``)."""
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

    def agent_constants(self):
        """The Eq. 4 constants and padded datasets (``eq4_agent_constants``)."""
        return eq4_agent_constants(self.obj)

    def apply(self, Theta, rows, valid, neigh, generator, state):
        """Gather the woken rows from the global snapshot and update them."""
        safe = torch.clamp(rows, max=self.n - 1)
        return self.apply_rows(Theta[safe], rows, valid, neigh, generator, state)

    def apply_rows(self, theta_rows, rows, valid, neigh, generator, state, srows=None,
                   ssize=None, consts=None):
        """Batched Eq. 4 step for the gathered rows; ``consts`` selects the
        sharded engine's row-gathered constants."""
        if consts is None:
            return eq4_theta_rows(self.obj, theta_rows, rows, neigh), valid, state
        return eq4_theta_rows_from(self.obj, theta_rows, neigh, consts), valid, state

    @property
    def fused_supported(self) -> bool:
        """The fused kernel implements the quadratic point grad only."""
        return self.obj.loss.name == "quadratic"

    def apply_fused(self, Theta_slab, rows, valid, generator, state, cols, w, srows=None,
                    ssize=None, consts=None):
        """Fused-kernel Eq. 4 step over a float32 slab, in place.

        ``rows``: (B,) woken agent ids (sentinel n); ``cols``/``w``: (B, K)
        int32 / float32 row-gathered neighbour tables over the slab;
        ``srows``/``ssize``: the slab rows to write and their sentinel,
        the kernel's ``limit`` (default ``rows``/n: the single-device
        slab is Theta); ``consts``: the sharded engine's row-gathered
        constants. Returns the updated slab (the same tensor), the applied
        mask and the state.
        """
        if not self.fused_supported:
            raise _fused_unsupported(self.obj)
        limit = self.n if srows is None else ssize
        krows, consts = fused_rows(self.obj, rows, valid, Theta_slab.device, srows, ssize,
                                   consts)
        new_slab = _eq4_fused_slab(self.obj, Theta_slab, krows, cols, w, consts, None, limit)
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

    def agent_constants(self):
        """The Eq. 4 constants and datasets, and the (n,) noise scales."""
        return {**eq4_agent_constants(self.obj), "scales": self.scales}

    def _scales(self, device, dtype):
        """The (n,) noise scales on ``device`` in ``dtype``, made once and kept."""
        cache = self.__dict__.setdefault("_scale_cache", {})
        key = (torch.device(device), dtype)
        if key not in cache:
            cache[key] = torch.as_tensor(self.scales).to(device=key[0], dtype=dtype)
        return cache[key]

    def _budget(self, rows, valid, state, srows=None, ssize=None):
        """The clamped state rows (``srows`` below ``ssize``, default
        ``rows`` below n) and the (B,) mask of woken rows with budget left."""
        if srows is None:
            srows, ssize = rows, self.n
        safe = torch.clamp(srows, max=ssize - 1)
        return safe, valid & (state[safe] < self.planned_Ti)

    def _row_scales(self, rows, device, dtype, consts):
        """(B,) noise scales: ``consts["scales"]``, or gathered at ``rows``."""
        if consts is not None:
            return consts["scales"].to(dtype)
        return self._scales(device, dtype)[torch.clamp(rows, max=self.n - 1)]

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

    def apply_rows(self, theta_rows, rows, valid, neigh, generator, state, draws=None,
                   srows=None, ssize=None, consts=None):
        """Batched Eq. 6 step with budget stopping. The (B, p) standard
        draws come from ``generator`` in the rows' dtype, or are ``draws``.
        ``srows``/``ssize``/``consts``: the sharded engine's state rows,
        their sentinel and row-gathered constants (noise scales included)."""
        dt = theta_rows.dtype
        safe, applied = self._budget(rows, valid, state, srows, ssize)
        z = self._draws(neigh.shape, generator, neigh.device, dt, draws)
        noise = z * self._row_scales(rows, neigh.device, dt, consts)[:, None]
        if consts is None:
            new_rows = eq4_theta_rows(self.obj, theta_rows, rows, neigh, grad_noise=noise)
        else:
            new_rows = eq4_theta_rows_from(self.obj, theta_rows, neigh, consts, grad_noise=noise)
        state.index_add_(0, safe, applied.to(state.dtype))
        return new_rows, applied, state

    @property
    def fused_supported(self) -> bool:
        """The fused kernel implements the quadratic point grad only."""
        return self.obj.loss.name == "quadratic"

    def apply_fused(self, Theta_slab, rows, valid, generator, state, cols, w, draws=None,
                    srows=None, ssize=None, consts=None):
        """Fused-kernel Eq. 6 step over a float32 slab, in place.

        The budget stopping and noise of :meth:`apply_rows` with the row
        math in one kernel call: budget-exhausted agents become kernel
        sentinels (``krows = ssize``, n by default), so their row stays as
        it was. The draws are always float32, and take the same calls from
        ``generator`` as :meth:`apply_rows` in a float32 engine, so the two
        routes see the same noise. ``srows``/``ssize``/``consts`` as in
        :meth:`CDUpdate.apply_fused` (the counts are read and written at
        ``srows``).
        """
        if not self.fused_supported:
            raise _fused_unsupported(self.obj)
        dev = Theta_slab.device
        safe, applied = self._budget(rows, valid, state, srows, ssize)
        f32 = torch.float32
        z = self._draws((rows.shape[0], Theta_slab.shape[1]), generator, dev, f32, draws)
        noise = z * self._row_scales(rows, dev, f32, consts)[:, None]
        limit = self.n if srows is None else ssize
        krows, consts = fused_rows(self.obj, rows, applied, dev, srows, ssize, consts)
        new_slab = _eq4_fused_slab(self.obj, Theta_slab, krows, cols, w, consts, noise, limit)
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

    def agent_constants(self):
        """Degrees, confidences and the (n, p) local models Eq. 16 reads."""
        return {"deg": self.graph.degrees, "conf": self.confidences, "loc": self.theta_loc}

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

    def apply_rows(self, theta_rows, rows, valid, neigh, generator, state, srows=None,
                   ssize=None, consts=None):
        """Batched Eq. 16 exact block minimizer; ``theta_rows`` is unused —
        the update reads only the neighbour sum and the local models
        (``consts``: the sharded engine's row-gathered ones)."""
        if consts is None:
            t = self.tensors(neigh.device, neigh.dtype)
            safe = torch.clamp(rows, max=self.n - 1)
            consts = {k: t[k][safe] for k in ("deg", "conf", "loc")}
        dt = neigh.dtype
        new_rows = propagation_rows_from(self.mu, consts["deg"].to(dt), consts["conf"].to(dt),
                                         consts["loc"].to(dt), neigh)
        return new_rows, valid, state

    def objective(self, Theta) -> float:
        """Q_MP of Eq. 15 (used by ``record_every``)."""
        value, _ = propagation_objective(
            self.graph, np.asarray(self.theta_loc), self.mu, np.asarray(self.confidences)
        )
        return float(value(_host(Theta)))


# Candidate pairs per block of GraphUpdate's distance pass: 2^16 pairs of
# p = 100 float64 rows make temporaries of 52 MB, where one pass over the
# ~10 M candidate pairs of a 500k-agent refresh would make three of 8 GB.
D2_BLOCK_PAIRS = 1 << 16


def pair_sq_dists(Theta, rows, cols, block: int = D2_BLOCK_PAIRS) -> np.ndarray:
    """``((Theta[rows] - Theta[cols]) ** 2).sum(axis=1)`` in blocks of
    ``block`` pairs, the blocks spread over host threads (numpy's gathers
    and reductions release the GIL). Each pair's row sum is the same numpy
    reduction over its own p values whatever else its block holds, and
    each block writes its own slice, so the result has the one-pass
    expression's bits."""
    out = np.empty(len(rows), dtype=np.float64)

    def run(lo):
        hi = min(lo + block, len(rows))
        out[lo:hi] = ((Theta[rows[lo:hi]] - Theta[cols[lo:hi]]) ** 2).sum(axis=1)

    starts = range(0, len(rows), block)
    with ThreadPoolExecutor(max_workers=max(1, min(len(starts), os.cpu_count() or 1))) as pool:
        list(pool.map(run, starts))
    return out


@dataclasses.dataclass(frozen=True)
class GraphUpdate:
    """Dada-style sparse similarity-driven edge refresh (arXiv 1901.08460).

    Port of ``repro.sim.updates.GraphUpdate``: the host-side graph step
    the engines fire every ``every`` slots, at slot boundaries (the
    super-ticks in between run on the frozen topology):

    1. **Candidates** — every current edge plus ``candidates`` random
       never-self peers per node;
    2. **Similarity** — ``w_ij = exp(-||Theta_i - Theta_j||^2 / gamma)``
       over candidate pairs only;
    3. **Selection** — per row keep the top-``k`` by similarity, always
       retaining the single best (every degree stays >= 1: Eq. 4 divides
       by D_ii) and dropping the rest below ``threshold``; then
       OR-symmetrize, like the k-NN constructors.

    Numpy throughout and deterministic in ``(seed, round_index)``: the
    same graph and models give the reference's CSR, array for array
    (the distances are taken in blocks, :func:`pair_sq_dists`, with the
    same bits).
    """

    every: int = 10
    k: int = 10
    candidates: int = 8
    gamma: float = 1.0
    threshold: float = 1e-4
    seed: int = 0

    def __post_init__(self):
        if self.every < 1:
            raise ValueError("every must be >= 1 slots")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.candidates < 0:
            raise ValueError("candidates must be >= 0")
        if self.gamma <= 0.0:
            raise ValueError("gamma must be > 0")

    def refresh(self, csr, Theta, round_index: int = 0, allowed=None):
        """One edge-update round: (current graph, models) -> new graph.

        ``csr``: the live :class:`repro_torch.core.graph.CSRGraph`;
        ``Theta``: (n, p) current models (numpy or a tensor, taken to the
        host in float64); ``round_index`` seeds the candidate draw.
        ``allowed``: optional (n,) bool mask — only edges between allowed
        agents are re-selected; edges touching a non-allowed agent pass
        through frozen at their weight (how the engines keep
        not-yet-arrived agents detached).
        """
        from repro_torch.core.graph import csr_from_coo

        Theta = np.asarray(_host(Theta), dtype=np.float64)
        n = csr.n
        rows = csr.row_ids().astype(np.int64)
        cols = csr.indices.astype(np.int64)
        if allowed is not None:
            allowed = np.asarray(allowed, dtype=bool)
            live = allowed[rows] & allowed[cols]
            frozen = (rows[~live], cols[~live], np.asarray(csr.data, np.float64)[~live])
            rows, cols = rows[live], cols[live]
        else:
            frozen = None
        if self.candidates > 0 and n > 1:
            rng = np.random.default_rng((self.seed, round_index))
            c = min(self.candidates, n - 1)
            # i + U{1, .., n-1} mod n is never i — no self candidates.
            rand = (np.arange(n, dtype=np.int64)[:, None] + rng.integers(1, n, size=(n, c))) % n
            crows = np.repeat(np.arange(n, dtype=np.int64), c)
            ccols = rand.ravel()
            if allowed is not None:
                # Draw for every row (stable rng stream), then filter.
                mask = allowed[crows] & allowed[ccols]
                crows, ccols = crows[mask], ccols[mask]
            rows = np.concatenate([rows, crows])
            cols = np.concatenate([cols, ccols])
        # Dedupe directed candidate pairs.
        key = rows * n + cols
        _, uniq = np.unique(key, return_index=True)
        rows, cols = rows[uniq], cols[uniq]
        vals = np.exp(-pair_sq_dists(Theta, rows, cols) / self.gamma)
        # Per-row top-k: rank candidates within each row by -similarity.
        order = np.lexsort((-vals, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        first = np.concatenate([[True], rows[1:] != rows[:-1]])
        start = np.maximum.accumulate(np.where(first, np.arange(len(rows)), 0))
        rank = np.arange(len(rows)) - start
        # The row's best candidate always survives (D_ii > 0 for Eq. 4);
        # beyond it, keep top-k entries above the negligibility floor.
        keep = (rank == 0) | ((rank < self.k) & (vals >= self.threshold))
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        if frozen is not None:
            rows = np.concatenate([rows, frozen[0]])
            cols = np.concatenate([cols, frozen[1]])
            vals = np.concatenate([vals, frozen[2]])
        return csr_from_coo(n, rows, cols, vals, symmetrize=True, dedupe="max")

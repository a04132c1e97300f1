"""The paper's objective (Eq. 2) and its block structure (Eq. 3), on tensors.

``Q(Theta) = 1/2 sum_{i<j} W_ij ||Theta_i - Theta_j||^2
           + mu * sum_i D_ii c_i L_i(Theta_i; S_i)``

with ``L_i(theta) = (1/m_i) sum_k loss(theta; x_k, y_k) + lambda_i ||theta||^2``.

Port of ``repro.core.objective``. The problem is specified on the host,
in numpy (graph, padded per-agent datasets ``X: (n, m_max, p)``,
``y``/``mask: (n, m_max)``, theory constants); the methods take a stacked
``Theta`` tensor of shape ``(n, p)`` and run on its device and in its
dtype. The per-agent arrays are moved to a device once per
``(device, dtype)`` and kept (:meth:`Objective.tensors`).

Theory constants, as in the reference:

* block Lipschitz constants ``L_i = D_ii (1 + mu c_i L_i^loc)`` (Sec. 2.2),
* the strong-convexity lower bound ``sigma >= mu min_i D_ii c_i sigma_i^loc``,
* the contraction factor ``C = 1 - sigma / (n L_max)`` of Prop. 1 / Prop. 2.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from repro_torch.core.graph import AgentGraph, CSRGraph
from repro_torch.core.graph import confidences as _confidences
from repro_torch.core.mixing import mix_op
from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Loss zoo
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Loss:
    """A pointwise convex loss ell(theta; x, y) with the constants the theory needs.

    ``point_loss(theta, X, y)`` and ``point_grad(theta, X, y)`` are batched:
    theta ``(..., p)``, X ``(..., m, p)``, y ``(..., m)`` give the per-point
    losses ``(..., m)`` and gradients ``(..., m, p)``; the gradients are
    written out, as in the reference. ``lipschitz_l1(X, mask)``: L0 with
    ||grad ell||_1 <= L0 over X (Thm. 1). ``smoothness(X, mask)``: a bound
    on the pointwise Hessian's top eigenvalue over X (for L_i^loc).
    """

    name: str
    point_loss: callable
    point_grad: callable
    lipschitz_l1: callable
    smoothness: callable


def _dots(theta, X):
    return torch.einsum("...mp,...p->...m", X, theta)


def _logistic_point_loss(theta, X, y):
    margin = y * _dots(theta, X)
    # log(1 + exp(-m)) computed stably.
    return torch.logaddexp(torch.zeros_like(margin), -margin)


def _logistic_point_grad(theta, X, y):
    margin = y * _dots(theta, X)
    return (-y * torch.sigmoid(-margin))[..., None] * X


def _logistic_lip_l1(X, mask):
    # ||grad||_1 = sigmoid(.) * ||x||_1 <= max ||x||_1 (data-dependent bound).
    norms = np.abs(np.asarray(X)).sum(axis=-1) * np.asarray(mask)
    return float(norms.max())


def _logistic_smoothness(X, mask):
    # Hessian = sigmoid'(m) x x^T with sigmoid' <= 1/4.
    sq = (np.asarray(X) ** 2).sum(axis=-1) * np.asarray(mask)
    return float(0.25 * sq.max())


def _quadratic_point_loss(theta, X, y):
    return torch.square(_dots(theta, X) - y)


def _quadratic_point_grad(theta, X, y):
    return (2.0 * (_dots(theta, X) - y))[..., None] * X


def _quadratic_lip_l1(X, mask):
    # Unbounded in general; callers should clip (paper Supp. D.2, C = 10).
    return float("inf")


def _quadratic_smoothness(X, mask):
    sq = (np.asarray(X) ** 2).sum(axis=-1) * np.asarray(mask)
    return float(2.0 * sq.max())


LOGISTIC = Loss(
    "logistic",
    _logistic_point_loss,
    _logistic_point_grad,
    _logistic_lip_l1,
    _logistic_smoothness,
)
QUADRATIC = Loss(
    "quadratic",
    _quadratic_point_loss,
    _quadratic_point_grad,
    _quadratic_lip_l1,
    _quadratic_smoothness,
)

LOSSES = {"logistic": LOGISTIC, "quadratic": QUADRATIC}


# ---------------------------------------------------------------------------
# Per-agent datasets (padded)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class AgentData:
    """Padded per-agent datasets (numpy, host side).

    X: (n, m_max, p), y: (n, m_max), mask: (n, m_max) in {0,1}.
    """

    X: np.ndarray
    y: np.ndarray
    mask: np.ndarray

    @property
    def n(self) -> int:
        return self.X.shape[0]

    @property
    def p(self) -> int:
        return self.X.shape[2]

    @property
    def num_examples(self) -> np.ndarray:
        return self.mask.sum(axis=1)


# ---------------------------------------------------------------------------
# The objective
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Objective:
    """Q(Theta) of Eq. 2, fully specified. Construct via :func:`make_objective`."""

    graph: AgentGraph | CSRGraph
    data: AgentData
    loss: Loss
    mu: float
    lambdas: np.ndarray  # (n,) L2 regularization per agent
    confidences: np.ndarray  # (n,) c_i in (0, 1]
    clip: float | None = None  # per-point gradient clip (Supp. D.2); None = off
    mix_mode: str = "auto"  # neighbour-sum path: "auto" | "dense" | "sparse"

    @cached_property
    def mix(self):
        """The neighbour-sum operator sum_j W_ij Theta_j (dense or sparse)."""
        return mix_op(self.graph, mode=self.mix_mode)

    # --- constants -------------------------------------------------------
    @property
    def n(self) -> int:
        return self.graph.n

    @property
    def p(self) -> int:
        return self.data.p

    @property
    def degrees(self) -> np.ndarray:
        return self.graph.degrees

    def local_smoothness(self) -> np.ndarray:
        """L_i^loc per agent: smoothness of L_i = emp. loss + lambda_i ||.||^2."""
        base = self.loss.smoothness(self.data.X, self.data.mask)
        return base + 2.0 * self.lambdas

    def local_strong_convexity(self) -> np.ndarray:
        """sigma_i^loc >= 2 lambda_i (L2 regularizer)."""
        return 2.0 * self.lambdas

    def block_lipschitz(self) -> np.ndarray:
        """L_i = D_ii (1 + mu c_i L_i^loc)."""
        return self.degrees * (1.0 + self.mu * self.confidences * self.local_smoothness())

    def strong_convexity(self) -> float:
        """sigma >= mu min_i [D_ii c_i sigma_i^loc]."""
        return float(
            self.mu
            * np.min(self.degrees * self.confidences * self.local_strong_convexity())
        )

    def contraction(self) -> float:
        """C = 1 - sigma / (n L_max) of Prop. 1."""
        return 1.0 - self.strong_convexity() / (self.n * float(self.block_lipschitz().max()))

    def alphas(self) -> np.ndarray:
        """alpha_i = 1 / (1 + mu c_i L_i^loc) — the Eq. 4 mixing coefficient."""
        return 1.0 / (1.0 + self.mu * self.confidences * self.local_smoothness())

    def lipschitz_l1(self) -> float:
        """L0 for Thm. 1 (possibly clipped per Supp. D.2)."""
        l0 = self.loss.lipschitz_l1(self.data.X, self.data.mask)
        if self.clip is not None:
            return min(l0, float(self.clip))
        return l0

    # --- device copies -----------------------------------------------------
    def tensors(self, device, dtype) -> dict:
        """The per-agent arrays on ``device`` in ``dtype``, made once and kept.

        Keys follow ``eq4_agent_constants``: ``deg``/``conf``/``alpha``/
        ``lam`` (n,) and the padded data ``X`` (n, m, p), ``y``/``mask``
        (n, m).
        """
        cache = self.__dict__.setdefault("_tensor_cache", {})
        key = (resolve_device(device), dtype)
        if key not in cache:
            host = {
                "deg": self.degrees,
                "conf": self.confidences,
                "alpha": self.alphas(),
                "lam": self.lambdas,
                "X": self.data.X,
                "y": self.data.y,
                "mask": self.data.mask,
            }
            cache[key] = {
                k: torch.as_tensor(np.asarray(v)).to(device=key[0], dtype=dtype)
                for k, v in host.items()
            }
        return cache[key]

    # --- values and gradients ----------------------------------------------
    def _point_grads(self, theta, X, y):
        """Per-point gradients (..., m, p), L1-clipped to ``clip`` if set."""
        g = self.loss.point_grad(theta, X, y)
        if self.clip is not None:
            # L1-norm clipping to C, matching the Laplace/L1 sensitivity story.
            norms = torch.sum(torch.abs(g), dim=-1, keepdim=True)
            g = g * torch.clamp(self.clip / norms.clamp(min=1e-12), max=1.0)
        return g

    def local_loss(self, Theta):
        """L_i(Theta_i; S_i) for all agents: (n,) vector."""
        t = self.tensors(Theta.device, Theta.dtype)
        mask = t["mask"]
        m = mask.sum(dim=1).clamp(min=1.0)
        vals = self.loss.point_loss(Theta, t["X"], t["y"])
        return torch.sum(vals * mask, dim=1) / m + t["lam"] * torch.sum(Theta**2, dim=1)

    def local_grad(self, Theta):
        """grad L_i(Theta_i; S_i) for all agents: (n, p)."""
        t = self.tensors(Theta.device, Theta.dtype)
        mask = t["mask"]
        m = mask.sum(dim=1).clamp(min=1.0)
        g = self._point_grads(Theta, t["X"], t["y"])
        return torch.sum(g * mask[..., None], dim=1) / m[:, None] + 2.0 * t["lam"][:, None] * Theta

    def value(self, Theta):
        """Q(Theta) as a 0-d tensor."""
        t = self.tensors(Theta.device, Theta.dtype)
        smooth = self.mix.pairwise_smoothness(Theta)
        return smooth + self.mu * torch.sum(t["deg"] * t["conf"] * self.local_loss(Theta))

    def block_grad(self, Theta):
        """[grad Q]_i for all i (Eq. 3), stacked into (n, p)."""
        t = self.tensors(Theta.device, Theta.dtype)
        d, c = t["deg"], t["conf"]
        neigh = self.mix.all(Theta)  # (n, p): sum_j W_ij Theta_j
        return d[:, None] * (Theta + self.mu * c[:, None] * self.local_grad(Theta)) - neigh

    def solve_exact(self) -> np.ndarray:
        """Closed-form minimizer when the loss is quadratic-in-theta (numpy).

        Only valid for QUADRATIC loss; used by tests to verify convergence
        to the true optimum.
        """
        if self.loss.name != "quadratic":
            raise ValueError("closed form only available for quadratic loss")
        n, p = self.n, self.p
        d = self.degrees
        c = self.confidences
        X, y, mask = self.data.X, self.data.y, self.data.mask
        m = np.maximum(mask.sum(axis=1), 1.0)
        A = np.zeros((n * p, n * p))
        b = np.zeros(n * p)
        for i in range(n):
            sl = slice(i * p, (i + 1) * p)
            Xi = X[i] * mask[i][:, None]
            H = 2.0 * Xi.T @ Xi / m[i] + 2.0 * self.lambdas[i] * np.eye(p)
            g0 = -2.0 * Xi.T @ (y[i] * mask[i]) / m[i]
            A[sl, sl] += d[i] * np.eye(p) + self.mu * d[i] * c[i] * H
            b[sl] += -self.mu * d[i] * c[i] * g0
            for j, wij in zip(*self.graph.row(i)):
                A[sl, j * p : (j + 1) * p] += -wij * np.eye(p)
        sol = np.linalg.solve(A, b)
        return sol.reshape(n, p)


def make_objective(
    graph: AgentGraph | CSRGraph,
    data: AgentData,
    loss: Loss | str,
    mu: float,
    lambdas=None,
    confidences=None,
    clip: float | None = None,
    mix_mode: str = "auto",
) -> Objective:
    if isinstance(loss, str):
        loss = LOSSES[loss]
    m = data.num_examples
    if lambdas is None:
        # Paper Sec. 5: lambda_i = 1 / m_i ensures overall strong convexity.
        lambdas = 1.0 / np.maximum(m, 1.0)
    if confidences is None:
        confidences = _confidences(m)
    return Objective(
        graph=graph,
        data=data,
        loss=loss,
        mu=float(mu),
        lambdas=np.asarray(lambdas, dtype=np.float64),
        confidences=np.asarray(confidences, dtype=np.float64),
        clip=clip,
        mix_mode=mix_mode,
    )

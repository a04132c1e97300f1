"""Model propagation (Supp. C) and the private warm start.

Port of ``repro.core.model_propagation``. With
L_i(Theta_i) = 1/2 ||Theta_i - Theta_i^loc||^2, the Eq. 4 update becomes
the *exact* block minimizer (Eq. 16):

    Theta_i <- ( sum_j (W_ij/D_ii) Theta_j + mu c_i Theta_i^loc ) / (1 + mu c_i)

which recovers Vanhaesebrouck et al. (2017)'s model propagation. Since the
data only enters through Theta_i^loc, a DP version of Theta_i^loc makes the
whole propagation private at no per-iteration cost — this is the paper's
private warm start (Remark 3).

DP local models use output perturbation (Chaudhuri et al., 2011): L_i is
(2 lambda_i)-strongly convex and swapping one data point moves its gradient
by at most 2 L0 / m_i, so the minimizer moves by at most
(2 L0 / m_i) / (2 lambda_i) = L0 / (lambda_i m_i); Laplace noise with scale
L0 / (lambda_i m_i eps) gives (eps, 0)-DP.

The sequential propagation, the objective and the output perturbation are
host-side numpy, copied from the reference (the same ``rng`` gives the same
arrays). The batched row step runs on tensors, and the local models are
trained on ``device`` with the gradient written out (the reference takes
``jax.grad`` of the same loss).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import AgentGraph, CSRGraph, dense_weights
from repro_torch.core.objective import AgentData, Objective
from repro_torch.device import resolve_device


def propagation_objective(
    graph: AgentGraph | CSRGraph, theta_loc: np.ndarray, mu: float, confidences: np.ndarray
):
    """Q_MP of Eq. 15 as closures (value, exact solve), on numpy."""
    rows, cols, vals = graph.edge_list()
    d = graph.degrees
    n, p = theta_loc.shape

    def value(Theta):
        d2 = np.sum((Theta[rows] - Theta[cols]) ** 2, axis=-1)
        smooth = 0.5 * np.sum(vals * d2)
        local = 0.5 * mu * np.sum(d * confidences * np.sum((Theta - theta_loc) ** 2, axis=-1))
        return smooth + local

    def solve():
        # (diag(D)(I + mu C) - W) Theta = mu diag(D) C theta_loc, per dimension.
        A = np.diag(d * (1.0 + mu * confidences)) - dense_weights(graph)
        B = mu * (d * confidences)[:, None] * theta_loc
        return np.linalg.solve(A, B)

    return value, solve


def propagation_update(graph: AgentGraph | CSRGraph, Theta, theta_loc, mu, confidences, i):
    """Eq. 16 for one agent (exact block minimizer), on numpy."""
    cols, w = graph.row(i)
    neigh = w @ Theta[cols] / graph.degrees[i]
    return (neigh + mu * confidences[i] * theta_loc[i]) / (1.0 + mu * confidences[i])


def propagation_rows_from(mu, d, c, loc, neigh):
    """Batched Eq. 16 from pre-gathered per-agent constants.

    ``d``/``c``: (B,) degrees and confidences, ``loc``: (B, p) local
    models, ``neigh``: (B, p) raw neighbour sums — all row-aligned. The
    constants may be numpy or tensors; they are taken on ``neigh``'s
    device and in its dtype.
    """
    dt, dev = neigh.dtype, neigh.device
    d = torch.as_tensor(d, dtype=dt, device=dev)
    c = torch.as_tensor(c, dtype=dt, device=dev)
    loc = torch.as_tensor(loc, dtype=dt, device=dev)
    return (neigh / d[:, None] + mu * c[:, None] * loc) / (1.0 + mu * c[:, None])


def propagation_rows(degrees, theta_loc, mu, confidences, rows, neigh):
    """Batched Eq. 16 for a gathered row set.

    ``rows``: (B,) agent indices (the padding sentinel n is clamped to
    n-1 for the gather; callers drop those rows); ``neigh``: (B, p) raw
    neighbour sums ``sum_j W_ij Theta_j``. The exact block minimizer needs
    no gradient, so this is the whole update — the engine drives it
    through the same gather / mix / scatter path as Eq. 4.
    """
    dt, dev = neigh.dtype, neigh.device
    deg = torch.as_tensor(degrees, dtype=dt, device=dev)
    safe = torch.clamp(rows.long(), max=deg.shape[0] - 1)
    return propagation_rows_from(
        mu,
        deg[safe],
        torch.as_tensor(confidences, dtype=dt, device=dev)[safe],
        torch.as_tensor(theta_loc, dtype=dt, device=dev)[safe],
        neigh,
    )


def run_propagation(
    graph: AgentGraph,
    theta_loc: np.ndarray,
    mu: float,
    confidences: np.ndarray,
    T: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Asynchronous model propagation; returns final Theta."""
    n = graph.n
    Theta = theta_loc.copy()
    for t in range(T):
        i = int(rng.integers(n))
        Theta[i] = propagation_update(graph, Theta, theta_loc, mu, confidences, i)
    return Theta


def train_local_models(
    data: AgentData, loss, lambdas, steps: int = 300, lr: float = 0.5, device="cuda"
) -> np.ndarray:
    """Theta_i^loc per Eq. 1 by full-batch gradient descent, in float32 on
    ``device``: ``steps`` steps of ``Theta -= lr * grad L_i(Theta_i)`` from
    zero, with ``grad L_i = (1/m_i) sum_k mask_k grad ell(Theta_i; x_k, y_k)
    + 2 lambda_i Theta_i`` (the loss's written-out point gradient, no clip)."""
    dev = resolve_device(device)
    f32 = torch.float32

    def t(a):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=f32)

    X, y, mask, lam = t(data.X), t(data.y), t(data.mask), t(lambdas)
    n, _, p = data.X.shape
    m = mask.sum(dim=1).clamp(min=1.0)[:, None]
    Theta = torch.zeros((n, p), dtype=f32, device=dev)
    for _ in range(steps):
        g = torch.sum(loss.point_grad(Theta, X, y) * mask[..., None], dim=1) / m
        Theta = Theta - lr * (g + 2.0 * lam[:, None] * Theta)
    return Theta.cpu().numpy()


def private_local_models(
    theta_loc: np.ndarray,
    l0: float,
    lambdas: np.ndarray,
    num_examples: np.ndarray,
    eps: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Output perturbation: Theta~_i^loc = Theta_i^loc + Lap(0, L0/(lam_i m_i eps))^p."""
    n, p = theta_loc.shape
    m = np.maximum(num_examples, 1.0)
    scales = l0 / (lambdas * m * eps)
    noise = rng.laplace(0.0, 1.0, size=(n, p)) * scales[:, None]
    return theta_loc + noise


def private_warm_start(
    obj: Objective,
    eps_warm: float,
    rng: np.random.Generator,
    propagation_ticks: int | None = None,
    device="cuda",
) -> np.ndarray:
    """Remark 3 / Supp. C: DP local models + (data-free) model propagation.
    The local models train on ``device``; the rest runs on the host."""
    theta_loc = train_local_models(obj.data, obj.loss, obj.lambdas, device=device)
    l0 = obj.lipschitz_l1()
    theta_priv = private_local_models(
        theta_loc, l0, obj.lambdas, obj.data.num_examples, eps_warm, rng
    )
    T = propagation_ticks if propagation_ticks is not None else 10 * obj.n
    return run_propagation(obj.graph, theta_priv, obj.mu, obj.confidences, T, rng)

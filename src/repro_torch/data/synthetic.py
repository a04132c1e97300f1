"""Synthetic tasks matching the paper's experimental setups.

``linear_classification_problem`` reproduces Sec. 5.1 exactly:
* n agents, each with a hidden target linear separator in R^p;
* W_ij = exp((cos(phi_ij) - 1) / gamma), gamma = 0.1, small weights dropped;
* m_i ~ U{10..100} training points per agent, drawn uniformly around the
  origin, labeled by the target model, labels flipped w.p. 0.05;
* a held-out test set of 100 points per agent;
* lambda_i = 1 / m_i.

Target models are sampled as in Vanhaesebrouck et al. (2017): two random
orthogonal base vectors; each agent's target is a random convex-ish
combination, giving a 1-D spectrum of relatedness.

Port of ``repro.data.synthetic`` (numpy, host side; the same seed gives
the same arrays as the reference).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import AgentGraph, angular_similarity_graph
from repro_torch.core.objective import AgentData


@dataclasses.dataclass
class LinearProblem:
    graph: AgentGraph
    train: AgentData
    test: AgentData
    targets: np.ndarray  # (n, p) hidden target separators


def _sample_targets(n: int, p: int, rng: np.random.Generator) -> np.ndarray:
    u = rng.normal(size=p)
    u /= np.linalg.norm(u)
    v = rng.normal(size=p)
    v -= (v @ u) * u
    v /= np.linalg.norm(v)
    angles = rng.uniform(0.0, np.pi / 2.0, size=n)
    return np.cos(angles)[:, None] * u[None, :] + np.sin(angles)[:, None] * v[None, :]


def _label(points: np.ndarray, target: np.ndarray, noise: float, rng) -> np.ndarray:
    y = np.sign(points @ target)
    y[y == 0] = 1.0
    flips = rng.random(len(y)) < noise
    return np.where(flips, -y, y)


def linear_classification_problem(
    n: int = 100,
    p: int = 100,
    m_low: int = 10,
    m_high: int = 100,
    test_points: int = 100,
    label_noise: float = 0.05,
    gamma: float = 0.1,
    feature_scale: float = 1.0,
    seed: int = 0,
) -> LinearProblem:
    rng = np.random.default_rng(seed)
    targets = _sample_targets(n, p, rng)
    graph = angular_similarity_graph(targets, gamma=gamma)

    ms = rng.integers(m_low, m_high + 1, size=n)
    m_max = int(ms.max())
    X = np.zeros((n, m_max, p))
    y = np.zeros((n, m_max))
    mask = np.zeros((n, m_max))
    Xt = np.zeros((n, test_points, p))
    yt = np.zeros((n, test_points))
    for i in range(n):
        m = int(ms[i])
        # "drawn uniformly around the origin": uniform in [-s, s]^p, normalized
        # to keep the logistic loss 1-Lipschitz as in the paper.
        pts = rng.uniform(-feature_scale, feature_scale, size=(m, p))
        pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-12)
        X[i, :m] = pts
        y[i, :m] = _label(pts, targets[i], label_noise, rng)
        mask[i, :m] = 1.0
        tp = rng.uniform(-feature_scale, feature_scale, size=(test_points, p))
        tp /= np.maximum(np.linalg.norm(tp, axis=1, keepdims=True), 1e-12)
        Xt[i] = tp
        yt[i] = _label(tp, targets[i], 0.0, rng)

    return LinearProblem(
        graph=graph,
        train=AgentData(X=X, y=y, mask=mask),
        test=AgentData(X=Xt, y=yt, mask=np.ones((n, test_points))),
        targets=targets,
    )


def eval_accuracy(Theta: np.ndarray, test: AgentData) -> np.ndarray:
    """Per-agent accuracy of sign(theta_i^T x) on the test set."""
    scores = np.einsum("nmp,np->nm", test.X, Theta)
    pred = np.sign(scores)
    pred[pred == 0] = 1.0
    correct = (pred == test.y) * test.mask
    return correct.sum(axis=1) / np.maximum(test.mask.sum(axis=1), 1.0)


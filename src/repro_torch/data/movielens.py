"""A statistically matched synthetic twin of MovieLens-100K (Sec. 5.2).

Port of ``repro.data.movielens``: numpy only, copied, so the same
arguments give the same arrays as the reference. MovieLens-100K itself is
not downloaded; the twin is generated with the same published statistics
and generative structure:

* 943 users, 1682 items, ~100k ratings in {1..5};
* per-user rating counts with mean ~106, std ~100, min 20, max 737 — we draw
  counts from a truncated log-normal fitted to those moments;
* ratings follow a low-rank user/item factor model (rank 20) plus user bias,
  item bias and Gaussian noise, quantized to the 1..5 star scale — the
  standard generative assumption underlying the ALS features the paper uses;
* item features phi_j in R^20 are recovered from the *training* ratings via
  alternating least squares (Zhou et al., 2008), exactly as the paper does.

The experiment protocol then matches Sec. 5.2: 80/20 per-user train/test
split, user-mean normalization, 10-NN cosine graph on training ratings,
quadratic loss with gradient clipping C = 10, lambda_i = 1/m_i, mu = 0.04.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import AgentGraph, knn_cosine_graph
from repro_torch.core.objective import AgentData


@dataclasses.dataclass
class MovieLensTwin:
    train: AgentData  # X = item features of rated movies, y = normalized rating
    test: AgentData
    graph: AgentGraph
    item_features: np.ndarray  # (n_items, p) ALS features
    user_means: np.ndarray  # (n_users,)


def _sample_counts(n_users: int, rng: np.random.Generator) -> np.ndarray:
    """Truncated log-normal matched to MovieLens-100K count stats."""
    # mean 106, std 100, min 20, max 737 -> lognormal(mu=4.35, sigma=0.8), clipped.
    c = rng.lognormal(mean=4.35, sigma=0.8, size=n_users)
    c = np.clip(c, 20, 737)
    return c.astype(int)


def _als(ratings: list[dict[int, float]], n_items: int, p: int, iters: int, reg: float, rng):
    """Alternating least squares on the sparse training ratings."""
    n_users = len(ratings)
    U = 0.1 * rng.normal(size=(n_users, p))
    V = 0.1 * rng.normal(size=(n_items, p))
    by_item: list[list[tuple[int, float]]] = [[] for _ in range(n_items)]
    for u, rd in enumerate(ratings):
        for j, r in rd.items():
            by_item[j].append((u, r))
    eye = reg * np.eye(p)
    for _ in range(iters):
        for u, rd in enumerate(ratings):
            if not rd:
                continue
            idx = np.fromiter(rd.keys(), int)
            r = np.fromiter(rd.values(), float)
            Vj = V[idx]
            U[u] = np.linalg.solve(Vj.T @ Vj + len(idx) * eye, Vj.T @ r)
        for j, lst in enumerate(by_item):
            if not lst:
                continue
            idx = np.array([u for u, _ in lst])
            r = np.array([x for _, x in lst])
            Uu = U[idx]
            V[j] = np.linalg.solve(Uu.T @ Uu + len(lst) * eye, Uu.T @ r)
    return U, V


def movielens_twin(
    n_users: int = 943,
    n_items: int = 1682,
    p: int = 20,
    rank: int = 20,
    noise: float = 1.2,
    train_frac: float = 0.8,
    als_iters: int = 6,
    seed: int = 0,
    n_clusters: int = 25,
    cluster_spread: float = 0.25,
) -> MovieLensTwin:
    rng = np.random.default_rng(seed)
    # Ground-truth low-rank structure. User factors are CLUSTERED (taste
    # communities), matching the strong user-similarity structure of the
    # real dataset — this is what the paper's graph regularizer exploits.
    centers = rng.normal(scale=0.6, size=(n_clusters, rank))
    assign = rng.integers(0, n_clusters, size=n_users)
    Utrue = centers[assign] + rng.normal(scale=0.6 * cluster_spread, size=(n_users, rank))
    Vtrue = rng.normal(scale=0.6, size=(n_items, rank))
    user_bias = rng.normal(scale=0.4, size=n_users)
    item_pop = rng.dirichlet(np.full(n_items, 0.3))  # popularity skew
    counts = _sample_counts(n_users, rng)

    train_ratings: list[dict[int, float]] = []
    test_ratings: list[dict[int, float]] = []
    for u in range(n_users):
        k = int(counts[u])
        items = rng.choice(n_items, size=min(k, n_items), replace=False, p=item_pop)
        raw = Utrue[u] @ Vtrue[items].T + user_bias[u] + rng.normal(scale=noise, size=len(items))
        stars = np.clip(np.round(3.0 + raw), 1, 5)
        n_train = max(int(train_frac * len(items)), 1)
        perm = rng.permutation(len(items))
        tr = {int(items[i]): float(stars[i]) for i in perm[:n_train]}
        te = {int(items[i]): float(stars[i]) for i in perm[n_train:]}
        train_ratings.append(tr)
        test_ratings.append(te)

    # Per-user mean normalization (computed on train only).
    user_means = np.array(
        [np.mean(list(r.values())) if r else 3.0 for r in train_ratings]
    )

    # ALS item features from the (normalized) training ratings.
    norm_train = [
        {j: r - user_means[u] for j, r in rd.items()} for u, rd in enumerate(train_ratings)
    ]
    _, V = _als(norm_train, n_items, p, als_iters, reg=0.05, rng=rng)

    # Build per-agent padded regression datasets: x = phi_j, y = r_uj - mean_u.
    def pack(ratings_list):
        m_max = max(max((len(r) for r in ratings_list), default=1), 1)
        X = np.zeros((n_users, m_max, p))
        y = np.zeros((n_users, m_max))
        mask = np.zeros((n_users, m_max))
        for u, rd in enumerate(ratings_list):
            for k, (j, r) in enumerate(rd.items()):
                X[u, k] = V[j]
                y[u, k] = r - user_means[u]
                mask[u, k] = 1.0
        return AgentData(X=X, y=y, mask=mask)

    train = pack(train_ratings)
    test = pack(test_ratings)

    # 10-NN cosine graph on raw training rating vectors (sparse, as the paper).
    vecs = np.zeros((n_users, n_items))
    for u, rd in enumerate(train_ratings):
        for j, r in rd.items():
            vecs[u, j] = r
    graph = knn_cosine_graph(vecs, k=10)

    return MovieLensTwin(
        train=train, test=test, graph=graph, item_features=V, user_means=user_means
    )


def rmse(Theta: np.ndarray, data: AgentData) -> float:
    """Per-user test RMSE averaged over users (Table 1 metric)."""
    pred = np.einsum("nmp,np->nm", data.X, Theta)
    err = (pred - data.y) ** 2 * data.mask
    m = np.maximum(data.mask.sum(axis=1), 1.0)
    per_user = np.sqrt(err.sum(axis=1) / m)
    valid = data.mask.sum(axis=1) > 0
    return float(per_user[valid].mean())

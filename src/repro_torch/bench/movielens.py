"""Table 1 on the port: per-user test RMSE on the MovieLens-100K twin.

Port of ``benchmarks/bench_movielens.py::run``. Columns: purely local
models | non-private CD | private CD for eps in {1, 0.5, 0.1} — all with
quadratic loss, gradient clipping C = 10, lambda_i = 1/m_i, mu tuned on a
validation split, 10-NN cosine graph (Sec. 5.2 protocol). The twin
(``repro_torch.data.movielens``) is synthesised from the dataset's
published statistics; nothing is downloaded. The tick loops run on
``device``; the private runs draw their noise from the port's own
generator, so their rows are comparable with the reference's only in
distribution.

    python -m repro_torch.bench.movielens [--device cuda] [--fast] [--out PATH]

``--fast`` is the reference's fast size (150 users, 400 items, 40 ticks
a user); the default is the full 943 users and 1682 items.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import parser, write_row
from repro_torch.core import DPConfig, make_objective, run_private, run_scan
from repro_torch.core.objective import AgentData
from repro_torch.data.movielens import movielens_twin, rmse


def _local_ridge(train, lambdas):
    n, _, p = train.X.shape
    theta = np.zeros((n, p))
    for u in range(n):
        sel = train.mask[u] > 0
        Xu, yu = train.X[u][sel], train.y[u][sel]
        m = max(len(yu), 1)
        theta[u] = np.linalg.solve(
            Xu.T @ Xu / m + lambdas[u] * np.eye(p), Xu.T @ yu / m
        )
    return theta


def _val_split(tw, seed):
    rng = np.random.default_rng(seed)
    mask = tw.train.mask.copy()
    val_mask = np.zeros_like(mask)
    for u in range(mask.shape[0]):
        idx = np.nonzero(mask[u] > 0)[0]
        k = max(len(idx) // 5, 1)
        val = rng.choice(idx, size=k, replace=False)
        val_mask[u, val] = 1.0
    tr = AgentData(X=tw.train.X, y=tw.train.y, mask=mask - val_mask)
    va = AgentData(X=tw.train.X, y=tw.train.y, mask=val_mask)
    return tr, va


def tune_mu(tw, lambdas, theta_loc, ticks_per_user, mu_grid=(0.5, 1.0, 2.0, 4.0, 8.0), seed=0,
            device="cuda"):
    """Tune mu on a held-out 20% of each user's training ratings, the
    paper's 'tuned to maximize accuracy ... on a validation set' protocol."""
    tr, va = _val_split(tw, seed)
    best = (mu_grid[0], np.inf)
    n = tw.train.n
    for mu in mu_grid:
        obj = make_objective(tw.graph, tr, "quadratic", mu=mu, lambdas=lambdas, clip=10.0)
        res = run_scan(obj, theta_loc, T=ticks_per_user * n,
                       rng=np.random.default_rng(seed), record_objective=False, device=device)
        r = rmse(res.Theta, va)
        if r < best[1]:
            best = (mu, r)
    return best[0]


def tune_private_ticks(tw, lambdas, theta_loc, mu, eps, tick_grid=(3, 8, 20), seed=0,
                       device="cuda"):
    """Paper Sec. 5.2: 'the number of iterations per node is tuned for each
    value of eps on a validation set'."""
    tr, va = _val_split(tw, seed)
    obj = make_objective(tw.graph, tr, "quadratic", mu=mu, lambdas=lambdas, clip=10.0)
    n = tw.train.n
    best = (tick_grid[0], np.inf)
    for ticks in tick_grid:
        r = run_private(obj, theta_loc, T=ticks * n, cfg=DPConfig(eps_bar=eps),
                        rng=np.random.default_rng(seed + ticks), record_objective=False,
                        device=device)
        v = rmse(r.Theta, va)
        if v < best[1]:
            best = (ticks, v)
    return best[0]


def run(n_users=943, n_items=1682, p=20, mu=None, ticks_per_user=40,
        eps_list=(1.0, 0.5, 0.1), seed=0, out=None, verbose=True, fast=False, device="cuda"):
    if fast:
        n_users, n_items, ticks_per_user = 150, 400, 40
    t0 = time.perf_counter()
    tw = movielens_twin(n_users=n_users, n_items=n_items, p=p, rank=p, seed=seed)
    lambdas = 1.0 / np.maximum(tw.train.num_examples, 1.0)

    theta_loc = _local_ridge(tw.train, lambdas)
    rmse_loc = rmse(theta_loc, tw.test)

    if mu is None:
        mu = tune_mu(tw, lambdas, theta_loc, ticks_per_user, seed=seed, device=device)
        if verbose:
            print(f"[table1] tuned mu = {mu}")
    obj = make_objective(tw.graph, tw.train, "quadratic", mu=mu, lambdas=lambdas, clip=10.0)

    T = ticks_per_user * n_users
    nonpriv = run_scan(obj, theta_loc, T=T, rng=np.random.default_rng(seed),
                       record_objective=False, device=device)
    rmse_cd = rmse(nonpriv.Theta, tw.test)

    rows = {"rmse_local": float(rmse_loc), "rmse_cd": float(rmse_cd)}
    for eps in eps_list:
        ticks = tune_private_ticks(tw, lambdas, theta_loc, mu, eps, seed=seed, device=device)
        priv = run_private(obj, theta_loc, T=ticks * n_users, cfg=DPConfig(eps_bar=eps),
                           rng=np.random.default_rng(seed + 1), record_objective=False,
                           device=device)
        rows[f"rmse_eps_{eps}"] = float(rmse(priv.Theta, tw.test))
        rows[f"ticks_eps_{eps}"] = ticks
    result = {"name": "table1_movielens", "n_users": n_users, "mu": mu,
              "ticks_per_user": ticks_per_user, **rows, "device": str(device),
              "elapsed_s": time.perf_counter() - t0}
    result["derived"] = f"rmse_local={rmse_loc:.3f},rmse_cd={rmse_cd:.3f}"
    if verbose:
        print(f"[table1] local {rmse_loc:.4f} | CD {rmse_cd:.4f} | " +
              " | ".join(f"eps={e}: {rows[f'rmse_eps_{e}']:.4f}" for e in eps_list))
    if out:
        write_row(out, result["name"], result)
    return result


def main(argv=None) -> None:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    run(out=args.out, device=args.device, fast=args.fast)


if __name__ == "__main__":
    main()

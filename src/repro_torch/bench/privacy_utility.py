"""Figures 2, 3 and 4 on the port: the privacy/utility trade-off on linear
classification.

Port of ``benchmarks/bench_privacy_utility.py``:

(a) objective along iterations under a fixed budget, constant init —
    the U-shaped "more iterations => more noise" behaviour;
(b) the same with the private warm start (Supp. C);
(c) final test accuracy against the dimension p for several privacy
    budgets, beside the purely local baseline, each budget's ticks tuned
    on a validation problem over ``tick_grid`` (the paper's protocol);
(fig3) the accuracy gain split by local dataset size;
(fig4) the local-DP baseline (perturb the data, then learn alone).

The tick loops and the local models run on ``device``; the problems, the
wake sequences, the warm start's output perturbation and the perturbed
datasets come from numpy seeded as in the reference, so the non-private
fields (local models, ``acc_local``, ``acc_nonprivate``, ``fig4``) agree
with the reference's. The private runs draw their noise from the port's
own generator, so their rows agree with the reference's only in
distribution.

    python -m repro_torch.bench.privacy_utility [--device cuda] [--fast] [--out PATH]

``--fast`` is the reference's fast size (``fig2a_b`` at n = 30, p = 20,
T = 200; ``fig2c_fig3`` at n = 30, p in (10, 20), 5 ticks an agent;
``fig4_local_dp`` at n = 30, p = 20), the size of ``BENCH_summary.json``'s
row; the default is the paper's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.bench import parser, write_row
from repro_torch.core import (
    DPConfig,
    make_objective,
    perturb_dataset,
    private_warm_start,
    run_private,
    run_scan,
    train_local_models,
)
from repro_torch.core.objective import LOGISTIC
from repro_torch.data.synthetic import eval_accuracy, linear_classification_problem
from repro_torch.device import resolve_device

FAST_FIG2AB = dict(n=30, p=20, T=200)
FAST_FIG2C = dict(n=30, dims=(10, 20), T_per_agent=5)
FAST_FIG4 = dict(n=30, p=20)


def _local_models(prob, device):
    return train_local_models(
        prob.train, LOGISTIC, 1.0 / np.maximum(prob.train.num_examples, 1.0), device=device
    )


def fig2a_b(n=100, p=100, eps=0.55, T=1000, mu=0.3, seed=0, record_every=20, verbose=True,
            device="cuda"):
    dev = resolve_device(device)
    prob = linear_classification_problem(n=n, p=p, seed=seed)
    obj = make_objective(prob.graph, prob.train, "logistic", mu=mu, clip=1.0)
    rng = np.random.default_rng(seed)
    const_init = np.ones((n, p))
    warm = private_warm_start(obj, eps_warm=0.05 * 10, rng=rng, device=dev)  # eps=0.5 warm
    cfg = DPConfig(eps_bar=eps)
    r_const = run_private(obj, const_init, T=T, cfg=cfg, rng=np.random.default_rng(seed + 1),
                          record_every=record_every, device=dev)
    r_warm = run_private(obj, warm, T=T, cfg=cfg, rng=np.random.default_rng(seed + 2),
                         record_every=record_every, device=dev)

    def value(Theta):
        return float(obj.value(torch.as_tensor(np.asarray(Theta), dtype=torch.float32,
                                               device=dev)))

    out = {
        "const_objective": r_const.objective.tolist(),
        "warm_objective": r_warm.objective.tolist(),
        "acc_const": float(eval_accuracy(r_const.Theta, prob.test).mean()),
        "acc_warm": float(eval_accuracy(r_warm.Theta, prob.test).mean()),
        "warm_start_obj": value(warm),
        "const_init_obj": value(const_init),
    }
    if verbose:
        print(f"[fig2ab] const init: obj {out['const_init_obj']:.1f} -> min "
              f"{min(r_const.objective):.1f}, acc {out['acc_const']:.3f}")
        print(f"[fig2ab] warm  init: obj {out['warm_start_obj']:.1f} -> min "
              f"{min(r_warm.objective):.1f}, acc {out['acc_warm']:.3f}")
    return out


def fig2c_fig3(n=100, dims=(10, 50, 100), eps_list=(0.1, 0.5, 1.0), T_per_agent=None,
               mu=0.3, seed=0, verbose=True, tick_grid=(1, 2, 5, 10), device="cuda"):
    dev = resolve_device(device)
    rows = []
    fig3 = None
    for p in dims:
        prob = linear_classification_problem(n=n, p=p, seed=seed + p)
        obj = make_objective(prob.graph, prob.train, "logistic", mu=mu, clip=1.0)
        theta_loc = _local_models(prob, dev)
        acc_loc = eval_accuracy(theta_loc, prob.test)
        rng = np.random.default_rng(seed)
        nonpriv = run_scan(obj, theta_loc, T=20 * n, rng=rng, record_objective=False,
                           device=dev)
        acc_np = eval_accuracy(nonpriv.Theta, prob.test)
        row = {"p": p, "acc_local": float(acc_loc.mean()), "acc_nonprivate": float(acc_np.mean())}
        # Paper protocol: "the number of iterations per node was tuned based
        # on a validation set of random problem instances".
        val_prob = linear_classification_problem(n=n, p=p, seed=seed + p + 10_000)
        val_obj = make_objective(val_prob.graph, val_prob.train, "logistic", mu=mu, clip=1.0)
        for eps in eps_list:
            if T_per_agent is None:
                best = (tick_grid[0], -1.0)
                for ticks in tick_grid:
                    vw = private_warm_start(val_obj, eps_warm=0.5,
                                            rng=np.random.default_rng(seed + 7), device=dev)
                    vr = run_private(val_obj, vw, T=ticks * n, cfg=DPConfig(eps_bar=eps),
                                     rng=np.random.default_rng(seed + 8),
                                     record_objective=False, device=dev)
                    a = float(eval_accuracy(vr.Theta, val_prob.test).mean())
                    if a > best[1]:
                        best = (ticks, a)
                ticks = best[0]
            else:
                ticks = T_per_agent
            warm = private_warm_start(obj, eps_warm=0.5, rng=np.random.default_rng(seed + 3),
                                      device=dev)
            r = run_private(obj, warm, T=ticks * n, cfg=DPConfig(eps_bar=eps),
                            rng=np.random.default_rng(seed + 4), record_objective=False,
                            device=dev)
            acc = eval_accuracy(r.Theta, prob.test)
            row[f"acc_eps_{eps}"] = float(acc.mean())
            row[f"ticks_eps_{eps}"] = ticks
            if p == max(dims) and eps == eps_list[-1]:
                # Fig 3: improvement by dataset size (largest dim, largest eps)
                m = prob.train.num_examples
                small = m <= np.median(m)
                fig3 = {
                    "acc_local_small_m": float(acc_loc[small].mean()),
                    "acc_priv_small_m": float(acc[small].mean()),
                    "acc_local_large_m": float(acc_loc[~small].mean()),
                    "acc_priv_large_m": float(acc[~small].mean()),
                }
        rows.append(row)
        if verbose:
            print(f"[fig2c] p={p}: " + " ".join(f"{k}={v:.3f}" for k, v in row.items() if k != "p"))
    if verbose and fig3:
        print(f"[fig3] small-m agents: local {fig3['acc_local_small_m']:.3f} -> "
              f"private {fig3['acc_priv_small_m']:.3f}; large-m: "
              f"{fig3['acc_local_large_m']:.3f} -> {fig3['acc_priv_large_m']:.3f}")
    return rows, fig3


def fig4_local_dp(n=100, p=50, eps_list=(1.0, 5.0), mu=0.3, seed=0, verbose=True,
                  device="cuda"):
    dev = resolve_device(device)
    prob = linear_classification_problem(n=n, p=p, seed=seed)
    theta_loc = _local_models(prob, dev)
    acc_clean = eval_accuracy(theta_loc, prob.test).mean()
    rows = []
    for eps in eps_list:
        pert = perturb_dataset(prob.train, eps=eps, rng=np.random.default_rng(seed))
        theta_dp = train_local_models(
            pert, LOGISTIC, 1.0 / np.maximum(pert.num_examples, 1.0), device=dev
        )
        acc = eval_accuracy(theta_dp, prob.test).mean()
        rows.append({"eps": eps, "acc_local_dp": float(acc)})
        if verbose:
            print(f"[fig4] local-DP eps={eps}: acc {acc:.3f} (clean local {acc_clean:.3f})")
    return {"acc_local_clean": float(acc_clean), "rows": rows}


def run(out=None, fast=False, verbose=True, device="cuda"):
    t0 = time.perf_counter()
    ab = fig2a_b(verbose=verbose, device=device, **(FAST_FIG2AB if fast else {}))
    c, f3 = fig2c_fig3(verbose=verbose, device=device, **(FAST_FIG2C if fast else {}))
    f4 = fig4_local_dp(verbose=verbose, device=device, **(FAST_FIG4 if fast else {}))
    result = {"name": "fig2_privacy_utility", "fig2ab": ab, "fig2c": c, "fig3": f3,
              "fig4": f4, "device": str(device), "elapsed_s": time.perf_counter() - t0}
    last = c[-1]
    result["derived"] = (f"acc_local={last['acc_local']:.3f},"
                         f"acc_nonpriv={last['acc_nonprivate']:.3f}")
    if out:
        write_row(out, result["name"], result)
    return result


def main(argv=None) -> None:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    run(out=args.out, device=args.device, fast=args.fast)


if __name__ == "__main__":
    main()

"""Beyond-paper ablations on the port.

Port of ``benchmarks/bench_ablations.py``:

1. Prop.-2 (time-decreasing) noise allocation against the uniform split
   the paper's experiments use — the theory (Lemma 3) predicts a lower
   utility loss for the decreasing schedule.
2. Gaussian (Remark 4) against Laplace (Thm. 1) mechanism at matched
   (eps, delta).
3. The personalized objective against one global model trained on the
   pooled data (the mu -> 0 extreme) on heterogeneous agents — the reason
   the paper's objective exists.

The tick loops and the local models run on ``device``; problems and wake
sequences come from numpy seeded as in the reference, so the
non-private comparison (3) agrees with the reference's, and (1) and (2),
whose runs draw private noise from the port's own generator, agree with
it only in distribution.

    python -m repro_torch.bench.ablations [--device cuda] [--fast] [--out PATH]

``--fast`` is the reference's fast size (n = 20, p = 10, 2 seeds; n = 16
for the personalization ablation), the size of ``BENCH_summary.json``'s
row.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import parser, write_row
from repro_torch.core import DPConfig, make_objective, run_private, run_scan, train_local_models
from repro_torch.core.objective import LOGISTIC, AgentData
from repro_torch.data.synthetic import eval_accuracy, linear_classification_problem

FAST = dict(n=20, p=10, seeds=2)
FAST_PERSONALIZATION = dict(n=16, p=10)


def _private_from_local(n, p, eps, T_per_agent, seeds, problem_seed, noise_seed, configs,
                        device):
    """Mean final test accuracy of private CD from the purely local models,
    for each named ``DPConfig`` in ``configs``, over ``seeds`` problems."""
    accs = {k: [] for k in configs}
    for s in range(seeds):
        prob = linear_classification_problem(n=n, p=p, seed=problem_seed + s)
        obj = make_objective(prob.graph, prob.train, "logistic", mu=0.3, clip=1.0)
        theta_loc = train_local_models(
            prob.train, LOGISTIC, 1.0 / np.maximum(prob.train.num_examples, 1.0), device=device
        )
        for name, cfg in configs.items():
            res = run_private(obj, theta_loc, T=T_per_agent * n, cfg=cfg,
                              rng=np.random.default_rng(noise_seed + s),
                              record_objective=False, device=device)
            accs[name].append(float(eval_accuracy(res.Theta, prob.test).mean()))
    return {k: float(np.mean(v)) for k, v in accs.items()}


def prop2_vs_uniform(n=50, p=10, eps=1.0, T_per_agent=5, seeds=5, verbose=True, device="cuda"):
    """Utility metric: mean final test accuracy from the purely local init
    (the regime where private CD descends)."""
    configs = {s: DPConfig(eps_bar=eps, schedule=s) for s in ("uniform", "prop2")}
    out = _private_from_local(n, p, eps, T_per_agent, seeds, 0, 100, configs, device)
    out["prop2_better"] = out["prop2"] >= out["uniform"]
    if verbose:
        print(f"[ablation] noise allocation: uniform acc {out['uniform']:.3f} "
              f"vs prop2 {out['prop2']:.3f} (prop2 better: {out['prop2_better']})")
    return out


def gaussian_vs_laplace(n=50, p=10, eps=1.0, T_per_agent=5, seeds=5, verbose=True,
                        device="cuda"):
    configs = {m: DPConfig(eps_bar=eps, mechanism=m, delta_step=1e-6)
               for m in ("laplace", "gaussian")}
    out = _private_from_local(n, p, eps, T_per_agent, seeds, 20, 7, configs, device)
    if verbose:
        print(f"[ablation] mechanism: laplace acc {out['laplace']:.3f} "
              f"vs gaussian {out['gaussian']:.3f}")
    return out


def personalized_vs_global(n=40, p=20, verbose=True, device="cuda"):
    """Heterogeneous tasks: the personalized optimum must beat the best
    single global model (collaboration must not collapse to consensus)."""
    prob = linear_classification_problem(n=n, p=p, seed=3)
    obj = make_objective(prob.graph, prob.train, "logistic", mu=0.3, clip=1.0)
    res = run_scan(obj, np.zeros((n, p)), T=30 * n, rng=np.random.default_rng(0),
                   record_objective=False, device=device)
    acc_pers = eval_accuracy(res.Theta, prob.test).mean()
    # Global model: one model trained on the union of all data (an upper
    # bound on any consensus method for this heterogeneous setup).
    X = prob.train.X.reshape(-1, p)
    y = prob.train.y.reshape(-1)
    mask = prob.train.mask.reshape(-1) > 0
    pooled = AgentData(X=X[mask][None], y=y[mask][None], mask=np.ones((1, mask.sum())))
    theta_g = train_local_models(pooled, LOGISTIC, np.array([1.0 / mask.sum()]), device=device)
    acc_glob = eval_accuracy(np.broadcast_to(theta_g, (n, p)), prob.test).mean()
    if verbose:
        print(f"[ablation] personalized acc {acc_pers:.3f} vs single global model "
              f"{acc_glob:.3f}")
    return {"acc_personalized": float(acc_pers), "acc_global": float(acc_glob)}


def run(out=None, verbose=True, fast=False, device="cuda"):
    t0 = time.perf_counter()
    r1 = prop2_vs_uniform(verbose=verbose, device=device, **(FAST if fast else {}))
    r2 = gaussian_vs_laplace(verbose=verbose, device=device, **(FAST if fast else {}))
    r3 = personalized_vs_global(verbose=verbose, device=device,
                                **(FAST_PERSONALIZATION if fast else {}))
    result = {"name": "ablations", "noise_allocation": r1, "mechanism": r2,
              "personalization": r3, "device": str(device),
              "elapsed_s": time.perf_counter() - t0}
    result["derived"] = (f"personalized={r3['acc_personalized']:.3f},"
                         f"global={r3['acc_global']:.3f}")
    if out:
        write_row(out, result["name"], result)
    return result


def main(argv=None) -> None:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    run(out=args.out, device=args.device, fast=args.fast)


if __name__ == "__main__":
    main()

"""Figure 1 on the port: coordinate descent (ours) vs gossip ADMM
(Vanhaesebrouck et al. 2017) on the linear classification task.

Port of ``benchmarks/bench_cd_vs_admm.py::run``. Both algorithms start
from the purely local models and are compared on the objective value and
test accuracy as functions of (i) iterations and (ii) p-dimensional
vectors transmitted — the paper's two x-axes. The tick loops run on
``device``; the problem, the wake sequence and the edge activations come
from numpy seeded by ``seed``, as in the reference.

    python -m repro_torch.bench.cd_vs_admm [--device cuda] [--fast] [--out PATH]

``--fast`` is the reference runner's fast size (n = 30, p = 20,
T_cd = 800, T_admm = 80); the default is the paper's (n = p = 100,
T_cd = 3000, T_admm = 300).
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import parser, write_row
from repro_torch.core import make_objective, run_admm, run_scan, train_local_models
from repro_torch.core.objective import LOGISTIC
from repro_torch.data.synthetic import eval_accuracy, linear_classification_problem

FAST = dict(n=30, p=20, T_cd=800, T_admm=80)


def run(n=100, p=100, T_cd=3000, T_admm=300, mu=0.3, seed=0, record_every=50,
        out=None, verbose=True, device="cuda"):
    t0 = time.perf_counter()
    prob = linear_classification_problem(n=n, p=p, seed=seed)
    obj = make_objective(prob.graph, prob.train, "logistic", mu=mu)
    theta_loc = train_local_models(
        prob.train, LOGISTIC, 1.0 / np.maximum(prob.train.num_examples, 1.0), device=device
    )
    acc_loc = eval_accuracy(theta_loc, prob.test).mean()

    rng = np.random.default_rng(seed)
    cd = run_scan(obj, theta_loc, T=T_cd, rng=rng, record_every=record_every, device=device)
    acc_cd = eval_accuracy(cd.Theta, prob.test).mean()

    admm = run_admm(obj, theta_loc, T=T_admm, rng=np.random.default_rng(seed + 1),
                    rho=1.0, local_grad_steps=10, record_every=max(record_every // 10, 1),
                    device=device)
    acc_admm = eval_accuracy(admm.Theta, prob.test).mean()

    # Fig-1 comparison at equal communication: objective reached by each
    # algorithm after the same number of transmitted p-vectors.
    budget = admm.messages[-1]
    k = int(np.searchsorted(cd.messages, budget))
    k = min(k, len(cd.objective) - 1)

    result = {
        "name": "fig1_cd_vs_admm",
        "n": n, "p": p, "mu": mu,
        "acc_local": float(acc_loc),
        "acc_cd": float(acc_cd),
        "acc_admm": float(acc_admm),
        "obj_init": float(cd.objective[0]),
        "obj_cd_final": float(cd.objective[-1]),
        "obj_admm_final": float(admm.objective[-1]),
        "messages_admm": float(budget),
        "obj_cd_at_admm_budget": float(cd.objective[k]),
        "cd_beats_admm_per_message": bool(cd.objective[k] < admm.objective[-1]),
        "curves": {
            "cd_messages": cd.messages.tolist(),
            "cd_objective": cd.objective.tolist(),
            "admm_messages": admm.messages.tolist(),
            "admm_objective": admm.objective.tolist(),
        },
        "device": str(device),
        "elapsed_s": time.perf_counter() - t0,
    }
    result["derived"] = f"cd_beats_admm_per_message={result['cd_beats_admm_per_message']}"
    if verbose:
        print(f"[fig1] local acc {acc_loc:.3f} | CD acc {acc_cd:.3f} | ADMM acc {acc_admm:.3f}")
        print(f"[fig1] obj: init {result['obj_init']:.2f} -> CD {result['obj_cd_final']:.2f}, "
              f"ADMM {result['obj_admm_final']:.2f}")
        print(f"[fig1] at ADMM's message budget ({budget:.0f} vectors): "
              f"CD obj {result['obj_cd_at_admm_budget']:.2f} "
              f"(beats ADMM: {result['cd_beats_admm_per_message']})")
    if out:
        write_row(out, result["name"], result)
    return result


def main(argv=None) -> None:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    run(out=args.out, device=args.device, **(FAST if args.fast else {}))


if __name__ == "__main__":
    main()

"""Quickstart: personalized + private P2P learning in a few lines (the port).

Port of ``examples/quickstart.py``. 10 agents with related-but-distinct
linear tasks collaborate over a similarity graph; it compares purely
local models, the paper's non-private coordinate descent (Eq. 4) and the
differentially private variant (Eq. 6).

    python -m repro_torch.examples.quickstart [--device D]
"""

import argparse

import numpy as np

from repro_torch.core import DPConfig, make_objective, run_private, run_scan, train_local_models
from repro_torch.core.objective import LOGISTIC
from repro_torch.data.synthetic import eval_accuracy, linear_classification_problem


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    dev = ap.parse_args(argv).device

    # 1. A network of agents with heterogeneous local datasets (Sec. 5.1 setup).
    prob = linear_classification_problem(n=10, p=20, m_low=15, m_high=80, seed=0)
    print(f"{prob.graph.n} agents, {prob.graph.num_edges()} edges, "
          f"{int(prob.train.num_examples.sum())} total examples")

    # 2. Purely local models (the perfectly private baseline).
    theta_loc = train_local_models(
        prob.train, LOGISTIC, 1.0 / np.maximum(prob.train.num_examples, 1.0), device=dev)
    acc_local = float(eval_accuracy(theta_loc, prob.test).mean())
    print(f"purely local accuracy:      {acc_local:.3f}")

    # 3. The paper's objective (Eq. 2) and asynchronous block coordinate descent.
    obj = make_objective(prob.graph, prob.train, "logistic", mu=0.3, clip=1.0)
    res = run_scan(obj, theta_loc, T=600, rng=np.random.default_rng(1), device=dev)
    acc_cd = float(eval_accuracy(res.Theta, prob.test).mean())
    print(f"collaborative CD accuracy:  {acc_cd:.3f} "
          f"(objective {res.objective[0]:.2f} -> {res.objective[-1]:.2f})")

    # 4. The private variant: every broadcast is (eps, delta)-DP for the agent.
    priv = run_private(obj, theta_loc, T=50, cfg=DPConfig(eps_bar=1.0),
                       rng=np.random.default_rng(2), device=dev)
    acc_private = float(eval_accuracy(priv.Theta, prob.test).mean())
    print(f"private CD (eps=1) accuracy: {acc_private:.3f} "
          f"(max eps spent: {priv.eps_spent.max():.3f})")
    return dict(acc_local=acc_local, acc_cd=acc_cd, objective=[float(res.objective[0]),
                float(res.objective[-1])], acc_private=acc_private,
                eps_spent_max=float(priv.eps_spent.max()))


if __name__ == "__main__":
    main()

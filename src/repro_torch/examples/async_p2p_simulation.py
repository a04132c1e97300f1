"""Batched async simulation walkthrough on the port: churn, delays, stragglers, DP.

Port of ``examples/async_p2p_simulation.py``. Builds a 10,000-agent
random geometric collaboration graph (CSR, no (n, n) array anywhere),
then drives the paper's algorithms through the
:mod:`repro_torch.sim` batched engine under increasingly hostile
deployment conditions:

1. non-private CD (Eq. 4) under ideal thinned-Poisson clocks;
2. the same under churn + per-edge message delays + stragglers;
3. DP-CD (Eq. 6) with per-agent uniform budget split and stopping.

    python -m repro_torch.examples.async_p2p_simulation [--device D]
"""

import argparse

import numpy as np

from repro_torch.core import AgentData, DPConfig, make_objective, random_geometric_graph
from repro_torch.sim import (
    CDUpdate,
    ChurnConfig,
    DelayConfig,
    DPCDUpdate,
    EngineConfig,
    Scenario,
    StragglerConfig,
    make_engine,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    dev = ap.parse_args(argv).device

    rng = np.random.default_rng(0)
    n, p, m = 10_000, 8, 64
    graph = random_geometric_graph(n, rng, avg_degree=16.0)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    data = AgentData(X=X, y=y, mask=np.ones((n, m)))
    obj = make_objective(graph, data, "quadratic", mu=0.5, mix_mode="sparse")
    Theta0 = np.zeros((n, p))
    out = {}

    print(f"n={n} agents, avg degree ~{np.diff(graph.indptr).mean():.1f}")

    # 1. Ideal conditions: pure thinned Poisson clocks. One EngineConfig
    # carries the shared knobs; scenario variants are overrides.
    cfg = EngineConfig(slot_wakes=512.0, seed=1, device=dev)
    eng = make_engine(CDUpdate(obj), cfg)
    res = eng.run(Theta0, slots=60, record_every=20)
    print("\n[ideal]      Q:", " -> ".join(f"{q:.1f}" for q in res.objective))
    print(f"             {res.wakes_applied} wakes over {res.slots} super-ticks")
    out["ideal"] = dict(objective=res.objective.tolist(), wakes_applied=res.wakes_applied)

    # 2. Deployment conditions: 1%/slot churn, 1-slot edge delays, 10% stragglers.
    scenario = Scenario(
        churn=ChurnConfig(leave_prob=0.01, rejoin_prob=0.2),
        delay=DelayConfig(max_delay=2, edge_delays=1),
        straggler=StragglerConfig(drop_prob=0.1),
    )
    eng = make_engine(CDUpdate(obj), cfg, scenario=scenario)
    res = eng.run(Theta0, slots=60, record_every=20)
    print("\n[hostile]    Q:", " -> ".join(f"{q:.1f}" for q in res.objective))
    print(f"             {res.wakes_applied} wakes applied, "
          f"{int((~res.active).sum())} agents currently departed")
    out["hostile"] = dict(objective=res.objective.tolist(), wakes_applied=res.wakes_applied,
                          departed=int((~res.active).sum()))

    # 3. Differential privacy: each agent plans 4 wake-ups from an overall
    # (eps=1, delta=e^-5) budget, then freezes once it is spent. The
    # quadratic loss needs a gradient clip (Supp. D.2) for finite
    # sensitivity; noise scales as 2 * clip / (eps_step * m_i).
    clipped = make_objective(graph, data, "quadratic", mu=0.5, mix_mode="sparse", clip=0.5)
    upd = DPCDUpdate.plan(clipped, DPConfig(eps_bar=1.0), planned_Ti=4)
    eng = make_engine(upd, cfg)
    res = eng.run(Theta0, slots=60, record_every=20)
    eps = upd.eps_spent(res.update_state)
    counts = np.asarray(res.update_state.cpu())
    exhausted = int((counts >= upd.planned_Ti).sum())
    print("\n[private]    Q:", " -> ".join(f"{q:.1f}" for q in res.objective))
    print(f"             eps spent: max {eps.max():.3f} <= 1.0, "
          f"{exhausted}/{n} agents exhausted their budget")
    out["private"] = dict(objective=res.objective.tolist(), eps_max=float(eps.max()),
                          exhausted=exhausted)
    return out


if __name__ == "__main__":
    main()

"""Sparse P2P learning at a scale no dense graph survives (the port).

Port of ``examples/sparse_p2p_scale.py``. 5,000 agents on a random
geometric collaboration graph (average degree ~12) run the paper's
asynchronous coordinate descent (Eq. 4) through the CSR sparse backend:
O(nnz) graph storage, O(deg * p) per tick, then synchronous rounds
through the sparse neighbour sum (on the card ``sparse_mix`` at R = n).
The same at n = 100,000 is :mod:`repro_torch.bench.sparse_scale`.

    python -m repro_torch.examples.sparse_p2p_scale [--device D]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import make_objective, random_geometric_graph, run_scan, synchronous_round
from repro_torch.core.objective import AgentData
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)

    n, p, m = 5_000, 16, 8
    rng = np.random.default_rng(0)

    # 1. Sparse collaboration graph, built without ever touching (n, n).
    graph = random_geometric_graph(n, rng, avg_degree=12.0)
    deg = np.diff(graph.indptr)
    print(f"{graph.n} agents, {graph.num_edges()} edges, "
          f"avg degree {deg.mean():.1f}, CSR bytes ~{graph.indices.nbytes + graph.data.nbytes}")

    # 2. Per-agent quadratic tasks whose targets vary smoothly in space.
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    data = AgentData(X=X, y=y, mask=np.ones((n, m)))

    # 3. mix_mode="auto" picks the sparse path above the crossover
    #    (REPRO_SPARSE_CROSSOVER, default 2048): n = 5000 routes sparse.
    obj = make_objective(graph, data, "quadratic", mu=0.5)
    print(f"neighbour-sum path: {obj.mix.kind}")

    # 4. A burst of asynchronous ticks (Eq. 4, one agent per tick)...
    res = run_scan(obj, np.zeros((n, p)), T=2_000, rng=rng, record_every=500,
                   record_objective=False, device=dev)

    # 5. ...then synchronous rounds (one round ~ n async ticks in
    #    expectation), all through the sparse neighbour sum.
    Theta = torch.as_tensor(res.Theta, dtype=torch.float32, device=dev)
    for _ in range(20):
        Theta = synchronous_round(obj, Theta)
    Theta = Theta.cpu().numpy()

    def mean_err(Th):
        return float(np.linalg.norm(np.asarray(Th) - targets, axis=1).mean())

    errs = [mean_err(np.zeros((n, p))), mean_err(res.Theta), mean_err(Theta)]
    print(f"mean distance to hidden targets: {errs[0]:.3f} -> {errs[1]:.3f} (2k async ticks) "
          f"-> {errs[2]:.3f} (+20 sync rounds)")
    return {"mix": obj.mix.kind, "mean_err": errs}


if __name__ == "__main__":
    main()

"""A run's inputs from its seeds, handed alike to the program and to the
reference.

The configuration's ``graph`` group names its generator, a module of this
package with a function ``csr(n, spec, generator)``; the base graph comes
from the group's own seed and is renamed by a permutation from the run's
seed, so every seed has the same degrees in another order. The agents'
points and a mix's edge delays come from the run's seeds.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

from perfbench.data import agents
from perfbench.data.rgg import relabel_csr


@dataclasses.dataclass
class Problem:
    """The benchmark's inputs as host arrays."""

    indptr: np.ndarray
    indices: np.ndarray
    weights: np.ndarray
    X: np.ndarray
    y: np.ndarray
    delays: np.ndarray | None  # (nnz,) per CSR entry

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.indices)


def make_problem(cfg: dict, traffic: dict, seeds: dict, device) -> Problem:
    """The graph, the agents' data and (where the mix has them) the edge
    delays of one run."""
    n = int(cfg["n"])
    g = cfg["graph"]
    build = importlib.import_module(f"perfbench.data.{g['generator']}").csr
    indptr, indices, _ = build(n, g, agents.generator(g["seed"], device))
    perm = np.random.default_rng(seeds["graph_relabel"]).permutation(n)
    indptr, indices, weights = relabel_csr(indptr, indices, perm, device)
    X, y = agents.agent_data(n, int(cfg["m"]), int(cfg["p"]),
                             agents.generator(seeds["data"], device))
    delays = None
    if traffic.get("delay"):
        delays = agents.edge_delays(len(indices), int(traffic["delay"]["max_delay"]),
                                    agents.generator(seeds["delays"], device)).cpu().numpy()
    return Problem(indptr, indices, weights, X.cpu().numpy(), y.cpu().numpy(), delays)

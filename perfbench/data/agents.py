"""The frozen per-agent inputs: data points, edge delays, seeds.

Each agent holds ``m`` points of width ``p``: ``x ~ N(0, I / p)`` and a
noise-free target ``y = x . t_i`` for an agent target ``t_i ~ N(0, I / p)``,
the linear-regression tasks of the paper's Sec. 5.1 at its width. They are
drawn on the generator's device in float32, the dtype they are served in,
in two calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Every input of a run comes from --seed through these named streams.
STREAMS = ("graph_relabel", "data", "engine", "delays", "perturb", "check", "episodes")


def stream_seeds(seed: int) -> dict:
    """One 63-bit seed per named stream, derived from the run's ``seed``
    (any non-negative whole number)."""
    words = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS), dtype=np.uint64)
    return {name: int(w) >> 1 for name, w in zip(STREAMS, words)}


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def agent_data(n: int, m: int, p: int, gen: torch.Generator):
    """``(X, y)``: (n, m, p) points and (n, m) targets, float32 on the
    generator's device."""
    dev = gen.device
    t = torch.randn((n, p), generator=gen, device=dev) / math.sqrt(p)
    X = torch.randn((n, m, p), generator=gen, device=dev) / math.sqrt(p)
    y = torch.einsum("nmp,np->nm", X, t)
    return X, y


def edge_delays(nnz: int, max_delay: int, gen: torch.Generator) -> torch.Tensor:
    """(nnz,) int64 per-edge delays, uniform in {0, ..., max_delay}, one for
    each stored (directed) CSR entry: entry e delays the message of agent
    ``indices[e]`` to its row's agent."""
    return torch.randint(0, max_delay + 1, (nnz,), generator=gen, device=gen.device)


def padded_delays(indptr: np.ndarray, delays: np.ndarray) -> np.ndarray:
    """The per-edge delays as an (n, K) array aligned with padded neighbour
    tiles in CSR order (K the largest degree; padding 0)."""
    deg = np.diff(indptr)
    K = max(int(deg.max(initial=0)), 1)
    out = np.zeros((len(deg), K), dtype=np.int32)
    out[np.arange(K)[None, :] < deg[:, None]] = delays
    return out

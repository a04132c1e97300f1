"""The frozen random geometric graph: agents on the unit square, built from a seed.

Agents are uniform points on [0, 1]^2; i ~ j when their distance is at most
the radius r with E[deg] = (n - 1) pi r^2 = ``avg_degree``; an agent left
without a neighbour is linked to its nearest peer, so every weighted degree
is positive (Eq. 4 divides by it). Every weight is 1.

The build is vectorized in torch on the generator's device: the points are
sorted into a grid of r-sized cells, and each point is paired with the
points of the 3 x 3 cells around its own, one offset at a time. The edge
list comes back in CSR order (sorted by row, then column), both directions
of every edge stored, as host numpy arrays.

``relabel_csr`` renames the agents by a permutation: the same graph, the
same degrees and the same largest degree in another order, so seeds that
share a base graph share every size of the work.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _csr_from_pairs(n: int, rows: torch.Tensor, cols: torch.Tensor):
    """CSR arrays (indptr int64, indices int32, data float64 ones) of the
    distinct directed pairs, sorted by row then column."""
    key = torch.unique(rows * n + cols)  # sorted, deduplicated
    rows, cols = key // n, key % n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=key.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return (indptr.cpu().numpy(), cols.to(torch.int32).cpu().numpy(),
            np.ones(int(key.numel()), dtype=np.float64))


def rgg_csr(n: int, avg_degree: float, generator: torch.Generator):
    """The graph's CSR arrays ``(indptr, indices, data)`` for ``n`` agents,
    drawn from ``generator`` (on its device)."""
    dev = generator.device
    pos = torch.rand((n, 2), generator=generator, device=dev, dtype=torch.float64)
    r = math.sqrt(avg_degree / (math.pi * max(n - 1, 1)))
    side = max(int(math.ceil(1.0 / r)), 1)
    cell = torch.clamp(torch.floor(pos / r).long(), max=side - 1)
    cid = cell[:, 0] * side + cell[:, 1]
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=side * side)
    starts = torch.cumsum(counts, 0) - counts
    cx, cy, spos = cell[order, 0], cell[order, 1], pos[order]
    rows, cols = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nx, ny = cx + dx, cy + dy
            src = torch.nonzero((nx >= 0) & (nx < side) & (ny >= 0) & (ny < side)).squeeze(1)
            other = nx[src] * side + ny[src]
            cnt = counts[other]
            i = torch.repeat_interleave(src, cnt)
            first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
            j = torch.repeat_interleave(starts[other], cnt) + (
                torch.arange(i.numel(), device=dev) - first)
            near = (((spos[i] - spos[j]) ** 2).sum(1) <= r * r) & (i != j)
            rows.append(order[i[near]])
            cols.append(order[j[near]])
    rows, cols = torch.cat(rows), torch.cat(cols)
    lonely = torch.nonzero(torch.bincount(rows, minlength=n) == 0).squeeze(1)
    if lonely.numel() and n > 1:
        nearest = []
        for block in torch.split(lonely, 64):
            d2 = ((pos[block][:, None, :] - pos[None, :, :]) ** 2).sum(-1)
            d2[torch.arange(block.numel(), device=dev), block] = float("inf")
            nearest.append(torch.argmin(d2, dim=1))
        nearest = torch.cat(nearest)
        rows = torch.cat([rows, lonely, nearest])
        cols = torch.cat([cols, nearest, lonely])
    return _csr_from_pairs(n, rows, cols)


def relabel_csr(indptr, indices, perm: np.ndarray, device="cpu"):
    """The graph with agent ``i`` renamed ``perm[i]``, in CSR order."""
    n = len(indptr) - 1
    ip = torch.as_tensor(indptr, device=device)
    rows = torch.repeat_interleave(torch.arange(n, device=device), ip[1:] - ip[:-1])
    p = torch.as_tensor(perm, dtype=torch.int64, device=device)
    cols = torch.as_tensor(indices, dtype=torch.int64, device=device)
    return _csr_from_pairs(n, p[rows], p[cols])


def csr(n: int, spec: dict, generator: torch.Generator):
    """The configuration's graph (``spec``: its ``graph`` group) for ``n``
    agents: the generator that ``data/problem.py`` finds by the name
    ``spec["generator"]``."""
    return rgg_csr(n, float(spec["avg_degree"]), generator)

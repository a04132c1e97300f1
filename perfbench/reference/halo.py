"""The plain reference of the sharded slot's halo exchange, in PyTorch.

A sharded deployment splits the agents over S silos (an ownership: each
agent belongs to one silo). An agent is a border agent of its silo when an
agent of another silo has it as a neighbour; a silo's halo is the set of
other silos' agents that its own agents have as neighbours. Each slot every
border agent publishes the payload

    v = theta + e          (float32 add: its start-of-slot row and its residual)
    q = bf16(v)            (round to nearest, ties to even)
    e <- v - q             (the new float32 residual: error feedback,
                            Karimireddy et al. 2019, arXiv:1901.09847)

and a woken agent takes the Eq. 4 step (``eq4.py``, its arithmetic reused)
reading its own silo's neighbours exactly and other silos' neighbours as q.
The bf16 rounding is done here on the float32 bits, not by a cast.

Inputs: the ownership (the silos' agent lists, read from the program's
partition and checked here to be a partition of 0..n-1), the benchmark's
CSR graph and data, and the residuals e of the state a slot starts from.
Nothing here calls the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.eq4 import Eq4Reference

I64 = torch.int64


def bf16_round(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to bfloat16 (nearest, ties to even; a carry
    into the exponent rounds up to the next power of two or to inf), as
    float32: the top 16 bits of ``bits + 0x7FFF + (bit 16)``."""
    b = v.contiguous().view(torch.int32).to(I64) & 0xFFFFFFFF
    r = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    r = torch.where(r >= 2**31, r - 2**32, r)
    return r.to(torch.int32).view(torch.float32)


class HaloReference:
    """The halo of a sharded slot and its Eq. 4 step over one CSR graph.

    ``own(blocks)`` sets the ownership; then ``border_keys`` and
    ``halo_keys`` hold each silo's border and halo agents as sorted keys
    ``silo * n + agent``, ``publish`` computes q and the new e, and
    ``step`` the Eq. 4 rows."""

    def __init__(self, indptr, indices, weights, X, y, mu: float, device="cpu"):
        self.eq4 = Eq4Reference(indptr, indices, weights, X, y, mu, device=device)
        self.device = self.eq4.device
        self.n, self.p = self.eq4.n, self.eq4.p
        n = self.n
        self.rows = torch.repeat_interleave(torch.arange(n, device=self.device),
                                            self.eq4.indptr[1:] - self.eq4.indptr[:-1])
        self.owner = None

    def own(self, blocks) -> "HaloReference":
        """Set the ownership: ``blocks`` (S, R) the agents of each silo,
        padded with ids >= n. Raises unless every agent 0..n-1 appears
        exactly once."""
        n, dev = self.n, self.device
        blocks = torch.as_tensor(np.asarray(blocks), dtype=I64, device=dev)
        silo = torch.arange(blocks.shape[0], device=dev)[:, None].expand_as(blocks)
        real = blocks < n
        ids, silo = blocks[real], silo[real]
        if bool((ids < 0).any()) or not bool(
                (torch.bincount(ids, minlength=n) == 1).all()):
            raise ValueError("the silos' agent lists are not a partition of 0..n-1")
        owner = torch.empty(n, dtype=I64, device=dev)
        owner[ids] = silo
        cols = self.eq4.indices
        cross = owner[self.rows] != owner[cols]
        self.owner = owner
        # Edge e of row i reads thetas[cross[e]]: its own silo's row (0) or q (1).
        self.eq4.delays = cross.to(I64)
        self.border = torch.zeros(n, dtype=torch.bool, device=dev)
        self.border[cols[cross]] = True
        self.border_keys = torch.unique(owner[cols[cross]] * n + cols[cross])
        self.halo_keys = torch.unique(owner[self.rows[cross]] * n + cols[cross])
        return self

    def publish(self, theta: torch.Tensor, e: torch.Tensor):
        """``(q, e_new)`` of one slot from the start-of-slot models ``theta``
        and residuals ``e`` (both (n, p) float32, agent order): q (n, p)
        float32 holds the bf16 payload at the border agents and theta
        elsewhere (what a reader of that agent sees), e_new the new
        residual at the border agents and ``e`` elsewhere."""
        b = self.border.to(theta.device)
        v = theta.to(torch.float32) + e.to(torch.float32)
        q = bf16_round(v)
        keep = b[:, None]
        return torch.where(keep, q, theta), torch.where(keep, v - q, e)

    def step(self, rows, theta: torch.Tensor, q: torch.Tensor, dtype=torch.float64):
        """The Eq. 4 rows (len(rows), p) of the agents ``rows`` in ``dtype``:
        own-silo neighbours read from ``theta``, other silos' from ``q``."""
        return self.eq4.step(rows, [theta, q], dtype=dtype)

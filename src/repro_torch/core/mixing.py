"""Neighbour-sum operator ``sum_j W_ij Theta_j`` with dense/sparse dispatch.

Port of ``repro.core.mixing`` (``MixOp``, ``mix_op``; the sharded halo
exchange comes with a later slice). Every algorithm reduces its graph
traffic to a few shapes:

* ``all``: the full neighbour sum for every agent — (n, p) -> (n, p);
* ``row``: one agent's neighbour sum — (n, p), i -> (p,);
* ``gather_rows``: the neighbour sums of a batch of rows, the engine's
  woken-rows path — (B,) -> (B, p).

:func:`mix_op` picks the dense (n, n) matrix below
:func:`repro_torch.core.graph.sparse_crossover` agents and padded CSR
neighbour tables at or above it. On a CUDA float32 Theta, ``all`` runs
the hand-written ``graph_mix`` (dense) or ``sparse_mix`` (sparse) kernel
and the sparse ``gather_rows`` runs ``sparse_mix`` on the gathered
tables; float64, or a CPU tensor, stays on plain PyTorch (the reference
likewise refuses to downcast its float64 paths). The reference's further
bound on the agent count (``REPRO_KERNEL_MAX_N``) is a TPU VMEM limit the
CUDA kernels do not have, so it is not carried over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import as_csr, dense_weights, sparse_crossover
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def kernel_auto(Theta) -> bool:
    """Whether the CUDA kernels serve ``Theta``: on a CUDA device, float32."""
    return Theta.device.type == "cuda" and Theta.dtype == torch.float32


@dataclasses.dataclass(frozen=True, eq=False)
class MixOp:
    """Dense or sparse neighbour-sum operator over host (numpy) tables."""

    kind: str  # "dense" | "sparse"
    n: int
    W: np.ndarray | None = None  # (n, n) — dense only
    idx: np.ndarray | None = None  # (n, K) padded neighbour indices — sparse only
    w: np.ndarray | None = None  # (n, K) padded neighbour weights — sparse only
    rows: np.ndarray | None = None  # (nnz,) COO rows, sorted — sparse only
    cols: np.ndarray | None = None  # (nnz,)
    vals: np.ndarray | None = None  # (nnz,)

    def table(self, name: str, device, dtype) -> torch.Tensor:
        """Host table ``name`` on ``device`` in ``dtype``, made once and kept."""
        cache = self.__dict__.setdefault("_tables", {})
        key = (name, resolve_device(device), dtype)
        if key not in cache:
            host = np.ascontiguousarray(getattr(self, name))
            cache[key] = torch.as_tensor(host).to(device=key[1], dtype=dtype)
        return cache[key]

    def all(self, Theta, use_kernel: bool | None = None):
        """sum_j W_ij Theta_j for every agent: (n, p) -> (n, p).

        ``use_kernel``: None runs the CUDA kernel for a CUDA float32 Theta;
        True asks for the kernel wrapper (its plain version on a CPU
        tensor); False keeps plain PyTorch.
        """
        dev = Theta.device
        if use_kernel is None:
            use_kernel = kernel_auto(Theta)
        if use_kernel:
            Theta = Theta.contiguous()
            if self.kind == "dense":
                return ops.graph_mix(self.table("W", dev, torch.float32), Theta)
            return ops.sparse_mix(
                self.table("idx", dev, torch.int32), self.table("w", dev, torch.float32), Theta
            )
        if self.kind == "dense":
            return self.table("W", dev, Theta.dtype) @ Theta
        cols = self.table("cols", dev, torch.long)
        contrib = self.table("vals", dev, Theta.dtype)[:, None] * Theta[cols]
        out = torch.zeros_like(Theta)
        return out.index_add_(0, self.table("rows", dev, torch.long), contrib)

    def row(self, Theta, i):
        """sum_j W_ij Theta_j for one agent i: -> (p,)."""
        dev = Theta.device
        if self.kind == "dense":
            return self.table("W", dev, Theta.dtype)[i] @ Theta
        cols_i = self.table("idx", dev, torch.long)[i]  # (K,)
        w_i = self.table("w", dev, Theta.dtype)[i]  # (K,)
        return torch.sum(w_i[:, None] * Theta[cols_i], dim=0)

    def gather_rows(self, Theta, idx, use_kernel: bool | None = None):
        """Batched neighbour sums for a row subset: (B,) indices -> (B, p).

        The engine's super-tick path: only the woken agents' neighbourhoods
        are mixed. ``idx`` may hold the padding sentinel n, which is clamped
        to row n-1 for the gather (callers drop those rows on scatter).
        """
        dev = Theta.device
        if use_kernel is None:
            use_kernel = kernel_auto(Theta)
        safe = torch.clamp(idx.long(), max=self.n - 1)
        if self.kind == "dense":
            return self.table("W", dev, Theta.dtype)[safe] @ Theta
        if use_kernel:
            cols = self.table("idx", dev, torch.int32)[safe]  # (B, K)
            w = self.table("w", dev, torch.float32)[safe]  # (B, K)
            return ops.sparse_mix(cols, w, Theta.contiguous())
        cols = self.table("idx", dev, torch.long)[safe]
        w = self.table("w", dev, Theta.dtype)[safe]
        return torch.einsum("bk,bkp->bp", w, Theta[cols])

    def pairwise_smoothness(self, Theta):
        """1/2 sum_{i<j} W_ij ||Theta_i - Theta_j||^2 (Eq. 2 first term)."""
        dev = Theta.device
        if self.kind == "dense":
            W = self.table("W", dev, Theta.dtype)
            diffs = Theta[:, None, :] - Theta[None, :, :]
            return 0.25 * torch.sum(W * torch.sum(diffs**2, dim=-1))
        rows = self.table("rows", dev, torch.long)
        cols = self.table("cols", dev, torch.long)
        d2 = torch.sum((Theta[rows] - Theta[cols]) ** 2, dim=-1)
        return 0.25 * torch.sum(self.table("vals", dev, Theta.dtype) * d2)


def mix_op(graph, mode: str = "auto") -> MixOp:
    """Build the neighbour-sum operator for a dense or CSR graph.

    ``mode="auto"`` picks dense below the crossover and sparse at or above
    it, whichever representation the caller holds.
    """
    if mode == "auto":
        mode = "sparse" if graph.n >= sparse_crossover() else "dense"
    if mode == "dense":
        return MixOp(kind="dense", n=graph.n, W=dense_weights(graph))
    if mode != "sparse":
        raise ValueError(f"unknown mix mode {mode!r}")
    csr = as_csr(graph)
    idx, w = csr.padded_neighbors()
    return MixOp(
        kind="sparse",
        n=csr.n,
        idx=idx,
        w=w,
        rows=csr.row_ids(),
        cols=csr.indices,
        vals=csr.data,
    )

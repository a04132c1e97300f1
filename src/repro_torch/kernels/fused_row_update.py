"""The fused woken-row super-tick update: gather + mix + Eq. 4 + scatter.

Port of ``repro/kernels/fused_row_update.py::fused_row_update`` (quadratic
loss, optional per-point L1 clip, additive gradient noise). For each
woken row ``b`` with ``rows[b] < limit`` it replaces ``theta[rows[b]]``
by the Eq. 4 step computed from the start-of-call slab; rows at or above
``limit`` are sentinels, never written.

Unlike the reference, which returns a new slab, both versions here
update ``theta`` IN PLACE and return it — saving the (nt, p) copy each
super-tick. They keep the reference's snapshot rule: every new row is
computed from the slab as it was before any row is written, even when a
woken row is another woken row's neighbour. The CUDA kernel
(``csrc/fused_row_update.cu``, a warp per woken row) computes the new
rows into a (B, p) scratch, then scatters them. The valid rows of one
call must be distinct. :func:`row_plan` plans its launch here, in Python,
so the CPU tests reach it. :func:`fused_row_update_plain` is the plain
PyTorch version: the CPU path and the kernel's yardstick.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

# Largest feature width / points per agent the CUDA kernel takes (a row
# and its residuals sit in shared memory); csrc/fused_row_update.cu
# kMaxP / kMaxM.
MAX_P = 1024
MAX_M = 2048
PASS_COLS = 128  # columns a warp covers in one pass: 4 a lane
ROWS_PER_BLOCK = 4  # woken rows (warps) a block


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """The launch: ``blocks`` blocks of ``ROWS_PER_BLOCK`` warps, a warp a
    woken row; a row in ``passes`` passes of ``PASS_COLS`` columns held in
    registers; 16-byte loads where ``vec``."""

    passes: int
    vec: bool
    blocks: int

    def rows(self, block: int, B: int) -> range:
        """The woken rows block ``block`` computes (one a warp)."""
        return range(block * ROWS_PER_BLOCK, min((block + 1) * ROWS_PER_BLOCK, B))


def row_plan(B: int, p: int, tensors) -> RowPlan:
    """The launch for B woken rows of width p: as few passes (1, 2, 4 or
    8) as cover p, and the float4 instance exactly when p % 4 == 0 and
    every one of ``tensors`` (Theta, X, noise: the (., p) rows the kernel
    reads; None is skipped) starts on a 16-byte boundary."""
    if not 0 <= p <= MAX_P:
        raise ValueError(f"the fused kernel takes p <= {MAX_P}, got p={p}")
    passes = next(n for n in (1, 2, 4, 8) if n * PASS_COLS >= p)
    vec = p % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)
    return RowPlan(passes=passes, vec=vec, blocks=-(-B // ROWS_PER_BLOCK))


def fused_row_update_plain(rows, idx, w, coef, X, y, mask, noise, theta, limit, clip=None):
    """Same contract as the kernel; the arithmetic runs in float32.

    rows (B,) slab rows (>= limit: sentinel); idx/w (B, K) row-gathered
    neighbour tables over the slab; coef (B, 4+) per-row
    ``[alpha, deg, mu*conf, 2*lam]``; X (B, m, p), y/mask (B, m); noise
    (B, p) or None (zeros); theta (nt, p), updated in place and returned.
    """
    f32 = torch.float32
    nt = theta.shape[0]
    t32 = theta.to(f32)
    rows = rows.long()
    tr = t32[rows.clamp(max=nt - 1)]  # sentinels clamp for the gather
    neigh = torch.einsum("bk,bkp->bp", w.to(f32), t32[idx.long()])
    X32 = X.to(f32)
    resid = 2.0 * (torch.einsum("bmp,bp->bm", X32, tr) - y.to(f32))
    if clip is not None:
        norms = resid.abs() * X32.abs().sum(dim=-1)
        resid = resid * torch.clamp(clip / norms.clamp(min=1e-12), max=1.0)
    m32 = mask.to(f32)
    m_hat = m32.sum(dim=-1).clamp(min=1.0)
    g_sum = torch.einsum("bm,bmp->bp", resid * m32, X32)
    c32 = coef.to(f32)
    alpha, deg, cmu, lam2 = c32[:, 0:1], c32[:, 1:2], c32[:, 2:3], c32[:, 3:4]
    grads = g_sum / m_hat[:, None] + lam2 * tr
    if noise is not None:
        grads = grads + noise.to(f32)
    new = (1.0 - alpha) * tr + alpha * (neigh / deg - cmu * grads)
    keep = (rows >= 0) & (rows < limit)
    theta[rows[keep]] = new[keep].to(theta.dtype)
    return theta


_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)


def fused_row_update_cuda(rows, idx, w, coef, X, y, mask, noise, theta, limit, clip=None):
    """Launch the CUDA kernel on contiguous CUDA tensors: rows/idx int32,
    everything else float32, ``p <= MAX_P``, ``m <= MAX_M``,
    ``0 < limit <= nt``. Updates ``theta`` in place and returns it."""
    dev = theta.device
    f32 = torch.float32
    _build.check_tensor(theta, "theta", dtype=f32, ndim=2, device=dev)
    nt, p = theta.shape
    _build.check_tensor(rows, "rows", dtype=torch.int32, ndim=1, device=dev)
    B = rows.shape[0]
    _build.check_tensor(idx, "idx", dtype=torch.int32, ndim=2, device=dev)
    K = idx.shape[1]
    if idx.shape[0] != B:
        raise ValueError(f"idx must have {B} rows, got shape {tuple(idx.shape)}")
    _build.check_tensor(w, "w", dtype=f32, ndim=2, device=dev, shape=(B, K))
    _build.check_tensor(coef, "coef", dtype=f32, ndim=2, device=dev)
    if coef.shape[0] != B or coef.shape[1] < 4:
        raise ValueError(f"coef must be ({B}, 4+), got {tuple(coef.shape)}")
    _build.check_tensor(X, "X", dtype=f32, ndim=3, device=dev)
    m = X.shape[1]
    if X.shape != (B, m, p):
        raise ValueError(f"X must be ({B}, m, {p}), got {tuple(X.shape)}")
    _build.check_tensor(y, "y", dtype=f32, ndim=2, device=dev, shape=(B, m))
    _build.check_tensor(mask, "mask", dtype=f32, ndim=2, device=dev, shape=(B, m))
    if noise is not None:
        _build.check_tensor(noise, "noise", dtype=f32, ndim=2, device=dev, shape=(B, p))
    if p > MAX_P or m > MAX_M:
        raise ValueError(f"the fused kernel takes p <= {MAX_P} and m <= {MAX_M}, got p={p}, m={m}")
    if not 0 < int(limit) <= nt:
        raise ValueError(f"limit must lie in (0, {nt}], got {limit}")
    plan = row_plan(B, p, (theta, X, noise))
    scratch = torch.empty((B, p), dtype=f32, device=dev)
    fn = _build.bind("fused_row_update", "fused_row_update_launch", _ARGTYPES)
    with _build.on_device(dev):
        status = fn(
            rows.data_ptr(), idx.data_ptr(), w.data_ptr(), coef.data_ptr(), coef.shape[1],
            X.data_ptr(), y.data_ptr(), mask.data_ptr(),
            None if noise is None else noise.data_ptr(),
            theta.data_ptr(), scratch.data_ptr(),
            B, K, m, p, int(limit),
            0.0 if clip is None else float(clip), 0 if clip is None else 1,
            plan.passes, int(plan.vec), _build.stream_of(dev),
        )
    _build.finish_launch("fused_row_update", status)
    return theta

"""Sparse neighbour mixing over padded neighbour tiles.

``Y[r] = sum_k w[r, k] * Theta[idx[r, k]]`` in float32 — the CSR
neighbour sum in padded (R, K) form (pad entries carry weight 0). R == n
is the full neighbour sum; R == B is the woken-rows batch of one engine
super-tick. Port of ``repro/kernels/sparse_mix.py::sparse_mix``; the CUDA
kernel is ``csrc/sparse_mix.cu``, whose header says how it is laid out.
It walks only a row's entries of nonzero weight, so a non-finite Theta
row reached only at weight 0 leaves the output finite where the plain
version's is NaN (``src/repro_torch/DEVIATIONS.md``).

:func:`sparse_mix_plain` is the plain PyTorch version of the same
function: the CPU path and the kernel's yardstick on the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def sparse_mix_plain(idx, w, theta):
    """idx (R, K) int, w (R, K), theta (n, p) -> (R, p) float32."""
    gathered = theta.to(torch.float32)[idx.long()]  # (R, K, p)
    return torch.einsum("rk,rkp->rp", w.to(torch.float32), gathered)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def sparse_mix_cuda(idx, w, theta):
    """Launch the CUDA kernel: idx (R, K) int32, w (R, K) float32 and theta
    (n, p) float32, all contiguous on one CUDA device. idx entries must
    lie in [0, n). Entries of weight 0 are skipped (see csrc/sparse_mix.cu).
    theta may start at any storage offset: the float4 instance runs where
    ``_build.vector_loads`` allows it, the scalar one elsewhere."""
    dev = theta.device
    _build.check_tensor(theta, "theta", dtype=torch.float32, ndim=2, device=dev)
    _build.check_tensor(idx, "idx", dtype=torch.int32, ndim=2, device=dev)
    R, K = idx.shape
    _build.check_tensor(w, "w", dtype=torch.float32, ndim=2, device=dev, shape=(R, K))
    p = theta.shape[1]
    out = torch.empty((R, p), dtype=torch.float32, device=dev)
    fn = _build.bind("sparse_mix", "sparse_mix_launch", _ARGTYPES)
    with _build.on_device(dev):
        status = fn(idx.data_ptr(), w.data_ptr(), theta.data_ptr(), out.data_ptr(),
                    R, K, p, int(_build.vector_loads(theta)), _build.stream_of(dev))
    _build.finish_launch("sparse_mix", status)
    return out

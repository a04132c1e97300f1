"""Public kernel wrappers: the CUDA kernel for a CUDA tensor, the plain
version for a CPU tensor.

The choice follows only where the tensor lies. A CUDA tensor launches the
kernel, or raises if the kernel cannot take it (type, shape, layout); it
never falls back to the plain version. Each launch counts in
:func:`launch_counts`, which a run resets and reads to show its path
went through the kernels.
"""

from __future__ import annotations

from repro_torch.kernels._build import launch_counts, reset_launch_counts
from repro_torch.kernels.dp_clip_noise import dp_clip_noise_cuda, dp_clip_noise_plain
from repro_torch.kernels.fused_row_update import fused_row_update_cuda, fused_row_update_plain
from repro_torch.kernels.graph_mix import graph_mix_cuda, graph_mix_plain
from repro_torch.kernels.sparse_mix import sparse_mix_cuda, sparse_mix_plain

__all__ = [
    "dp_clip_noise",
    "fused_row_update",
    "graph_mix",
    "launch_counts",
    "reset_launch_counts",
    "sparse_mix",
]


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def sparse_mix(idx, w, theta):
    """Y[r] = sum_k w[r,k] theta[idx[r,k]]. idx/w (R, K), theta (n, p) -> (R, p) f32.

    R = n is the full neighbour sum; R = B, on tables gathered to the
    woken rows, is the engine's woken-rows mix."""
    if _on_cpu(theta):
        return sparse_mix_plain(idx, w, theta)
    return sparse_mix_cuda(idx, w, theta)


def graph_mix(mix, theta):
    """Y = mix @ theta in full float32. mix (n, n), theta (n, p) -> (n, p) f32."""
    if _on_cpu(theta):
        return graph_mix_plain(mix, theta)
    return graph_mix_cuda(mix, theta)


def fused_row_update(rows, idx, w, coef, X, y, mask, noise, theta, limit, clip=None):
    """Fused woken-row super-tick over the (nt, p) slab ``theta``, IN PLACE.

    rows (B,) slab rows (sentinel >= limit skipped; valid rows distinct);
    idx/w (B, K) row-gathered neighbour tables over the slab; coef (B, 4)
    per-row [alpha, deg, mu*conf, 2*lam]; X (B, m, p), y/mask (B, m);
    noise (B, p) or None. Returns ``theta``. Quadratic loss only — see
    :mod:`repro_torch.kernels.fused_row_update`.
    """
    if _on_cpu(theta):
        return fused_row_update_plain(rows, idx, w, coef, X, y, mask, noise, theta, limit, clip)
    return fused_row_update_cuda(rows, idx, w, coef, X, y, mask, noise, theta, limit, clip)


def dp_clip_noise(grads, noise, clip, noise_scale):
    """Per-example L2 clip to ``clip``, mean over the N rows, plus
    ``noise_scale * noise``. grads (N, D) float32 or bfloat16, noise (D,)
    standard draws -> (D,) float32. Reached only from here, as in the
    reference: no engine path calls it."""
    if _on_cpu(grads):
        return dp_clip_noise_plain(grads, noise, clip, noise_scale)
    return dp_clip_noise_cuda(grads, noise, clip, noise_scale)

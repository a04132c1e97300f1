"""Fused per-example clip -> mean -> noise: the DP gradient aggregation.

Port of ``repro/kernels/dp_clip_noise.py::dp_clip_noise``. For (N, D)
per-example gradients it scales each row by ``min(1, C / ||g_i||_2)``,
averages over the N rows and adds ``noise_scale * noise``:

    out = (1/N) sum_i min(1, C / max(||g_i||, 1e-12)) g_i + noise_scale * noise

in float32, for float32 or bfloat16 gradients. As in the reference, no
engine path calls it: it is reached through ``ops.dp_clip_noise`` only
(the engine's private step clips each data point's gradient in L1 inside
the Eq. 4 gradient instead, ``Objective.clip``).

The CUDA kernel is ``csrc/dp_clip_noise.cu`` (two launches: per-row clip
factors, then column tiles summed in a fixed order, so results repeat
from run to run); :func:`dp_clip_noise_plain` is the plain PyTorch
version: the CPU path and the kernel's yardstick.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def dp_clip_noise_plain(grads, noise, clip, noise_scale):
    """grads (N, D), noise (D,) -> (D,) float32."""
    f32 = torch.float32
    g32 = grads.to(f32)
    nrm = torch.sqrt(torch.sum(g32 * g32, dim=1).clamp(min=1e-24))
    scale = torch.clamp(float(clip) / nrm.clamp(min=1e-12), max=1.0)
    return (g32 * scale[:, None]).sum(dim=0) / g32.shape[0] + float(noise_scale) * noise.to(f32)


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_float] * 3 + [ctypes.c_void_p]
)


def dp_clip_noise_cuda(grads, noise, clip, noise_scale):
    """Launch the CUDA kernel: grads (N, D) float32 or bfloat16 and noise
    (D,) float32, contiguous, on one CUDA device, N >= 1 and D >= 1."""
    dev = grads.device
    if grads.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grads must be float32 or bfloat16, got {grads.dtype}")
    _build.check_tensor(grads, "grads", dtype=grads.dtype, ndim=2, device=dev)
    N, D = grads.shape
    if N < 1 or D < 1:
        raise ValueError(f"grads must have at least one row and column, got {(N, D)}")
    _build.check_tensor(noise, "noise", dtype=torch.float32, ndim=1, device=dev, shape=(D,))
    out = torch.empty(D, dtype=torch.float32, device=dev)
    scratch = torch.empty(N, dtype=torch.float32, device=dev)
    fn = _build.bind("dp_clip_noise", "dp_clip_noise_launch", _ARGTYPES)
    with _build.on_device(dev):
        status = fn(grads.data_ptr(), int(grads.dtype == torch.bfloat16), noise.data_ptr(),
                    out.data_ptr(), scratch.data_ptr(), N, D, float(clip), float(noise_scale),
                    float(N), _build.stream_of(dev))
    _build.finish_launch("dp_clip_noise", status)
    return out

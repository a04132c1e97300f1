"""Dense neighbour mixing ``Y = A @ Theta`` in full float32.

Port of ``repro/kernels/graph_mix.py::graph_mix``, which multiplies at
``Precision.HIGHEST``; the CUDA kernel ``csrc/graph_mix.cu`` is a tiled
SGEMM on IEEE float32 FMAs (no TF32). :func:`graph_mix_plain` is the
plain PyTorch version: the CPU path and the kernel's yardstick.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def graph_mix_plain(mix, theta):
    """mix (n, n), theta (n, p) -> (n, p) float32."""
    return mix.to(torch.float32) @ theta.to(torch.float32)


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def graph_mix_cuda(mix, theta):
    """Launch the CUDA kernel: mix (n, n) and theta (n, p), float32,
    contiguous, on one CUDA device."""
    dev = theta.device
    _build.check_tensor(theta, "theta", dtype=torch.float32, ndim=2, device=dev)
    n, p = theta.shape
    _build.check_tensor(mix, "mix", dtype=torch.float32, ndim=2, device=dev, shape=(n, n))
    out = torch.empty((n, p), dtype=torch.float32, device=dev)
    fn = _build.bind("graph_mix", "graph_mix_launch", _ARGTYPES)
    with _build.on_device(dev):
        status = fn(mix.data_ptr(), theta.data_ptr(), out.data_ptr(), n, p, _build.stream_of(dev))
    _build.finish_launch("graph_mix", status)
    return out

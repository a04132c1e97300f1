"""Dense neighbour mixing ``Y = A @ Theta`` in full float32.

Port of ``repro/kernels/graph_mix.py::graph_mix``, which multiplies at
``Precision.HIGHEST``; the CUDA kernel ``csrc/graph_mix.cu`` is a
register-tiled, split-K SGEMM on IEEE float32 FMAs (no TF32), whose
header says how it is laid out. :func:`graph_mix_plain` is the plain
PyTorch version: the CPU path and the kernel's yardstick.

The launch is planned here, in Python, so the CPU tests reach it:
:func:`split_plan` cuts the contraction into parts that fill the card,
and ``_build.vector_loads`` picks the 16-byte or the 4-byte copies of
Theta.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

# The kernel's tile (csrc/graph_mix.cu): 128 x 128 outputs a block, the
# contraction staged 16 steps at a time, one block on an SM.
TILE_M = 128
TILE_N = 128
TILE_K = 16
MIN_SPLIT = 64  # fewest contraction steps worth a part of its own


def graph_mix_plain(mix, theta):
    """mix (n, n), theta (n, p) -> (n, p) float32."""
    return mix.to(torch.float32) @ theta.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The contraction [0, n) cut into ``splits`` parts of ``chunk`` steps
    (the last one shorter), each a multiple of ``TILE_K`` long."""

    splits: int
    chunk: int

    def bounds(self, n: int) -> list[tuple[int, int]]:
        return [(s * self.chunk, min((s + 1) * self.chunk, n)) for s in range(self.splits)]


def split_plan(n: int, p: int, sms: int) -> SplitPlan:
    """How many parts to cut the n-long contraction into: as many as fill
    the card in one wave of one block an SM (``sms // output tiles``),
    none shorter than ``MIN_SPLIT`` steps. One part means no second
    launch."""
    tiles = -(-n // TILE_M) * -(-p // TILE_N)
    splits = max(1, min(sms // tiles, -(-n // MIN_SPLIT)))
    steps = -(-n // TILE_K)
    chunk = -(-steps // splits) * TILE_K
    return SplitPlan(splits=-(-n // chunk), chunk=chunk)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def graph_mix_cuda(mix, theta):
    """Launch the CUDA kernel: mix (n, n) and theta (n, p), float32,
    contiguous, on one CUDA device."""
    dev = theta.device
    _build.check_tensor(theta, "theta", dtype=torch.float32, ndim=2, device=dev)
    n, p = theta.shape
    _build.check_tensor(mix, "mix", dtype=torch.float32, ndim=2, device=dev, shape=(n, n))
    plan = split_plan(max(n, 1), max(p, 1),
                      torch.cuda.get_device_properties(dev).multi_processor_count)
    out = torch.empty((n, p), dtype=torch.float32, device=dev)
    scratch = (torch.empty((plan.splits, n, p), dtype=torch.float32, device=dev)
               if plan.splits > 1 else None)
    fn = _build.bind("graph_mix", "graph_mix_launch", _ARGTYPES)
    with _build.on_device(dev):
        status = fn(mix.data_ptr(), theta.data_ptr(), out.data_ptr(),
                    scratch.data_ptr() if scratch is not None else None, n, p,
                    plan.splits, plan.chunk, int(_build.vector_loads(theta)),
                    _build.stream_of(dev))
    _build.finish_launch("graph_mix", status)
    return out

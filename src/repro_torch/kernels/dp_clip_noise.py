"""Fused per-example clip -> mean -> noise: the DP gradient aggregation.

Port of ``repro/kernels/dp_clip_noise.py::dp_clip_noise``. For (N, D)
per-example gradients it scales each row by ``min(1, C / ||g_i||_2)``,
averages over the N rows and adds ``noise_scale * noise``:

    out = (1/N) sum_i min(1, C / max(||g_i||, 1e-12)) g_i + noise_scale * noise

in float32, for float32 or bfloat16 gradients. As in the reference, no
engine path calls it: it is reached through ``ops.dp_clip_noise`` only
(the engine's private step clips each data point's gradient in L1 inside
the Eq. 4 gradient instead, ``Objective.clip``).

The CUDA kernel is ``csrc/dp_clip_noise.cu``: each block holds a few
rows (or, past 8192 float32 columns, a thread-block cluster holds them,
exchanging partial norms through distributed shared memory) in
registers, clips them and sums them into a partial row of column sums;
where there are several row blocks a dependent launch adds the partial
rows in a fixed order, so results repeat from run to run.
:func:`clip_plan` plans the launch; :func:`dp_clip_noise_plain` is the
plain PyTorch version: the CPU path and the kernel's yardstick.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

THREADS = 256  # threads a block; csrc/dp_clip_noise.cu kThreads
MAX_ROWS = 8  # rows a block takes at most; kRows
SLOTS = 8  # 16-byte words of grads a thread holds in registers; kSlots
MAX_CLUSTER = 8  # blocks a cluster spans across D at most; kMaxCluster
COMBINE_COLS = 32  # columns a combine block sums; kCombineCols


@dataclasses.dataclass(frozen=True)
class ClipPlan:
    """The launch: a grid of ``row_blocks`` x ``cluster`` blocks of
    ``THREADS`` threads; block (y, x) takes rows ``rows_of(y)`` and columns
    ``columns_of(x)`` in ``passes`` passes of ``THREADS * per`` columns
    (``per`` elements a load: 16 bytes where ``vec``, else one); the
    ``cluster`` blocks of a row block form one thread-block cluster. With
    ``row_blocks > 1`` a combine launch of ``combine_blocks`` blocks sums
    the (row_blocks, D) partial column sums."""

    N: int
    D: int
    vec: bool
    per: int
    passes: int
    cluster: int
    rows: int

    @property
    def row_blocks(self) -> int:
        return -(-self.N // self.rows)

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.cluster

    @property
    def resident(self) -> bool:
        """Whether a block holds its tile in registers, ``rows * passes``
        16-byte words a thread (grads read once); else it streams its
        columns twice."""
        return self.passes in (1, 2, 4, 8) and self.rows * self.passes <= SLOTS

    @property
    def combine_blocks(self) -> int:
        return -(-self.D // COMBINE_COLS) if self.row_blocks > 1 else 0

    @property
    def partial_floats(self) -> int:
        """The float32 scratch the combine reads: (row_blocks, D), or none."""
        return self.row_blocks * self.D if self.row_blocks > 1 else 0

    def rows_of(self, row_block: int) -> range:
        return range(row_block * self.rows, min((row_block + 1) * self.rows, self.N))

    def columns_of(self, col_block: int) -> range:
        span = self.passes * THREADS * self.per
        return range(min(col_block * span, self.D), min((col_block + 1) * span, self.D))


@functools.lru_cache(maxsize=256)
def clip_plan(N: int, D: int, itemsize: int, vec: bool) -> ClipPlan:
    """The launch for (N, D) gradients of ``itemsize`` bytes, read 16 bytes
    at a time where ``vec``.

    A block takes ``passes`` (1, 2, 4 or 8) passes of ``THREADS * per``
    columns and ``SLOTS // passes`` rows, so its tile fills the ``SLOTS``
    words a thread holds in registers and grads is read once; a cluster of
    ``ceil(D / (passes * THREADS * per))`` blocks spans the row. The plan
    takes the smallest such cluster (one block where a row fits eight
    passes), then the fewest passes: on the H100 a cluster launch costs
    about a microsecond more for every doubling of the cluster, and more
    rows a block leave fewer partial rows to combine, which outweighed
    filling more SMs at every shape timed (``chip_smoke.py`` phase 3). A
    row wider than eight passes of a cluster of ``MAX_CLUSTER`` blocks
    cannot stay in registers: the block streams its columns twice, with
    the fewest passes a cluster of ``MAX_CLUSTER`` allows and up to
    ``MAX_ROWS`` rows."""
    if N < 1 or D < 1:
        raise ValueError(f"grads must have at least one row and column, got {(N, D)}")
    per = 16 // itemsize if vec else 1
    pass_cols = THREADS * per

    def cluster_of(passes: int) -> int:
        return -(-D // (passes * pass_cols))

    resident = [q for q in (1, 2, 4, 8) if cluster_of(q) <= MAX_CLUSTER]
    if resident:
        passes = min(resident, key=lambda q: (cluster_of(q), q))
        rows = min(SLOTS // passes, N)
    else:
        passes = -(-D // (MAX_CLUSTER * pass_cols))
        rows = min(MAX_ROWS, N)
    cluster = cluster_of(passes)
    return ClipPlan(N=N, D=D, vec=vec, per=per, passes=passes, cluster=cluster, rows=rows)


def dp_clip_noise_plain(grads, noise, clip, noise_scale):
    """grads (N, D), noise (D,) -> (D,) float32."""
    f32 = torch.float32
    g32 = grads.to(f32)
    nrm = torch.sqrt(torch.sum(g32 * g32, dim=1).clamp(min=1e-24))
    scale = torch.clamp(float(clip) / nrm.clamp(min=1e-12), max=1.0)
    return (g32 * scale[:, None]).sum(dim=0) / g32.shape[0] + float(noise_scale) * noise.to(f32)


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_float] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
)


def dp_clip_noise_cuda(grads, noise, clip, noise_scale, plan: ClipPlan | None = None):
    """Launch the CUDA kernel: grads (N, D) float32 or bfloat16 and noise
    (D,) float32, contiguous, on one CUDA device, N >= 1 and D >= 1.
    ``plan`` overrides :func:`clip_plan`'s launch (it must be for this N,
    D and alignment); every plan gives the function, each in its own
    fixed order."""
    dev = grads.device
    if grads.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grads must be float32 or bfloat16, got {grads.dtype}")
    _build.check_tensor(grads, "grads", dtype=grads.dtype, ndim=2, device=dev)
    N, D = grads.shape
    if N < 1 or D < 1:
        raise ValueError(f"grads must have at least one row and column, got {(N, D)}")
    _build.check_tensor(noise, "noise", dtype=torch.float32, ndim=1, device=dev, shape=(D,))
    if plan is None:
        plan = clip_plan(N, D, grads.element_size(), _build.vector_loads(grads))
    elif (plan.N, plan.D) != (N, D) or (plan.vec and not _build.vector_loads(grads)):
        raise ValueError(f"the plan {plan} does not fit grads {(N, D)}")
    out = torch.empty(D, dtype=torch.float32, device=dev)
    partial = (torch.empty(plan.partial_floats, dtype=torch.float32, device=dev)
               if plan.partial_floats else None)
    fn = _build.bind("dp_clip_noise", "dp_clip_noise_launch", _ARGTYPES)
    with _build.on_device(dev):
        status = fn(grads.data_ptr(), int(grads.dtype == torch.bfloat16), noise.data_ptr(),
                    out.data_ptr(), None if partial is None else partial.data_ptr(), N, D,
                    float(clip), float(noise_scale), float(N), int(plan.vec), plan.passes,
                    plan.cluster, plan.rows, plan.row_blocks, _build.stream_of(dev))
    _build.finish_launch("dp_clip_noise", status)
    return out

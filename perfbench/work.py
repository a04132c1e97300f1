"""The frozen yardstick: the card's peaks and the least work of the updates.

Counts come from the configuration's shapes, the graph's size and the
updates a run applied, never from the program's implementation: each input
byte that the updates need is read once per slot (or round) and each
output byte written once; float32 operations are the ones the step's
arithmetic needs. A later change to the program does not change them.

Peaks: NVIDIA's data sheet for one H100 SXM (HBM3 at 3.35 TB/s, 67 TFLOP/s
float32 outside the tensor cores), at the full 700 W power limit.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F32 = 4  # bytes
INDEX = 4  # bytes of a neighbour index (int32) or weight (float32)


def distinct(n: int, picks: float) -> float:
    """Expected distinct agents among ``picks`` uniform draws of ``n``."""
    return -n * math.expm1(picks * math.log1p(-1.0 / n))


def update_flops(cfg: dict, deg: float) -> float:
    """Float32 operations of one Eq. 4 (or Eq. 6) block step of width p with
    m points and ``deg`` neighbours: the neighbour sum (2 deg p), the
    residuals and the gradient (4 m p), the regulariser, step and mix (8 p);
    with a clip the point gradients' L1 norms and scaling (2 m p), with
    privacy the noise added (2 p)."""
    p, m = cfg["p"], cfg["m"]
    f = 2.0 * deg * p + 4.0 * m * p + 8.0 * p
    if cfg.get("private"):
        f += 2.0 * p + (2.0 * m * p if cfg["private"].get("clip") else 0.0)
    return f


def slot_work(cfg: dict, n: int, nnz: int, updates: float) -> tuple:
    """(bytes, flops) that ``updates`` block steps of one slot need: the
    distinct model rows they read (each agent's own row and its neighbours'),
    each agent's points, targets, neighbour list (index and weight) and four
    constants, and the rows written."""
    p, m = cfg["p"], cfg["m"]
    deg = nnz / n
    rows = distinct(n, updates * (deg + 1.0))
    nbytes = rows * p * F32 + updates * (m * p * F32 + m * F32 + deg * 2 * INDEX + 4 * F32
                                         + p * F32)
    return nbytes, updates * update_flops(cfg, deg)


def round_work(cfg: dict, n: int, nnz: int) -> tuple:
    """(bytes, flops) of one synchronous round: the (n, p) models read once,
    the CSR graph (indices, weights, row offsets), every agent's points,
    targets and four constants, and the (n, p) models written."""
    p, m = cfg["p"], cfg["m"]
    nbytes = (2 * n * p * F32 + nnz * 2 * INDEX + (n + 1) * 8 + n * (m * p * F32 + m * F32)
              + n * 4 * F32)
    return nbytes, n * update_flops(cfg, nnz / n)


def mix_work(cfg: dict, n: int, nnz: int) -> tuple:
    """(bytes, flops) of the full neighbour sum sum_j W_ij theta_j: the (n, p)
    models read once, the CSR graph, the (n, p) sums written."""
    p = cfg["p"]
    return 2 * n * p * F32 + nnz * 2 * INDEX + (n + 1) * 8, 2.0 * nnz * p


def bound_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)

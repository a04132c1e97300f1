"""Roofline placement of one engine super-tick, from counted bytes and flops.

The port's counterpart of ``repro.roofline.supertick``. The reference
lowers the jitted chunk and parses its HLO for bytes, flops and
collective traffic. A captured CUDA graph has no such text, so this
module counts, term by term from the slot's code (``sim/engine.py``
``_slot``, ``core/mixing.py`` ``ShardedMixOp.exchange_halo``, the
kernels' own traffic as ``chip_smoke.py`` phase 3 counts it), the bytes
one super-tick must move (each tensor an operation reads, once; each it
writes, once) and the float32 operations it does, at the expected wakes
of a slot, and places them on the card's peaks:

    bound_s = max(compute_s, memory_s, collective_s)

with ``memory_s`` the bytes over the HBM rate (3.35 TB/s on the H100 SXM)
and ``compute_s`` the flops over the float32 peak without tensor cores
(67 TFLOP/s). On one card ``collective_s`` is 0: the stacked halo
exchange's publish, roll and scatter are HBM traffic, counted at the
wire's dtype. :func:`model_flops_per_supertick` is the reference's
useful-work count, unchanged, and ``useful_ratio`` its share of the
counted flops.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.graph import neighbor_counts

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def model_flops_per_supertick(engine) -> float:
    """Useful Eq. 4 FLOPs for the expected wakes of one super-tick.

    Per woken agent: ``2*m*p`` residual matvec + ``2*m*p`` gradient
    reduction + ``2*deg*p`` neighbour mix + ``~8*p`` axpy/regulariser,
    rate-weighted over agents (the reference's count, in numpy).
    """
    probs = np.asarray(engine.wake_probs, dtype=np.float64)
    p = float(engine.p)
    deg = np.zeros_like(probs)
    graph = getattr(engine.update, "graph", None)
    if graph is not None:
        deg = np.asarray(neighbor_counts(graph), dtype=np.float64)
    m = 0.0
    obj = getattr(engine.update, "obj", None)
    data = getattr(obj, "data", None)
    if data is not None and getattr(data, "X", None) is not None:
        m = float(np.asarray(data.X).shape[1])
    per_wake = 4.0 * m * p + 2.0 * deg * p + 8.0 * p
    return float(np.sum(probs * per_wake))


@dataclasses.dataclass
class SlotCount:
    """Counted bytes and float32 flops of one super-tick, by term."""

    bytes: dict  # term -> bytes moved
    flops: dict  # term -> float32 operations
    woken: float  # expected valid woken rows
    edges: float  # expected real neighbour entries of the woken rows

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes.values()))

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))


def count_slot(engine) -> SlotCount:
    """Bytes and flops of one sampled super-tick of ``engine`` (either
    engine, static topology), term by term:

    * ``wake_draws``: each O(L) uniform draw written and read, its
      probability vector read, its mask written (the wake draw, churn's
      leave and rejoin draws with the flag update, the stragglers' draw),
      L = n, or S * R on the sharded engine;
    * ``compaction``: the two int64 cumulative sums over L and their
      masks, the two batched binary searches for the B slot rows;
    * ``halo_publish``, ``halo_collective``, ``halo_scatter`` (sharded):
      the shipped rows gathered from the slab (quantized on a compressed
      wire, the error feedback read and written), the stacked pool or
      roll copied, the received rows written into the halo rows;
    * ``gathers``: the woken rows' neighbour tables and per-agent data
      (``X``, ``y``, ``mask``, the Eq. 4 constants) gathered and written;
    * ``fused_row_update`` (the fused kernel: its row inputs, the real
      neighbour rows and the woken rows read, the new rows written) or
      ``gather_mix`` (``sparse_mix`` at R = B, or the sharded einsum),
      ``row_update`` (the Eq. 4 rows) and ``scatter`` (read the old rows,
      write back B rows);
    * ``noise`` (private updates): the (B, p) draws and their scaling;
    * ``finalize``: the message degrees and counters.

    Counts use the expected woken rows, min(B, sum of wake probabilities),
    and their rate-weighted expected neighbour entries.
    """
    sharded = hasattr(engine, "part")
    p = int(engine.p)
    e = torch.empty(0, dtype=engine.dtype).element_size()
    probs = np.asarray(engine.wake_probs, dtype=np.float64)
    deg = np.asarray(neighbor_counts(engine.update.graph), dtype=np.float64)
    obj = getattr(engine.update, "obj", None)
    m = int(obj.data.X.shape[1]) if obj is not None else 0
    mix = getattr(engine.update, "mix", None)
    if sharded:
        S, R = engine.num_shards, engine.rows_per_shard
        L, B, search = S * R, S * engine.batch_size, R
        K = int(engine.part.tile_width)
    else:
        L, B, search = engine.n, engine.batch_size, engine.n
        if engine.fused:
            K = int(engine._fidx.shape[1])
        elif getattr(mix, "kind", None) == "sparse":
            K = int(mix.idx.shape[1])
        else:
            K = engine.n  # a dense row of W
    woken = min(float(B), float(probs.sum()))
    edges = woken * float(np.sum(probs * deg) / max(probs.sum(), 1e-300))
    scen = engine.scenario
    draws = 1 + (2 if scen.churn is not None else 0) + (1 if scen.straggler is not None else 0)
    b, f = {}, {}
    b["wake_draws"] = draws * 13.0 * L + (4.0 * L if scen.churn is not None else 0.0) + L
    f["wake_draws"] = draws * float(L)
    steps = math.ceil(math.log2(max(search, 2)))
    b["compaction"] = 2 * 9.0 * L + 10.0 * L + 2 * (16.0 * B + 8.0 * B * steps) + 24.0 * B
    if sharded:
        smix = engine.smix
        rows = float(engine.part.exchange_rows(engine.exchange_method))
        wire = float(engine.exchange_spec.payload_bytes_per_row(p))
        ef = 2.0 * rows * p * 4 if engine._use_ef else 0.0
        b["halo_publish"] = rows * p * e + rows * wire + ef
        b["halo_collective"] = 2.0 * rows * wire
        b["halo_scatter"] = rows * wire + rows * p * e
        if smix.dtype != "f32":
            f["halo_publish"] = 4.0 * rows * p
    consts = 4.0 * (4 + m * p + 2 * m)  # alpha, deg, conf, lam; X; y, mask
    if engine.fused:
        b["gathers"] = 2 * 8.0 * B * K + 2 * B * consts + 48.0 * B
        b["fused_row_update"] = (woken * (4 + 2 * K * 4 + 16 + m * p * 4 + 2 * m * 4)
                                 + edges * p * 4 + 2 * woken * p * 4)
        f["fused_row_update"] = 2.0 * edges * p + woken * (4.0 * m * p + 8.0 * p)
    else:
        b["gathers"] = 2 * 8.0 * B * K + 2 * B * consts
        b["gather_mix"] = 8.0 * B * K + edges * p * e + B * p * e
        f["gather_mix"] = 2.0 * edges * p
        b["row_update"] = 2 * B * p * e + B * (m * p + 2 * m) * e + B * p * e
        f["row_update"] = B * (4.0 * m * p + 8.0 * p)
        b["scatter"] = 2 * B * p * e + 3 * B * p * e + B
    if getattr(engine.update, "planned_Ti", None) is not None:
        b["noise"] = 3.0 * B * p * 4 + 8.0 * B
        f["noise"] = 2.0 * B * p
    b["finalize"] = 16.0 * B + (2.0 * L if scen.churn is not None else 0.0)
    return SlotCount(bytes=b, flops=f, woken=woken, edges=edges)


@dataclasses.dataclass
class Roofline:
    """One super-tick placed on the card's peaks (per ``steps`` slots)."""

    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_global: float
    useful_ratio: float
    steps: int = 1
    count: SlotCount | None = None


def supertick_roofline(engine, state=None, steps: int = 8, peak_flops: float = F32_FLOP_PER_S,
                       hbm_bw: float = HBM_BYTES_PER_S, link_bw: float = float("inf")) -> Roofline:
    """``steps`` super-ticks of ``engine`` on the roofline, from
    :func:`count_slot` (``state`` is accepted for the reference's
    signature: the count depends on the configuration only)."""
    steps = int(steps)
    count = count_slot(engine)
    flops = count.total_flops * steps
    nbytes = count.total_bytes * steps
    compute_s = flops / peak_flops
    memory_s = nbytes / hbm_bw
    collective_s = 0.0 / link_bw  # one card: the stacked exchange is HBM traffic
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    model_flops = model_flops_per_supertick(engine) * steps
    return Roofline(
        flops_per_device=flops, bytes_per_device=nbytes, collective_bytes_per_device=0.0,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s, dominant=dominant,
        model_flops_global=model_flops, useful_ratio=model_flops / flops if flops > 0 else 0.0,
        steps=steps, count=count,
    )


def supertick_report(
    engine,
    state=None,
    steps: int = 8,
    measured_s_per_tick: float | None = None,
    prefix: str = "roofline_supertick",
    **roofline_kw,
) -> list:
    """CSV-style ``(name, value, note)`` rows for the bench summary, under
    the reference's names: the per-super-tick bound (us) with its
    dominant term and, with a measured time per super-tick, the ``gap``
    row (measured / bound)."""
    roof = supertick_roofline(engine, state=state, steps=steps, **roofline_kw)
    bound_s = max(roof.compute_s, roof.memory_s, roof.collective_s) / max(steps, 1)
    note = (
        f"dominant={roof.dominant} compute={roof.compute_s / steps * 1e6:.3g}us "
        f"memory={roof.memory_s / steps * 1e6:.3g}us "
        f"collective={roof.collective_s / steps * 1e6:.3g}us "
        f"useful_ratio={roof.useful_ratio:.3g} us/slot"
    )
    rows = [(f"{prefix}_bound", bound_s * 1e6, note)]
    if measured_s_per_tick is not None and bound_s > 0:
        gap = measured_s_per_tick / bound_s
        rows.append(
            (
                f"{prefix}_gap",
                gap,
                f"measured {measured_s_per_tick * 1e6:.4g}us / bound "
                f"{bound_s * 1e6:.4g}us ({roof.dominant}-bound); gap = launch "
                "overhead + bubbles + unmodelled scalar work",
            )
        )
    return rows

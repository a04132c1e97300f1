"""Neighbour-sum operator ``sum_j W_ij Theta_j`` with dense/sparse dispatch.

Port of ``repro.core.mixing``: ``MixOp`` and ``mix_op``, and the sharded
engine's halo exchange (``ExchangeSpec``, ``ShardedMixOp``,
``sharded_mix_op``). Every algorithm reduces its graph traffic to a few
shapes:

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
import warnings

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


_EXCHANGE_METHODS = ("all_gather", "p2p", "auto")
_EXCHANGE_DTYPES = ("f32", "bf16", "int8")

# The bare-string deprecation fires once per process, not once per engine,
# as in the reference.
_warned_bare_exchange_string = False


@dataclasses.dataclass(frozen=True)
class ExchangeSpec:
    """Typed halo-exchange configuration of the sharded engine.

    The reference's spec, unchanged: ``method`` picks the collective
    (``"all_gather"`` replicated border pool, ``"p2p"`` one ring shift per
    offset, ``"auto"`` by the partition's measured cut); ``dtype`` the
    payload element type (``"f32"`` exact, ``"bf16"`` half the bytes,
    ``"int8"`` a quarter plus one float32 scale per row, ``max|row| /
    127``); ``error_feedback`` carries a per-border-row residual
    accumulator in :class:`repro_torch.sim.ShardedSimState` (``ef``), so
    the quantization error re-enters the next slot's payload. Bare
    strings coerce through :meth:`coerce` with a ``DeprecationWarning``;
    :meth:`from_string` reads the CLI form ``"p2p:bf16:ef"``.
    """

    method: str = "auto"
    dtype: str = "f32"
    error_feedback: bool = False

    def __post_init__(self):
        if self.method not in _EXCHANGE_METHODS:
            raise ValueError(
                f"unknown exchange method {self.method!r} (use one of {_EXCHANGE_METHODS})"
            )
        if self.dtype not in _EXCHANGE_DTYPES:
            raise ValueError(
                f"unknown exchange dtype {self.dtype!r} (use one of {_EXCHANGE_DTYPES})"
            )
        if self.error_feedback and self.dtype == "f32":
            raise ValueError(
                "error_feedback has no effect on the lossless f32 wire format; "
                "pick dtype='bf16' or 'int8'"
            )

    @classmethod
    def from_string(cls, spec: str) -> "ExchangeSpec":
        """Parse the CLI form ``method[:dtype[:ef]]``, e.g. ``"p2p:bf16:ef"``."""
        parts = [s for s in str(spec).split(":") if s]
        if not parts:
            raise ValueError(f"empty exchange spec {spec!r}")
        method, rest = parts[0], parts[1:]
        ef = "ef" in rest
        dtypes = [r for r in rest if r != "ef"]
        if len(dtypes) > 1 or any(r not in _EXCHANGE_DTYPES for r in dtypes):
            raise ValueError(f"bad exchange spec {spec!r} (want method[:dtype[:ef]])")
        return cls(method=method, dtype=dtypes[0] if dtypes else "f32", error_feedback=ef)

    @classmethod
    def coerce(cls, value) -> "ExchangeSpec":
        """Accept an ExchangeSpec, None (defaults), or a deprecated string."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            global _warned_bare_exchange_string
            if not _warned_bare_exchange_string:
                _warned_bare_exchange_string = True
                warnings.warn(
                    f"passing exchange={value!r} as a bare string is deprecated; "
                    f"use ExchangeSpec (e.g. ExchangeSpec.from_string({value!r}))",
                    DeprecationWarning,
                    stacklevel=3,
                )
            return cls.from_string(value)
        raise TypeError(f"exchange must be an ExchangeSpec or string, got {type(value)!r}")

    def payload_bytes_per_row(self, p: int) -> int:
        """Wire bytes per exchanged row of width p (int8 adds its f32 scale)."""
        if self.dtype == "f32":
            return 4 * p
        if self.dtype == "bf16":
            return 2 * p
        return p + 4

    def needs_error_feedback_state(self) -> bool:
        """Whether the engine must thread a (Bmax, p) accumulator per shard."""
        return self.error_feedback and self.dtype != "f32"


class StackedCollective:
    """The collective step of the halo exchange with all S shards stacked
    on one device: the (S, ...) send buffers are already the pool, so
    ``all_gather`` is the identity and ``ppermute`` by ring offset ``d``
    (shard s receives what shard ``(s - d) mod S`` sent) is a roll along
    the shard axis. A multi-process backend replaces this step alone
    (ROADMAP A9b)."""

    def all_gather(self, send):
        """(S, Bmax, ...) per-shard payloads -> the (S, Bmax, ...) pool."""
        return send

    def ppermute(self, send, offset: int):
        """(S, P, ...) buffers -> the buffers each shard receives."""
        return torch.roll(send, shifts=int(offset), dims=0)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedMixOp:
    """Shard-local neighbour sums with halo exchange over an agent partition.

    Port of the reference's operator with its S shards stacked on one
    device. The shards' rows live in one **slab** of ``S * (R + Hmax)``
    rows: all owned rows first (shard s's local row r at ``s * R + r``),
    then all halo rows (shard s's halo slot h at ``S * R + s * Hmax +
    h``). :meth:`exchange_halo` fills the halo rows from the owned ones
    in the reference's three steps, for all shards at once:

    * publish — the border rows of every shard, as (S, Bmax, p) (f32 on
      ``all_gather``, per-offset (S, P_d, p) buffers on ``p2p``); on a
      compressed wire they are quantized once per shard (``bf16`` or
      ``int8``), with the error-feedback residual ``e' = v - dq(v)``;
    * collective — :class:`StackedCollective`: the pool itself for
      ``all_gather``, a roll along S per ring offset for ``p2p``;
    * scatter — halo slots filled through ``halo_src`` (``all_gather``)
      or through the plan's ``dst`` slots with the sentinel ``Hmax``
      dropped (``p2p``).

    Both methods fill the referenced halo slots with identical copies.
    :meth:`gather_rows` is the reference's ``einsum`` over the slab, with
    the tiles remapped to slab rows (``flat_idx``). The host tables are
    numpy; :meth:`table` makes their device copies once.
    """

    n: int
    num_shards: int
    idx: np.ndarray  # (S, R, K) extended-local neighbour indices
    w: np.ndarray  # (S, R, K) weights (pad entries 0)
    border: np.ndarray  # (S, Bmax) local rows each shard publishes
    halo_src: np.ndarray  # (S, Hmax) flat index into the (S * Bmax,) border pool
    method: str = "all_gather"  # "all_gather" | "p2p"
    halo_width: int = 1  # Hmax: halo slots per shard
    p2p_offsets: tuple = ()  # ring offsets, one shift each
    p2p_send: tuple = ()  # per offset: (S, P_d) local rows to ship
    p2p_dst: tuple = ()  # per offset: (S, P_d) halo slots, sentinel Hmax
    p2p_bpos: tuple = ()  # per offset: (S, P_d) border-pool positions of sends
    dtype: str = "f32"  # wire format: "f32" | "bf16" | "int8"
    error_feedback: bool = False  # thread a (S, Bmax, p) residual accumulator
    collective: StackedCollective = dataclasses.field(default_factory=StackedCollective)

    @property
    def rows_per_shard(self) -> int:
        """R: padded rows per shard."""
        return self.idx.shape[1]

    @property
    def slab_rows(self) -> int:
        """Rows of the stacked slab: ``S * (R + Hmax)``."""
        return self.num_shards * (self.rows_per_shard + self.halo_width)

    def rebound(self, partition) -> "ShardedMixOp":
        """This operator rebuilt against another partition, the method
        pinned to this one's resolved choice (never re-run through
        ``"auto"``); wire dtype and error feedback carry over."""
        return sharded_mix_op(
            partition,
            exchange=ExchangeSpec(
                method=self.method, dtype=self.dtype, error_feedback=self.error_feedback
            ),
        )

    # -- host tables over the slab -------------------------------------------
    def _host(self, name: str) -> np.ndarray:
        """The slab-row index tables, computed once (see :meth:`table`)."""
        cache = self.__dict__.setdefault("_host_tables", {})
        if name in cache:
            return cache[name]
        S, R, H = self.num_shards, self.rows_per_shard, self.halo_width
        base = (np.arange(S, dtype=np.int64) * R)[:, None]
        if name == "flat_idx":  # (S * R, K) slab rows of the tiles
            local = self.idx.astype(np.int64)
            halo_base = (S * R + np.arange(S, dtype=np.int64) * H - R)[:, None, None]
            out = np.where(local < R, local + base[..., None], local + halo_base)
            out = out.reshape(S * R, -1)
        elif name == "flat_w":
            out = self.w.reshape(S * R, -1)
        elif name == "border_rows":  # (S * Bmax,) slab rows of the border pool
            out = (self.border.astype(np.int64) + base).reshape(-1)
        elif name == "halo_src":  # (S * Hmax,) pool row of each halo slot
            out = self.halo_src.astype(np.int64).reshape(-1)
        elif name in ("send_rows", "recv_keep", "recv_slot"):
            out = self._p2p_host()[name]
        else:
            raise KeyError(name)
        cache[name] = out
        return out

    def _p2p_host(self) -> dict:
        """The p2p plan over the slab, offsets concatenated: ``send_rows``
        (sum_d S * P_d,) the rows each offset's buffers pack (slab rows on
        the f32 wire, border-pool rows on a compressed one); ``recv_keep``
        the positions of the received rows whose slot is real (the
        sentinel ``Hmax`` dropped) and ``recv_slot`` their halo slab rows."""
        S, R, H = self.num_shards, self.rows_per_shard, self.halo_width
        Bmax = self.border.shape[1]
        shard = np.arange(S, dtype=np.int64)[:, None]
        sends, keeps, slots = [], [], []
        start = 0
        for k in range(len(self.p2p_offsets)):
            if self.dtype == "f32":
                sends.append((self.p2p_send[k].astype(np.int64) + shard * R).reshape(-1))
            else:
                # A padding entry's position may run one past its border
                # list (the receiver drops it); clamp it into the shard's
                # block, where the reference's gather clamps it.
                bpos = np.minimum(self.p2p_bpos[k].astype(np.int64), Bmax - 1)
                sends.append((bpos + shard * Bmax).reshape(-1))
            dst = self.p2p_dst[k].astype(np.int64)
            real = dst < H
            keeps.append(start + np.flatnonzero(real.reshape(-1)))
            slots.append((S * R + shard * H + dst)[real])
            start += dst.size
        cat = (lambda xs: np.concatenate(xs) if xs else np.zeros(0, np.int64))
        return {"send_rows": cat(sends), "recv_keep": cat(keeps), "recv_slot": cat(slots)}

    def table(self, name: str, device, dtype=torch.long) -> torch.Tensor:
        """Host table ``name`` on ``device`` in ``dtype``, made once and kept:
        ``flat_idx``/``flat_w`` (S * R, K), ``border_rows``, ``halo_src``
        and the p2p ``send_rows``/``recv_keep``/``recv_slot``."""
        cache = self.__dict__.setdefault("_tables", {})
        key = (name, resolve_device(device), dtype)
        if key not in cache:
            host = np.ascontiguousarray(self._host(name))
            cache[key] = torch.as_tensor(host).to(device=key[1], dtype=dtype)
        return cache[key]

    def init_error_feedback(self, p: int, dtype, device):
        """Zero (S, Bmax, p) residual accumulator (None when not threaded)."""
        if not (self.error_feedback and self.dtype != "f32"):
            return None
        return torch.zeros((self.num_shards, self.border.shape[1], p), dtype=dtype,
                           device=device)

    def _quantize(self, v):
        """Quantize border rows v (..., Bmax, p) -> (payload dict, dequantized),
        the reference's bits: bf16 rounding, or int8 with per-row
        ``scale = max(max|row| / 127, 1e-30)`` and
        ``clip(round(v / scale), -127, 127)``."""
        if self.dtype == "bf16":
            q = v.to(torch.bfloat16)
            return {"q": q}, q.to(v.dtype)
        scale = torch.amax(torch.abs(v), dim=-1, keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-30)
        q = torch.clamp(torch.round(v / scale), -127.0, 127.0).to(torch.int8)
        return {"q": q, "scale": scale}, q.to(v.dtype) * scale

    def exchange_halo(self, slab, ef=None, *, collect_stats=False):
        """Fill the halo rows of the stacked ``slab`` from its owned rows, in
        place, for all S shards (publish, collective, scatter; see the class
        docstring). ``ef``: the (S, Bmax, p) error-feedback accumulator,
        updated in place (None when not threaded). Returns the per-shard
        stats ``{"quant_err_sq", "ef_residual_sq"}`` (each (S,) float32)
        on a compressed wire with ``collect_stats``, else None; collecting
        them never changes the payload."""
        S, R, H = self.num_shards, self.rows_per_shard, self.halo_width
        dev, p = slab.device, slab.shape[1]
        halo = slab[S * R:]  # (S * Hmax, p), a view
        stats = None
        coll = self.collective
        # -- publish
        if self.dtype == "f32":
            if self.method == "p2p":
                send = slab[self.table("send_rows", dev)]  # (sum_d S * P_d, p)
            else:
                send = slab[self.table("border_rows", dev)].view(S, -1, p)
            scales = None
        else:
            v = slab[self.table("border_rows", dev)].view(S, -1, p)
            if ef is not None:
                v = v + ef.to(v.dtype)
            payload, dq = self._quantize(v)
            if ef is not None:
                ef.copy_(v - dq)
            if collect_stats:
                err = (v - dq).to(torch.float32)
                sq = torch.sum(torch.square(err), dim=(1, 2))
                stats = {"quant_err_sq": sq,
                         "ef_residual_sq": sq if ef is not None else torch.zeros_like(sq)}
            q = payload["q"].view(S * v.shape[1], p)
            scale = payload.get("scale")
            if self.method == "p2p":
                rows = self.table("send_rows", dev)
                send, scales = q[rows], (None if scale is None else scale.view(-1, 1)[rows])
            else:
                send, scales = q.view(S, -1, p), scale
        # -- collective
        if self.method == "p2p":
            recv, recv_s = self._ring_shift(send, coll), None
            if scales is not None:
                recv_s = self._ring_shift(scales, coll)
        else:
            recv = coll.all_gather(send)
            recv_s = None if scales is None else coll.all_gather(scales)
        # -- scatter
        if self.method == "p2p":
            keep = self.table("recv_keep", dev)
            rows = recv[keep].to(slab.dtype)
            if recv_s is not None:
                rows = rows * recv_s[keep].to(slab.dtype)
            slab.index_copy_(0, self.table("recv_slot", dev), rows)
        else:
            src = self.table("halo_src", dev)
            rows = recv.reshape(-1, p)[src].to(slab.dtype)
            if recv_s is not None:
                rows = rows * recv_s.reshape(-1, 1)[src].to(slab.dtype)
            halo.copy_(rows)
        return stats

    def _ring_shift(self, send, coll):
        """Each offset's (S, P_d, ...) segment of the concatenated send
        buffer through ``coll.ppermute``, concatenated again."""
        S = self.num_shards
        out, start = [], 0
        for k, off in enumerate(self.p2p_offsets):
            size = S * int(self.p2p_dst[k].shape[1])
            seg = send[start:start + size]
            out.append(coll.ppermute(seg.view((S, -1) + tuple(seg.shape[1:])), off)
                       .reshape(seg.shape))
            start += size
        if len(out) < 2:
            return out[0] if out else send  # no offset: nothing crosses shards
        return torch.cat(out)

    def gather_rows(self, slab, rows):
        """Neighbour sums of the slab rows ``rows`` (flat owned rows
        ``s * R + r``, in range): the reference's einsum over the
        halo-extended slab -> (len(rows), p)."""
        dev = slab.device
        cols = self.table("flat_idx", dev)[rows]  # (B, K) slab rows
        ww = self.table("flat_w", dev, slab.dtype)[rows]  # (B, K)
        return torch.einsum("bk,bkp->bp", ww, slab[cols])


def sharded_mix_op(partition, exchange=None) -> ShardedMixOp:
    """Build the halo-exchange operator for a :class:`GraphPartition`.

    ``exchange`` is an :class:`ExchangeSpec` (None = defaults: auto
    method, f32 wire; bare strings are a deprecated shim).
    ``method="auto"`` goes point-to-point only when it ships at most 3/4
    of the all_gather rows on this partition's measured cut
    (``GraphPartition.exchange_rows``), as in the reference.
    """
    spec = ExchangeSpec.coerce(exchange)
    method = spec.method
    if method == "auto":
        method = (
            "p2p"
            if 4 * partition.exchange_rows("p2p") <= 3 * partition.exchange_rows("all_gather")
            else "all_gather"
        )
    offsets, sends, dsts = partition.p2p_plan if method == "p2p" else ((), (), ())
    bpos: tuple = ()
    if method == "p2p" and spec.dtype != "f32":
        # Each offset's send rows as positions in the (sorted, unique)
        # border list, so compressed sends slice the quantized-once border
        # pool. Only the valid prefix of a border row is sorted; padding
        # send entries may land anywhere — the receiver drops them.
        border = np.asarray(partition.border)
        bsizes = np.asarray(partition.border_sizes)
        bpos = tuple(
            np.stack([
                np.searchsorted(border[t, : int(bsizes[t])], np.asarray(snd)[t]).astype(np.int32)
                for t in range(partition.num_shards)
            ])
            for snd in sends
        )
    return ShardedMixOp(
        n=partition.n,
        num_shards=partition.num_shards,
        idx=partition.idx,
        w=partition.w,
        border=partition.border,
        halo_src=partition.halo_src,
        method=method,
        halo_width=partition.halo.shape[1],
        p2p_offsets=offsets,
        p2p_send=sends,
        p2p_dst=dsts,
        p2p_bpos=bpos,
        dtype=spec.dtype,
        error_feedback=spec.needs_error_feedback_state(),
    )


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

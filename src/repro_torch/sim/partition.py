"""Agent-block graph partitioning for the sharded engine.

Port of ``repro.sim.partition``, unchanged: pure numpy, so the arrays it
builds are the reference's, entry for entry. It cuts a :class:`CSRGraph`
into ``num_shards`` index blocks (equal-count blocks, or degree-balanced
blocks that equalize per-shard nnz), optionally after a **locality
relabel** pass (reverse Cuthill–McKee, or a Morton or Hilbert
space-filling curve for geometric graphs) that permutes agent positions
so that graph neighbours land in the same block and the cut — and with
it the halo traffic — shrinks. It precomputes everything the
shard-local super-tick needs as stacked ``(S, ...)`` arrays (the port's
sharded engine keeps them stacked on one device):

* ``owned``: each shard's global agent ids (always *original* ids,
  whatever the relabeling), padded to the max block size ``R`` with the
  sentinel ``n``;
* per-shard **padded neighbour tiles** ``idx``/``w`` of width ``K`` (the
  global max degree), whose column indices live in the shard's *extended*
  local array ``[own rows (R) ; halo rows (Hmax)]``;
* **halo maps** for the cross-shard edges: ``halo`` lists the remote
  global ids a shard reads, ``halo_owner`` the shard that owns each of
  them, ``border`` lists the local rows a shard must publish, and
  ``halo_src`` maps each halo slot to its position in the all-gathered
  ``(S * Bmax,)`` border pool;
* a **point-to-point plan** (:func:`point_to_point_plan`): per
  shard-offset ``d``, the local rows each shard ships to the shard ``d``
  hops ahead on the ring and the halo slots the receiver writes them
  to — the alternative to the replicated border pool.

The exchange itself lives in :class:`repro_torch.core.mixing.ShardedMixOp`.

Relabeling never leaks into caller-visible ids: ``owned``/``halo``/
``shard_of``/``local_of`` all speak original agent ids, so
``pad_rows``/``unpad_rows`` (and the engine's ``global_theta``) are the
identity round-trip under any permutation — callers need no unrelabel
step. The permutation itself is exposed as ``order`` for diagnostics.
``patch`` and ``drift`` serve the sharded engine's dynamic topology
(``ShardedAsyncEngine.set_topology``); ``place_rows`` and
:func:`partition_from_ownership` the engine checkpoints
(:mod:`repro_torch.checkpoint.engine_io`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.graph import CSRGraph


@dataclasses.dataclass(frozen=True, eq=False)
class GraphPartition:
    """An agent-block partition of a CSR graph with halo and exchange maps.

    Shapes: ``S = num_shards``, ``R = rows_per_shard`` (max block size),
    ``K = tile_width`` (max degree), ``Bmax``/``Hmax`` the padded border
    and halo widths. Shard ``s`` owns the agents at *positions*
    ``[bounds[s], bounds[s+1])`` of the (possibly relabeled) ``order``;
    all id-valued arrays hold original agent ids.
    """

    csr: CSRGraph
    num_shards: int
    mode: str
    relabel: str | None  # None | "rcm" | "sfc" | "custom"
    order: np.ndarray  # (n,) position -> original agent id (the relabel permutation)
    bounds: np.ndarray  # (S + 1,) block boundaries in *positions* of ``order``
    owned: np.ndarray  # (S, R) original agent ids, sentinel n past the block
    sizes: np.ndarray  # (S,) real rows per shard
    shard_of: np.ndarray  # (n,) owning shard per agent (original ids)
    local_of: np.ndarray  # (n,) local row within the owning shard (original ids)
    halo: np.ndarray  # (S, Hmax) remote global ids each shard reads, sentinel n
    halo_sizes: np.ndarray  # (S,)
    halo_owner: np.ndarray  # (S, Hmax) owning shard per halo slot, sentinel S
    border: np.ndarray  # (S, Bmax) local rows each shard publishes, padded 0
    border_sizes: np.ndarray  # (S,)
    halo_src: np.ndarray  # (S, Hmax) flat index into the (S * Bmax,) border pool
    idx: np.ndarray  # (S, R, K) extended-local neighbour indices
    w: np.ndarray  # (S, R, K) neighbour weights (pad entries 0)

    @property
    def n(self) -> int:
        """Total number of agents in the partitioned graph."""
        return self.csr.n

    @property
    def rows_per_shard(self) -> int:
        """R: padded rows per shard (max block size over shards)."""
        return self.owned.shape[1]

    @property
    def tile_width(self) -> int:
        """K: padded neighbour-tile width (>= global max degree)."""
        return self.idx.shape[2]

    def halo_fraction(self) -> float:
        """Mean fraction of read rows that cross shards (comm diagnostics)."""
        reads = self.sizes + self.halo_sizes
        return float(self.halo_sizes.sum() / max(reads.sum(), 1))

    def neighbor_shards(self) -> list[np.ndarray]:
        """Per-shard sorted array of the shards whose rows this shard reads.

        Empty array for shards whose blocks have no cross-shard edge; a
        shard never lists itself. This is the communication graph the
        point-to-point exchange walks.
        """
        return [
            np.unique(self.halo_owner[s, : int(self.halo_sizes[s])]).astype(np.int64)
            for s in range(self.num_shards)
        ]

    @functools.cached_property
    def p2p_plan(self) -> tuple[tuple[int, ...], tuple[np.ndarray, ...], tuple[np.ndarray, ...]]:
        """Cached :func:`point_to_point_plan` for this partition."""
        return point_to_point_plan(self)

    def exchange_rows(self, method: str) -> int:
        """Interconnect rows moved per super-tick under an exchange method.

        ``"all_gather"``: every shard receives the other ``S - 1`` shards'
        padded ``Bmax`` border rows from the replicated pool. ``"p2p"``:
        every shard receives one padded ``P_d`` buffer per ring offset
        ``d`` in the plan. Counts are rows summed over all shards (one row
        = one ``(p,)`` model vector); padding rows are counted because
        static shapes ship them. Used by the ``method="auto"`` selection
        in :func:`repro_torch.core.mixing.sharded_mix_op`.
        """
        S = self.num_shards
        if S <= 1:
            return 0
        if method == "all_gather":
            return S * (S - 1) * int(self.border.shape[1])
        if method != "p2p":
            raise ValueError(f"unknown exchange method {method!r}")
        _, sends, _ = self.p2p_plan
        return S * int(sum(s.shape[1] for s in sends))

    # -- dynamic topology: drift gauge + incremental rebind ----------------
    def cut_weight(self, csr: CSRGraph | None = None) -> float:
        """Total edge weight crossing shard boundaries under *this* cut.

        With ``csr`` given, the live graph is measured against the
        ownership frozen at partition time — the drift gauge input.
        """
        csr = self.csr if csr is None else csr
        if csr.n != self.n:
            raise ValueError(f"graph has {csr.n} agents, partition has {self.n}")
        rows = csr.row_ids()
        cross = self.shard_of[rows] != self.shard_of[csr.indices]
        return float(np.asarray(csr.data)[cross].sum() / 2.0)

    def cut_fraction(self, csr: CSRGraph | None = None) -> float:
        """Cut weight as a fraction of total edge weight (0 when no edges)."""
        csr = self.csr if csr is None else csr
        total = float(np.asarray(csr.data).sum() / 2.0)
        if total <= 0.0:
            return 0.0
        return self.cut_weight(csr) / total

    def drift(self, new_csr: CSRGraph) -> float:
        """Topology drift: cut fraction of the live graph minus at cut time.

        Positive drift means edge weight has migrated onto shard
        boundaries since this partition was cut — the engine's
        repartition-trigger policy compares it to
        ``EngineConfig.drift_threshold``.
        """
        return self.cut_fraction(new_csr) - self.cut_fraction()

    def patch(self, new_csr: CSRGraph) -> "GraphPartition":
        """Rebind halo rows + exchange maps to ``new_csr`` without a rebuild.

        Ownership (relabel order, block bounds, ``owned``/``shard_of``/
        ``local_of``) is kept frozen — that is the entire saving over
        :func:`partition_graph`, which would redo the relabel pass and
        the block cut. Two paths:

        * weight-only (identical ``indptr``/``indices``): only the ``w``
          tiles are regathered; every map — including the cached
          ``p2p_plan`` — carries over unchanged.
        * structural: the halo/border/exchange maps and neighbour tiles
          are rebuilt against the frozen ownership. The tile width never
          shrinks (it grows to the new max degree when needed), keeping
          downstream tile shapes stable under pure edge deletion.
        """
        if new_csr.n != self.n:
            raise ValueError(f"graph has {new_csr.n} agents, partition has {self.n}")
        same_structure = np.array_equal(
            np.asarray(self.csr.indptr), np.asarray(new_csr.indptr)
        ) and np.array_equal(np.asarray(self.csr.indices), np.asarray(new_csr.indices))
        if same_structure:
            w = self.w.copy()
            for s in range(self.num_shards):
                lo, hi = int(self.bounds[s]), int(self.bounds[s + 1])
                _, vals, deg, offs = _row_gather(new_csr, self.order[lo:hi])
                rows_local = np.repeat(np.arange(hi - lo, dtype=np.int64), deg)
                w[s, rows_local, offs] = vals
            patched = dataclasses.replace(self, csr=new_csr, w=w)
            # Same structure -> identical plan; carry the cache over.
            patched.__dict__["p2p_plan"] = self.p2p_plan
            return patched
        K = max(self.tile_width, new_csr.max_degree())
        tiles = _halo_tiles(
            new_csr,
            self.num_shards,
            self.order,
            self.bounds,
            self.sizes,
            self.rows_per_shard,
            K,
            self.shard_of,
            self.local_of,
        )
        return dataclasses.replace(self, csr=new_csr, **tiles)

    # -- row <-> shard layout conversions ---------------------------------
    def pad_rows(self, x, fill=0):
        """(n, ...) per-agent array -> (S, R, ...) shard layout, ``fill`` pads."""
        x = np.asarray(x)
        if x.shape[:1] != (self.n,):
            raise ValueError(f"expected leading dim {self.n}, got {x.shape}")
        out = np.full((self.num_shards, self.rows_per_shard) + x.shape[1:], fill, dtype=x.dtype)
        real = self.owned < self.n
        out[real] = x[self.owned[real]]
        return out

    def unpad_rows(self, x_sh):
        """(S, R, ...) shard layout -> (n, ...) per-agent array (drops padding)."""
        x_sh = np.asarray(x_sh)
        if x_sh.shape[:2] != self.owned.shape:
            raise ValueError(f"expected leading dims {self.owned.shape}, got {x_sh.shape}")
        out = np.empty((self.n,) + x_sh.shape[2:], dtype=x_sh.dtype)
        real = self.owned < self.n
        out[self.owned[real]] = x_sh[real]
        return out

    def place_rows(self, out, ids, rows):
        """Scatter per-agent ``rows`` (keyed by original agent ``ids``)
        into the (S, R, ...) shard layout ``out``, in place.

        The elastic-restore primitive: a checkpoint written under one cut
        re-tiles under another by routing each owned row through this
        partition's ``shard_of``/``local_of`` maps — no (n, ...) host
        array is ever assembled, unlike ``pad_rows``/``unpad_rows``.
        """
        ids = np.asarray(ids)
        rows = np.asarray(rows)
        if out.shape[:2] != self.owned.shape:
            raise ValueError(f"expected leading dims {self.owned.shape}, got {out.shape}")
        if ids.shape[:1] != rows.shape[:1]:
            raise ValueError(f"ids/rows leading dims differ: {ids.shape} vs {rows.shape}")
        out[self.shard_of[ids], self.local_of[ids]] = rows
        return out


# ---------------------------------------------------------------------------
# Locality relabeling
# ---------------------------------------------------------------------------


def _rcm_order_numpy(csr: CSRGraph) -> np.ndarray:
    """Pure-numpy reverse Cuthill–McKee fallback (scipy unavailable).

    Per component: BFS from a minimum-degree start node, visiting each
    frontier's unvisited neighbours in ascending-degree order, then
    reverse the full visitation sequence. O(n + nnz log deg); the scipy
    path is preferred at large n.
    """
    n = csr.n
    deg = np.diff(csr.indptr)
    visited = np.zeros(n, dtype=bool)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    for start in np.argsort(deg, kind="stable"):
        if visited[start]:
            continue
        visited[start] = True
        queue = [int(start)]
        head = 0
        while head < len(queue):
            i = queue[head]
            head += 1
            out[pos] = i
            pos += 1
            nbrs = csr.neighbors(i)
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                queue.extend(int(j) for j in nbrs)
    return out[::-1].copy()


def rcm_order(csr: CSRGraph) -> np.ndarray:
    """Reverse Cuthill–McKee ordering: (n,) position -> agent id.

    A bandwidth-reducing BFS relabeling: after it, graph neighbours sit at
    nearby positions, so contiguous position blocks have O(boundary) cuts
    instead of O(volume). Uses scipy's C implementation when available and
    a pure-numpy BFS otherwise.
    """
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:  # pragma: no cover - exercised where scipy is absent
        return _rcm_order_numpy(csr)
    mat = csr_matrix(
        (np.asarray(csr.data), np.asarray(csr.indices), np.asarray(csr.indptr)),
        shape=(csr.n, csr.n),
    )
    return np.asarray(reverse_cuthill_mckee(mat, symmetric_mode=True), dtype=np.int64)


def sfc_order(coords: np.ndarray) -> np.ndarray:
    """Morton (Z-order) space-filling-curve ordering of 2-D coordinates.

    ``coords``: (n, 2) positions (any units; rescaled to the bounding
    box). Each point is quantized to a 16-bit grid per axis and sorted by
    the bit-interleaved Morton key, so spatially-close agents get nearby
    positions — the right relabel for ``random_geometric_graph``-style
    topologies where edges are short-range. Returns (n,) position ->
    agent id.
    """
    c = np.asarray(coords, dtype=np.float64)
    if c.ndim != 2 or c.shape[1] != 2:
        raise ValueError(f"coords must be (n, 2), got {c.shape}")
    mins = c.min(axis=0)
    span = c.max(axis=0) - mins
    span = np.where(span > 0.0, span, 1.0)
    q = ((c - mins) / span * (2**16 - 1)).astype(np.uint64)

    def spread(v):
        # 16 significant bits -> 32, a zero between every pair of bits.
        v = (v | (v << 8)) & np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x33333333)
        v = (v | (v << 1)) & np.uint64(0x55555555)
        return v

    key = (spread(q[:, 0]) << np.uint64(1)) | spread(q[:, 1])
    return np.argsort(key, kind="stable").astype(np.int64)


def hilbert_order(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Hilbert-curve space-filling ordering of 2-D coordinates.

    Same contract as :func:`sfc_order` (Morton), but sorts by the Hilbert
    curve index instead of the bit-interleaved Z-order key. The Hilbert
    curve has no diagonal jumps — consecutive curve positions are always
    grid neighbours — so block cuts along it have strictly local
    boundaries where Morton's quadrant seams put far-apart points at
    adjacent positions. That is exactly the S=16 regime the ROADMAP
    flags: more shards means more cuts landing on Morton seams. Returns
    (n,) position -> agent id.

    Vectorized transcription of the standard ``xy2d`` bit-descent: per
    quantization level ``s`` the quadrant pair (rx, ry) contributes
    ``s^2 * ((3 rx) XOR ry)`` to the curve index, then the lower-level
    coordinates are rotated/reflected into the quadrant's frame.
    """
    c = np.asarray(coords, dtype=np.float64)
    if c.ndim != 2 or c.shape[1] != 2:
        raise ValueError(f"coords must be (n, 2), got {c.shape}")
    mins = c.min(axis=0)
    span = c.max(axis=0) - mins
    span = np.where(span > 0.0, span, 1.0)
    q = ((c - mins) / span * (2**bits - 1)).astype(np.int64)
    x, y = q[:, 0].copy(), q[:, 1].copy()
    d = np.zeros(len(c), dtype=np.int64)
    s = np.int64(1) << (bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # Rotate the sub-square: in the ry == 0 quadrants the lower bits
        # traverse a reflected/transposed copy of the curve.
        flip = (ry == 0) & (rx == 1)
        x = np.where(flip, s - 1 - x, x)
        y = np.where(flip, s - 1 - y, y)
        swap = ry == 0
        x, y = np.where(swap, y, x), np.where(swap, x, y)
        s >>= 1
    return np.argsort(d, kind="stable").astype(np.int64)


def _resolve_order(csr: CSRGraph, relabel, coords) -> tuple[str | None, np.ndarray]:
    """Resolve the ``relabel`` argument into (mode name, order array)."""
    n = csr.n
    if relabel is None:
        return None, np.arange(n, dtype=np.int64)
    if isinstance(relabel, str):
        if relabel == "rcm":
            return "rcm", rcm_order(csr)
        if relabel in ("sfc", "hilbert"):
            if coords is None:
                raise ValueError(
                    f"relabel={relabel!r} needs coords: the (n, 2) agent positions"
                )
            order = sfc_order(coords) if relabel == "sfc" else hilbert_order(coords)
            if len(order) != n:
                raise ValueError(f"coords rows ({len(order)}) != agents ({n})")
            return relabel, order
        raise ValueError(
            f"unknown relabel mode {relabel!r} (use 'rcm', 'sfc', 'hilbert', or an order)"
        )
    order = np.asarray(relabel, dtype=np.int64)
    if order.shape != (n,) or not np.array_equal(np.sort(order), np.arange(n)):
        raise ValueError("explicit relabel must be a permutation of arange(n)")
    return "custom", order


# ---------------------------------------------------------------------------
# Block cutting
# ---------------------------------------------------------------------------


def _block_bounds(csr: CSRGraph, num_shards: int, mode: str, order: np.ndarray) -> np.ndarray:
    """Cut the permuted position axis into ``num_shards`` blocks."""
    n, S = csr.n, num_shards
    if mode == "contiguous":
        return np.array([n * s // S for s in range(S + 1)], dtype=np.int64)
    if mode != "degree":
        raise ValueError(f"unknown partition mode {mode!r}")
    # Degree-balanced: put boundaries at equal cumulative-nnz quantiles of
    # the *permuted* degree sequence so every shard carries ~nnz/S edge
    # work, whatever the degree skew or relabeling.
    deg = np.diff(np.asarray(csr.indptr, dtype=np.int64))
    cum = np.concatenate([[0], np.cumsum(deg[order])])
    target = csr.nnz * np.arange(1, S, dtype=np.float64) / S
    cuts = np.searchsorted(cum, target)
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)
    for s in range(1, S + 1):  # keep blocks non-empty and ordered
        bounds[s] = min(max(bounds[s], bounds[s - 1] + 1), n - (S - s))
    bounds[S] = n
    return bounds


def partition_graph(
    csr: CSRGraph,
    num_shards: int,
    mode: str = "degree",
    tile_width: int | None = None,
    relabel: str | np.ndarray | None = None,
    coords: np.ndarray | None = None,
) -> GraphPartition:
    """Cut ``csr`` into agent blocks with halo/border/exchange maps.

    ``mode``: "contiguous" (equal agent counts) or "degree" (equal nnz).
    ``relabel``: None (cut original ids in index order), ``"rcm"``
    (reverse Cuthill–McKee), ``"sfc"`` (Morton curve over ``coords``,
    the (n, 2) agent positions), or an explicit (n,) permutation
    (position -> agent id). Blocks are contiguous in the relabeled
    position space; all returned id arrays stay in original ids, so
    results need no unrelabel step.
    ``tile_width`` pads the neighbour tiles to at least the global max
    degree (the default), which keeps the per-row contraction extent
    identical to the single-device padded tiles — the forced-wake parity
    guarantee rests on that, together with the tiles preserving the
    original CSR neighbour order per row under any relabeling.
    """
    n, S = csr.n, int(num_shards)
    if not (1 <= S <= max(n, 1)):
        raise ValueError(f"num_shards must lie in [1, n={n}], got {S}")
    relabel_mode, order = _resolve_order(csr, relabel, coords)
    bounds = _block_bounds(csr, S, mode, order)
    sizes = np.diff(bounds).astype(np.int64)
    R = int(sizes.max())
    K = max(csr.max_degree(), 1)
    if tile_width is not None:
        if tile_width < K:
            raise ValueError(f"tile_width={tile_width} < max degree {K}")
        K = int(tile_width)

    owned = np.full((S, R), n, dtype=np.int32)
    shard_of = np.empty(n, dtype=np.int32)
    local_of = np.empty(n, dtype=np.int32)
    for s in range(S):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        ids = order[lo:hi]
        owned[s, : hi - lo] = ids.astype(np.int32)
        shard_of[ids] = s
        local_of[ids] = np.arange(hi - lo, dtype=np.int32)

    tiles = _halo_tiles(csr, S, order, bounds, sizes, R, K, shard_of, local_of)
    return GraphPartition(
        csr=csr,
        num_shards=S,
        mode=mode,
        relabel=relabel_mode,
        order=order,
        bounds=bounds,
        owned=owned,
        sizes=sizes,
        shard_of=shard_of,
        local_of=local_of,
        **tiles,
    )


def partition_from_ownership(
    csr: CSRGraph,
    order: np.ndarray,
    bounds: np.ndarray,
    mode: str = "degree",
    relabel: str | None = None,
    tile_width: int | None = None,
) -> GraphPartition:
    """Rebuild a :class:`GraphPartition` from a frozen ownership.

    ``order``/``bounds`` are taken verbatim (no relabel pass, no block
    cut) and only the halo/border/exchange maps and neighbour tiles are
    derived from ``csr`` — the same second half :meth:`GraphPartition.patch`
    runs. This is how a checkpoint restores the *exact* partition a
    sharded run was cut on: the saved ownership may be the product of a
    patch chain that no ``partition_graph`` call reproduces, but given
    (ownership, graph, tile width) the derived maps are deterministic.
    ``mode``/``relabel`` are recorded as provenance only.
    """
    n = csr.n
    order = np.asarray(order, dtype=np.int64)
    bounds = np.asarray(bounds, dtype=np.int64)
    if order.shape != (n,) or not np.array_equal(np.sort(order), np.arange(n)):
        raise ValueError("order must be a permutation of arange(n)")
    S = len(bounds) - 1
    if S < 1 or bounds[0] != 0 or bounds[-1] != n or np.any(np.diff(bounds) <= 0):
        raise ValueError(f"bounds must cut [0, n={n}] into non-empty blocks")
    sizes = np.diff(bounds).astype(np.int64)
    R = int(sizes.max())
    K = max(csr.max_degree(), 1)
    if tile_width is not None:
        if tile_width < K:
            raise ValueError(f"tile_width={tile_width} < max degree {K}")
        K = int(tile_width)
    owned = np.full((S, R), n, dtype=np.int32)
    shard_of = np.empty(n, dtype=np.int32)
    local_of = np.empty(n, dtype=np.int32)
    for s in range(S):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        ids = order[lo:hi]
        owned[s, : hi - lo] = ids.astype(np.int32)
        shard_of[ids] = s
        local_of[ids] = np.arange(hi - lo, dtype=np.int32)
    tiles = _halo_tiles(csr, S, order, bounds, sizes, R, K, shard_of, local_of)
    return GraphPartition(
        csr=csr,
        num_shards=S,
        mode=mode,
        relabel=relabel,
        order=order,
        bounds=bounds,
        owned=owned,
        sizes=sizes,
        shard_of=shard_of,
        local_of=local_of,
        **tiles,
    )


def _row_gather(csr: CSRGraph, ids: np.ndarray):
    """Flat CSR gather of the rows ``ids`` (preserving per-row order).

    Returns ``(cols, vals, deg, offs)`` where ``offs[e]`` is edge ``e``'s
    position within its row — reused by the tile builds as the tile
    column coordinate. Reduces to the indptr slice when ``ids`` is a
    contiguous identity range.
    """
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    deg = np.diff(indptr)[ids]
    total = int(deg.sum())
    offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(deg) - deg, deg)
    flat = np.repeat(indptr[ids], deg) + offs
    return csr.indices[flat].astype(np.int64), csr.data[flat], deg, offs


def _halo_tiles(
    csr: CSRGraph,
    S: int,
    order: np.ndarray,
    bounds: np.ndarray,
    sizes: np.ndarray,
    R: int,
    K: int,
    shard_of: np.ndarray,
    local_of: np.ndarray,
) -> dict:
    """Halo/border/exchange maps + neighbour tiles for a frozen ownership.

    The second half of :func:`partition_graph`, split out so
    :meth:`GraphPartition.patch` can rebind a changed graph to an
    existing cut (order/bounds/ownership untouched) without paying for
    the relabel pass or the block cut again. Returns the field dict
    ``{halo, halo_sizes, halo_owner, border, border_sizes, halo_src,
    idx, w}``.
    """
    n = csr.n
    # Flat CSR row gathers per shard (reduces to the indptr slice when the
    # order is the identity): cols/vals keep the original per-row
    # neighbour order, which the bit-exactness guarantee rests on.
    shard_cols, shard_vals, shard_degs, shard_offs = [], [], [], []
    halos = []
    for s in range(S):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        cols, vals, deg, offs = _row_gather(csr, order[lo:hi])
        shard_cols.append(cols)
        shard_vals.append(vals)
        shard_degs.append(deg)
        shard_offs.append(offs)
        halos.append(np.unique(cols[shard_of[cols] != s]).astype(np.int32))
    halo_sizes = np.array([len(h) for h in halos], dtype=np.int64)
    Hmax = max(int(halo_sizes.max(initial=0)), 1)
    halo = np.full((S, Hmax), n, dtype=np.int32)
    halo_owner = np.full((S, Hmax), S, dtype=np.int32)
    for s, h in enumerate(halos):
        halo[s, : len(h)] = h
        halo_owner[s, : len(h)] = shard_of[h]

    # Border of shard s = its local rows referenced by any other shard's
    # halo, unique-sorted in local-row order.
    all_halo = np.concatenate(halos) if halos else np.zeros(0, dtype=np.int32)
    owner_all = shard_of[all_halo] if len(all_halo) else np.zeros(0, dtype=np.int32)
    borders = []
    for s in range(S):
        mine = all_halo[owner_all == s]
        borders.append(np.unique(local_of[mine]).astype(np.int32))
    border_sizes = np.array([len(b) for b in borders], dtype=np.int64)
    Bmax = max(int(border_sizes.max(initial=0)), 1)
    border = np.zeros((S, Bmax), dtype=np.int32)
    for s, b in enumerate(borders):
        border[s, : len(b)] = b

    # halo_src[s, h]: where halo id halo[s, h] lands in the all-gathered
    # (S * Bmax,) border pool — owner shard block, then position within the
    # owner's sorted border list.
    halo_src = np.zeros((S, Hmax), dtype=np.int32)
    for s, h in enumerate(halos):
        if not len(h):
            continue
        owner = shard_of[h]
        pos = np.empty(len(h), dtype=np.int64)
        for d in np.unique(owner):
            sel = owner == d
            pos[sel] = np.searchsorted(borders[d], local_of[h[sel]])
        halo_src[s, : len(h)] = owner.astype(np.int64) * Bmax + pos

    # Per-shard padded neighbour tiles in extended-local coordinates
    # ([own rows ; halo rows]), preserving the original CSR neighbour
    # order per row so the per-row reduction matches
    # CSRGraph.padded_neighbors bit-for-bit under any relabeling.
    idx = np.tile(np.arange(R, dtype=np.int32)[None, :, None], (S, 1, K))
    w = np.zeros((S, R, K), dtype=np.float64)
    for s in range(S):
        size = int(sizes[s])
        cols, vals, deg, pos = shard_cols[s], shard_vals[s], shard_degs[s], shard_offs[s]
        rows_local = np.repeat(np.arange(size, dtype=np.int64), deg)
        local_cols = np.where(
            shard_of[cols] == s,
            local_of[cols],
            R + np.searchsorted(halos[s], cols),
        )
        idx[s, rows_local, pos] = local_cols.astype(np.int32)
        w[s, rows_local, pos] = vals
    return dict(
        halo=halo,
        halo_sizes=halo_sizes,
        halo_owner=halo_owner,
        border=border,
        border_sizes=border_sizes,
        halo_src=halo_src,
        idx=idx,
        w=w,
    )


def point_to_point_plan(
    part: GraphPartition,
) -> tuple[tuple[int, ...], tuple[np.ndarray, ...], tuple[np.ndarray, ...]]:
    """Neighbour-shard exchange plan: one ring shift per offset.

    Returns ``(offsets, sends, dsts)``. For each mesh-ring offset
    ``d = offsets[k]`` (a distinct value of ``(reader - owner) mod S``
    over cross-shard edges):

    * ``sends[k]``: (S, P_d) int32 — the local rows shard ``t`` packs
      into the buffer it ships to shard ``(t + d) mod S`` (padded with
      row 0; padding is never referenced by the receiver);
    * ``dsts[k]``: (S, P_d) int32 — the halo slot (position in
      ``[0, Hmax)``) shard ``s`` writes each received buffer row to,
      padded with the sentinel ``Hmax`` (dropped by the scatter).

    Buffer slot ``j`` of the (t -> s) pair carries owner-local row
    ``sends[k][t, j]`` and lands in halo slot ``dsts[k][s, j]`` — both
    sides are built from the same traversal of shard ``s``'s halo list,
    so the alignment is by construction. Total shipped rows per
    super-tick are ``S * sum_d P_d``, vs ``S * (S-1) * Bmax`` for the
    replicated all-gather pool — the ``method="auto"`` selection in
    :func:`repro_torch.core.mixing.sharded_mix_op` compares exactly these.
    """
    S, Hmax = part.halo.shape
    send_by_off: dict[int, dict[int, np.ndarray]] = {}
    dst_by_off: dict[int, dict[int, np.ndarray]] = {}
    for s in range(S):
        hs = int(part.halo_sizes[s])
        ids = part.halo[s, :hs]
        owners = part.shard_of[ids]
        for t in np.unique(owners):
            d = int((s - int(t)) % S)
            sel = np.nonzero(owners == t)[0]
            send_by_off.setdefault(d, {})[int(t)] = part.local_of[ids[sel]].astype(np.int32)
            dst_by_off.setdefault(d, {})[s] = sel.astype(np.int32)
    offsets = tuple(sorted(send_by_off))
    sends, dsts = [], []
    for d in offsets:
        P = max(max(len(v) for v in send_by_off[d].values()), 1)
        snd = np.zeros((S, P), dtype=np.int32)
        dst = np.full((S, P), Hmax, dtype=np.int32)
        for t, rows_t in send_by_off[d].items():
            snd[t, : len(rows_t)] = rows_t
        for s, slots in dst_by_off[d].items():
            dst[s, : len(slots)] = slots
        sends.append(snd)
        dsts.append(dst)
    return offsets, tuple(sends), tuple(dsts)

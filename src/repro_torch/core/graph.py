"""Agent graphs for peer-to-peer personalized learning (numpy, host side).

The port's own copy of ``repro.core.graph``. Graph construction is host
work in both packages, so the arrays here are bit-equal to the
reference's under the same numpy seed (``tests/test_torch_graph.py``);
:class:`TopologyState`, the mutable slot form of a live graph, keeps its
host builders in numpy and its three in-graph edge mutators in torch
(``tests/test_torch_dynamic_topology.py``).

The paper (Sec. 2.1) models the collaboration network as a weighted
connected graph G = ([n], E, W) whose weights encode task relatedness:

* ``angular_similarity_graph`` — the synthetic setup of Sec. 5.1:
  ``W_ij = exp((cos(phi_ij) - 1) / gamma)``, negligible weights dropped;
* ``knn_cosine_graph`` / ``knn_graph`` — the MovieLens setup of Sec. 5.2:
  ``W_ij = 1`` iff i is in the k-NN of j (or vice versa) under cosine
  similarity;
* ``ring_graph`` / ``circulant_graph`` / ``erdos_renyi_graph`` /
  ``complete_graph`` — test topologies;
* ``random_geometric_graph`` — the O(n * deg) sparse builder behind the
  large-n engine runs.

:class:`CSRGraph` stores the symmetric weighted graph as CSR neighbour
lists; :func:`repro_torch.core.mixing.mix_op` dispatches the neighbour
sum to the dense ``graph_mix`` path below :func:`sparse_crossover` agents
and to the padded-neighbour ``sparse_mix`` path at or above it.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os

import numpy as np
import torch

from repro_torch.obs.trace import span


@dataclasses.dataclass(frozen=True, eq=False)
class AgentGraph:
    """Symmetric non-negative weight matrix with zero diagonal."""

    weights: np.ndarray  # (n, n) float64

    def __post_init__(self):
        w = self.weights
        if w.ndim != 2 or w.shape[0] != w.shape[1]:
            raise ValueError(f"weights must be square, got {w.shape}")
        if not np.allclose(w, w.T, atol=1e-10):
            raise ValueError("weights must be symmetric")
        if np.any(np.diag(w) != 0.0):
            raise ValueError("weights must have zero diagonal")
        if np.any(w < 0.0):
            raise ValueError("weights must be non-negative")

    @property
    def n(self) -> int:
        return self.weights.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        """D_ii = sum_j W_ij."""
        return self.weights.sum(axis=1)

    def neighbors(self, i: int) -> np.ndarray:
        return np.nonzero(self.weights[i] > 0.0)[0]

    def laplacian(self) -> np.ndarray:
        return np.diag(self.degrees) - self.weights

    def is_connected(self) -> bool:
        n = self.n
        seen = np.zeros(n, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            i = stack.pop()
            for j in np.nonzero(self.weights[i] > 0.0)[0]:
                if not seen[j]:
                    seen[j] = True
                    stack.append(int(j))
        return bool(seen.all())

    def num_edges(self) -> int:
        return int(np.count_nonzero(np.triu(self.weights, 1)))

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(neighbour indices, weights) of agent i — the CSR-compatible view."""
        cols = self.neighbors(i)
        return cols, self.weights[i, cols]

    def edge_list(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, weights) over undirected edges, one entry per i < j."""
        rows, cols = np.nonzero(np.triu(self.weights, 1))
        return rows, cols, self.weights[rows, cols]

    def max_degree(self) -> int:
        return int(np.count_nonzero(self.weights > 0.0, axis=1).max(initial=0))

    def to_csr(self) -> "CSRGraph":
        rows, cols = np.nonzero(self.weights > 0.0)
        return csr_from_coo(self.n, rows, cols, self.weights[rows, cols])


def angular_similarity_graph(
    target_models: np.ndarray, gamma: float = 0.1, threshold: float = 1e-2
) -> AgentGraph:
    """Paper Sec. 5.1: W_ij = exp((cos(phi_ij) - 1) / gamma), thresholded.

    ``target_models``: (n, p) array of the agents' target separators.
    Weights below ``threshold`` are considered negligible and dropped.
    """
    t = np.asarray(target_models, dtype=np.float64)
    norms = np.linalg.norm(t, axis=1, keepdims=True)
    norms = np.where(norms == 0.0, 1.0, norms)
    unit = t / norms
    cos = np.clip(unit @ unit.T, -1.0, 1.0)
    w = np.exp((cos - 1.0) / gamma)
    np.fill_diagonal(w, 0.0)
    w[w < threshold] = 0.0
    # Symmetrize against numerical asymmetry.
    w = 0.5 * (w + w.T)
    return AgentGraph(w)


def knn_cosine_graph(
    features: np.ndarray,
    k: int = 10,
    block_rows: int | None = None,
    sparse: bool = False,
) -> AgentGraph | "CSRGraph":
    """Paper Sec. 5.2: unit weight iff i in kNN(j) or j in kNN(i), cosine sim.

    The similarity computation streams in (block_rows, n) slabs — the
    dense (n, n) cosine matrix is never materialized, so the top-k
    selection scales past ~50k agents. The default return type is the
    historical dense :class:`AgentGraph` (itself (n, n) — fine for the
    small-n paper experiments); pass ``sparse=True`` to get the same
    graph as a :class:`CSRGraph` with O(n * k) storage end to end.

    ``k`` is clamped to ``n - 1``: with fewer than k candidate peers,
    everyone is a neighbour (the paper's semantics), instead of
    ``np.argpartition`` crashing on an out-of-range kth.
    """
    f = np.asarray(features, dtype=np.float64)
    n = f.shape[0]
    k = min(k, n - 1)
    if k <= 0:
        if sparse:
            return csr_from_coo(n, [], [], [])
        return AgentGraph(np.zeros((n, n), dtype=np.float64))
    norms = np.linalg.norm(f, axis=1, keepdims=True)
    norms = np.where(norms == 0.0, 1.0, norms)
    unit = f / norms
    if block_rows is None:
        block_rows = max(1, min(4096, (1 << 25) // max(n, 1)))
    rows = np.empty(n * k, dtype=np.int64)
    cols = np.empty(n * k, dtype=np.int64)
    for lo in range(0, n, block_rows):
        hi = min(lo + block_rows, n)
        sim = unit[lo:hi] @ unit.T  # (b, n) slab
        sim[np.arange(hi - lo), np.arange(lo, hi)] = -np.inf
        nn = np.argpartition(-sim, k, axis=1)[:, :k]
        rows[lo * k : hi * k] = np.repeat(np.arange(lo, hi), k)
        cols[lo * k : hi * k] = nn.ravel()
    if sparse:
        return csr_from_coo(n, rows, cols, np.ones(n * k), symmetrize=True)
    w = np.zeros((n, n), dtype=np.float64)
    w[rows, cols] = 1.0
    w = np.maximum(w, w.T)  # i in kNN(j) OR j in kNN(i)
    np.fill_diagonal(w, 0.0)
    return AgentGraph(w)


def ring_graph(n: int, weight: float = 1.0) -> AgentGraph:
    w = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        w[i, (i + 1) % n] = weight
        w[(i + 1) % n, i] = weight
    return AgentGraph(w)


def circulant_graph(n: int, offsets: tuple[int, ...], weights=None) -> AgentGraph:
    """Union of ring permutations: agent i connects to i +/- o for o in offsets.

    The collective-friendly family: the neighbour sum ``sum_j W_ij Theta_j``
    decomposes into |offsets| * 2 shifted copies of Theta.
    """
    if weights is None:
        weights = [1.0] * len(offsets)
    w = np.zeros((n, n), dtype=np.float64)
    for o, wt in zip(offsets, weights):
        o = o % n
        if o == 0:
            continue
        for i in range(n):
            j = (i + o) % n
            w[i, j] = max(w[i, j], wt)
            w[j, i] = max(w[j, i], wt)
    return AgentGraph(w)


def erdos_renyi_graph(n: int, prob: float, rng: np.random.Generator, weight: float = 1.0) -> AgentGraph:
    while True:
        upper = rng.random((n, n)) < prob
        w = np.triu(upper, 1).astype(np.float64) * weight
        w = w + w.T
        g = AgentGraph(w)
        if g.is_connected():
            return g


def complete_graph(n: int, weight: float = 1.0) -> AgentGraph:
    w = np.full((n, n), weight, dtype=np.float64)
    np.fill_diagonal(w, 0.0)
    return AgentGraph(w)


# ---------------------------------------------------------------------------
# Sparse (CSR) representation
# ---------------------------------------------------------------------------

_DEFAULT_SPARSE_CROSSOVER = 2048


def int_env_knob(name: str, default: int) -> int:
    """Integer agent-count knob from the environment (shared parse/raise)."""
    raw = os.environ.get(name, default)
    try:
        return int(raw)
    except ValueError as e:
        raise ValueError(
            f"{name} must be an integer agent count, got {raw!r}"
        ) from e


def sparse_crossover() -> int:
    """Agent count at which the neighbour-sum switches dense -> sparse.

    Below this, the (n, n) mixing matrix is small and the dense
    ``graph_mix`` product wins; above it, gather/segment-sum over CSR neighbour lists
    is the only representation that scales. Override with the
    ``REPRO_SPARSE_CROSSOVER`` environment variable.
    """
    return int_env_knob("REPRO_SPARSE_CROSSOVER", _DEFAULT_SPARSE_CROSSOVER)


@dataclasses.dataclass(frozen=True, eq=False)
class CSRGraph:
    """Symmetric non-negative weighted graph in CSR neighbour-list form.

    Same invariants as :class:`AgentGraph` (symmetric, zero diagonal,
    non-negative) but O(nnz) storage: ``indices[indptr[i]:indptr[i+1]]`` are
    agent i's neighbours and ``data[...]`` the matching weights. Column
    indices are sorted within each row; every undirected edge is stored
    twice (once per direction), so ``nnz == 2 * num_edges``.
    """

    indptr: np.ndarray  # (n + 1,) int64
    indices: np.ndarray  # (nnz,) int32
    data: np.ndarray  # (nnz,) float64

    def __post_init__(self):
        with span("graph.validate"):
            indptr = np.asarray(self.indptr)
            indices = np.asarray(self.indices)
            data = np.asarray(self.data)
            if indptr.ndim != 1 or indices.shape != data.shape or indices.ndim != 1:
                raise ValueError("malformed CSR arrays")
            if indptr[0] != 0 or indptr[-1] != len(indices) or np.any(np.diff(indptr) < 0):
                raise ValueError("malformed indptr")
            if np.any(data < 0.0):
                raise ValueError("weights must be non-negative")
            n = len(indptr) - 1
            if len(indices) and (indices.min() < 0 or indices.max() >= n):
                raise ValueError("column index out of range")
            rows = self.row_ids()
            if np.any(indices == rows):
                raise ValueError("weights must have zero diagonal")
            # Symmetry: the transpose has the same sorted (row, col, val) triples.
            order_t = np.lexsort((rows, indices))
            if not (
                np.array_equal(indices[order_t], rows)
                and np.array_equal(rows[order_t], indices)
                and np.allclose(data[order_t], data, atol=1e-10)
            ):
                raise ValueError("weights must be symmetric")

    @property
    def n(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.indices)

    @functools.cached_property
    def degrees(self) -> np.ndarray:
        """D_ii = sum_j W_ij. Cached — the async tick loop reads it per tick."""
        return np.bincount(self.row_ids(), weights=self.data, minlength=self.n)

    def row_ids(self) -> np.ndarray:
        """(nnz,) row index of every stored entry (COO row vector)."""
        return np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.indptr))

    def neighbors(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i] : self.indptr[i + 1]]

    def row(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        sl = slice(self.indptr[i], self.indptr[i + 1])
        return self.indices[sl], self.data[sl]

    def num_edges(self) -> int:
        return self.nnz // 2

    def max_degree(self) -> int:
        return int(np.diff(self.indptr).max(initial=0))

    def digest(self) -> str:
        """sha256 over the exact CSR contents (indptr, indices, data).

        The checkpoint fingerprint: two graphs digest equal iff every
        stored edge, weight, and the row layout are byte-identical.
        """
        h = hashlib.sha256()
        for a in (self.indptr, self.indices, self.data):
            a = np.ascontiguousarray(a)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        return h.hexdigest()

    def edge_list(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, weights) over undirected edges, one entry per i < j."""
        rows = self.row_ids()
        keep = rows < self.indices
        return rows[keep], self.indices[keep], self.data[keep]

    def is_connected(self) -> bool:
        n = self.n
        if n == 0:
            return True
        seen = np.zeros(n, dtype=bool)
        seen[0] = True
        frontier = np.array([0])
        while len(frontier):
            nxt = np.concatenate([self.neighbors(int(i)) for i in frontier])
            nxt = np.unique(nxt)
            nxt = nxt[~seen[nxt]]
            seen[nxt] = True
            frontier = nxt
        return bool(seen.all())

    def padded_neighbors(self, pad_to: int | None = None) -> tuple[np.ndarray, np.ndarray]:
        """Dense (n, K) neighbour tiles for the gather kernels.

        Rows shorter than K = max degree are padded with the agent's own
        index (in-bounds gather) at weight 0, which contributes nothing to
        the neighbour sum.
        """
        n = self.n
        K = max(self.max_degree(), 1)
        if pad_to is not None:
            if pad_to < K:
                raise ValueError(f"pad_to={pad_to} < max degree {K}")
            K = pad_to
        idx = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, K))
        w = np.zeros((n, K), dtype=np.float64)
        deg = np.diff(self.indptr)
        cols = (np.arange(K)[None, :] < deg[:, None]).nonzero()
        idx[cols] = self.indices
        w[cols] = self.data
        return idx, w

    def to_dense(self) -> AgentGraph:
        w = np.zeros((self.n, self.n), dtype=np.float64)
        w[self.row_ids(), self.indices] = self.data
        return AgentGraph(w)

    def laplacian(self) -> np.ndarray:
        return self.to_dense().laplacian()


def csr_from_coo(
    n: int, rows, cols, vals, symmetrize: bool = False, dedupe: str = "max"
) -> CSRGraph:
    """Build a :class:`CSRGraph` from COO triples.

    Entries with zero weight and duplicate (i, j) pairs are collapsed
    (``dedupe``: "max" or "sum"). With ``symmetrize`` the union with the
    transpose is taken, so callers may pass directed picks (e.g. raw k-NN
    lists) and get the paper's OR-symmetrized graph back.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if np.any(vals < 0.0):
        raise ValueError("weights must be non-negative")
    if symmetrize:
        rows, cols, vals = (
            np.concatenate([rows, cols]),
            np.concatenate([cols, rows]),
            np.concatenate([vals, vals]),
        )
    keep = (vals > 0.0) & (rows != cols)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows):
        key = rows * n + cols
        first = np.concatenate([[True], key[1:] != key[:-1]])
        group = np.cumsum(first) - 1
        if dedupe == "sum":
            merged = np.bincount(group, weights=vals)
        else:
            merged = np.full(group[-1] + 1, -np.inf)
            np.maximum.at(merged, group, vals)
        rows, cols, vals = rows[first], cols[first], merged
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return CSRGraph(indptr=indptr, indices=cols.astype(np.int32), data=vals)


# ---------------------------------------------------------------------------
# Mutable, versioned topology (capacity-padded slot form)
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    """A numpy array or a tensor (on any device) as a host numpy array."""
    return a.to("cpu").numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass(frozen=True, eq=False)
class TopologyState:
    """Mutable, versioned topology backing a :class:`CSRGraph`.

    Each row holds ``capacity`` neighbour *slots*: ``nbr[i, s]`` is the
    neighbour id (the row's own index where the slot is free, so a gather
    at it stays in range), ``w[i, s]`` its weight (0 where invalid) and
    ``valid[i, s]`` whether the slot holds a live edge; ``version`` is a
    0-d int32 counter bumped by every mutation.

    The host builders (:meth:`from_csr`, :meth:`apply_edge_updates`) give
    numpy arrays, as the reference's do; the three in-graph mutators
    (:meth:`with_edge_weights`, :meth:`deactivate_edges`,
    :meth:`activate_edges`) are torch functions on the state's device that
    keep the (n, capacity) shape and return a new state of tensors.
    Symmetry holds by construction: each mutator applies every (i, j) pair
    in both directions. A row must not repeat within one
    :meth:`activate_edges` batch (two activations racing for one free slot
    collide; which one lands is undefined, as in the reference); the host
    path has no such restriction.
    """

    nbr: np.ndarray | torch.Tensor  # (n, capacity) int32, own index where invalid
    w: np.ndarray | torch.Tensor  # (n, capacity) float, 0 where invalid
    valid: np.ndarray | torch.Tensor  # (n, capacity) bool
    version: np.ndarray | torch.Tensor  # () int32

    @property
    def n(self) -> int:
        return self.nbr.shape[0]

    @property
    def capacity(self) -> int:
        return self.nbr.shape[1]

    @classmethod
    def from_csr(cls, csr: CSRGraph, capacity: int | None = None, slack: int = 0,
                 version: int = 0) -> "TopologyState":
        """Slot form of ``csr`` (numpy); ``capacity`` defaults to max degree + slack."""
        need = max(csr.max_degree(), 1)
        if capacity is None:
            capacity = need + max(slack, 0)
        if capacity < need:
            raise ValueError(f"capacity={capacity} < max degree {need}")
        idx, w = csr.padded_neighbors(pad_to=capacity)
        deg = np.diff(csr.indptr)
        valid = np.arange(capacity)[None, :] < deg[:, None]
        return cls(nbr=idx, w=w, valid=valid, version=np.asarray(version, dtype=np.int32))

    def to_csr(self) -> CSRGraph:
        """Host-side CSR snapshot of the live edge set."""
        nbr, w, valid = _host(self.nbr), _host(self.w), _host(self.valid)
        r, s = np.nonzero(valid)
        return csr_from_coo(self.n, r, nbr[r, s], w[r, s], symmetrize=True)

    def degrees(self):
        """Weighted degrees D_ii = sum_j W_ij (w is 0 at invalid slots)."""
        return self.w.sum(axis=1)

    def neighbor_counts(self):
        """|N_i| per row — live slots only."""
        return self.valid.sum(axis=1)

    # -- in-graph mutators (torch) -------------------------------------------
    def _tensors(self):
        nbr = torch.as_tensor(self.nbr)
        dev = nbr.device
        return (nbr, torch.as_tensor(self.w).to(dev), torch.as_tensor(self.valid).to(dev),
                torch.as_tensor(self.version).to(dev))

    def _pairs(self, rows, cols, vals=None):
        """``rows``/``cols`` (and ``vals`` in the weights' dtype) as tensors
        on the state's device."""
        nbr, w, _, _ = self._tensors()
        r, c = (torch.as_tensor(a).to(device=nbr.device, dtype=torch.long) for a in (rows, cols))
        if vals is None:
            return r, c, None
        return r, c, torch.as_tensor(vals).to(device=nbr.device, dtype=w.dtype).expand(r.shape)

    def _directed(self, rows, cols, fn):
        """Apply ``fn(nbr, w, valid, rows, cols) -> (nbr, w, valid)`` both
        ways, on copies, and bump the version."""
        nbr, w, valid, version = self._tensors()
        nbr, w, valid = nbr.clone(), w.clone(), valid.clone()
        nbr, w, valid = fn(nbr, w, valid, rows, cols)
        nbr, w, valid = fn(nbr, w, valid, cols, rows)
        return dataclasses.replace(self, nbr=nbr, w=w, valid=valid, version=version + 1)

    @staticmethod
    def _first(mask):
        """(first True column, any True) of each row of a (k, capacity) mask."""
        return torch.argmax(mask.to(torch.int32), dim=1), mask.any(dim=1)

    @staticmethod
    def _put(a, rows, slot, ok, vals):
        """``a[rows, slot] = vals`` where ``ok``, in place. The rows that are
        not ``ok`` are masked out before the write (the reference drops
        them through an out-of-range sentinel, which a torch scatter
        refuses)."""
        a[rows[ok], slot[ok]] = vals[ok] if isinstance(vals, torch.Tensor) else vals

    def with_edge_weights(self, rows, cols, vals) -> "TopologyState":
        """Set the weights of existing edges (i, j), symmetrically.

        Pairs that are not live edges are ignored (nothing is activated).
        """
        rows, cols, vals = self._pairs(rows, cols, vals)

        def set_w(nbr, w, valid, r, c):
            slot, found = self._first((nbr[r] == c[:, None]) & valid[r])
            self._put(w, r, slot, found, vals)
            return nbr, w, valid

        return self._directed(rows, cols, set_w)

    def deactivate_edges(self, rows, cols) -> "TopologyState":
        """Remove edges (i, j); their slots become free for later activation."""
        rows, cols, _ = self._pairs(rows, cols)

        def drop(nbr, w, valid, r, c):
            slot, found = self._first((nbr[r] == c[:, None]) & valid[r])
            self._put(w, r, slot, found, 0.0)
            self._put(valid, r, slot, found, False)
            return nbr, w, valid

        return self._directed(rows, cols, drop)

    def activate_edges(self, rows, cols, vals) -> "TopologyState":
        """Add (or reweight) edges (i, j) within the row capacity.

        A slot already holding j (live or freed) is reused, else the first
        free slot is claimed; a row with neither drops the activation
        (capacity growth is the host's :meth:`apply_edge_updates`). At most
        one activation per row per call, the mirrored direction included.
        """
        rows, cols, vals = self._pairs(rows, cols, vals)

        def add(nbr, w, valid, r, c):
            slot_hit, found = self._first(nbr[r] == c[:, None])  # a matching slot, even freed
            slot_free, has_free = self._first(~valid[r])
            slot = torch.where(found, slot_hit, slot_free)
            ok = found | has_free
            self._put(nbr, r, slot, ok, c.to(nbr.dtype))
            self._put(w, r, slot, ok, vals)
            self._put(valid, r, slot, ok, True)
            return nbr, w, valid

        return self._directed(rows, cols, add)

    # -- host structural update (numpy) ---------------------------------------
    def apply_edge_updates(self, add_rows=(), add_cols=(), add_vals=(), remove_rows=(),
                           remove_cols=(), slack: int = 0) -> "TopologyState":
        """Host-side structural update, capacity growth included.

        Removes then adds the given (i, j) pairs (symmetrically, duplicates
        collapse by max weight) and rebuilds the slot arrays. When the new
        max degree exceeds the capacity, the capacity grows to the next
        multiple of 8; it never shrinks. The version advances by one.
        """
        nbr, wts, valid = _host(self.nbr), _host(self.w), _host(self.valid)
        r, s = np.nonzero(valid)
        rows, cols, vals = r, nbr[r, s], wts[r, s]
        if len(np.asarray(remove_rows)):
            rr = np.asarray(remove_rows, dtype=np.int64)
            rc = np.asarray(remove_cols, dtype=np.int64)
            drop_keys = np.concatenate([rr * self.n + rc, rc * self.n + rr])
            keep = ~np.isin(rows * self.n + cols, drop_keys)
            rows, cols, vals = rows[keep], cols[keep], vals[keep]
        if len(np.asarray(add_rows)):
            rows = np.concatenate([rows, np.asarray(add_rows, dtype=np.int64)])
            cols = np.concatenate([cols, np.asarray(add_cols, dtype=np.int64)])
            vals = np.concatenate([vals, np.asarray(add_vals, dtype=np.float64)])
        csr = csr_from_coo(self.n, rows, cols, vals, symmetrize=True, dedupe="max")
        need = max(csr.max_degree(), 1) + max(slack, 0)
        capacity = self.capacity
        if need > capacity:
            capacity = ((need + 7) // 8) * 8
        return type(self).from_csr(csr, capacity=capacity, version=int(_host(self.version)) + 1)


def neighbor_counts(graph) -> np.ndarray:
    """|N_i| per agent (message accounting), vectorized for either backend."""
    if isinstance(graph, CSRGraph):
        return np.diff(graph.indptr)
    return np.count_nonzero(graph.weights > 0.0, axis=1)


def as_csr(graph) -> CSRGraph:
    return graph if isinstance(graph, CSRGraph) else graph.to_csr()


def as_dense(graph) -> AgentGraph:
    return graph.to_dense() if isinstance(graph, CSRGraph) else graph


def dense_weights(graph) -> np.ndarray:
    """(n, n) weight matrix of either representation. O(n^2) — small n only."""
    return as_dense(graph).weights


# ---------------------------------------------------------------------------
# Sparse constructors (never materialize (n, n))
# ---------------------------------------------------------------------------


def knn_graph(
    features: np.ndarray, k: int = 10, block_rows: int | None = None
) -> CSRGraph:
    """Sparse OR-symmetrized cosine k-NN graph (Sec. 5.2 semantics).

    Streams the similarity computation in (block_rows, n) slabs so peak
    memory is O(block_rows * n), never (n, n). Matches
    :func:`knn_cosine_graph` exactly on the same input.
    """
    f = np.asarray(features, dtype=np.float64)
    n = f.shape[0]
    # Clamp like knn_cosine_graph: k >= n means everyone is a neighbour.
    k = min(k, n - 1)
    if k <= 0:
        return csr_from_coo(n, [], [], [])
    norms = np.linalg.norm(f, axis=1, keepdims=True)
    unit = f / np.where(norms == 0.0, 1.0, norms)
    if block_rows is None:
        block_rows = max(1, min(4096, (1 << 25) // max(n, 1)))
    rows = np.empty(n * k, dtype=np.int64)
    cols = np.empty(n * k, dtype=np.int64)
    for lo in range(0, n, block_rows):
        hi = min(lo + block_rows, n)
        sim = unit[lo:hi] @ unit.T  # (b, n) slab
        sim[np.arange(hi - lo), np.arange(lo, hi)] = -np.inf
        nn = np.argpartition(-sim, k, axis=1)[:, :k]
        rows[lo * k : hi * k] = np.repeat(np.arange(lo, hi), k)
        cols[lo * k : hi * k] = nn.ravel()
    return csr_from_coo(n, rows, cols, np.ones(n * k), symmetrize=True)


def random_geometric_graph(
    n: int,
    rng: np.random.Generator,
    avg_degree: float = 16.0,
    radius: float | None = None,
    weight: float = 1.0,
    min_degree: int = 1,
    return_pos: bool = False,
) -> CSRGraph | tuple[CSRGraph, np.ndarray]:
    """Random geometric graph on [0, 1]^2 via grid-cell bucketing: O(n * deg).

    Agents are uniform points; i ~ j iff ||x_i - x_j|| <= radius (default
    radius targets ``avg_degree`` via E[deg] = n pi r^2). Isolated agents are
    linked to their nearest peer so every D_ii > 0 (Eq. 4 divides by it).
    With ``return_pos`` the (n, 2) agent positions are returned alongside
    the graph — the coordinates a space-filling-curve relabel pass
    (``repro.sim.partition.sfc_order``) sorts by.
    """
    pos = rng.random((n, 2))
    if radius is None:
        radius = float(np.sqrt(avg_degree / (np.pi * max(n - 1, 1))))
    cell = np.floor(pos / radius).astype(np.int64)
    ncells = int(np.ceil(1.0 / radius)) + 1
    cell_id = cell[:, 0] * ncells + cell[:, 1]
    order = np.argsort(cell_id, kind="stable")
    sorted_ids = cell_id[order]
    uniq, starts = np.unique(sorted_ids, return_index=True)
    starts = np.append(starts, n)
    bucket = {int(u): order[s:e] for u, s, e in zip(uniq, starts[:-1], starts[1:])}

    rows_acc, cols_acc = [], []
    r2 = radius * radius
    # Half-neighbourhood offsets so each cell pair is visited once.
    half = [(0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]
    for u, members in bucket.items():
        cx, cy = divmod(u, ncells)
        for dx, dy in half:
            other = bucket.get((cx + dx) * ncells + (cy + dy))
            if other is None:
                continue
            d2 = ((pos[members][:, None, :] - pos[other][None, :, :]) ** 2).sum(-1)
            a, b = np.nonzero(d2 <= r2)
            if dx == 0 and dy == 0:
                keep = a < b  # dedupe within-cell pairs
                a, b = a[keep], b[keep]
            rows_acc.append(members[a])
            cols_acc.append(other[b])
    rows = np.concatenate(rows_acc) if rows_acc else np.zeros(0, dtype=np.int64)
    cols = np.concatenate(cols_acc) if cols_acc else np.zeros(0, dtype=np.int64)

    if min_degree > 0 and n > 1:
        deg = np.bincount(np.concatenate([rows, cols]), minlength=n)
        need = min(min_degree, n - 1)
        for i in np.nonzero(deg < need)[0]:
            # Link to the (need) nearest peers; existing radius edges to
            # them dedupe away in csr_from_coo, so post-union degree >= need.
            d2 = ((pos - pos[i]) ** 2).sum(-1)
            d2[i] = np.inf
            nearest = np.argpartition(d2, need)[:need]
            rows = np.append(rows, np.full(need, i))
            cols = np.append(cols, nearest)
    csr = csr_from_coo(n, rows, cols, np.full(len(rows), weight), symmetrize=True)
    return (csr, pos) if return_pos else csr


def confidences(num_examples: np.ndarray, floor: float = 1e-3) -> np.ndarray:
    """Paper footnote 2: c_i = m_i / max_j m_j (plus small constant if m_i=0)."""
    m = np.asarray(num_examples, dtype=np.float64)
    mx = m.max()
    if mx <= 0:
        return np.full_like(m, floor)
    c = m / mx
    return np.clip(c, floor, 1.0)

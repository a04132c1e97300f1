"""Versioned Theta snapshots and batched personalized inference.

Port of ``repro.serve.handle``. The paper trains one personalized linear
model per agent (row ``i`` of Theta); this is the read path that answers
agent ``i``'s prediction requests while the swarm keeps training. The
trainer publishes version-tagged snapshots from inside ``run(...,
snapshot_every=, serve=)``, and a :class:`ServeHandle` answers batched
``predict(agent_ids, X)`` against the latest published version with one
row gather and dot over exactly the requested rows, routing original
agent ids through the partition's ``shard_of``/``local_of`` maps.

A snapshot is a copy on the device, not a reference: the port's slot
writes Theta in place and a captured chunk's replay writes the same
addresses, so a reference to the live tensor would change under a
reader. ``publish`` clones the ``(n, p)`` models (the sharded engine's
``(S, R, p)`` owned tiles: no ``(n, p)`` gather, no host copy) on the
engine's stream and records a CUDA event after the copy; ``run`` gives
it the version from its own slot count, so publishing reads
nothing from the card, and the trainer only waits for the previous
publication's copy (it stays at most one period ahead of the card).
``predict`` serves the newest snapshot whose copy has completed, on a
stream of the handle's own that also waits for the event, so a reader
never sees a half-written copy and never waits for the trainer's later
chunks. The ring of ``ServeSpec.buffers`` snapshots keeps the newest
versions alive; a reader that pinned an older one keeps its tensor alive
itself.

Ids not yet in the swarm (scheduled-but-pending arrivals, or ids beyond
``n``) are served by a cold-start tier that synthesizes their row as the
Eq. 16 confidence-zero neighbour average, the warm start
``ArrivalConfig`` applies at admission, folded into the same gather as a
K-neighbour weighted row instead of a K = 1 self row.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.obs.metrics import serve_counters_init


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Frozen serving configuration.

    ``buffers`` sets the snapshot ring depth: publication fills the next
    slot and swaps the reader reference, so at least the last
    ``buffers`` published versions stay alive. ``neighbors`` maps a cold
    agent id to the warm ids whose Eq. 16 average synthesizes its row;
    per-call ``predict(..., neighbors=)`` entries override it.
    """

    buffers: int = 2
    neighbors: dict | None = None

    def __post_init__(self):
        """Validate at construction: a bad spec never reaches serving."""
        if int(self.buffers) < 2:
            raise ValueError(
                f"ServeSpec.buffers={self.buffers}: double-buffered publication "
                "needs at least 2 snapshot slots"
            )
        if self.neighbors is not None:
            for cold, nbrs in self.neighbors.items():
                if len(tuple(nbrs)) == 0:
                    raise ValueError(
                        f"ServeSpec.neighbors[{cold}] is empty; the Eq. 16 "
                        "cold-start average needs at least one neighbour"
                    )

    @classmethod
    def coerce(cls, value) -> "ServeSpec":
        """``None`` -> defaults, a spec passes through; anything else (bare
        strings included) is a TypeError."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        raise TypeError(
            f"serve spec must be a ServeSpec or None for defaults, "
            f"got {type(value).__name__}: {value!r}"
        )


class ThetaSnapshot(NamedTuple):
    """One published serving view of the swarm's models."""

    version: int  # trainer slot counter at publication
    tiles: torch.Tensor  # (S, R, p) device copy (a single-device engine: S = 1, R = n)
    shard_of: np.ndarray | None  # (n,) owning shard per original id (None: S = 1 identity)
    local_of: np.ndarray | None  # (n,) local row within the owning shard
    pending: frozenset  # ids scheduled but not yet admitted: served cold
    ready: object = None  # CUDA event recorded after the copy (None on the CPU)

    def is_ready(self) -> bool:
        """Whether the copy has completed (always, on the CPU)."""
        return self.ready is None or self.ready.query()


class SnapshotStore:
    """Version-tagged snapshot ring.

    ``publish`` fills the oldest ring slot and swaps the single reader
    reference under a lock; ``latest`` is one attribute read with no lock,
    so a reader mid-``predict`` keeps its pinned snapshot while the
    trainer publishes behind it. On the card a snapshot is published
    when its copy is enqueued; :attr:`latest_ready` is the newest one
    whose copy has completed, which readers serve without waiting.
    """

    def __init__(self, buffers: int = 2):
        """Create an empty ring of ``buffers`` snapshot slots."""
        self._ring: list = [None] * int(buffers)
        self._idx = 0
        self._lock = threading.Lock()
        self._latest: ThetaSnapshot | None = None

    def publish(self, snap: ThetaSnapshot) -> None:
        """Install ``snap`` as the served version (atomic reference swap)."""
        with self._lock:
            self._ring[self._idx] = snap
            self._idx = (self._idx + 1) % len(self._ring)
            self._latest = snap

    @property
    def latest(self) -> ThetaSnapshot:
        """The newest published snapshot (raises before the first publish)."""
        snap = self._latest
        if snap is None:
            raise _unpublished()
        return snap

    @property
    def latest_version(self) -> int:
        """Version tag of the newest published snapshot."""
        return self.latest.version

    @property
    def published(self) -> bool:
        """Whether a first snapshot has been published."""
        return self._latest is not None

    @property
    def latest_ready(self) -> ThetaSnapshot:
        """The newest snapshot in the ring whose copy has completed (the
        latest one where none has: the reader's stream then waits for it)."""
        return self.read()[1]

    def read(self) -> tuple:
        """``(latest version, newest ready snapshot)``, read under one lock
        so a reader's lag is counted against the version that was newest
        when it chose its snapshot."""
        with self._lock:
            latest = self._latest
            k = len(self._ring)
            ring = [self._ring[(self._idx - 1 - j) % k] for j in range(k)]
        if latest is None:
            raise _unpublished()
        ready = next((snap for snap in ring if snap is not None and snap.is_ready()), latest)
        return latest.version, ready


def _unpublished() -> RuntimeError:
    return RuntimeError(
        "no snapshot published yet; run the engine with "
        "run(..., snapshot_every=, serve=handle) or serve from a "
        "checkpoint via repro_torch.serve.serve_from_checkpoint"
    )


class ServeResult(NamedTuple):
    """One answered batch: scores or rows, and the version that served it."""

    values: np.ndarray  # (B,) float32 scores from predict(), (B, p) rows from rows()
    version: int  # snapshot version (trainer slot) the batch was served from
    cold: np.ndarray  # (B,) bool: True where the row was Eq. 16 synthesized


def _gather_rows(tiles, sids, lids, w):
    """Gather + Eq. 16 combine: ``(B, K)`` routed rows -> ``(B, p)`` float32.

    The reference's ``einsum("bk,bkp->bp")``, written as a product and a
    sum over K: no matmul, so no TF32 setting rounds a row, and a warm
    row (K = 1 self row of weight 1, padding weight 0) is its snapshot
    row bit for bit. Touches exactly B * K rows of the tiles.
    """
    rows = tiles[sids, lids].to(w.dtype)  # (B, K, p)
    return (w.unsqueeze(-1) * rows).sum(dim=1)


def _score_rows(tiles, sids, lids, w, X):
    """Gather, combine and a per-row dot: ``(B,)`` scores."""
    theta = _gather_rows(tiles, sids, lids, w)
    return (theta * X.to(theta.dtype)).sum(dim=-1)


class ServeHandle:
    """Batched personalized inference over published Theta snapshots.

    Front a live engine with :meth:`for_engine` and ``run(...,
    snapshot_every=, serve=handle)``, or a finished or crash-recovered
    run with :func:`repro_torch.serve.serve_from_checkpoint`; the read API
    is the same either way. Thread-safe: ``predict`` may run from request
    threads while the training thread publishes.
    """

    def __init__(self, store: SnapshotStore, spec: ServeSpec, *, n: int, p: int):
        """Wrap ``store``; prefer :meth:`for_engine` or checkpoint serving."""
        self.spec = spec
        self.n = int(n)
        self.p = int(p)
        self._store = store
        self._engine = None
        self._lock = threading.Lock()
        self._counters = serve_counters_init()
        self._streams: dict = {}  # device -> the stream predict reads on
        self._publish_events: list = []  # (start, end) CUDA events of each copy
        self._publish_device_s = 0.0
        self._lag_start = (0, 0)  # (last, largest) lag counted at a request's start

    # -- publication -------------------------------------------------------
    @classmethod
    def for_engine(cls, engine, spec: ServeSpec | None = None) -> "ServeHandle":
        """A handle bound to a live engine, ready for ``run(serve=...)``.

        When the engine carries an arrival scenario with an explicit
        attachment map and the spec names no neighbours, the arrival map
        becomes the cold-start default: pending arrivals are then served
        with exactly the neighbours they will warm-start from at admission.
        """
        spec = ServeSpec.coerce(spec)
        arrival = getattr(getattr(engine, "scenario", None), "arrival", None)
        if spec.neighbors is None and arrival is not None and arrival.attach:
            spec = dataclasses.replace(
                spec, neighbors={int(k): tuple(v) for k, v in arrival.attach.items()})
        handle = cls(SnapshotStore(spec.buffers), spec, n=engine.n, p=engine.p)
        handle._engine = engine
        return handle

    def publish(self, state, version: int | None = None) -> None:
        """Publish the engine state's Theta as the next served version.

        The copy is the sharded engine's ``(S, R, p)`` owned tiles (a
        single-device engine's ``(1, n, p)``), cloned on the engine's
        current stream, with the partition's ownership maps so routing
        survives repartitions; on the card a CUDA event marks the copy's
        end. ``version`` is the state's slot counter where the caller
        knows it on the host (``run`` counts the slots it drives);
        else it is read from the state, which waits for the card. On the
        card the trainer waits for the previous publication's copy, not
        for this one: it runs at most one publication period ahead of the
        card, which keeps working meanwhile, so the newest snapshot is at
        most one period from ready.
        """
        eng = self._engine
        if eng is None:
            raise RuntimeError(
                "this ServeHandle is not bound to a live engine; build it "
                "with ServeHandle.for_engine(engine) (checkpoint-served "
                "handles are read-only)"
            )
        t0 = time.perf_counter()
        version = eng._ptr_of(state) if version is None else int(version)
        src = state.Theta if hasattr(eng, "part") else state.Theta.unsqueeze(0)
        tiles = torch.empty_like(src, memory_format=torch.contiguous_format)
        ready = start = None
        if src.is_cuda:
            prev = self._store._latest
            if prev is not None and prev.ready is not None:
                prev.ready.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            ready = torch.cuda.Event(enable_timing=True)
            start.record()
            tiles.copy_(src)
            ready.record()
        else:
            tiles.copy_(src)
        part = getattr(eng, "part", None)
        snap = ThetaSnapshot(
            version=version,
            tiles=tiles,
            shard_of=None if part is None else part.shard_of,
            local_of=None if part is None else part.local_of,
            pending=frozenset(eng._pending),
            ready=ready,
        )
        self._store.publish(snap)
        dt = time.perf_counter() - t0
        with self._lock:
            self._counters["serve_snapshots_published"] += 1
            self._counters["serve_publish_s_total"] += dt
            if ready is not None:
                self._publish_events.append((start, ready))

    def publish_device_seconds(self) -> float:
        """Device seconds spent in the publications' copies so far (CUDA
        events around each clone; waits for the pending ones, 0 on the CPU)."""
        with self._lock:
            events, self._publish_events = self._publish_events, []
        total = 0.0
        for start, end in events:
            end.synchronize()
            total += start.elapsed_time(end) * 1e-3
        with self._lock:
            self._publish_device_s += total
            return self._publish_device_s

    # -- the read path -----------------------------------------------------
    def snapshot(self) -> ThetaSnapshot:
        """Pin the newest ready version for a multi-call consistent read
        (pass it back via ``predict(..., at=snap)``)."""
        return self._store.latest_ready

    @property
    def version(self) -> int:
        """Version tag (trainer slot) of the latest published snapshot."""
        return self._store.latest_version

    @property
    def published(self) -> bool:
        """Whether a first snapshot has been published (``run`` publishes
        its starting version before the first slot)."""
        return self._store.published

    def counters(self) -> dict:
        """A copy of the host-side ``serve_*`` counters
        (:data:`repro_torch.obs.SERVE_COUNTERS` layout). The version lag is
        the reference's: counted when the request ends, the newest published
        version then less the version that served it."""
        with self._lock:
            return dict(self._counters)

    @property
    def version_lag_start(self) -> tuple:
        """``(last, largest)`` lag counted at a request's start: the newest
        published version when it chose its snapshot, less the served one.
        The end lag (``serve_version_lag``) adds the publications made while
        the request ran."""
        with self._lock:
            return self._lag_start

    def rows(self, agent_ids, neighbors=None, at=None) -> ServeResult:
        """The served ``(B, p)`` model rows (float32) for ``agent_ids``.

        Warm ids return their snapshot row bit for bit (float64 and bf16
        tiles rounded to float32); cold ids the Eq. 16 neighbour average.
        """
        ids = self._check_ids(agent_ids)
        latest, snap = self._choose(at)
        plan, cold = self._route(ids, snap, neighbors)
        out = self._serve(snap, plan)
        self._account(ids.size, int(cold.sum()), snap.version, latest)
        return ServeResult(values=out, version=snap.version, cold=cold)

    def predict(self, agent_ids, X, neighbors=None, at=None) -> ServeResult:
        """Batched personalized predictions ``<theta_i, x_b>`` -> (B,).

        ``agent_ids`` is (B,) original ids; ``X`` is (B, p) features.
        Served from the latest published snapshot (or a pinned ``at=``
        one): one gather and dot over exactly the requested rows. Cold ids
        (pending arrivals, or ids >= n) need neighbours, from
        ``neighbors={id: (warm ids...)}``, the spec, or the engine's arrival
        attachment map, and are scored on their Eq. 16 confidence-zero
        average row.
        """
        ids = self._check_ids(agent_ids)
        X = np.asarray(X)
        if X.shape != (ids.size, self.p):
            raise ValueError(
                f"X must be (B, p) = ({ids.size}, {self.p}) to match "
                f"agent_ids; got {X.shape}"
            )
        latest, snap = self._choose(at)
        plan, cold = self._route(ids, snap, neighbors)
        y = self._serve(snap, plan, np.ascontiguousarray(X, dtype=np.float32))
        self._account(ids.size, int(cold.sum()), snap.version, latest)
        return ServeResult(values=y, version=snap.version, cold=cold)

    # -- internals ---------------------------------------------------------
    def _choose(self, at):
        """The newest published version at the request's start and the
        snapshot that serves it (the newest ready one, or the pinned ``at``)."""
        latest, ready = self._store.read()
        return latest, (ready if at is None else at)

    def _reader_stream(self, device):
        with self._lock:
            stream = self._streams.get(device)
            if stream is None:
                stream = self._streams[device] = torch.cuda.Stream(device)
            return stream

    def _serve(self, snap, plan, X=None) -> np.ndarray:
        """The gathered rows (``X`` None) or the scores against ``X`` of the
        ``(sids, lids, w)`` plan, on the host. On the card they are computed
        on the handle's reader stream, after the snapshot's copy (its
        event), and the tiles are marked as used there so the allocator
        keeps them until the read is done."""
        tiles = snap.tiles

        def compute():
            sids, lids, w = (torch.from_numpy(a).to(tiles.device) for a in plan)
            if X is None:
                out = _gather_rows(tiles, sids, lids, w)
            else:
                out = _score_rows(tiles, sids, lids, w, torch.from_numpy(X).to(tiles.device))
            return out.to("cpu").numpy()

        if not tiles.is_cuda:
            return compute()
        stream = self._reader_stream(tiles.device)
        with torch.cuda.stream(stream):
            if snap.ready is not None:
                stream.wait_event(snap.ready)
            tiles.record_stream(stream)
            return compute()

    def _check_ids(self, agent_ids) -> np.ndarray:
        ids = np.asarray(agent_ids, dtype=np.int64).ravel()
        if ids.size == 0:
            raise ValueError("empty agent_ids batch")
        if (ids < 0).any():
            raise ValueError(f"negative agent ids: {ids[ids < 0][:5].tolist()}")
        return ids

    def _neighbors_for(self, i: int, neighbors) -> tuple:
        if neighbors is not None and i in neighbors:
            return tuple(int(j) for j in neighbors[i])
        if self.spec.neighbors is not None and i in self.spec.neighbors:
            return tuple(int(j) for j in self.spec.neighbors[i])
        raise ValueError(
            f"agent id {i} is not in the swarm yet and has no attachment "
            f"neighbours; pass neighbors={{{i}: (warm ids...)}} (or set "
            f"ServeSpec.neighbors) so Eq. 16 can synthesize its row"
        )

    def _route(self, ids, snap, neighbors):
        """Original ids -> the ``(B, K)`` (shard, local, weight) gather plan
        and the (B,) cold mask (numpy, host side).

        Warm ids are a K = 1 self-gather of weight 1 (padded slots route to
        row 0 with weight 0); cold ids spread uniform weight over their
        neighbours: the Eq. 16 average with zero confidence and the
        uniform attachment weights ``ArrivalConfig`` uses.
        """
        cold = ids >= self.n
        pending = np.fromiter(snap.pending, np.int64, len(snap.pending))
        if pending.size:
            cold |= np.isin(ids, pending)
        cold_b = np.flatnonzero(cold)
        lists = [self._neighbors_for(i, neighbors) for i in ids[cold_b].tolist()]
        lens = np.fromiter(map(len, lists), np.int64, len(lists))
        flat = np.fromiter(itertools.chain.from_iterable(lists), np.int64, int(lens.sum()))
        bad = (flat >= self.n) | (flat < 0) | np.isin(flat, pending)
        if bad.any():
            k = int(np.searchsorted(np.cumsum(lens), np.flatnonzero(bad)[0], side="right"))
            i = int(ids[cold_b[k]])
            raise ValueError(
                f"cold agent id {i}: attachment neighbours "
                f"{[j for j in lists[k] if j >= self.n or j < 0 or j in snap.pending]} are not "
                f"established in the swarm (pending or out of range)"
            )
        K = max(1, int(lens.max(initial=0)))
        gids = np.zeros((ids.size, K), dtype=np.int64)
        w = np.zeros((ids.size, K), dtype=np.float32)
        gids[:, 0] = np.where(cold, 0, ids)
        w[:, 0] = np.where(cold, 0.0, 1.0)
        rows = np.repeat(cold_b, lens)
        cols = np.arange(flat.size) - np.repeat(np.cumsum(lens) - lens, lens)
        gids[rows, cols] = flat
        w[rows, cols] = np.repeat(1.0 / np.maximum(lens, 1), lens)
        if snap.shard_of is None:
            sids, lids = np.zeros_like(gids), gids
        else:
            sids = snap.shard_of[gids].astype(np.int64)
            lids = snap.local_of[gids].astype(np.int64)
        return (sids, lids, w), cold

    def _account(self, batch: int, cold: int, served_version: int, latest_at_start: int) -> None:
        lag_start = latest_at_start - served_version
        lag = self._store.latest_version - served_version
        with self._lock:
            self._lag_start = (lag_start, max(self._lag_start[1], lag_start))
            c = self._counters
            c["serve_requests"] += 1
            c["serve_predictions"] += batch
            c["serve_batch_rows_max"] = max(c["serve_batch_rows_max"], batch)
            c["serve_cold_starts"] += cold
            c["serve_version_lag"] = lag
            c["serve_version_lag_max"] = max(c["serve_version_lag_max"], lag)

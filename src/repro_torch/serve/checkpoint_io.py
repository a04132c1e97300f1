"""Read-only serving from a ``repro_torch.checkpoint`` engine entry.

Port of ``repro.serve.checkpoint_io``. The same :class:`ServeHandle` API
that fronts a live engine fronts a finished or crash-recovered run:
resolve the newest verified entry of a rotation directory (per-file
sha256, torn-entry fallback), check the saved engine fingerprint against
what the caller expects, and stream the per-shard Theta blocks one file
at a time into an ``(S, R, p)`` tile stack on the device. The ownership
routing is rebuilt from each shard file's own original-id list, so no
graph, partition or ``(n, p)`` gather is needed. No engine and no random
stream is restored, so an entry the card wrote serves on the CPU and an
entry of the JAX package serves here (the files are the reference's).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (
    CheckpointError,
    _from_numpy,
    _load_arrays,
    _load_file,
    _resolve_entry,
)
from repro_torch.device import resolve_device
from repro_torch.serve.handle import ServeHandle, ServeSpec, SnapshotStore, ThetaSnapshot


def _check_expected(entry: str, saved: dict, expect: dict | None) -> None:
    """Reject a serve request whose caller expects a different swarm:
    every key of ``expect`` (any subset of the saved fingerprint: ``n``,
    ``p``, ``dtype``, ``engine``, ``graph``, ...) must match exactly."""
    if not expect:
        return
    for key in sorted(expect):
        if saved.get(key) != expect[key]:
            raise CheckpointError(
                f"{entry}: fingerprint mismatch on {key!r}: checkpoint has "
                f"{saved.get(key)!r}, caller expects {expect[key]!r}"
            )


def _pending_of(entry: str, fp: dict) -> frozenset:
    if not fp.get("dynamic"):
        return frozenset()
    topo = _load_file(entry, "topology.npz")
    return frozenset(int(i) for i in topo["pending"])


def _async_snapshot(entry: str, manifest: dict, device) -> ThetaSnapshot:
    """Theta of an ``AsyncEngine`` entry as a single (1, n, p) tile."""
    by_path = {r["path"]: r for r in manifest["leaves"]}
    rec = by_path[".Theta"]
    data = _load_arrays(entry, manifest)
    theta = _from_numpy(data[rec["key"]], rec["dtype"]).to(device)
    return ThetaSnapshot(
        version=int(manifest["step"]),
        tiles=theta.unsqueeze(0),
        shard_of=None,
        local_of=None,
        pending=_pending_of(entry, manifest["fingerprint"]),
    )


def _sharded_snapshot(entry: str, manifest: dict, device) -> ThetaSnapshot:
    """Stream the shard files into an (S, R, p) device tile stack plus the
    ownership maps: one shard file on the host at a time, each block
    written into the stack as it is read, at the local rows its saved id
    list dictates; the same ids define ``shard_of``/``local_of``."""
    fp = manifest["fingerprint"]
    S, n, p = int(fp["num_shards"]), int(fp["n"]), int(fp["p"])
    R = int(np.max(_load_file(entry, "partition.npz")["sizes"]))
    bf16 = set(manifest.get("bf16", []))
    shard_of = np.full(n, -1, dtype=np.int32)
    local_of = np.zeros(n, dtype=np.int32)
    tiles = None
    for s in range(S):
        fname = f"shard_{s}.npz"
        arrs = _load_file(entry, fname)
        ids = np.asarray(arrs["ids"], dtype=np.int64)
        theta = _from_numpy(arrs["theta"], "bfloat16" if f"{fname}/theta" in bf16
                            else str(arrs["theta"].dtype))
        if tiles is None:
            tiles = torch.zeros((S, R, p), dtype=theta.dtype, device=device)
        tiles[s, : ids.size] = theta.to(device)
        shard_of[ids] = s
        local_of[ids] = np.arange(ids.size, dtype=np.int32)
    if tiles is None or (shard_of < 0).any():
        raise CheckpointError(f"{entry}: shard files do not cover all {n} agents")
    return ThetaSnapshot(
        version=int(manifest["step"]),
        tiles=tiles,
        shard_of=shard_of,
        local_of=local_of,
        pending=_pending_of(entry, fp),
    )


def serve_from_checkpoint(path: str, spec: ServeSpec | None = None,
                          expect_fingerprint: dict | None = None,
                          device="cuda") -> ServeHandle:
    """A read-only :class:`ServeHandle` over a checkpointed swarm, its
    tiles on ``device`` (default the card; ``"cpu"`` on request).

    ``path`` is a rotation directory or a single entry (the resolution of
    :func:`repro_torch.checkpoint.restore`: the newest sha256-verified
    entry wins, torn entries fall back). Non-engine checkpoints are
    rejected, and ``expect_fingerprint`` pins any subset of the saved
    engine fingerprint (``{"n": ..., "dtype": ...}``) before a single
    prediction is served. The handle's version is the saved step;
    ``publish`` raises (publication needs a live engine).
    """
    dev = resolve_device(device, "device")
    entry, manifest = _resolve_entry(path)
    if manifest.get("kind") != "engine":
        raise CheckpointError(
            f"{entry}: not an engine checkpoint (kind={manifest.get('kind')!r}); "
            "serve_from_checkpoint needs a save_engine_checkpoint entry"
        )
    fp = manifest["fingerprint"]
    _check_expected(entry, fp, expect_fingerprint)
    spec = ServeSpec.coerce(spec)
    if fp["engine"] == "sharded":
        snap = _sharded_snapshot(entry, manifest, dev)
    else:
        snap = _async_snapshot(entry, manifest, dev)
    store = SnapshotStore(spec.buffers)
    store.publish(snap)
    handle = ServeHandle(store, spec, n=int(fp["n"]), p=int(fp["p"]))
    with handle._lock:
        handle._counters["serve_snapshots_published"] += 1
    return handle

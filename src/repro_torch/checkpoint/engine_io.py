"""Engine-aware checkpointing: full resume closures for both engines.

Port of ``repro.checkpoint.engine_io``, on the crash-safe entry
primitives of :mod:`repro_torch.checkpoint.checkpoint` (staged
``<entry>.tmp`` writes, per-file sha256, atomic rename, ``keep_last``
rotation). An entry holds everything a killed run needs to resume
exactly:

* **AsyncEngine**: one ``state.npz`` of every :class:`SimState` leaf
  (Theta, the delay ring ``hist``, the slot counter, the churn flags, the
  random stream as the ``.generator`` leaf, the update state, the DP
  accountant's counts included, and the metrics counters), plus
  ``topology.npz`` for a dynamic run (the live CSR graph, slot capacity,
  topology version, pending-arrival ids) and the host topology log.
* **ShardedAsyncEngine**: a per-shard layout with no gather: one
  ``shard_<s>.npz`` per shard with that shard's owned rows (Theta block,
  churn flags, per-agent update-state leaves, ``last_wake``) keyed by
  original agent ids, plus ``partition.npz`` (the frozen ownership:
  order, block bounds, tile width) and ``scalars.npz`` (the generator's
  state, the (S,) counters, the error-feedback accumulator ``ef``, the
  counter-type metrics). Theta never becomes one (n, p) host array, at
  save or at load; the slab's halo rows are derived (the slot's exchange
  rewrites them) and are not saved.

Restore checks the manifest's fingerprint (graph sha256, n, p, dtype, an
:class:`repro_torch.sim.EngineConfig` digest, topology version) before
touching the engine, and a sharded entry restores at another shard count
by re-tiling the saved rows through :meth:`GraphPartition.place_rows`.
Same-S resume is bit for bit; the elastic policies are the reference's
(counters collapsed into shard 0, ``ef`` restarted) except that the one
generator is kept (``src/repro_torch/DEVIATIONS.md``).

The files and keys are the reference's, so ``repro.serve`` serves a
port entry and the port serves a reference entry; a full engine restore
across packages is refused by the fingerprint (the config digests and
state structures differ: the port's counters are int64, its stream a
generator).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (
    CheckpointError,
    _check_digest,
    _flatten_with_paths,
    _from_numpy,
    _leaf_dtype_name,
    _load_arrays,
    _load_file,
    _resolve_entry,
    _save_entry,
    _to_numpy,
    _unflatten,
    structure_digest,
)
from repro_torch.core.graph import CSRGraph, TopologyState, as_csr
from repro_torch.sim.partition import partition_from_ownership, partition_graph

# Placement fields: they pick where the run executes, not what it computes.
# ``device`` is one of them: the CPU restores entries that the card wrote.
_EXCLUDED_CONFIG_FIELDS = ("partition", "devices", "device")


# ---------------------------------------------------------------------------
# Fingerprint
# ---------------------------------------------------------------------------


def _dtype_name(dt) -> str:
    """numpy's name for a torch or numpy dtype (``float32``, ``bool``, ...)."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _token(v) -> str:
    """Deterministic string form of a config field value (digest input)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return repr(v)
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu").numpy()
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        return f"array:{a.dtype}:{a.shape}:{hashlib.sha256(a.tobytes()).hexdigest()[:16]}"
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        inner = ",".join(f"{f.name}={_token(getattr(v, f.name))}" for f in dataclasses.fields(v))
        return f"{type(v).__name__}({inner})"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k!r}:{_token(v[k])}" for k in sorted(v)) + "}"
    if isinstance(v, (list, tuple, set, frozenset)):
        items = sorted(v, key=repr) if isinstance(v, (set, frozenset)) else v
        return "[" + ",".join(_token(x) for x in items) + "]"
    if isinstance(v, (torch.dtype, np.dtype)) or (isinstance(v, type)
                                                  and issubclass(v, np.generic)):
        return f"dtype:{_dtype_name(v)}"
    r = repr(v)
    # Default object reprs embed a memory address: useless as identity.
    return type(v).__name__ if " at 0x" in r else r


def config_digest(cfg) -> str:
    """sha256 identity of an :class:`EngineConfig`, placement fields
    (``partition``, ``devices``, ``device``) excluded: they pick where the
    run executes, not what it computes."""
    parts = [
        f"{f.name}={_token(getattr(cfg, f.name))}"
        for f in dataclasses.fields(cfg)
        if f.name not in _EXCLUDED_CONFIG_FIELDS
    ]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


def _is_sharded(engine) -> bool:
    return hasattr(engine, "part")


def _live_csr(engine) -> CSRGraph:
    """The engine's current collaboration graph (live CSR when dynamic)."""
    if getattr(engine, "_csr", None) is not None:
        return engine._csr
    return as_csr(engine.update.graph)


def engine_fingerprint(engine) -> dict:
    """The identity a checkpoint must match to restore into ``engine``
    (``dtype`` in numpy's spelling, as the reference writes it)."""
    fp = {
        "engine": "sharded" if _is_sharded(engine) else "async",
        "n": int(engine.n),
        "p": int(engine.p),
        "dtype": _dtype_name(engine.dtype),
        "config": config_digest(engine.config),
        "metrics": engine._macc is not None,
        "dynamic": bool(engine.dynamic),
        "graph": _live_csr(engine).digest(),
        "topology_version": (
            int(np.asarray(engine.topo.version))
            if getattr(engine, "topo", None) is not None
            else 0
        ),
    }
    if _is_sharded(engine):
        fp["num_shards"] = int(engine.num_shards)
    return fp


def _check_fingerprint(entry: str, saved: dict, now: dict) -> None:
    """Reject a checkpoint/engine identity mismatch with a clear error.

    ``num_shards`` may differ (elastic restore), and ``graph`` /
    ``topology_version`` come from the checkpoint on dynamic runs
    (restore adopts the saved topology), so only static engines compare
    graphs.
    """
    strict = ["engine", "n", "p", "dtype", "config", "metrics", "dynamic"]
    if not saved.get("dynamic"):
        strict.append("graph")
    for key in strict:
        if saved.get(key) != now.get(key):
            raise CheckpointError(
                f"{entry}: fingerprint mismatch on {key!r}: checkpoint has "
                f"{saved.get(key)!r}, engine has {now.get(key)!r}"
            )


def _generator(entry: str, saved_device: str | None, arr, device: torch.device):
    """A new generator on ``device`` continuing the saved stream. A CUDA
    generator's state (seed, offset) and a CPU one's (mt19937) are
    different formats: a stream never crosses device types."""
    if saved_device is not None and saved_device != device.type:
        raise CheckpointError(
            f"{entry}: the random stream '.generator' was saved from a {saved_device} "
            f"generator and cannot continue on a {device.type} engine (the two "
            "generators' states are different formats)"
        )
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint8)))
    return gen


# ---------------------------------------------------------------------------
# Topology capture (shared)
# ---------------------------------------------------------------------------


def _topology_arrays(engine) -> dict:
    csr = engine._csr
    arrs = {
        "indptr": np.asarray(csr.indptr, np.int64),
        "indices": np.asarray(csr.indices, np.int32),
        "data": np.asarray(csr.data, np.float64),
        "pending": np.asarray(sorted(engine._pending), np.int64),
    }
    if getattr(engine, "topo", None) is not None:
        arrs["capacity"] = np.int64(engine.topo.capacity)
        arrs["version"] = np.int64(np.asarray(engine.topo.version))
    return arrs


def _topology_from_arrays(arrs) -> tuple[CSRGraph, set[int]]:
    csr = CSRGraph(
        indptr=np.asarray(arrs["indptr"], np.int64),
        indices=np.asarray(arrs["indices"], np.int32),
        data=np.asarray(arrs["data"], np.float64),
    )
    return csr, {int(i) for i in arrs["pending"]}


def _restore_topology_log(engine, manifest: dict) -> None:
    for k, v in manifest.get("topology_log", {}).items():
        engine.topology_log[k] = float(v) if k == "last_drift" else int(v)


# ---------------------------------------------------------------------------
# AsyncEngine closure
# ---------------------------------------------------------------------------


def _async_state_dict(engine, state, step: int):
    arrays, records = {}, []
    for i, (pth, leaf) in enumerate(_flatten_with_paths(state)):
        arr, dt = _to_numpy(leaf)
        key = f"leaf_{i}"
        arrays[key] = arr
        records.append({"key": key, "path": pth, "dtype": dt, "shape": list(arr.shape)})
    files = {"state.npz": arrays}
    manifest = {
        "kind": "engine",
        "engine": "async",
        "step": int(step),
        "fingerprint": engine_fingerprint(engine),
        "generator_device": state.generator.device.type,
        "leaves": records,
        "structure": structure_digest((r["path"], r["dtype"], r["shape"]) for r in records),
    }
    if engine.dynamic:
        files["topology.npz"] = _topology_arrays(engine)
        manifest["topology_log"] = dict(engine.topology_log)
    return files, manifest


def _adopt_async_topology(engine, data: dict, manifest: dict) -> None:
    """Point a dynamic single-device engine at the saved live topology:
    the CSR, its slot form, the pending arrivals (and the churn rejoin
    probabilities they zero), the host log, and the device tiles. The
    captured graphs are dropped: the next ``advance`` adopts the restored
    state and captures again."""
    csr, pending = _topology_from_arrays(data)
    engine._pending = pending
    engine.topo = TopologyState.from_csr(csr, capacity=int(data["capacity"]),
                                         version=int(data["version"]))
    engine._csr = csr
    engine._load_tiles()
    if engine._rejoin is not None:
        rejoin = np.asarray(engine._rejoin_v, np.float32).copy()
        rejoin[sorted(pending)] = 0.0
        engine._rejoin.copy_(torch.from_numpy(rejoin))
    _restore_topology_log(engine, manifest)
    if engine._graphs is not None:
        engine._graphs.reset()


def _restore_async(engine, entry: str, manifest: dict):
    fp = manifest["fingerprint"]
    _check_fingerprint(entry, fp, engine_fingerprint(engine))
    like = engine.init_state(torch.zeros((engine.n, engine.p), dtype=engine.dtype,
                                         device=engine.device))
    like_flat = _flatten_with_paths(like)
    records = manifest["leaves"]
    data = _load_arrays(entry, manifest)
    by_path = {r["path"]: r for r in records}
    gen_rec = by_path.get(".generator")
    if gen_rec is None:
        raise CheckpointError(f"{entry}: no '.generator' leaf (not a port engine entry)")
    generator = _generator(entry, manifest.get("generator_device"), data[gen_rec["key"]],
                           engine.device)
    # The generator's state size is the device type's; the digest compares
    # the rest of the tree against the engine's own template.
    like_flat = [(p, generator if p == ".generator" else leaf) for p, leaf in like_flat]
    _check_digest(entry, manifest, like_flat, what="engine state structure")
    if fp.get("dynamic"):
        _adopt_async_topology(engine, data, manifest)
    leaves = [
        generator if p == ".generator"
        else _from_numpy(data[r["key"]], r["dtype"]).to(engine.device)
        for r, (p, _) in zip(records, like_flat)
    ]
    return _unflatten(like, leaves), int(manifest["step"])


# ---------------------------------------------------------------------------
# ShardedAsyncEngine closure (per-shard layout, no gather)
# ---------------------------------------------------------------------------


def _sharded_state_dict(engine, state, step: int):
    part, S = engine.part, engine.num_shards
    files: dict = {}
    bf16: list[str] = []

    def put(fname, arrs, key, value):
        arr, dt = _to_numpy(value)
        arrs[key] = arr
        if dt == "bfloat16":
            bf16.append(f"{fname}/{key}")

    files["partition.npz"] = {
        "order": np.asarray(part.order, np.int64),
        "bounds": np.asarray(part.bounds, np.int64),
        "sizes": np.asarray(part.sizes, np.int64),
        "tile_width": np.int64(part.tile_width),
        "batch_size": np.int64(engine.batch_size),
    }
    ustate_flat = _flatten_with_paths(state.ustate)
    ustate_records = [
        {"path": pth, "dtype": _leaf_dtype_name(leaf), "shape_tail": list(leaf.shape[2:])}
        for pth, leaf in ustate_flat
    ]
    metrics = state.metrics if engine._macc is not None else None
    counter_keys = (
        [] if metrics is None
        else [k for k, kind in engine._macc.leaf_kinds().items() if kind == "counter"]
    )
    has_last_wake = metrics is not None and "last_wake" in metrics

    # One file per shard, owned rows only, keyed by original agent ids:
    # each block goes to the host as its own (size, ...) tile.
    for s in range(S):
        size = int(part.sizes[s])
        fname = f"shard_{s}.npz"
        arrs: dict = {"ids": np.asarray(part.owned[s, :size], np.int64)}
        put(fname, arrs, "theta", state.Theta[s, :size])
        arrs["active"] = state.active[s, :size].to("cpu").numpy()
        for j, (_pth, leaf) in enumerate(ustate_flat):
            put(fname, arrs, f"ustate_{j}", leaf[s, :size])
        if has_last_wake:
            arrs["last_wake"] = metrics["last_wake"][s, :size].to("cpu").numpy()
        files[fname] = arrs

    sc: dict = {name: getattr(state, name).to("cpu").numpy()
                for name in ("applied", "dropped", "messages", "ptr")}
    sc["generator"] = state.generator.get_state().numpy()
    if state.ef is not None:
        put("scalars.npz", sc, "ef", state.ef)
    for k in counter_keys:
        put("scalars.npz", sc, f"metric_{k}", metrics[k])
    files["scalars.npz"] = sc

    manifest = {
        "kind": "engine",
        "engine": "sharded",
        "step": int(step),
        "fingerprint": engine_fingerprint(engine),
        "generator_device": state.generator.device.type,
        "bf16": bf16,
        "theta_dtype": _leaf_dtype_name(state.Theta),
        "ustate": ustate_records,
        "metrics_keys": counter_keys,
        "has_last_wake": has_last_wake,
        "partition": {"mode": part.mode, "relabel": part.relabel},
    }
    if engine.dynamic:
        files["topology.npz"] = _topology_arrays(engine)
        manifest["topology_log"] = dict(engine.topology_log)
    return files, manifest


def _adopt_partition(engine, manifest: dict, data: dict) -> int:
    """Point the engine at the checkpoint's graph and partition; returns
    the saved shard count.

    Same S: the saved ownership (order, bounds, tile width) is rebuilt
    verbatim with :func:`partition_from_ownership`, the only way to
    reproduce a patch chain's partition exactly. Elastic (S differs):
    static engines keep their own fresh cut of the same graph; dynamic
    engines cut the saved live graph at the engine's S. Never through
    ``set_topology``, whose relayout reads the state.
    """
    fp = manifest["fingerprint"]
    saved_S = int(fp["num_shards"])
    dynamic = bool(fp.get("dynamic"))
    pending_changed = False
    if dynamic:
        csr, pending = _topology_from_arrays(data)
        pending_changed = pending != engine._pending
        engine._pending = pending
        _restore_topology_log(engine, manifest)
    else:
        csr = engine._csr
    meta = manifest.get("partition", {})
    if saved_S == engine.num_shards:
        part = engine.part
        same_cut = (
            np.array_equal(np.asarray(data["order"]), np.asarray(part.order))
            and np.array_equal(np.asarray(data["bounds"]), np.asarray(part.bounds))
            and int(data["tile_width"]) == part.tile_width
        )
        same_graph = csr is engine._csr or csr.digest() == engine._csr.digest()
        engine.batch_size = int(data["batch_size"])
        if same_cut and same_graph and not pending_changed:
            return saved_S  # the engine already sits on the saved cut
        new_part = partition_from_ownership(
            csr, data["order"], data["bounds"],
            mode=meta.get("mode", engine.config.partition_mode),
            relabel=meta.get("relabel"), tile_width=int(data["tile_width"]),
        )
    elif dynamic or pending_changed:
        new_part = partition_graph(csr, engine.num_shards, mode=engine.config.partition_mode,
                                   relabel=engine.config.relabel, coords=engine.config.coords)
    else:
        return saved_S  # elastic static: the engine's own fresh cut serves
    engine._csr = csr
    engine.part = new_part
    engine.smix = engine.smix.rebound(new_part)
    engine.exchange_method = engine.smix.method
    engine.batch_size = int(min(engine.batch_size, new_part.rows_per_shard))
    engine._rebuild_static()
    return saved_S


def _restore_sharded(engine, entry: str, manifest: dict):
    fp = manifest["fingerprint"]
    _check_fingerprint(entry, fp, engine_fingerprint(engine))
    sc = _load_file(entry, "scalars.npz")
    if "generator" not in sc:
        raise CheckpointError(f"{entry}: no generator in scalars.npz (not a port engine entry)")
    generator = _generator(entry, manifest.get("generator_device"), sc["generator"],
                           engine.device)
    pmeta = _load_file(entry, "partition.npz")
    topo = _load_file(entry, "topology.npz") if fp.get("dynamic") else {}
    saved_S = _adopt_partition(engine, manifest, {**pmeta, **topo})
    elastic = saved_S != engine.num_shards
    part, S, dev = engine.part, engine.num_shards, engine.device

    blank = engine._blank_state()
    ustate_flat = _flatten_with_paths(blank.ustate)
    records = manifest.get("ustate", [])
    if len(records) != len(ustate_flat):
        raise CheckpointError(
            f"{entry}: update-state mismatch — checkpoint has {len(records)} "
            f"leaves, engine expects {len(ustate_flat)}"
        )
    for rec, (pth, leaf) in zip(records, ustate_flat):
        want = (pth, _leaf_dtype_name(leaf), tuple(leaf.shape[2:]))
        if (rec["path"], rec["dtype"], tuple(rec["shape_tail"])) != want:
            raise CheckpointError(
                f"{entry}: update-state leaf {pth!r} mismatch: checkpoint "
                f"({rec['path']!r}, {rec['dtype']}, {tuple(rec['shape_tail'])}) != engine {want}"
            )
    if bool(manifest.get("has_last_wake")) and engine._macc is None:
        raise CheckpointError(f"{entry}: checkpoint carries metrics, engine has none")

    def host_zeros(t):
        """A numpy template of ``t``'s shape (bfloat16 as its uint16 view)."""
        dt = np.uint16 if t.dtype == torch.bfloat16 else torch.empty(0, dtype=t.dtype).numpy().dtype
        return np.zeros(tuple(t.shape), dt)

    def on_device(a, like):
        return _from_numpy(a, _leaf_dtype_name(like)).to(dev)

    theta_t = host_zeros(blank.Theta)
    active_t = np.zeros((S, part.rows_per_shard), bool)
    ustate_t = [host_zeros(leaf) for _pth, leaf in ustate_flat]
    lw_t = host_zeros(blank.metrics["last_wake"]) if manifest.get("has_last_wake") else None
    # Re-tile each saved shard's owned rows through the live partition's id
    # maps, whether the cut moved or S changed; one shard file is on the
    # host at a time. The arrays stay in their saved form (bfloat16 as its
    # uint16 view) until they go to the device.
    for s in range(saved_S):
        z = _load_file(entry, f"shard_{s}.npz")
        ids = z["ids"]
        part.place_rows(theta_t, ids, z["theta"])
        part.place_rows(active_t, ids, z["active"])
        for j, t in enumerate(ustate_t):
            part.place_rows(t, ids, z[f"ustate_{j}"])
        if lw_t is not None:
            part.place_rows(lw_t, ids, z["last_wake"])

    def dev_t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    ustate = _unflatten(blank.ustate, [on_device(t, leaf)
                                       for t, (_, leaf) in zip(ustate_t, ustate_flat)])
    state = engine._state(on_device(theta_t, blank.Theta).reshape(-1, engine.p),
                          torch.from_numpy(active_t).to(dev), ustate)
    if not elastic:
        for name, dtype in (("applied", torch.long), ("dropped", torch.long),
                            ("messages", torch.float32), ("ptr", torch.long)):
            getattr(state, name).copy_(dev_t(sc[name], dtype))
        if engine._use_ef and "ef" in sc and state.ef is not None \
                and tuple(np.shape(sc["ef"])) == tuple(state.ef.shape):
            state.ef.copy_(on_device(sc["ef"], state.ef))
    else:
        # Elastic policies (src/repro_torch/DEVIATIONS.md): the one generator
        # is kept, additive counters collapse into shard 0 (run totals kept),
        # and the error-feedback accumulator restarts (its rows describe the
        # old cut's border).
        state.ptr.fill_(int(sc["ptr"][0]))
        state.applied[0] = int(sc["applied"].sum())
        state.dropped[0] = int(sc["dropped"].sum())
        state.messages[0] = float(sc["messages"].astype(np.float64).sum())

    metrics = state.metrics
    if engine._macc is not None:
        if lw_t is not None:
            metrics["last_wake"].copy_(torch.from_numpy(lw_t))
        for k in manifest.get("metrics_keys", []):
            if k not in metrics or f"metric_{k}" not in sc:
                continue
            saved = torch.from_numpy(np.asarray(sc[f"metric_{k}"]))
            tmpl = metrics[k]
            if not elastic:
                if tuple(saved.shape) == tuple(tmpl.shape):
                    tmpl.copy_(saved)
            elif tuple(saved.shape[1:]) == tuple(tmpl.shape[1:]):
                tmpl.zero_()
                tmpl[0] = saved.sum(dim=0).to(tmpl.dtype)
    return state._replace(generator=generator), int(manifest["step"])


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def engine_state_dict(engine, state, step: int | None = None):
    """The engine's complete resume closure as ``(files, manifest)``:
    ``files`` maps file names to ``{key: numpy array}``, ``manifest`` is
    the JSON header (fingerprint included). What
    :func:`save_engine_checkpoint` writes."""
    step = engine._ptr_of(state) if step is None else int(step)
    if _is_sharded(engine):
        return _sharded_state_dict(engine, state, step)
    return _async_state_dict(engine, state, step)


def save_engine_checkpoint(engine, state, path, *, step=None, keep_last=None):
    """Write a crash-safe engine checkpoint (see the module docstring).

    ``step`` defaults to the state's slot counter. With ``keep_last=K``,
    ``path`` is a rotation root (entries ``ckpt-<step>``, newest K kept);
    otherwise it is the entry directory itself. Returns the entry written.
    """
    files, manifest = engine_state_dict(engine, state, step=step)
    return _save_entry(path, files, manifest, manifest["step"], keep_last)


def restore(engine, path):
    """Load an engine checkpoint into ``engine``; returns ``(state, step)``.

    ``path`` may be one entry or a ``keep_last`` rotation root (newest
    valid entry wins, torn entries skipped). The manifest fingerprint
    (graph hash, n, p, dtype, config digest) is checked first: a mismatch
    raises :class:`CheckpointError` naming the field. Dynamic runs adopt
    the saved live topology (graph, capacity, version, pending arrivals,
    host log); sharded restores re-tile the per-shard files through the
    live partition, elastically when S changed. The state's tensors are
    new ones on the engine's device: on the card, ``advance`` copies them
    into its live buffers (or, after a dynamic restore, adopts them).
    """
    entry, manifest = _resolve_entry(path)
    if manifest.get("kind") != "engine":
        raise CheckpointError(
            f"{entry}: not an engine checkpoint (kind={manifest.get('kind')!r}); "
            "pytree checkpoints load via repro_torch.checkpoint.load_checkpoint"
        )
    want = "sharded" if _is_sharded(engine) else "async"
    saved_engine = manifest.get("engine")
    if saved_engine != want:
        raise CheckpointError(
            f"{entry}: {saved_engine} checkpoint cannot restore into a {type(engine).__name__}"
        )
    if want == "async":
        return _restore_async(engine, entry, manifest)
    return _restore_sharded(engine, entry, manifest)

"""Crash-safe, shard-friendly checkpointing of trees of tensors.

Port of ``repro.checkpoint.checkpoint``; the on-disk format is the
reference's, entry for entry, so each package reads the other's entries.
A checkpoint is a directory: numbered ``shard_*.npz`` array files plus a
``manifest.json`` carrying the step, user extras, a structure digest
(leaf paths + dtypes + shapes) verified against the ``like`` tree on
load, and a sha256 per file. Writes stage into ``<dir>.tmp`` (every file
fsynced, the manifest written last) and atomically rename into place: a
writer killed mid-save can never leave a directory that loads. With
``keep_last=K`` the target path is a *rotation root* holding
``ckpt-<step>`` entries; loading a root falls back to the newest entry
that verifies, so a torn newest write recovers the previous one.

The trees are NamedTuples, dicts, tuples, lists and ``None`` around
tensors, numpy arrays and ``torch.Generator`` leaves. A leaf's path is
the reference's string (JAX's key path joined by ``/``: ``.field`` for a
NamedTuple field, the key for a dict entry, the index for a sequence
entry; dict keys in sorted order), so ``.Theta`` names the same leaf in
both packages' entries. Tensors go to the host with ``.cpu()``; a
bfloat16 leaf ships as a uint16 view (npz has no bfloat16); a generator
ships as its ``get_state()`` bytes (uint8). :mod:`repro_torch.checkpoint.engine_io`
builds the engine layer on the same entry primitives.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

_BF16 = "bfloat16"
_MANIFEST = "manifest.json"
_FORMAT = 2


class CheckpointError(ValueError):
    """A checkpoint directory is torn, corrupted, or structurally wrong."""


# ---------------------------------------------------------------------------
# Trees and leaf <-> numpy codecs
# ---------------------------------------------------------------------------

_LEAVES = (torch.Tensor, np.ndarray, np.generic, torch.Generator, bool, int, float)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_with_paths(tree):
    """``(path_str, leaf)`` pairs in the reference's canonical order.

    NamedTuple fields in declaration order (``.field``), dict entries in
    sorted key order (``key``), sequence entries by index (``i``), path
    components joined by ``/``; ``None`` and empty containers hold no
    leaves, as in JAX.
    """
    out: list = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, _LEAVES):
            out.append(("/".join(path), node))
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), path + [f".{f}"])
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (tuple, list)):
            for i, x in enumerate(node):
                walk(x, path + [str(i)])
        else:
            raise TypeError(f"checkpoint trees hold tensors, arrays and generators; "
                            f"got {type(node).__name__} at {'/'.join(path)!r}")

    walk(tree, [])
    return out


def _unflatten(like, leaves):
    """``like`` with its leaves replaced, in :func:`_flatten_with_paths` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, _LEAVES):
            return next(it)
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        return type(node)(build(x) for x in node)

    return build(like)


def _to_numpy(x):
    """Host array + recorded dtype name (bf16 ships as a uint16 view, a
    generator as its state bytes)."""
    if isinstance(x, torch.Generator):
        return x.get_state().numpy(), "uint8"
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = x.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(x)
    if arr.dtype.name == _BF16:
        return arr.view(np.uint16), _BF16
    return arr, str(arr.dtype)


def _from_numpy(arr, dtype: str) -> torch.Tensor:
    """Invert :func:`_to_numpy` as a CPU tensor (restores the bf16 view)."""
    arr = np.require(arr, requirements="C")  # keeps 0-d arrays 0-d
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _leaf_dtype_name(leaf) -> str:
    """Recorded dtype name of a template leaf (numpy's spelling)."""
    if isinstance(leaf, torch.Generator):
        return "uint8"
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _leaf_shape(leaf) -> tuple:
    if isinstance(leaf, torch.Generator):
        return tuple(leaf.get_state().shape)
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def structure_digest(records) -> str:
    """sha256 over ``(path, dtype, shape)`` triples: the tree's identity."""
    h = hashlib.sha256()
    for path, dtype, shape in records:
        h.update(f"{path}|{dtype}|{tuple(shape)}\n".encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Crash-safe entry I/O (shared with engine_io; the reference's)
# ---------------------------------------------------------------------------


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_entry(entry: str, files: dict, manifest: dict) -> str:
    """Crash-safely materialize ``entry/`` from ``{filename: {key: array}}``.

    Everything stages under ``<entry>.tmp`` (each npz fsynced, its sha256
    recorded, the manifest written and fsynced last), then one atomic
    rename publishes the directory. A crash at any earlier point leaves
    only a ``.tmp`` directory, which no loader ever counts.
    """
    tmp = entry + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return _publish(entry, manifest, _write_files(tmp, files))


def _write_files(tmp: str, files: dict) -> dict:
    """Write ``{filename: {key: array}}`` into ``tmp``, each npz fsynced;
    returns their sha256 by name."""
    hashes = {}
    for name, arrays in files.items():
        fp = os.path.join(tmp, name)
        np.savez(fp, **arrays)
        with open(fp, "rb+") as f:
            os.fsync(f.fileno())
        hashes[name] = _sha256_file(fp)
    return hashes


def _publish(entry: str, manifest: dict, hashes: dict) -> str:
    """The manifest written and fsynced into ``<entry>.tmp`` (holding the
    files of ``hashes``), then the directory renamed into place."""
    tmp = entry + ".tmp"
    manifest = dict(manifest, format=_FORMAT, file_sha256=hashes)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    if os.path.exists(entry):
        old = entry + ".old"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(entry, old)
        os.rename(tmp, entry)
        shutil.rmtree(old)
    else:
        os.rename(tmp, entry)
    _fsync_dir(os.path.dirname(os.path.abspath(entry)))
    return entry


def _write_entry_ranked(entry: str, own: dict, files: dict, manifest: dict, group) -> str:
    """:func:`_write_entry` across the ranks of ``group``: rank 0 stages
    ``<entry>.tmp``; after a barrier every rank writes its ``own`` files
    there (fsync, sha256); rank 0 writes ``files``, gathers every rank's
    hashes, writes the manifest and renames; a last barrier returns only
    once the entry is published."""
    import torch.distributed as dist

    rank, tmp = dist.get_rank(group), entry + ".tmp"
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    dist.barrier(group)
    hashes = _write_files(tmp, own)
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, hashes, group=group)
    if rank == 0:
        for h in every:
            hashes.update(h)
        hashes.update(_write_files(tmp, files))
        _publish(entry, manifest, dict(sorted(hashes.items())))
    dist.barrier(group)
    return entry


def _save_entry(path: str, files: dict, manifest: dict, step: int, keep_last, *,
                own=None, group=None):
    """Write one entry at ``path`` (or into its ``keep_last`` rotation).
    With ``group``, every rank of it calls this with its ``own`` files
    (:func:`_write_entry_ranked`; rank 0 writes ``files`` and prunes)."""
    if keep_last is not None:
        keep = int(keep_last)
        if keep < 1:
            raise ValueError("keep_last must be >= 1")
        os.makedirs(path, exist_ok=True)
        entry = os.path.join(path, f"ckpt-{int(step):012d}")
    else:
        entry = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if group is None:
        _write_entry(entry, files, manifest)
    else:
        _write_entry_ranked(entry, own or {}, files, manifest, group)
    if group is None:
        if keep_last is not None:
            _prune_rotation(path, keep)
        return entry
    import torch.distributed as dist

    if keep_last is not None and dist.get_rank(group) == 0:
        _prune_rotation(path, keep)
    dist.barrier(group)
    return entry


def _read_manifest(entry: str) -> dict:
    mp = os.path.join(entry, _MANIFEST)
    if not os.path.isfile(mp):
        raise CheckpointError(f"{entry}: no {_MANIFEST} (torn write or foreign directory)")
    try:
        with open(mp) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"{entry}: unreadable manifest: {e}") from e


def _verify_entry(entry: str) -> dict:
    """Manifest + per-file sha256 check; CheckpointError on a torn entry."""
    manifest = _read_manifest(entry)
    for name, want in manifest.get("file_sha256", {}).items():
        fp = os.path.join(entry, name)
        if not os.path.isfile(fp):
            raise CheckpointError(f"{entry}: missing file {name} (torn write)")
        got = _sha256_file(fp)
        if got != want:
            raise CheckpointError(
                f"{entry}: {name} sha256 mismatch (torn or corrupted write): "
                f"{got[:12]} != {want[:12]}"
            )
    return manifest


def _rotation_entries(root: str) -> list[str]:
    """``ckpt-*`` entries under ``root``, newest step first; ``*.tmp`` /
    ``*.old`` staging leftovers are never candidates."""
    names = [
        name
        for name in os.listdir(root)
        if name.startswith("ckpt-")
        and not name.endswith((".tmp", ".old"))
        and os.path.isdir(os.path.join(root, name))
    ]

    def step_of(name: str) -> int:
        digits = name.split("-", 1)[1]
        return int(digits) if digits.isdigit() else -1

    return [os.path.join(root, n) for n in sorted(names, key=step_of, reverse=True)]


def _prune_rotation(root: str, keep_last: int) -> None:
    for entry in _rotation_entries(root)[keep_last:]:
        shutil.rmtree(entry)


def _resolve_entry(path: str):
    """Map ``path`` (one entry, or a rotation root) to a verified entry.

    Returns ``(entry, manifest)``. A rotation root falls back across its
    entries newest-first; FileNotFoundError when nothing was ever
    written, CheckpointError when entries exist but none verifies.
    """
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if os.path.isfile(os.path.join(path, _MANIFEST)):
        return path, _verify_entry(path)
    entries = _rotation_entries(path)
    if not entries:
        raise FileNotFoundError(f"no checkpoint entries under {path}")
    errors = []
    for entry in entries:
        try:
            return entry, _verify_entry(entry)
        except CheckpointError as e:
            errors.append(str(e))
    raise CheckpointError(
        f"{path}: no valid checkpoint among {len(entries)} entries:\n" + "\n".join(errors)
    )


def _load_file(entry: str, name: str) -> dict:
    """One verified npz file of an entry as ``{key: array}``."""
    with np.load(os.path.join(entry, name)) as z:
        return {k: z[k] for k in z.files}


def _load_arrays(entry: str, manifest: dict) -> dict:
    """All arrays of a verified entry, keyed as saved."""
    data: dict = {}
    for name in manifest.get("file_sha256", {}):
        if name.endswith(".npz"):
            data.update(_load_file(entry, name))
    return data


def _records(flat) -> list:
    """``(path, dtype, shape)`` of each ``(path, leaf)`` template pair."""
    return [(p, _leaf_dtype_name(leaf), list(_leaf_shape(leaf))) for p, leaf in flat]


def _check_structure(entry: str, records, like_flat) -> None:
    """Compare the manifest leaf records against the ``like`` tree; raises
    a CheckpointError naming the first mismatch (leaf set, dtype, shape)."""
    saved_paths = [r["path"] for r in records]
    like_paths = [p for p, _ in like_flat]
    if saved_paths != like_paths:
        missing = [p for p in saved_paths if p not in like_paths]
        added = [p for p in like_paths if p not in saved_paths]
        raise CheckpointError(
            f"{entry}: tree structure mismatch — checkpoint has "
            f"{len(saved_paths)} leaves, `like` has {len(like_paths)}"
            + (f"; only in checkpoint: {missing[:4]}" if missing else "")
            + (f"; only in `like`: {added[:4]}" if added else "")
        )
    for rec, (pth, ref) in zip(records, like_flat):
        want_dtype = _leaf_dtype_name(ref)
        if rec["dtype"] != want_dtype:
            raise CheckpointError(
                f"{entry}: leaf {pth!r}: checkpoint dtype {rec['dtype']} != {want_dtype}"
            )
        want_shape = _leaf_shape(ref)
        if tuple(rec["shape"]) != want_shape:
            raise CheckpointError(
                f"{entry}: leaf {pth!r}: checkpoint shape {tuple(rec['shape'])} != {want_shape}"
            )


def _check_digest(entry: str, manifest: dict, like_flat, what: str = "structure") -> None:
    """The saved structure digest against ``like``'s; on a mismatch the
    readable per-leaf check names it."""
    if manifest.get("structure") != structure_digest(_records(like_flat)):
        _check_structure(entry, manifest["leaves"], like_flat)
        raise CheckpointError(f"{entry}: {what} digest mismatch")


def _like_leaf(arr, rec, ref):
    """A loaded array as ``ref``'s kind: a tensor on ``ref``'s device, a
    numpy array, or a generator continuing the saved stream."""
    if isinstance(ref, torch.Generator):
        gen = torch.Generator(device=ref.device)
        gen.set_state(torch.from_numpy(np.ascontiguousarray(arr)))
        return gen
    t = _from_numpy(arr, rec["dtype"])
    if isinstance(ref, torch.Tensor):
        return t.to(ref.device)
    if rec["dtype"] == _BF16:
        return np.asarray(arr).view(np.asarray(ref).dtype)
    return np.asarray(arr)


# ---------------------------------------------------------------------------
# Tree checkpoint API
# ---------------------------------------------------------------------------


def save_checkpoint(path, tree, step=0, extra=None, max_shard_bytes=1 << 30, keep_last=None):
    """Write ``tree`` (tensors, arrays and generators in NamedTuples, dicts,
    tuples and lists) as one crash-safe checkpoint.

    Leaves are grouped into ``shard_*.npz`` files of at most
    ``max_shard_bytes`` each (a single larger leaf gets its own file);
    the manifest records ``step``, the JSON-serializable ``extra``, every
    leaf's path/dtype/shape plus a structure digest, and per-file sha256.
    With ``keep_last=K``, ``path`` is a rotation root and the entry lands
    at ``path/ckpt-<step>`` with only the newest K entries retained.
    Returns the entry directory written.
    """
    flat = _flatten_with_paths(tree)
    leaves = []
    files: dict[str, dict[str, np.ndarray]] = {}
    shard: dict[str, np.ndarray] = {}
    shard_bytes = 0

    def flush():
        nonlocal shard, shard_bytes
        if shard:
            files[f"shard_{len(files)}.npz"] = shard
            shard, shard_bytes = {}, 0

    for i, (pth, leaf) in enumerate(flat):
        arr, dt = _to_numpy(leaf)
        key = f"leaf_{i}"
        shard[key] = arr
        shard_bytes += arr.nbytes
        leaves.append({"key": key, "path": pth, "dtype": dt, "shape": list(arr.shape)})
        if shard_bytes >= max_shard_bytes:
            flush()
    flush()
    manifest = {
        "kind": "pytree",
        "step": int(step),
        "extra": extra or {},
        "leaves": leaves,
        "structure": structure_digest((r["path"], r["dtype"], r["shape"]) for r in leaves),
    }
    return _save_entry(path, files, manifest, step, keep_last)


def load_checkpoint(path, like):
    """Load a checkpoint written by :func:`save_checkpoint`.

    ``path`` may be one entry or a ``keep_last`` rotation root (newest
    valid entry wins; torn entries are skipped). ``like`` is a tree with
    the expected structure/dtypes/shapes: any mismatch raises
    :class:`CheckpointError` (a ``ValueError``) naming the offending
    leaf. Tensor leaves load onto ``like``'s devices. Returns
    ``(tree, step, extra)``.
    """
    entry, manifest = _resolve_entry(path)
    if manifest.get("kind") != "pytree":
        raise CheckpointError(
            f"{entry}: not a pytree checkpoint (kind={manifest.get('kind')!r}); "
            "engine checkpoints load via repro_torch.checkpoint.restore(engine, path)"
        )
    like_flat = _flatten_with_paths(like)
    _check_digest(entry, manifest, like_flat)
    data = _load_arrays(entry, manifest)
    out = [_like_leaf(data[r["key"]], r, ref)
           for r, (_, ref) in zip(manifest["leaves"], like_flat)]
    return _unflatten(like, out), manifest["step"], manifest.get("extra", {})

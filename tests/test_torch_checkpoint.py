"""repro_torch.checkpoint's entry primitives against the reference's.

Counterparts of ``tests/test_checkpoint_crash.py`` (torn writes never
load; a rotation root falls back to the newest entry that verifies),
``tests/test_checkpoint_properties.py`` (hypothesis round trips over the
dtype zoo) and the checkpoint cases of ``tests/test_checkpoint_and_data.py``,
on trees of tensors; then the two packages' entries held against each
other: for the same numpy tree the manifests are equal except
``file_sha256`` (npz zip headers carry times) and the arrays are equal,
and each package loads the other's entries. Everything is exact: a
checkpoint moves bits.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointError, load_checkpoint, save_checkpoint
from repro_torch.checkpoint.checkpoint import _flatten_with_paths


def _tree(v=0.0, n=16):
    return {
        "w": torch.full((n, 4), v, dtype=torch.float32),
        "b": torch.full((n,), v, dtype=torch.bfloat16),
        "step_count": torch.tensor(int(v), dtype=torch.int32),
    }


def _assert_same(a, b):
    la, lb = _flatten_with_paths(a), _flatten_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# -- rotation ----------------------------------------------------------------


def test_rotation_keeps_last_k_and_loads_newest(tmp_path):
    root = str(tmp_path / "rot")
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(root, _tree(step), step=step, keep_last=2)
    assert sorted(os.listdir(root)) == ["ckpt-000000000004", "ckpt-000000000005"]
    restored, step, _ = load_checkpoint(root, _tree())
    assert step == 5
    assert torch.equal(restored["w"], torch.full((16, 4), 5.0))


def test_missing_or_empty_root_raises_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nope"), _tree())
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(empty), _tree())


def test_root_with_only_tmp_staging_raises_filenotfound(tmp_path):
    """A writer killed before its first rename leaves only ``.tmp``: that
    reads as 'nothing was ever written', not as a candidate."""
    root = tmp_path / "rot"
    (root / "ckpt-000000000001.tmp").mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(root), _tree())


# -- mid-write crash ---------------------------------------------------------


def test_midwrite_crash_recovers_previous_entry(tmp_path, monkeypatch):
    """Kill the writer after its first array file: the save raises, no new
    entry appears, and the rotation still serves the previous step."""
    root = str(tmp_path / "rot")
    big = {"a": torch.ones((256, 64)), "b": torch.zeros((256, 64))}  # 2 files
    save_checkpoint(root, big, step=1, keep_last=3, max_shard_bytes=1 << 14)
    assert len(os.listdir(os.path.join(root, "ckpt-000000000001"))) == 3

    real_savez = np.savez
    calls = {"n": 0}

    def dying_savez(*args, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("simulated crash: disk gone mid-write")
        return real_savez(*args, **kw)

    monkeypatch.setattr(np, "savez", dying_savez)
    with pytest.raises(OSError, match="simulated crash"):
        save_checkpoint(root, big, step=2, keep_last=3, max_shard_bytes=1 << 14)
    monkeypatch.undo()

    assert calls["n"] == 2  # it really was mid-entry
    names = os.listdir(root)
    assert "ckpt-000000000002" not in names
    assert "ckpt-000000000002.tmp" in names
    restored, step, _ = load_checkpoint(root, big)
    assert step == 1
    assert torch.equal(restored["a"], torch.ones((256, 64)))
    # A later successful save reclaims the stale staging directory.
    save_checkpoint(root, big, step=2, keep_last=3, max_shard_bytes=1 << 14)
    _, step, _ = load_checkpoint(root, big)
    assert step == 2


def test_truncated_file_rejected_and_rotation_falls_back(tmp_path):
    root = str(tmp_path / "rot")
    save_checkpoint(root, _tree(1), step=1, keep_last=3)
    save_checkpoint(root, _tree(2), step=2, keep_last=3)
    newest = os.path.join(root, "ckpt-000000000002")
    shard = os.path.join(newest, "shard_0.npz")
    with open(shard, "rb") as f:
        blob = f.read()
    with open(shard, "wb") as f:
        f.write(blob[: len(blob) // 2])  # torn at half length
    with pytest.raises(CheckpointError, match="sha256 mismatch"):
        load_checkpoint(newest, _tree())
    restored, step, _ = load_checkpoint(root, _tree())
    assert step == 1
    assert torch.equal(restored["w"], torch.ones((16, 4)))


def test_missing_shard_file_is_a_torn_write(tmp_path):
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, _tree(3), step=3)
    os.remove(os.path.join(ck, "shard_0.npz"))
    with pytest.raises(CheckpointError, match="missing file"):
        load_checkpoint(ck, _tree())


def test_all_entries_torn_raises_checkpoint_error(tmp_path):
    root = str(tmp_path / "rot")
    save_checkpoint(root, _tree(1), step=1, keep_last=3)
    os.remove(os.path.join(root, "ckpt-000000000001", "shard_0.npz"))
    with pytest.raises(CheckpointError, match="no valid checkpoint"):
        load_checkpoint(root, _tree())


def test_manifest_without_checkpoint_kind_is_rejected(tmp_path):
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, _tree(1), step=1)
    mp = os.path.join(ck, "manifest.json")
    with open(mp) as f:
        manifest = json.load(f)
    manifest["kind"] = "mystery"
    with open(mp, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(CheckpointError, match="not a pytree checkpoint"):
        load_checkpoint(ck, _tree())


# -- structure verification --------------------------------------------------


def test_structure_digest_catches_extra_and_missing_leaves(tmp_path):
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, _tree(), step=0)
    with pytest.raises(CheckpointError, match="structure mismatch"):
        load_checkpoint(ck, dict(_tree(), junk=torch.zeros(3)))
    with pytest.raises(CheckpointError, match="structure mismatch"):
        load_checkpoint(ck, {"w": _tree()["w"]})


def test_structure_digest_catches_dtype_change(tmp_path):
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, _tree(), step=0)
    with pytest.raises(CheckpointError, match="dtype"):
        load_checkpoint(ck, dict(_tree(), b=torch.zeros(16)))  # bf16 -> f32


def test_manifest_records_structure_digest_and_file_hashes(tmp_path):
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, _tree(), step=0)
    with open(os.path.join(ck, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["kind"] == "pytree" and manifest["format"] == 2
    assert len(manifest["structure"]) == 64  # sha256 hex
    npz = [n for n in os.listdir(ck) if n.endswith(".npz")]
    assert sorted(manifest["file_sha256"]) == sorted(npz)


def test_single_leaf_larger_than_max_shard_bytes_gets_own_file(tmp_path):
    """One oversized leaf may exceed ``max_shard_bytes`` but must not drag
    later leaves into its file, and the whole tree still round-trips."""
    tree = {"big": torch.arange(1 << 18, dtype=torch.float32),
            "small": torch.full((4,), 7.0)}
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, tree, max_shard_bytes=1 << 10)
    shards = sorted(n for n in os.listdir(ck) if n.startswith("shard_"))
    assert len(shards) == 2
    sizes = [os.path.getsize(os.path.join(ck, s)) for s in shards]
    assert max(sizes) > (1 << 20) and min(sizes) < (1 << 12)
    restored, _, _ = load_checkpoint(ck, tree)
    _assert_same(restored, tree)


# -- the checkpoint cases of tests/test_checkpoint_and_data.py ------------------


def test_checkpoint_roundtrip_mixed_dtypes(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"w": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                  "s": torch.tensor(7, dtype=torch.int32)}}
    save_checkpoint(str(tmp_path / "ck"), tree, step=42, extra={"note": "x"})
    like = {"a": torch.zeros(3, 4), "b": {"w": torch.zeros(5, dtype=torch.bfloat16),
                                          "s": torch.tensor(0, dtype=torch.int32)}}
    restored, step, extra = load_checkpoint(str(tmp_path / "ck"), like)
    assert step == 42 and extra["note"] == "x"
    _assert_same(restored, tree)


def test_checkpoint_sharding_into_multiple_files(tmp_path):
    tree = {"big": torch.zeros((1024, 1024))}  # 4 MB
    save_checkpoint(str(tmp_path / "ck"), tree, max_shard_bytes=1 << 20)
    assert [f for f in os.listdir(tmp_path / "ck") if f.startswith("shard_")]
    restored, _, _ = load_checkpoint(str(tmp_path / "ck"), tree)
    assert torch.equal(restored["big"], tree["big"])


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "ck"), {"w": torch.zeros((5, 4))})


# -- trees of the port's kinds ------------------------------------------------


def test_paths_are_the_reference_key_paths():
    """NamedTuple fields as ``.field``, dict keys sorted, sequence indices,
    joined by ``/``; None and empty tuples hold no leaves, as in JAX."""
    from repro_torch.sim import SimState

    st = SimState(Theta=torch.zeros(2), hist=torch.zeros(1), ptr=torch.tensor(0),
                  active=torch.zeros(2, dtype=torch.bool), generator=torch.Generator(),
                  ustate=(), applied=torch.tensor(0), dropped=torch.tensor(0),
                  messages=torch.tensor(0.0), metrics={"b": torch.zeros(1), "a": torch.zeros(2)})
    assert [p for p, _ in _flatten_with_paths(st)] == [
        ".Theta", ".hist", ".ptr", ".active", ".generator", ".applied", ".dropped",
        ".messages", ".metrics/a", ".metrics/b"]
    tree = {"x": [np.zeros(1), {"c": np.zeros(2)}], "a": (np.zeros(1),), "n": None}
    assert [p for p, _ in _flatten_with_paths(tree)] == ["a/0", "x/0", "x/1/c"]


def test_generator_leaf_continues_its_stream(tmp_path):
    """A generator is saved as its state bytes (uint8) and loads as a new
    generator drawing what the saved one draws next."""
    gen = torch.Generator()
    gen.manual_seed(11)
    torch.rand(5, generator=gen)
    save_checkpoint(str(tmp_path / "ck"), {"g": gen, "x": torch.ones(2)}, step=3)
    like = {"g": torch.Generator(), "x": torch.zeros(2)}
    restored, step, _ = load_checkpoint(str(tmp_path / "ck"), like)
    assert step == 3 and restored["g"] is not like["g"]
    assert torch.equal(torch.rand(7, generator=restored["g"]), torch.rand(7, generator=gen))


# -- hypothesis round trips (tests/test_checkpoint_properties.py) ----------------

hypothesis = pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

_DTYPES = [torch.float32, torch.bfloat16, torch.int32, torch.uint16, torch.bool]
_SHAPES = [(), (0,), (1,), (3, 2), (2, 0, 4), (5,)]


def _leaf(draw_i, shape, dtype):
    rng = np.random.default_rng(draw_i)
    if dtype == torch.bool:
        return torch.from_numpy(np.asarray(rng.random(shape) < 0.5))
    if dtype in (torch.int32, torch.uint16):
        return torch.from_numpy(np.asarray(rng.integers(0, 1000, size=shape))).to(dtype)
    return torch.from_numpy(np.asarray(rng.normal(size=shape))).to(dtype)


_leaves = st.builds(_leaf, st.integers(min_value=0, max_value=2**31 - 1),
                    st.sampled_from(_SHAPES), st.sampled_from(_DTYPES))
_trees = st.recursive(
    _leaves,
    lambda children: st.one_of(
        st.dictionaries(st.sampled_from(list("abcdef")), children, min_size=1, max_size=3),
        st.lists(children, min_size=1, max_size=3),
    ),
    max_leaves=6,
)


def _zeros_like(tree):
    flat = _flatten_with_paths(tree)
    from repro_torch.checkpoint.checkpoint import _unflatten

    return _unflatten(tree, [torch.zeros_like(x) for _, x in flat])


@given(tree=_trees, step=st.integers(min_value=0, max_value=10**9))
@settings(max_examples=25, deadline=None)
def test_roundtrip_preserves_values_dtypes_and_step(tree, step):
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ck")
        save_checkpoint(ck, tree, step=step, extra={"tag": "prop"})
        restored, got_step, extra = load_checkpoint(ck, _zeros_like(tree))
        assert got_step == step and extra["tag"] == "prop"
        _assert_same(tree, restored)


@given(tree=_trees, max_shard_bytes=st.sampled_from([1, 128, 1 << 10, 1 << 30]))
@settings(max_examples=25, deadline=None)
def test_roundtrip_invariant_to_shard_grouping(tree, max_shard_bytes):
    """The grouping of leaves into npz files never changes what loads back."""
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ck")
        save_checkpoint(ck, tree, max_shard_bytes=max_shard_bytes)
        restored, _, _ = load_checkpoint(ck, _zeros_like(tree))
        _assert_same(tree, restored)


@given(dtype=st.sampled_from(_DTYPES), shape=st.sampled_from(_SHAPES))
@settings(max_examples=30, deadline=None)
def test_every_dtype_shape_cell_roundtrips(dtype, shape):
    """The full dtype x shape matrix, one leaf at a time, the bf16 codec on
    empty and 0-d arrays included."""
    leaf = _leaf(7, shape, dtype)
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ck")
        save_checkpoint(ck, {"x": leaf})
        restored, _, _ = load_checkpoint(ck, {"x": torch.zeros_like(leaf)})
        assert restored["x"].dtype == leaf.dtype and tuple(restored["x"].shape) == shape
        assert torch.equal(restored["x"], leaf)


# -- the two packages' entries -------------------------------------------------


def _numpy_tree():
    import ml_dtypes

    rng = np.random.default_rng(3)
    return {"w": rng.normal(size=(6, 4)).astype(np.float32),
            "b": {"h": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
                  "s": np.asarray(7, np.int32)},
            "l": [np.arange(3, dtype=np.int32), np.asarray([True, False])]}


def test_same_numpy_tree_gives_the_reference_manifest_and_arrays(tmp_path):
    from repro.checkpoint import save_checkpoint as ref_save

    tree = _numpy_tree()
    for keep in (None, 2):
        mine = save_checkpoint(str(tmp_path / f"port{keep}"), tree, step=9,
                               extra={"k": 1}, max_shard_bytes=64, keep_last=keep)
        theirs = ref_save(str(tmp_path / f"ref{keep}"), tree, step=9, extra={"k": 1},
                          max_shard_bytes=64, keep_last=keep)
        assert os.path.relpath(mine, tmp_path / f"port{keep}") == \
            os.path.relpath(theirs, tmp_path / f"ref{keep}")
        man = [json.load(open(os.path.join(e, "manifest.json"))) for e in (mine, theirs)]
        assert sorted(man[0]["file_sha256"]) == sorted(man[1]["file_sha256"])
        for m in man:
            m.pop("file_sha256")
        assert man[0] == man[1]
        for name in sorted(f for f in os.listdir(mine) if f.endswith(".npz")):
            with np.load(os.path.join(mine, name)) as a, np.load(os.path.join(theirs, name)) as b:
                assert a.files == b.files
                for k in a.files:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_each_package_loads_the_others_entries(tmp_path):
    import jax.numpy as jnp
    from repro.checkpoint import load_checkpoint as ref_load
    from repro.checkpoint import save_checkpoint as ref_save
    from repro.checkpoint.checkpoint import _verify_entry as ref_verify

    tree = _numpy_tree()
    like_t = {"w": torch.zeros(6, 4), "b": {"h": torch.zeros(5, dtype=torch.bfloat16),
                                           "s": torch.tensor(0, dtype=torch.int32)},
              "l": [torch.zeros(3, dtype=torch.int32), torch.zeros(2, dtype=torch.bool)]}
    ref_save(str(tmp_path / "ref"), tree, step=4)
    got, step, _ = load_checkpoint(str(tmp_path / "ref"), like_t)
    assert step == 4
    assert np.array_equal(got["w"].numpy(), tree["w"])
    assert np.array_equal(got["b"]["h"].view(torch.int16).numpy().view(np.uint16),
                          tree["b"]["h"].view(np.uint16))
    assert np.array_equal(got["l"][0].numpy(), tree["l"][0])

    mine = save_checkpoint(str(tmp_path / "port"), like_t | {"w": torch.from_numpy(tree["w"])},
                           step=5)
    ref_verify(mine)
    like_j = {"w": jnp.zeros((6, 4), jnp.float32), "b": {"h": jnp.zeros(5, jnp.bfloat16),
                                            "s": jnp.int32(0)},
              "l": [jnp.zeros(3, jnp.int32), jnp.zeros(2, bool)]}
    back, step, _ = ref_load(mine, like_j)
    assert step == 5 and np.array_equal(np.asarray(back["w"]), tree["w"])

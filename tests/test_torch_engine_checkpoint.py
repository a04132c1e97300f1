"""Engine checkpoint and restore on the port: crash-safe resume closures,
held to the uninterrupted run bit for bit and to the reference.

Counterparts of ``tests/test_engine_checkpoint.py``. Each resume test runs
``total`` slots straight through, and ``cut`` slots -> save -> restore
into a fresh engine -> ``total - cut`` more, and compares every state
leaf (the generator's state included) exactly: static CD, DP with the
accountant's counts, the delay ring, the sharded engine, dynamic topology
at each cut point. The reference's multi-device scripts (S = 4 resume,
S = 4 -> 8 elastic restore) run here with the S shards stacked on one
device; the elastic restore is held to the uninterrupted S = 8 run under
forced wakes (1e-10, float64), to the fixed point (1e-5) on a sampled
run, and keeps the run totals. Under forced wakes the port's resumed
Theta is also held to the reference's resumed Theta (1e-10, float64:
sums taken in another order). Random streams differ between the
packages, so parity with the reference goes through forced wake sets.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim as jsim
from repro.checkpoint import restore as ref_restore
from repro.checkpoint import save_engine_checkpoint as ref_save
from repro.core import AgentData, knn_graph, make_objective
from repro_torch.checkpoint import (
    CheckpointError,
    restore,
    save_checkpoint,
    save_engine_checkpoint,
)
from repro_torch.checkpoint.checkpoint import _flatten_with_paths, _to_numpy
from repro_torch.convert import objective_from_reference
from repro_torch.core import DPConfig
from repro_torch.sim import (
    AsyncEngine,
    CDUpdate,
    DelayConfig,
    DPCDUpdate,
    ExchangeSpec,
    GraphUpdate,
    Scenario,
    ShardedAsyncEngine,
)
from repro_torch.sim.partition import GraphPartition

TOL64 = 1e-10
F64 = dict(dtype=torch.float64, device="cpu")


def _quad(n, p=4, m=3, seed=0, mu=0.5, clip=None):
    """(reference objective, port objective): the reference tests' problem."""
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic", mu=mu,
                         mix_mode="sparse", clip=clip)
    return ref, objective_from_reference(ref)


def _leaves(state) -> dict:
    """Every leaf of a state as numpy, the generator as its state bytes."""
    return {p: _to_numpy(leaf)[0] for p, leaf in _flatten_with_paths(state)}


def _assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert np.array_equal(la[k], lb[k]), k


def _resume_run(make_engine, Theta0, total, cut, tmp_path, **run_kw):
    """``total`` slots straight through against ``cut`` + save/restore +
    ``total - cut`` into a fresh engine."""
    ref_eng = make_engine()
    ref = ref_eng.run(Theta0, slots=total, **run_kw)
    half_eng = make_engine()
    half = half_eng.run(Theta0, slots=cut, **run_kw)
    ck = str(tmp_path / f"ck{cut}")
    save_engine_checkpoint(half_eng, half.state, ck)
    res_eng = make_engine()
    state, step = restore(res_eng, ck)
    assert step == cut
    fin = res_eng.run(None, slots=total - cut, state=state, **run_kw)
    return ref_eng, ref, res_eng, fin


# -- AsyncEngine -------------------------------------------------------------


def test_async_static_cd_resume_bit_exact(tmp_path):
    _, obj = _quad(40, seed=1)

    def mk():
        return AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, metrics=True, **F64)

    _, ref, _, fin = _resume_run(mk, np.zeros((40, 4)), 24, 12, tmp_path)
    np.testing.assert_array_equal(fin.Theta, ref.Theta)
    assert (fin.messages, fin.wakes_applied, fin.wakes_dropped) == \
        (ref.messages, ref.wakes_applied, ref.wakes_dropped)
    _assert_states_equal(fin.state, ref.state)


def test_async_static_dp_resume_bit_exact_including_accountant(tmp_path):
    _, obj = _quad(40, seed=1, clip=1.0)
    dp = DPCDUpdate.plan(obj, DPConfig(eps_bar=1.0), planned_Ti=6)

    def mk():
        return AsyncEngine(dp, slot_wakes=8.0, seed=0, metrics=True, **F64)

    _, ref, _, fin = _resume_run(mk, np.zeros((40, 4)), 24, 12, tmp_path)
    np.testing.assert_array_equal(fin.Theta, ref.Theta)
    _assert_states_equal(fin.state, ref.state)
    assert fin.state.ustate.dtype == torch.int32 and int(fin.state.ustate.sum()) > 0
    np.testing.assert_array_equal(dp.eps_spent(fin.state.ustate), dp.eps_spent(ref.state.ustate))


@pytest.mark.parametrize("cut", [6, 11, 12, 18])
def test_async_dynamic_resume_bit_exact_across_cut_points(tmp_path, cut):
    """The refresh grid is absolute in the slot counter, so a save at any
    point, exactly on a refresh boundary included, replays the same
    refreshes."""
    _, obj = _quad(40, seed=1)

    def mk():
        return AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, metrics=True,
                           graph_update=GraphUpdate(every=6), **F64)

    ref_eng, ref, res_eng, fin = _resume_run(mk, np.zeros((40, 4)), 24, cut, tmp_path)
    np.testing.assert_array_equal(fin.Theta, ref.Theta)
    _assert_states_equal(fin.state, ref.state)
    assert res_eng.topology_log == ref_eng.topology_log
    assert int(res_eng.topo.version) == int(ref_eng.topo.version)
    assert res_eng.topo.capacity == ref_eng.topo.capacity
    assert res_eng._csr.digest() == ref_eng._csr.digest()


def test_async_delay_ring_resumes_bit_exact(tmp_path):
    """The staleness ring buffer (hist) is part of the resume closure."""
    _, obj = _quad(32, seed=4)
    scen = Scenario(delay=DelayConfig(max_delay=2))

    def mk():
        return AsyncEngine(CDUpdate(obj), slot_wakes=6.0, seed=2, scenario=scen, **F64)

    _, ref, _, fin = _resume_run(mk, np.zeros((32, 4)), 16, 7, tmp_path)
    np.testing.assert_array_equal(fin.Theta, ref.Theta)
    assert torch.equal(fin.state.hist, ref.state.hist)
    _assert_states_equal(fin.state, ref.state)


# -- ShardedAsyncEngine ---------------------------------------------------------


def _forced(engine, Theta0, masks, state=None):
    state = engine.init_state(Theta0) if state is None else state
    for mask in masks:
        state = engine.step(state, mask)
    return state


def test_sharded_static_resume_bit_exact_forced_wakes(tmp_path):
    _, obj = _quad(40, seed=1)

    def mk():
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=1, slot_wakes=8.0, seed=0,
                                  metrics=True, **F64)

    rng = np.random.default_rng(7)
    masks = [rng.random(40) < 0.25 for _ in range(10)]
    s1 = _forced(mk(), np.zeros((40, 4)), masks)
    e2 = mk()
    s2 = _forced(e2, np.zeros((40, 4)), masks[:5])
    save_engine_checkpoint(e2, s2, str(tmp_path / "ck"))
    e3 = mk()
    st, step = restore(e3, str(tmp_path / "ck"))
    assert step == 5
    _assert_states_equal(_forced(e3, None, masks[5:], st), s1)


def test_sharded_dp_resume_bit_exact(tmp_path):
    _, obj = _quad(36, seed=2, clip=1.0)
    dp = DPCDUpdate.plan(obj, DPConfig(eps_bar=1.0), planned_Ti=4)

    def mk():
        return ShardedAsyncEngine(dp, num_shards=1, slot_wakes=8.0, seed=0, metrics=True, **F64)

    _, ref, _, fin = _resume_run(mk, np.zeros((36, 4)), 20, 10, tmp_path)
    np.testing.assert_array_equal(fin.Theta, ref.Theta)
    _assert_states_equal(fin.state, ref.state)


@pytest.mark.parametrize("cut", [6, 9, 12])
def test_sharded_dynamic_sampled_run_resume_bit_exact(tmp_path, cut):
    _, obj = _quad(48, seed=2)

    def mk():
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=1, slot_wakes=8.0, seed=0,
                                  metrics=True, graph_update=GraphUpdate(every=6),
                                  drift_threshold=1.0, **F64)

    ref_eng, ref, res_eng, fin = _resume_run(mk, np.zeros((48, 4)), 24, cut, tmp_path)
    np.testing.assert_array_equal(fin.Theta, ref.Theta)
    _assert_states_equal(fin.state, ref.state)
    assert res_eng.topology_log == ref_eng.topology_log


@pytest.mark.parametrize("tag", ["CD", "DP"])
def test_sharded_multidevice_resume_bit_exact(tmp_path, tag):
    """The reference's S = 4 script, with the four shards stacked on one
    device: forced-wake resume bit for bit for CD and DP-CD, and sampled
    dynamic runs across a refresh boundary."""
    _, obj = _quad(96, seed=1, clip=1.0 if tag == "DP" else None)
    upd = CDUpdate(obj) if tag == "CD" else DPCDUpdate.plan(obj, DPConfig(eps_bar=1.0),
                                                            planned_Ti=4)

    def mk():
        return ShardedAsyncEngine(upd, num_shards=4, slot_wakes=8.0, seed=0, relabel="rcm",
                                  metrics=True, **F64)

    rng = np.random.default_rng(5)
    masks = [rng.random(96) < 0.3 for _ in range(10)]
    s1 = _forced(mk(), np.zeros((96, 4)), masks)
    e2 = mk()
    s2 = _forced(e2, np.zeros((96, 4)), masks[:5])
    save_engine_checkpoint(e2, s2, str(tmp_path / "ck"))
    e3 = mk()
    st, step = restore(e3, str(tmp_path / "ck"))
    assert step == 5
    _assert_states_equal(_forced(e3, None, masks[5:], st), s1)

    _, dobj = _quad(96, seed=2)

    def mkd():
        return ShardedAsyncEngine(CDUpdate(dobj), num_shards=4, slot_wakes=8.0, seed=0,
                                  graph_update=GraphUpdate(every=6), drift_threshold=1.0, **F64)

    for cut in (6, 9):
        ref_eng, ref, res_eng, fin = _resume_run(mkd, np.zeros((96, 4)), 24, cut, tmp_path)
        np.testing.assert_array_equal(fin.Theta, ref.Theta)
        assert res_eng.topology_log == ref_eng.topology_log


def test_sharded_bf16_error_feedback_wire_resumes_bit_exact(tmp_path):
    """A compressed wire's error-feedback accumulator is saved: a sampled
    resume on a bf16 + error-feedback p2p wire is still bit for bit."""
    _, obj = _quad(96, seed=3)

    def mk():
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=4, slot_wakes=12.0, seed=1,
                                  relabel="rcm", metrics=True, dtype=torch.float32, device="cpu",
                                  exchange=ExchangeSpec(method="p2p", dtype="bf16",
                                                        error_feedback=True))

    _, ref, _, fin = _resume_run(mk, np.zeros((96, 4)), 20, 8, tmp_path)
    assert fin.state.ef is not None and float(fin.state.ef.abs().sum()) > 0
    _assert_states_equal(fin.state, ref.state)


class _MaterializationProbe:
    """Fails the test if the checkpoint path assembles a global (n, p)
    float array: ``pad_rows`` on an (n, >= 2-D) float input, ``unpad_rows``
    on stacked float tiles, or any ``global_theta`` call."""

    def __enter__(self):
        self._pad, self._unpad = GraphPartition.pad_rows, GraphPartition.unpad_rows
        self._gt = ShardedAsyncEngine.global_theta
        pad, unpad = self._pad, self._unpad

        def _is_float(arr):
            return "float" in str(arr.dtype)

        def trap_pad(part, rows, *a, **k):
            if np.ndim(rows) >= 2 and np.shape(rows)[0] == part.n and _is_float(rows):
                raise AssertionError(f"pad_rows saw a global array: {np.shape(rows)}")
            return pad(part, rows, *a, **k)

        def trap_unpad(part, tiles, *a, **k):
            if np.ndim(tiles) >= 3 and _is_float(tiles):
                raise AssertionError(f"unpad_rows would build a global array: {np.shape(tiles)}")
            return unpad(part, tiles, *a, **k)

        def trap_gt(engine, state):
            raise AssertionError("global_theta called inside the checkpoint path")

        GraphPartition.pad_rows, GraphPartition.unpad_rows = trap_pad, trap_unpad
        ShardedAsyncEngine.global_theta = trap_gt
        return self

    def __exit__(self, *exc):
        GraphPartition.pad_rows, GraphPartition.unpad_rows = self._pad, self._unpad
        ShardedAsyncEngine.global_theta = self._gt
        return False


def test_sharded_checkpoint_never_materializes_global_theta(tmp_path):
    """Save and restore work tile by tile: no (n, p) model matrix exists on
    the host at any point in either direction."""
    _, obj = _quad(48, seed=5)

    def mk():
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=3, slot_wakes=8.0, seed=0,
                                  metrics=True, **F64)

    eng = mk()
    rng = np.random.default_rng(3)
    state = _forced(eng, np.zeros((48, 4)), [rng.random(48) < 0.3 for _ in range(4)])
    target = mk()
    with _MaterializationProbe():
        save_engine_checkpoint(eng, state, str(tmp_path / "ck"))
        restored, _ = restore(target, str(tmp_path / "ck"))
    saved = _leaves(state)
    got = _leaves(restored)
    for k in saved:
        if k != ".slab":  # the halo rows are derived, not saved
            assert np.array_equal(saved[k], got[k]), k
    R = eng.rows_per_shard
    assert torch.equal(restored.slab[: 3 * R], state.slab[: 3 * R])


def test_sharded_elastic_restore_s4_to_s8(tmp_path):
    """An S = 4 entry restores into S = 8: under forced wakes within 1e-10
    of the uninterrupted S = 8 run, with the probe armed around the round
    trip and the run totals kept (collapsed into shard 0); a sampled run
    resumed at S = 8 reaches the fixed point within 1e-5."""
    _, obj = _quad(128, seed=3)

    def mk(S, slot_wakes=8.0):
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=S, slot_wakes=slot_wakes, seed=0,
                                  metrics=True, **F64)

    rng = np.random.default_rng(7)
    masks = [rng.random(128) < 0.25 for _ in range(10)]
    e8 = mk(8)
    s8 = _forced(e8, np.zeros((128, 4)), masks)
    e4 = mk(4)
    s4 = _forced(e4, np.zeros((128, 4)), masks[:5])
    e8b = mk(8)
    with _MaterializationProbe():
        save_engine_checkpoint(e4, s4, str(tmp_path / "ck"))
        st, step = restore(e8b, str(tmp_path / "ck"))
    assert step == 5
    st = _forced(e8b, None, masks[5:], st)
    assert np.abs(e8b.global_theta(st) - e8.global_theta(s8)).max() <= TOL64
    assert int(st.applied.sum()) == int(s8.applied.sum())
    assert float(st.messages.sum()) == float(s8.messages.sum())
    assert int(st.ptr[0]) == int(s8.ptr[0]) == 10
    counters, _ = e8b.metrics_snapshot(st)
    want, _ = e8.metrics_snapshot(s8)
    assert int(counters["wakes_applied"].sum()) == int(want["wakes_applied"].sum())

    star = obj.solve_exact()
    e4s = mk(4, slot_wakes=32.0)
    half = e4s.run(np.zeros((128, 4)), slots=40)
    save_engine_checkpoint(e4s, half.state, str(tmp_path / "sampled"))
    e8s = mk(8, slot_wakes=32.0)
    st, _ = restore(e8s, str(tmp_path / "sampled"))
    fin = e8s.run(None, slots=760, state=st)
    assert np.abs(fin.Theta - star).max() < 1e-5
    assert fin.wakes_applied > half.wakes_applied


# -- the port against the reference under forced wakes ---------------------------


def _ref_forced(engine, Theta0, masks, state=None):
    state = engine.init_state(Theta0) if state is None else state
    for mask in masks:
        state = engine.step(state, jnp.asarray(mask))
    return state


@pytest.mark.parametrize("kind", ["async", "async_dynamic", "sharded_s1", "sharded_s4"])
def test_resumed_theta_matches_the_reference_resumed_theta(tmp_path, kind):
    """Forced wakes, save after 5, restore into fresh engines, 5 more: the
    port's resumed Theta against the reference's resumed Theta (each
    package's own entries), float64, 1e-10. The dynamic kind refreshes
    the topology explicitly after slots 3 and 7; the S = 4 port engine is
    held to the reference's single-device engine (the reference holds its
    sharded engine to it bit for bit)."""
    ref, port = _quad(64, seed=6)
    n, p = 64, 4
    rng = np.random.default_rng(8)
    masks = [rng.random(n) < 0.3 for _ in range(10)]
    dyn = kind == "async_dynamic"
    gu = dict(every=1000, k=6, candidates=3, gamma=4.0, seed=0)

    def make_ref():
        kw = dict(graph_update=jsim.GraphUpdate(**gu)) if dyn else {}
        if kind == "sharded_s1":
            return jsim.ShardedAsyncEngine(jsim.CDUpdate(ref), num_shards=1, slot_wakes=8.0,
                                           seed=0, dtype=jnp.float64)
        return jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, seed=0, dtype=jnp.float64,
                                **kw)

    def make_port():
        kw = dict(graph_update=GraphUpdate(**gu)) if dyn else {}
        if kind.startswith("sharded"):
            return ShardedAsyncEngine(CDUpdate(port), num_shards=int(kind[-1]), slot_wakes=8.0,
                                      seed=0, relabel="rcm", **F64)
        return AsyncEngine(CDUpdate(port), slot_wakes=8.0, seed=0, **kw, **F64)

    def drive(eng, state, masks, first, forced):
        for t, mask in enumerate(masks, start=first):
            state = forced(eng, None, [mask], state)
            if dyn and t in (3, 7):
                state = eng._refresh_topology(state, t)
        return state

    outs = []
    for make, save, load, forced in ((make_ref, ref_save, ref_restore, _ref_forced),
                                     (make_port, save_engine_checkpoint, restore, _forced)):
        eng = make()
        state = drive(eng, eng.init_state(np.zeros((n, p))), masks[:5], 1, forced)
        ck = str(tmp_path / f"{make.__name__}")
        save(eng, state, ck)
        eng2 = make()
        state, step = load(eng2, ck)
        assert step == 5
        state = drive(eng2, state, masks[5:], 6, forced)
        outs.append(eng2.global_theta(state) if hasattr(eng2, "part")
                    else np.asarray(state.Theta))
        if dyn:
            outs.append(eng2._csr.digest())
    if dyn:
        assert outs[1] == outs[3]
        outs = outs[::2]
    assert np.abs(outs[1] - outs[0]).max() <= TOL64


# -- guard rails -----------------------------------------------------------------


def test_fingerprint_mismatches_are_rejected(tmp_path):
    _, obj = _quad(40, seed=1)
    _, other = _quad(40, seed=9)  # another graph and data
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, device="cpu")
    res = eng.run(np.zeros((40, 4)), slots=4)
    ck = str(tmp_path / "ck")
    save_engine_checkpoint(eng, res.state, ck)
    with pytest.raises(CheckpointError, match="config"):
        restore(AsyncEngine(CDUpdate(obj), slot_wakes=4.0, seed=0, device="cpu"), ck)
    with pytest.raises(CheckpointError, match="graph"):
        restore(AsyncEngine(CDUpdate(other), slot_wakes=8.0, seed=0, device="cpu"), ck)
    with pytest.raises(CheckpointError, match="cannot restore"):
        restore(ShardedAsyncEngine(CDUpdate(obj), num_shards=1, slot_wakes=8.0, device="cpu"),
                ck)
    with pytest.raises(CheckpointError, match="dtype"):
        restore(AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, **F64), ck)
    save_checkpoint(str(tmp_path / "plain"), {"w": torch.zeros(3)})
    with pytest.raises(CheckpointError, match="not an engine checkpoint"):
        restore(eng, str(tmp_path / "plain"))


def test_a_stream_never_crosses_device_types(tmp_path):
    """A CUDA generator's state (seed, offset) cannot continue on a CPU
    engine (mt19937): restoring a card entry's stream on the CPU raises
    naming the generator, for both engines; the placement itself (the
    ``device`` field) is not part of the config digest."""
    import json

    _, obj = _quad(24, seed=2)
    for eng in (AsyncEngine(CDUpdate(obj), slot_wakes=6.0, seed=0, device="cpu"),
                ShardedAsyncEngine(CDUpdate(obj), num_shards=2, slot_wakes=6.0, seed=0,
                                   device="cpu")):
        ck = str(tmp_path / type(eng).__name__)
        save_engine_checkpoint(eng, eng.init_state(np.zeros((24, 4))), ck)
        mp = os.path.join(ck, "manifest.json")
        manifest = json.load(open(mp))
        assert manifest["generator_device"] == "cpu"
        manifest["generator_device"] = "cuda"  # what the card writes
        json.dump(manifest, open(mp, "w"))
        with pytest.raises(CheckpointError, match="'.generator'.*cuda generator"):
            restore(eng, ck)
    from repro_torch.checkpoint.engine_io import config_digest
    from repro_torch.sim import EngineConfig

    cfg = EngineConfig(device="cpu")
    object.__setattr__(cfg, "device", "cuda:0")  # what an engine on the card carries
    assert config_digest(cfg) == config_digest(EngineConfig(device="cpu"))


def test_run_checkpoint_every_writes_restorable_rotation(tmp_path):
    _, obj = _quad(40, seed=1)

    def mk():
        return ShardedAsyncEngine(CDUpdate(obj), num_shards=1, slot_wakes=8.0, seed=0, **F64)

    ck = str(tmp_path / "rot")
    ref = mk().run(np.zeros((40, 4)), slots=12)
    mk().run(np.zeros((40, 4)), slots=12, checkpoint_every=4, checkpoint_dir=ck,
             checkpoint_keep_last=2)
    entries = sorted(e for e in os.listdir(ck) if e.startswith("ckpt-"))
    assert entries == ["ckpt-000000000008", "ckpt-000000000012"]
    eng3 = mk()
    state, step = restore(eng3, ck)
    assert step == 12
    np.testing.assert_array_equal(eng3.global_theta(state), ref.Theta)
    with pytest.raises(ValueError, match="checkpoint_every and checkpoint_dir"):
        mk().run(np.zeros((40, 4)), slots=4, checkpoint_every=4)
    with pytest.raises(ValueError, match="checkpoint_every and checkpoint_dir"):
        mk().run(np.zeros((40, 4)), slots=4, checkpoint_dir=ck)


def test_engine_state_dict_exposes_fingerprint_and_files():
    _, obj = _quad(24, seed=3)
    eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=1, slot_wakes=8.0, seed=0, device="cpu")
    files, manifest = eng.state_dict(eng.init_state(np.zeros((24, 4))))
    assert manifest["kind"] == "engine" and manifest["engine"] == "sharded"
    assert manifest["fingerprint"]["n"] == 24 and manifest["fingerprint"]["dtype"] == "float32"
    assert {"partition.npz", "scalars.npz", "shard_0.npz"} <= set(files)
    assert files["scalars.npz"]["generator"].dtype == np.uint8
    assert files["scalars.npz"]["applied"].dtype == np.int64  # the port's counters
    # Per-shard files carry original agent ids: the relabel-stable key.
    assert sorted(files["shard_0.npz"]["ids"].tolist()) == list(range(24))
    single = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, device="cpu")
    files, manifest = single.state_dict(single.init_state(np.zeros((24, 4))))
    paths = {r["path"]: r for r in manifest["leaves"]}
    assert paths[".generator"]["dtype"] == "uint8" and paths[".ptr"]["dtype"] == "int64"
    assert set(files) == {"state.npz"} and manifest["generator_device"] == "cpu"

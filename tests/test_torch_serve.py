"""repro_torch.serve against the reference's serving tier: snapshot
consistency, routing, cold start, checkpoint serving, and the two
packages' entries served by each other.

Counterparts of ``tests/test_serve.py`` (its ``launch/`` stub test
aside). The reference's multi-device S = 4 script runs here with the
four shards stacked on one device. The port's snapshots are copies, not
references (the slot writes Theta in place), so the zero-copy test's
counterpart asserts the opposite: a snapshot does not alias the live
state, and later slots leave it unchanged.

Tolerances: warm rows and one-hot predictions exact (float32 rows of the
snapshot); a cold row's Eq. 16 average against a hand computation to
rtol 1e-6 with atol 1e-7 (float32 sums whose terms may cancel) and its
score to rtol 1e-5; predictions of the same
entry through the reference's ``serve_from_checkpoint`` and the port's
within 1e-6 in float32 (the sums of one row's dot in another order).
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro.sim as jsim
from repro.checkpoint import save_engine_checkpoint as ref_save
from repro.checkpoint.checkpoint import _verify_entry as ref_verify
from repro.core import AgentData, knn_graph, make_objective
from repro_torch.checkpoint import CheckpointError, save_checkpoint, save_engine_checkpoint
from repro_torch.convert import objective_from_reference
from repro_torch.obs import SERVE_COUNTERS, serve_counters_init
from repro_torch.serve import ServeHandle, ServeSpec, serve_from_checkpoint
from repro_torch.sim import ArrivalConfig, AsyncEngine, CDUpdate, Scenario, ShardedAsyncEngine
from repro_torch.sim.partition import GraphPartition

F64 = dict(dtype=torch.float64, device="cpu")


def _quad(n, p=4, m=3, seed=0, mu=0.5):
    """(reference objective, port objective): the reference tests' problem."""
    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    ref = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic", mu=mu,
                         mix_mode="sparse")
    return ref, objective_from_reference(ref)


def _engines(obj):
    return (AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, **F64),
            ShardedAsyncEngine(CDUpdate(obj), num_shards=1, slot_wakes=8.0, seed=0, **F64))


# -- spec / run contract ----------------------------------------------


def test_serve_spec_coerce_and_validation():
    assert ServeSpec.coerce(None) == ServeSpec()
    spec = ServeSpec(buffers=3, neighbors={9: (0, 1)})
    assert ServeSpec.coerce(spec) is spec
    with pytest.raises(TypeError, match="ServeSpec"):
        ServeSpec.coerce("double")
    with pytest.raises(ValueError, match="buffers"):
        ServeSpec(buffers=1)
    with pytest.raises(ValueError, match="at least one neighbour"):
        ServeSpec(neighbors={3: ()})


def test_run_driver_error_messages_identical_across_engines():
    """``run`` raises the same message from either engine (metrics
    off, the checkpoint pairing, the snapshot pairing), and it is the
    reference's message up to the package's name."""
    ref, obj = _quad(32, seed=1)
    Theta0 = np.zeros((32, 4))
    messages = {"metrics": set(), "checkpoint": set(), "snapshot": set()}
    for eng in _engines(obj):
        with pytest.raises(ValueError) as ei:
            eng.run(Theta0, 2, metrics_every=1)
        messages["metrics"].add(str(ei.value))
        for kwargs in (dict(checkpoint_every=2), dict(checkpoint_dir="ck")):
            with pytest.raises(ValueError) as ei:
                eng.run(Theta0, 2, **kwargs)
            messages["checkpoint"].add(str(ei.value))
        handle = ServeHandle.for_engine(eng)
        for kwargs in (dict(snapshot_every=2), dict(serve=handle)):
            with pytest.raises(ValueError) as ei:
                eng.run(Theta0, 2, **kwargs)
            messages["snapshot"].add(str(ei.value))
    assert all(len(v) == 1 for v in messages.values())
    jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=8.0, seed=0)
    jhandle = jserve.ServeHandle.for_engine(jeng)
    for key, kwargs in (("metrics", dict(metrics_every=1)), ("checkpoint", dict(checkpoint_every=2)),
                        ("snapshot", dict(serve=jhandle))):
        with pytest.raises(ValueError) as ei:
            jeng.run(Theta0, 2, **kwargs)
        (mine,) = messages[key]
        assert mine.replace("repro_torch.", "repro.") == str(ei.value)


# -- snapshot consistency ----------------------------------------------------


@pytest.mark.parametrize("sharded", [False, True])
def test_snapshot_version_bit_exact_and_immutable(sharded):
    """A version read mid-training equals the engine's Theta at its
    publication slot bit for bit, and stays so after training moves on."""
    _, obj = _quad(48, seed=2)
    eng = _engines(obj)[int(sharded)]
    handle = ServeHandle.for_engine(eng)
    ids = np.arange(48)
    half = eng.run(np.zeros((48, 4)), 3, snapshot_every=3, serve=handle)
    assert handle.version == 3 == half.slots
    pinned = handle.snapshot()
    served3 = handle.rows(ids, at=pinned)
    assert np.array_equal(served3.values, half.Theta[ids].astype(np.float32))
    final = eng.run(None, 3, state=half.state, snapshot_every=3, serve=handle)
    assert handle.version == 6 == final.slots
    served6 = handle.rows(ids)
    assert np.array_equal(served6.values, final.Theta[ids].astype(np.float32))
    assert np.array_equal(handle.rows(ids, at=pinned).values, served3.values)
    assert not np.array_equal(served6.values, served3.values)
    # A one-hot feature makes the whole predict path one Theta entry.
    pr = handle.predict(ids, np.eye(4)[[1] * 48])
    assert np.array_equal(pr.values, final.Theta[:, 1].astype(np.float32))


class _Probe:
    """Fails the test if serving assembles a global (n, p) float array."""

    def __enter__(self):
        self._pad, self._unpad = GraphPartition.pad_rows, GraphPartition.unpad_rows
        self._gt = ShardedAsyncEngine.global_theta
        pad, unpad = self._pad, self._unpad

        def trap_pad(part, rows, *a, **k):
            if np.ndim(rows) >= 2 and np.shape(rows)[0] == part.n and "float" in str(rows.dtype):
                raise AssertionError(f"pad_rows saw a global array: {np.shape(rows)}")
            return pad(part, rows, *a, **k)

        def trap_unpad(part, tiles, *a, **k):
            if np.ndim(tiles) >= 3 and "float" in str(tiles.dtype):
                raise AssertionError(f"unpad_rows: {np.shape(tiles)}")
            return unpad(part, tiles, *a, **k)

        def trap_gt(engine, s):
            raise AssertionError("global_theta on the serve path")

        GraphPartition.pad_rows, GraphPartition.unpad_rows = trap_pad, trap_unpad
        ShardedAsyncEngine.global_theta = trap_gt
        return self

    def __exit__(self, *exc):
        GraphPartition.pad_rows, GraphPartition.unpad_rows = self._pad, self._unpad
        ShardedAsyncEngine.global_theta = self._gt
        return False


def test_sharded_serve_path_never_materializes_global_theta():
    """Publish, route, gather, predict: none assembles an (n, p) float array."""
    _, obj = _quad(40, seed=3)
    eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=3, slot_wakes=8.0, seed=0, **F64)
    handle = ServeHandle.for_engine(eng)
    state = eng.advance(eng.init_state(np.zeros((40, 4))), 2)
    with _Probe():
        handle.publish(state)
        r = handle.rows([0, 7, 39])
        handle.predict([0, 7, 39], np.ones((3, 4)))
        handle.predict([45], np.ones((1, 4)), neighbors={45: (0, 7)})
    want = state.Theta[eng.part.shard_of[[0, 7, 39]], eng.part.local_of[[0, 7, 39]]]
    assert np.array_equal(r.values, want.numpy().astype(np.float32))
    assert tuple(handle.snapshot().tiles.shape) == (3, eng.rows_per_shard, 4)


@pytest.mark.parametrize("sharded", [False, True])
def test_published_tiles_are_copies_not_the_engines_state(sharded):
    """The opposite of the reference's zero-copy test: the snapshot does not
    alias the live state (the slot writes it in place), and later slots
    leave the published tiles unchanged."""
    _, obj = _quad(24, seed=9)
    eng = _engines(obj)[int(sharded)]
    handle = ServeHandle.for_engine(eng)
    state = eng.init_state(np.zeros((24, 4)))
    handle.publish(state)
    snap = handle.snapshot()
    live = state.Theta if sharded else state.Theta.unsqueeze(0)
    assert snap.tiles is not state.Theta
    assert snap.tiles.data_ptr() != live.data_ptr() and torch.equal(snap.tiles, live)
    before = snap.tiles.clone()
    state = eng.advance(state, 4)
    assert not torch.equal(state.Theta if sharded else state.Theta.unsqueeze(0), before)
    assert torch.equal(snap.tiles, before)


def test_readers_serve_the_newest_ready_snapshot():
    """A snapshot whose copy is still in flight (its event not complete) is
    published but not served: readers take the newest ready one, and the
    ``run``'s versions are its own slot count, equal to the state's."""
    from repro_torch.serve import SnapshotStore, ThetaSnapshot

    class Pending:
        def query(self):
            return False

    store = SnapshotStore(3)
    tiles = torch.zeros(1, 2, 2)
    for v, ready in ((1, None), (2, None), (3, Pending())):
        store.publish(ThetaSnapshot(version=v, tiles=tiles + v, shard_of=None, local_of=None,
                                    pending=frozenset(), ready=ready))
    assert store.latest_version == 3 and store.latest_ready.version == 2
    _, obj = _quad(24, seed=3)
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=6.0, seed=0, **F64)
    handle = ServeHandle.for_engine(eng)
    res = eng.run(np.zeros((24, 4)), 7, snapshot_every=3, serve=handle)
    assert handle.version == res.slots == int(res.state.ptr) == 7
    res = eng.run(None, 5, state=res.state, snapshot_every=2, serve=handle)
    assert handle.version == int(res.state.ptr) == 12
    assert handle.counters()["serve_snapshots_published"] == 4 + 4


# -- cold start --------------------------------------------------------------


def test_cold_start_matches_hand_computed_eq16_average():
    """A cold row is the Eq. 16 confidence-zero neighbour average (the
    uniform mean of the neighbours' served rows), by hand and as the
    reference's handle serves the same snapshot."""
    ref, obj = _quad(32, seed=4)
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, **F64)
    handle = ServeHandle.for_engine(eng)
    res = eng.run(np.zeros((32, 4)), 4, snapshot_every=4, serve=handle)
    nbrs = (0, 2, 5)
    want_row = res.Theta[list(nbrs)].astype(np.float32).mean(axis=0)
    got = handle.rows([132], neighbors={132: nbrs})
    assert bool(got.cold[0])
    np.testing.assert_allclose(got.values[0], want_row, rtol=1e-6, atol=1e-7)
    x = np.linspace(-1, 1, 4)
    pr = handle.predict([132], x[None], neighbors={132: nbrs})
    np.testing.assert_allclose(pr.values[0], want_row @ x.astype(np.float32), rtol=1e-5)
    mixed = handle.rows([3, 132], neighbors={132: nbrs})
    assert np.array_equal(mixed.values[0], res.Theta[3].astype(np.float32))
    assert list(mixed.cold) == [False, True]
    with pytest.raises(ValueError, match="no attachment neighbours"):
        handle.rows([37])

    # The reference's handle on the same snapshot (its tiles as jax arrays).
    snap = handle.snapshot()
    jstore = jserve.SnapshotStore(2)
    jstore.publish(jserve.ThetaSnapshot(version=snap.version,
                                        tiles=jnp.asarray(snap.tiles.numpy()),
                                        shard_of=None, local_of=None, pending=frozenset()))
    jhandle = jserve.ServeHandle(jstore, jserve.ServeSpec(), n=32, p=4)
    X = np.random.default_rng(1).normal(size=(3, 4))
    ids, nb = [3, 132, 17], {132: nbrs}
    np.testing.assert_allclose(handle.rows(ids, neighbors=nb).values,
                               jhandle.rows(ids, neighbors=nb).values, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(handle.predict(ids, X, neighbors=nb).values,
                               jhandle.predict(ids, X, neighbors=nb).values, rtol=1e-6, atol=1e-6)


def test_pending_arrivals_served_cold_from_their_attach_map():
    """A scheduled-but-not-admitted arrival is cold, ``for_engine`` takes
    its neighbours from the arrival attach map, and pending ids are
    rejected as neighbours."""
    _, obj = _quad(24, seed=5)
    late = 7
    arrival = ArrivalConfig(schedule=((1000, (late,)),), attach={late: (1, 4)})
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=6.0, seed=0, scenario=Scenario(arrival=arrival),
                      **F64)
    handle = ServeHandle.for_engine(eng)
    assert handle.spec.neighbors == {late: (1, 4)}
    res = eng.run(np.zeros((24, 4)), 3, snapshot_every=3, serve=handle)
    got = handle.rows([late])
    assert bool(got.cold[0])
    np.testing.assert_allclose(got.values[0], res.Theta[[1, 4]].astype(np.float32).mean(axis=0),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="not established"):
        handle.rows([25], neighbors={25: (late, 1)})


# -- checkpoint serving ------------------------------------------------------


@pytest.mark.parametrize("sharded", [False, True])
def test_serve_from_checkpoint_round_trip(sharded, tmp_path):
    _, obj = _quad(40, seed=6)
    eng = _engines(obj)[int(sharded)]
    ck = str(tmp_path / "ck")
    res = eng.run(np.zeros((40, 4)), 4, checkpoint_every=2, checkpoint_dir=ck)
    handle = serve_from_checkpoint(ck, device="cpu")
    assert (handle.n, handle.p, handle.version) == (40, 4, 4)
    ids = np.arange(40)
    assert np.array_equal(handle.rows(ids).values, res.Theta[ids].astype(np.float32))
    cold = handle.rows([49], neighbors={49: (0, 3)})
    np.testing.assert_allclose(cold.values[0], res.Theta[[0, 3]].astype(np.float32).mean(axis=0),
                               rtol=1e-6)
    with pytest.raises(RuntimeError, match="not bound to a live engine"):
        handle.publish(res.state)


def test_serve_from_checkpoint_fingerprint_rejection_matrix(tmp_path):
    _, obj = _quad(32, seed=7)
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, **F64)
    res = eng.run(np.zeros((32, 4)), 2)
    ck = str(tmp_path / "ck")
    save_engine_checkpoint(eng, res.state, ck)
    for key, bogus in (("n", 33), ("dtype", "float32"), ("engine", "sharded")):
        with pytest.raises(CheckpointError, match=f"mismatch on '{key}'"):
            serve_from_checkpoint(ck, expect_fingerprint={key: bogus}, device="cpu")
    handle = serve_from_checkpoint(
        ck, expect_fingerprint={"n": 32, "engine": "async", "dynamic": False}, device="cpu")
    assert handle.version == 2
    plain = str(tmp_path / "plain")
    save_checkpoint(plain, {"theta": np.zeros((4, 2))})
    with pytest.raises(CheckpointError, match="not an engine checkpoint"):
        serve_from_checkpoint(plain, device="cpu")
    npzs = sorted(os.path.join(root, f) for root, _d, files in os.walk(ck)
                  for f in files if f.endswith(".npz"))
    with open(npzs[0], "r+b") as f:
        f.seek(60)
        f.write(b"\xde\xad")
    with pytest.raises(CheckpointError):
        serve_from_checkpoint(ck, device="cpu")


def test_serve_counters_and_version_lag():
    assert "serve_version_lag" in SERVE_COUNTERS
    assert serve_counters_init()["serve_version_lag"] == 0
    from repro.obs import SERVE_COUNTERS as REF_COUNTERS

    assert SERVE_COUNTERS == REF_COUNTERS
    _, obj = _quad(32, seed=8)
    eng = AsyncEngine(CDUpdate(obj), slot_wakes=8.0, seed=0, **F64)
    handle = ServeHandle.for_engine(eng)
    half = eng.run(np.zeros((32, 4)), 2, snapshot_every=2, serve=handle)
    stale = handle.snapshot()
    eng.run(None, 4, state=half.state, snapshot_every=2, serve=handle)
    handle.predict([1, 2, 3], np.ones((3, 4)))
    assert handle.counters()["serve_version_lag"] == 0
    handle.predict([1], np.ones((1, 4)), at=stale)
    c = handle.counters()
    assert c["serve_version_lag"] == 4 and c["serve_version_lag_max"] == 4
    assert (c["serve_requests"], c["serve_predictions"], c["serve_batch_rows_max"]) == (2, 4, 3)
    assert c["serve_snapshots_published"] == 5  # a start publish per run, then every 2 slots
    assert set(c) == set(SERVE_COUNTERS)
    assert handle.publish_device_seconds() == 0.0  # no device events on the CPU


def test_sharded_multidevice_serve_consistency_and_probe(tmp_path):
    """The reference's S = 4 script with the shards stacked on one device:
    mid-training versions exact at their publication slot, one-hot
    predicts exact through the routing, and neither live nor checkpoint
    serving assembles (n, p)."""
    _, obj = _quad(96, seed=11)
    eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, slot_wakes=8.0, seed=0, relabel="rcm",
                             **F64)
    handle = ServeHandle.for_engine(eng)
    half = eng.run(np.zeros((96, 4)), 3, snapshot_every=3, serve=handle)
    pinned = handle.snapshot()
    assert pinned.version == 3 == half.slots
    final = eng.run(None, 3, state=half.state, snapshot_every=3, serve=handle)
    assert handle.version == 6 == final.slots
    ids = np.arange(96)
    assert np.array_equal(handle.rows(ids, at=pinned).values, half.Theta.astype(np.float32))
    assert np.array_equal(handle.rows(ids).values, final.Theta.astype(np.float32))
    pr = handle.predict(ids, np.eye(4)[np.full(96, 2)])
    assert np.array_equal(pr.values, final.Theta[:, 2].astype(np.float32))
    ck = str(tmp_path / "ck")
    save_engine_checkpoint(eng, final.state, ck)
    with _Probe():
        handle.publish(final.state)
        live_rows = handle.rows(ids).values
        offline = serve_from_checkpoint(ck, device="cpu")
        off_rows = offline.rows(ids).values
        cold = offline.rows([97], neighbors={97: (0, 9)}).values
    assert np.array_equal(live_rows, final.Theta.astype(np.float32))
    assert np.array_equal(off_rows, final.Theta.astype(np.float32))
    np.testing.assert_allclose(cold[0], final.Theta[[0, 9]].astype(np.float32).mean(0), rtol=1e-6)
    assert offline.version == 6


# -- the two packages' entries, served by each other -----------------------------

_REF_S4 = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro.core import AgentData, knn_graph, make_objective
    from repro.sim import CDUpdate, ShardedAsyncEngine
    from repro.checkpoint import save_engine_checkpoint

    n, p, m = 512, 4, 3
    rng = np.random.default_rng(21)
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, rng.normal(size=(n, p)) / np.sqrt(p))
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse")
    eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, slot_wakes=64.0, seed=0,
                             relabel="rcm")
    res = eng.run(rng.normal(size=(n, p)), 6)
    save_engine_checkpoint(eng, res.state, sys.argv[1])
    np.save(sys.argv[1] + ".theta.npy", res.Theta)
    print("REF_S4_OK")
    """
)


def _queries(n=512, p=4, seed=5):
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, n, 60), [n + 3, n + 8]])
    return ids, rng.normal(size=(ids.size, p)), {n + 3: (1, 2, 3, 4), n + 8: (9,)}


def _agree(mine, theirs, warm_theta):
    """Both handles' answers: rows and predictions within 1e-6 (float32),
    warm rows exactly the entry's rows."""
    ids, X, nb = _queries()
    a, b = mine.rows(ids, neighbors=nb), theirs.rows(ids, neighbors=nb)
    assert a.version == b.version and list(a.cold) == list(np.asarray(b.cold))
    warm = ~a.cold
    assert np.array_equal(a.values[warm], np.asarray(b.values)[warm])
    assert np.array_equal(a.values[warm], warm_theta[ids[warm]].astype(np.float32))
    np.testing.assert_allclose(a.values, np.asarray(b.values), rtol=1e-6, atol=1e-7)
    pa, pb = mine.predict(ids, X, neighbors=nb), theirs.predict(ids, X, neighbors=nb)
    np.testing.assert_allclose(pa.values, np.asarray(pb.values), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shards", [None, 4])
def test_the_reference_serves_a_port_entry(tmp_path, shards):
    """n = 512: the reference's ``_verify_entry`` accepts the port's entry,
    and its ``serve_from_checkpoint`` answers as the port's own does."""
    ref, obj = _quad(512, seed=21)
    kw = dict(slot_wakes=64.0, seed=0, device="cpu")
    eng = (AsyncEngine(CDUpdate(obj), **kw) if shards is None
           else ShardedAsyncEngine(CDUpdate(obj), num_shards=shards, relabel="rcm", **kw))
    res = eng.run(np.random.default_rng(2).normal(size=(512, 4)), 6)
    entry = save_engine_checkpoint(eng, res.state, str(tmp_path / "ck"))
    manifest = ref_verify(entry)
    assert manifest["fingerprint"]["dtype"] == "float32"
    theirs = jserve.serve_from_checkpoint(entry)
    mine = serve_from_checkpoint(entry, device="cpu")
    _agree(mine, theirs, res.Theta)


@pytest.mark.parametrize("shards", [None, 4])
def test_the_port_serves_a_reference_entry(tmp_path, shards):
    """n = 512: the port's ``serve_from_checkpoint`` answers a reference
    entry as the reference's own does (S = 4 written by the reference's
    sharded engine on four host devices, in a subprocess), and reads the
    reference's ``.Theta`` exactly."""
    ck = str(tmp_path / "ck")
    if shards is None:
        ref, _ = _quad(512, seed=21)
        jeng = jsim.AsyncEngine(jsim.CDUpdate(ref), slot_wakes=64.0, seed=0,
                                dtype=jnp.float32)
        res = jeng.run(np.random.default_rng(2).normal(size=(512, 4)), 6)
        ref_save(jeng, res.state, ck)
        theta = np.asarray(res.Theta)
    else:
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
        env.pop("JAX_ENABLE_X64", None)
        out = subprocess.run([sys.executable, "-c", _REF_S4, ck], env=env, capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0 and "REF_S4_OK" in out.stdout, out.stderr[-3000:]
        theta = np.load(ck + ".theta.npy")
    manifest = json.load(open(os.path.join(ck, "manifest.json")))
    assert manifest["fingerprint"]["engine"] == ("async" if shards is None else "sharded")
    mine = serve_from_checkpoint(ck, device="cpu")
    theirs = jserve.serve_from_checkpoint(ck)
    _agree(mine, theirs, theta)
    if shards is None:
        snap = mine.snapshot()
        assert snap.tiles.dtype == torch.float32
        assert np.array_equal(snap.tiles[0].numpy(), np.asarray(theirs.snapshot().tiles[0]))


class _Copy:
    """A stand-in for a publication's CUDA event: ready or still copying."""

    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_version_lag_is_counted_at_the_request_start_within_snapshot_every():
    """C4: a reader serves the newest snapshot whose copy is done; the
    trainer publishes version v + E only once the copy of v is done, so the
    served version trails the newest one published at the request's start
    by at most E = snapshot_every (``version_lag_start``). The counters keep
    the reference's end lag: publications made while a request runs add to
    ``serve_version_lag``, and nothing but the request's duration bounds
    them."""
    from repro_torch.serve.handle import SnapshotStore, ThetaSnapshot

    E = 16
    store = SnapshotStore(2)
    handle = ServeHandle(store, ServeSpec(), n=4, p=2)

    def snap(version, done):
        tiles = torch.full((1, 4, 2), float(version))
        return ThetaSnapshot(version=version, tiles=tiles, shard_of=None, local_of=None,
                             pending=frozenset(), ready=_Copy(done))

    store.publish(snap(0, True))
    pending = snap(E, False)  # enqueued, its copy not done
    store.publish(pending)
    res = handle.predict([1, 2], np.ones((2, 2)))
    assert res.version == 0 and handle.version_lag_start == (E, E)
    assert handle.counters()["serve_version_lag"] == E
    pending.ready.done = True  # the trainer waits for this before the next publication
    store.publish(snap(2 * E, False))
    serve = handle._serve

    def slow_serve(s, plan, X=None):  # two publications land while the request runs
        s3 = snap(3 * E, False)
        store._latest.ready.done = True
        store.publish(s3)
        s3.ready.done = True
        store.publish(snap(4 * E, False))
        return serve(s, plan, X)

    handle._serve = slow_serve
    res = handle.predict([3], np.ones((1, 2)))
    assert res.version == E
    c = handle.counters()
    assert handle.version_lag_start == (E, E)  # the newest at the start (2E) less E
    assert c["serve_version_lag"] == 3 * E and c["serve_version_lag_max"] == 3 * E  # 4E less E

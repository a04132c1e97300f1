"""The sharded engine one shard a process: dynamic topology, serving and
the phase programs across ranks.

The port's counterpart of the reference's multi-device
``MULTIDEV_DYNAMIC_SCRIPT`` (``tests/test_dynamic_topology.py:436-539``),
``SERVE_SCRIPT`` (``tests/test_serve.py:346-455``) and part 3 of
``OBS_MULTIDEV_SCRIPT`` (``tests/test_obs.py:412-510``). One worker
function a world size, 2 and 4 gloo processes (the ``spawn`` helper of
``tests/test_torch_rank_engine.py``), each building the per-rank engine
and, in the same process, the stacked engine on the same problem
(float64, the reference script's n = 48 problem):

* forced wakes, a refresh (rank 0 refreshes, the graph broadcast), an
  admission, a weight-only swap and a forced repartition (rows moving
  between ranks): every rank's owned rows, flags, counters, error
  feedback, rejoin tiles, live CSR, partition and topology log equal the
  stacked engine's shard ``rank`` (``torch.equal``, ``np.array_equal``);
* a dynamic per-rank checkpoint resumed bit for bit, restored into the
  stacked engine, and a stacked entry restored into the ranks;
* ``ServeHandle.for_engine`` on the ranks: a version pinned mid-run and
  the newest, one-hot ``predict`` and ``rows`` (a cold id included) equal
  the stacked handle's, with ``global_theta`` and the global padding
  trapped on the serve path, as ``SERVE_SCRIPT``'s probe traps them; a
  read that cannot be served (a rank with nothing published, a version
  a ring no longer holds, pinned versions that differ) raises on every
  rank, and the next read is in step;
* every phase prefix's output equals the stacked engine's shard
  ``rank`` (every agent wakes, so the draws do not depend on the
  generators), and ``profile_supertick`` runs on every rank;
* a sampled ``run`` with refreshes, arrivals, churn, publications and
  checkpoints agrees across the ranks.

At 4 ranks the reference's 4-shard engine on 4 XLA host devices (a
subprocess) takes the same forced steps, refresh and admission: the
refreshed CSR's ``indptr``/``indices`` equal, its ``data`` within 1e-12,
the models within 1e-10.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_rank_engine import _equal_shard, spawn

SRC = Path(__file__).resolve().parents[1] / "src"
N, P = 48, 3
ARRIVING = (46, 47)
GU = dict(every=4, k=6, candidates=4, gamma=2.0)
ARRIVAL = dict(schedule=((6, ARRIVING),), attach_k=3, seed=1)
MASKS = dict(seed=0, rate=0.4)


def prob(n=N, p=P, m=3, seed=0):
    """The reference script's quadratic problem (k-NN graph, k = 6)."""
    from repro_torch.core import AgentData, knn_graph, make_objective

    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 6)), k=6)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    data = AgentData(X=X, y=y, mask=np.ones((n, m)))
    return make_objective(graph, data, "quadratic", mu=0.5, mix_mode="sparse")


def _same_topology(st, rk, rank) -> bool:
    """The per-rank engine's host topology and tiles are the stacked one's."""
    a, b = st._csr, rk._csr
    ok = all(np.array_equal(getattr(a, f), getattr(b, f)) for f in ("indptr", "indices", "data"))
    ok &= st._pending == rk._pending and st.topology_log == rk.topology_log
    ok &= np.array_equal(st.part.order, rk.part.order) and np.array_equal(st.part.bounds,
                                                                         rk.part.bounds)
    ok &= st.batch_size == rk.batch_size and st.exchange_method == rk.exchange_method
    if st._rejoin is not None:
        ok &= torch.equal(st._rejoin[rank:rank + 1], rk._rejoin)
    return bool(ok)


def _state_equal(a, b) -> bool:
    """Two states of one engine form, leaf by leaf."""
    ok = True
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, torch.Tensor):
            ok &= torch.equal(x, y)
        elif isinstance(x, dict):
            ok &= all(torch.equal(x[k], y[k]) for k in x)
    return bool(ok)


def _dynamic(rank, world, root):
    """Forced steps, a refresh, an admission, a weight-only swap, a forced
    repartition and checkpoints, per rank against stacked."""
    from repro_torch.checkpoint import restore, save_engine_checkpoint
    from repro_torch.core.graph import CSRGraph
    from repro_torch.sim import (ArrivalConfig, CDUpdate, ChurnConfig, EngineConfig,
                                 ExchangeSpec, GraphUpdate, Scenario, ShardedAsyncEngine,
                                 make_engine)
    from repro_torch.sim.capture import prefix_shards

    obj = prob()
    rng = np.random.default_rng(MASKS["seed"])
    report = {}
    legs = {"degree": {}, "rcm_p2p_bf16_ef": dict(relabel="rcm", exchange=ExchangeSpec(
        method="p2p", dtype="bf16", error_feedback=True))}
    for name, kw in legs.items():
        cfg = EngineConfig(slot_wakes=8.0, seed=5, dtype=torch.float64, device="cpu",
                           graph_update=GraphUpdate(**GU), drift_threshold=0.25,
                           scenario=Scenario(arrival=ArrivalConfig(**ARRIVAL),
                                             churn=ChurnConfig(leave_prob=0.05)), **kw)
        st = ShardedAsyncEngine(CDUpdate(obj), num_shards=world, config=cfg)
        rk = make_engine(CDUpdate(obj), cfg, shards=world)
        a, b = st.init_state(np.zeros((N, P))), rk.init_state(np.zeros((N, P)))
        checks = {}

        def forced(a, b, k=3):
            for _ in range(k):
                mask = rng.random(N) < MASKS["rate"]
                a, b = st.step(a, mask), rk.step(b, mask)
            return a, b

        def check(label, a, b):
            checks[label] = _equal_shard(st, a, rk, b, rank) and _same_topology(st, rk, rank)

        a, b = forced(a, b)
        check("forced", a, b)
        a, b = st._refresh_topology(a, 1), rk._refresh_topology(b, 1)
        check("refresh", a, b)
        a, b = forced(a, b)
        a, b = st.admit(a, ARRIVING), rk.admit(b, ARRIVING)
        check("admit", a, b)
        a, b = forced(a, b)
        check("after_admit", a, b)
        csr = st._csr
        scaled = CSRGraph(indptr=csr.indptr, indices=csr.indices, data=csr.data * 1.5)
        a, b = st.set_topology(a, scaled), rk.set_topology(b, scaled)
        check("weight_only", a, b)
        for eng in (st, rk):
            eng.config = eng.config.replace(drift_threshold=-10.0)
        before = rk.topology_log["repartitions"]
        a, b = st._refresh_topology(a, 2), rk._refresh_topology(b, 2)
        check("repartition", a, b)
        checks["forced_repartition"] = rk.topology_log["repartitions"] == before + 1
        a, b = forced(a, b)
        check("after_repartition", a, b)
        log = dict(rk.topology_log)

        # A per-rank entry resumed on the ranks and in the stacked engine, a
        # stacked entry (one a process) restored into the ranks.
        cfg2 = cfg.replace(drift_threshold=-10.0)
        entry = save_engine_checkpoint(rk, b, str(Path(root) / f"rank_{name}"))
        stacked_entry = save_engine_checkpoint(st, a, str(Path(root) / f"stacked_{name}_{rank}"))
        rk2, st2, rk3 = (make_engine(CDUpdate(obj), cfg2, shards=world),
                         ShardedAsyncEngine(CDUpdate(obj), num_shards=world, config=cfg2),
                         make_engine(CDUpdate(obj), cfg2, shards=world))
        b2, step2 = restore(rk2, entry)
        a2, step_s = restore(st2, entry)
        b3, step3 = restore(rk3, stacked_entry)
        for _ in range(3):
            mask = rng.random(N) < MASKS["rate"]
            a, b = st.step(a, mask), rk.step(b, mask)
            a2, b2, b3 = st2.step(a2, mask), rk2.step(b2, mask), rk3.step(b3, mask)
        checks["resume"] = _state_equal(b, b2) and _same_topology(st, rk2, rank)
        checks["rank_entry_in_stacked"] = _state_equal(a, a2) and _same_topology(st2, rk, rank)
        checks["stacked_entry_in_ranks"] = _state_equal(b, b3) and _same_topology(st, rk3, rank)
        checks["steps"] = step2 == step_s == step3 == int(b.ptr[0]) - 3
        report[name] = dict(checks=checks, log=log, method=rk.exchange_method)
    return report


def _serve_and_phases(rank, world, root):
    """Serving on the ranks against the stacked handle (the global model
    assembly trapped on the serve path), the phase prefixes against the
    stacked engine's, ``profile_supertick`` on every rank, and a sampled
    dynamic ``run`` with publications and checkpoints."""
    from repro_torch.obs import profile_supertick
    from repro_torch.serve import ServeHandle, ServeSpec
    from repro_torch.sim import (ArrivalConfig, CDUpdate, ChurnConfig, EngineConfig,
                                 ExchangeSpec, GraphUpdate, Scenario, ShardedAsyncEngine,
                                 make_engine)
    from repro_torch.sim.capture import prefix_shards

    obj = prob()
    rng = np.random.default_rng(3)
    out = {}

    # -- serving: two publications, one pinned between them
    cfg = EngineConfig(slot_wakes=8.0, seed=5, dtype=torch.float64, device="cpu",
                       relabel="rcm", scenario=Scenario(arrival=ArrivalConfig(**ARRIVAL)))
    st = ShardedAsyncEngine(CDUpdate(obj), num_shards=world, config=cfg)
    rk = make_engine(CDUpdate(obj), cfg, shards=world)
    hs, hr = (ServeHandle.for_engine(e, ServeSpec(buffers=2)) for e in (st, rk))
    T0 = rng.normal(size=(N, P))
    a, b = st.init_state(T0), rk.init_state(T0)
    trapped = []

    def trap(label):
        def raise_(*args, **kw):
            trapped.append(label)
            raise AssertionError(f"the serve path called {label}")
        return raise_

    def serving(fn):
        """``fn()`` with the global model assembly trapped on the rank engine."""
        saved = {k: getattr(rk, k) for k in ("global_theta", "_agent_theta", "shards_of")}
        for k in saved:
            setattr(rk, k, trap(k))
        for k in ("pad_rows", "unpad_rows"):
            object.__setattr__(rk.part, k, trap(k))
        try:
            return fn()
        finally:
            for k, v in saved.items():
                setattr(rk, k, v)
            for k in ("pad_rows", "unpad_rows"):
                object.__delattr__(rk.part, k)

    def steps(a, b, k):
        for _ in range(k):
            mask = rng.random(N) < 0.4
            a, b = st.step(a, mask), rk.step(b, mask)
        return a, b

    cold = N + 3
    neighbors = {cold: (1, 2, 7, 9), ARRIVING[0]: (3, 5)}
    ids = np.array([0, 7, 13, 21, 33, ARRIVING[0], cold, 2, 40, 7])
    X = np.eye(P)[np.arange(ids.size) % P]
    answers = {}
    for k, (nsteps, pin) in enumerate(((0, False), (2, True), (2, False))):
        a, b = steps(a, b, nsteps)
        version = int(a.ptr[0])
        hs.publish(a, version=version)
        serving(lambda: hr.publish(b, version=version))
        if pin:
            pinned = (hs.snapshot(), serving(hr.snapshot))
    for label, at in (("pinned", pinned), ("latest", (None, None))):
        ps = hs.predict(ids, X, neighbors=neighbors, at=at[0])
        pr = serving(lambda: hr.predict(ids, X, neighbors=neighbors, at=at[1]))
        rs = hs.rows(ids, neighbors=neighbors, at=at[0])
        rr = serving(lambda: hr.rows(ids, neighbors=neighbors, at=at[1]))
        answers[label] = dict(
            predict=bool(np.array_equal(ps.values, pr.values)),
            rows=bool(np.array_equal(rs.values, rr.values)),
            version=[ps.version, pr.version, rr.version], cold=pr.cold.tolist(),
            nonzero=bool(np.abs(pr.values).sum() > 0))
    out["serve"] = dict(answers=answers, trapped=trapped, counters=hr.counters())

    # -- reads that cannot be served raise on every rank, and none waits:
    # a rank with nothing published, a version one rank's ring of 2 no
    # longer holds, pinned versions that differ; then a read in step
    fails = {}
    for case, versions in (("unpublished", (1,) if rank == 0 else ()),
                           ("ring", (1, 2, 3) if rank == 0 else (1,)),
                           ("pinned", (1, 2))):
        h = ServeHandle.for_engine(rk, ServeSpec(buffers=2))
        for v in versions:
            h.publish(b, version=v)
        pin = h._store.at_version(2 if rank == 0 else 1) if case == "pinned" else None
        try:
            h.predict(ids, X, neighbors=neighbors, at=pin)
            fails[case] = None
        except RuntimeError as e:
            fails[case] = str(e)
    h.publish(b, version=3)
    fails["after"] = h.predict(ids, X, neighbors=neighbors).version
    out["serve"]["fails"] = fails

    # -- phase prefixes: every agent wakes (p = 1), so each prefix's output
    # depends on no generator
    phases = {}
    for name, kw in {"unfused_all_gather": dict(exchange=ExchangeSpec(method="all_gather")),
                     "fused_p2p": dict(fused=True, dtype=torch.float32, relabel="rcm",
                                       exchange=ExchangeSpec(method="p2p"))}.items():
        kw.setdefault("dtype", torch.float64)
        cfg = EngineConfig(slot_wakes=64.0 * N, seed=5, device="cpu", **kw)
        st = ShardedAsyncEngine(CDUpdate(obj), num_shards=world, config=cfg)
        rk = make_engine(CDUpdate(obj), cfg, shards=world)
        T0 = np.random.default_rng(4).normal(size=(N, P))
        a, b = st.init_state(T0), rk.init_state(T0)
        equal = {}
        for upto in list(rk.phase_names) + [None]:
            want = prefix_shards(st, upto, st.phase_program(upto)(a))
            got = prefix_shards(rk, upto, rk.phase_program(upto)(b))
            equal[str(upto)] = len(want) == len(got) and all(
                torch.equal(w[rank:rank + 1] if per else w, g)
                for (w, per), (g, _) in zip(want, got))
        prof = profile_supertick(rk, b, inner=1, repeats=1)
        phases[name] = dict(equal=equal, names=list(rk.phase_names), profiled=list(prof.phases),
                            fused=bool(rk.fused), untouched=_state_equal(b, rk.init_state(T0)))
    out["phases"] = phases

    # -- a sampled dynamic run with every event
    cfg = EngineConfig(slot_wakes=8.0, seed=5, dtype=torch.float64, device="cpu",
                       graph_update=GraphUpdate(**GU), drift_threshold=0.25,
                       scenario=Scenario(arrival=ArrivalConfig(**ARRIVAL),
                                         churn=ChurnConfig(leave_prob=0.05)))
    rk = make_engine(CDUpdate(obj), cfg, shards=world)
    h = ServeHandle.for_engine(rk)
    res = rk.run(np.zeros((N, P)), 12, record_every=4, snapshot_every=4, serve=h,
                 checkpoint_every=4, checkpoint_dir=str(Path(root) / "run"))
    warm = np.array([0, 5, 17, 46])
    got = h.rows(warm)
    out["run"] = dict(log=dict(rk.topology_log), digest=rk._csr.digest(),
                      objective=[float(q) for q in res.objective],
                      finite=bool(np.isfinite(res.Theta).all()), version=got.version,
                      rows=bool(np.array_equal(got.values, res.Theta[warm].astype(np.float32))))
    return out


def _against_reference(rank, world):
    """The reference script's forced steps, refresh and admission on the
    ranks (no churn)."""
    from repro_torch.sim import (ArrivalConfig, CDUpdate, EngineConfig, GraphUpdate, Scenario,
                                 make_engine)

    cfg = EngineConfig(slot_wakes=8.0, seed=5, dtype=torch.float64, device="cpu",
                       graph_update=GraphUpdate(**GU), drift_threshold=0.25,
                       scenario=Scenario(arrival=ArrivalConfig(**ARRIVAL)))
    eng = make_engine(CDUpdate(prob()), cfg, shards=world)
    st = eng.init_state(np.zeros((N, P)))
    rng = np.random.default_rng(MASKS["seed"])
    out = {}
    for label in ("refresh", "admit", "end"):
        for _ in range(3):
            st = eng.step(st, rng.random(N) < MASKS["rate"])
        if label == "refresh":
            st = eng._refresh_topology(st, 1)
            csr = eng._csr
            out["csr"] = [csr.indptr.tolist(), csr.indices.tolist(), csr.data.tolist()]
        elif label == "admit":
            st = eng.admit(st, ARRIVING)
        out[label] = eng.global_theta(st).tolist()
    return out


REF_SCRIPT = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import json
    import numpy as np, jax.numpy as jnp
    from repro.core import AgentData, knn_graph, make_objective
    from repro.sim import (ArrivalConfig, CDUpdate, EngineConfig, GraphUpdate, Scenario,
                           ShardedAsyncEngine)
    assert len(jax.devices()) == 4
    rng = np.random.default_rng(0)
    graph = knn_graph(rng.normal(size=({N}, 6)), k=6)
    targets = rng.normal(size=({N}, {P})) / np.sqrt({P})
    X = rng.normal(size=({N}, 3, {P})) / np.sqrt({P})
    y = np.einsum("nmp,np->nm", X, targets)
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones(({N}, 3))), "quadratic",
                         mu=0.5, mix_mode="sparse")
    cfg = EngineConfig(slot_wakes=8.0, seed=5, dtype=jnp.float64,
                       graph_update=GraphUpdate(**{GU!r}), drift_threshold=0.25,
                       scenario=Scenario(arrival=ArrivalConfig(**{ARRIVAL!r})))
    eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, config=cfg)
    st = eng.init_state(np.zeros(({N}, {P})))
    rng = np.random.default_rng({MASKS["seed"]})
    out = {{}}
    for label in ("refresh", "admit", "end"):
        for _ in range(3):
            st = eng.step(st, rng.random({N}) < {MASKS["rate"]})
        if label == "refresh":
            st = eng._refresh_topology(st, 1)
            csr = eng._csr
            out["csr"] = [csr.indptr.tolist(), csr.indices.tolist(), csr.data.tolist()]
        elif label == "admit":
            st = eng.admit(st, {ARRIVING!r})
        out[label] = eng.global_theta(st).tolist()
    print("REF " + json.dumps(out))
""")


def _both(rank, world, root):
    out = {"dynamic": _dynamic(rank, world, root),
           "serve_phases": _serve_and_phases(rank, world, root)}
    if world == 4:
        out["reference"] = _against_reference(rank, world)
    return out


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """(world, every rank's report, the reference's rows or None)."""
    world = request.param
    tmp = tmp_path_factory.mktemp(f"dyn{world}")
    ref = None
    if world == 4:
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
        env.pop("JAX_ENABLE_X64", None)
        ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT], env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    reports = spawn(_both, world, tmp, str(tmp))
    want = None
    if ref is not None:
        out, err = ref.communicate(timeout=600)
        assert ref.returncode == 0, err[-3000:]
        want = json.loads(next(ln for ln in out.splitlines() if ln.startswith("REF "))[4:])
    return world, reports, want


def test_dynamic_topology_on_the_ranks_equals_the_stacked_engine(ranks):
    world, reports, _ = ranks
    for r in reports:
        for name, leg in r["dynamic"].items():
            failed = [k for k, ok in leg["checks"].items() if not ok]
            assert not failed, (world, name, failed)
            log = leg["log"]
            assert log["edge_refreshes"] == 2 and log["arrivals"] == 2, log
            assert log["weight_patches"] == 1 and log["repartitions"] >= 1, log
    assert reports[0]["dynamic"]["rcm_p2p_bf16_ef"]["method"] == "p2p"


def test_serving_on_the_ranks_equals_the_stacked_handle(ranks):
    world, reports, _ = ranks
    for r in reports:
        s = r["serve_phases"]["serve"]
        assert not s["trapped"], s["trapped"]
        for label, ans in s["answers"].items():
            assert ans["predict"] and ans["rows"] and ans["nonzero"], (world, label, ans)
            assert len(set(ans["version"])) == 1, ans
            assert ans["cold"] == [False] * 5 + [True, True] + [False] * 3
        assert s["answers"]["pinned"]["version"][0] == 2
        assert s["answers"]["latest"]["version"][0] == 4
        assert s["counters"]["serve_requests"] == 4


def test_a_read_that_cannot_be_served_raises_on_every_rank(ranks):
    world, reports, _ = ranks
    for r in reports:
        fails = r["serve_phases"]["serve"]["fails"]
        assert "no snapshot published" in fails["unpublished"], fails
        assert "no longer in the ring" in fails["ring"], fails
        assert "pinned snapshots differ" in fails["pinned"], fails
        assert fails["after"] == 3, fails


def test_phase_programs_on_the_ranks_equal_the_stacked_engine(ranks):
    world, reports, _ = ranks
    for r in reports:
        for name, leg in r["serve_phases"]["phases"].items():
            failed = [k for k, ok in leg["equal"].items() if not ok]
            assert not failed, (world, name, failed)
            assert leg["profiled"] == leg["names"] and leg["untouched"]
            assert ("fused_row_update" in leg["names"]) == leg["fused"]


def test_a_sampled_dynamic_run_agrees_across_the_ranks(ranks):
    world, reports, _ = ranks
    runs = [r["serve_phases"]["run"] for r in reports]
    assert all(run == runs[0] for run in runs)
    run = runs[0]
    assert run["log"]["edge_refreshes"] == 2 and run["log"]["arrivals"] == 2, run["log"]
    assert run["finite"] and run["rows"] and run["version"] == 12
    assert len(run["objective"]) == 4


def test_ranks_match_the_reference_sharded_engine_on_4_devices(ranks):
    world, reports, want = ranks
    if world != 4:
        return
    for r in reports:
        got = r["reference"]
        for got_a, want_a in zip(got["csr"][:2], want["csr"][:2]):
            assert np.array_equal(got_a, want_a)
        assert np.abs(np.asarray(got["csr"][2]) - np.asarray(want["csr"][2])).max() <= 1e-12
        for label in ("refresh", "admit", "end"):
            assert np.abs(np.asarray(got[label]) - np.asarray(want[label])).max() <= 1e-10

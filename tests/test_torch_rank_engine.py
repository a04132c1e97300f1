"""The sharded engine one shard a process (``ShardedAsyncEngine`` over a
``torch.distributed`` group) against the stacked engine.

The port's counterpart of the reference's ``MULTIDEV_SCRIPT``
(``tests/test_sharded_engine.py:176-285``, one shard a device on 8 XLA
host devices): here 2 and 4 gloo processes, started by ``mp.spawn`` with
a file store under the test's ``tmp_path``, each build the per-rank engine
(``make_engine(shards=S)`` over the default group) and, in the same
process, the stacked engine on the same problem. Under forced wake sets
every rank's owned rows, counters and error-feedback rows must equal the
stacked engine's shard ``rank`` bit for bit (``torch.equal``), across
both partition modes, relabel on and off, ``all_gather`` and ``p2p``,
the bf16 wire with error feedback, the fused slot (its plain version
here) and the private Eq. 6 slot; the gathered model matrix and the
metric counters read across the ranks equal the stacked engine's. The
private slot draws its noise from the engine's generator, which a rank
seeds from (seed, rank): the parity runs inject the same draws a row on
both sides (``_RowDraws``), and the reference's budget accounting holds
with the generator's own draws. ``GroupCollective`` over gloo equals
``StackedCollective``'s pool and roll. Float64, n = 64.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N, P = 64, 4


def spawn(fn, world, tmp_path, *args):
    """Run ``fn(rank, *args)`` in ``world`` gloo processes (file store
    under ``tmp_path``); returns every rank's JSON report."""
    out = tmp_path / fn.__name__
    out.mkdir(parents=True, exist_ok=True)
    mp.spawn(_worker, args=(world, str(out / "pg"), str(out), fn, args), nprocs=world,
             join=True)
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def _worker(rank, world, path, out_dir, fn, args):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{path}", world_size=world, rank=rank)
    try:
        report = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))


def quad(n=N, p=P, m=3, seed=1, clip=None):
    """The reference tests' quadratic problem, built by the port (``clip``
    bounds its gradient, for the private update)."""
    from repro_torch.core import AgentData, knn_graph, make_objective

    rng = np.random.default_rng(seed)
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    data = AgentData(X=X, y=y, mask=np.ones((n, m)))
    return make_objective(graph, data, "quadratic", mu=0.5, mix_mode="sparse", clip=clip)


def _masks(n=N, k=12, p=0.3, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.random(n) < p for _ in range(k)]


def _row_draws_update(obj):
    """A private update whose noise draws are a fixed table row per agent
    (both engines see the same noise); the budget stops as always."""
    import dataclasses

    from repro_torch.core import DPConfig
    from repro_torch.sim import DPCDUpdate

    table = torch.as_tensor(np.random.default_rng(9).laplace(size=(obj.n + 1, obj.p)))

    @dataclasses.dataclass(frozen=True)
    class RowDraws(DPCDUpdate):
        def apply_rows(self, theta_rows, rows, valid, neigh, generator, state, draws=None,
                       **kw):
            return super().apply_rows(theta_rows, rows, valid, neigh, generator, state,
                                      table[rows.cpu()], **kw)

        def apply_fused(self, Theta_slab, rows, valid, generator, state, cols, w, draws=None,
                        **kw):
            return super().apply_fused(Theta_slab, rows, valid, generator, state, cols, w,
                                       table[rows.cpu()], **kw)

    base = DPCDUpdate.plan(obj, DPConfig(eps_bar=0.8), planned_Ti=3)
    return RowDraws(**{f.name: getattr(base, f.name) for f in dataclasses.fields(base)})


def _legs():
    from repro_torch.sim import ExchangeSpec

    f64 = dict(dtype=torch.float64)
    return {
        "contiguous": dict(partition_mode="contiguous", **f64),
        "degree": dict(partition_mode="degree", **f64),
        "degree_p2p": dict(partition_mode="degree", exchange=ExchangeSpec(method="p2p"), **f64),
        "rcm_all_gather": dict(relabel="rcm", exchange=ExchangeSpec(method="all_gather"), **f64),
        "rcm_p2p": dict(relabel="rcm", exchange=ExchangeSpec(method="p2p"), **f64),
        "bf16_ef": dict(relabel="rcm", exchange=ExchangeSpec(method="p2p", dtype="bf16",
                                                             error_feedback=True), **f64),
        "int8_all_gather": dict(exchange=ExchangeSpec(method="all_gather", dtype="int8",
                                                      error_feedback=True), **f64),
        "fused": dict(fused=True, dtype=torch.float32, metrics=True),
        "fused_p2p": dict(fused=True, dtype=torch.float32, relabel="rcm",
                          exchange=ExchangeSpec(method="p2p")),
        "private": dict(private=True, relabel="rcm", exchange=ExchangeSpec(method="p2p"), **f64),
        "private_fused": dict(private=True, fused=True, dtype=torch.float32),
    }


def _equal_shard(st, a, rk, b, rank) -> bool:
    """Rank ``rank``'s per-rank state ``b`` equals the stacked state
    ``a``'s shard ``rank``, leaf by leaf."""
    ok = torch.equal(a.Theta[rank:rank + 1], b.Theta) and torch.equal(a.active[rank:rank + 1],
                                                                       b.active)
    for name in ("applied", "dropped", "messages", "ptr"):
        ok &= torch.equal(getattr(a, name)[rank:rank + 1], getattr(b, name))
    if a.ef is not None:
        ok &= torch.equal(a.ef[rank:rank + 1], b.ef)
    if isinstance(a.ustate, torch.Tensor):
        ok &= torch.equal(a.ustate[rank:rank + 1], b.ustate)
    ok &= bool(np.array_equal(st.global_theta(a), rk.global_theta(b)))
    return bool(ok)


def _parity(rank, world):
    from repro_torch.sim import CDUpdate, ShardedAsyncEngine, make_engine

    obj = quad()
    masks = _masks()
    report = {}
    for name, kw in _legs().items():
        kw = dict(kw)
        update = (_row_draws_update(quad(clip=1.0)) if kw.pop("private", False)
                  else CDUpdate(obj))
        cfg = dict(slot_wakes=8.0, seed=0, device="cpu", **kw)
        st = ShardedAsyncEngine(update, num_shards=world, **cfg)
        rk = make_engine(update, shards=world, **cfg)
        assert rk.rank == rank and rk.local_shards == 1 and rk.capture_mode.startswith("eager")
        a, b = st.init_state(np.zeros((N, P))), rk.init_state(np.zeros((N, P)))
        for mask in masks:
            a, b = st.step(a, mask), rk.step(b, mask)
        leg = dict(equal=_equal_shard(st, a, rk, b, rank), method=rk.exchange_method,
                   fused=bool(rk.fused))
        if rk._macc is not None:
            want, _ = st.metrics_snapshot(a)
            got, _ = rk.metrics_snapshot(b)
            leg["metrics"] = want.keys() == got.keys() and all(
                np.array_equal(want[k], got[k]) for k in want)
        report[name] = leg
    return report


@pytest.mark.parametrize("world", [2, 4])
def test_rank_engine_equals_the_stacked_engine_under_forced_wakes(tmp_path, world):
    reports = spawn(_parity, world, tmp_path)
    for r in reports:
        for name, leg in r.items():
            assert leg["equal"], (name, leg)
            assert leg.get("metrics", True), (name, leg)
        assert r["fused"]["fused"] and r["private_fused"]["fused"] and not r["degree"]["fused"]
        assert r["degree_p2p"]["method"] == "p2p" and r["rcm_all_gather"]["method"] == "all_gather"


def _sampled(rank, world):
    """Sampled runs (each rank's own generator) through ``run``: the
    counters and totals read across the ranks are the same on every rank;
    the reference's DP budget accounting with the generator's draws."""
    from repro_torch.core import AgentData, DPConfig, erdos_renyi_graph, make_objective
    from repro_torch.core import run_private
    from repro_torch.sim import CDUpdate, DPCDUpdate, ExchangeSpec, make_engine

    obj = quad()
    eng = make_engine(CDUpdate(obj), shards=world, slot_wakes=8.0, seed=3, device="cpu",
                      dtype=torch.float64, metrics=True)
    res = eng.run(np.zeros((N, P)), slots=6, record_every=3)
    counters, _ = eng.metrics_snapshot(res.state)
    out = dict(objective=[float(q) for q in res.objective], applied=res.wakes_applied,
               messages=res.messages, theta=float(np.abs(res.Theta).sum()),
               counter_shards=int(next(iter(counters.values())).shape[0]),
               wakes=int(counters["wakes_applied"].sum()) if "wakes_applied" in counters
               else res.wakes_applied)
    # The reference's DP_PARITY: forced all-wake slots spend exactly the
    # planned budget, as run_private does, and spent agents freeze.
    rngd = np.random.default_rng(0)
    gd = erdos_renyi_graph(12, 0.5, rngd)
    td = rngd.normal(size=(12, 3))
    Xd = rngd.normal(size=(12, 4, 3))
    yd = np.sign(np.einsum("nmp,np->nm", Xd, td))
    objd = make_objective(gd, AgentData(X=Xd, y=yd, mask=np.ones((12, 4))), "logistic", mu=0.3)
    cfg = DPConfig(eps_bar=0.8)
    wake = np.concatenate([np.tile(np.arange(12), 3), np.arange(11)])
    seq = run_private(objd, np.zeros((12, 3)), T=len(wake), cfg=cfg,
                      rng=np.random.default_rng(0), wake_sequence=wake, record_objective=False,
                      device="cpu")
    upd = DPCDUpdate.plan(objd, cfg, planned_Ti=3)
    engd = make_engine(upd, shards=world, slot_wakes=12.0, seed=0, relabel="rcm",
                       exchange=ExchangeSpec(method="p2p"), device="cpu")
    st = engd.init_state(np.zeros((12, 3)))
    for _ in range(5):
        st = engd.step(st, np.ones(12, bool))
    counts = engd.part.unpad_rows(engd.shards_of(st.ustate).numpy())
    frozen = engd.global_theta(st)
    msgs = float(engd.shards_of(st.messages).sum())
    st = engd.step(st, np.ones(12, bool))
    out.update(
        counts=counts.tolist(),
        eps=float(np.abs(upd.eps_spent(counts) - seq.eps_spent).max()),
        frozen=bool(np.array_equal(engd.global_theta(st), frozen))
        and float(engd.shards_of(st.messages).sum()) == msgs)
    return out


def test_sampled_runs_read_the_same_totals_on_every_rank_and_dp_accounting(tmp_path):
    reports = spawn(_sampled, 2, tmp_path)
    assert reports[0] == reports[1]
    r = reports[0]
    assert r["counter_shards"] == 2 and r["wakes"] == r["applied"] > 0
    assert len(r["objective"]) == 3 and r["objective"][-1] < r["objective"][0]
    assert r["counts"] == [3] * 12 and r["eps"] <= 1e-10 and r["frozen"]


def _collective(rank, world):
    from repro_torch.core.mixing import GroupCollective, StackedCollective

    import torch.distributed as dist

    coll, stacked = GroupCollective(dist.group.WORLD), StackedCollective()
    every = torch.arange(world * 6, dtype=torch.float64).view(world, 2, 3) + 0.5
    mine = every[rank:rank + 1]
    ok = coll.staged and torch.equal(coll.all_gather(mine).view(world, 2, 3),
                                     stacked.all_gather(every))
    for off in range(-world, 2 * world):
        ok &= torch.equal(coll.ppermute(mine, off), stacked.ppermute(every, off)[rank:rank + 1])
    for dt in (torch.bfloat16, torch.int8):
        ok &= torch.equal(coll.all_gather(mine.to(dt)).view(world, 2, 3),
                          every.to(dt))
    return dict(ok=bool(ok))


def test_group_collective_over_gloo_is_the_stacked_pool_and_roll(tmp_path):
    assert all(r["ok"] for r in spawn(_collective, 4, tmp_path))


def _refusals(rank, world):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sim import (CDUpdate, DelayConfig, EngineConfig, GraphUpdate, Scenario,
                                 make_engine)

    obj = quad(24)
    out = {}
    for name, call in {
        "size": lambda: make_engine(CDUpdate(obj), shards=world + 1, device="cpu"),
        "delay": lambda: make_engine(CDUpdate(obj), shards=world, device="cpu",
                                     scenario=Scenario(delay=DelayConfig(max_delay=2))),
        "fused_dynamic": lambda: make_engine(CDUpdate(obj), shards=world, device="cpu",
                                             dtype=torch.float32, fused=True,
                                             graph_update=GraphUpdate(every=2)),
        "mesh_name": lambda: EngineConfig(device="cpu", devices=init_device_mesh(
            "cpu", (world,), mesh_dim_names=("agents",))),
    }.items():
        try:
            call()
            out[name] = "no error"
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shards",))
    eng = make_engine(CDUpdate(obj), EngineConfig(device="cpu", devices=mesh), shards=world)
    out["mesh_rank"] = eng.rank
    dyn = make_engine(CDUpdate(obj), shards=world, device="cpu", graph_update=GraphUpdate(every=2))
    out["dynamic_rank"] = dyn.rank
    return out


def test_rank_engine_refusals(tmp_path):
    """What still refuses one shard a rank: a group of another size,
    per-edge delays, ``fused=True`` on a dynamic run (each as the stacked
    engine refuses it) and a mesh not named "shards", each naming why; a
    "shards" mesh hands each rank its shard, and a dynamic engine builds
    on the ranks."""
    for rank, r in enumerate(spawn(_refusals, 2, tmp_path)):
        assert r["size"].startswith("ValueError") and "that many ranks" in r["size"]
        assert r["delay"].startswith("NotImplementedError") and "delays" in r["delay"]
        assert r["fused_dynamic"].startswith("ValueError") and "static-topology" in \
            r["fused_dynamic"]
        assert r["mesh_name"].startswith("ValueError") and "'shards'" in r["mesh_name"]
        assert r["mesh_rank"] == rank and r["dynamic_rank"] == rank

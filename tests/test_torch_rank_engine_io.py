"""The sharded engine one shard a process: fixed points, per-rank
checkpoints, the example under torchrun, and the reference's engine.

* The reference's ``FIXED_POINT_SCRIPT`` (``tests/test_sharded_engine.py:
  288-329``) at 2 and 4 gloo ranks: 700 sampled slots of the n = 512
  quadratic problem reach ``solve_exact`` within 1e-5, and 5 more slots
  from the optimum move it less than 1e-9.
* Per-rank checkpoints (``checkpoint/engine_io.py``): each rank writes its
  ``shard_<rank>.npz``, rank 0 the rest; a same-S restore resumes bit for
  bit (``torch.equal``, the error feedback and the counters included); a
  stacked S = 4 entry restores into 2 ranks (the reference's elastic
  rules: the rows re-tiled, the totals collapsed into shard 0); a 2-rank
  entry restores into the stacked engine at S = 2.
* ``examples/sharded_async_simulation.py`` under ``torchrun`` with 4
  gloo processes: one shard a rank, its parity line against the stacked
  engine (0 difference) printed by rank 0.
* The reference's ``ShardedAsyncEngine`` on 4 XLA host devices (its own
  subprocess) against the port's on 4 gloo ranks, the same forced wake
  sets: within 1e-10 in float64, counters equal.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

from test_torch_rank_engine import N, P, _masks, quad, spawn

SRC = Path(__file__).resolve().parents[1] / "src"


def _fixed_point(rank, world):
    from repro_torch.sim import CDUpdate, ExchangeSpec, make_engine

    obj = quad(512, seed=0)
    star = obj.solve_exact()
    kw = {} if world == 2 else dict(relabel="rcm", exchange=ExchangeSpec(method="p2p"))
    eng = make_engine(CDUpdate(obj), shards=world, slot_wakes=128.0, seed=3,
                      dtype=torch.float64, device="cpu", **kw)
    res = eng.run(np.zeros((512, 4)), slots=700)
    st = eng.advance(eng.init_state(star), 5)
    return dict(err=float(np.abs(res.Theta - star).max()),
                drift=float(np.abs(eng.global_theta(st) - star).max()),
                method=eng.exchange_method)


def test_fixed_point_512_agents_at_2_and_4_ranks(tmp_path):
    for world in (2, 4):
        for r in spawn(_fixed_point, world, tmp_path / str(world)):
            assert r["err"] < 1e-5 and r["drift"] < 1e-9, (world, r)


def _checkpoints(rank, world, root):
    from repro_torch.checkpoint import restore, save_engine_checkpoint
    from repro_torch.sim import CDUpdate, ExchangeSpec, ShardedAsyncEngine, make_engine

    import torch.distributed as dist

    obj = quad()
    kw = dict(slot_wakes=8.0, seed=0, dtype=torch.float64, device="cpu", metrics=True,
              exchange=ExchangeSpec(method="p2p", dtype="bf16", error_feedback=True))
    out = {}
    # Same S: save after 7 sampled slots, restore into a fresh rank engine,
    # both advance 5 slots.
    eng = make_engine(CDUpdate(obj), shards=world, **kw)
    st = eng.advance(eng.init_state(np.zeros((N, P))), 7)
    entry = save_engine_checkpoint(eng, st, os.path.join(root, "ranks"), keep_last=2)
    out["files"] = sorted(os.listdir(entry))
    fresh = make_engine(CDUpdate(obj), shards=world, **kw)
    back, step = restore(fresh, os.path.join(root, "ranks"))
    same = all(torch.equal(getattr(back, k), getattr(st, k)) for k in
               ("Theta", "active", "applied", "dropped", "messages", "ptr", "ef"))
    a, b = eng.advance(st, 5), fresh.advance(back, 5)
    out["same_s"] = bool(same and step == 7 and all(
        torch.equal(getattr(a, k), getattr(b, k)) for k in ("Theta", "applied", "ef", "ptr"))
        and all(torch.equal(a.metrics[k], b.metrics[k]) for k in a.metrics))
    # A stacked S = 4 entry into these ranks (elastic at 2 ranks).
    stk = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, **kw)
    if rank == 0:
        save_engine_checkpoint(stk, stk.advance(stk.init_state(np.zeros((N, P))), 6),
                               os.path.join(root, "stacked4"))
    dist.barrier()
    want, _ = restore(stk, os.path.join(root, "stacked4"))
    rk = make_engine(CDUpdate(obj), shards=world, **kw)
    got, _ = restore(rk, os.path.join(root, "stacked4"))
    out["stacked_to_ranks"] = bool(
        np.array_equal(rk.global_theta(got), stk.global_theta(want))
        and int(rk.shards_of(got.applied).sum()) == int(want.applied.sum())
        and int(got.applied[0]) == (int(want.applied.sum()) if rank == 0 else 0)
        and int(got.ptr[0]) == 6)
    # The rank entry into the stacked engine at the same S.
    stS = ShardedAsyncEngine(CDUpdate(obj), num_shards=world, **kw)
    s2, _ = restore(stS, entry)
    again, _ = restore(fresh, entry)
    out["ranks_to_stacked"] = bool(
        np.array_equal(stS.global_theta(s2), fresh.global_theta(again))
        and torch.equal(s2.applied, fresh.shards_of(again.applied))
        and torch.equal(s2.ef, fresh.shards_of(again.ef)))
    return out


def test_per_rank_checkpoints_resume_and_cross_forms(tmp_path):
    for r in spawn(_checkpoints, 2, tmp_path, str(tmp_path / "ck")):
        assert r["files"] == ["manifest.json", "partition.npz", "scalars.npz", "shard_0.npz",
                              "shard_1.npz"], r
        assert r["same_s"] and r["stacked_to_ranks"] and r["ranks_to_stacked"], r


def test_example_runs_one_shard_a_rank_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "4", "-m", "repro_torch.examples.sharded_async_simulation", "--smoke", "--device",
           "cpu"]
    res = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "device: cpu, shards: 4 (one a rank)" in lines
    parity = [ln for ln in lines if ln.startswith("[parity]")]
    assert parity == ["[parity]   forced wake sets against the stacked engine: max |diff| "
                      "0.0e+00 (tol 0e+00)"], lines


REF_SCRIPT = textwrap.dedent(f"""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np, jax.numpy as jnp
    from repro.core import AgentData, knn_graph, make_objective
    from repro.sim import CDUpdate, ExchangeSpec, ShardedAsyncEngine
    assert len(jax.devices()) == 4
    rng = np.random.default_rng(1)
    n, p, m = {N}, {P}, 3
    graph = knn_graph(rng.normal(size=(n, 8)), k=8)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    obj = make_objective(graph, AgentData(X=X, y=y, mask=np.ones((n, m))), "quadratic",
                         mu=0.5, mix_mode="sparse")
    rng = np.random.default_rng(5)
    masks = [rng.random(n) < 0.3 for _ in range(12)]
    out = {{}}
    for name, kw in (("degree", {{}}), ("rcm_p2p", dict(relabel="rcm",
                                                      exchange=ExchangeSpec(method="p2p")))):
        eng = ShardedAsyncEngine(CDUpdate(obj), num_shards=4, slot_wakes=8.0, seed=0,
                                 dtype=jnp.float64, **kw)
        st = eng.init_state(np.zeros((n, p)))
        for mask in masks:
            st = eng.step(st, mask)
        out[name] = dict(theta=eng.global_theta(st).tolist(),
                         applied=int(np.asarray(st.applied).sum()),
                         messages=float(np.asarray(st.messages).sum()))
    print("REF " + json.dumps(out))
""")


def _against_reference(rank, world):
    from repro_torch.sim import CDUpdate, ExchangeSpec, make_engine

    obj = quad()
    out = {}
    for name, kw in (("degree", {}), ("rcm_p2p", dict(relabel="rcm",
                                                       exchange=ExchangeSpec(method="p2p")))):
        eng = make_engine(CDUpdate(obj), shards=world, slot_wakes=8.0, seed=0,
                          dtype=torch.float64, device="cpu", **kw)
        st = eng.init_state(np.zeros((N, P)))
        for mask in _masks():
            st = eng.step(st, mask)
        out[name] = dict(theta=eng.global_theta(st).tolist(),
                         applied=int(eng.shards_of(st.applied).sum()),
                         messages=float(eng.shards_of(st.messages).sum()))
    return out


def test_rank_engine_matches_the_reference_sharded_engine_on_4_devices(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("JAX_ENABLE_X64", None)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    ours = spawn(_against_reference, 4, tmp_path)
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    want = json.loads(next(ln for ln in out.splitlines() if ln.startswith("REF "))[4:])
    for r in ours:
        for name, leg in want.items():
            got = r[name]
            assert np.abs(np.asarray(got["theta"]) - np.asarray(leg["theta"])).max() <= 1e-10
            assert got["applied"] == leg["applied"]
            assert abs(got["messages"] - leg["messages"]) <= 1e-9 * max(1.0, leg["messages"])

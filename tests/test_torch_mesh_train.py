"""The P2P-DP round on a DeviceMesh, one agent a rank: the counterpart of the
reference's ``MULTIDEV_SCRIPT`` (``tests/test_spmd.py:86-131``).

Eight gloo processes form a (4, 2) ("data", "model") mesh: four agents,
each tensor-parallel over two ranks. On the reduced llama config every
rank runs ``spmd.jit_train_step``'s round on its agent's DTensor tree, and
the result must equal the stacked ``make_train_step`` round on the same
inputs and Laplace draws (which ``tests/test_torch_train.py`` holds to the
reference), with the ring (``ppermute``) and the dense gossip. Tolerance:
2e-5 of max(1, |value|) per leaf, loss and gradient norm 1e-5 relative
(the sharded products and the clip norm's sums of squares add in another
order; with DP on the noise scale is about 8, so a 1e-7 change of the clip
scale moves a coordinate by up to 8e-6). The mesh gossip alone must give
the circulant mean of the distinct ring targets, the collision and
self-loop cases of ``tests/test_spmd.py:191`` included. Process groups
start from a file under the test's ``tmp_path`` (no fixed port).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = 2e-5
OFFSETS = ((1,), (2,), (1, 2), (4,), (1, 3), (2, 2), (1, 4), (3, 5))


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def _worker(rank, world, path, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{path}", world_size=world, rank=rank)
    try:
        _round_checks(rank, out_dir)
    finally:
        dist.destroy_process_group()


def _round_checks(rank, out_dir):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import P2PConfig
    from repro_torch.core import spmd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.sharding import batch_specs, param_specs
    from repro_torch.utils.tree import tree_flatten_with_path, tree_map

    mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
    cfg = get_reduced("llama3.2-1b", dtype="float32")
    bundle = build_model(cfg, remat=True, device="cpu")
    A = spmd.num_agents(mesh, "full")
    params = bundle.init_agents(A, 0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (A, 2, 17)),
                                       dtype=torch.int32)}
    draws = {name: torch.as_tensor(np.random.default_rng(7).laplace(size=tuple(x.shape)),
                                   dtype=torch.float32)
             for name, x in tree_flatten_with_path(params)}
    pspecs = param_specs(params, mesh, "full", A)
    bspecs = batch_specs(batch, mesh, "full")
    report, mixed = {}, {}
    for gossip in ("ppermute", "dense"):
        p2p = P2PConfig(agent_mode="full", dp_enabled=True, eps_bar=1.0, planned_rounds=10,
                        mu=0.2, neighbor_offsets=(1,), gossip_dtype=None)
        step, _, _ = spmd.make_train_step(bundle, p2p, mesh, 2, gossip=gossip)
        want, wm = step(tree_map(torch.clone, params), batch, draws=draws)
        mstep = spmd.jit_train_step(step, mesh, pspecs, bspecs)
        a = mstep.agent
        assert a == rank // 2 and mstep.agent_mesh.size() == 2
        mine = mstep.shard(tree_map(lambda x: x[a].clone(), params))
        got, gm = mstep(mine, {k: v[a] for k, v in batch.items()},
                        draws={k: v[a] for k, v in draws.items()})
        errs = [_rel(x.full_tensor(), y[a]) for (_, x), (_, y) in
                zip(tree_flatten_with_path(got), tree_flatten_with_path(want))]
        report[gossip] = dict(err=max(errs),
                              loss=abs(float(gm["loss"]) / float(wm["loss"]) - 1),
                              grad_norm=abs(float(gm["grad_norm"]) / float(wm["grad_norm"]) - 1))
        mixed[gossip] = {n: x.full_tensor() for n, x in tree_flatten_with_path(got)}
    report["ppermute_vs_dense"] = max(_rel(mixed["ppermute"][n], mixed["dense"][n])
                                      for n in mixed["dense"])
    # A round with its noise from a generator: the replicated leaves stay
    # the same on both ranks of an agent (their noise is the agent's).
    import torch.distributed as dist

    got, _ = mstep(got, {k: v[a] for k, v in batch.items()},
                   generator=torch.Generator().manual_seed(11))
    replicas = []
    for _, x in tree_flatten_with_path(got):
        if all(p.is_replicate() for p in x.placements):
            pair = [torch.empty_like(x.to_local()) for _ in range(2)]
            dist.all_gather(pair, x.to_local().contiguous(), group=mstep.agent_mesh.get_group())
            replicas.append(torch.equal(*pair))
    report["replicas_equal"] = bool(replicas) and all(replicas)
    # The mesh gossip alone against the circulant W of the distinct targets.
    x = torch.arange(6, dtype=torch.float32)[None, :] + 10.0 * mstep.agent
    gossip_err = 0.0
    for offsets in OFFSETS:
        p2p = P2PConfig(agent_mode="full", dp_enabled=False, neighbor_offsets=offsets,
                        gossip_dtype=None)
        step, _, _ = spmd.make_train_step(bundle, p2p, mesh, 2, gossip="ppermute")
        ms = spmd.jit_train_step(step, mesh, pspecs, bspecs)
        res = sorted({s * o % A for o in offsets for s in (1, -1)})
        want = sum(x - 10.0 * mstep.agent + 10.0 * ((ms.agent - r) % A) for r in res) / len(res)
        gossip_err = max(gossip_err, float((ms._mix(x) - want).abs().max()))
    report["gossip"] = gossip_err
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))


def test_mesh_round_equals_the_stacked_round_with_both_gossips(tmp_path):
    """(4, 2) gloo mesh, reduced llama, DP on: ppermute and dense rounds
    equal the stacked round and each other; the mesh gossip equals the
    circulant mean, collisions and self-loops included; with generator
    noise the replicated leaves stay replicas."""
    mp.spawn(_worker, args=(8, str(tmp_path / "pg"), str(tmp_path)), nprocs=8, join=True)
    reports = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(8)]
    for r in reports:
        for gossip in ("ppermute", "dense"):
            assert r[gossip]["err"] <= TOL, r
            assert r[gossip]["loss"] <= 1e-5 and r[gossip]["grad_norm"] <= 1e-5, r
        assert r["ppermute_vs_dense"] <= TOL, r
        assert r["replicas_equal"], r
        assert r["gossip"] <= 1e-5, r


def test_train_launcher_runs_a_model_axis_under_torchrun(tmp_path):
    """``launch.train --mesh 1x2 --device cpu`` under torchrun with 2
    processes trains 2 steps (one agent, tensor-parallel over 2 ranks)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "repro_torch.launch.train", "--mesh", "1x2", "--steps", "2", "--batch",
           "2", "--seq", "33", "--device", "cpu", "--log-every", "1"]
    res = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)

"""The dry-run of the port (``launch/dryrun.py``) against the reference's.

Reduced configs of each family (dense, MoE, hybrid, xLSTM, enc-dec) are
traced for train, prefill and decode on a fake (4, 2) mesh in a subprocess
(its fake process group and FakeTensors stay out of the test process);
``tests/test_torch_dryrun_pods.py`` does the (2, 2, 2) mesh. Each row has
the reference's keys (``trace_s`` for ``lower_s``/``compile_s``), its
argument bytes are the local shard bytes the reference's specs give, and
its ``model_flops_global`` is the reference's formula. The collective
formulas, the counter's local flops and the hill-climb's pairs are held to
the reference's as well.
"""

import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import repro.configs as jcfgs
from repro.models import build_model as jbuild
from repro.models import sharding as jsh

SRC = Path(__file__).resolve().parents[1] / "src"
FAMILIES = ("llama3.2-1b", "granite-moe-3b-a800m", "zamba2-1.2b", "xlstm-1.3b",
            "seamless-m4t-medium")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
BATCH, SEQ = 8, 16
# The reference's row keys (launch/dryrun.py::run_one), the port's trace_s
# in place of lower_s and compile_s.
REF_KEYS = {"arch", "shape", "variant", "mesh", "chips", "gossip", "p2p", "dp", "agent_mode",
            "n_agents", "memory", "compute_s", "memory_s", "collective_s", "dominant",
            "flops_per_device", "bytes_per_device", "collective_bytes_per_device",
            "model_flops_global", "useful_ratio", "collective_ops", "collective_breakdown"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
               "alias_size_in_bytes"}

ROWS_SCRIPT = textwrap.dedent(f"""
    import json, sys, torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_reduced
    from repro_torch.launch import dryrun
    mesh = [int(x) for x in sys.argv[1].split("x")]
    rows = []
    for arch in {FAMILIES!r}:
        for shape in {KINDS!r}:
            rows.append(dryrun.run_one(arch, shape, cfg=get_reduced(arch, dtype="bfloat16"),
                                       mesh_shape=mesh, global_batch={BATCH}, seq_len={SEQ},
                                       verbose=False))
    extra = {{}}
    if sys.argv[2:] == ["extra"]:
        # The issue's trouble spot: a product of two DTensors on a fake
        # 16x16 mesh is the local shard's flops, not the global product's.
        import torch.distributed as dist
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.roofline.counter import OpCounter
        dryrun.fake_world(256)
        m = make_mesh((16, 16), ("data", "model"), "cpu")
        with FakeTensorMode():
            a = DTensor.from_local(torch.empty(4096, 4096), m, [Replicate(), Replicate()],
                                   run_check=False)
            b = DTensor.from_local(torch.empty(4096, 256), m, [Replicate(), Shard(1)],
                                   run_check=False, shape=(4096, 4096), stride=(4096, 1))
            with OpCounter() as c:
                a @ b
        extra = {{"flops": c.flops, "collectives": len(c.collectives)}}
    print("ROWS " + json.dumps({{"rows": rows, "extra": extra}}))
""")


def dryrun_rows(mesh: str, extra=False):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    res = subprocess.run([sys.executable, "-c", ROWS_SCRIPT, mesh] + (["extra"] if extra else []),
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = next(ln for ln in res.stdout.splitlines() if ln.startswith("ROWS "))
    return json.loads(line[5:])


def _ref_local_bytes(tree, specs, sizes, drop_agent):
    """Local shard bytes of a reference tree under its specs."""
    total = 0
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    for leaf, spec in zip(leaves, spec_leaves):
        shape = list(leaf.shape)
        for d, entry in enumerate(spec):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                shape[d] //= int(np.prod([sizes[a] for a in axes]))
        if drop_agent:
            shape = shape[1:]
        total += int(np.prod(shape)) * leaf.dtype.itemsize
    return total


def check_rows(rows, sizes):
    """Every family x kind has a row with the reference's keys (none is
    refused); argument bytes and model flops as the reference's specs and
    formula give them. Returns the rows by (arch, shape)."""
    by = {(r["arch"], r["shape"]): r for r in rows}
    assert set(by) == {(a, k) for a in FAMILIES for k in KINDS}
    chips = int(np.prod(list(sizes.values())))
    mesh = types.SimpleNamespace(shape=dict(sizes))
    for (arch, kind), r in by.items():
        assert REF_KEYS | {"trace_s"} == set(r), set(r) ^ (REF_KEYS | {"trace_s"})
        assert set(r["memory"]) == MEMORY_KEYS and r["chips"] == chips
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
        assert all(np.isfinite(r[k]) for k in ("compute_s", "memory_s", "collective_s"))
        jcfg = jcfgs.get_reduced(arch, dtype="bfloat16")
        jb = jbuild(jcfg, remat=False)
        one = jax.eval_shape(jb.init, jax.eval_shape(lambda: jax.random.PRNGKey(0)))
        n = jcfg.active_param_count()
        if kind == "train_4k":
            mode = jcfgs.AGENT_MODES[arch]
            A = sizes["data"] * sizes.get("pod", 1) if mode == "full" else sizes.get("pod", 1)
            assert r["n_agents"] == A and r["agent_mode"] == mode
            stacked = jax.tree.map(lambda x: jax.ShapeDtypeStruct((A, *x.shape), x.dtype), one)
            params = _ref_local_bytes(stacked, jsh.param_specs(stacked, mesh, mode, A), sizes,
                                      True)
            batch = {"tokens": jax.ShapeDtypeStruct((A, BATCH // A, SEQ + 1), np.int32)}
            if jcfg.is_encdec:
                from repro.models.encdec import enc_len
                batch["embeds"] = jax.ShapeDtypeStruct((A, BATCH // A, enc_len(SEQ),
                                                        jcfg.d_model), np.float32)
            data = _ref_local_bytes(batch, jsh.batch_specs(batch, mesh, mode), sizes, True)
            assert r["model_flops_global"] == 6.0 * n * BATCH * SEQ
            assert r["collective_bytes_per_device"] > 0  # TP and the gossip
        else:
            params = _ref_local_bytes(one, jsh.param_specs(one, mesh, "serve", 1), sizes, False)
            if kind == "prefill_32k":
                batch = {"tokens": jax.ShapeDtypeStruct((BATCH, SEQ), np.int32)}
                if jcfg.is_encdec:
                    from repro.models.encdec import enc_len
                    batch["embeds"] = jax.ShapeDtypeStruct((BATCH, enc_len(SEQ), jcfg.d_model),
                                                           np.float32)
                data = _ref_local_bytes(batch, jsh.batch_specs(batch, mesh, "serve"), sizes,
                                        False)
                assert r["model_flops_global"] == 2.0 * n * BATCH * SEQ
            else:
                token = {"t": jax.ShapeDtypeStruct((BATCH, 1), np.int32)}
                caches = jax.eval_shape(lambda: jb.init_cache(None, BATCH, SEQ))
                data = (_ref_local_bytes(token, jsh.batch_specs(token, mesh, "serve"), sizes,
                                         False)
                        + _ref_local_bytes(caches, jsh.cache_specs(caches, mesh, True), sizes,
                                           False))
                assert r["model_flops_global"] == 2.0 * n * BATCH
        assert r["memory"]["argument_size_in_bytes"] == params + data, (arch, kind)
    return by


@pytest.fixture(scope="module")
def rows_4x2():
    return dryrun_rows("4x2", extra=True)


def test_every_family_traces_train_prefill_and_decode_on_4x2(rows_4x2):
    by = check_rows(rows_4x2["rows"], {"data": 4, "model": 2})
    r = by[("llama3.2-1b", "train_4k")]
    # The round writes the parameters in place: the outputs alias them.
    assert r["memory"]["alias_size_in_bytes"] > 0.9 * r["memory"]["argument_size_in_bytes"]
    assert r["collective_ops"]["collective-permute"] > 0  # the ring gossip


def test_counter_counts_the_local_shard_of_a_sharded_product(rows_4x2):
    """2 x 4096 x 4096 x 256 (the local product), not the global
    2 x 4096^3 that FlopCounterMode reports above DTensor."""
    assert rows_4x2["extra"]["flops"] == 2.0 * 4096 * 4096 * 256
    assert rows_4x2["extra"]["collectives"] == 0


def test_collective_formulas_on_the_reference_synthetic_hlo():
    """The records of ``tests/test_roofline.py:60-73``'s HLO (an all-gather,
    an all-reduce and a collective-permute of f32[128,256]) give what the
    reference's parser gives."""
    from repro.roofline.analysis import collective_bytes as ref_bytes
    from repro_torch.roofline.analysis import collective_bytes
    from repro_torch.roofline.counter import Collective

    sz = 128 * 256 * 4
    txt = """
ENTRY %main.1 (p0: f32[128,256]) -> f32[128,256] {
  %p0 = f32[128,256]{1,0} parameter(0)
  %ag = f32[128,256]{1,0} all-gather(%p0), replica_groups={{0,1}}, dimensions={0}
  %ar = f32[128,256]{1,0} all-reduce(%ag), to_apply=%add
  ROOT %cp = f32[128,256]{1,0} collective-permute(%ar), source_target_pairs={{0,1}}
}
"""
    got = collective_bytes([Collective("all-gather", sz, sz), Collective("all-reduce", sz, sz),
                            Collective("collective-permute", sz, sz)])
    assert got == ref_bytes(txt)
    assert (got["all-gather"], got["all-reduce"], got["collective-permute"]) == (sz, 2 * sz, sz)


def test_refusals_name_their_reason_and_roadmap_item(monkeypatch, capsys):
    """No combination is refused any more: ``--all --both-meshes`` plans
    every one of the 80 (10 archs x 4 shapes x 2 meshes) and calls
    ``run_one`` on each (stubbed here: tracing them all takes tens of
    minutes), and the module keeps no refusal list."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun

    calls = []

    def fake_run_one(arch, shape_name, multi_pod=False, **kw):
        calls.append((arch, shape_name, bool(multi_pod)))
        return {}

    monkeypatch.setattr(dryrun, "run_one", fake_run_one)
    assert dryrun.main(["--all", "--both-meshes"]) == 0
    assert len(ARCH_IDS) * len(SHAPES) * 2 == 80
    assert sorted(calls) == sorted((a, s, mp) for a in ARCH_IDS for s in SHAPES
                                   for mp in (False, True))
    assert "refused" not in capsys.readouterr().out
    assert not hasattr(dryrun, "REFUSED") and not hasattr(dryrun, "refusal")


def test_hillclimb_pairs_and_variants_are_the_reference_ones():
    """Read in a subprocess: importing the reference's hill-climb sets its
    512-device XLA flag."""
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    code = ("import json, repro.launch.hillclimb as h; "
            "print(json.dumps([h.PAIRS, h.VARIANTS]))")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    from repro_torch.launch import hillclimb

    want = json.loads(res.stdout.strip().splitlines()[-1])
    assert json.loads(json.dumps([hillclimb.PAIRS, hillclimb.VARIANTS])) == want

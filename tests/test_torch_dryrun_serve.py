"""The dry-run's serve rows and training collectives against the reference's.

* The counter (``roofline/counter.py``) counts the same flops, bytes and
  collectives for ``einsum``, ``@``, ``F.linear`` and ``bmm`` under
  ``torch.inference_mode()`` (where its dispatch mode sees the composite
  operations whole and runs their decompositions) as under
  ``torch.no_grad()``: on real tensors here, and on FakeTensor DTensors
  on a fake (4, 2) mesh in the port's subprocess.
* The serve rows (prefill and decode) of reduced dense (qwen1.5-4b, MHA)
  and GQA (llama3.2-1b) configs on a (4, 2) ("data", "model") mesh: the
  port's ``launch.dryrun`` in one subprocess over the fake process group,
  the reference's in another on 8 XLA host devices, both at batch 8 and
  16 positions (``tests/test_torch_dryrun.py``'s reduced rows). Per-device
  flops within 5% of the reference's; the port's temp at most 2x.
* The reduced llama training row's collective bytes by kind against the
  reference's, each ratio inside the bounds ``DEVIATIONS.md`` explains
  ("Collective bytes by kind").
* C10, the recurrent families' counts: the reference's HLO parser takes
  the larger branch of every ``lax.cond`` (``hlo_parse.py``), and both
  recurrent stacks choose their block by ``lax.cond`` in the layer scan,
  so it counts an mLSTM on every xLSTM layer and the shared attention on
  every zamba2 layer, whatever the layer runs. Where every layer runs the
  branch the reference counts (xLSTM all mLSTM; zamba2's shared block on
  every layer) the port's per-device flops are within 5% of the
  reference's for train, prefill and decode; the reference's count is the
  same for every layer pattern; the mixed configs' count is the
  reference's less, on each layer it over-counts, the branch difference
  the port's uniform rows give (within 5%).
* The sLSTM scan's weighting (``OpCounter.weighted``): the reduced xLSTM
  train and prefill rows at 64 positions (4 mLSTM chunks, 64 sLSTM steps)
  count the same flops and collective bytes by kind, exactly, and bytes
  within 1%, whether the loops are weighted or run step by step.
* The MoE decode (``models/moe.py``: the token group split on its tokens,
  the expert products on the weights' own shards, d_ff on "model"): the
  reduced granite-moe and grok decode rows within 5% of the reference's
  flops on (4, 2); the formerly refused combinations' reduced
  counterparts (granite-moe decode and long-context decode on (2, 2, 2),
  grok decode on both meshes) trace.
* The serve layout computes what the plain model computes: four gloo
  processes on a (2, 2) mesh (the cache split on its KV heads) and on a
  (1, 4) mesh (split on its positions) prefill and decode the reduced
  llama (as the dry-run runs it: plain tensors replicated implicitly, the
  caches laid out by ``cache_specs``), and the logits equal the
  one-process model's to 1e-5.
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
import torch.multiprocessing as mp
import torch.nn.functional as F

SRC = Path(__file__).resolve().parents[1] / "src"
BATCH, SEQ = 8, 16
ROWS = [("llama3.2-1b", "prefill_32k"), ("llama3.2-1b", "decode_32k"),
        ("qwen1.5-4b", "prefill_32k"), ("qwen1.5-4b", "decode_32k")]
TRAIN = ("llama3.2-1b", "train_4k")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
# C10's configs: (name, arch, override of the reduced config's layer
# pattern). The reduced xLSTM has 2 blocks (slstm_every 2: mLSTM, sLSTM),
# the reduced zamba2 2 Mamba2 layers with the shared block after the
# second (shared_attn_every 2).
C10 = {"xlstm_mixed": ("xlstm-1.3b", {}), "xlstm_all_m": ("xlstm-1.3b", {"slstm_every": 3}),
       "xlstm_all_s": ("xlstm-1.3b", {"slstm_every": 1}),
       "zamba2_mixed": ("zamba2-1.2b", {}),
       "zamba2_all_shared": ("zamba2-1.2b", {"shared_attn_every": 1}),
       "zamba2_no_shared": ("zamba2-1.2b", {"shared_attn_every": 99})}
# The reference's rows: every kind of the uniform configs; the mixed ones'
# prefill and decode show its count is the uniform one's (its train rows,
# 10 s of compile each, are taken as equal: the same count, CPU runs).
C10_REF = {"xlstm_all_m": KINDS, "zamba2_all_shared": KINDS,
           "xlstm_mixed": KINDS[1:], "zamba2_mixed": KINDS[1:]}
MOE = ("granite-moe-3b-a800m", "grok-1-314b")
# The reduced counterparts of the formerly refused MoE rows, by mesh.
MOE_REFUSED = [("granite-moe-3b-a800m", "decode_32k", (2, 2, 2)),
               ("granite-moe-3b-a800m", "long_500k", (2, 2, 2)),
               ("grok-1-314b", "decode_32k", (2, 2, 2))]  # grok on (4, 2): the ratio row
WEIGHT_SEQ = 64
# Per-kind collective bytes of the reduced llama training row, port over
# reference (DEVIATIONS.md "Collective bytes by kind"): the reference
# counts an asynchronous collective-permute-start's (operand, result)
# tuple as its operand, twice the bytes sent; the port's tensor-parallel
# weight reshards are all-gathers where GSPMD's layout all-reduces.
KIND_BOUNDS = {"collective-permute": (0.5, 0.5), "all-gather": (1.5, 3.5),
               "all-reduce": (0.4, 0.9)}


def _ops():
    g = np.random.default_rng(0)
    t = (lambda *s: torch.as_tensor(g.normal(size=s), dtype=torch.float32))
    a, b, w, x = t(2, 4, 16, 8), t(2, 4, 16, 8), t(8, 32), t(5, 8)
    return {"einsum": lambda: torch.einsum("bhqd,bhkd->bhqk", a, b),
            "matmul": lambda: x @ w,
            "linear": lambda: F.linear(x, w.T),
            "bmm": lambda: torch.bmm(a[0], b[0].transpose(1, 2))}


def _count(fn, ctx):
    from repro_torch.roofline.counter import OpCounter

    with ctx(), OpCounter() as c:
        fn()
    return c.flops, c.bytes, [(k.kind, k.operand_bytes, k.result_bytes) for k in c.collectives]


@pytest.mark.parametrize("op", ["einsum", "matmul", "linear", "bmm"])
def test_counter_counts_products_alike_under_inference_mode(op):
    fn = _ops()[op]
    want = _count(fn, torch.no_grad)
    assert want[0] > 0
    assert _count(fn, torch.inference_mode) == want


PORT_SCRIPT = textwrap.dedent(f"""
    import json, torch
    torch.set_num_threads(1)
    import torch.nn.functional as F
    from repro_torch.configs import get_reduced
    from repro_torch.launch import dryrun
    rows = {{}}
    for arch, shape in {ROWS + [TRAIN]!r}:
        r = dryrun.run_one(arch, shape, cfg=get_reduced(arch, dtype="bfloat16"), mesh_shape=(4, 2),
                           global_batch={BATCH}, seq_len={SEQ}, verbose=False,
                           sites=4 if shape == "train_4k" else 0)
        rows[arch + "|" + shape] = r
    def variant(cfg, over):  # a C10 layer pattern
        import dataclasses
        if "slstm_every" in over:
            return dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm, **over))
        return dataclasses.replace(cfg, **over)
    c10 = {{}}
    for name, (arch, over) in {C10!r}.items():
        for shape in {KINDS!r}:
            c10[name + "|" + shape] = dryrun.run_one(
                arch, shape, cfg=variant(get_reduced(arch, dtype="bfloat16"), over),
                mesh_shape=(4, 2), global_batch={BATCH}, seq_len={SEQ},
                verbose=False)["flops_per_device"]
    weighted = {{}}
    for shape in ("train_4k", "prefill_32k"):
        for w in (True, False):
            r = dryrun.run_one("xlstm-1.3b", shape, cfg=get_reduced("xlstm-1.3b", dtype="bfloat16"),
                               mesh_shape=(4, 2), global_batch={BATCH}, seq_len={WEIGHT_SEQ},
                               verbose=False, weight_loops=w)
            weighted[shape + "|" + str(w)] = [r["flops_per_device"], r["bytes_per_device"],
                                               r["collective_breakdown"], r["collective_ops"]]
    moe = {{}}
    for arch in {MOE!r}:
        moe[arch + "|decode_32k|4x2"] = dryrun.run_one(
            arch, "decode_32k", cfg=get_reduced(arch, dtype="bfloat16"), mesh_shape=(4, 2),
            global_batch={BATCH}, seq_len={SEQ}, verbose=False)["flops_per_device"]
    for arch, shape, mesh in {MOE_REFUSED!r}:
        moe[arch + "|" + shape + "|" + "x".join(map(str, mesh))] = dryrun.run_one(
            arch, shape, cfg=get_reduced(arch, dtype="bfloat16"), mesh_shape=mesh,
            global_batch=1 if shape == "long_500k" else {BATCH}, seq_len={SEQ},
            verbose=False)["flops_per_device"]
    # FakeTensor DTensors on the fake (4, 2) mesh: the same four products
    # counted under no_grad and under inference_mode.
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline.counter import OpCounter
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    fake = {{}}
    with FakeTensorMode(allow_non_fake_inputs=True):
        dt = lambda t, p: DTensor.from_local(t, mesh, p, run_check=False)
        a = dt(torch.empty(2, 2, 16, 8), [Shard(0), Shard(1)])
        b = dt(torch.empty(2, 2, 16, 8), [Shard(0), Shard(1)])
        x = dt(torch.empty(8, 64), [Replicate(), Replicate()])
        w = dt(torch.empty(64, 16), [Replicate(), Shard(1)])
        ops = {{"einsum": lambda: torch.einsum("bhqd,bhkd->bhqk", a, b), "matmul": lambda: x @ w,
               "linear": lambda: F.linear(x, w.T),
               "bmm": lambda: torch.bmm(a.to_local()[0], b.to_local()[0].transpose(1, 2))}}
        for name, fn in ops.items():
            fake[name] = []
            for ctx in (torch.no_grad, torch.inference_mode):
                with ctx(), OpCounter() as c:
                    fn()
                fake[name].append([c.flops, c.bytes,
                                   [[k.kind, k.operand_bytes, k.result_bytes] for k in c.collectives]])
    print("ROWS " + json.dumps({{"rows": rows, "fake": fake, "c10": c10, "weighted": weighted,
                                "moe": moe}}))
""")

REF_SCRIPT = textwrap.dedent(f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax, numpy as np
    from jax.sharding import Mesh
    assert len(jax.devices()) == 8
    import repro.configs as rc
    import repro.launch.dryrun as d
    d.make_production_mesh = lambda multi_pod=False: Mesh(
        np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    d.get_config = lambda arch: rc.get_reduced(arch, dtype="bfloat16")
    d.SHAPES = {{k: dataclasses.replace(v, global_batch={BATCH}, seq_len={SEQ})
                for k, v in d.SHAPES.items()}}
    rows = {{}}
    for arch, shape in {ROWS + [TRAIN]!r}:
        rows[arch + "|" + shape] = d.run_one(arch, shape, False, verbose=False)
    def variant(cfg, over):  # a C10 layer pattern
        import dataclasses
        if "slstm_every" in over:
            return dataclasses.replace(cfg, xlstm=dataclasses.replace(cfg.xlstm, **over))
        return dataclasses.replace(cfg, **over)
    c10 = {{}}
    for name, kinds in {C10_REF!r}.items():
        arch, over = {C10!r}[name]
        d.get_config = lambda a, over=over: variant(rc.get_reduced(a, dtype="bfloat16"), over)
        for shape in kinds:
            c10[name + "|" + shape] = d.run_one(arch, shape, False,
                                                verbose=False)["flops_per_device"]
    d.get_config = lambda arch: rc.get_reduced(arch, dtype="bfloat16")
    moe = {{arch + "|decode_32k|4x2": d.run_one(arch, "decode_32k", False,
                                                verbose=False)["flops_per_device"]
           for arch in {MOE!r}}}
    print("ROWS " + json.dumps({{"rows": rows, "c10": c10, "moe": moe}}))
""")


def _start(script, **env):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1", **env)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _rows(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("ROWS "))
    return json.loads(line[5:])


@pytest.fixture(scope="module")
def both_all():
    """(port, reference) results, the two subprocesses run side by side."""
    port = _start(PORT_SCRIPT)
    ref = _start(REF_SCRIPT, JAX_PLATFORMS="cpu")
    return _rows(port), _rows(ref)


@pytest.fixture(scope="module")
def both(both_all):
    """(port results, reference rows)."""
    return both_all[0], both_all[1]["rows"]


@pytest.mark.parametrize("op", ["einsum", "matmul", "linear", "bmm"])
def test_counter_counts_products_alike_on_a_fake_mesh(both, op):
    no_grad, inference = both[0]["fake"][op]
    assert no_grad[0] > 0 and inference == no_grad


@pytest.mark.parametrize("arch,shape", ROWS)
def test_serve_rows_count_the_reference_program(both, arch, shape):
    """Per-device flops within 5% of the reference's (the serve layout:
    FSDP weights gathered, the decode query meeting the cache, the lm head
    vocab-parallel on the local batch); temp at most 2x."""
    port, ref = both[0]["rows"][f"{arch}|{shape}"], both[1][f"{arch}|{shape}"]
    ratio = port["flops_per_device"] / ref["flops_per_device"]
    assert abs(ratio - 1) <= 0.05, (arch, shape, ratio)
    temp = port["memory"]["temp_size_in_bytes"] / ref["memory"]["temp_size_in_bytes"]
    assert 0 < temp <= 2.0, (arch, shape, temp)


def test_training_collective_bytes_by_kind(both):
    """The reduced llama training row: flops equal, each collective kind's
    bytes inside its recorded ratio to the reference's, and the live bytes
    at its temp peak attributed by allocation site."""
    port, ref = both[0]["rows"]["|".join(TRAIN)], both[1]["|".join(TRAIN)]
    assert abs(port["flops_per_device"] / ref["flops_per_device"] - 1) <= 0.05
    pk, rk = port["collective_breakdown"], ref["collective_breakdown"]
    for kind, (lo, hi) in KIND_BOUNDS.items():
        ratio = pk[kind] / rk[kind]
        assert lo - 1e-9 <= ratio <= hi + 1e-9, (kind, ratio, pk, rk)
    total = sum(pk.values())
    assert pk["reduce-scatter"] <= 0.01 * total and pk["all-to-all"] == 0, pk
    # The temp peak's attribution (``sites=4``): the largest sites first,
    # model frames, their bytes within the peak.
    sites = port["peak_sites"]
    assert len(sites) == 4 and all(site.count(":") == 2 for site, _ in sites), sites
    sizes = [b for _, b in sites]
    assert sizes == sorted(sizes, reverse=True) and 0 < sum(sizes) <= port["memory"][
        "temp_size_in_bytes"], sites


@pytest.mark.parametrize("kind", KINDS)
def test_recurrent_rows_count_the_branch_each_layer_runs(both_all, kind):
    """C10: the reference counts the larger ``lax.cond`` branch on every
    layer (the same count for every layer pattern); where every layer runs
    that branch the port is within 5% of it; the mixed configs are the
    reference less the branch difference on each over-counted layer (the
    port's uniform rows give the difference a layer), within 5%."""
    port, ref = both_all[0]["c10"], both_all[1]["c10"]
    p = {name: port[f"{name}|{kind}"] for name in C10}
    r = {name: ref[f"{name}|{kind}"] for name in ("xlstm_all_m", "zamba2_all_shared")}
    if kind == "train_4k":  # not run: the uniform count (see C10_REF)
        r.update(xlstm_mixed=r["xlstm_all_m"], zamba2_mixed=r["zamba2_all_shared"])
    else:
        r.update(xlstm_mixed=ref[f"xlstm_mixed|{kind}"], zamba2_mixed=ref[f"zamba2_mixed|{kind}"])
    assert r["xlstm_mixed"] == r["xlstm_all_m"], r
    assert r["zamba2_mixed"] == r["zamba2_all_shared"], r
    for name in ("xlstm_all_m", "zamba2_all_shared"):
        assert abs(p[name] / r[name] - 1) <= 0.05, (name, kind, p[name] / r[name])
    layers = 2  # the reduced configs' blocks
    d_xlstm = (p["xlstm_all_m"] - p["xlstm_all_s"]) / layers  # mLSTM less sLSTM, a layer
    d_zamba = (p["zamba2_all_shared"] - p["zamba2_no_shared"]) / layers  # the shared block
    want = {"xlstm_mixed": r["xlstm_mixed"] - 1 * d_xlstm,  # one sLSTM layer
            "zamba2_mixed": r["zamba2_mixed"] - 1 * d_zamba}  # one layer without the block
    for name, w in want.items():
        assert d_xlstm > 0 and d_zamba > 0 and abs(p[name] / w - 1) <= 0.05, (name, kind,
                                                                              p[name] / w)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_weighted_scan_counts_equal_every_step(both, shape):
    """The reduced xLSTM rows at 64 positions: the weighted loops (the
    sLSTM scan's steps; a prefill's mLSTM chunks) count the flops and the
    collective bytes and operations by kind of the step-by-step run
    exactly, and its bytes within 1%."""
    (f_w, b_w, coll_w, ops_w) = both[0]["weighted"][f"{shape}|True"]
    (f_e, b_e, coll_e, ops_e) = both[0]["weighted"][f"{shape}|False"]
    assert f_w == f_e > 0
    assert coll_w == coll_e and ops_w == ops_e
    assert abs(b_w / b_e - 1) <= 0.01


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_counts_the_reference_program(both_all, arch):
    """The reduced MoE decode on (4, 2) within 5% of the reference's
    per-device flops (the experts' d_ff on "model", no expert axis; the
    token group split on its tokens), and the formerly refused
    combinations' reduced counterparts trace with positive counts."""
    port, ref = both_all[0]["moe"], both_all[1]["moe"]
    key = f"{arch}|decode_32k|4x2"
    assert abs(port[key] / ref[key] - 1) <= 0.05, (arch, port[key] / ref[key])
    for a, shape, mesh in MOE_REFUSED:
        if a == arch:
            assert port[f"{a}|{shape}|{'x'.join(map(str, mesh))}"] > 0


def _serve_worker(rank, world, path, out_dir):
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{path}", world_size=world, rank=rank)
    try:
        _serve_checks(rank, out_dir)
    finally:
        dist.destroy_process_group()


def _serve_checks(rank, out_dir):
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_mesh, use_mesh
    from repro_torch.models import build_model, sharding
    from repro_torch.models.sharding import (batch_specs, layer_cache_specs, map_specs,
                                             param_specs, placements)
    from repro_torch.utils.tree import module_tree

    cfg = get_reduced("llama3.2-1b", dtype="float32")
    bundle = build_model(cfg, remat=False, device="cpu")
    model = bundle.init(0)
    tree = module_tree(model)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8)))
    steps = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 2)))
    want = [bundle.prefill(model, {"tokens": tokens}, max_len=12)]
    caches = want[0][1]
    for j in range(2):
        want.append(bundle.decode(model, steps[:, j:j + 1], caches, 8 + j))
    report = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        sharding.set_activation_axes("data")
        try:
            with use_mesh(mesh), torch.inference_mode(), implicit_replication():
                specs = param_specs(tree, mesh, "serve", 1)
                params = map_specs(lambda s, x: distribute_tensor(x, mesh, placements(s, mesh)),
                                   specs, tree)
                served = bundle.bind(params)
                bspec = batch_specs({"t": tokens}, mesh, "serve")["t"]
                as_dt = (lambda t: distribute_tensor(t, mesh, placements(bspec, mesh)))
                got = [bundle.prefill(served, {"tokens": as_dt(tokens)}, max_len=12)]
                # Laid out as the dry-run's decode takes them (cache_specs).
                caches = map_specs(lambda sp, c: c.redistribute(mesh, placements(sp, mesh))
                                   if isinstance(c, DTensor) else c,
                                   layer_cache_specs(got[0][1], mesh, True), got[0][1])
                for j in range(2):
                    got.append(bundle.decode(served, as_dt(steps[:, j:j + 1]), caches, 8 + j))
                full = [(g[0].full_tensor() if isinstance(g[0], DTensor) else g[0]) for g in got]
                split = any(isinstance(c["k"], DTensor) and any(p.is_shard(1) for p in
                                                                c["k"].placements)
                            for c in caches)
        finally:
            sharding.set_activation_axes(None)
        report["x".join(map(str, shape))] = dict(
            err=max(float((g - w[0]).abs().max()) for g, w in zip(full, want)),
            seq_split=bool(split))
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))


def test_serve_layout_computes_the_plain_model(tmp_path):
    """Prefill and two decode steps of the reduced llama on gloo meshes of
    four processes equal the one-process model (1e-5); on (1, 4) the
    cache is split on its positions, so the decode query is gathered to
    meet it."""
    mp.spawn(_serve_worker, args=(4, str(tmp_path / "pg"), str(tmp_path)), nprocs=4, join=True)
    for r in range(4):
        rep = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rep["2x2"]["err"] <= 1e-5 and rep["1x4"]["err"] <= 1e-5, rep
        assert rep["1x4"]["seq_split"] and not rep["2x2"]["seq_split"], rep

"""Multi-pod dry-run: trace every step on the production mesh, allocating nothing.

Port of ``repro/launch/dryrun.py``. The reference lowers and compiles the
real train, prefill and decode steps of every (architecture x input shape)
on the 16x16 and 2x16x16 meshes from ShapeDtypeStructs, and reads XLA's
memory analysis and the partitioned HLO. The port runs one rank's step
(rank 0) of the same program eagerly:

* the process group is ``torch.distributed``'s ``fake`` backend, of the
  mesh's size, so every collective returns at once;
* every tensor is a FakeTensor on the ``"cpu"`` device type (no storage),
  so every kernel site takes its plain version: a kernel cannot run on a
  fake tensor;
* parameters, batches and caches are DTensors with the placements of the
  reference's specs (``models/sharding.py``): the train step is
  ``spmd.jit_train_step``'s per-rank round, the inference steps the
  bundle's ``prefill``/``decode`` on the whole mesh (FSDP + TP, the batch
  over the data axes);
* ``roofline/counter.py`` counts the rank's local flops, bytes,
  collectives and live storage bytes, and ``roofline/analysis.py`` places
  them on the H100's peaks (``launch/mesh.py``).

The ``memory`` dict gives per device ``argument_size_in_bytes`` (the
local shards of the step's inputs, exact from the specs),
``output_size_in_bytes``, ``alias_size_in_bytes`` (outputs written into
inputs: the round's parameters, the decode caches) and
``temp_size_in_bytes`` (the peak of live storages the step allocated).
``lower_s``/``compile_s`` are ``trace_s``. Every (architecture x shape
x mesh) combination is traced, as the reference compiles every one: the
sLSTM time scan traces its distinct steps once, weighted by their count
(``roofline/counter.py``), and so does a prefill's mLSTM inter-chunk
loop, so an xlstm-1.3b row traces in minutes on a CPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out results/dryrun_torch.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import AGENT_MODES, ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import P2PConfig
from repro_torch.core import spmd
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, PRODUCTION_SHAPES, link_bw,
                                     make_mesh, use_mesh)
from repro_torch.models import build_model
from repro_torch.models import sharding
from repro_torch.models.encdec import enc_len
from repro_torch.models.registry import model_class
from repro_torch.models.sharding import (Shape, batch_specs, layer_cache_specs, map_specs,
                                         param_specs, placements, stacked_shapes)
from repro_torch.roofline.analysis import analyze_traced
from repro_torch.roofline.counter import OpCounter
from repro_torch.utils.tree import module_tree, tree_leaves

SLIDING_WINDOW_500K = 8192
DEFAULT_OUT = "results/dryrun_torch.jsonl"

def arch_config_for_shape(arch: str, shape_name: str):
    """Resolve the model config, applying the long-context attention policy."""
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.family != "ssm" and cfg.sliding_window is None:
        # sub-quadratic requirement: windowed attention for attention archs
        cfg = dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_500K)
    return cfg


def model_flops(cfg, shape) -> float:
    """The reference's useful-work count of one step of ``shape``."""
    if shape.kind == "train":
        return 6.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    return 2.0 * cfg.active_param_count() * shape.global_batch


def fake_world(chips: int):
    """Start (or resize) the fake process group of ``chips`` ranks, rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == chips and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), world_size=chips, rank=0)


def _dtensor(spec, mesh, shape, dtype, fill=None):
    """A DTensor of global ``shape`` laid out by ``spec`` whose local shard
    is a new (fake) tensor."""
    from torch.distributed.tensor import DTensor

    local = sharding.local_shape(shape, spec, mesh) if spec is not None else tuple(shape)
    t = torch.empty(local, dtype=dtype) if fill is None else torch.full(local, fill, dtype=dtype)
    stride = sharding.contiguous_stride(shape)
    return DTensor.from_local(t, mesh, placements(spec or sharding.P(), mesh), run_check=False,
                              shape=tuple(shape), stride=stride)


def _agent_tree(cfg, stacked):
    """The parameter tree of one model, as meta tensors."""
    return module_tree(model_class(cfg)(cfg, device="meta"), stacked)


def _local_bytes(obj) -> int:
    from torch.distributed.tensor import DTensor

    total = 0
    for x in tree_leaves(obj):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _storages(obj) -> set:
    from torch.distributed.tensor import DTensor

    out = set()
    for x in tree_leaves(obj):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            out.add(id(x.untyped_storage()))
    return out


def input_specs(arch: str, shape_name: str, mesh, gossip="ppermute", p2p_on=True, dp_on=True,
                cfg_overrides=None, moe_overrides=None, remat=True, cfg=None,
                global_batch=None, seq_len=None):
    """The step of one (arch, shape) combination on ``mesh`` and its fake
    inputs. Call under a ``FakeTensorMode``. ``cfg`` replaces the arch's
    config (the tests' reduced ones); ``global_batch``/``seq_len`` replace
    the shape's. Returns ``(step, args, meta)``: ``step(*args)`` runs the
    rank's program."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    cfg = cfg or arch_config_for_shape(arch, shape_name)
    if moe_overrides and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_overrides))
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    shape = dataclasses.replace(shape, global_batch=global_batch or shape.global_batch,
                                seq_len=seq_len or shape.seq_len)
    bundle = build_model(cfg, remat=remat, device="cpu")
    tree = _agent_tree(cfg, bundle.stacked)

    if shape.kind == "train":
        agent_mode = AGENT_MODES[arch]
        A = spmd.num_agents(mesh, agent_mode)
        assert shape.global_batch % A == 0, (arch, shape_name, A)
        per_agent = shape.global_batch // A
        p2p = P2PConfig(agent_mode=agent_mode, enabled=p2p_on, dp_enabled=dp_on,
                        planned_rounds=100)
        step, eps_step, noise_scale = spmd.make_train_step(bundle, p2p, mesh, per_agent,
                                                           gossip=gossip)
        pspecs = param_specs(stacked_shapes(tree, A), mesh, agent_mode, A)
        batch_shapes = {"tokens": ((A, per_agent, shape.seq_len + 1), torch.int32)}
        if cfg.is_encdec:
            batch_shapes["embeds"] = ((A, per_agent, enc_len(shape.seq_len), cfg.d_model),
                                      torch.float32)
        bspecs = batch_specs({k: Shape(s) for k, (s, _) in batch_shapes.items()}, mesh,
                             agent_mode)
        with unset_fake_temporarily():  # its sub-meshes read the rank grid
            mstep = spmd.jit_train_step(step, mesh, pspecs, bspecs)
        params = map_specs(lambda s, x: _dtensor(s, mstep.agent_mesh, x.shape, x.dtype),
                           mstep.agent_specs, tree)
        batch = {k: _dtensor(mstep.batch_specs[k], mstep.agent_mesh, s[1:], dt, fill=0)
                 for k, (s, dt) in batch_shapes.items()}
        generator = torch.Generator().manual_seed(0)

        def train_step(params, batch):
            return mstep(params, batch, generator)

        meta = dict(agent_mode=agent_mode, n_agents=A, eps_step=eps_step,
                    noise_scale=noise_scale, model_flops=model_flops(cfg, shape),
                    aliased=(0,))
        return train_step, (params, batch), meta

    # ---- inference shapes (serve): one shared model, FSDP + TP ----------
    act_axes = sharding._ACT_AXES
    pspecs = param_specs(tree, mesh, "serve", 1)
    with torch.inference_mode():  # serving runs under it: views of the weights too
        params = map_specs(lambda s, x: _dtensor(s, mesh, x.shape, x.dtype), pspecs, tree)
        model = bundle.bind(params)

    def batch_of(shapes):
        specs = batch_specs({k: Shape(s) for k, (s, _) in shapes.items()}, mesh, "serve")
        return {k: _dtensor(specs[k], mesh, s, dt, fill=0) for k, (s, dt) in shapes.items()}

    if shape.kind == "prefill":
        shapes = {"tokens": ((shape.global_batch, shape.seq_len), torch.int32)}
        if cfg.is_encdec:
            shapes["embeds"] = ((shape.global_batch, enc_len(shape.seq_len), cfg.d_model),
                                torch.float32)
        batch = batch_of(shapes)

        def prefill_step(params, batch):
            return bundle.prefill(model, batch)

        meta = dict(agent_mode="serve", model_flops=model_flops(cfg, shape), aliased=())
        return prefill_step, (params, batch), meta

    # decode: the caches laid out by cache_specs, one token a request
    sharding.set_activation_axes(None)  # the shapes alone: specs lay them out
    try:
        cache_shapes = bundle.init_cache(model_class(cfg)(cfg, device="meta"),
                                         shape.global_batch, shape.seq_len)
    finally:
        sharding.set_activation_axes(act_axes)
    cspecs = layer_cache_specs(cache_shapes, mesh, batch_sharded=True)
    with torch.inference_mode():  # as bundle.init_cache makes them
        caches = map_specs(lambda s, x: _dtensor(s, mesh, x.shape, x.dtype, fill=0), cspecs,
                           cache_shapes)
    token = batch_of({"t": ((shape.global_batch, 1), torch.int32)})["t"]
    pos = shape.seq_len - 1

    def serve_step(params, token, caches):
        return bundle.decode(model, token, caches, pos)

    meta = dict(agent_mode="serve", model_flops=model_flops(cfg, shape), aliased=(2,))
    return serve_step, (params, token, caches), meta


def mesh_name(shape) -> str:
    return "x".join(str(s) for s in shape)


def run_one(arch: str, shape_name: str, multi_pod: bool = False, gossip="ppermute",
            p2p_on=True, dp_on=True, verbose=True, seq_parallel=False, cfg_overrides=None,
            moe_overrides=None, variant="", remat=True, cfg=None, mesh_shape=None,
            global_batch=None, seq_len=None, sites=0, weight_loops=True):
    """Trace one combination's step on the production mesh (or on
    ``mesh_shape``, 2 or 3 dims named as the production meshes) and return
    its row. ``sites > 0``
    adds ``peak_sites``: the ``sites`` allocation sites holding the most
    bytes at the temp peak (``OpCounter.top_sites``). ``weight_loops``
    False runs every step of the sLSTM scan under the counter, where the
    default traces its distinct steps once, weighted by their count
    (``OpCounter.weighted``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    if mesh_shape is not None:  # the production axes of as many dims
        multi_pod = len(mesh_shape) == 3
    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    shape = tuple(mesh_shape) if mesh_shape is not None else shape
    chips = int(np.prod(shape))
    fake_world(chips)
    mesh = make_mesh(shape, axes, device_type="cpu")
    t0 = time.time()
    kind = SHAPES[shape_name].kind
    if kind != "train":
        # Inference paths anchor activation shardings at the batch dim.
        sharding.set_activation_axes(("pod", "data") if "pod" in axes else "data")
    else:
        sharding.set_activation_axes(None)
    sharding.set_seq_axis("model" if seq_parallel else None)
    counter = OpCounter(sites=sites > 0, weight_loops=weight_loops)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh):
            step, args, meta = input_specs(
                arch, shape_name, mesh, gossip=gossip, p2p_on=p2p_on, dp_on=dp_on,
                cfg_overrides=cfg_overrides, moe_overrides=moe_overrides, remat=remat,
                cfg=cfg, global_batch=global_batch, seq_len=seq_len)
            arg_bytes = _local_bytes(args)
            arg_storages = _storages(args)
            with counter, implicit_replication():
                out = step(*args)
            aliased = _storages(out) & arg_storages
            out_bytes = _local_bytes(out)
            alias_bytes = sum(_local_bytes(args[i]) for i in meta["aliased"]
                              if _storages(args[i]) <= aliased)
    finally:
        sharding.set_activation_axes(None)
        sharding.set_seq_axis(None)
    trace_s = time.time() - t0
    mem_row = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
               "temp_size_in_bytes": counter.peak, "alias_size_in_bytes": alias_bytes}
    roof = analyze_traced(counter, chips, meta["model_flops"], peak_flops=PEAK_FLOPS_BF16,
                          hbm_bw=HBM_BW, link_bw=min(link_bw(shape, axes, (a,)) for a in axes))
    row = {
        "arch": arch,
        "shape": shape_name,
        "variant": variant,
        "mesh": mesh_name(shape),
        "chips": chips,
        "gossip": gossip,
        "p2p": p2p_on,
        "dp": dp_on,
        "agent_mode": meta["agent_mode"],
        "n_agents": meta.get("n_agents"),
        "trace_s": round(trace_s, 1),
        "memory": mem_row,
        **roof.row(),
        "collective_ops": roof.collectives.get("_counts"),
        "collective_breakdown": {k: v for k, v in roof.collectives.items()
                                 if not k.startswith("_")},
    }
    if sites:
        row["peak_sites"] = counter.top_sites(sites)
    if verbose:
        print(f"== {arch} x {shape_name} on {row['mesh']} ({meta['agent_mode']}) ==")
        print("memory:", mem_row)
        for site, nbytes in row.get("peak_sites", ()):
            print(f"  peak site {nbytes / 1e9:9.3f} GB  {site}")
        print("counted: flops=%.3e bytes=%.3e ops=%d" % (counter.flops, counter.bytes,
                                                          counter.ops))
        print("roofline: compute=%.4fs memory=%.4fs collective=%.4fs dominant=%s useful=%.2f" % (
            roof.compute_s, roof.memory_s, roof.collective_s, roof.dominant, roof.useful_ratio))
        sys.stdout.flush()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="all arch x shape combos")
    ap.add_argument("--gossip", default="ppermute", choices=["ppermute", "dense"])
    ap.add_argument("--no-p2p", action="store_true")
    ap.add_argument("--no-dp", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 1x1: a mesh of this shape in place of the production one")
    ap.add_argument("--batch", type=int, default=None, help="global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None, help="sequence length in place of the shape's")
    ap.add_argument("--sites", type=int, default=0,
                    help="print the N allocation sites holding the most bytes at the temp peak")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    mesh_shape = ([int(s) for s in args.mesh_shape.split("x")] if args.mesh_shape else None)

    done = set()
    if args.out and args.skip_existing:
        with contextlib.suppress(FileNotFoundError), open(args.out) as f:
            for line in f:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"], r["gossip"]))

    failures = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                name = (mesh_name(mesh_shape) if mesh_shape
                        else mesh_name(PRODUCTION_SHAPES[mp][0]))
                if (arch, shape_name, name, args.gossip) in done:
                    print(f"skip {arch} x {shape_name} on {name} (done)")
                    continue
                try:
                    row = run_one(arch, shape_name, mp, gossip=args.gossip,
                                  p2p_on=not args.no_p2p, dp_on=not args.no_dp,
                                  mesh_shape=mesh_shape, global_batch=args.batch,
                                  seq_len=args.seq, sites=args.sites)
                    if args.out:
                        with open(args.out, "a") as f:
                            f.write(json.dumps(row) + "\n")
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape_name, name, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("dry-run: all combinations traced OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

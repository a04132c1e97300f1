"""End-to-end P2P-DP training launcher.

Port of ``repro/launch/train.py``: personal models per agent, per-round DP
perturbation, ring or dense gossip, periodic checkpoints. With ``--mesh
Dx1`` the A agents are stacked on one device (the card unless ``--device
cpu``); A is ``--agents``, else D. With ``--mesh DxM``, M > 1, the round
runs on a D x M ``DeviceMesh``, one agent a data rank, tensor-parallel over
the M model ranks (``spmd.jit_train_step``): start it with ``torchrun
--nproc_per_node D*M`` (NCCL on the cards, gloo with ``--device cpu``);
the rank-0 process logs, and checkpoints are not written on a mesh.
Every family trains: the decoder-only
transformer (the default ``--arch llama3.2-1b``; MoE, VLM), the enc-dec
transformer (its frame embeddings drawn each step, as the reference draws
them), the zamba2 hybrid and the recurrent xLSTM (``--arch xlstm-1.3b``).

    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny --steps 50 \\
        --batch 4 --seq 129 --device cpu
    PYTHONPATH=src torchrun --standalone --nproc_per_node 2 -m repro_torch.launch.train \\
        --mesh 1x2 --steps 2 --batch 2 --seq 33 --device cpu
"""

from __future__ import annotations

import argparse
import itertools
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.base import P2PConfig
from repro_torch.core import spmd
from repro_torch.data.synthetic import token_stream
from repro_torch.models import build_model
from repro_torch.models.encdec import enc_len


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "small", "full"],
                    help="tiny/small = reduced configs for CPU; full = assigned config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4, help="per-agent batch")
    ap.add_argument("--seq", type=int, default=129)
    ap.add_argument("--agents", type=int, default=None, help="default: data-axis size")
    ap.add_argument("--mesh", default="1x1", help="e.g. 4x1 (data x model)")
    ap.add_argument("--mu", type=float, default=0.5)
    ap.add_argument("--alpha", type=float, default=0.9)
    ap.add_argument("--eps", type=float, default=0.0, help="DP budget; 0 = off")
    ap.add_argument("--clip", type=float, default=1.0)
    ap.add_argument("--gossip", default="ppermute", choices=["ppermute", "dense"])
    ap.add_argument("--no-p2p", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--keep-last", type=int, default=3,
                    help="checkpoint rotation depth (newest K entries kept)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(args):
    if args.preset == "full":
        cfg = get_config(args.arch)
    elif args.preset == "small":
        cfg = get_reduced(args.arch, num_layers=2, d_model=256, d_ff=512,
                          vocab_size=2048, dtype="float32")
    else:
        cfg = get_reduced(args.arch, dtype="float32")
    return cfg


def _p2p(args, A):
    return P2PConfig(
        agent_mode="full",
        enabled=not args.no_p2p,
        dp_enabled=args.eps > 0,
        eps_bar=args.eps if args.eps > 0 else 1.0,
        planned_rounds=args.steps,
        clip=args.clip,
        mu=args.mu,
        neighbor_offsets=(1,) if A <= 4 else (1, 2),
        gossip_dtype=None,
    )


def _batches(args, cfg, A, device):
    """Each step's stacked batch, (A, batch, seq) tokens (and the enc-dec
    frame embeddings), from the start of the stream."""
    stream = token_stream(cfg.vocab_size, A * args.batch, args.seq, args.seed, A)
    for step in itertools.count():
        toks = next(stream).reshape(A, args.batch, args.seq)
        batch = {"tokens": torch.as_tensor(toks, device=device)}
        if cfg.is_encdec:
            # The stubbed frontend's frame embeddings, a draw of their own
            # each step (the reference folds the step into its key).
            seed = np.random.SeedSequence([args.seed, step]).generate_state(1)[0]
            batch["embeds"] = torch.randn(
                (A, args.batch, enc_len(args.seq), cfg.d_model), device=device,
                generator=torch.Generator(device=device).manual_seed(int(seed)))
        yield batch


def _log(args, step, metrics, t0, history, quiet=False):
    if step % args.log_every == 0 or step == args.steps - 1:
        row = {"step": step, "loss": round(float(metrics["loss"]), 4),
               "grad_norm": round(float(metrics["grad_norm"]), 3),
               "elapsed_s": round(time.time() - t0, 1)}
        history.append(row)
        if not quiet:
            print(json.dumps(row), flush=True)


def _main_on_mesh(args, data, model_axis):
    """The round on a (data, model) mesh, one agent a data rank; this
    process is one rank of ``torchrun``'s."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import model_class
    from repro_torch.models.sharding import Shape, batch_specs, param_specs, stacked_shapes
    from repro_torch.utils.tree import module_tree

    world = data * model_axis
    if "RANK" not in os.environ or int(os.environ.get("WORLD_SIZE", 0)) != world:
        raise RuntimeError(
            f"--mesh {args.mesh} runs {world} ranks: start it with "
            f"torchrun --standalone --nproc_per_node {world} -m repro_torch.launch.train "
            f"--mesh {args.mesh} ...")
    if args.agents not in (None, data):
        raise ValueError(f"--agents {args.agents}: a mesh holds one agent a data rank ({data})")
    if args.checkpoint_dir or args.resume:
        raise ValueError("--checkpoint-dir/--resume: checkpoints are not written on a mesh")
    cuda = args.device != "cpu"
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))) if cuda else "cpu"
    if cuda:
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if cuda else "gloo", device_id=device if cuda else None)
    try:
        mesh = make_mesh((data, model_axis), ("data", "model"), "cuda" if cuda else "cpu")
        cfg = build(args)
        bundle = build_model(cfg, remat=False, device=device)
        A = data
        p2p = _p2p(args, A)
        step_fn, eps_step, _ = spmd.make_train_step(bundle, p2p, mesh, args.batch,
                                                    alpha=args.alpha, gossip=args.gossip)
        shapes = module_tree(model_class(cfg)(cfg, device="meta"), bundle.stacked)
        mstep = spmd.jit_train_step(
            step_fn, mesh, param_specs(stacked_shapes(shapes, A), mesh, "full", A),
            batch_specs({"tokens": Shape((A, args.batch, args.seq))}, mesh, "full"))
        a = mstep.agent
        # Agent a's model: the seed init_agents gives it.
        seed = int(np.random.SeedSequence(args.seed).generate_state(A)[a])
        params = mstep.shard(module_tree(bundle.init(seed), bundle.stacked))
        generator = torch.Generator(device=device).manual_seed(args.seed * 1_000_003 + a)
        batches = _batches(args, cfg, A, device)
        t0, history = time.time(), []
        for step in range(args.steps):
            batch = {k: v[a] for k, v in next(batches).items()}
            params, metrics = mstep(params, batch, generator)
            _log(args, step, metrics, t0, history, quiet=dist.get_rank() != 0)
        if args.eps > 0 and dist.get_rank() == 0:
            print(f"DP: per-step eps={eps_step:.4f} on a {args.mesh} mesh", flush=True)
        return history
    finally:
        dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    data, model_axis = (int(x) for x in args.mesh.split("x"))
    if model_axis != 1:
        return _main_on_mesh(args, data, model_axis)
    cfg = build(args)
    bundle = build_model(cfg, remat=False, device=args.device)
    A = args.agents or data

    p2p = _p2p(args, A)

    params = bundle.init_agents(A, args.seed)
    start_step = 0
    if args.resume and args.checkpoint_dir:
        try:
            params, start_step, _ = load_checkpoint(args.checkpoint_dir, params)
            print(f"resumed from step {start_step}")
        except FileNotFoundError:
            pass

    # A is the stacked axis: the step is built for the agents it holds.
    step_fn, eps_step, noise_scale = spmd.make_train_step(
        bundle, p2p, A, args.batch, alpha=args.alpha, gossip=args.gossip
    )
    generator = torch.Generator(device=bundle.device).manual_seed(args.seed)

    # Heterogeneous per-agent token streams (personalization signal).
    batches = _batches(args, cfg, A, bundle.device)
    t0 = time.time()
    history = []
    for step in range(start_step, args.steps):
        params, metrics = step_fn(params, next(batches), generator)
        _log(args, step, metrics, t0, history)
        if args.checkpoint_dir and (step + 1) % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint_dir, params, step=step + 1,
                            extra={"eps_step": eps_step},
                            keep_last=args.keep_last)
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, params, step=args.steps,
                        extra={"eps_step": eps_step, "noise_scale": noise_scale},
                        keep_last=args.keep_last)
    if args.eps > 0:
        from repro_torch.core.privacy import compose_kairouz

        spent = compose_kairouz(np.full(args.steps - start_step, eps_step), p2p.delta_bar)
        print(f"DP: per-step eps={eps_step:.4f}, composed eps over run={spent:.3f} "
              f"(budget {p2p.eps_bar})")
    return history


if __name__ == "__main__":
    main()

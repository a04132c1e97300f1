"""§Perf hill-climb driver: named variants of the selected (arch x shape)
pairs through the dry-run, one row each appended to
``results/perf_iterations_torch.jsonl``.

Port of ``repro/launch/hillclimb.py``: the same pairs and variants, each a
``launch.dryrun.run_one`` on the 16x16 mesh (fake process group, FakeTensors)
with the variant's options; ``repeat_kv`` goes to
``attention.set_repeat_kv_cache``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --pair llama
"""

from __future__ import annotations

import argparse
import json

from repro_torch.launch.dryrun import run_one

PAIRS = {
    # Most representative of the paper's technique: full P2P-DP round,
    # 16 personal models, ppermute gossip.
    "llama": ("llama3.2-1b", "train_4k"),
    # Most collective-bound baseline.
    "qwen": ("qwen2.5-14b", "train_4k"),
    # Worst roofline fraction: MoE with 512-wide experts — dispatch
    # machinery dwarfs the expert GEMMs.
    "moe": ("granite-moe-3b-a800m", "train_4k"),
    # Decode is all-gather-bound (the seq-sharded GQA cache gets gathered
    # for attention).
    "decode": ("llama3.2-1b", "decode_32k"),
}

VARIANTS = {
    "llama": [
        ("baseline", {}),
        # H1: dense gossip all-gathers every agent's parameters; the
        # circulant ring shift should move ~A/k x fewer bytes.
        ("gossip_dense", dict(gossip="dense")),
        # H2: Megatron sequence-parallel residual.
        ("seq_parallel", dict(seq_parallel=True)),
        # H3: DP off isolates the cost of the privacy machinery.
        ("no_dp", dict(dp_on=False)),
        # Iter 2: drop remat — trades memory capacity for fewer reads.
        ("seqpar_noremat", dict(seq_parallel=True, remat=False)),
    ],
    "qwen": [
        ("baseline", {}),
        ("seq_parallel", dict(seq_parallel=True)),
        # H: gossip off isolates the P2P exchange's share of the collectives.
        ("no_p2p", dict(p2p_on=False)),
        ("seqpar_noremat", dict(seq_parallel=True, remat=False)),
    ],
    "decode": [
        ("baseline", {}),
        # H: pre-repeat KV in the cache so the head dim divides the model
        # axis -> per-shard attention, no cache all-gather; 4x cache bytes.
        ("repeat_kv_cache", dict(repeat_kv=True)),
    ],
    "moe": [
        ("baseline", {}),
        # H1: bigger dispatch groups + cf 1.0 cut the one-hot dispatch tensors.
        ("gs512_cf1", dict(moe_overrides=dict(group_size=512, capacity_factor=1.0))),
        # H2: seq-parallel on top.
        ("gs512_cf1_seqpar", dict(moe_overrides=dict(group_size=512, capacity_factor=1.0),
                                  seq_parallel=True)),
    ],
}


def run_pair(pair: str, variant=None, out="results/perf_iterations_torch.jsonl", **run_kw):
    """Run ``pair``'s variants (or the one named ``variant``), append each
    row to ``out`` (None: no file) and return the rows. ``run_kw`` goes to
    every ``run_one`` (the tests' reduced ``cfg`` and mesh)."""
    from repro_torch.models.attention import set_repeat_kv_cache

    arch, shape = PAIRS[pair]
    rows = []
    for name, kw in VARIANTS[pair]:
        if variant and name != variant:
            continue
        kw = dict(kw)
        set_repeat_kv_cache(kw.pop("repeat_kv", False))
        try:
            row = run_one(arch, shape, multi_pod=False, variant=f"{pair}:{name}",
                          verbose=False, **kw, **run_kw)
        finally:
            set_repeat_kv_cache(False)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        print(f"[{pair}:{name}] compute={row['compute_s']:.3f} "
              f"memory={row['memory_s']:.3f} collective={row['collective_s']:.3f} "
              f"dominant={row['dominant']} trace_s={row['trace_s']}", flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb")
    ap.add_argument("--pair", choices=list(PAIRS), required=True)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default="results/perf_iterations_torch.jsonl")
    args = ap.parse_args(argv)
    run_pair(args.pair, args.variant, args.out)


if __name__ == "__main__":
    main()

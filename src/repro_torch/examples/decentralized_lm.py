"""End-to-end example: train a small llama3.2-1b-family transformer with the
paper's P2P-DP update (the port).

Port of ``examples/decentralized_lm.py``: personal models per agent,
Laplace-perturbed local gradients, ring gossip, through the training
launcher (:mod:`repro_torch.launch.train`) on the launcher's ``small``
preset (2 layers, d_model 256, vocab 2048) or, with ``--hundred-m``, its
~100M-parameter widening (8 layers, d_model 768, vocab 32768). As in the
reference, the mesh is 1x1, so one agent trains; each agent's token
stream has its own unigram distribution (``token_stream``). Checkpoints
go to ``results/decentralized_lm_ckpt`` under the working directory.

    python -m repro_torch.examples.decentralized_lm [--hundred-m] [--steps N] \\
        [--eps EPS] [--device D]
"""

import argparse

from repro_torch.configs import get_reduced
from repro_torch.launch import train as train_mod


def _build_100m(args):
    return get_reduced("llama3.2-1b", num_layers=8, d_model=768, num_heads=12, num_kv_heads=4,
                       d_ff=3072, vocab_size=32768, head_dim=64, dtype="float32")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--eps", type=float, default=0.0, help="DP budget (0 = off)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    args = ap.parse_args(argv)

    steps = args.steps or (200 if args.hundred_m else 60)
    train_argv = ["--arch", "llama3.2-1b", "--preset", "small", "--steps", str(steps),
                  "--batch", "2", "--seq", "129", "--mu", "0.5", "--alpha", "0.9",
                  "--mesh", "1x1", "--device", args.device]
    if args.eps > 0:
        train_argv += ["--eps", str(args.eps)]
    train_argv += ["--checkpoint-dir", "results/decentralized_lm_ckpt"]
    build = train_mod.build
    if args.hundred_m:
        train_mod.build = _build_100m  # the reference widens the preset the same way
    try:
        history = train_mod.main(train_argv)
    finally:
        train_mod.build = build
    first, last = history[0]["loss"], history[-1]["loss"]
    improved = last < first
    print(f"loss {first:.3f} -> {last:.3f} ({'improved' if improved else 'NO DESCENT'})")
    return dict(first_loss=first, last_loss=last, improved=improved, steps=steps,
                history=history)


if __name__ == "__main__":
    main()

"""Table-1 experiment on the port: private P2P recommendation on the MovieLens-100K twin.

Port of ``examples/movielens_recommendation.py``, through
:mod:`repro_torch.bench.movielens`. Each user keeps their ratings on the
device; collaboration happens only through DP-perturbed model broadcasts
over a 10-NN similarity graph. The default is the runner's fast size
(150 users); ``--full`` takes all 943.

    python -m repro_torch.examples.movielens_recommendation [--full] [--device D]
"""

import argparse

from repro_torch.bench import movielens


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="all 943 users")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    args = ap.parse_args(argv)
    return movielens.run(fast=not args.full, device=args.device)


if __name__ == "__main__":
    main()

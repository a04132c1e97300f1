"""Full Sec.-5.1 experiment on the port: CD vs ADMM (Fig. 1) + privacy sweep (Figs. 2-4).

Port of ``examples/p2p_linear_classification.py``, through the port's
runners (:mod:`repro_torch.bench.cd_vs_admm`,
:mod:`repro_torch.bench.privacy_utility`). The default uses n = 30
agents and p = 20 dims; ``--full`` matches the paper (n = 100, p = 100).

    python -m repro_torch.examples.p2p_linear_classification [--full] [--device D]
"""

import argparse

from repro_torch.bench import cd_vs_admm, privacy_utility


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", help="'cuda' (default), 'cuda:<i>' or 'cpu'")
    args = ap.parse_args(argv)

    print("=== Fig. 1: coordinate descent vs gossip ADMM ===")
    if args.full:
        fig1 = cd_vs_admm.run(device=args.device)
    else:
        fig1 = cd_vs_admm.run(n=30, p=20, T_cd=800, T_admm=80, device=args.device)

    print("\n=== Fig. 2-4: privacy/utility trade-off ===")
    fig2 = privacy_utility.run(fast=not args.full, device=args.device)
    return {"fig1": fig1, "fig2": fig2}


if __name__ == "__main__":
    main()

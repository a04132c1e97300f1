"""Sparse-graph scale bench on the port: CD ticks where a dense W cannot exist.

Port of ``benchmarks/bench_sparse_scale.py``. At n = 100,000 agents a
dense float64 weight matrix is 80 GB, while the CSR neighbour lists at
average degree ~16 are a few MB. The bench builds a random geometric CSR
graph, attaches the reference's synthetic quadratic objective
(:func:`_make_problem`, the runners' one problem builder), asserts that
nothing holds an (n, n) array and drives Eq. 4 coordinate-descent ticks
(``run_scan``) on the device. Rows, under the reference's names:

* ``sparse_graph_build``: host seconds of the problem, us per agent;
* ``sparse_cd_tick``: us per sequential tick;
* ``dense_sparse_parity_512``: :func:`parity_check`, the largest
  disagreement of the dense and sparse ``MixOp`` at n = 512 (on the card
  ``MixOp.all`` runs ``graph_mix`` and ``sparse_mix`` at R = n).

    python -m repro_torch.bench.sparse_scale [--n 100000] [--ticks 2000] [--device D] [--fast] [--out PATH]

``--fast`` is the reference runner's fast size (n = 5,000, 200 ticks).
The rows merge into ``results/BENCH_torch_summary.json`` under
``sparse_scale``.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.bench import parser, write_row


def _make_problem(n: int, p: int, m: int, rng: np.random.Generator):
    """Quadratic objective over a random geometric CSR graph; O(n) memory.
    The reference's arrays from the same ``rng`` (numpy in both)."""
    from repro_torch.core import AgentData, make_objective, random_geometric_graph

    graph = random_geometric_graph(n, rng, avg_degree=16.0)
    targets = rng.normal(size=(n, p)) / np.sqrt(p)
    X = rng.normal(size=(n, m, p)) / np.sqrt(p)
    y = np.einsum("nmp,np->nm", X, targets)
    data = AgentData(X=X, y=y, mask=np.ones((n, m)))
    return graph, make_objective(graph, data, "quadratic", mu=0.5, mix_mode="sparse")


def leak_check(n: int, arrays) -> None:
    """No (n, n) array anywhere: every array below the reference's floor
    (1% of n^2, at least 64 n + 256 so tiny debug sizes do not fire)."""
    leak_floor = max(n * n // 100, 64 * n + 256)
    for arr in arrays:
        assert arr is None or arr.size < leak_floor, "an O(n^2) array leaked in"


def parity_check(n: int = 512, seed: int = 0, tol: float = 1e-5, device="cuda") -> float:
    """Max-abs dense/sparse disagreement of the mix operator on n agents,
    float32 on ``device`` (the reference's graph and Theta)."""
    import torch

    from repro_torch.core import knn_cosine_graph, mix_op
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    graph = knn_cosine_graph(rng.normal(size=(n, 16)), k=10)
    Theta = torch.as_tensor(rng.normal(size=(n, 32)), dtype=torch.float32, device=dev)
    dense = mix_op(graph, mode="dense")
    sparse = mix_op(graph, mode="sparse")
    err_all = float((dense.all(Theta) - sparse.all(Theta)).abs().max())
    err_row = max(
        float((dense.row(Theta, i) - sparse.row(Theta, i)).abs().max())
        for i in range(0, n, max(n // 16, 1))
    )
    err = max(err_all, err_row)
    assert err <= tol, f"dense/sparse mixing disagree: {err} > {tol}"
    return err


def run(n: int = 100_000, p: int = 8, m: int = 4, ticks: int = 2_000, seed: int = 0,
        device="cuda", verbose: bool = True, out=None):
    """Returns the ``(name, value, note)`` rows (merged into ``out`` when given)."""
    from repro_torch.core import run_scan
    from repro_torch.core.mixing import MixOp

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    graph, obj = _make_problem(n, p, m, rng)
    build_s = time.perf_counter() - t0
    deg = np.diff(graph.indptr)
    assert deg.mean() <= 32.0, f"avg degree {deg.mean():.1f} exceeds bench spec"

    mix = obj.mix
    assert isinstance(mix, MixOp) and mix.kind == "sparse"
    leak_check(n, (mix.idx, mix.w, mix.rows, mix.cols, mix.vals, graph.indices, graph.data))

    t0 = time.perf_counter()
    res = run_scan(obj, np.zeros((n, p)), T=ticks, rng=rng, record_objective=False,
                   device=device)
    tick_s = time.perf_counter() - t0
    assert np.isfinite(res.Theta).all()

    rows = [
        ("sparse_graph_build", build_s * 1e6 / max(n, 1), f"n={n} deg~{deg.mean():.1f} us/agent"),
        ("sparse_cd_tick", tick_s * 1e6 / ticks, f"n={n} {ticks} ticks us/tick"),
        ("dense_sparse_parity_512", parity_check(device=device), "max-abs, tol 1e-5"),
    ]
    if verbose:
        for name, v, note in rows:
            print(f"{name},{v:.3g},{note}")
    if out is not None:
        write_row(out, "sparse_scale", {"n": n, "ticks": ticks, "device": str(device),
                                        "rows": [[k, float(v), note] for k, v, note in rows]})
    return rows


def main(argv=None):
    """CLI entry point."""
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--ticks", type=int, default=2_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    n, ticks = (5_000, 200) if args.fast else (args.n, args.ticks)
    run(n=n, ticks=ticks, seed=args.seed, device=args.device, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

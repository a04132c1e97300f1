"""repro_torch.data.movielens and the Table 1 runner against the reference.

The twin is numpy only and copied, so the same arguments give the same
arrays: train and test data, the graph's weights, the ALS item features
and the user means are asserted equal, and ``rmse`` gives the same value.
The Table 1 runner (``repro_torch.bench.movielens``) at a tiny size
against ``benchmarks/bench_movielens.run``: the local ridge RMSE is numpy
on both sides and equal; the non-private CD runs in float32 on both
sides from the same wake sequence, so ``rmse_cd`` agrees to 1e-5
relative and the tuned mu is the same. The private rows draw noise from
each package's own stream, so they are checked by range only.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.data import movielens as jml
from repro_torch.bench import movielens as bench
from repro_torch.data import movielens as tml

TOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
TWIN = dict(n_users=120, n_items=300, p=8, rank=8, als_iters=5, seed=23)


def _reference_bench():
    path = ROOT / "benchmarks" / "bench_movielens.py"
    spec = importlib.util.spec_from_file_location("bench_movielens", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def twins():
    return jml.movielens_twin(**TWIN), tml.movielens_twin(**TWIN)


def test_twin_equals_reference_array_for_array(twins):
    a, b = twins
    for part in ("train", "test"):
        for field in ("X", "y", "mask"):
            np.testing.assert_array_equal(getattr(getattr(b, part), field),
                                          getattr(getattr(a, part), field))
    np.testing.assert_array_equal(b.graph.weights, a.graph.weights)
    np.testing.assert_array_equal(b.item_features, a.item_features)
    np.testing.assert_array_equal(b.user_means, a.user_means)


@pytest.mark.parametrize("seed", [0, 1])
def test_rmse_equals_reference(twins, seed):
    a, b = twins
    Theta = np.random.default_rng(seed).normal(size=(TWIN["n_users"], TWIN["p"]))
    assert tml.rmse(Theta, b.test) == jml.rmse(Theta, a.test)
    assert tml.rmse(Theta, b.train) == jml.rmse(Theta, a.train)


def test_sample_counts_and_als_equal_reference():
    counts = [m._sample_counts(500, np.random.default_rng(4)) for m in (jml, tml)]
    np.testing.assert_array_equal(counts[1], counts[0])
    assert counts[1].min() >= 20 and counts[1].max() <= 737
    rng = np.random.default_rng(5)
    ratings = [{int(j): float(rng.normal()) for j in rng.choice(30, size=6, replace=False)}
               for _ in range(12)]
    U0, V0 = jml._als(ratings, 30, 4, 3, 0.05, np.random.default_rng(6))
    U1, V1 = tml._als(ratings, 30, 4, 3, 0.05, np.random.default_rng(6))
    np.testing.assert_array_equal(U1, U0)
    np.testing.assert_array_equal(V1, V0)


def test_movielens_twin_statistics(twins):
    _, tw = twins
    m = tw.train.num_examples
    assert m.min() >= 15  # 80% of >= 20
    assert tw.graph.is_connected() or tw.graph.num_edges() > 0
    # ALS features allow a linear fit much better than predicting 0 (= user mean).
    base = tml.rmse(np.zeros((120, 8)), tw.test)
    theta = np.zeros((120, 8))
    for u in range(120):
        Xu = tw.train.X[u][tw.train.mask[u] > 0]
        yu = tw.train.y[u][tw.train.mask[u] > 0]
        theta[u] = np.linalg.solve(Xu.T @ Xu + 0.1 * np.eye(8), Xu.T @ yu)
    assert tml.rmse(theta, tw.test) < base


def test_table1_runner_matches_reference_bench(tmp_path):
    kw = dict(n_users=40, n_items=120, p=5, ticks_per_user=5, verbose=False)
    a = _reference_bench().run(**kw)
    b = bench.run(device="cpu", out=tmp_path / "summary.json", **kw)
    assert set(a) <= set(b)
    assert b["rmse_local"] == a["rmse_local"]
    assert b["mu"] == a["mu"]
    assert abs(b["rmse_cd"] - a["rmse_cd"]) <= TOL * a["rmse_cd"]
    assert b["rmse_cd"] < b["rmse_local"]
    for eps in (1.0, 0.5, 0.1):  # another random stream: by range only
        assert np.isfinite(b[f"rmse_eps_{eps}"]) and 0.5 < b[f"rmse_eps_{eps}"] < 10.0
        assert b[f"ticks_eps_{eps}"] in (3, 8, 20)
    assert b["derived"] == f"rmse_local={b['rmse_local']:.3f},rmse_cd={b['rmse_cd']:.3f}"


def test_table1_helpers_equal_reference(twins):
    ref = _reference_bench()
    a, b = twins
    lambdas = 1.0 / np.maximum(b.train.num_examples, 1.0)
    np.testing.assert_array_equal(bench._local_ridge(b.train, lambdas),
                                  ref._local_ridge(a.train, lambdas))
    for got, want in zip(bench._val_split(b, 3), ref._val_split(a, 3)):
        np.testing.assert_array_equal(got.mask, want.mask)

"""The frozen input generators: deterministic by seed, and the graph an RGG
of mean degree about 16."""

import numpy as np
import torch

from perfbench.data import agents
from perfbench.data.rgg import relabel_csr, rgg_csr


def _graph(seed, n=20000):
    return rgg_csr(n, 16.0, agents.generator(seed, "cpu"))


def test_rgg_deterministic_by_seed():
    a, b, c = _graph(3), _graph(3), _graph(4)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])


def test_rgg_degree_and_shape():
    n = 20000
    indptr, indices, data = _graph(5, n)
    deg = np.diff(indptr)
    # E[deg] = 16 less the border's share: about 15.8 at n = 20,000.
    assert abs(deg.mean() - 16.0) < 0.5, deg.mean()
    assert deg.min() >= 1  # isolated agents get their nearest peer
    rows = np.repeat(np.arange(n), deg)
    assert not np.any(rows == indices)  # no self loops
    assert np.all(np.diff(rows * n + indices) > 0)  # CSR order, no duplicates
    fwd = set(zip(rows.tolist(), indices.tolist()))
    assert all((j, i) in fwd for i, j in list(fwd)[:5000])  # both directions stored
    assert np.all(data == 1.0)


def test_rgg_isolated_agent_linked_to_nearest():
    # At n = 50 and degree 0.5 most agents have no radius neighbour.
    indptr, indices, _ = rgg_csr(50, 0.5, agents.generator(1, "cpu"))
    assert np.diff(indptr).min() >= 1


def test_relabel_keeps_the_degrees():
    indptr, indices, _ = _graph(7, 5000)
    perm = np.random.default_rng(0).permutation(5000)
    ip2, ix2, _ = relabel_csr(indptr, indices, perm)
    deg, deg2 = np.diff(indptr), np.diff(ip2)
    assert np.array_equal(deg2[perm], deg)
    assert len(ix2) == len(indices)


def test_agent_data_deterministic_and_noise_free():
    X, y = agents.agent_data(64, 8, 100, agents.generator(9, "cpu"))
    X2, y2 = agents.agent_data(64, 8, 100, agents.generator(9, "cpu"))
    assert torch.equal(X, X2) and torch.equal(y, y2)
    assert X.shape == (64, 8, 100) and y.shape == (64, 8) and X.dtype == torch.float32
    assert abs(float((X * X).sum(-1).mean()) - 1.0) < 0.05  # x ~ N(0, I / p)


def test_stream_seeds_large_seed():
    s = agents.stream_seeds(2**31 + 12345)
    assert s == agents.stream_seeds(2**31 + 12345)
    assert len(set(s.values())) == len(s) and all(0 <= v < 2**63 for v in s.values())
    assert s != agents.stream_seeds(2**31 + 12346)


def test_padded_delays_align_with_csr():
    indptr = np.array([0, 2, 5, 6])
    d = np.array([1, 2, 0, 1, 2, 2])
    out = agents.padded_delays(indptr, d)
    assert out.tolist() == [[1, 2, 0], [0, 1, 2], [2, 0, 0]]

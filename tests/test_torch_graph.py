"""repro_torch.core.graph against repro.core.graph: every builder gives
bit-equal arrays under the same numpy seed (graph construction is numpy
host code in both packages, so the tolerance is exact)."""

import numpy as np
import pytest

import repro.core.graph as ref
import repro_torch.core.graph as port


def _assert_same_graph(a, b):
    assert type(a).__name__ == type(b).__name__
    if isinstance(b, ref.CSRGraph):
        for name in ("indptr", "indices", "data"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert a.digest() == b.digest()
    else:
        assert np.array_equal(a.weights, b.weights)
    assert np.array_equal(a.degrees, b.degrees)
    assert a.max_degree() == b.max_degree() and a.num_edges() == b.num_edges()
    assert a.is_connected() == b.is_connected()


BUILDERS = {
    "angular": lambda g, rng: g.angular_similarity_graph(rng.normal(size=(40, 5)), gamma=0.3),
    "knn_cosine_dense": lambda g, rng: g.knn_cosine_graph(rng.normal(size=(60, 6)), k=5),
    "knn_cosine_sparse": lambda g, rng: g.knn_cosine_graph(
        rng.normal(size=(60, 6)), k=5, sparse=True, block_rows=7
    ),
    "knn_graph": lambda g, rng: g.knn_graph(rng.normal(size=(90, 6)), k=7, block_rows=16),
    "knn_graph_k_clamped": lambda g, rng: g.knn_graph(rng.normal(size=(5, 3)), k=10),
    "ring": lambda g, rng: g.ring_graph(9, weight=0.5),
    "circulant": lambda g, rng: g.circulant_graph(12, (1, 3, 12), weights=(1.0, 0.25, 2.0)),
    "erdos_renyi": lambda g, rng: g.erdos_renyi_graph(20, 0.3, rng),
    "complete": lambda g, rng: g.complete_graph(7, weight=2.0),
    "rgg": lambda g, rng: g.random_geometric_graph(500, rng, avg_degree=8.0),
    "rgg_radius": lambda g, rng: g.random_geometric_graph(300, rng, radius=0.05, min_degree=2),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_bit_equal(name):
    build = BUILDERS[name]
    a = build(port, np.random.default_rng(3))
    b = build(ref, np.random.default_rng(3))
    _assert_same_graph(a, b)


def test_rgg_positions_bit_equal():
    a, pa = port.random_geometric_graph(400, np.random.default_rng(1), return_pos=True)
    b, pb = ref.random_geometric_graph(400, np.random.default_rng(1), return_pos=True)
    _assert_same_graph(a, b)
    assert np.array_equal(pa, pb)


@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("dedupe", ["max", "sum"])
def test_csr_from_coo_bit_equal(symmetrize, dedupe):
    rng = np.random.default_rng(5)
    n = 30
    rows = rng.integers(0, n, 200)
    cols = rng.integers(0, n, 200)
    vals = rng.random(200)
    if not symmetrize:  # a symmetric triple set with duplicates
        rows, cols, vals = np.r_[rows, cols], np.r_[cols, rows], np.r_[vals, vals]
    a = port.csr_from_coo(n, rows, cols, vals, symmetrize=symmetrize, dedupe=dedupe)
    b = ref.csr_from_coo(n, rows, cols, vals, symmetrize=symmetrize, dedupe=dedupe)
    _assert_same_graph(a, b)


@pytest.mark.parametrize("pad_to", [None, 40])
def test_padded_neighbors_and_views_bit_equal(pad_to):
    rng = np.random.default_rng(2)
    a = port.random_geometric_graph(300, rng, avg_degree=10.0)
    b = ref.random_geometric_graph(300, np.random.default_rng(2), avg_degree=10.0)
    ia, wa = a.padded_neighbors(pad_to=pad_to)
    ib, wb = b.padded_neighbors(pad_to=pad_to)
    assert ia.dtype == ib.dtype and np.array_equal(ia, ib)
    assert np.array_equal(wa, wb)
    assert np.array_equal(port.neighbor_counts(a), ref.neighbor_counts(b))
    assert np.array_equal(port.dense_weights(a), ref.dense_weights(b))
    assert np.array_equal(a.row_ids(), b.row_ids())
    for x, y in zip(a.edge_list(), b.edge_list()):
        assert np.array_equal(x, y)
    dense_a, dense_b = port.as_dense(a), ref.as_dense(b)
    assert np.array_equal(dense_a.laplacian(), dense_b.laplacian())
    _assert_same_graph(port.as_csr(dense_a), ref.as_csr(dense_b))
    with pytest.raises(ValueError, match="pad_to"):
        a.padded_neighbors(pad_to=1)


def test_digest_tracks_contents():
    a = port.ring_graph(6).to_csr()
    b = port.csr_from_coo(6, a.row_ids(), a.indices, a.data * 2.0)
    assert a.digest() == ref.ring_graph(6).to_csr().digest()
    assert a.digest() != b.digest()


def test_confidences_and_knobs(monkeypatch):
    m = np.array([0, 3, 10, 5])
    assert np.array_equal(port.confidences(m), ref.confidences(m))
    assert np.array_equal(port.confidences(np.zeros(3)), ref.confidences(np.zeros(3)))
    monkeypatch.setenv("REPRO_SPARSE_CROSSOVER", "77")
    assert port.sparse_crossover() == ref.sparse_crossover() == 77
    monkeypatch.setenv("REPRO_SPARSE_CROSSOVER", "many")
    with pytest.raises(ValueError, match="integer"):
        port.sparse_crossover()
    assert port.int_env_knob("REPRO_TORCH_UNSET_KNOB", 5) == 5


def test_invalid_graphs_rejected():
    with pytest.raises(ValueError, match="symmetric"):
        port.AgentGraph(np.array([[0.0, 1.0], [0.0, 0.0]]))
    with pytest.raises(ValueError, match="diagonal"):
        port.AgentGraph(np.eye(2))
    with pytest.raises(ValueError, match="symmetric"):
        port.CSRGraph(indptr=np.array([0, 1, 1]), indices=np.array([1], np.int32),
                      data=np.array([1.0]))

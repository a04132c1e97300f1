"""Property tests (hypothesis) of the port's ``TopologyState`` against the
reference's, the counterpart of ``tests/test_topology_properties.py``.

Any random insert/delete batch through the host path
(``apply_edge_updates``) gives the reference's slot arrays and keeps the
CSR invariants, and inserting novel edges then deleting them returns the
original edge set with the version advanced by two. Random batches
through the torch edge mutators (no row repeated within an activation
batch, the mutators' contract) give the reference's slots as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="hypothesis not installed (see requirements-dev.txt)")
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.graph import TopologyState as JTopologyState
from repro.core.graph import csr_from_coo as jcsr_from_coo
from repro_torch.core.graph import TopologyState, csr_from_coo


def _base_coo(n: int, seed: int):
    """A ring plus random chords (the reference test's base graph)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n, dtype=np.int64)
    cols = (rows + 1) % n
    vals = rng.uniform(0.1, 1.0, size=n)
    extra = max(n // 2, 1)
    er, ec = rng.integers(0, n, size=extra), rng.integers(0, n, size=extra)
    ev = rng.uniform(0.1, 1.0, size=extra)
    keep = er != ec
    return (np.concatenate([rows, er[keep]]), np.concatenate([cols, ec[keep]]),
            np.concatenate([vals, ev[keep]]))


def _pair(n, seed):
    coo = _base_coo(n, seed)
    return (TopologyState.from_csr(csr_from_coo(n, *coo, symmetrize=True)),
            JTopologyState.from_csr(jcsr_from_coo(n, *coo, symmetrize=True)))


def _edge_dict(csr):
    return {(int(i), int(j)): float(v) for i, j, v in zip(csr.row_ids(), csr.indices, csr.data)}


def _assert_invariants(csr):
    assert csr.indptr[0] == 0 and csr.indptr[-1] == len(csr.indices)
    rows = csr.row_ids()
    for i in range(csr.n):
        nb = csr.indices[csr.indptr[i]: csr.indptr[i + 1]]
        assert (np.diff(nb) > 0).all(), f"row {i} columns not sorted-unique"
    assert not np.any(csr.indices == rows) and (csr.data > 0.0).all()
    edges = _edge_dict(csr)
    for (i, j), v in edges.items():
        assert edges.get((j, i)) == v, (i, j)


def _assert_same(t, j):
    for leaf in ("nbr", "w", "valid", "version"):
        a, b = getattr(t, leaf), np.asarray(getattr(j, leaf))
        a = a.numpy() if hasattr(a, "numpy") and not isinstance(a, np.ndarray) else np.asarray(a)
        np.testing.assert_array_equal(a, b, err_msg=leaf)


churn_params = st.tuples(
    st.integers(min_value=3, max_value=20),  # n
    st.integers(min_value=0, max_value=2**31 - 1),  # seed
    st.integers(min_value=1, max_value=12),  # batch size
)


@settings(max_examples=30, deadline=None)
@given(churn_params)
def test_random_insert_delete_batches_match_reference(params):
    n, seed, b = params
    topo, jtopo = _pair(n, seed)
    rng = np.random.default_rng(seed ^ 0x5EED)
    for _ in range(3):
        ar, ac = rng.integers(0, n, size=b), rng.integers(0, n, size=b)
        av = rng.uniform(0.05, 2.0, size=b)
        ok = ar != ac
        kw = dict(add_rows=ar[ok], add_cols=ac[ok], add_vals=av[ok])
        topo, jtopo = topo.apply_edge_updates(**kw), jtopo.apply_edge_updates(**kw)
        _assert_same(topo, jtopo)
        _assert_invariants(topo.to_csr())
        edges = sorted(_edge_dict(topo.to_csr()))
        if edges:
            picks = rng.integers(0, len(edges), size=min(b, len(edges)))
            rr = np.array([edges[k][0] for k in picks])
            rc = np.array([edges[k][1] for k in picks])
            topo = topo.apply_edge_updates(remove_rows=rr, remove_cols=rc)
            jtopo = jtopo.apply_edge_updates(remove_rows=rr, remove_cols=rc)
            _assert_same(topo, jtopo)
            _assert_invariants(topo.to_csr())


@settings(max_examples=30, deadline=None)
@given(churn_params)
def test_topology_state_insert_then_delete_round_trips(params):
    """apply_edge_updates(add) then apply_edge_updates(remove) of the same
    novel pairs returns exactly the original edge set (weights included),
    with the version advanced by two, as the reference's does."""
    n, seed, b = params
    topo, jtopo = _pair(n, seed)
    csr = topo.to_csr()
    before = _edge_dict(csr)
    rng = np.random.default_rng(seed ^ 0xC0FFEE)
    cand_r, cand_c = rng.integers(0, n, size=4 * b), rng.integers(0, n, size=4 * b)
    novel, seen = [], set()
    for i, j in zip(cand_r, cand_c):
        key = tuple(sorted((int(i), int(j))))
        if i != j and key not in before and key not in seen:
            novel.append(key)
            seen.add(key)
        if len(novel) == b:
            break
    if not novel:
        return
    ar, ac = np.array([i for i, _ in novel]), np.array([j for _, j in novel])
    av = rng.uniform(0.1, 1.0, size=len(novel))
    grown = topo.apply_edge_updates(add_rows=ar, add_cols=ac, add_vals=av)
    _assert_same(grown, jtopo.apply_edge_updates(add_rows=ar, add_cols=ac, add_vals=av))
    _assert_invariants(grown.to_csr())
    assert grown.to_csr().num_edges() == csr.num_edges() + len(novel)
    shrunk = grown.apply_edge_updates(remove_rows=ar, remove_cols=ac)
    assert _edge_dict(shrunk.to_csr()) == before
    assert int(np.asarray(shrunk.version)) == 2


@settings(max_examples=30, deadline=None)
@given(churn_params)
def test_torch_mutators_match_reference_on_random_batches(params):
    """Random deactivate / activate / reweight batches (each row at most
    once a batch, both directions counted) through the torch mutators give
    the reference's slots, and the result stays a valid symmetric CSR."""
    n, seed, b = params
    topo, jtopo = _pair(n, seed)
    topo, jtopo = (TopologyState.from_csr(topo.to_csr(), slack=2),
                   JTopologyState.from_csr(jtopo.to_csr(), slack=2))
    rng = np.random.default_rng(seed ^ 0xBEEF)
    for _ in range(3):
        perm = rng.permutation(n)
        k = min(b, n // 2)
        rows, cols = perm[:k], perm[k: 2 * k]
        vals = rng.uniform(0.1, 2.0, size=k)
        for name, args in (("deactivate_edges", (rows[: k // 2], cols[: k // 2])),
                           ("activate_edges", (rows, cols, vals)),
                           ("with_edge_weights", (cols, rows, vals[::-1].copy()))):
            topo = getattr(topo, name)(*args)
            jtopo = getattr(jtopo, name)(*(jnp.asarray(a) for a in args))
            _assert_same(topo, jtopo)
        _assert_invariants(topo.to_csr())

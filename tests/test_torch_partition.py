"""repro_torch.sim.partition against repro.sim.partition, and the
partitioner's own properties held on the port.

The module is numpy in both packages, so every array of a
``GraphPartition`` (ownership, halo and border maps, tiles, the p2p plan)
must equal the reference's entry for entry on the same graph. The
property tests of ``tests/test_partition.py`` run again on the port:
halo round trips, tiles that reproduce the global neighbour sum (to
1e-13, float64), the locality relabels' halo fractions.
"""

import numpy as np
import pytest

import repro.sim as jsim
from repro.core import as_csr as ref_as_csr
from repro.core import erdos_renyi_graph as ref_er
from repro.core import knn_graph as ref_knn
from repro.core import ring_graph as ref_ring
from repro_torch.core import CSRGraph, csr_from_coo, random_geometric_graph
from repro_torch.core.mixing import sharded_mix_op
from repro_torch.sim import (
    hilbert_order,
    partition_graph,
    point_to_point_plan,
    rcm_order,
    sfc_order,
)
from repro_torch.sim.partition import partition_from_ownership

ARRAYS = ("order", "bounds", "owned", "sizes", "shard_of", "local_of", "halo", "halo_sizes",
          "halo_owner", "border", "border_sizes", "halo_src", "idx", "w")


def _port_csr(ref):
    """The port's CSRGraph with the reference graph's arrays."""
    return CSRGraph(indptr=np.asarray(ref.indptr), indices=np.asarray(ref.indices),
                    data=np.asarray(ref.data))


def _graphs():
    """The graphs of tests/test_partition.py, as (name, reference CSR, port CSR, coords)."""
    rng = np.random.default_rng(0)
    for name, g in (("knn", ref_knn(rng.normal(size=(57, 6)), k=5)),
                    ("er", ref_as_csr(ref_er(40, 0.15, rng))),
                    ("ring", ref_as_csr(ref_ring(12, weight=0.5)))):
        yield name, g, _port_csr(g), np.random.default_rng(len(name)).random((g.n, 2))


def _assert_same_partition(port, ref, label):
    for key in ARRAYS:
        np.testing.assert_array_equal(getattr(port, key), np.asarray(getattr(ref, key)),
                                      err_msg=f"{label}: {key}")
        assert getattr(port, key).dtype == np.asarray(getattr(ref, key)).dtype, (label, key)
    assert (port.num_shards, port.mode, port.relabel) == (ref.num_shards, ref.mode, ref.relabel)
    p_off, p_snd, p_dst = port.p2p_plan
    r_off, r_snd, r_dst = ref.p2p_plan
    assert p_off == r_off, label
    for a, b in zip(p_snd + p_dst, r_snd + r_dst):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=label)
    for method in ("all_gather", "p2p"):
        assert port.exchange_rows(method) == ref.exchange_rows(method), (label, method)
    assert port.halo_fraction() == ref.halo_fraction(), label


@pytest.mark.parametrize("relabel", [None, "rcm", "sfc", "hilbert"])
@pytest.mark.parametrize("mode", ["contiguous", "degree"])
def test_partition_arrays_equal_reference(mode, relabel):
    for name, ref_g, port_g, coords in _graphs():
        for S in (1, 2, 3, 5):
            kw = dict(mode=mode, relabel=relabel,
                      coords=coords if relabel in ("sfc", "hilbert") else None)
            _assert_same_partition(partition_graph(port_g, S, **kw),
                                   jsim.partition_graph(ref_g, S, **kw),
                                   f"{name} S={S} {mode} {relabel}")


def test_explicit_permutation_orders_and_rebuild_equal_reference():
    for name, ref_g, port_g, coords in _graphs():
        shuffle = np.random.default_rng(3).permutation(port_g.n)
        port = partition_graph(port_g, 4, relabel=shuffle)
        ref = jsim.partition_graph(ref_g, 4, relabel=shuffle)
        _assert_same_partition(port, ref, f"{name} custom")
        np.testing.assert_array_equal(rcm_order(port_g), jsim.rcm_order(ref_g))
        np.testing.assert_array_equal(sfc_order(coords), jsim.sfc_order(coords))
        np.testing.assert_array_equal(hilbert_order(coords, bits=8),
                                      jsim.hilbert_order(coords, bits=8))
        # The checkpoint rebuild from a frozen ownership.
        K = port_g.max_degree() + 2
        again = partition_from_ownership(port_g, port.order, port.bounds, tile_width=K)
        from repro.sim.partition import partition_from_ownership as ref_from_ownership

        _assert_same_partition(again, ref_from_ownership(ref_g, ref.order, ref.bounds,
                                                         tile_width=K), f"{name} rebuilt")


def test_patch_drift_and_place_rows_equal_reference():
    _, ref_g, port_g, _ = next(_graphs())
    port = partition_graph(port_g, 3, relabel="rcm")
    ref = jsim.partition_graph(ref_g, 3, relabel="rcm")
    # Weight-only patch: the same structure, new (symmetric) weights.
    rows = np.repeat(np.arange(ref_g.n), np.diff(ref_g.indptr))
    cols = np.asarray(ref_g.indices)
    w2 = np.asarray(ref_g.data) * (1.0 + (rows + cols) % 3)
    from repro.core.graph import CSRGraph as RefCSR

    ref_w = RefCSR(indptr=ref_g.indptr, indices=ref_g.indices, data=w2)
    _assert_same_partition(port.patch(_port_csr(ref_w)), ref.patch(ref_w), "weight patch")
    # Structural patch: drop every edge of agent 0 (both directions).
    keep = (rows != 0) & (cols != 0)
    from repro.core.graph import csr_from_coo as ref_coo

    ref_s = ref_coo(ref_g.n, rows[keep], cols[keep], np.asarray(ref_g.data)[keep])
    port_s = _port_csr(ref_s)
    _assert_same_partition(port.patch(port_s), ref.patch(ref_s), "structural patch")
    assert port.drift(port_s) == ref.drift(ref_s)
    assert port.cut_fraction() == ref.cut_fraction()
    x = np.random.default_rng(1).normal(size=(ref_g.n, 2))
    ids = np.array([5, 0, 17])
    got = port.place_rows(np.zeros((3, port.rows_per_shard, 2)), ids, x[ids])
    want = ref.place_rows(np.zeros((3, ref.rows_per_shard, 2)), ids, x[ids])
    np.testing.assert_array_equal(got, want)


# -- the partitioner's properties, on the port -----------------------------


def _simulate_exchange(part, Theta):
    """Numpy re-enactment of the all_gather exchange: publish border rows,
    gather the pool, read halo rows per shard."""
    S, Bmax = part.border.shape
    blocks = part.pad_rows(Theta)
    pool = np.stack([blocks[s][part.border[s]] for s in range(S)])
    pool = pool.reshape((S * Bmax,) + Theta.shape[1:])
    return [np.concatenate([blocks[s], pool[part.halo_src[s]]], axis=0) for s in range(S)]


def _simulate_p2p(part, Theta):
    """Numpy re-enactment of the point-to-point exchange: one ring shift per
    offset, receivers scatter buffer rows into their halo slots."""
    S, Hmax = part.halo.shape
    blocks = part.pad_rows(Theta)
    offsets, sends, dsts = part.p2p_plan
    ext = []
    for s in range(S):
        halo = np.zeros((Hmax,) + Theta.shape[1:], Theta.dtype)
        for off, snd, dst in zip(offsets, sends, dsts):
            t = (s - off) % S
            recv = blocks[t][snd[t]]
            keep = dst[s] < Hmax
            halo[dst[s][keep]] = recv[keep]
        ext.append(np.concatenate([blocks[s], halo], axis=0))
    return ext


@pytest.mark.parametrize("mode", ["contiguous", "degree"])
def test_halo_maps_round_trip(mode):
    rng = np.random.default_rng(1)
    for name, _, g, _ in _graphs():
        for S in (1, 2, 3, min(8, g.n)):
            part = partition_graph(g, S, mode=mode)
            x = rng.normal(size=(g.n, 3))
            np.testing.assert_array_equal(part.unpad_rows(part.pad_rows(x)), x)
            for ext in (_simulate_exchange(part, x), _simulate_p2p(part, x)):
                for s in range(S):
                    h, R = part.halo_sizes[s], part.rows_per_shard
                    np.testing.assert_array_equal(ext[s][R: R + h], x[part.halo[s, :h]],
                                                  f"{name} S={S} shard {s}")


@pytest.mark.parametrize("relabel", [None, "rcm", "shuffle"])
@pytest.mark.parametrize("mode", ["contiguous", "degree"])
def test_shard_tiles_reproduce_global_mix_exactly(mode, relabel):
    rng = np.random.default_rng(2)
    for name, _, g, _ in _graphs():
        W = g.to_dense().weights
        Theta = rng.normal(size=(g.n, 4))
        want = W @ Theta
        rl = rng.permutation(g.n) if relabel == "shuffle" else relabel
        for S in (1, 2, 5):
            part = partition_graph(g, S, mode=mode, relabel=rl)
            for ext in (_simulate_exchange(part, Theta), _simulate_p2p(part, Theta)):
                for s in range(S):
                    size = int(part.sizes[s])
                    got = np.einsum("rk,rkp->rp", part.w[s], ext[s][part.idx[s]])
                    np.testing.assert_allclose(got[:size], want[part.owned[s, :size]],
                                               rtol=1e-13, atol=1e-13,
                                               err_msg=f"{name} S={S} shard {s}")


def test_degree_mode_balances_nnz():
    n = 60
    rows, cols = [], []
    for i in range(4):  # 4 hubs touching everyone
        rows += [i] * (n - 1 - i)
        cols += list(range(i + 1, n))
    g = csr_from_coo(n, rows, cols, np.ones(len(rows)), symmetrize=True)

    def nnz_of(part):
        return np.array([g.indptr[part.bounds[s + 1]] - g.indptr[part.bounds[s]]
                         for s in range(4)])

    contig, deg = partition_graph(g, 4, mode="contiguous"), partition_graph(g, 4, mode="degree")
    assert nnz_of(deg).max() < nnz_of(contig).max()
    assert (np.diff(deg.bounds) >= 1).all()


def test_partition_validation_and_edges():
    g = _port_csr(ref_as_csr(ref_ring(6)))
    with pytest.raises(ValueError):
        partition_graph(g, 7)
    with pytest.raises(ValueError):
        partition_graph(g, 2, mode="spectral")
    with pytest.raises(ValueError):
        partition_graph(g, 2, tile_width=1)
    p1 = partition_graph(g, 1)
    assert p1.halo_sizes.sum() == 0 and p1.border_sizes.sum() == 0 and p1.halo_fraction() == 0.0
    pn = partition_graph(g, 6, mode="contiguous")
    assert (pn.sizes == 1).all() and (pn.halo_sizes == 2).all()
    pw = partition_graph(g, 2, tile_width=5)
    assert pw.tile_width == 5 and (pw.w[..., 2:] == 0).all()
    with pytest.raises(ValueError, match="coords"):
        partition_graph(g, 2, relabel="sfc")
    with pytest.raises(ValueError, match="coords"):
        partition_graph(g, 2, relabel="hilbert")
    with pytest.raises(ValueError, match="relabel"):
        partition_graph(g, 2, relabel="metis")
    with pytest.raises(ValueError, match="permutation"):
        partition_graph(g, 2, relabel=np.zeros(6, dtype=np.int64))
    with pytest.raises(ValueError, match="coords"):
        sfc_order(np.zeros((8, 3)))
    with pytest.raises(ValueError, match="coords"):
        hilbert_order(np.zeros((8, 3)))


def test_p2p_plan_and_neighbor_shards():
    for name, _, g, _ in _graphs():
        for relabel in (None, "rcm"):
            for S in (2, 4):
                part = partition_graph(g, S, relabel=relabel)
                _, sends, _ = point_to_point_plan(part)
                assert part.exchange_rows("p2p") == S * sum(b.shape[1] for b in sends)
                nbrs = part.neighbor_shards()
                for s in range(S):
                    h = int(part.halo_sizes[s])
                    np.testing.assert_array_equal(nbrs[s],
                                                  np.unique(part.shard_of[part.halo[s, :h]]))
                    assert s not in nbrs[s] and (part.halo_owner[s, h:] == S).all()


def test_rcm_and_curves_drop_halo_fraction_on_shuffled_rgg():
    """As the reference's acceptance: on a random geometric graph with
    n = 4096, contiguous index blocks at S = 4 read over 60% remote rows;
    RCM and the Morton curve bring that to <= 0.3, and p2p ships fewer
    rows than the all_gather pool (so ``"auto"`` picks it). At S = 16 the
    Hilbert curve is no worse than Morton and ships fewer p2p rows."""
    g, pos = random_geometric_graph(4096, np.random.default_rng(0), avg_degree=16.0,
                                    return_pos=True)
    base = partition_graph(g, 4)
    assert base.halo_fraction() > 0.6
    assert sharded_mix_op(base).method == "all_gather"
    for part in (partition_graph(g, 4, relabel="rcm"),
                 partition_graph(g, 4, relabel="sfc", coords=pos)):
        assert part.halo_fraction() <= 0.3
        assert part.exchange_rows("p2p") < part.exchange_rows("all_gather")
        assert sharded_mix_op(part).method == "p2p"
    sfc = partition_graph(g, 16, relabel="sfc", coords=pos)
    hil = partition_graph(g, 16, relabel="hilbert", coords=pos)
    assert hil.halo_fraction() <= 0.35
    assert hil.halo_fraction() <= sfc.halo_fraction() + 1e-9
    assert hil.exchange_rows("p2p") < sfc.exchange_rows("p2p")


def test_orders_on_simple_shapes():
    g = _port_csr(ref_as_csr(ref_ring(8)))
    order = rcm_order(g)
    rank = np.empty(8, dtype=np.int64)
    rank[order] = np.arange(8)
    for i in range(8):
        for j in g.neighbors(i):
            assert abs(rank[i] - rank[int(j)]) <= 2
    line = np.stack([np.linspace(0, 1, 8), np.zeros(8)], axis=1)
    np.testing.assert_array_equal(sfc_order(line), np.arange(8))
    k = 16
    xs, ys = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    grid = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(float)
    steps = np.abs(np.diff(grid[hilbert_order(grid, bits=4)], axis=0)).sum(axis=1)
    assert (steps == 1).all()

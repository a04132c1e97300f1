"""repro_torch.core.mixing's halo exchange against repro.core.mixing.

* ``ExchangeSpec``: validation, ``from_string`` and ``coerce`` give the
  reference's results and errors;
* ``sharded_mix_op``: the ``"auto"`` rule picks the reference's method and
  the compressed p2p plan (``p2p_bpos``) equals the reference's;
* ``ShardedMixOp._quantize``: the reference's bits (bf16 rounding, int8
  scale and rounding), equal bit for bit;
* ``exchange_halo`` on the stacked slab at S = 4: on the f32 wire both
  methods fill every referenced halo slot with a copy of
  ``Theta[halo ids]``; on a compressed wire the halo rows equal the
  reference's dequantized pool and the error-feedback residual is
  ``v - dq(v)``, bit for bit (the quantizer runs on the same float32
  values).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.mixing as jmix
import repro.sim as jsim
from repro.core import knn_graph as ref_knn
from repro_torch.core import CSRGraph, random_geometric_graph
from repro_torch.core.mixing import ExchangeSpec, StackedCollective, sharded_mix_op
from repro_torch.sim import partition_graph


def _outcome(fn):
    """(result, None) or (None, (exception type name, message))."""
    try:
        return fn(), None
    except (ValueError, TypeError) as e:
        return None, (type(e).__name__, str(e))


SPECS = [dict(), dict(method="p2p"), dict(method="all_gather", dtype="bf16"),
         dict(method="p2p", dtype="int8", error_feedback=True), dict(method="ring"),
         dict(dtype="f16"), dict(dtype="f32", error_feedback=True),
         dict(method="auto", dtype="bf16", error_feedback=True)]
STRINGS = ["p2p", "p2p:bf16:ef", "all_gather:int8", "auto:ef", "", "p2p:bf16:int8", "p2p:f8",
           "ring:bf16", ":bf16"]


@pytest.mark.parametrize("kw", SPECS, ids=[str(i) for i in range(len(SPECS))])
def test_spec_validation_equals_reference(kw):
    got, got_err = _outcome(lambda: ExchangeSpec(**kw))
    want, want_err = _outcome(lambda: jmix.ExchangeSpec(**kw))
    assert got_err == want_err
    if want is not None:
        assert (got.method, got.dtype, got.error_feedback) == (
            want.method, want.dtype, want.error_feedback)
        for p in (1, 7, 100):
            assert got.payload_bytes_per_row(p) == want.payload_bytes_per_row(p)
        assert got.needs_error_feedback_state() == want.needs_error_feedback_state()


@pytest.mark.parametrize("text", STRINGS)
def test_string_forms_equal_reference(text, monkeypatch):
    # Each package warns once per process about a bare string; the flags
    # are reset here and restored after, so no other test (the reference's
    # own included) loses its warning to this one.
    import repro_torch.core.mixing as tmix

    for module in (tmix, jmix):
        monkeypatch.setattr(module, "_warned_bare_exchange_string", False)
    for parse in ("from_string", "coerce"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got, got_err = _outcome(lambda: getattr(ExchangeSpec, parse)(text))
            want, want_err = _outcome(lambda: getattr(jmix.ExchangeSpec, parse)(text))
        assert got_err == want_err, parse
        kinds = [w.category for w in caught]
        assert kinds == ([DeprecationWarning] * 2 if parse == "coerce" else []), kinds
        if want is not None:
            assert dataclass_fields(got) == dataclass_fields(want)
    assert ExchangeSpec.coerce(None) == ExchangeSpec()
    spec = ExchangeSpec(method="p2p")
    assert ExchangeSpec.coerce(spec) is spec
    with pytest.raises(TypeError, match="ExchangeSpec or string"):
        ExchangeSpec.coerce(3)


def dataclass_fields(spec):
    return spec.method, spec.dtype, spec.error_feedback


def _partitions():
    """(label, port partition, reference partition) on a k-NN graph and a
    geometric one, S = 4, with and without the RCM relabel."""
    rng = np.random.default_rng(0)
    ref_g = ref_knn(rng.normal(size=(90, 6)), k=6)
    port_g = CSRGraph(indptr=np.asarray(ref_g.indptr), indices=np.asarray(ref_g.indices),
                      data=np.asarray(ref_g.data))
    for relabel in (None, "rcm"):
        yield (f"knn {relabel}", partition_graph(port_g, 4, relabel=relabel),
               jsim.partition_graph(ref_g, 4, relabel=relabel))
    geo = random_geometric_graph(600, np.random.default_rng(1), avg_degree=10.0)
    from repro.core.graph import CSRGraph as RefCSR

    ref_geo = RefCSR(indptr=geo.indptr, indices=geo.indices, data=geo.data)
    yield ("rgg rcm", partition_graph(geo, 4, relabel="rcm"),
           jsim.partition_graph(ref_geo, 4, relabel="rcm"))


@pytest.mark.parametrize("spec", ["auto", "p2p:bf16", "p2p:int8:ef", "all_gather:bf16"])
def test_sharded_mix_op_plan_equals_reference(spec):
    for label, part, ref in _partitions():
        got = sharded_mix_op(part, exchange=ExchangeSpec.from_string(spec))
        want = jmix.sharded_mix_op(ref, exchange=jmix.ExchangeSpec.from_string(spec))
        assert (got.method, got.dtype, got.error_feedback, got.halo_width) == (
            want.method, want.dtype, want.error_feedback, want.halo_width), label
        assert got.p2p_offsets == want.p2p_offsets
        for a, b in zip(got.p2p_send + got.p2p_dst + got.p2p_bpos,
                        want.p2p_send + want.p2p_dst + want.p2p_bpos):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=label)
        assert got.rebound(part).method == got.method


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantize_bits_equal_reference(dtype):
    _, part, ref = next(_partitions())
    got_op = sharded_mix_op(part, exchange=ExchangeSpec(dtype=dtype))
    want_op = jmix.sharded_mix_op(ref, exchange=jmix.ExchangeSpec(dtype=dtype))
    rng = np.random.default_rng(2)
    v = (rng.normal(size=(4, 9, 13)) * 10.0 ** rng.integers(-6, 4, size=(4, 9, 1)))
    v[1, 3] = 0.0  # an all-zero row: the int8 scale's floor
    v[2, 5, :4] = [127.5, -0.5, 1e-30, -3e3]
    v = v.astype(np.float32)
    got_payload, got_dq = got_op._quantize(torch.as_tensor(v))
    for s in range(4):
        want_payload, want_dq = want_op._quantize(jnp.asarray(v[s]))
        np.testing.assert_array_equal(got_dq[s].numpy(), np.asarray(want_dq))
        want_q = np.asarray(want_payload["q"])
        got_q = got_payload["q"][s]
        if dtype == "bf16":
            got_q = got_q.view(torch.int16).numpy()
            want_q = want_q.view(np.int16)
        else:
            got_q = got_q.numpy()
            np.testing.assert_array_equal(got_payload["scale"][s].numpy(),
                                          np.asarray(want_payload["scale"]))
        np.testing.assert_array_equal(got_q, want_q)


def _slab(op, Theta, part):
    """The stacked slab of ``Theta`` (n, p): owned rows, halo rows zero."""
    S, R, H = op.num_shards, op.rows_per_shard, op.halo_width
    slab = torch.zeros((S * (R + H), Theta.shape[1]), dtype=torch.float32)
    slab[: S * R] = torch.as_tensor(part.pad_rows(Theta)).reshape(S * R, -1)
    return slab


def _halo_rows(op, slab, s, size):
    S, R, H = op.num_shards, op.rows_per_shard, op.halo_width
    return slab[S * R + s * H: S * R + s * H + size].numpy()


def test_f32_wire_fills_halo_with_exact_copies():
    for label, part, _ in _partitions():
        Theta = np.random.default_rng(3).normal(size=(part.n, 5)).astype(np.float32)
        slabs = {}
        for method in ("all_gather", "p2p"):
            op = sharded_mix_op(part, exchange=ExchangeSpec(method=method))
            slab = _slab(op, Theta, part)
            before = slab[: 4 * op.rows_per_shard].clone()
            assert op.exchange_halo(slab) is None
            assert torch.equal(slab[: 4 * op.rows_per_shard], before)  # owned rows untouched
            for s in range(4):
                h = int(part.halo_sizes[s])
                np.testing.assert_array_equal(_halo_rows(op, slab, s, h),
                                              Theta[part.halo[s, :h]], err_msg=label)
            slabs[method] = slab
            # The tiles over the slab give the global neighbour sum.
            rows = torch.arange(4 * op.rows_per_shard)
            got = op.gather_rows(slab.double(), rows).numpy()
            want = part.csr.to_dense().weights @ Theta.astype(np.float64)
            real = part.owned.reshape(-1) < part.n
            np.testing.assert_allclose(got[real], want[part.owned.reshape(-1)[real]],
                                       rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("spec", ["all_gather:bf16", "p2p:bf16:ef", "all_gather:int8:ef",
                                  "p2p:int8"])
def test_compressed_wire_matches_reference_pool_and_residual(spec):
    _, part, ref = list(_partitions())[1]
    op = sharded_mix_op(part, exchange=ExchangeSpec.from_string(spec))
    want_op = jmix.sharded_mix_op(ref, exchange=jmix.ExchangeSpec.from_string(spec))
    rng = np.random.default_rng(4)
    Theta = rng.normal(size=(part.n, 6)).astype(np.float32)
    ef0 = None
    if op.error_feedback:
        ef0 = (1e-3 * rng.normal(size=(4, op.border.shape[1], 6))).astype(np.float32)
    slab = _slab(op, Theta, part)
    ef = None if ef0 is None else torch.as_tensor(ef0.copy())
    stats = op.exchange_halo(slab, ef, collect_stats=True)
    blocks = part.pad_rows(Theta)
    v = np.stack([blocks[s][part.border[s]] for s in range(4)])
    if ef0 is not None:
        v = v + ef0
    dq = np.stack([np.asarray(want_op._quantize(jnp.asarray(v[s]))[1]) for s in range(4)])
    pool = dq.reshape(-1, 6)
    for s in range(4):
        h = int(part.halo_sizes[s])
        np.testing.assert_array_equal(_halo_rows(op, slab, s, h), pool[part.halo_src[s, :h]])
    if ef0 is not None:
        np.testing.assert_array_equal(ef.numpy(), v - dq)
    err = (v - dq).astype(np.float32)
    np.testing.assert_allclose(stats["quant_err_sq"].numpy(), (err ** 2).sum(axis=(1, 2)),
                               rtol=1e-6)
    assert (stats["quant_err_sq"] > 0).all() and torch.isfinite(stats["quant_err_sq"]).all()
    assert torch.equal(stats["ef_residual_sq"], stats["quant_err_sq"] if ef0 is not None
                       else torch.zeros(4))


def test_stacked_collective_is_the_pool_and_a_ring_shift():
    coll = StackedCollective()
    x = torch.arange(4 * 3).view(4, 3)
    assert coll.all_gather(x) is x
    for d in range(4):
        got = coll.ppermute(x, d)
        for s in range(4):
            assert torch.equal(got[s], x[(s - d) % 4])  # shard s receives from s - d

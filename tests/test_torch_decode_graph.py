"""The compiled decode on the CPU: every family's decode step with its
position as a 0-d tensor, against the reference's ``jax.jit`` decode with
a traced ``jnp.int32`` position and against the port's own int-position
decode, and :class:`repro_torch.models.DecodeGraph` against
``bundle.decode``.

One reduced float32 config per route: llama3.2-1b (dense),
granite-moe-3b-a800m (MoE), chameleon-34b (VLM), seamless-m4t-medium
(enc-dec), zamba2-1.2b (hybrid) and xlstm-1.3b (recurrent). The reference
draws the parameters and ``convert.*_params_from_reference`` carries them
across; token ids and the enc-dec memory come from numpy seeds. Each
reference decode is compiled once a case at XLA's backend optimization
level 0, as the family tests do. Tolerances: against the reference each
family's own, 1e-5 relative to max(1, max |reference|) (float32 sums in
another order than XLA's); the port's routes against each other bit for
bit (the same operations on the same values). The refusal of a tensor
position on a mesh runs on the dry-run's fake process group.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import encdec as jencdec
from repro.models import hybrid as jhybrid
from repro.models import transformer as jtrans
from repro.models import xlstm_stack as jstack
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.models import DecodeGraph
from repro_torch.models.registry import build_model
from repro_torch.utils.tree import tree_leaves, tree_map

ARCHS = ["llama3.2-1b", "granite-moe-3b-a800m", "chameleon-34b", "seamless-m4t-medium",
         "zamba2-1.2b", "xlstm-1.3b"]
F32_TOL = 1e-5
CPU = torch.device("cpu")
B, MAX_LEN, STEPS = 2, 8, 4


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Many small operations: one torch thread a test process (see
    ``tests/test_torch_train.py``)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _compile(f, *args):
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().to(torch.float64))
    want = np.asarray(jnp.asarray(want, jnp.float32), dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _family(cfg):
    """The reference's model module and the port's converter of its tree."""
    if cfg.is_encdec:
        return jencdec, convert.encdec_params_from_reference
    if cfg.family == "hybrid":
        return jhybrid, convert.hybrid_params_from_reference
    if cfg.family == "ssm":
        return jstack, convert.xlstm_params_from_reference
    return jtrans, convert.transformer_params_from_reference


@functools.lru_cache(maxsize=None)
def _case(arch, **overrides):
    """The reference's random init at the reduced float32 config and the
    port's copy on the CPU."""
    kw = {"dtype": "float32", **overrides}
    jcfg, tcfg = jcfgs.get_reduced(arch, **kw), tcfgs.get_reduced(arch, **kw)
    jmod, to_port = _family(tcfg)
    params = jmod.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jmod, params, to_port(jax.tree.map(np.asarray, params), tcfg, CPU)


def _caches(jmod, jcfg, params, bundle, model, max_len):
    """The reference's ``init_cache`` and the port's, an enc-dec's memory
    keys and values filled with the same seeded draws."""
    jc = jmod.init_cache(params, jcfg, B, max_len)
    caches = bundle.init_cache(model, B, max_len)
    if bundle.cfg.is_encdec:
        rng = np.random.default_rng(1)
        mem = {k: rng.normal(size=jc[k].shape).astype(np.float32) for k in ("mem_k", "mem_v")}
        jc = dict(jc, **{k: jnp.asarray(v) for k, v in mem.items()})
        with torch.inference_mode():
            for i, c in enumerate(caches):
                for k, v in mem.items():
                    c[k].copy_(torch.as_tensor(v[i]))
    return jc, caches


def _decode_three_ways(arch, steps, max_len, **overrides):
    """``steps`` decode steps from ``init_cache``: the reference's compiled
    step (traced ``jnp.int32`` position), the port's with a 0-d tensor
    position and with an int. Returns the three logits lists and the
    port's two final caches."""
    jcfg, tcfg, jmod, params, model = _case(arch, **overrides)
    bundle = build_model(tcfg, device=CPU)
    jc, caches = _caches(jmod, jcfg, params, bundle, model, max_len)
    ints = tree_map(torch.clone, caches)
    toks = [_tokens(jcfg.vocab_size, (B, 1), seed=10 + i) for i in range(steps)]
    step = _compile(lambda p, t, c, pos: jmod.decode_step(p, t, jcfg, c, pos), params,
                    jnp.asarray(toks[0]), jc, jnp.int32(0))
    want, got, got_int = [], [], []
    for pos, tok in enumerate(toks):
        out, jc = step(params, jnp.asarray(tok), jc, jnp.int32(pos))
        want.append(out)
        out, caches = bundle.decode(model, tok, caches, torch.tensor(pos))
        got.append(out)
        out, ints = bundle.decode(model, tok, ints, pos)
        got_int.append(out)
    return want, got, got_int, caches, ints


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_position_decode_matches_reference_and_int_decode(arch):
    """4 steps from ``init_cache`` with the position a 0-d tensor: within
    1e-5 of ``jax.jit(decode_step)`` at ``jnp.int32(pos)``, and equal bit
    for bit to the int-position decode, logits and every cache tensor."""
    want, got, got_int, caches, ints = _decode_three_ways(arch, STEPS, MAX_LEN)
    for pos, (w, g, gi) in enumerate(zip(want, got, got_int)):
        assert _rel(g, w) <= F32_TOL, pos
        assert torch.equal(g, gi), pos
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(caches), tree_leaves(ints)))


def test_windowed_ring_slot_on_the_device():
    """``sliding_window`` = 4 and 7 steps: the ring slot ``pos % 4``
    computed on the device wraps as the reference's and the int path's."""
    want, got, got_int, caches, ints = _decode_three_ways("llama3.2-1b", 7, 16, sliding_window=4)
    for pos, (w, g, gi) in enumerate(zip(want, got, got_int)):
        assert _rel(g, w) <= F32_TOL, pos
        assert torch.equal(g, gi), pos
    assert caches[0]["k"].shape[1] == 4
    assert caches[0]["slot_pos"].tolist() == [4, 5, 6, 3]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(caches), tree_leaves(ints)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_graph_equals_bundle_decode_on_the_cpu(arch):
    """6 greedy steps through ``DecodeGraph`` and through ``bundle.decode``
    from clones of the same caches: equal bit for bit, logits and caches;
    the graph's buffers keep their addresses and its caches are the ones
    it was given. A step past a full cache raises as the eager one does
    and writes nothing."""
    _, tcfg, _, _, model = _case(arch)
    bundle = build_model(tcfg, device=CPU)
    caches = bundle.init_cache(model, B, 6)
    eager = tree_map(torch.clone, caches)
    graph = DecodeGraph(bundle, model, caches)
    first = torch.as_tensor(_tokens(tcfg.vocab_size, (B, 1), seed=3)).long()
    tok_g = tok_e = first
    ptrs = None
    for pos in range(6):
        logits, out = graph(tok_g, pos)
        want, eager = bundle.decode(model, tok_e, eager, pos)
        assert torch.equal(logits, want), pos
        assert out is caches
        now = [t.data_ptr() for t in tree_leaves(out) + [graph.token, graph.pos, logits]]
        assert ptrs is None or now == ptrs
        ptrs = now
        tok_g = logits[:, -1].argmax(dim=-1, keepdim=True)
        tok_e = want[:, -1].argmax(dim=-1, keepdim=True)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(caches), tree_leaves(eager)))
    assert graph.captures == 0  # the CPU runs the step eagerly
    if tcfg.family == "ssm":  # no position cache: the recurrent states run on
        return
    before = [t.clone() for t in tree_leaves(caches)]
    with pytest.raises(ValueError, match="outside the cache of 6 positions"):
        bundle.decode(model, tok_e, eager, 6)
    with pytest.raises(ValueError, match="outside the cache of 6 positions"):
        graph(tok_g, 6)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(caches), before))


@pytest.mark.parametrize("pos", [torch.tensor([1]), torch.tensor(1.0), torch.tensor(True)])
def test_bundle_decode_refuses_a_position_that_is_not_a_0d_integer_tensor(pos):
    _, tcfg, _, _, model = _case("llama3.2-1b")
    bundle = build_model(tcfg, device=CPU)
    caches = bundle.init_cache(model, B, 4)
    with pytest.raises(ValueError, match="0-d integer tensor"):
        bundle.decode(model, np.zeros((B, 1), np.int32), caches, pos)


def test_set_position_refuses_a_tensor_position_on_a_position_split_dtensor():
    """A decode cache split on its positions over the dry-run's fake (4, 2)
    mesh: an int position writes on the rank that holds it; a tensor one
    raises, naming the mesh decode (it stays eager with an int)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import set_position

    fake_world(8)
    try:
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
        t = DTensor.from_local(torch.zeros(2, 4, 3, 5), mesh, [Replicate(), Shard(1)],
                               run_check=False)
        value = torch.ones(2, 3, 5)
        set_position(t, 1, value)  # rank 0 holds positions 0-3 of 8
        assert torch.equal(t.to_local()[:, 1], value)
        with pytest.raises(ValueError, match="mesh decode"):
            set_position(t, torch.tensor(1), value)
    finally:
        dist.destroy_process_group()

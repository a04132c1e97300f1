"""The port's decoder-only transformer (dense, MoE, VLM) against the JAX
package's, on the CPU.

The reduced float32 configs of five architectures: llama3.2-1b (dense
GQA), qwen1.5-4b (QKV bias, MHA), chameleon-34b (VLM, untied head),
grok-1-314b (MoE with logit soft-capping) and granite-moe-3b-a800m (MoE).
The reference draws the parameters (``jax.random``) and
``convert.transformer_params_from_reference`` carries them across; token
ids come from numpy seeds. Each reference function is compiled once a
case at XLA's backend optimization level 0 (as ``tests/test_torch_train.py``
does). Tolerances, relative to max(1, max |reference|):

* logits, loss (the MoE aux included), prefill caches and decode steps
  1e-5 (float32 sums in another order than XLA's; the reference's own
  routes agree to about 1e-6);
* gradients 1e-4 per leaf (through the backward of two layers);
* the port's own routes (prefill against the decode loop, the repeated
  KV cache against the compact one) 1e-5; remat on against off bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtrans
from repro_torch import configs as tcfgs
from repro_torch.convert import agent_params_from_reference, transformer_params_from_reference
from repro_torch.core import spmd
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttrans
from repro_torch.models.registry import build_model
from repro_torch.utils.tree import tree_flatten_with_path

ARCHS = ["llama3.2-1b", "qwen1.5-4b", "chameleon-34b", "grok-1-314b", "granite-moe-3b-a800m"]
F32_TOL = 1e-5
GRAD_TOL = 1e-4
CPU = torch.device("cpu")
B, S, EXTRA = 2, 17, 4  # prompts of S tokens (S - 1 after the shift), EXTRA decode steps


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


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _case(arch, **overrides):
    """The reference's random init at the reduced float32 config and the
    port's copy on the CPU."""
    kw = {"dtype": "float32", **dict(overrides)}
    jkw = dict(kw)
    if "moe" in kw:  # the same MoE settings in the reference's own dataclass
        jkw["moe"] = jcfgs.MoEConfig(**dataclasses.asdict(kw["moe"]))
    jcfg, tcfg = jcfgs.get_reduced(arch, **jkw), tcfgs.get_reduced(arch, **kw)
    params = jtrans.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    return (jcfg, tcfg, params, np_params,
            transformer_params_from_reference(np_params, tcfg, CPU))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference_names_shapes_and_types(arch):
    """The port's own random init, stacked for two agents, against the
    reference's ``jax.vmap(init_params)`` tree, at the bfloat16 default
    (the MoE router stays float32 in both)."""
    jcfg, tcfg = jcfgs.get_reduced(arch), tcfgs.get_reduced(arch)
    want = jax.eval_shape(jax.vmap(lambda k: jtrans.init_params(k, jcfg)),
                          jax.random.split(jax.random.PRNGKey(0), 2))
    bundle = build_model(tcfg, device=CPU)
    got = bundle.init_agents(2, 0)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(tree_flatten_with_path(got))
    for (name, t), (path, leaf) in zip(tree_flatten_with_path(got), paths):
        assert name == ".".join(k.key for k in path)
        assert tuple(t.shape) == leaf.shape and str(t.dtype)[6:] == str(leaf.dtype), name
    assert ("lm_head" in got) == (not tcfg.tie_embeddings)
    if tcfg.moe is not None:
        assert got["layers"]["ffn"]["router"]["w"].dtype == torch.float32
    again = bundle.init(3)
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(),
                                                  bundle.init(3).parameters()))


def _ref_forward_and_grads(jcfg, params, tokens):
    def f(p, t):
        # remat off: the same values, compiled in less time
        logits, aux = jtrans.forward(p, t[:, :-1], jcfg, remat=False)
        return jlayers.cross_entropy_loss(logits, t[:, 1:]) + aux, (logits, aux)

    vg = jax.value_and_grad(f, has_aux=True)
    t = jnp.asarray(tokens)
    return _compile(vg, params, t)(params, t)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    jcfg, tcfg, params, np_params, model = _case(arch)
    tokens = _tokens(jcfg.vocab_size, (B, S))
    (want_loss, (want_logits, want_aux)), want_grads = _ref_forward_and_grads(jcfg, params, tokens)
    with torch.no_grad():
        logits, aux = ttrans.forward(model, torch.as_tensor(tokens[:, :-1]).long(), tcfg)
    assert _rel(logits, want_logits) <= F32_TOL
    assert _rel(aux, want_aux) <= F32_TOL
    assert (float(want_aux) > 0) == (tcfg.moe is not None)
    # The gradient through the bundle's loss over a bound tree, as a
    # training round takes it (one agent).
    bundle = build_model(tcfg, device=CPU)
    stacked = agent_params_from_reference(jax.tree.map(lambda x: x[None], np_params), tcfg, CPU)
    losses, grads = spmd.agent_losses_and_grads(bundle, stacked,
                                                {"tokens": torch.as_tensor(tokens[None])})
    assert _rel(losses[0], want_loss) <= F32_TOL
    wants = jax.tree.leaves(want_grads)
    for (name, g), w in zip(tree_flatten_with_path(grads), wants):
        assert _rel(g[0], w) <= GRAD_TOL, name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_the_same_bits(arch):
    jcfg, tcfg, _, np_params, _ = _case(arch)
    tokens = {"tokens": torch.as_tensor(_tokens(jcfg.vocab_size, (1, B, S), seed=1))}
    out = []
    for remat in (True, False):
        stacked = agent_params_from_reference(jax.tree.map(lambda x: x[None], np_params), tcfg,
                                              CPU)
        out.append(spmd.agent_losses_and_grads(build_model(tcfg, remat=remat, device=CPU),
                                               stacked, tokens))
    (l_on, g_on), (l_off, g_off) = out
    assert torch.equal(l_on, l_off)
    for (name, a), (_, b) in zip(tree_flatten_with_path(g_on), tree_flatten_with_path(g_off)):
        assert torch.equal(a, b), name


def _ref_serve(jcfg, params, tokens, steps, max_len):
    """The reference's prefill into ``max_len`` positions and ``steps``
    decode steps of the given token ids."""
    prefill = _compile(lambda p, t: jtrans.prefill(p, t, jcfg, max_len=max_len), params,
                       jnp.asarray(tokens))
    logits, first = prefill(params, jnp.asarray(tokens))
    S = tokens.shape[1]
    step = _compile(lambda p, t, c, pos: jtrans.decode_step(p, t, jcfg, c, pos), params,
                    jnp.asarray(steps[0]), first, jnp.int32(S))
    caches, outs = first, []
    for i, tok in enumerate(steps):
        out, caches = step(params, jnp.asarray(tok), caches, jnp.int32(S + i))
        outs.append(out)
    return logits, first, outs, caches


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_loop_match_reference(arch):
    """``bundle.prefill`` (cache sized for the steps to come) and a 4-step
    decode loop: logits, and every layer's keys, values and slot positions."""
    jcfg, tcfg, params, _, model = _case(arch)
    tokens = _tokens(jcfg.vocab_size, (B, S - 1), seed=2)
    steps = [_tokens(jcfg.vocab_size, (B, 1), seed=10 + i) for i in range(EXTRA)]
    want_logits, want_first, want_steps, want_caches = _ref_serve(
        jcfg, params, tokens, steps, S - 1 + EXTRA)
    bundle = build_model(tcfg, device=CPU)
    logits, caches = bundle.prefill(model, {"tokens": tokens}, max_len=S - 1 + EXTRA)
    assert logits.shape == (B, 1, tcfg.padded_vocab)
    assert _rel(logits, want_logits) <= F32_TOL
    assert len(caches) == tcfg.num_layers
    for i, c in enumerate(caches):
        assert _rel(c["k"], want_first["k"][i]) <= F32_TOL
        assert _rel(c["v"], want_first["v"][i]) <= F32_TOL
        assert np.array_equal(c["slot_pos"].numpy(), np.asarray(want_first["slot_pos"][i]))
    for i, (tok, want) in enumerate(zip(steps, want_steps)):
        got, caches = bundle.decode(model, tok, caches, S - 1 + i)
        assert _rel(got, want) <= F32_TOL
    for i, c in enumerate(caches):
        assert _rel(c["k"], want_caches["k"][i]) <= F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_agrees_with_decode_loop(arch):
    """The port's own two forms: the prefill's last-token logits against
    the same tokens fed one at a time through decode. An MoE layer routes
    a group of tokens at once, and what capacity drops depends on the
    group: its configs run with the capacity factor E / top_k, so every
    expert can take the whole group and the two forms compute the same
    function."""
    cfg = tcfgs.get_reduced(arch)
    over = {} if cfg.moe is None else {"moe": dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)}
    jcfg, tcfg, _, _, model = _case(arch, **over)
    bundle = build_model(tcfg, device=CPU)
    tokens = _tokens(jcfg.vocab_size, (B, S), seed=3)
    logits, _ = bundle.prefill(model, {"tokens": tokens})
    caches = bundle.init_cache(model, B, S)
    for pos in range(S):
        step, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
    assert float((logits - step).abs().max()) <= F32_TOL * max(1.0, float(logits.abs().max()))


def test_windowed_prefill_writes_the_ring_as_the_reference():
    """``sliding_window`` = 8 and a prompt of 13 tokens: the prefill keeps
    the last 8 positions at their ring slots (``pos % 8``), and decode
    steps wrap around the ring, as in the reference."""
    jcfg, tcfg, params, _, model = _case("llama3.2-1b", sliding_window=8)
    tokens = _tokens(jcfg.vocab_size, (B, 13), seed=4)
    steps = [_tokens(jcfg.vocab_size, (B, 1), seed=20 + i) for i in range(EXTRA)]
    want_logits, want_first, want_steps, _ = _ref_serve(jcfg, params, tokens, steps, 64)
    bundle = build_model(tcfg, device=CPU)
    logits, caches = bundle.prefill(model, {"tokens": tokens}, max_len=64)
    assert caches[0]["k"].shape[1] == 8
    assert caches[0]["slot_pos"].tolist() == [8, 9, 10, 11, 12, 5, 6, 7]
    assert _rel(logits, want_logits) <= F32_TOL
    for i, c in enumerate(caches):
        assert _rel(c["k"], want_first["k"][i]) <= F32_TOL
        assert np.array_equal(c["slot_pos"].numpy(), np.asarray(want_first["slot_pos"][i]))
    for i, (tok, want) in enumerate(zip(steps, want_steps)):
        got, caches = bundle.decode(model, tok, caches, 13 + i)
        assert _rel(got, want) <= F32_TOL


def test_repeat_kv_cache_decode_equivalence():
    """The port's twin of ``tests/test_perf_levers.py``'s: decode with the
    cache pre-repeated to the query heads gives the compact layout's
    outputs (from an empty cache, and after a prefill, whose compact K/V
    the port repeats as it writes them)."""
    jcfg, tcfg, _, _, model = _case("llama3.2-1b")
    bundle = build_model(tcfg, device=CPU)
    tokens = _tokens(jcfg.vocab_size, (B, 9), seed=5)
    steps = [_tokens(jcfg.vocab_size, (B, 1), seed=30 + i) for i in range(EXTRA)]
    x = np.random.default_rng(6).normal(size=(EXTRA, B, 1, tcfg.d_model)).astype(np.float32)

    def run(flag):
        tattn.set_repeat_kv_cache(flag)
        try:
            cache = tattn.init_cache(tcfg, B, 16, torch.float32, CPU)
            with torch.no_grad():
                ys = [tattn.decode_attention(model.layers[0].attn, torch.as_tensor(x[i]), tcfg,
                                             cache, i)[0] for i in range(EXTRA)]
            logits, caches = bundle.prefill(model, {"tokens": tokens}, max_len=9 + EXTRA)
            outs = [logits]
            for i, tok in enumerate(steps):
                out, caches = bundle.decode(model, tok, caches, 9 + i)
                outs.append(out)
            return cache["k"].shape[2], caches[0]["k"].shape[2], ys, outs
        finally:
            tattn.set_repeat_kv_cache(False)

    compact, repeated = run(False), run(True)
    assert (compact[0], compact[1]) == (tcfg.num_kv_heads, tcfg.num_kv_heads)
    assert (repeated[0], repeated[1]) == (tcfg.num_heads, tcfg.num_heads)
    for a, b in zip(compact[2] + compact[3], repeated[2] + repeated[3]):
        assert float((a - b).abs().max()) <= F32_TOL * max(1.0, float(a.abs().max()))
    assert not tattn.REPEAT_KV_IN_CACHE and not jattn.REPEAT_KV_IN_CACHE


def test_decode_past_the_prefill_cache_raises_where_the_reference_clamps():
    """The bundle's prefill makes a cache of exactly S positions, as the
    reference's does. A decode at position S: JAX's ``dynamic_update_slice``
    clamps the write onto the last slot (slot S - 1 then claims position S);
    the port raises, and serving passes ``max_len``."""
    jcfg, tcfg, params, _, model = _case("llama3.2-1b")
    tokens = _tokens(jcfg.vocab_size, (B, 6), seed=7)
    t = jnp.asarray(tokens)
    _, jc = _compile(lambda p, t: jtrans.prefill(p, t, jcfg), params, t)(params, t)
    step = _compile(lambda p, t, c: jtrans.decode_step(p, t, jcfg, c, 6), params, t[:, :1], jc)
    _, jc = step(params, t[:, :1], jc)
    assert np.asarray(jc["slot_pos"])[0].tolist() == [0, 1, 2, 3, 4, 6]
    bundle = build_model(tcfg, device=CPU)
    _, caches = bundle.prefill(model, {"tokens": tokens})
    assert caches[0]["k"].shape[1] == 6
    with pytest.raises(ValueError, match="outside the cache"):
        bundle.decode(model, tokens[:, :1], caches, 6)
    with pytest.raises(ValueError, match="does not fit the cache"):
        ttrans.prefill(model, torch.as_tensor(tokens).long(), tcfg, max_len=5)


def test_chunked_causal_attention_matches_dense():
    """``tests/test_perf_levers.py``'s check on the port: the q-block path
    (threshold lowered to 1024) against the whole-matrix path at S = 2048,
    windowed and not, within the reference test's rtol 2e-4, atol 2e-5."""
    from repro_torch.configs.base import ModelConfig

    cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = tattn.Attention(cfg, device=CPU, dtype=torch.float32, generator=gen)
    x = torch.randn((1, 2048, 64), generator=gen)
    for window in (None, 256):
        with torch.no_grad():
            dense, _ = tattn.attention(params, x, cfg, window=window)
            before = tattn.CHUNKED_ATTN_THRESHOLD
            tattn.CHUNKED_ATTN_THRESHOLD = 1024
            try:
                chunked, _ = tattn.attention(params, x, cfg, window=window)
            finally:
                tattn.CHUNKED_ATTN_THRESHOLD = before
        np.testing.assert_allclose(dense.numpy(), chunked.numpy(), rtol=2e-4, atol=2e-5)


def test_bf16_forward_matches_reference():
    """llama3.2-1b reduced in bfloat16: the port's logits within 3e-2 (bf16
    keeps about 3 significant digits; the frameworks round at different
    places) and of the model type."""
    jcfg, tcfg, params, _, model = _case("llama3.2-1b", dtype="bfloat16")
    assert model.embed.table.dtype == torch.bfloat16
    tokens = _tokens(jcfg.vocab_size, (B, S), seed=8)
    with torch.no_grad():
        got, _ = ttrans.forward(model, torch.as_tensor(tokens).long(), tcfg)
    t = jnp.asarray(tokens)
    want, _ = _compile(lambda p, t: jtrans.forward(p, t, jcfg, remat=False), params, t)(params, t)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= 3e-2


def test_bundle_bind_and_param_tree_round_trip():
    """``param_tree`` gives the reference's tree; ``bind`` lays a model
    over it sharing storage."""
    _, tcfg, _, np_params, model = _case("granite-moe-3b-a800m")
    tree = ttrans.param_tree(model)
    for (name, t), w in zip(tree_flatten_with_path(tree), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
    bound = ttrans.bind(tcfg, tree)
    assert bound.layers[1].ffn.gate.data_ptr() == tree["layers"]["ffn"]["gate"][1].data_ptr()
    with pytest.raises(KeyError, match="no leaves"):
        ttrans.bind(tcfg, {k: v for k, v in tree.items() if k != "final_norm"})

"""The port's enc-dec transformer (``models/encdec.py``) and the attention
it adds (bidirectional, cross-attention) against the JAX package's, on the
CPU.

seamless-m4t-medium's reduced float32 config (2 + 2 layers, MHA, untied
head). The reference draws the parameters and
``convert.encdec_params_from_reference`` carries them across; tokens and
frame embeddings come from numpy seeds. Tolerances as in
``tests/test_torch_transformer.py``: 1e-5 for logits, the loss, caches
and decode steps, 1e-4 for gradients, relative to max(1, max |reference|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro_torch import configs as tcfgs
from repro_torch.convert import (agent_params_from_reference, encdec_params_from_reference,
                                 load_reference_params)
from repro_torch.core import spmd
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models.registry import build_model
from repro_torch.utils.tree import tree_flatten_with_path

ARCH = "seamless-m4t-medium"
CPU = torch.device("cpu")
F32_TOL = 1e-5
B, S = 2, 17


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
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


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, tcfg = (m.get_reduced(ARCH, dtype="float32") for m in (jcfgs, tcfgs))
    params = jencdec.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    embeds = rng.normal(size=(B, jencdec.enc_len(S - 1), jcfg.d_model)).astype(np.float32)
    return (jcfg, tcfg, params, np_params, encdec_params_from_reference(np_params, tcfg, CPU),
            tokens, embeds)


def test_config_and_enc_len_match_reference():
    jcfg, tcfg, *_ = _setup()
    assert tcfg.is_encdec and tcfg.encoder_layers == jcfg.encoder_layers == 2
    assert tencdec.ENC_DOWNSAMPLE == jencdec.ENC_DOWNSAMPLE
    for s in (1, 3, 4, 16, 2048):
        assert tencdec.enc_len(s) == jencdec.enc_len(s)


def test_encode_forward_loss_and_gradients_match_reference():
    jcfg, tcfg, params, np_params, model, tokens, embeds = _setup()
    e, t = jnp.asarray(embeds), jnp.asarray(tokens)

    def ref(p, e, t):
        memory = jencdec.encode(p, e, jcfg, remat=False)
        logits, aux = jencdec.forward(p, e, t[:, :-1], jcfg, remat=False)
        return jlayers.cross_entropy_loss(logits, t[:, 1:]) + aux, (memory, logits)

    (want_loss, (want_mem, want_logits)), want_grads = _compile(
        jax.value_and_grad(ref, has_aux=True), params, e, t)(params, e, t)
    with torch.no_grad():
        mem = tencdec.encode(model, torch.as_tensor(embeds), tcfg)
        logits, aux = tencdec.forward(model, torch.as_tensor(embeds),
                                      torch.as_tensor(tokens[:, :-1]).long(), tcfg)
        loss = tencdec.loss_fn(model, {"tokens": torch.as_tensor(tokens).long(),
                                       "embeds": torch.as_tensor(embeds)}, tcfg)
    assert _rel(mem, want_mem) <= F32_TOL
    assert _rel(logits, want_logits) <= F32_TOL
    assert float(aux) == 0.0 and _rel(loss, want_loss) <= F32_TOL
    bundle = build_model(tcfg, device=CPU)
    assert bundle.stacked == ("encoder", "decoder")
    stacked = agent_params_from_reference(jax.tree.map(lambda x: x[None], np_params), tcfg, CPU)
    losses, grads = spmd.agent_losses_and_grads(
        bundle, stacked, {"tokens": torch.as_tensor(tokens[None]),
                          "embeds": torch.as_tensor(embeds[None])})
    assert _rel(losses[0], want_loss) <= F32_TOL
    for (name, g), w in zip(tree_flatten_with_path(grads), jax.tree.leaves(want_grads)):
        assert _rel(g[0], w) <= 1e-4, name


def test_prefill_and_decode_steps_match_reference():
    """``bundle.prefill`` (encode, the decoder prompt, the self caches and
    the memory's cross K/V) and 4 decode steps with ``decode_cross_attention``."""
    jcfg, tcfg, params, _, model, tokens, embeds = _setup()
    max_len = S + 4
    e, t = jnp.asarray(embeds), jnp.asarray(tokens)
    want_logits, want = _compile(lambda p, e, t: jencdec.prefill(p, e, t, jcfg, max_len=max_len),
                                 params, e, t)(params, e, t)
    bundle = build_model(tcfg, device=CPU)
    logits, caches = bundle.prefill(model, {"tokens": tokens, "embeds": embeds}, max_len=max_len)
    assert _rel(logits, want_logits) <= F32_TOL
    for i, c in enumerate(caches):
        for key in ("mem_k", "mem_v"):
            assert _rel(c[key], want[key][i]) <= F32_TOL
        assert _rel(c["self"]["k"], want["self"]["k"][i]) <= F32_TOL
        assert np.array_equal(c["self"]["slot_pos"].numpy(),
                              np.asarray(want["self"]["slot_pos"][i]))
    step = _compile(lambda p, t, c, pos: jencdec.decode_step(p, t, jcfg, c, pos), params,
                    t[:, :1], want, jnp.int32(S))
    rng = np.random.default_rng(1)
    for pos in range(S, max_len):
        tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        got, caches = bundle.decode(model, tok, caches, pos)
        ref, want = step(params, jnp.asarray(tok), want, jnp.int32(pos))
        assert _rel(got, ref) <= F32_TOL
    # init_cache: the self cache and zero memory K/V of enc_len(max_len) rows.
    blank = bundle.init_cache(model, B, max_len)
    assert len(blank) == tcfg.num_layers
    assert blank[0]["mem_k"].shape == (B, tencdec.enc_len(max_len), tcfg.num_kv_heads,
                                       tcfg.resolved_head_dim)
    assert blank[0]["self"]["k"].shape[1] == max_len


def test_prefill_agrees_with_decode_loop():
    """The port's own two forms: with the memory's cross K/V of a prefill
    of the first token, the decode loop over the prompt gives the prefill's
    last logits."""
    _, tcfg, _, _, model, tokens, embeds = _setup()
    bundle = build_model(tcfg, device=CPU)
    logits, _ = bundle.prefill(model, {"tokens": tokens, "embeds": embeds})
    _, caches = bundle.prefill(model, {"tokens": tokens[:, :1], "embeds": embeds}, max_len=S)
    for pos in range(1, S):
        step, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
    assert float((logits - step).abs().max()) <= F32_TOL * max(1.0, float(logits.abs().max()))


@pytest.mark.parametrize("kv", [4, 2])
def test_attention_bidirectional_and_cross_match_reference(kv):
    """``attention(causal=False)``, ``attention(kv_memory=)`` and
    ``decode_cross_attention`` on one attention layer, MHA and GQA."""
    jcfg, tcfg = (m.get_reduced(ARCH, dtype="float32", num_kv_heads=kv) for m in (jcfgs, tcfgs))
    params = jax.tree.map(np.asarray, jattn.init_attention(jax.random.PRNGKey(2), jcfg))
    tp = load_reference_params(tattn.Attention(tcfg, device=CPU, dtype=torch.float32), params)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, 9, jcfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(B, 5, jcfg.d_model)).astype(np.float32)
    jp, jx, jm = jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(mem)

    def ref(p, x, m):
        bi, _ = jattn.attention(p, x, jcfg, causal=False)
        cross, (k, v) = jattn.attention(p, x, jcfg, kv_memory=m)
        return bi, cross, k, v, jattn.decode_cross_attention(p, x[:, :1], jcfg, k, v)

    want = _compile(ref, jp, jx, jm)(jp, jx, jm)
    with torch.no_grad():
        bi, _ = tattn.attention(tp, torch.as_tensor(x), tcfg, causal=False)
        causal, _ = tattn.attention(tp, torch.as_tensor(x), tcfg)
        assert float((causal - bi).abs().max()) > 1e-3  # the mask matters
        cross, (k, v) = tattn.attention(tp, torch.as_tensor(x), tcfg,
                                        kv_memory=torch.as_tensor(mem))
        one = tattn.decode_cross_attention(tp, torch.as_tensor(x[:, :1]), tcfg, k, v)
    for got, w in zip((bi, cross, k, v, one), want):
        assert _rel(got, w) <= F32_TOL


def test_bundle_train_inputs_and_init():
    _, tcfg, *_ = _setup()
    bundle = build_model(tcfg, device=CPU)
    t = bundle.train_inputs(3, 9)
    assert t["tokens"].shape == (3, 9) and t["embeds"].shape == (3, 2, tcfg.d_model)
    model = bundle.init(1)
    assert isinstance(model, tencdec.EncDecLM) and hasattr(model, "lm_head")
    tree = tencdec.param_tree(model)
    assert tree["encoder"]["attn"]["q"]["w"].shape[0] == tcfg.encoder_layers
    assert tree["decoder"]["cross_attn"]["q"]["w"].shape[0] == tcfg.num_layers
    bound = tencdec.bind(tcfg, tree)
    assert bound.decoder[1].ln_x.scale.data_ptr() == tree["decoder"]["ln_x"]["scale"][1].data_ptr()

"""The port's zamba2 serving path against the JAX package's, on the CPU.

Parameters are drawn by the reference (``jax.random``) and carried across
with ``repro_torch.convert``; token ids and activations come from numpy
seeds. Every comparison is relative to max(1, max |reference|):

* float32: 1e-5 (the reference's own routes agree to about 1e-6; sums
  run in another order in torch than in XLA);
* bfloat16: 3e-2 (bf16 keeps about 3 significant digits, and the two
  frameworks round elementwise chains at different places).
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
from repro.models import hybrid as jhybrid
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch import configs as tcfgs
from repro_torch.convert import hybrid_params_from_reference, load_reference_params
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import hybrid as thybrid
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.registry import build_model

F32_TOL = 1e-5
BF16_TOL = 3e-2
CPU = torch.device("cpu")


def _close(got, want, tol=F32_TOL):
    got = np.asarray(torch.as_tensor(got).detach().to(torch.float32), dtype=np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), dtype=np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _reduced(**overrides):
    kw = {"dtype": "float32", **overrides}
    return jcfgs.get_reduced("zamba2-1.2b", **kw), tcfgs.get_reduced("zamba2-1.2b", **kw)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _hybrid(num_layers=2, dtype="float32"):
    """The reference's random init at the reduced config, and the port's copy."""
    jcfg, tcfg = _reduced(num_layers=num_layers, dtype=dtype)
    params = jhybrid.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, hybrid_params_from_reference(_numpy_tree(params), tcfg, CPU)


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_configs_equal_reference(arch):
    for jc, tc in ((jcfgs.get_config(arch), tcfgs.get_config(arch)),
                   (jcfgs.get_reduced(arch), tcfgs.get_reduced(arch))):
        assert _fields(jc) == _fields(tc)
        assert (jc.padded_vocab, jc.resolved_head_dim, jc.param_count(), jc.active_param_count()) \
            == (tc.padded_vocab, tc.resolved_head_dim, tc.param_count(), tc.active_param_count())
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 8)).astype(np.float32)
    pos = np.array([0, 3, 7, 100, 2047])
    _close(tlayers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    d, f = 16, 24
    h = rng.normal(size=(3, 4, d)).astype(np.float32)
    norm = {"scale": rng.normal(size=(d,)).astype(np.float32)}
    tnorm = load_reference_params(tlayers.RMSNorm(d, device=CPU, dtype=torch.float32), norm)
    _close(tlayers.rms_norm(tnorm, torch.as_tensor(h), 1e-5),
           jlayers.rms_norm(jax.tree.map(jnp.asarray, norm), jnp.asarray(h), 1e-5))
    ffn = _numpy_tree(jlayers.init_swiglu(jax.random.PRNGKey(1), d, f))
    tffn = load_reference_params(tlayers.SwiGLU(d, f, device=CPU, dtype=torch.float32), ffn)
    with torch.no_grad():
        _close(tlayers.swiglu(tffn, torch.as_tensor(h)), jlayers.swiglu(ffn, jnp.asarray(h)))


@pytest.mark.parametrize("window,softcap,kv", [(None, None, 4), (5, 30.0, 2)])
def test_attention_and_decode_attention_match_reference(window, softcap, kv):
    jcfg, tcfg = _reduced(sliding_window=window, logit_softcap=softcap, num_kv_heads=kv)
    params = _numpy_tree(jattn.init_attention(jax.random.PRNGKey(2), jcfg))
    tp = load_reference_params(tattn.Attention(tcfg, device=CPU, dtype=torch.float32), params)
    B, S = 2, 12
    x = np.random.default_rng(3).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y, (k, v) = tattn.attention(tp, torch.as_tensor(x), tcfg, window=window)
        jy, (jk, jv) = jattn.attention(params, jnp.asarray(x), jcfg, window=window)
        _close(y, jy)
        _close(k, jk)
        _close(v, jv)
        cache = tattn.init_cache(tcfg, B, S, torch.float32, CPU)
        jc = jattn.init_cache(jcfg, B, S, jnp.float32)
        for pos in range(S):
            y, cache = tattn.decode_attention(tp, torch.as_tensor(x[:, pos:pos + 1]), tcfg,
                                              cache, pos)
            jy, jc = jattn.decode_attention(params, jnp.asarray(x[:, pos:pos + 1]), jcfg, jc, pos)
            _close(y, jy)
        _close(cache["k"], jc["k"])
        assert np.array_equal(cache["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))


def test_chunked_causal_attention_matches_reference():
    """The q-block path the reference takes above 16384 tokens, at a small
    block size: the same function as the whole-matrix path."""
    jcfg, tcfg = _reduced(logit_softcap=20.0)
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, 64, 4, 8)).astype(np.float32) for _ in range(3))
    pos = np.arange(64)
    got = tattn._chunked_causal_attention(*(torch.as_tensor(a) for a in (q, k, v, pos)), tcfg,
                                          window=9, q_chunk=16)
    want = jattn._chunked_causal_attention(*(jnp.asarray(a) for a in (q, k, v, pos)), jcfg,
                                           window=9, q_chunk=16)
    _close(got, want)


def _mamba(seed=5):
    jcfg, tcfg = _reduced()
    params = _numpy_tree(jssm.init_mamba2(jax.random.PRNGKey(seed), jcfg))
    tp = load_reference_params(tssm.Mamba2(tcfg, device=CPU, dtype=torch.float32), params)
    return jcfg, tcfg, params, tp


@pytest.mark.parametrize("use_kernel", [False, True, None])
def test_mamba2_forward_routes_match_reference(use_kernel):
    """Both of the port's routes (None is the einsums on the CPU) against
    both of the reference's (its Pallas kernel in interpret mode), over
    three chunks so the inter-chunk recurrence runs."""
    jcfg, tcfg, params, tp = _mamba()
    x = np.random.default_rng(6).normal(size=(2, 48, jcfg.d_model)).astype(np.float32)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = tssm.mamba2_forward(tp, torch.as_tensor(x), tcfg, use_kernel=use_kernel)
    assert ops.launch_counts()["ssm_chunk"] == 0
    for ref_route in (False, True):
        _close(got, jssm.mamba2_forward(params, jnp.asarray(x), jcfg, use_kernel=ref_route))


def test_mamba2_decode_matches_reference():
    jcfg, tcfg, params, tp = _mamba()
    x = np.random.default_rng(7).normal(size=(2, 10, jcfg.d_model)).astype(np.float32)
    cache = tssm.init_mamba2_cache(tcfg, 2, torch.float32, CPU)
    jc = jssm.init_mamba2_cache(None, jcfg, 2, jnp.float32)
    with torch.no_grad():
        for t in range(10):
            y, cache = tssm.mamba2_decode(tp, torch.as_tensor(x[:, t:t + 1]), tcfg, cache)
            jy, jc = jssm.mamba2_decode(params, jnp.asarray(x[:, t:t + 1]), jcfg, jc)
            _close(y, jy)
    _close(cache["state"], jc["state"])
    _close(cache["conv_buf"], jc["conv_buf"])


@pytest.mark.parametrize("last_only", [False, True])
def test_hybrid_forward_matches_reference(last_only):
    jcfg, tcfg, params, model = _hybrid()
    tokens = _tokens(2, 48, jcfg.vocab_size)
    with torch.no_grad():
        got, aux = thybrid.forward(model, torch.as_tensor(tokens).long(), tcfg,
                                   last_only=last_only)
    want, _ = jhybrid.forward(params, jnp.asarray(tokens), jcfg, remat=False, last_only=last_only)
    assert got.shape == (2, 1 if last_only else 48, jcfg.padded_vocab)
    assert float(aux) == 0.0
    _close(got, want)


def test_hybrid_forward_bf16_matches_reference():
    jcfg, tcfg, params, model = _hybrid(dtype="bfloat16")
    assert model.embed.table.dtype == torch.bfloat16
    assert model.layers[0].mamba.A_log.dtype == torch.float32
    tokens = _tokens(2, 32, jcfg.vocab_size, seed=1)
    with torch.no_grad():
        got, _ = thybrid.forward(model, torch.as_tensor(tokens).long(), tcfg)
    want, _ = jhybrid.forward(params, jnp.asarray(tokens), jcfg, remat=False)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_decode_loop_matches_reference():
    """48 greedy-free decode steps (fixed token ids) through the bundle, with
    4 layers so the shared block has two sites and two KV caches."""
    jcfg, tcfg, params, model = _hybrid(num_layers=4)
    assert thybrid.attn_sites(tcfg) == [1, 3]
    B, S = 2, 48
    tokens = _tokens(B, S, jcfg.vocab_size, seed=2)
    step = jax.jit(lambda p, t, c, pos: jhybrid.decode_step(p, t, jcfg, c, pos))
    jc = jhybrid.init_cache(params, jcfg, B, S)
    bundle = build_model(tcfg, device="cpu")
    caches = bundle.init_cache(model, B, S)
    assert len(caches["mamba"]) == 4 and len(caches["attn"]) == 2
    for pos in range(S):
        got, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
        want, jc = step(params, jnp.asarray(tokens[:, pos:pos + 1]), jc, pos)
        _close(got, want)
    for i in range(4):
        _close(caches["mamba"][i]["state"], jc["mamba"]["state"][i])
    for s in range(2):
        _close(caches["attn"][s]["k"], jc["attn"]["k"][s])


def test_prefill_agrees_with_decode_loop():
    """The port's own two forms: the chunked prefill's last-token logits
    against feeding the same tokens one at a time through decode."""
    _, tcfg, _, model = _hybrid(num_layers=4)
    bundle = build_model(tcfg, device="cpu")
    tokens = _tokens(2, 48, tcfg.vocab_size, seed=3)
    logits, _ = bundle.prefill(model, {"tokens": tokens})
    caches = bundle.init_cache(model, 2, 48)
    for pos in range(48):
        step, caches = bundle.decode(model, tokens[:, pos:pos + 1], caches, pos)
    assert logits.shape == step.shape == (2, 1, tcfg.padded_vocab)
    assert float((logits - step).abs().max()) <= F32_TOL * max(1.0, float(logits.abs().max()))


def test_random_init_matches_reference_shapes_and_types():
    """The port's own random init (a seeded torch.Generator) builds the
    reference tree's names, shapes and types; same seed, same weights."""
    jcfg, tcfg = _reduced()
    jtree = jax.eval_shape(lambda: jhybrid.init_params(jax.random.PRNGKey(0), jcfg))
    model = thybrid.init_params(tcfg, seed=3, device="cpu")
    again = build_model(tcfg, device="cpu").init(3)
    sd = model.state_dict()
    for name, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = [k.key for k in name]
        if keys[0] == "layers":
            for i in range(jcfg.num_layers):
                t = sd[".".join(["layers", str(i), *keys[1:]])]
                assert tuple(t.shape) == leaf.shape[1:] and str(t.dtype)[6:] == str(leaf.dtype)
        else:
            t = sd[".".join(keys)]
            assert tuple(t.shape) == leaf.shape and str(t.dtype)[6:] == str(leaf.dtype)
    assert all(torch.equal(a, b) for a, b in zip(sd.values(), again.state_dict().values()))
    assert float(model.embed.table.detach().std()) == pytest.approx(0.02, rel=0.1)


def test_bundle_entry_points_and_refusals():
    _, tcfg = _reduced()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(tcfg)
    bundle = build_model(tcfg, device="cpu")
    model = bundle.init(0)
    assert model.embed.table.device == CPU
    with pytest.raises(NotImplementedError, match="A15b"):
        bundle.loss(model, {"tokens": np.zeros((1, 8), np.int32)})
    with pytest.raises(NotImplementedError, match="A15c"):
        build_model(tcfgs.get_reduced("llama3.2-1b"), device="cpu")
    with pytest.raises(ValueError, match="divisible by chunk"):
        bundle.prefill(model, {"tokens": np.zeros((1, 20), np.int32)})
    caches = bundle.init_cache(model, 1, 4)
    with pytest.raises(ValueError, match="outside the cache"):
        for pos in range(5):
            _, caches = bundle.decode(model, np.zeros((1, 1), np.int32), caches, pos)


def test_conversion_refuses_mismatched_trees():
    jcfg, tcfg, params, _ = _hybrid()
    tree = _numpy_tree(params)
    wrong = dict(tree, final_norm={"scale": tree["final_norm"]["scale"].astype(np.float64)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        hybrid_params_from_reference(wrong, tcfg, CPU)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="final_norm"):
        hybrid_params_from_reference(missing, tcfg, CPU)

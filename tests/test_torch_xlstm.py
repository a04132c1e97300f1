"""The port's xLSTM family (``models/xlstm.py``, ``models/xlstm_stack.py``)
against the JAX package's, on the CPU.

xlstm-1.3b's reduced float32 config: 2 blocks with ``slstm_every=2``
(block 0 an mLSTM, block 1 an sLSTM), d_model 128, 4 heads, chunk 16.
Sequences of 32 tokens after the shift run two chunks (the inter-chunk
scan), 16 tokens one. The reference draws the parameters (``jax.random``)
and ``convert.xlstm_params_from_reference`` carries them across; inputs
come from numpy seeds. Each reference function is compiled once a case at
XLA's backend optimization level 0 (as ``tests/test_torch_train.py``
does). Tolerances, relative to max(1, max |reference|):

* block outputs, logits, loss, decode steps and recurrent states 1e-5
  (float32 sums in another order than XLA's; the mLSTM's normalizer
  max(|q.n|, exp(-m)) divides by a dot product, so both packages sit
  about 2e-6 from a float64 evaluation);
* gradients 1e-4 per leaf;
* the port's prefill against its own decode loop 1e-5; remat on against
  off bit for bit;
* bfloat16 logits 3e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import layers as jlayers
from repro.models import xlstm as jxl
from repro.models import xlstm_stack as jstack
from repro_torch import configs as tcfgs
from repro_torch.convert import agent_params_from_reference, xlstm_params_from_reference
from repro_torch.core import spmd
from repro_torch.models import xlstm as txl
from repro_torch.models import xlstm_stack as tstack
from repro_torch.models.registry import build_model, model_class
from repro_torch.utils.tree import tree_flatten_with_path

ARCH = "xlstm-1.3b"
F32_TOL = 1e-5
GRAD_TOL = 1e-4
CPU = torch.device("cpu")
B = 2
FULL_PARAMS = 3_426_883_584  # xlstm-1.3b as configured (48 blocks, d_model 2048)


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
def _case(dtype="float32"):
    """The reference's random init at the reduced config and the port's
    copy on the CPU."""
    jcfg, tcfg = jcfgs.get_reduced(ARCH, dtype=dtype), tcfgs.get_reduced(ARCH, dtype=dtype)
    params = jstack.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, np_params, xlstm_params_from_reference(np_params, tcfg, CPU)


def _block(params, key, i=0):
    return jax.tree.map(lambda a: a[i], params[key])


def test_init_tree_matches_reference_names_shapes_and_types():
    """The port's own random init, stacked for two agents, against the
    reference's ``jax.vmap(init_params)`` tree at the bfloat16 default
    (``igate``, ``fgate`` and the sLSTM ``bias`` float32 in both); the full
    config's parameter count on the meta device, the reference's too."""
    jcfg, tcfg = jcfgs.get_reduced(ARCH), tcfgs.get_reduced(ARCH)
    want = jax.eval_shape(jax.vmap(lambda k: jstack.init_params(k, jcfg)),
                          jax.random.split(jax.random.PRNGKey(0), 2))
    bundle = build_model(tcfg, device=CPU)
    assert bundle.stacked == ("ln_m", "ln_s", "mlstm", "slstm")
    got = bundle.init_agents(2, 0)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(paths) == len(tree_flatten_with_path(got))
    for (name, t), (path, leaf) in zip(tree_flatten_with_path(got), paths):
        assert name == ".".join(k.key for k in path)
        assert tuple(t.shape) == leaf.shape and str(t.dtype)[6:] == str(leaf.dtype), name
    for leaf in ("mlstm.igate.w", "mlstm.fgate.w", "slstm.bias"):
        assert dict(tree_flatten_with_path(got))[leaf].dtype == torch.float32
    assert "lm_head" not in got
    again = bundle.init(3)
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(),
                                                  bundle.init(3).parameters()))
    full = tcfgs.get_config(ARCH)
    meta = model_class(full)(full, device="meta")
    assert sum(p.numel() for p in meta.parameters()) == FULL_PARAMS
    assert (len(meta.mlstm), len(meta.slstm)) == (42, 6)
    ref = jax.eval_shape(lambda k: jstack.init_params(k, jcfgs.get_config(ARCH)),
                         jax.random.PRNGKey(0))
    assert sum(x.size for x in jax.tree.leaves(ref)) == FULL_PARAMS


@pytest.mark.parametrize("S", [16, 32])
def test_block_forwards_match_reference(S):
    """``mlstm_forward`` (one chunk, or two through the inter-chunk scan)
    and ``slstm_forward`` on the same float32 input."""
    jcfg, tcfg, params, _, model = _case()
    x = np.random.default_rng(S).normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    for key, jfn, tfn, block in (("mlstm", jxl.mlstm_forward, txl.mlstm_forward, model.mlstm[0]),
                                 ("slstm", jxl.slstm_forward, txl.slstm_forward, model.slstm[0])):
        p = _block(params, key)
        want = _compile(lambda p, x: jfn(p, x, jcfg), p, x)(p, x)
        with torch.no_grad():
            got = tfn(block, torch.as_tensor(x), tcfg)
        assert _rel(got, want) <= F32_TOL, key
    with pytest.raises(ValueError, match="divisible by chunk"):
        txl.mlstm_forward(model.mlstm[0], torch.zeros((1, 24, tcfg.d_model)), tcfg)


def test_decode_cells_and_states_match_reference():
    """Six steps of ``mlstm_decode`` and ``slstm_decode`` from the initial
    caches (m = -1e30 and m = 0): outputs and every state leaf (C, n, m;
    c, n, h, m). Then the gradient of the first step's output against
    every leaf of the initial cache: at the sLSTM's first step the largest
    lane of each head's input gate gives n = 1 exactly, where ``max(n, 1)``
    ties; the reference gives each side half the gradient, and so must the
    port (``torch.clamp`` would pass the whole of it to n)."""
    jcfg, tcfg, params, _, model = _case()
    xs = np.random.default_rng(3).normal(size=(6, B, 1, tcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(4).normal(size=(B, 1, tcfg.d_model)).astype(np.float32)
    cases = (("mlstm", jxl.mlstm_decode, jxl.init_mlstm_cache, txl.mlstm_decode,
              txl.init_mlstm_cache, model.mlstm[0]),
             ("slstm", jxl.slstm_decode, jxl.init_slstm_cache, txl.slstm_decode,
              txl.init_slstm_cache, model.slstm[0]))
    for key, jdec, jinit, tdec, tinit, block in cases:
        p = _block(params, key)
        want_c, got_c = jinit(jcfg, B), tinit(tcfg, B, device="cpu")
        assert set(want_c) == set(got_c)
        for name in want_c:
            assert np.array_equal(got_c[name].numpy(), np.asarray(want_c[name])), (key, name)
        grad = _compile(jax.grad(lambda c, p, x: jnp.sum(jdec(p, x, jcfg, c)[0] * w)),
                        want_c, p, xs[0])(want_c, p, xs[0])
        start = {k: v.clone().requires_grad_() for k, v in got_c.items()}
        out, new = tdec(block, torch.as_tensor(xs[0]), tcfg, start)
        got_grad = torch.autograd.grad((out * torch.as_tensor(w)).sum(), list(start.values()))
        for name, g in zip(start, got_grad):
            assert _rel(g, grad[name]) <= GRAD_TOL, (key, name)
        if key == "slstm":
            assert bool((new["n"] == 1.0).any())
            assert float(np.abs(np.asarray(grad["n"])).max()) > 0
        step = _compile(lambda p, x, c: jdec(p, x, jcfg, c), p, xs[0], want_c)
        for x in xs:
            want, want_c = step(p, x, want_c)
            with torch.no_grad():
                got, got_c = tdec(block, torch.as_tensor(x), tcfg, got_c)
            assert _rel(got, want) <= F32_TOL, key
            for name in want_c:
                assert _rel(got_c[name], want_c[name]) <= F32_TOL, (key, name)


def _ref_forward_and_grads(jcfg, params, tokens):
    def f(p, t):
        logits, aux = jstack.forward(p, t[:, :-1], jcfg, remat=False)
        return jlayers.cross_entropy_loss(logits, t[:, 1:]) + aux, logits

    vg = jax.value_and_grad(f, has_aux=True)
    t = jnp.asarray(tokens)
    return _compile(vg, params, t)(params, t)


class _TieProbe:
    """Counts, while open, the sLSTM steps' normalizer entries equal to 1.0
    exactly, where ``max(n, 1)`` ties."""

    def __init__(self, monkeypatch):
        self.ties = 0
        inner = txl._slstm_step

        def probed(*args):
            new = inner(*args)
            self.ties += int((new["n"] == 1.0).sum())
            return new

        monkeypatch.setattr(txl, "_slstm_step", probed)


@pytest.mark.parametrize("S", [17, 33])
def test_forward_loss_and_gradients_match_reference(S, monkeypatch):
    """Logits, then the loss and every leaf's gradient through the bundle's
    loss over a bound tree, as a training round takes it (one agent). The
    seeded tokens put the sLSTM's ``max(n, 1)`` on a tie (at the first
    step: there the tied lane's n is exp(it - max(it)) = 1 on the largest
    lane, whose derivative is zero, so the tie's share reaches no parameter;
    the cell test holds the share itself against the initial state)."""
    jcfg, tcfg, params, np_params, model = _case()
    tokens = _tokens(jcfg.vocab_size, (B, S))
    (want_loss, want_logits), want_grads = _ref_forward_and_grads(jcfg, params, tokens)
    with torch.no_grad():
        logits, aux = tstack.forward(model, torch.as_tensor(tokens[:, :-1]).long(), tcfg)
    assert _rel(logits, want_logits) <= F32_TOL
    assert float(aux) == 0.0
    probe = _TieProbe(monkeypatch)
    bundle = build_model(tcfg, device=CPU)
    stacked = agent_params_from_reference(jax.tree.map(lambda x: x[None], np_params), tcfg, CPU)
    losses, grads = spmd.agent_losses_and_grads(bundle, stacked,
                                                {"tokens": torch.as_tensor(tokens[None])})
    assert probe.ties > 0
    assert _rel(losses[0], want_loss) <= F32_TOL
    wants = jax.tree.leaves(want_grads)
    for (name, g), w in zip(tree_flatten_with_path(grads), wants):
        assert _rel(g[0], w) <= GRAD_TOL, name


def test_float32_conditioning_of_the_normalizer_bounds_the_agreement():
    """The mLSTM's normalizer ``max(|q.n|, exp(-m))`` divides by a dot
    product that cancels: on these tokens (seed 17 of 2 x 16, the worst of
    30 seeds a length) |q||n| / |q.n| reaches about 140 on a row where the
    dot product is the denominator, and the port's logits differ from the
    reference's by 1.004e-5 of max(1, max |logit|). Neither route is at
    fault: each lies within 1e-5 of the port's float64 evaluation of the
    same parameters; the two float32 errors point different ways."""
    import copy

    jcfg, tcfg, params, _, model = _case()
    tokens = _tokens(jcfg.vocab_size, (B, 17), seed=17)[:, :-1]
    t = torch.as_tensor(tokens).long()
    want = _compile(lambda p, t: jstack.forward(p, t, jcfg, remat=False)[0], params,
                    jnp.asarray(tokens))(params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = tstack.forward(model, t, tcfg)
        # The normalizer's amplification in the first block.
        x = tstack.rms_norm(model.ln_m[0], model.embed.table[t], tcfg.norm_eps)
        q, k, _, ig, fg, _ = txl._mlstm_inputs(model.mlstm[0], x, tcfg)
        cum = torch.cumsum(fg, dim=1)
        logD = cum[:, :, None] - cum[:, None] + ig[:, None]
        logD = torch.where(torch.ones((16, 16), dtype=torch.bool).tril()[None, :, :, None], logD,
                           -torch.inf)
        m_row = logD.amax(dim=2)
        nvec = torch.einsum("bqth,bthd->bqhd", torch.exp(logD - m_row[:, :, None]), k)
        dot = torch.einsum("bqhd,bqhd->bqh", q, nvec).abs()
        amp = torch.einsum("bqhd,bqhd->bqh", q.abs(), nvec.abs()) / dot
        assert float(amp[dot > torch.exp(-m_row)].max()) > 100
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(txl, "F32", torch.float64)
        with torch.no_grad():
            exact, _ = tstack.forward(copy.deepcopy(model).double(), t, tcfg)
    assert exact.dtype == torch.float64
    assert _rel(got, exact.numpy()) <= F32_TOL and _rel(want, exact.numpy()) <= F32_TOL
    assert _rel(got, want) <= 2 * F32_TOL


def test_remat_on_and_off_give_the_same_bits():
    jcfg, tcfg, _, np_params, _ = _case()
    tokens = {"tokens": torch.as_tensor(_tokens(jcfg.vocab_size, (1, B, 33), seed=1))}
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


def test_prefill_and_decode_loop_match_reference():
    """``bundle.prefill`` (the forward's last-token logits) and 8 decode
    steps from ``init_cache``, against the reference's; the final states of
    every block. Then the port's prefill of 32 tokens against the same
    tokens fed one at a time through its own decode loop."""
    jcfg, tcfg, params, _, model = _case()
    tokens = _tokens(jcfg.vocab_size, (B, 32), seed=2)
    t = jnp.asarray(tokens)
    want = _compile(lambda p, t: jstack.forward(p, t, jcfg, remat=False, last_only=True)[0],
                    params, t)(params, t)
    bundle = build_model(tcfg, device=CPU)
    logits, aux = bundle.prefill(model, {"tokens": tokens})
    assert logits.shape == (B, 1, tcfg.padded_vocab) and float(aux) == 0.0
    assert _rel(logits, want) <= F32_TOL

    caches = jstack.init_cache(params, jcfg, B, 8)
    step = _compile(lambda p, t, c: jstack.decode_step(p, t, jcfg, c, 0), params, t[:, :1], caches)
    got_caches = bundle.init_cache(model, B, 8)
    for pos in range(8):
        want, caches = step(params, t[:, pos:pos + 1], caches)
        got, got_caches = bundle.decode(model, tokens[:, pos:pos + 1], got_caches, pos)
        assert _rel(got, want) <= F32_TOL, pos
    for kind in ("mlstm", "slstm"):
        assert len(got_caches[kind]) == caches[kind]["m"].shape[0]
        for i, c in enumerate(got_caches[kind]):
            for name in c:
                assert _rel(c[name], caches[kind][name][i]) <= F32_TOL, (kind, i, name)

    states = bundle.init_cache(model, B, 32)
    for pos in range(32):
        step_logits, states = bundle.decode(model, tokens[:, pos:pos + 1], states, pos)
    assert float((logits - step_logits).abs().max()) <= F32_TOL * max(
        1.0, float(logits.abs().max()))


def test_bf16_forward_matches_reference():
    """The reduced config in bfloat16: the port's logits within 3e-2 (bf16
    keeps about 3 significant digits; the frameworks round at different
    places) and of the model type."""
    jcfg, tcfg, params, _, model = _case("bfloat16")
    assert model.mlstm[0].q.w.dtype == torch.bfloat16
    assert model.mlstm[0].igate.w.dtype == torch.float32
    tokens = _tokens(jcfg.vocab_size, (B, 32), seed=8)
    with torch.no_grad():
        got, _ = tstack.forward(model, torch.as_tensor(tokens).long(), tcfg)
    t = jnp.asarray(tokens)
    want, _ = _compile(lambda p, t: jstack.forward(p, t, jcfg, remat=False), params, t)(params, t)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= 3e-2


def test_bundle_bind_and_param_tree_round_trip():
    """``param_tree`` gives the reference's tree; ``bind`` lays a model over
    it sharing storage; a tree missing a leaf or of another type is refused."""
    _, tcfg, _, np_params, model = _case()
    tree = tstack.param_tree(model)
    for (name, t), w in zip(tree_flatten_with_path(tree), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
    bound = tstack.bind(tcfg, tree)
    assert bound.slstm[0].r.data_ptr() == tree["slstm"]["r"][0].data_ptr()
    assert bound.ln_m[0].scale.data_ptr() == tree["ln_m"]["scale"][0].data_ptr()
    with pytest.raises(KeyError, match="no leaves"):
        tstack.bind(tcfg, {k: v for k, v in tree.items() if k != "ln_s"})
    wrong = dict(np_params, slstm=dict(np_params["slstm"],
                                       bias=np_params["slstm"]["bias"].astype(np.float64)))
    with pytest.raises(ValueError, match="slstm.0.bias"):
        xlstm_params_from_reference(wrong, tcfg, CPU)


def test_cache_initialisers_take_no_default_device():
    """``init_mlstm_cache`` and ``init_slstm_cache`` take ``device`` with no
    default, as ``attention.init_cache`` and ``ssm.init_mamba2_cache`` do:
    nothing lands on the CPU unless asked (``repro_torch/device.py``)."""
    tcfg = tcfgs.get_reduced(ARCH, dtype="float32")
    for init in (txl.init_mlstm_cache, txl.init_slstm_cache):
        with pytest.raises(TypeError, match="device"):
            init(tcfg, B)
        state = init(tcfg, B, device="cpu")
        assert all(t.device == CPU for t in state.values())

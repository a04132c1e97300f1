"""The port's MoE FFN (``models/moe.py``) against the JAX package's, on the CPU.

The reference's ``moe_ffn`` returns only ``(y, aux)``; its routing is read
here by the reference's own lines (``_ref_routing``: the float32 router,
``lax.top_k``, the rank-major queue positions, the one-hot slots), and
must equal the port's exactly: the chosen experts (``top_idx``) and the
kept mask. Values within 1e-5 and the aux loss within 1e-6, relative to
max(1, max |reference|) (float32 sums in another order than XLA's).
Cases: a token count that is not a multiple of ``group_size`` (the last
group zero-padded) and ``capacity_factor`` 0.5, so that choices overflow
their expert's capacity and drop.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import moe as jmoe
from repro_torch import configs as tcfgs
from repro_torch.convert import load_reference_params
from repro_torch.models import moe as tmoe

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _compile(f, *args):
    """``jax.jit(f)`` compiled at XLA's backend optimization level 0 (as
    ``tests/test_torch_train.py`` does): faster than the eager primitives."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().to(torch.float64))
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _cfgs(arch, **moe):
    out = []
    for mod in (jcfgs, tcfgs):
        base = mod.get_reduced(arch, dtype="float32")
        out.append(dataclasses.replace(base, moe=dataclasses.replace(base.moe, **moe)))
    return out


def _ref_routing(params, x, cfg):
    """The reference ``moe_ffn``'s routing, line for line: ``top_idx`` and
    the kept mask (G, gs, k) of the grouped tokens."""
    mcfg = cfg.moe
    B, S, d = x.shape
    E, k = mcfg.num_experts, mcfg.top_k
    T = B * S
    gs = min(mcfg.group_size, T)
    G = -(-T // gs)
    xt = jnp.pad(x.reshape(T, d), ((0, G * gs - T), (0, 0)))
    xg = xt.reshape(G, gs, d)
    logits = (xg.astype(jnp.float32) @ params["router"]["w"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_idx = jax.lax.top_k(probs, k)
    C = jmoe.capacity(gs, k, E, mcfg.capacity_factor)
    onehot = jax.nn.one_hot(top_idx, E, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(G, k * gs, E)
    qpos = jnp.cumsum(flat, axis=1) - flat
    qpos = qpos.reshape(G, k, gs, E).transpose(0, 2, 1, 3)
    keep = ((qpos < C) & (onehot > 0)).any(axis=-1)
    return top_idx, keep


CASES = {
    # T = 21 tokens in groups of 16 (the last one 11 rows of padding), C = 4
    # of 2 x 16 choices over 4 experts: choices drop.
    "ragged_cf0.5": dict(arch="granite-moe-3b-a800m", shape=(3, 7), moe=dict(
        group_size=16, capacity_factor=0.5)),
    # grok's reduced MoE: one group of 32, C = 20.
    "grok_one_group": dict(arch="grok-1-314b", shape=(2, 16), moe={}),
    # a group larger than T (gs = min(group_size, T)), cf 1.25.
    "short": dict(arch="granite-moe-3b-a800m", shape=(1, 5), moe={}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_routing_values_and_aux_match_reference(case):
    c = CASES[case]
    jcfg, tcfg = _cfgs(c["arch"], **c["moe"])
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(1), jcfg))
    tp = load_reference_params(tmoe.MoE(tcfg, device=CPU, dtype=torch.float32), params)
    x = np.random.default_rng(2).normal(size=(*c["shape"], jcfg.d_model)).astype(np.float32)
    jp, jx = jax.tree.map(jnp.asarray, params), jnp.asarray(x)
    ref = _compile(lambda p, x: (_ref_routing(p, x, jcfg), jmoe.moe_ffn(p, x, jcfg)), jp, jx)
    (want_idx, want_keep), (want_y, want_aux) = jax.tree.map(np.asarray, ref(jp, jx))
    C = jmoe.capacity(min(jcfg.moe.group_size, x.shape[0] * x.shape[1]), jcfg.moe.top_k,
                      jcfg.moe.num_experts, jcfg.moe.capacity_factor)
    with torch.no_grad():
        xg, T = tmoe._groups(torch.as_tensor(x), min(tcfg.moe.group_size, x.shape[0] * x.shape[1]))
        r = tmoe.route(tp, xg, tcfg)
        y, aux = tmoe.moe_ffn(tp, torch.as_tensor(x), tcfg)
    assert r.dispatch.shape[-1] == C
    np.testing.assert_array_equal(r.top_idx.numpy(), want_idx)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    if case == "ragged_cf0.5":
        assert T % tcfg.moe.group_size and not want_keep.all()
    assert _rel(y, want_y) <= 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * max(1.0, abs(float(want_aux)))


def test_moe_gradients_match_reference():
    """The gradient of a scalar of the output and the aux through the
    dropped choices' zero rows, per parameter, within 1e-4."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", group_size=16, capacity_factor=0.5)
    params = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3), jcfg))
    tp = load_reference_params(tmoe.MoE(tcfg, device=CPU, dtype=torch.float32), params)
    x = np.random.default_rng(4).normal(size=(3, 7, jcfg.d_model)).astype(np.float32)
    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, x, jcfg)
        return jnp.sum(y * w) + aux

    jp, jx = jax.tree.map(jnp.asarray, params), jnp.asarray(x)
    want = _compile(jax.grad(jloss, argnums=(0, 1)), jp, jx)(jp, jx)
    xt = torch.as_tensor(x).requires_grad_(True)
    y, aux = tmoe.moe_ffn(tp, xt, tcfg)
    got = torch.autograd.grad((y * torch.as_tensor(w)).sum() + aux,
                              [tp.down, tp.gate, tp.router.w, tp.up, xt])
    wants = [want[0]["down"], want[0]["gate"], want[0]["router"]["w"], want[0]["up"], want[1]]
    for g, wnt in zip(got, wants):
        assert _rel(g, wnt) <= 1e-4


@pytest.mark.parametrize("gs,k,E,cf", [(256, 8, 40, 1.25), (4, 8, 40, 1.25), (16, 2, 4, 0.5),
                                        (1, 1, 64, 0.1)])
def test_capacity_matches_reference(gs, k, E, cf):
    assert tmoe.capacity(gs, k, E, cf) == jmoe.capacity(gs, k, E, cf)
    assert tmoe.capacity(gs, k, E, cf) == max(math.ceil(gs * k * cf / E), 1)


def test_tied_router_probabilities_go_to_the_lower_expert():
    """Zero rows (the padding) give uniform router probabilities: the
    stable sort picks experts 0..k-1, as ``lax.top_k`` does. Three such
    tokens in a group of 3 (C = 2): the third token's choices queue third
    at experts 0 and 1, and drop."""
    _, tcfg = _cfgs("granite-moe-3b-a800m")
    tp = tmoe.MoE(tcfg, device=CPU, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        r = tmoe.route(tp, torch.zeros((1, 3, tcfg.d_model)), tcfg)
    assert r.top_idx.tolist() == [[list(range(tcfg.moe.top_k))] * 3]
    assert r.keep.tolist() == [[[True, True], [True, True], [False, False]]]

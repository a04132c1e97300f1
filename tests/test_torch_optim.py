"""The port's tree helpers, optimizers, token stream and cross-entropy
against the JAX package's, on the CPU, on the same numpy inputs.

Tolerance 1e-6 relative to max(1, max |reference|): float32 sums and
powers taken in another order than XLA's. The token stream is numpy in
both packages and must give equal arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import token_stream as jtoken_stream
from repro.models.layers import cross_entropy_loss as jcross_entropy
from repro.optim import adamw as jadamw
from repro.optim import apply_updates as japply
from repro.optim import sgd as jsgd
from repro.utils import tree as jtree
from repro_torch.data.synthetic import token_stream
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.optim import adamw, apply_updates, sgd
from repro_torch.utils import tree as ttree

TOL = 1e-6


def _arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"b": {"w": (scale * rng.normal(size=(3, 4))).astype(np.float32),
                  "bias": (scale * rng.normal(size=(4,))).astype(np.float32)},
            "a": (scale * rng.normal(size=(2, 2, 3))).astype(np.float32)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return ttree.tree_map(torch.from_numpy, tree)


def _close_tree(got, want, tol=TOL):
    gl = ttree.tree_flatten_with_path(got)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for (_, g), w in zip(gl, wl):
        w = np.asarray(w, dtype=np.float64)
        g = g.detach().to(torch.float64).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.abs(g - w).max() <= tol * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("name", ["tree_add", "tree_sub", "tree_scale", "tree_axpy",
                                  "tree_zeros_like", "tree_global_norm", "tree_size",
                                  "tree_cast"])
def test_tree_helpers_match_reference(name):
    a, b = _arrays(0), _arrays(1)
    args = {"tree_add": (a, b), "tree_sub": (a, b), "tree_scale": (0.3, a),
            "tree_axpy": (-0.7, a, b), "tree_zeros_like": (a,), "tree_global_norm": (a,),
            "tree_size": (a,), "tree_cast": (a,)}[name]
    conv = lambda f, x: x if isinstance(x, float) else f(x)  # noqa: E731
    if name == "tree_cast":
        want = jtree.tree_cast(_j(a), jnp.float64)
        got = ttree.tree_cast(_t(a), torch.float64)
    else:
        want = getattr(jtree, name)(*(conv(_j, x) for x in args))
        got = getattr(ttree, name)(*(conv(_t, x) for x in args))
    if name == "tree_size":
        assert got == want == 3 * 4 + 4 + 12
    elif name == "tree_global_norm":
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= TOL * max(1.0, float(want))
    else:
        _close_tree(got, want)


def test_tree_leaves_follow_the_reference_order():
    a = _arrays(2)
    names = [n for n, _ in ttree.tree_flatten_with_path(_t(a))]
    assert names == ["a", "b.bias", "b.w"]
    for got, want in zip(ttree.tree_leaves(_t(a)), jax.tree.leaves(_j(a))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("opt", ["sgd", "sgd_momentum", "adamw"])
def test_optimizer_three_steps_match_reference(opt):
    factories = {"sgd": (jsgd(0.1), sgd(0.1)),
                 "sgd_momentum": (jsgd(0.1, momentum=0.9), sgd(0.1, momentum=0.9)),
                 "adamw": (jadamw(0.01), adamw(0.01))}[opt]
    (jinit, jupd), (tinit, tupd) = factories
    jp, tp = _j(_arrays(3)), _t(_arrays(3))
    js, ts = jinit(jp), tinit(tp)
    for step in range(3):
        g = _arrays(10 + step, scale=0.5)
        ju, js = jupd(_j(g), js, jp)
        tu, ts = tupd(_t(g), ts, tp)
        _close_tree(tu, ju)
        jp, tp = japply(jp, ju), apply_updates(tp, tu)
        _close_tree(tp, jp)
    if opt == "adamw":
        assert int(ts["t"]) == int(js["t"]) == 3
        _close_tree(ts["nu"], js["nu"])


def test_apply_updates_casts_back_to_each_leaf_type():
    w = np.linspace(-2.0, 2.0, 7).astype(np.float32)
    u = np.full(7, 1e-2, np.float32)
    got = apply_updates({"w": torch.from_numpy(w).to(torch.bfloat16), "b": torch.from_numpy(w)},
                        {"w": torch.from_numpy(u), "b": torch.from_numpy(u)})
    want = japply({"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(w)},
                  {"w": jnp.asarray(u), "b": jnp.asarray(u)})
    assert got["w"].dtype == torch.bfloat16 and got["b"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"].float().numpy(), np.asarray(want["w"], np.float32))
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))


@pytest.mark.parametrize("vocab,batch,seq,seed,agents", [(97, 4, 9, 0, 2), (512, 6, 33, 5, 3)])
def test_token_stream_equals_reference(vocab, batch, seq, seed, agents):
    got, want = token_stream(vocab, batch, seq, seed, agents), jtoken_stream(vocab, batch, seq,
                                                                             seed, agents)
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(4)
    logits = (3.0 * rng.normal(size=(2, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                          None if mask is None else jnp.asarray(mask))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= TOL * max(1.0, abs(float(want)))


def test_cross_entropy_of_an_empty_mask_is_zero_as_in_the_reference():
    logits = torch.randn(1, 3, 5)
    got = cross_entropy_loss(logits, torch.zeros(1, 3, dtype=torch.int32), torch.zeros(1, 3))
    want = jcross_entropy(jnp.asarray(logits.numpy()), jnp.zeros((1, 3), jnp.int32),
                          jnp.zeros((1, 3)))
    assert float(got) == float(want) == 0.0

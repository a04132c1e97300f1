"""The port's P2P-DP training round against the JAX package's, on the CPU.

zamba2-1.2b's reduced config in float32 (2 layers, one shared-attention
site, chunk 16), A = 4 agents whose parameters the reference draws
(``jax.vmap(bundle.init)``) and ``convert.agent_params_from_reference``
carries across; token batches of 2 x 33 (two chunks) per agent from a
numpy seed. The reference's ``make_train_step`` runs with a stand-in
mesh (``.shape = {"data": 4, "model": 1}``), which its dense and sparse
routes read only through ``num_agents``. Its DP noise is rebuilt from
its keys (``split(key, A)``, then ``split(key_a, n_leaves)`` in leaf
order) and given to the port by leaf name through ``draws=``.

Tolerances, relative to max(1, max |reference|):
* loss 1e-5, gradients 1e-4 per leaf (float32 sums in another order than
  XLA's, through two layers and the backward);
* gossip 1e-6 (a float32 sum of at most four terms, or a matmul over A);
* ``clip_and_noise`` 1e-6 (the global norm is the sum of the leaves'
  float32 sums of squares in the reference's leaf order, each leaf summed
  in torch's order: the clip scale moves by about 1e-7);
* a round's parameters and metrics 1e-4; ``eps_step`` and ``noise_scale``
  are host float math and must be equal.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.configs.base import P2PConfig as JP2PConfig
from repro.core import spmd as jspmd
from repro.models import build_model as jbuild_model
from repro.models import hybrid as jhybrid
from repro_torch.configs import get_reduced
from repro_torch.configs.base import P2PConfig
from repro_torch.convert import agent_params_from_reference, hybrid_params_from_reference
from repro_torch.core import spmd
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model, hybrid
from repro_torch.utils.tree import tree_flatten_with_path, tree_map

A = 4
CPU = torch.device("cpu")
MESH = types.SimpleNamespace(shape={"data": A, "model": 1})
P2P = dict(mu=0.2, neighbor_offsets=(1,), gossip_dtype=None, alpha=0.5)
DP = dict(eps_bar=50.0, planned_rounds=2, clip=1.0)


def _compile(f, *args):
    """``jax.jit(f)`` compiled for ``args`` at XLA's backend optimization
    level 0: the reference's steps compile in about 30% less time on the
    CPU, their values within about 2e-7 of the default level's."""
    return jax.jit(f).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).detach().to(torch.float64))
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _close_stacked(got_tree, want_tree, tol):
    names = [n for n, _ in tree_flatten_with_path(got_tree)]
    wants = jax.tree.leaves(want_tree)
    assert len(names) == len(wants)
    for (name, g), w in zip(tree_flatten_with_path(got_tree), wants):
        assert _rel(g, w) <= tol, name


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The rounds here are many small operations. With torch's default
    pool (a thread a core) in each of several test processes sharing the
    cores, every operation's threads wait on each other: six such processes
    on eight cores took about 28 s a reduced round, against 0.19 s with one
    thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget_reduced("zamba2-1.2b", dtype="float32"), get_reduced("zamba2-1.2b",
                                                                        dtype="float32")
    jm = jbuild_model(jcfg, remat=False)
    keys = jax.random.split(jax.random.PRNGKey(0), A)
    jparams = _compile(jax.vmap(jm.init), keys)(keys)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (A, 2, 33)).astype(np.int32)
    # The reference's clip_and_noise, compiled once: given zero gradients
    # and noise scale 1 it returns its draws exactly.
    zeros = jax.tree.map(lambda x: jnp.zeros_like(x[0]), jparams)
    perturb = _compile(jspmd.clip_and_noise, zeros, jax.random.PRNGKey(0), 1.0, 1.0)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jm=jm, jparams=jparams,
                                 np_params=jax.tree.map(np.asarray, jparams), tokens=tokens,
                                 bundle=build_model(tcfg, device=CPU), cache={},
                                 perturb=perturb)


def _port_params(s):
    return agent_params_from_reference(s.np_params, s.tcfg, CPU)


@pytest.fixture(scope="module")
def ref_grads(setup):
    """The reference's per-agent loss and gradient (remat on, as its default)."""
    vg = jax.vmap(jax.value_and_grad(
        lambda p, t: jhybrid.loss_fn(p, {"tokens": t}, setup.jcfg)))
    tokens = jnp.asarray(setup.tokens)
    return _compile(vg, setup.jparams, tokens)(setup.jparams, tokens)


def test_agent_params_carry_the_stacked_layout(setup):
    p = _port_params(setup)
    for (name, t), w in zip(tree_flatten_with_path(p), jax.tree.leaves(setup.np_params)):
        assert t.shape == w.shape and t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), w)
    assert spmd._stacked_count(p) == A
    bad = jax.tree.map(lambda x: x, setup.np_params)
    bad["final_norm"]["scale"] = bad["final_norm"]["scale"][:, :-1]
    with pytest.raises(ValueError, match="final_norm.scale"):
        agent_params_from_reference(bad, setup.tcfg, CPU)


def test_loss_and_gradient_match_reference(setup, ref_grads):
    want_loss, want_grads = ref_grads
    losses, grads = spmd.agent_losses_and_grads(setup.bundle, _port_params(setup),
                                                {"tokens": torch.from_numpy(setup.tokens)})
    assert _rel(losses, want_loss) <= 1e-5
    _close_stacked(grads, want_grads, 1e-4)


def test_hybrid_loss_fn_on_one_model_matches_reference(setup, ref_grads):
    """``hybrid.loss_fn`` on a ``HybridLM`` (not a bound view): agent 0's
    loss, built outside inference mode (its gradient is the bound view's,
    held in ``test_loss_and_gradient_match_reference``)."""
    want_loss, _ = ref_grads
    tree0 = jax.tree.map(lambda x: x[0], setup.np_params)
    lm = hybrid_params_from_reference(tree0, setup.tcfg, CPU)
    loss = hybrid.loss_fn(lm, {"tokens": torch.from_numpy(setup.tokens[0]).long()}, setup.tcfg)
    assert loss.requires_grad and not loss.is_inference()
    assert _rel(loss, want_loss[0]) <= 1e-5


def test_remat_on_and_off_give_the_same_bits(setup):
    batch = {"tokens": torch.from_numpy(setup.tokens)}
    on = spmd.agent_losses_and_grads(build_model(setup.tcfg, remat=True, device=CPU),
                                     _port_params(setup), batch)
    off = spmd.agent_losses_and_grads(build_model(setup.tcfg, remat=False, device=CPU),
                                      _port_params(setup), batch)
    assert torch.equal(on[0], off[0])
    for (name, a), (_, b) in zip(tree_flatten_with_path(on[1]), tree_flatten_with_path(off[1])):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("remat", [True, False])
def test_remat_recomputes_each_mamba2_block_once(setup, monkeypatch, remat):
    """Counted on the CPU at the block's entry: a round runs each layer's
    forward A times, and the backward recomputes it once more with remat
    (on the card each run launches ``ssm_chunk``: 2 L A launches)."""
    calls = []
    inner = hybrid.ssm.mamba2_forward

    def counted(*a, **k):
        calls.append(torch.is_grad_enabled())
        return inner(*a, **k)

    monkeypatch.setattr(hybrid.ssm, "mamba2_forward", counted)
    bundle = build_model(setup.tcfg, remat=remat, device=CPU)
    spmd.agent_losses_and_grads(bundle, _port_params(setup),
                                {"tokens": torch.from_numpy(setup.tokens)})
    L = setup.tcfg.num_layers
    assert len(calls) == (2 if remat else 1) * L * A


OFFSET_CASES = [((1,), 4), ((1, 2), 4), ((1, 2), 5), ((4,), 4)]


def _circulant(offsets, n):
    W = np.zeros((n, n))
    for o in offsets:
        for i in range(n):
            W[i, (i + o) % n] = W[i, (i - o) % n] = 1.0
    return W / W.sum(1, keepdims=True)


def _stacked_tree(n, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 3, 5)).astype(np.float32),
            "v": {"b": rng.normal(size=(n, 7)).astype(np.float32)}}


@pytest.mark.parametrize("offsets,n", OFFSET_CASES)
def test_gossip_routes_match_the_reference_circulant(offsets, n):
    tree = _stacked_tree(n, n + len(offsets))
    W = _circulant(offsets, n)
    want = jspmd.gossip_dense(jax.tree.map(jnp.asarray, tree), jnp.asarray(W, jnp.float32))
    residues = sorted({s * o % n for o in offsets for s in (1, -1)})
    idx = (np.arange(n)[:, None] + np.asarray(residues)[None, :]) % n
    w = np.full(idx.shape, 1.0 / len(residues), np.float32)
    want_gather = jspmd.gossip_gather(jax.tree.map(jnp.asarray, tree), jnp.asarray(idx),
                                      jnp.asarray(w))
    t = tree_map(torch.from_numpy, tree)
    for got in (spmd.gossip_ppermute(t, offsets), spmd.gossip_dense(t, W.astype(np.float32)),
                spmd.gossip_gather(t, idx, w)):
        _close_stacked(got, want, 1e-6)
        _close_stacked(got, want_gather, 1e-6)


def test_gossip_dtype_casts_on_the_roll_route_only(setup):
    """The ring route ships its payload in ``gossip_dtype``; the dense and
    sparse routes ignore it, in the reference and here."""
    tree = _stacked_tree(4, 9)
    t = tree_map(torch.from_numpy, tree)
    got = spmd.gossip_ppermute(t, (1,), torch.bfloat16)
    rounded = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16).astype(jnp.float32), tree)
    _close_stacked(got, jspmd.gossip_dense(rounded, jnp.asarray(_circulant((1,), 4),
                                                                jnp.float32)), 1e-6)
    assert not torch.equal(got["w"], spmd.gossip_ppermute(t, (1,))["w"])

    # One chunk a sequence: the update is what these rounds hold.
    batch = {"tokens": torch.from_numpy(setup.tokens[:, :, :17])}
    out = {}
    for route in ("ppermute", "dense", "sparse"):
        for dt in (None, "bfloat16"):
            cfg = P2PConfig(dp_enabled=False, mu=0.2, neighbor_offsets=(1,), gossip_dtype=dt)
            step, _, _ = spmd.make_train_step(setup.bundle, cfg, A, 2, alpha=0.5, gossip=route)
            out[route, dt] = step(_port_params(setup), batch)[0]["embed"]["table"]
    assert not torch.equal(out["ppermute", None], out["ppermute", "bfloat16"])
    assert torch.equal(out["dense", None], out["dense", "bfloat16"])
    assert torch.equal(out["sparse", None], out["sparse", "bfloat16"])


def _ref_draws(s, keys):
    """The standard Laplace draws the reference's ``clip_and_noise`` takes
    from each key of ``keys`` (``split(key_a, n_leaves)`` in leaf order),
    stacked on a leading axis, by leaf name: its own output on zero
    gradients at noise scale 1."""
    zeros = jax.tree.map(lambda x: jnp.zeros_like(x[0]), s.jparams)
    per = [jax.tree.leaves(s.perturb(zeros, k, 1.0, 1.0)) for k in keys]
    return {n: np.stack([np.asarray(p[i]) for p in per]) for i, n in enumerate(_names(s))}


def _names(s):
    return [n for n, _ in tree_flatten_with_path(s.np_params)]


@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_clip_and_noise_matches_reference_with_its_draws(setup, ref_grads, clip):
    """Agent 0's gradient and the reference's key 7."""
    _, want_grads = ref_grads
    key = jax.random.PRNGKey(7)
    want = setup.perturb(jax.tree.map(lambda x: x[0], want_grads), key, clip, 0.3)
    draws = {n: d[0] for n, d in _ref_draws(setup, [key]).items()}
    g0 = tree_map(lambda x: torch.from_numpy(np.array(x[0])), want_grads)
    _close_stacked(spmd.clip_and_noise(g0, None, clip, 0.3, draws=draws), want, 1e-6)
    norm = float(spmd._tree_norm(g0))
    assert abs(norm - float(jspmd._tree_norm(jax.tree.map(lambda x: x[0], want_grads)))) <= 1e-6 * norm
    clipped = spmd.clip_and_noise(g0, None, clip, 0.0, draws=draws)
    assert float(spmd._tree_norm(clipped)) <= min(clip, norm) * (1 + 1e-6)


def _reference_rounds(s, route, dp):
    """Two reference rounds (keys 1 and 2) from the carried-over agents,
    the parameters after each and the metrics; compiled once per case."""
    if (route, dp) not in s.cache:
        cfg = JP2PConfig(dp_enabled=dp, mu=P2P["mu"], neighbor_offsets=P2P["neighbor_offsets"],
                         gossip_dtype=None, **(DP if dp else {}))
        step, eps, ns = jspmd.make_train_step(s.jm, cfg, MESH, 2, alpha=P2P["alpha"], gossip=route)
        batch = {"tokens": jnp.asarray(s.tokens)}
        step = _compile(step, s.jparams, batch, jax.random.PRNGKey(0))
        p, outs = s.jparams, []
        for k in (1, 2):
            p, m = step(p, batch, jax.random.PRNGKey(k))
            outs.append((jax.tree.map(np.asarray, p), {k2: float(v) for k2, v in m.items()}))
        s.cache[route, dp] = (outs, eps, ns)
    return s.cache[route, dp]


@pytest.mark.parametrize("dp", [False, True], ids=["dp_off", "dp_on"])
@pytest.mark.parametrize("route", ["dense", "sparse", "ppermute"])
def test_train_step_matches_reference(setup, route, dp):
    """Every route against the reference's dense route: its ring needs one
    device per agent (``tests/test_spmd.py`` holds it to the dense one),
    and its sparse route gathers the dense W's distinct-target set by
    construction (its ``gossip_gather`` and ``gossip_dense`` agree in
    ``test_gossip_routes_match_the_reference_circulant``)."""
    outs, eps, ns = _reference_rounds(setup, "dense", dp)
    cfg = P2PConfig(dp_enabled=dp, mu=P2P["mu"], neighbor_offsets=P2P["neighbor_offsets"],
                    gossip_dtype=None, **(DP if dp else {}))
    step, t_eps, t_ns = spmd.make_train_step(setup.bundle, cfg, MESH, 2, alpha=P2P["alpha"],
                                             gossip=route)
    assert (t_eps, t_ns) == (eps, ns)
    params = _port_params(setup)
    for k, (want_p, want_m) in zip((1, 2), outs):
        draws = _ref_draws(setup, jax.random.split(jax.random.PRNGKey(k), A)) if dp else None
        params, metrics = step(params, {"tokens": torch.from_numpy(setup.tokens)}, draws=draws)
        _close_stacked(params, want_p, 1e-4)
        for name in ("loss", "grad_norm"):
            assert abs(float(metrics[name]) - want_m[name]) <= 1e-4 * max(1.0, abs(want_m[name]))


def test_train_step_with_a_generator_draws_laplace_noise_of_the_scale(setup):
    cfg = P2PConfig(dp_enabled=True, mu=0.2, neighbor_offsets=(1,), gossip_dtype=None, **DP)
    step, eps, ns = spmd.make_train_step(setup.bundle, cfg, A, 2, alpha=0.5, gossip="ppermute")
    from repro_torch.core.privacy import invert_uniform_budget

    assert eps == invert_uniform_budget(DP["eps_bar"], DP["planned_rounds"], cfg.delta_bar)
    assert ns == 2.0 * DP["clip"] / (eps * 2)
    batch = {"tokens": torch.from_numpy(setup.tokens[:, :, :17])}
    with pytest.raises(ValueError, match="generator or draws"):
        step(_port_params(setup), batch)
    a = step(_port_params(setup), batch, torch.Generator().manual_seed(3))[0]
    b = step(_port_params(setup), batch, torch.Generator().manual_seed(3))[0]
    c = step(_port_params(setup), batch, torch.Generator().manual_seed(4))[0]
    assert torch.equal(a["embed"]["table"], b["embed"]["table"])
    assert not torch.equal(a["embed"]["table"], c["embed"]["table"])
    with pytest.raises(ValueError, match="stack 4 agents, the step 3"):
        spmd.make_train_step(setup.bundle, cfg, 3, 2)[0](_port_params(setup), batch)


@pytest.mark.parametrize("route,dp", [("ppermute", False), ("dense", True), ("sparse", True)],
                         ids=["ppermute-dp_off", "dense-dp_on", "sparse-dp_on"])
def test_blocked_update_matches_one_block(setup, monkeypatch, route, dp):
    """The update walks each stacked leaf in column blocks (``BLOCK_ELEMS``,
    sized for full-width leaves); blocks of 1,000 elements give the bits of
    one block per leaf (the norms sum in another order: 1e-6 with DP on)."""
    cfg = P2PConfig(dp_enabled=dp, mu=0.2, neighbor_offsets=(1, 2), gossip_dtype=None,
                    **(DP if dp else {}))
    step, _, _ = spmd.make_train_step(setup.bundle, cfg, A, 2, alpha=0.5, gossip=route)
    batch = {"tokens": torch.from_numpy(setup.tokens[:, :, :17])}
    draws = {n: np.random.default_rng(3).laplace(size=x.shape).astype(np.float32)
             for n, x in tree_flatten_with_path(setup.np_params)} if dp else None
    whole, whole_m = step(_port_params(setup), batch, draws=draws)
    monkeypatch.setattr(spmd, "BLOCK_ELEMS", 1000)
    assert len(spmd._column_blocks(whole["embed"]["table"], A)) > 1
    blocked, blocked_m = step(_port_params(setup), batch, draws=draws)
    for (name, a), (_, b) in zip(tree_flatten_with_path(blocked), tree_flatten_with_path(whole)):
        if dp:
            assert _rel(a, b.numpy()) <= 1e-6, name
        else:
            assert torch.equal(a, b), name
    assert abs(float(blocked_m["grad_norm"]) - float(whole_m["grad_norm"])) <= 1e-6 * float(
        whole_m["grad_norm"])


def test_fedavg_step_matches_reference_and_keeps_agents_identical(setup):
    same = jax.tree.map(lambda x: np.broadcast_to(x[:1], x.shape).copy(), setup.np_params)
    jp, tp = jax.tree.map(jnp.asarray, same), agent_params_from_reference(same, setup.tcfg, CPU)
    jbatch = {"tokens": jnp.asarray(setup.tokens)}
    step = _compile(jspmd.make_fedavg_step(setup.jm, MESH, lr=0.05), jp, jbatch,
                    jax.random.PRNGKey(0))
    tstep = spmd.make_fedavg_step(setup.bundle, MESH, lr=0.05)
    batch = {"tokens": torch.from_numpy(setup.tokens)}
    for k in (1, 2):
        jp, jm = step(jp, jbatch, jax.random.PRNGKey(k))
        tp, tm = tstep(tp, batch)
        _close_stacked(tp, jp, 1e-4)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4 * max(1.0, float(jm["loss"]))
    for name, x in tree_flatten_with_path(tp):
        assert all(torch.equal(x[0], x[a]) for a in range(1, A)), name


def test_reduced_rounds_descend_on_one_batch(setup):
    """``tests/test_spmd.py``'s gate with zamba2: A = 1, mu = 0.3, DP off,
    two rounds on one batch; the second round's loss is below the first's."""
    cfg = P2PConfig(agent_mode="full", dp_enabled=False, mu=0.3)
    params = setup.bundle.init_agents(1, 0)
    step, _, _ = spmd.make_train_step(setup.bundle, cfg, types.SimpleNamespace(
        shape={"data": 1, "model": 1}), local_batch_size=2)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, setup.tcfg.vocab_size, (1, 2, 17)).astype(np.int32))}
    params, m1 = step(params, batch)
    params, m2 = step(params, batch)
    assert np.isfinite(float(m1["loss"])) and float(m2["loss"]) < float(m1["loss"])


def test_bundle_surface(setup):
    b = setup.bundle
    t = b.train_inputs(3, 9)
    assert t["tokens"].shape == (3, 9) and t["tokens"].dtype == torch.int32
    stacked, again = b.init_agents(2, 5), b.init_agents(2, 5)
    for (name, x), (_, y) in zip(tree_flatten_with_path(stacked), tree_flatten_with_path(again)):
        assert x.shape[0] == 2 and torch.equal(x, y), name
    emb = stacked["embed"]["table"]
    assert not torch.equal(emb[0], emb[1])
    assert spmd.num_agents(MESH, "full") == A and spmd.num_agents(3, "full") == 3
    assert spmd.num_agents(types.SimpleNamespace(shape={"pod": 2, "data": 3}), "silo") == 2
    assert spmd.agent_axes_of(MESH) == ("data",) and spmd.agent_axes_of(3) == ("data",)
    assert b.stacked == ("layers",)
    xlstm = build_model(get_reduced("xlstm-1.3b"), device=CPU)
    assert xlstm.stacked == ("ln_m", "ln_s", "mlstm", "slstm")


def test_train_launcher_writes_and_resumes_checkpoints(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--arch", "zamba2-1.2b", "--preset", "tiny", "--batch", "2", "--seq", "33",
            "--agents", "2", "--log-every", "1", "--device", "cpu", "--checkpoint-dir", ck,
            "--eps", "1.0"]
    hist = ttrain.main(argv + ["--steps", "3"])
    assert [r["step"] for r in hist] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in hist)
    assert "composed eps over run" in capsys.readouterr().out
    # The launcher's DP unit is the reference's: one sequence (m_i = --batch).
    extra = next(e for e in (json.loads(m.read_text())["extra"]
                             for m in tmp_path.glob("ck/**/manifest.json")) if "noise_scale" in e)
    assert extra["noise_scale"] == 2.0 * 1.0 / (extra["eps_step"] * 2)
    hist = ttrain.main(argv + ["--steps", "5", "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert [r["step"] for r in hist] == [3, 4]
    hist = ttrain.main(["--arch", "xlstm-1.3b", "--preset", "tiny", "--steps", "2", "--batch",
                        "2", "--seq", "33", "--agents", "2", "--log-every", "1", "--device", "cpu"])
    assert [r["step"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in hist)
    # A model axis runs one agent a data rank: only under torchrun.
    with pytest.raises(RuntimeError, match="torchrun --standalone --nproc_per_node 4"):
        ttrain.main(["--mesh", "2x2", "--steps", "1", "--device", "cpu"])


def test_train_launcher_trains_the_default_llama_and_resumes(tmp_path, capsys):
    """The launcher's default ``--arch llama3.2-1b`` (the reduced float32
    config of ``--preset tiny``): the last of 4 rounds below the first,
    then a resume from its checkpoint."""
    ck = str(tmp_path / "ck")
    argv = ["--preset", "tiny", "--batch", "2", "--seq", "33", "--agents", "2",
            "--log-every", "1", "--device", "cpu", "--checkpoint-dir", ck]
    hist = ttrain.main(argv + ["--steps", "4"])
    losses = [r["loss"] for r in hist]
    assert [r["step"] for r in hist] == [0, 1, 2, 3] and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    hist = ttrain.main(argv + ["--steps", "6", "--resume"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert [r["step"] for r in hist] == [4, 5] and hist[-1]["loss"] < losses[0]


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "seamless-m4t-medium",
                                  "chameleon-34b"])
def test_train_launcher_runs_every_attention_family(arch):
    """Two DP rounds of the MoE, enc-dec (frame embeddings drawn each step)
    and VLM families through the launcher: finite losses."""
    hist = ttrain.main(["--arch", arch, "--preset", "tiny", "--steps", "2", "--batch", "2",
                        "--seq", "17", "--agents", "2", "--log-every", "1", "--eps", "1.0",
                        "--device", "cpu"])
    assert [r["step"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in hist)


FAMILY_ARCHS = ["llama3.2-1b", "granite-moe-3b-a800m", "xlstm-1.3b"]


@functools.lru_cache(maxsize=None)
def _family(arch):
    """The reference's A stacked agents of ``arch``'s reduced float32
    config, tokens of 2 x 17 an agent, and its compiled ``clip_and_noise``
    (for :func:`_ref_draws`)."""
    jcfg, tcfg = jget_reduced(arch, dtype="float32"), get_reduced(arch, dtype="float32")
    jm = jbuild_model(jcfg, remat=False)
    keys = jax.random.split(jax.random.PRNGKey(0), A)
    jparams = _compile(jax.vmap(jm.init), keys)(keys)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (A, 2, 17)).astype(np.int32)
    zeros = jax.tree.map(lambda x: jnp.zeros_like(x[0]), jparams)
    perturb = _compile(jspmd.clip_and_noise, zeros, jax.random.PRNGKey(0), 1.0, 1.0)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jm=jm, jparams=jparams,
                                 np_params=jax.tree.map(np.asarray, jparams), tokens=tokens,
                                 perturb=perturb)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_train_step_matches_reference(arch):
    """One DP round of the transformer families (dense, and MoE with its
    aux in the loss) and of the xLSTM family (its four stacked block trees
    under the agent axis) against the reference's ``make_train_step`` (its dense
    route; the port's ring of rolls), its noise given through ``draws=``:
    every agent's new parameters and the metrics within 1e-4."""
    s = _family(arch)
    kw = dict(dp_enabled=True, mu=P2P["mu"], neighbor_offsets=P2P["neighbor_offsets"],
              gossip_dtype=None, **DP)
    jstep, eps, ns = jspmd.make_train_step(s.jm, JP2PConfig(**kw), MESH, 2, alpha=P2P["alpha"],
                                           gossip="dense")
    batch = {"tokens": jnp.asarray(s.tokens)}
    key = jax.random.PRNGKey(1)
    want_p, want_m = _compile(jstep, s.jparams, batch, key)(s.jparams, batch, key)
    bundle = build_model(s.tcfg, device=CPU)
    step, t_eps, t_ns = spmd.make_train_step(bundle, P2PConfig(**kw), MESH, 2, alpha=P2P["alpha"])
    assert (t_eps, t_ns) == (eps, ns)
    params, metrics = step(agent_params_from_reference(s.np_params, s.tcfg, CPU),
                           {"tokens": torch.from_numpy(s.tokens)},
                           draws=_ref_draws(s, jax.random.split(key, A)))
    _close_stacked(params, jax.tree.map(np.asarray, want_p), 1e-4)
    for name in ("loss", "grad_norm"):
        want = float(want_m[name])
        assert abs(float(metrics[name]) - want) <= 1e-4 * max(1.0, abs(want)), name

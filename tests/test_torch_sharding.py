"""The port's partition specs against the reference's, and the mesh layer's
pieces that need no process group.

``param_specs``, ``batch_specs`` and ``cache_specs`` are numpy rules over
shapes: the reference's trees come from ``jax.eval_shape`` (its dry-run's
inputs, every arch of the registry at full width), the port's from its own
models on the meta device (shapes only), and the mesh is a shape stand-in
as in ``tests/test_spmd.py:62-83``. Every spec must be the reference's,
exactly, leaf by leaf, for every arch, in every agent mode and ``"serve"``,
on both production meshes.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jcfgs
from repro.models import build_model as jbuild
from repro.models import sharding as jsh
from repro_torch import configs as tcfgs
from repro_torch.launch import mesh as tmesh
from repro_torch.models import sharding as tsh
from repro_torch.models.encdec import enc_len
from repro_torch.models.registry import build_model, model_class
from repro_torch.utils.tree import module_tree, tree_map

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}
MODES = ("full", "silo", "serve")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(name):
    return types.SimpleNamespace(shape=dict(MESHES[name]))


def _n_agents(mode, shape):
    if mode == "full":
        return shape["data"] * shape.get("pod", 1)
    return shape.get("pod", 1) if mode == "silo" else 1


def _shape(s):
    return types.SimpleNamespace(shape=tuple(s))


def _flat_ref(specs):
    leaves = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s)
            for path, s in leaves}


def _flat_port(specs, prefix=""):
    if isinstance(specs, tsh.P):
        return {prefix[:-1]: tuple(specs)}
    if isinstance(specs, dict):
        return {k: v for key in specs for k, v in _flat_port(specs[key], f"{prefix}{key}.").items()}
    return {k: v for i, x in enumerate(specs) for k, v in _flat_port(x, f"{prefix}{i}.").items()}


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    """Every leaf's spec, every mode and production mesh, at full width."""
    jb = jbuild(jcfgs.get_config(arch), remat=False)
    one = jax.eval_shape(jb.init, jax.eval_shape(lambda: jax.random.PRNGKey(0)))
    cfg = tcfgs.get_config(arch)
    stacked = build_model(cfg, device="cpu").stacked
    tree = module_tree(model_class(cfg)(cfg, device="meta"), stacked)
    for name in MESHES:
        for mode in MODES:
            A = _n_agents(mode, MESHES[name])
            ref_tree = one if mode == "serve" else jax.tree.map(
                lambda x: jax.ShapeDtypeStruct((A, *x.shape), x.dtype), one)
            port_tree = tree if mode == "serve" else tree_map(lambda x: _shape((A, *x.shape)),
                                                              tree)
            want = _flat_ref(jsh.param_specs(ref_tree, _mesh(name), mode, A))
            got = _flat_port(tsh.param_specs(port_tree, _mesh(name), mode, A))
            assert got == want, (arch, name, mode)
    assert len(want) > 5


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    """The batches of every shape the dry-run traces (the enc-dec frame
    embeddings too) and the decode caches of ``init_cache`` (the
    reference's stacked shapes; the port's rules read them alike)."""
    cfg = jcfgs.get_config(arch)
    jb = jbuild(cfg, remat=False)
    for name in MESHES:
        m = _mesh(name)
        for shape in jcfgs.SHAPES.values():
            for mode in MODES:
                A = _n_agents(mode, MESHES[name])
                if shape.kind == "train" and mode != "serve":
                    lead = (A, shape.global_batch // max(A, 1), shape.seq_len + 1)
                    emb = (A, shape.global_batch // max(A, 1), enc_len(shape.seq_len), cfg.d_model)
                else:
                    lead = (shape.global_batch, shape.seq_len)
                    emb = (shape.global_batch, enc_len(shape.seq_len), cfg.d_model)
                shapes = {"tokens": lead, "embeds": emb}
                ref = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in shapes.items()}
                port = {k: _shape(v) for k, v in shapes.items()}
                assert (_flat_port(tsh.batch_specs(port, m, mode))
                        == _flat_ref(jsh.batch_specs(ref, m, mode))), (arch, name, shape, mode)
            if shape.kind == "decode":
                caches = jax.eval_shape(lambda: jb.init_cache(None, shape.global_batch,
                                                              shape.seq_len))
                port = jax.tree.map(lambda x: _shape(x.shape), caches)
                for batch_sharded in (True, False):
                    want = _flat_ref(jsh.cache_specs(caches, m, batch_sharded))
                    got = _flat_port(tsh.cache_specs(port, m, batch_sharded))
                    assert got == want, (arch, name, shape.name, batch_sharded)


def test_layer_cache_specs_are_the_stacked_specs_without_the_layer_dim():
    """The port's per-layer KV caches (a list of dicts) get the reference's
    stacked spec of the same leaf, the layer dim dropped."""
    arch = "llama3.2-1b"
    jb = jbuild(jcfgs.get_config(arch), remat=False)
    cfg = tcfgs.get_config(arch)
    bundle = build_model(cfg, device="cpu")
    for name in MESHES:
        m = _mesh(name)
        for B, S in ((128, 32768), (1, 524288)):
            ref = _flat_ref(jsh.cache_specs(jax.eval_shape(lambda: jb.init_cache(None, B, S)), m,
                                            True))
            caches = bundle.init_cache(model_class(cfg)(cfg, device="meta"), B, S)
            got = _flat_port(tsh.layer_cache_specs(caches, m, True))
            assert len(got) == 3 * cfg.num_layers
            for key, spec in got.items():
                layer, leaf = key.split(".")
                assert spec == ref[leaf][1:], (name, B, key)


def test_placements_follow_the_specs():
    """One DTensor placement a mesh dim: ``Shard(d)`` where dim d's entry
    names the axis (a tuple names several, each its own mesh dim),
    ``Replicate()`` elsewhere; an axis the mesh lacks raises."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tsh.placements(tsh.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert tsh.placements(tsh.P(None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert tsh.placements(tsh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="'pod'"):
        tsh.placements(tsh.P("pod"), types.SimpleNamespace(mesh_dim_names=("data", "model")))
    assert tsh.drop_dim(tsh.P("data", None, "model")) == tsh.P(None, "model")
    assert tsh.local_shape((32, 64, 8), tsh.P(("pod", "data"), "model"), _mesh("2x16x16")) == (
        1, 4, 8)


def test_constraints_are_the_identity_without_a_mesh():
    """The counterpart of ``tests/test_perf_levers.py:71``: with the axes
    set but no ambient mesh (and on a plain tensor with one) the
    constraints return their input, so the models' bits stay the same."""
    x = torch.randn(4, 8, 16)
    try:
        tsh.set_activation_axes("data")
        tsh.set_seq_axis("model")
        assert tsh.constrain_batch(x) is x and tsh.constrain_seq(x) is x
        assert tsh.replicate_features(x) is x and tsh.gather_unless_divides(x, 0, 3) is x
        assert torch.equal(tsh.batch_zeros((2, 3), torch.float32, "cpu"), torch.zeros(2, 3))
        with tmesh.use_mesh(object()):
            assert tsh.constrain_batch(x) is x and tsh.constrain_seq(x) is x
        assert tsh.current_mesh() is None
    finally:
        tsh.set_activation_axes(None)
        tsh.set_seq_axis(None)
    w = torch.randn(16, 5)
    assert torch.equal(tsh.matmul(x, w), x @ w)
    assert torch.equal(tsh.einsum("bsd,de->bse", x, w), torch.einsum("bsd,de->bse", x, w))


def test_production_meshes_and_the_link_model():
    """The reference's shapes and names; the H100 peaks; every axis of both
    production meshes crosses nodes, so every collective goes at the
    InfiniBand rate; a (4, 2) mesh stays inside one node."""
    assert tmesh.PRODUCTION_SHAPES[False] == ((16, 16), ("data", "model"))
    assert tmesh.PRODUCTION_SHAPES[True] == ((2, 16, 16), ("pod", "data", "model"))
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW, tmesh.IB_BW) == (
        989e12, 3.35e12, 450e9, 50e9)
    for multi_pod in (False, True):
        shape, axes = tmesh.PRODUCTION_SHAPES[multi_pod]
        for axis in axes:
            assert tmesh.link_bw(shape, axes, (axis,)) == tmesh.IB_BW
    assert tmesh.link_bw((4, 2), ("data", "model"), ("data",)) == tmesh.NVLINK_BW
    groups = tmesh.group_ranks((2, 2, 2), ("pod", "data", "model"), ("pod", "data"))
    assert groups == [[0, 2, 4, 6], [1, 3, 5, 7]]
    if not torch.cuda.is_available():  # never a CPU mesh in the card's place
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh((1, 1), ("data", "model"))
    np.testing.assert_equal(tsh.axis_sizes(_mesh("2x16x16")), MESHES["2x16x16"])

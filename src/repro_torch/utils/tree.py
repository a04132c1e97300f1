"""Small pytree helpers used across the framework.

Port of ``repro/utils/tree.py``. A tree is what the reference's parameter
pytrees are: nested dicts (and tuples or lists) whose leaves are tensors,
keyed by the reference's names. Dicts are walked in sorted key order, as
``jax.tree.leaves`` walks them, so a tree's leaves come in the
reference's order: the order in which its global norm sums them and in
which ``core.spmd.clip_and_noise`` names their noise.

Beyond the reference's names: :func:`tree_map`, :func:`tree_leaves`,
:func:`tree_flatten_with_path` and :func:`tree_map_with_path` (dotted
paths such as ``layers.mamba.in_proj.w``); :func:`module_views`, which names one
model's leaves as its ``nn.Module`` does, and its two inverses over a
model: :func:`module_tree` (a model's reference tree, stacked) and
:func:`bind_module` (a model laid over a tree's storage).
"""

from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(dotted path, leaf)`` applied leaf by leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}{k}.") for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, x, f"{prefix}{i}.") for i, x in enumerate(tree))
    return fn(prefix[:-1], tree)


def tree_flatten_with_path(tree, prefix: str = "") -> list:
    """``[(dotted path, leaf)]`` in the reference's leaf order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_flatten_with_path(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in tree_flatten_with_path(x, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_axpy(s, a, b):
    """b + s * a, leaf-wise."""
    return tree_map(lambda x, y: y + s * x, a, b)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_global_norm(a):
    """sqrt of the leaves' float32 sums of squares, added in leaf order."""
    leaves = tree_leaves(a)
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


def tree_size(a) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(int(x.numel()) for x in tree_leaves(a))


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def module_views(tree, stacked=("layers",)) -> list:
    """``[(state-dict name, tensor)]`` of one model's reference tree: leaf
    ``a.b.c`` as ``a.b.c``; under a top-level key in ``stacked`` the leaf's
    leading layer axis split into ``<key>.<i>.<rest>``. Each tensor is a
    view sharing the leaf's storage (the layout of
    :func:`repro_torch.convert.load_reference_params`)."""
    out = []
    for name, leaf in tree_flatten_with_path(tree):
        head, _, rest = name.partition(".")
        if head in stacked:
            out.extend((f"{head}.{i}.{rest}", leaf[i]) for i in range(leaf.shape[0]))
        else:
            out.append((name, leaf))
    return out


def _insert(tree: dict, name: str, leaf) -> None:
    *path, last = name.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = leaf


def module_tree(module, stacked=("layers",)) -> dict:
    """The reference's parameter tree of ``module``: nested dicts of its
    (detached) parameters by name, the layers of a ``ModuleList`` under a
    top-level key in ``stacked`` stacked on a leading axis (a copy)."""
    tree: dict = {}
    per_layer: dict = {}
    for name, t in module.named_parameters():
        head, _, rest = name.partition(".")
        if head in stacked:
            _, _, rest = rest.partition(".")
            per_layer.setdefault(f"{head}.{rest}", []).append(t.detach())
            continue
        _insert(tree, name, t.detach())
    for name, ts in per_layer.items():
        _insert(tree, name, torch.stack(ts))
    return tree


def bind_module(module, tree, stacked=("layers",)):
    """``module`` (built on the meta device) with its parameters replaced by
    views of ``tree``'s leaves (:func:`module_views`), sharing their
    storage: it computes with the tree's values, and autograd gives each
    view its own gradient. Raises if the tree leaves a parameter unbound."""
    for name, view in module_views(tree, stacked):
        owner, _, leaf = name.rpartition(".")
        module.get_submodule(owner).register_parameter(leaf, torch.nn.Parameter(view))
    left = [n for n, p in module.named_parameters() if p.is_meta]
    if left:
        raise KeyError(f"the tree has no leaves for {left}")
    return module

"""Partition specs for every model family on the production mesh.

Port of ``repro/models/sharding.py``. Mesh axes: ("data", "model")
single-pod, ("pod", "data", "model") multi-pod.

Two P2P agent modes (DESIGN.md §5):
* ``full`` — params carry a leading agent axis of size n_agents
  (= data-axis size x pods) sharded over ("pod","data"); within an agent the
  model is tensor-parallel over "model".
* ``silo`` — no agent axis (or pod-sized); params are FSDP-sharded over
  "data" and tensor-parallel over "model" (giant archs).

Rules are divisibility-aware: a dim is only sharded if the axis size divides
it; otherwise the rule falls through to the next candidate dim. The rules
are the reference's, in numpy, over trees of anything with a ``.shape``
(tensors, FakeTensors, ``torch.Size``-carrying stand-ins). A spec is a
:class:`P`: one entry per dimension, ``None``, an axis name, or a tuple of
names. :func:`placements` turns one into DTensor placements over a
``DeviceMesh``, one per mesh dimension.

``set_activation_axes``/``constrain_batch`` and ``set_seq_axis``/
``constrain_seq`` are the reference's sharding constraints: the identity
unless an ambient mesh is set (``launch.mesh.use_mesh``) and the activation
is a DTensor, which they then ``redistribute``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.utils.tree import tree_map, tree_map_with_path


class P(tuple):
    """A partition spec: one entry per dimension (``None``, an axis name,
    or a tuple of names), the port's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + super().__repr__()


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or a stand-in's ``.shape``
    dict (the tests' and the dry-run's mesh-shape objects)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    return dict(mesh.shape)


# The ambient mesh of :func:`repro_torch.launch.mesh.use_mesh`.
_MESH = None

# Optional activation-batch constraint used by inference paths: the launcher
# sets the batch axes here; library code calls constrain_batch at anchor
# points.
_ACT_AXES = None

# §Perf lever: Megatron-style sequence parallelism. When set (to the model
# axis name), the residual stream between TP regions is sharded on the SEQ
# dim by constrain_seq at the layer boundary.
_SEQ_AXIS = None


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


def set_seq_axis(axis):
    global _SEQ_AXIS
    _SEQ_AXIS = axis


def set_activation_axes(axes):
    global _ACT_AXES
    _ACT_AXES = axes


def _axes_tuple(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _constrain(x, dim, axes):
    """``x`` redistributed to ``Shard(dim)`` over the mesh dims named in
    ``axes`` and replicated over the others (the reference's
    ``with_sharding_constraint(x, P(..., axes at dim, ...))``), when the
    named dims' size divides ``x.shape[dim]``; else ``x``."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    dims = [i for i, n in enumerate(names) if n in axes]
    size = int(np.prod([mesh.size(i) for i in dims])) if dims else 1
    if size <= 1 or x.ndim <= dim or x.shape[dim] % size != 0 or x.shape[dim] < size:
        return x
    want = tuple(Shard(dim) if i in dims else Replicate() for i in range(mesh.ndim))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain_seq(x, dim=1):
    """Shard the sequence dim of an activation (B, S, d) over the TP axis.
    Without sequence parallelism, a DTensor residual stream is kept with
    whole features (``replicate_features``): Megatron's layout, which
    GSPMD finds by propagation and DTensor, choosing op by op, does not."""
    if _SEQ_AXIS is None:
        return replicate_features(x)
    return _constrain(x, dim, (_SEQ_AXIS,))


def constrain_batch(x, dim=0):
    """Shard the batch dim of an activation over the activation axes."""
    if _ACT_AXES is None:
        return x
    return _constrain(x, dim, _axes_tuple(_ACT_AXES))


def gather_unless_divides(x, dim: int, n: int):
    """``x``; a DTensor whose split of ``dim`` over the mesh does not divide
    ``n`` (the MoE's token groups of a decode step) gathered on that dim."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    parts = int(np.prod([mesh.size(i) for i, p in enumerate(x.placements) if p.is_shard(dim)]))
    if parts <= 1 or n % parts == 0:
        return x
    return x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p for p in x.placements])


def split_group(t, tok_dim: int, feat_dim=None):
    """On a serving mesh, ``t`` (one token group of a decode step, gathered
    for the router: see :func:`gather_unless_divides`) split on its
    tokens ``tok_dim`` over the activation axes and, with ``feat_dim``, on
    its features over "model", where a split is replicated and the size
    divides: local slices, no collective. That is GSPMD's layout of the
    group; the expert products (``models/moe.py``, through :func:`einsum`)
    then run on the local tokens and the weights' own shards. Identity
    elsewhere."""
    if _ACT_AXES is None or not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    want = list(t.placements)
    act = [i for i, n in enumerate(names) if n in _axes_tuple(_ACT_AXES)]
    size = int(np.prod([mesh.size(i) for i in act])) if act else 1
    if act and t.shape[tok_dim] % size == 0 and all(want[i].is_replicate() for i in act):
        for i in act:
            want[i] = Shard(tok_dim)
    if feat_dim is not None and "model" in names:
        i = names.index("model")
        if want[i].is_replicate() and t.shape[feat_dim] % mesh.size(i) == 0:
            want[i] = Shard(feat_dim)
    return _retarget(t, want)


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``, computed without
    making one (a meta tensor made inside the dry-run's counter would be
    counted as an allocation of the global size)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def _retarget(t, want):
    want = list(want)
    return t if want == list(t.placements) else t.redistribute(t.device_mesh, want)


def row_parallel(x, w):
    """The weight ``w`` (d_in, d_out) of ``x @ w``: where ``x`` is split on
    its features over a mesh dim that splits ``w``'s outputs, ``w`` split
    on its inputs there instead (a row-parallel product, partial sums
    reduced after), the layout GSPMD picks; DTensor would gather both."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)) or x.device_mesh != w.device_mesh:
        return w
    k = x.ndim - 1
    return _retarget(w, [Shard(0) if xp.is_shard(k) and wp.is_shard(1) else wp
                         for xp, wp in zip(x.placements, w.placements)])


def _tp_pattern(xp, wp, k) -> bool:
    """Whether one mesh dim's (x, w) placements of ``x @ w`` are a pattern
    :func:`_tp_placements` computes locally (after :func:`row_parallel`)."""
    return ((xp.is_replicate() and (wp.is_replicate() or wp.is_shard(1)))
            or (xp.is_shard(k) and wp.is_shard())
            or (xp.is_shard() and xp.dim < k and wp.is_replicate()))


def gather_fsdp(x, w):
    """On a serving mesh (activation axes set), the weight ``w`` of
    ``x @ w`` all-gathered over each mesh dim that splits it outside a
    tensor-parallel pattern: the FSDP ("data") split of a serve weight
    beside an activation split on its batch there. That is the gather
    GSPMD inserts; the product then runs on the local batch shard. A
    training round's weights are left to DTensor."""
    if (_ACT_AXES is None or not (isinstance(x, DTensor) and isinstance(w, DTensor))
            or x.device_mesh != w.device_mesh):
        return w
    k = x.ndim - 1
    return _retarget(w, [wp if _tp_pattern(xp, wp, k) or not wp.is_shard() else Replicate()
                         for xp, wp in zip(x.placements, w.placements)])


def _tp_placements(x, w):
    """Per mesh dim, (output, x-grad, w-grad) placements of ``x @ w`` done on
    the local shards, or None where the pair is not a tensor-parallel
    pattern (pending or partial activations: DTensor decides)."""
    k = x.ndim - 1
    out = []
    for xp, wp in zip(x.placements, w.placements):
        if xp.is_replicate() and wp.is_replicate():
            out.append((Replicate(), Replicate(), Replicate()))
        elif xp.is_replicate() and wp.is_shard(1):  # column-parallel
            out.append((Shard(k), Partial(), wp))
        elif xp.is_shard(k) and wp.is_shard(0):  # row-parallel
            out.append((Partial(), xp, wp))
        elif xp.is_shard() and xp.dim < k and wp.is_replicate():  # batch-split
            out.append((xp, xp, Partial()))
        else:
            return None
    return out


def matmul(x, w):
    """``x @ w`` (``w`` a 2-D weight). On a mesh, a tensor-parallel layout
    (Megatron's column- or row-parallel product, after ``row_parallel``)
    is computed on the local shards, the output split or pending a sum as
    the layout says, after an activation pending a sum is reduced and an
    FSDP-split weight gathered (:func:`gather_fsdp`): DTensor, choosing op
    by op, gathers the weight instead once the activations are large, or
    runs the global product."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)) or x.device_mesh != w.device_mesh:
        return x @ w
    if any(p.is_partial() for p in x.placements):  # a row-parallel output: reduced first
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in x.placements])
    w = row_parallel(x, gather_fsdp(x, w))
    plan = _tp_placements(x, w)
    if plan is None:
        return x @ w
    out, xg, wg = zip(*plan)
    local = x.to_local(grad_placements=xg) @ w.to_local(grad_placements=wg)
    shape = (*x.shape[:-1], w.shape[-1])
    return DTensor.from_local(local, x.device_mesh, out, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)``; on a mesh, computed on the local shards,
    mesh dim by mesh dim, where the split operands are split on one index
    letter. A replicated operand that has the letter is sliced to the
    split (a local slice); a letter the output keeps splits the output, a
    summed one leaves partial sums, reduced at once. On a serving mesh
    (activation axes set) also: operands split on different letters meet
    on the largest operand's (the others gathered there, as a decode query
    meets its cache: the small operand moves), operands pending a sum are
    reduced first, and a plain tensor beside DTensors is taken as
    replicated (as DTensor's implicit replication takes it). Other layouts
    go to DTensor (a training round's, as before the serving rules)."""
    serving = _ACT_AXES is not None
    meshes = {t.device_mesh for t in ops if isinstance(t, DTensor)}
    if len(meshes) != 1 or not (serving or all(isinstance(t, DTensor) for t in ops)):
        return torch.einsum(eq, *ops)
    ins, res = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    (mesh,) = meshes
    if any(p.is_partial() for t in ops if isinstance(t, DTensor) for p in t.placements):
        if not serving:
            return torch.einsum(eq, *ops)
        ops = [_retarget(t, [Replicate() if p.is_partial() else p for p in t.placements])
               if isinstance(t, DTensor) else t for t in ops]
    ops = [t if isinstance(t, DTensor) else
           DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in ops]
    out, want = [], [list(t.placements) for t in ops]
    for i in range(mesh.ndim):
        split = [(t.numel(), t_in[t.placements[i].dim]) for t_in, t in zip(ins, ops)
                 if t.placements[i].is_shard()]
        letters = {c for _, c in split}
        if len(letters) > 1 and not serving:
            return torch.einsum(eq, *ops)
        if len(letters) > 1:  # the largest operand's letter; the others gathered
            keep = max(split)[1]
            for j, t_in in enumerate(ins):
                p = ops[j].placements[i]
                if p.is_shard() and t_in[p.dim] != keep:
                    want[j][i] = Replicate()
            letters = {keep}
        if not letters:
            out.append(Replicate())
            continue
        (letter,) = letters
        for j, t_in in enumerate(ins):
            if letter in t_in:
                want[j][i] = Shard(t_in.index(letter))
        out.append(Shard(res.index(letter)) if letter in res else Partial())
    ops = [_retarget(t, w) for t, w in zip(ops, want)]
    local = torch.einsum(eq, *(t.to_local() for t in ops)).contiguous()
    sizes = {c: n for t_in, t in zip(ins, ops) for c, n in zip(t_in, t.shape)}
    shape = tuple(sizes[c] for c in res)
    y = DTensor.from_local(local, mesh, out, run_check=False, shape=shape,
                           stride=contiguous_stride(shape))
    if any(p.is_partial() for p in out):
        y = y.redistribute(mesh, [Replicate() if p.is_partial() else p for p in out])
    return y


def repeat_heads(k, n_rep: int, dim: int = 2):
    """``torch.repeat_interleave(k, n_rep, dim)`` (the GQA repeat of keys or
    values); a DTensor repeated on its local shard, its placements kept: a
    split of whole KV heads is the split of their query heads."""
    if n_rep == 1:
        return k
    if not isinstance(k, DTensor):
        return torch.repeat_interleave(k, n_rep, dim=dim)
    local = torch.repeat_interleave(k.to_local(), n_rep, dim=dim)
    shape = list(k.shape)
    shape[dim] *= n_rep
    return DTensor.from_local(local, k.device_mesh, k.placements, run_check=False,
                              shape=tuple(shape), stride=contiguous_stride(shape))


def embedding(table, tokens):
    """``table[tokens]``; on a serving mesh (activation axes set) with a
    DTensor table, Megatron's vocab-parallel lookup: the table gathered
    over the mesh dims that split its features (FSDP), each rank looking
    up the ids of its own vocab slice on its local tokens (others zero),
    the pending sums reduced. DTensor's own lookup of a split table
    replicates the whole global (B, S, d) output first."""
    if _ACT_AXES is None or not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    table = _retarget(table, [Replicate() if p.is_shard(1) else p for p in table.placements])
    vocab = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tokens = _retarget(tokens, [Replicate() if i in vocab else p
                                for i, p in enumerate(tokens.placements)])
    local, ids = table.to_local(), tokens.to_local().long()
    width, start = local.shape[0], 0
    for i in vocab:  # the first vocab row of this rank's slice
        start = start * mesh.size(i) + mesh.get_local_rank(i)
    start *= width
    inside = (ids >= start) & (ids < start + width)
    rows = local[torch.where(inside, ids - start, 0)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype))
    out = [Partial() if i in vocab else p for i, p in enumerate(tokens.placements)]
    shape = (*tokens.shape, table.shape[1])
    y = DTensor.from_local(rows, mesh, out, run_check=False, shape=shape,
                           stride=contiguous_stride(shape))
    return y.redistribute(mesh, [Replicate() if p.is_partial() else p for p in out])


def set_position(t, pos: int, value, dim: int = 1):
    """``t[:, pos] = value`` along ``dim`` (``value`` has ``t``'s shape
    without ``dim``), in place. On a DTensor split on ``dim`` (a decode
    cache split on its positions) only the rank whose slice holds ``pos``
    writes, into its local shard: DTensor's own ``__setitem__`` there
    writes nothing."""
    index = (slice(None),) * dim + (pos,)
    if not isinstance(t, DTensor) or not any(p.is_shard(dim) for p in t.placements):
        t[index] = value
        return
    mesh = t.device_mesh
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim, run_check=False)
    value = _retarget(value, [Shard(p.dim - (p.dim > dim)) if p.is_shard() and p.dim != dim
                              else Replicate() if p.is_shard() else p for p in t.placements])
    local = t.to_local()
    start = 0
    for i, p in enumerate(t.placements):  # this rank's first position along dim
        if p.is_shard(dim):
            start = start * mesh.size(i) + mesh.get_local_rank(i)
    start *= local.shape[dim]
    if start <= pos < start + local.shape[dim]:
        local[(slice(None),) * dim + (pos - start,)] = value.to_local()


def shard_like(t, ref, dim: int):
    """``t`` split on ``dim`` where ``ref`` is and ``t`` is replicated (the
    repeated K/V beside the head-split queries): a local slice."""
    if not (isinstance(t, DTensor) and isinstance(ref, DTensor)):
        return t
    if t.device_mesh != ref.device_mesh:
        return t
    return _retarget(t, [Shard(dim) if rp.is_shard(dim) and tp.is_replicate() else tp
                         for tp, rp in zip(t.placements, ref.placements)])


def replicate_features(x):
    """``x``; a DTensor activation whose feature (last) dim is split or
    pending a sum gathered on it first, so the product with a vocab-split
    head gives vocab-split logits (never full-vocab partial sums)."""
    if not isinstance(x, DTensor):
        return x
    want = [Replicate() if p.is_partial() or p.is_shard(x.ndim - 1) else p
            for p in x.placements]
    return x if want == list(x.placements) else x.redistribute(x.device_mesh, want)


def split_model(t, dim: int):
    """``t``; a DTensor replicated over "model" split there on ``dim``
    where the size divides: a local slice, no collective (the Mamba2
    block's inputs split on their heads, as GSPMD splits them after the
    packed input projection, which DTensor gathers to slice)."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return t
    i = names.index("model")
    dim = dim % t.ndim
    if not t.placements[i].is_replicate() or t.shape[dim] % mesh.size(i):
        return t
    return _retarget(t, [Shard(dim) if j == i else p for j, p in enumerate(t.placements)])


def replicate_where_split(x, w, dim: int):
    """``x``; a DTensor gathered over each mesh dim that splits the DTensor
    ``w`` on ``dim`` (the activation of a column-parallel product, such as
    ``x @ table.T`` over a vocab-split table, which DTensor, choosing op by
    op, may have left split on its batch there)."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)) or x.device_mesh != w.device_mesh:
        return x
    return _retarget(x, [Replicate() if wp.is_shard(dim) else xp
                         for xp, wp in zip(x.placements, w.placements)])


def batch_zeros(shape, dtype, device, dim=0):
    """``torch.zeros(shape)``; with an ambient mesh and activation axes set,
    a DTensor of zeros sharded on ``dim`` over them that holds only its
    local shard (the reference constrains its zero caches so)."""
    if _MESH is None or _ACT_AXES is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    import torch.distributed.tensor as dt

    names = _MESH.mesh_dim_names
    axes = _axes_tuple(_ACT_AXES)
    size = int(np.prod([axis_sizes(_MESH)[a] for a in axes]))
    place = [Shard(dim) if n in axes and shape[dim] % size == 0 and shape[dim] >= size
             else Replicate() for n in names]
    return dt.zeros(tuple(shape), dtype=dtype, device_mesh=_MESH, placements=place)


def _register_pointwise(ops, n_out: int, n_in: int):
    """Give elementwise ops DTensor has no sharding strategy for one: every
    operand and output alike, replicated or split on one dim."""
    from torch.distributed.tensor.experimental import register_sharding

    def strategy(x, *rest):
        return [([Replicate()] * n_out, [Replicate()] * n_in)] + [
            ([Shard(d)] * n_out, [Shard(d)] * n_in) for d in range(x.ndim)]

    register_sharding(ops)(strategy)


# The xLSTM gates' ``F.logsigmoid`` and its backward.
_register_pointwise(torch.ops.aten.log_sigmoid_forward.default, 2, 1)
_register_pointwise(torch.ops.aten.log_sigmoid_backward.default, 1, 3)


def _has_strategy(op) -> bool:
    prop = DTensor._op_dispatcher.sharding_propagator
    return (op in prop.op_strategy_funcs or op in prop.op_to_rules
            or op in getattr(prop, "op_single_dim_strategy_funcs", {}))


def _register_missing_identity():
    """``detach_`` of a redistributed parameter under inference mode: some
    torch versions (2.11) give DTensor no strategy for it."""
    op = torch.ops.aten.detach_.default
    if not _has_strategy(op):
        _register_pointwise(op, 1, 1)


_register_missing_identity()


def _flip_strategy(x, dims):
    # Split on a dim it does not reverse, or replicated.
    flipped = {d % x.ndim for d in dims}
    return [([Replicate()], [Replicate(), None])] + [
        ([Shard(d)], [Shard(d), None]) for d in range(x.ndim) if d not in flipped]


def _register_missing_flip():
    """``flip`` (the backward of ``cumsum``: the mLSTM's and Mamba2's
    cumulative gates): some torch versions (2.11) give DTensor no strategy
    for it."""
    from torch.distributed.tensor.experimental import register_sharding

    op = torch.ops.aten.flip.default
    if not _has_strategy(op):
        register_sharding(op)(_flip_strategy)


_register_missing_flip()


def _replicated_assert(cond, msg):
    # ``F.one_hot``'s range check (the MoE router): on the whole condition.
    return [([], [Replicate(), None])]


def _register_assert():
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(torch.ops.aten._assert_async.msg)(_replicated_assert)


_register_assert()


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return int(np.prod([_axis_size(mesh, n) for n in name]))
    return axis_sizes(mesh)[name]


def _pick_dims(shape, skip, mesh, model_axis, fsdp_axis=None):
    """Choose (model_dim, fsdp_dim) to shard for a leaf of `shape`.

    Preference: shard the *last* divisible dim over model (column-parallel
    default), and the largest remaining divisible dim over data (FSDP).
    Dims in `skip` (leading layer-stack / agent dims) are never sharded.
    """
    msz = _axis_size(mesh, model_axis)
    cands = [i for i in range(len(shape)) if i not in skip]
    model_dim = None
    for i in reversed(cands):
        if shape[i] % msz == 0 and shape[i] >= msz:
            model_dim = i
            break
    fsdp_dim = None
    if fsdp_axis is not None:
        fsz = _axis_size(mesh, fsdp_axis)
        rest = [i for i in cands if i != model_dim]
        rest.sort(key=lambda i: -shape[i])
        for i in rest:
            if shape[i] % fsz == 0 and shape[i] >= fsz:
                fsdp_dim = i
                break
    return model_dim, fsdp_dim


_STACKS = ("layers", "encoder", "decoder", "mlstm", "slstm", "ln_m", "ln_s")


def param_specs(params, mesh, agent_mode: str, n_agents: int, scan_dims=("layers",)):
    """A :class:`P` tree matching ``params`` (a tree of anything with a
    ``.shape``). In ``full`` mode the leaves carry the leading agent dim."""
    sizes = axis_sizes(mesh)
    has_pod = "pod" in sizes
    agent_axes = ("pod", "data") if has_pod else ("data",)
    fsdp_axis = "data" if agent_mode in ("silo", "serve") else None

    def one(path_str, leaf):
        shape = tuple(leaf.shape)
        skip = set()
        spec = [None] * len(shape)
        dim0 = 0
        if agent_mode == "full":
            spec[0] = agent_axes if len(agent_axes) > 1 else agent_axes[0]
            skip.add(0)
            dim0 = 1
        elif agent_mode == "silo":
            # leading pod-agent dim (size 1 on a single pod -> replicated)
            spec[0] = "pod" if (has_pod and n_agents > 1) else None
            skip.add(0)
            dim0 = 1
        # layer-stack dim (from the stacked init) right after the agent dim.
        if any(s in path_str for s in _STACKS) and len(shape) > dim0:
            skip.add(dim0)
        if len(shape) - len(skip) == 0:
            return P(*spec)
        if len(shape) - len(skip) == 1 and shape[-1] < 1024:
            return P(*spec)  # small vectors (norm scales, biases): replicate
        if path_str.endswith("table") and len(shape) - dim0 == 2:
            # embedding / lm-head: shard the (padded) vocab dim over "model"
            # so logits stay vocab-sharded instead of replicated at full V.
            msz = _axis_size(mesh, "model")
            vdim, ddim = dim0, dim0 + 1
            if shape[vdim] % msz == 0:
                spec[vdim] = "model"
                if fsdp_axis is not None and shape[ddim] % _axis_size(mesh, fsdp_axis) == 0:
                    spec[ddim] = fsdp_axis
                return P(*spec)
        model_dim, fsdp_dim = _pick_dims(shape, skip, mesh, "model", fsdp_axis)
        if model_dim is not None:
            spec[model_dim] = "model"
        if fsdp_dim is not None:
            spec[fsdp_dim] = "data"
        return P(*spec)

    return tree_map_with_path(one, params)


def batch_specs(batch, mesh, agent_mode: str):
    """Batch specs, divisibility-safe.

    full  — dim0 is the agent dim, sharded over ("pod","data");
    silo  — dim0 is the pod-agent dim ("pod" when pods>1, else replicated),
            dim1 (per-agent batch) sharded over "data";
    serve — dim0 is the request batch, sharded over ("pod","data") when the
            size divides (long_500k's batch of 1 stays replicated).
    """
    sizes = axis_sizes(mesh)
    has_pod = "pod" in sizes
    data_axes = ("pod", "data") if has_pod else ("data",)
    lead = data_axes if len(data_axes) > 1 else data_axes[0]
    lead_sz = _axis_size(mesh, data_axes)
    dsz = _axis_size(mesh, "data")

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if agent_mode == "full":
            if len(shape) >= 1 and shape[0] % lead_sz == 0:
                spec[0] = lead
        elif agent_mode == "silo":
            if has_pod and len(shape) >= 1 and shape[0] % sizes["pod"] == 0:
                spec[0] = "pod"
            if len(shape) >= 2 and shape[1] % dsz == 0 and shape[1] >= dsz:
                spec[1] = "data"
        else:  # serve
            if len(shape) >= 1 and shape[0] % lead_sz == 0 and shape[0] >= lead_sz:
                spec[0] = lead
            elif len(shape) >= 1 and not has_pod and shape[0] % dsz == 0 and shape[0] >= dsz:
                spec[0] = "data"
        return P(*spec)

    return tree_map(one, batch)


def cache_specs(cache, mesh, batch_sharded: bool):
    """Decode-cache specs.

    Layout is (layer, batch, seq, kv_heads, head_dim) for KV buffers. Batch
    shards over ("pod","data"); the model axis takes the KV-head dim when it
    divides, otherwise the SEQ dim. The port's caches are lists, one entry
    a layer: :func:`layer_cache_specs` reads them as stacked.
    """
    sizes = axis_sizes(mesh)
    has_pod = "pod" in sizes
    data_axes = ("pod", "data") if has_pod else ("data",)
    lead = data_axes if len(data_axes) > 1 else data_axes[0]
    dsz = _axis_size(mesh, data_axes)
    msz = _axis_size(mesh, "model")

    def one(leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        # caches are stacked per layer: dim0 = layer, dim1 = batch
        if batch_sharded and len(shape) >= 2 and shape[1] % dsz == 0 and shape[1] >= dsz:
            spec[1] = lead
        if len(shape) == 5:  # (L, B, S, KV, hd)
            if shape[3] % msz == 0 and shape[3] >= msz:
                spec[3] = "model"
            elif shape[2] % msz == 0 and shape[2] >= msz:
                spec[2] = "model"
        return P(*spec)

    return tree_map(one, cache)


class Shape:
    """A leaf stand-in for the spec rules: only a ``.shape``."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def stacked_shapes(tree, n: int):
    """``tree``'s leaves as stand-ins stacked on a leading axis of ``n``
    (the agents of a round, the layers of a cache)."""
    return tree_map(lambda x: Shape((n, *x.shape)), tree)


def layer_cache_specs(caches, mesh, batch_sharded: bool):
    """:func:`cache_specs` of the port's per-layer caches (lists of a tree a
    layer): each leaf read as the reference's stacked (layer, ...) leaf,
    the layer dim dropped from its spec again (the rules never shard it)."""
    stacked = stacked_shapes(caches, 1)
    return map_specs(drop_dim, cache_specs(stacked, mesh, batch_sharded))


def map_specs(fn, specs, *rest):
    """``fn`` applied to each :class:`P` of a spec tree (and the matching
    nodes of trees of its structure): a ``P`` is a leaf, not a tuple."""
    if isinstance(specs, P):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], *(r[k] for r in rest)) for k in sorted(specs)}
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, x, *(r[i] for r in rest)) for i, x in enumerate(specs))
    return fn(specs, *rest)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``, one per mesh dimension:
    ``Shard(d)`` on each mesh dim that dimension d's entry names (a tuple
    such as ("pod", "data") shards d over both, major first), else
    ``Replicate()``. A mesh dim the spec does not name is replicated; an
    axis the mesh lacks raises."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in _axes_tuple(entry):
            if axis not in names:
                raise ValueError(f"spec {spec} names {axis!r}, the mesh has {names}")
            out[names.index(axis)] = Shard(d)
    return tuple(out)


def drop_dim(spec, dim: int = 0):
    """``spec`` without dimension ``dim`` (the agent or the layer axis)."""
    return P(*(e for i, e in enumerate(spec) if i != dim))


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one device's shard of a leaf of ``shape`` under ``spec``
    (the specs shard only dims the axes divide)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            out[d] //= _axis_size(mesh, entry)
    return tuple(out)

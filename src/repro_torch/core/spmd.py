"""The paper's update (Eq. 4/6) as a training round over stacked agents.

Port of ``repro/core/spmd.py``, the scale layer (DESIGN.md §4): each agent
holds a personal copy of a model, the broadcast-gossip neighbour sum runs
over the agent axis, and the DP perturbation (clip + Laplace) runs on each
agent's local gradient.

Semantics vs the paper (recorded deviations, DESIGN.md §9):
* synchronous rounds (all agents update from the same snapshot) instead of
  Poisson single-agent wake-ups — same fixed points; the simulator in
  ``coordinate_descent.py`` keeps the faithful async semantics;
* for transformer-scale models the DP unit is the per-round *aggregated*
  local gradient, clipped to C in global L2 norm (the paper's per-example
  clipping is kept in the simulator and in the dp_clip_noise kernel, which
  serving-scale linear heads use directly);
* c_i == 1 (uniform confidence): the scale layer feeds equal-size local
  batches per agent each round.

Update per agent (leaf-wise over the parameter tree):

    Theta_i <- (1 - alpha) Theta_i
               + alpha * ( sum_o w_o (Theta_{i-o} + Theta_{i+o})
                           - mu * (clip_C(grad_i) + eta_i) )

with eta_i ~ Laplace(0, s)^dim, s = 2 C / (eps_step * m_i).

How the agents map onto one device (``src/repro_torch/DEVIATIONS.md``):
* the A agents are the leading axis of every leaf of one parameter tree,
  the reference's ``jax.vmap(bundle.init)`` layout, the ``layers`` axis
  under it; A is that axis (:func:`num_agents` of a ``DeviceMesh``, a
  stand-in with ``.shape``, or a count);
* the reference vmaps ``value_and_grad(bundle.loss)`` over the agents; the
  ``ssm_chunk`` kernel has no vmap rule, so each agent's loss and gradient
  run in turn, the model laid over its slice of the stacked leaves
  (``bundle.bind``), and the gossip and the update then run once per
  stacked leaf for all agents;
* ``lax.ppermute`` along the agent axis is a roll of the stacked axis
  (``mixing.StackedCollective.ppermute``, the one step a multi-process
  backend replaces);
* a round writes the new parameters into the tree it was given and
  returns it (the reference's launcher donates them to its jit);
* the noise comes from a ``torch.Generator`` (Philox), not from a threefry
  key: ``draws=`` takes the standard Laplace draws by leaf name instead.

On a ``DeviceMesh`` the same round runs one agent a rank
(:func:`jit_train_step`, :class:`MeshTrainStep`): the agent's tree is a
DTensor tree over its ranks of the model axis, and the ring shift goes to
another rank (``mixing.GroupCollective``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import P2PConfig
from repro_torch.core import privacy
from repro_torch.core.coordinate_descent import standard_laplace
from repro_torch.core.mixing import GroupCollective, StackedCollective
from repro_torch.models.sharding import axis_sizes, drop_dim, map_specs, placements
from repro_torch.utils.tree import (module_views, tree_flatten_with_path, tree_map,
                                     tree_map_with_path)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Gossip
# ---------------------------------------------------------------------------


def agent_axes_of(mesh) -> tuple:
    """The mesh axes the agents span; a count stands for ``("data",)``."""
    if isinstance(mesh, (int, np.integer)):
        return ("data",)
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def num_agents(mesh, agent_mode: str) -> int:
    """A from a ``DeviceMesh``, a stand-in (``.shape`` a dict of axis
    sizes) or a count."""
    if isinstance(mesh, (int, np.integer)):
        return int(mesh)
    shape = axis_sizes(mesh)
    if agent_mode == "full":
        n = shape["data"]
        if "pod" in shape:
            n *= shape["pod"]
        return n
    return shape.get("pod", 1)


def _ring_perm(n: int, shift: int):
    return [(i, (i + shift) % n) for i in range(n)]


def _residues(offsets, n: int) -> list:
    """The distinct ring residues {±o mod n}: the target set the dense W stores."""
    return sorted({s * int(o) % n for o in offsets for s in (1, -1)})


# Ships each ring shift of the stacked agent axis (a roll); the step a
# multi-process backend replaces.
_COLLECTIVE = StackedCollective()


def gossip_ppermute(params, offsets, gossip_dtype=None):
    """Circulant neighbour mean by ring shifts along the stacked agent axis.

    Returns sum_j (W_ij / D_ii) Theta_j for the ring-union graph W with unit
    weights on the *distinct* target set {i +/- o mod A : o in offsets}:
    offsets that collide modulo A contribute one unit entry, and a residue
    of 0 is the self-loop (the agent's own block, no shift). The payload
    is cast to ``gossip_dtype`` (if given), accumulated in float32 and cast
    back to each leaf's type.
    """

    def mix_leaf(x):
        residues = _residues(offsets, x.shape[0])
        w = 1.0 / len(residues)
        xg = x.to(gossip_dtype) if gossip_dtype is not None else x
        acc = torch.zeros(xg.shape, dtype=F32, device=x.device)
        for r in residues:
            # A shift by r delivers Theta_{i-r}; the residue set is closed
            # under negation, so the union is the distinct {i +/- o} set.
            got = xg if r == 0 else _COLLECTIVE.ppermute(xg, r)
            acc = acc + w * got.to(F32)
        return acc.to(x.dtype)

    return tree_map(mix_leaf, params)


def gossip_dense(params, mix_matrix):
    """Dense-W mixing: ``einsum("ij,j...->i...")`` over the agent axis in
    float32, cast back. ``mix_matrix``: (A, A) row-normalized W/D."""

    def leaf(x):
        m = torch.as_tensor(mix_matrix, device=x.device).to(F32)
        return (m @ x.to(F32).reshape(x.shape[0], -1)).reshape(x.shape).to(x.dtype)

    return tree_map(leaf, params)


def gossip_gather(params, idx, w):
    """Sparse neighbour mean over the stacked agent axis: O(A * K) gathers.

    ``idx``: (A, K) padded neighbour indices; ``w``: (A, K) row-normalized
    weights (pad entries 0). The matrix-free counterpart of
    :func:`gossip_dense`.
    """

    def leaf(x):
        i = torch.as_tensor(idx, device=x.device).long()
        ww = torch.as_tensor(w, device=x.device).to(F32)
        g = x.to(F32)[i]  # (A, K, ...)
        return torch.sum(g * ww.reshape(ww.shape + (1,) * (g.ndim - 2)), dim=1).to(x.dtype)

    return tree_map(leaf, params)


# ---------------------------------------------------------------------------
# DP perturbation
# ---------------------------------------------------------------------------


# The stacked leaves are updated in column blocks of at most this many
# elements, so the float32 temporaries of a step stay near 256 MB each: a
# full-width zamba2-1.2b leaf stacks 2.6 G elements for 4 agents
# (``layers.mamba.in_proj.w``), 10 GB a float32 copy.
BLOCK_ELEMS = 1 << 26


def _column_blocks(x, A: int):
    """Views of the (A, -1) form of the stacked leaf ``x``: column blocks of
    at most ``BLOCK_ELEMS`` elements, in order (writes go to ``x``)."""
    flat = x.view(A, -1)
    width = max(BLOCK_ELEMS // A, 1)
    return [flat[:, lo:lo + width] for lo in range(0, flat.shape[1], width)]


def _agent_norms(grads, A: int):
    """(A,) float32: the global L2 norm of each agent's slice of a stacked
    tree, the leaves' float32 sums of squares added in leaf order (the
    reference's order; within a leaf, block by block in torch's own)."""
    total = 0
    for _, x in tree_flatten_with_path(grads):
        for blk in _column_blocks(x, A):
            total = total + torch.sum(torch.square(blk.to(F32)), dim=1)
    return torch.sqrt(total)


def _tree_norm(tree):
    """Global L2 norm of one agent's tree (:func:`_agent_norms` at A = 1)."""
    return _agent_norms(tree_map(lambda x: x.reshape(1, -1), tree), 1)[0]


def _clip_scale(norm, clip):
    return torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)


def _perturb(g, scale, noise_scale, generator, draw=None):
    """``g * scale + noise_scale * noise`` in float32, cast back to ``g``'s
    type: the DP step of :func:`clip_and_noise` and of the round's column
    blocks. The standard Laplace ``noise`` is ``draw`` if given, else drawn
    from ``generator``."""
    noise = (draw.to(F32) if draw is not None
             else standard_laplace(g.shape, generator, g.device, F32))
    return (g.to(F32) * scale + noise_scale * noise).to(g.dtype)


def _draws_of(name, x, draws):
    """``draws[name]`` on ``x``'s device, checked to have ``x``'s shape."""
    d = torch.as_tensor(draws[name], device=x.device).contiguous()
    if d.shape != x.shape:
        raise ValueError(f"draws[{name!r}] has shape {tuple(d.shape)}, the leaf {tuple(x.shape)}")
    return d


def clip_and_noise(grads, generator, clip, noise_scale, draws=None):
    """Global-L2 clip to ``clip``, then add Laplace(0, noise_scale) per coord.

    ``grads``: one agent's tree. The noise of each leaf is drawn from
    ``generator`` in leaf order, or read from ``draws`` (standard Laplace
    draws by dotted leaf name, e.g. ``draws["layers.mamba.D"]``). Each leaf
    is computed in float32 and cast back to its type."""
    scale = _clip_scale(_tree_norm(grads), clip)

    def leaf(name, x):
        return _perturb(x, scale, noise_scale, generator,
                        _draws_of(name, x, draws) if draws is not None else None)

    return tree_map_with_path(leaf, grads)


# ---------------------------------------------------------------------------
# Train-step builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class P2PPlan:
    """Everything a launcher needs to run one training round. The
    reference's pjit specs have no counterpart on one device (None)."""

    train_step: Callable  # (params, batch, generator, draws) -> (params, metrics)
    in_specs: tuple | None
    out_specs: tuple | None
    n_agents: int
    eps_step: float
    noise_scale: float


def agent_losses_and_grads(bundle, params, batch):
    """Each agent's loss and gradient, agent after agent.

    ``params``: a stacked tree (leading agent axis A); ``batch``: a dict of
    (A, ...) arrays. Agent a's model is ``bundle.bind`` over its slice, its
    batch the a-th rows. Returns ((A,) losses, a stacked gradient tree of
    ``params``' types), the gradients written into one new tree. Each
    agent's forward, backward and gradient copy run in the profiler ranges
    "agent_forward", "agent_backward" and "grad_copy" (a round's update in
    "clip_noise", "gossip" and "update", leaf by leaf)."""
    A = _stacked_count(params)
    grads = tree_map(torch.empty_like, params)
    losses = []
    for a in range(A):
        model = bundle.bind(tree_map(lambda x: x[a], params))
        with record_function("agent_forward"):
            loss = bundle.loss(model, {k: v[a] for k, v in batch.items()})
        dsts = module_views(tree_map(lambda g: g[a], grads), bundle.stacked)
        with record_function("agent_backward"):
            got = torch.autograd.grad(loss, [model.get_parameter(n) for n, _ in dsts],
                                      allow_unused=True)
        with torch.no_grad(), record_function("grad_copy"):
            for (_, dst), g in zip(dsts, got):
                if g is None:  # a leaf the loss does not reach
                    dst.zero_()
                else:
                    dst.copy_(g)
        losses.append(loss.detach().to(F32))
        del model, loss, got
    return torch.stack(losses), grads


def _stacked_count(params) -> int:
    counts = {x.shape[0] for _, x in tree_flatten_with_path(params)}
    if len(counts) != 1:
        raise ValueError(f"the leaves' leading agent axes differ: {sorted(counts)}")
    return counts.pop()


def make_train_step(bundle, p2p: P2PConfig, mesh, local_batch_size: int,
                    alpha: float = 0.5, gossip: str = "ppermute"):
    """Build the P2P-DP training round for a model bundle.

    ``mesh``: the agent count A, or a stand-in with ``.shape`` (read by
    :func:`num_agents`). ``gossip``: "ppermute" (ring shifts of the stacked
    axis), "dense" ((A, A) mixing matrix), "sparse" (padded-neighbour
    gathers, no (A, A) array), or "matrix" (dense below the sparse
    crossover, sparse above). Returns ``(train_step, eps_step,
    noise_scale)``; ``train_step(params, batch, generator=None, draws=None)``
    updates the stacked tree ``params`` in place and returns it with the
    metrics ``{"loss", "grad_norm"}`` (means over the agents, 0-d float32
    tensors). With DP on, the noise comes from ``generator`` (a
    ``torch.Generator`` on the parameters' device) or from ``draws``:
    standard Laplace draws by dotted leaf name, each of the leaf's stacked
    shape.
    """
    agent_mode = p2p.agent_mode
    A = num_agents(mesh, agent_mode)
    m_i = max(local_batch_size, 1)

    if p2p.dp_enabled:
        eps_step = privacy.invert_uniform_budget(p2p.eps_bar, p2p.planned_rounds, p2p.delta_bar)
        noise_scale = 2.0 * p2p.clip / (eps_step * m_i)
    else:
        eps_step, noise_scale = 0.0, 0.0

    gossip_dtype = getattr(torch, p2p.gossip_dtype) if p2p.gossip_dtype else None
    do_gossip = p2p.enabled and A > 1
    if gossip == "matrix":
        from repro_torch.core.graph import sparse_crossover

        gossip = "sparse" if A >= sparse_crossover() else "dense"
    if gossip not in ("ppermute", "dense", "sparse"):
        raise ValueError(f"gossip must be ppermute, dense, sparse or matrix, got {gossip!r}")
    mix_mat = mix_idx = mix_w = None
    if do_gossip and gossip == "dense":
        W = np.zeros((A, A))
        for o in p2p.neighbor_offsets:
            for i in range(A):
                W[i, (i + o) % A] = 1.0
                W[i, (i - o) % A] = 1.0
        mix_mat = (W / W.sum(1, keepdims=True)).astype(np.float32)
    elif do_gossip and gossip == "sparse":
        # The exact distinct-target set of the dense W, the self-loop of an
        # offset ≡ 0 (mod A) included.
        offs = _residues(p2p.neighbor_offsets, A) or [0]
        mix_idx = (np.arange(A)[:, None] + np.asarray(offs)[None, :]) % A
        mix_w = np.full(mix_idx.shape, 1.0 / len(offs), np.float32)
    # The reference's silo mode gossips over the pod axis only; stacked on
    # one device the agent axis is the stacked one either way.
    offsets = tuple(p2p.neighbor_offsets) or (1,)

    def mixed_leaf(x):
        if not do_gossip:
            return x
        if gossip == "dense":
            return gossip_dense(x, mix_mat)
        if gossip == "sparse":
            return gossip_gather(x, mix_idx, mix_w)
        return gossip_ppermute(x, offsets, gossip_dtype)

    @torch.no_grad()
    def train_step(params, batch, generator=None, draws=None):
        if _stacked_count(params) != A:
            raise ValueError(f"params stack {_stacked_count(params)} agents, the step {A}")
        if p2p.dp_enabled and draws is None and generator is None:
            raise ValueError("DP is on: pass a generator or draws")
        with torch.enable_grad():
            losses, grads = agent_losses_and_grads(bundle, params, batch)
        norms = _agent_norms(grads, A)
        s = _clip_scale(norms, p2p.clip)[:, None] if p2p.dp_enabled else None
        for name, leaf in tree_flatten_with_path(params):
            g_leaf = _node(grads, name)
            d_blocks = (_column_blocks(_draws_of(name, g_leaf, draws), A)
                        if p2p.dp_enabled and draws is not None else itertools.repeat(None))
            blocks = zip(_column_blocks(leaf, A), _column_blocks(g_leaf, A), d_blocks)
            for theta, g, d in blocks:
                if p2p.dp_enabled:
                    with record_function("clip_noise"):
                        g = _perturb(g, s, noise_scale, generator, d)
                with record_function("gossip"):
                    mix = mixed_leaf(theta)
                with record_function("update"):
                    t32 = theta.to(F32)
                    m32 = mix.to(F32) if do_gossip else t32
                    theta.copy_((1.0 - alpha) * t32 + alpha * (m32 - p2p.mu * g.to(F32)))
                del g, mix, t32, m32
        metrics = {"loss": losses.mean(), "grad_norm": norms.mean()}
        return params, metrics

    # What jit_train_step needs to run the same round one agent a rank.
    train_step.plan = _RoundPlan(bundle=bundle, p2p=p2p, alpha=alpha, gossip=gossip,
                                 n_agents=A, noise_scale=noise_scale, do_gossip=do_gossip,
                                 offsets=offsets, gossip_dtype=gossip_dtype, mix_mat=mix_mat,
                                 mix_idx=mix_idx, mix_w=mix_w)
    return train_step, eps_step, noise_scale


@dataclasses.dataclass(frozen=True, eq=False)
class _RoundPlan:
    bundle: object
    p2p: P2PConfig
    alpha: float
    gossip: str
    n_agents: int
    noise_scale: float
    do_gossip: bool
    offsets: tuple
    gossip_dtype: object
    mix_mat: object
    mix_idx: object
    mix_w: object


def _node(tree, name: str):
    for k in name.split("."):
        tree = tree[k]
    return tree


def make_fedavg_step(bundle, mesh, lr: float = 3e-4):
    """Single-global-model baseline (the paper's mu -> 0 extreme).

    Every agent slot holds the same model; gradients are averaged across the
    agent axis each round (complete-graph consensus). ``train_step(params,
    batch, generator=None)`` updates ``params`` in place and returns it with
    the metrics; ``mesh`` is read as in :func:`make_train_step`.
    """

    @torch.no_grad()
    def train_step(params, batch, generator=None):
        with torch.enable_grad():
            losses, grads = agent_losses_and_grads(bundle, params, batch)
        A = losses.shape[0]
        for name, leaf in tree_flatten_with_path(params):
            for p, g in zip(_column_blocks(leaf, A), _column_blocks(_node(grads, name), A)):
                mean = torch.mean(g.to(F32), dim=0, keepdim=True)
                p.copy_(p.to(F32) - lr * torch.broadcast_to(mean, p.shape))
        metrics = {"loss": losses.mean(), "grad_norm": _agent_norms(grads, A).mean()}
        return params, metrics

    return train_step


# ---------------------------------------------------------------------------
# The round on a DeviceMesh, one agent a rank (the reference's pjit wiring)
# ---------------------------------------------------------------------------


def shardings_for(tree, mesh, spec_tree):
    """The DTensor placements of every spec of ``spec_tree`` over ``mesh``
    (``models.sharding.placements``); ``tree`` is unused, as in the
    reference."""
    return map_specs(lambda s: placements(s, mesh), spec_tree)


def jit_train_step(train_step, mesh, pspecs, bspecs):
    """The round of ``train_step`` (from :func:`make_train_step`) as each
    rank of ``mesh`` runs it: a :class:`MeshTrainStep`. ``pspecs`` and
    ``bspecs`` are the stacked trees' specs (``param_specs``,
    ``batch_specs``), the agent dim leading."""
    return MeshTrainStep(train_step.plan, mesh, pspecs, bspecs)


def _agent_axes(mesh, agent_mode):
    names = tuple(mesh.mesh_dim_names)
    if agent_mode == "full":
        return tuple(a for a in ("pod", "data") if a in names), ("model",)
    if agent_mode == "silo":
        return (("pod",) if "pod" in names else ()), ("data", "model")
    raise ValueError(f"agent_mode {agent_mode!r} trains no agents")


def _sub_mesh(mesh, axes):
    return mesh[axes[0]] if len(axes) == 1 else mesh[tuple(axes)]


def _local_slice(full, mesh, places):
    """This rank's shard of ``full`` under ``places`` (DTensor's even
    chunks, mesh dims in order), with no communication."""
    for i, p in enumerate(places):
        if p.is_shard():
            full = full.chunk(mesh.size(i), dim=p.dim)[mesh.get_local_rank(i)]
    return full


class MeshTrainStep:
    """The P2P-DP round on a ``DeviceMesh``, one agent a rank of the agent
    axes: in ``"full"`` mode each rank of ("pod", "data") holds one agent
    (A = pods x data), its tree a DTensor tree on the 1-D ``mesh["model"]``
    with its ``param_specs`` placements minus the agent dim; in ``"silo"``
    mode each pod holds one agent, FSDP over "data" and TP over "model".

    ``step(params, batch, generator=None, draws=None)`` runs this rank's
    part of the stacked round: the agent's loss and gradient on the DTensor
    tree (remat as the bundle was built), the global-L2 clip (a sharded
    leaf's sum of squares all-reduced over the mesh dims it is split on)
    and Laplace noise, the gossip over the agent axes
    (:class:`~repro_torch.core.mixing.GroupCollective`: a ring shift by r
    receives agent (i - r) mod A, the circulant mean of
    :func:`gossip_ppermute`; dense and sparse gossip all-gather the agents'
    blocks and take this agent's row), and the update, written into the
    local shards of ``params`` in place. ``draws`` holds this agent's
    standard Laplace draws by leaf name, each of the leaf's full shape (a
    rank takes its shard); with a ``generator`` (seeded alike on the ranks
    of one agent) a replicated leaf's noise comes from it, alike on the
    agent's ranks, and a split leaf's shard from a stream of the rank's own
    (:meth:`_shard_generator`), as the reference draws each shard. Returns
    ``(params, metrics)``, the metrics the means over the agents.

    :meth:`shard` lays one agent's tree of full tensors out on the agent
    mesh (each rank keeps its own slices, no communication; a batch of
    full tensors is laid out alike); ``agent`` is this rank's agent
    and ``collective`` the gossip's :class:`GroupCollective` (None for one
    agent)."""

    def __init__(self, plan, mesh, pspecs, bspecs):
        self.plan, self.mesh = plan, mesh
        mode = plan.p2p.agent_mode
        agent_axes, within = _agent_axes(mesh, mode)
        self.agent_mesh = _sub_mesh(mesh, within)
        if agent_axes:
            am = _sub_mesh(mesh, agent_axes)
            self._agents_mesh = am if len(agent_axes) == 1 else am._flatten()
            self.agent = self._agents_mesh.get_local_rank()
            n = self._agents_mesh.size()
        else:
            self._agents_mesh, self.agent, n = None, 0, 1
        if n != plan.n_agents:
            raise ValueError(f"the mesh holds {n} agents, the step was built for {plan.n_agents}")
        self.collective = (GroupCollective(self._agents_mesh.get_group())
                           if self._agents_mesh is not None and n > 1 else None)
        self._rounds = 0  # rounds drawn from a generator (the shard streams' seeds)
        # One agent's specs: the agent dim dropped.
        self.agent_specs = map_specs(lambda s: drop_dim(s, 0), pspecs)
        self.batch_specs = map_specs(lambda s: drop_dim(s, 0), bspecs)

    def _distribute(self, spec, x):
        from torch.distributed.tensor import DTensor

        pl = placements(spec, self.agent_mesh)
        return DTensor.from_local(_local_slice(x, self.agent_mesh, pl).contiguous(),
                                  self.agent_mesh, pl, run_check=False, shape=x.shape,
                                  stride=x.contiguous().stride())

    def shard(self, tree):
        """One agent's tree of full tensors -> DTensors on the agent mesh."""
        return map_specs(self._distribute, self.agent_specs, tree)

    def _shard_generator(self, generator):
        """This rank's stream for the noise of the leaves split over its
        agent's ranks, new each round: seeded from ``generator``'s seed,
        the round and the rank's coordinate in the agent mesh (the
        replicated leaves draw from ``generator`` itself, alike on every
        rank of the agent)."""
        self._rounds += 1
        coord = 0
        for i, c in enumerate(self.agent_mesh.get_coordinate() or ()):
            coord = coord * self.agent_mesh.size(i) + c
        seed = (generator.initial_seed() * 1_000_003 + self._rounds) * 65_537 + coord
        return torch.Generator(device=generator.device).manual_seed(seed % (1 << 63))

    def _all_reduce(self, t, dims, mesh):
        import torch.distributed._functional_collectives as funcol

        for i in dims:
            t = funcol.all_reduce(t, "sum", (mesh, i))
        return t

    def _mix(self, theta):
        """This agent's row of the round's gossip of the (1, w) block."""
        plan, A, i = self.plan, self.plan.n_agents, self.agent
        if plan.gossip == "ppermute":
            residues = _residues(plan.offsets, A)
            w = 1.0 / len(residues)
            xg = theta.to(plan.gossip_dtype) if plan.gossip_dtype is not None else theta
            acc = torch.zeros(xg.shape, dtype=F32, device=theta.device)
            for r in residues:
                got = xg if r == 0 else self.collective.ppermute(xg, r)
                acc = acc + w * got.to(F32)
            return acc.to(theta.dtype)
        every = self.collective.all_gather(theta[0])  # (A, w)
        if plan.gossip == "dense":
            return gossip_dense(every, plan.mix_mat)[i:i + 1]
        return gossip_gather(every, plan.mix_idx, plan.mix_w)[i:i + 1]

    @torch.no_grad()
    def __call__(self, params, batch, generator=None, draws=None):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication

        plan = self.plan
        p2p, bundle = plan.p2p, plan.bundle
        if p2p.dp_enabled and draws is None and generator is None:
            raise ValueError("DP is on: pass a generator or draws")
        batch = {k: v if isinstance(v, DTensor) else self._distribute(self.batch_specs[k], v)
                 for k, v in batch.items()}
        grads = tree_map(torch.empty_like, params)
        with torch.enable_grad(), implicit_replication():
            model = bundle.bind(params)
            with record_function("agent_forward"):
                loss = bundle.loss(model, batch)
            dsts = module_views(grads, bundle.stacked)
            with record_function("agent_backward"):
                got = torch.autograd.grad(loss, [model.get_parameter(n) for n, _ in dsts],
                                          allow_unused=True)
            with record_function("grad_copy"):
                for (_, dst), g in zip(dsts, got):
                    if g is None:
                        dst.zero_()
                    else:
                        dst.copy_(g)
        del model, got
        loss = loss.detach().to_local().to(F32).reshape(1)
        leaves = tree_flatten_with_path(params)
        gleaves = dict(tree_flatten_with_path(grads))
        total = torch.zeros((1,), dtype=F32, device=loss.device)
        for name, _ in leaves:
            g = gleaves[name]
            dims = [i for i, pl in enumerate(g.placements)
                    if pl.is_shard() and g.device_mesh.size(i) > 1]
            part = 0 if dims else total
            for blk in _column_blocks(g.to_local(), 1):
                part = part + torch.sum(torch.square(blk.to(F32)), dim=1)
            total = total + self._all_reduce(part, dims, g.device_mesh) if dims else part
        norm = torch.sqrt(total)
        s = _clip_scale(norm, p2p.clip)[:, None] if p2p.dp_enabled else None
        shard_gen = (self._shard_generator(generator)
                     if p2p.dp_enabled and draws is None else None)
        for name, leaf in leaves:
            g_leaf = gleaves[name]
            if p2p.dp_enabled and draws is not None:
                d_blocks = _column_blocks(_local_slice(
                    _draws_of(name, leaf, draws), leaf.device_mesh, leaf.placements
                ).contiguous(), 1)
            elif p2p.dp_enabled:
                local = leaf.to_local()
                split = any(pl.is_shard() and leaf.device_mesh.size(i) > 1
                            for i, pl in enumerate(leaf.placements))
                d_blocks = _column_blocks(standard_laplace(
                    local.shape, shard_gen if split else generator, local.device, F32), 1)
            else:
                d_blocks = itertools.repeat(None)
            blocks = zip(_column_blocks(leaf.to_local(), 1),
                         _column_blocks(g_leaf.to_local(), 1), d_blocks)
            for theta, g, d in blocks:
                if p2p.dp_enabled:
                    with record_function("clip_noise"):
                        g = _perturb(g, s, plan.noise_scale, generator, d)
                with record_function("gossip"):
                    mix = self._mix(theta) if plan.do_gossip else theta
                with record_function("update"):
                    t32 = theta.to(F32)
                    m32 = mix.to(F32) if plan.do_gossip else t32
                    theta.copy_((1.0 - plan.alpha) * t32
                                + plan.alpha * (m32 - p2p.mu * g.to(F32)))
                del g, mix, t32, m32
        metrics = {"loss": loss, "grad_norm": norm}
        if self.collective is not None:
            import torch.distributed._functional_collectives as funcol

            group = self._agents_mesh.get_group()
            metrics = {k: funcol.all_reduce(v, "sum", group) / plan.n_agents
                       for k, v in metrics.items()}
        return params, {k: v.mean() for k, v in metrics.items()}

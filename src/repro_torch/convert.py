"""Carry problems and engine states across from the JAX package, as numpy.

The port never imports ``repro``; these functions take the reference's
objects as plain numpy arrays (``np.asarray`` of any of its arrays) and
build the port's, or give the port's back as numpy:

* :func:`objective_from_numpy` — an :class:`~repro_torch.core.objective.Objective`
  from a CSR graph (``indptr``/``indices``/``data``) or dense ``weights``,
  the padded data, and the constants;
* :func:`objective_from_reference` — the same, read off any object with
  the reference ``Objective``'s attribute names;
* :func:`dp_update_from_reference` — a :class:`~repro_torch.sim.updates.DPCDUpdate`
  from the reference's (its plan read as numpy, not recomputed);
* :func:`sim_state_from_numpy` / :func:`sim_state_to_numpy` — an engine
  ``SimState``, with a private update's (n,) applied-update counts
  (``ustate``). The random key is not carried: the two packages' random
  streams differ, so the port's state takes a fresh generator seed;
* :func:`sharded_sim_state_from_numpy` — a ``ShardedSimState`` from the
  reference's stacked (S, R, ...) leaves (``Theta``, ``active``, the
  private counts, the (S,) counters, the error-feedback ``ef`` and the
  device ``metrics``), its halo rows zero (the next slot's exchange fills
  them); the per-shard keys are not carried, the generator starts from
  ``seed``;
* :func:`topology_state_from_numpy` — a
  :class:`~repro_torch.core.graph.TopologyState` of tensors from a
  reference ``TopologyState``'s arrays (the live topology of a dynamic
  engine);
* :func:`load_reference_params` — a model parameter tree (nested dicts of
  arrays) into an ``nn.Module`` whose ``state_dict`` names follow it;
* :func:`hybrid_params_from_reference` — the zamba2 hybrid's
  ``init_params`` tree as a :class:`~repro_torch.models.hybrid.HybridLM`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dp_cd import DPConfig
from repro_torch.core.graph import AgentGraph, CSRGraph, TopologyState
from repro_torch.core.objective import AgentData, Objective, make_objective
from repro_torch.device import resolve_device
from repro_torch.models.hybrid import HybridLM
from repro_torch.sim.engine import ShardedSimState, SimState
from repro_torch.sim.updates import DPCDUpdate


def objective_from_numpy(
    *,
    X,
    y,
    mask,
    mu: float,
    loss: str = "quadratic",
    indptr=None,
    indices=None,
    data=None,
    weights=None,
    lambdas=None,
    confidences=None,
    clip: float | None = None,
    mix_mode: str = "auto",
) -> Objective:
    """Objective from numpy arrays: a CSR graph or dense ``weights``."""
    if weights is not None:
        graph = AgentGraph(np.asarray(weights, dtype=np.float64))
    else:
        graph = CSRGraph(
            indptr=np.asarray(indptr, dtype=np.int64),
            indices=np.asarray(indices, dtype=np.int32),
            data=np.asarray(data, dtype=np.float64),
        )
    agent_data = AgentData(X=np.asarray(X), y=np.asarray(y), mask=np.asarray(mask))
    return make_objective(
        graph,
        agent_data,
        loss,
        mu,
        lambdas=None if lambdas is None else np.asarray(lambdas),
        confidences=None if confidences is None else np.asarray(confidences),
        clip=clip,
        mix_mode=mix_mode,
    )


def objective_from_reference(obj) -> Objective:
    """Objective from an object laid out like the reference ``Objective``
    (``graph``, ``data.X/y/mask``, ``loss.name``, ``mu``, ``lambdas``,
    ``confidences``, ``clip``, ``mix_mode``), read as numpy."""
    g = obj.graph
    if hasattr(g, "indptr"):
        graph = {"indptr": g.indptr, "indices": g.indices, "data": g.data}
    else:
        graph = {"weights": g.weights}
    return objective_from_numpy(
        X=np.asarray(obj.data.X),
        y=np.asarray(obj.data.y),
        mask=np.asarray(obj.data.mask),
        mu=float(obj.mu),
        loss=obj.loss.name,
        lambdas=np.asarray(obj.lambdas),
        confidences=np.asarray(obj.confidences),
        clip=obj.clip,
        mix_mode=obj.mix_mode,
        **{k: np.asarray(v) for k, v in graph.items()},
    )


def dp_update_from_reference(upd) -> DPCDUpdate:
    """A :class:`DPCDUpdate` from an object laid out like the reference's
    (``obj``, ``cfg``, ``planned_Ti``, ``eps_step``, ``scales``): the same
    plan, its numbers read as numpy, over the port's copy of ``upd.obj``."""
    c = upd.cfg
    cfg = DPConfig(eps_bar=float(c.eps_bar), delta_bar=float(c.delta_bar), schedule=c.schedule,
                   T_total=int(c.T_total), mechanism=c.mechanism,
                   delta_step=float(c.delta_step))
    return DPCDUpdate(obj=objective_from_reference(upd.obj), cfg=cfg,
                      planned_Ti=int(upd.planned_Ti), eps_step=float(upd.eps_step),
                      scales=np.array(upd.scales, dtype=np.float64, copy=True))


def sim_state_from_numpy(
    Theta,
    hist,
    ptr,
    active,
    applied,
    dropped,
    messages,
    *,
    device="cuda",
    dtype=torch.float32,
    seed: int = 0,
    ustate=(),
) -> SimState:
    """An engine state from numpy leaves; the generator starts from ``seed``.

    ``ustate``: the update's state — ``()`` for the stateless rules, or a
    private update's (n,) integer counts, which land on ``device`` as int32.
    """
    dev = resolve_device(device)

    def t(a, dt):
        return torch.as_tensor(np.array(a, copy=True)).to(device=dev, dtype=dt)

    if not (isinstance(ustate, tuple) and not ustate):
        counts = np.asarray(ustate)
        if counts.ndim != 1 or not np.issubdtype(counts.dtype, np.integer):
            raise TypeError(f"ustate must be () or (n,) integer counts, got {counts.dtype} "
                            f"of shape {counts.shape}")
        ustate = t(counts, torch.int32)

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return SimState(
        Theta=t(Theta, dtype),
        hist=t(hist, dtype),
        ptr=t(ptr, torch.long),
        active=t(active, torch.bool),
        generator=gen,
        ustate=ustate,
        applied=t(applied, torch.long),
        dropped=t(dropped, torch.long),
        messages=t(messages, torch.float32),
    )


# The float metrics leaves; every other counter lands as int64 (the
# reference's int32 counters and float32 byte counts alike).
_FLOAT_METRICS = ("quant_err_sq", "ef_residual_sq")


def sharded_sim_state_from_numpy(
    Theta,
    active,
    applied,
    dropped,
    messages,
    ptr,
    *,
    halo_width: int,
    device="cuda",
    dtype=torch.float32,
    seed: int = 0,
    ustate=(),
    ef=None,
    metrics=None,
) -> ShardedSimState:
    """A sharded engine state from the reference's stacked numpy leaves.

    ``Theta`` (S, R, p), ``active`` (S, R), the (S,) counters, ``ustate``
    ``()`` or the (S, R) private counts (int32 on ``device``), ``ef`` the
    (S, Bmax, p) accumulator or None, ``metrics`` the (S, ...) counters or
    None. ``halo_width`` is the engine's Hmax (``engine.smix.halo_width``):
    the state's slab holds S * (R + Hmax) rows, the halo rows zero.
    """
    dev = resolve_device(device)

    def t(a, dt):
        return torch.as_tensor(np.array(a, copy=True)).to(device=dev, dtype=dt)

    Theta = np.asarray(Theta)
    S, R, p = Theta.shape
    slab = torch.zeros((S * (R + int(halo_width)), p), dtype=dtype, device=dev)
    slab[: S * R] = t(Theta.reshape(S * R, p), dtype)
    if not (isinstance(ustate, tuple) and not ustate):
        counts = np.asarray(ustate)
        if counts.shape != (S, R) or not np.issubdtype(counts.dtype, np.integer):
            raise TypeError(f"ustate must be () or ({S}, {R}) integer counts, got "
                            f"{counts.dtype} of shape {counts.shape}")
        ustate = t(counts, torch.int32)
    if metrics is not None:
        metrics = {k: t(v, torch.float32 if k in _FLOAT_METRICS else torch.int64)
                   for k, v in metrics.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return ShardedSimState(
        Theta=slab[: S * R].view(S, R, p),
        active=t(active, torch.bool),
        generator=gen,
        ustate=ustate,
        applied=t(applied, torch.long),
        dropped=t(dropped, torch.long),
        messages=t(messages, torch.float32),
        ptr=t(ptr, torch.long),
        slab=slab,
        ef=None if ef is None else t(ef, dtype),
        metrics=metrics,
    )


def sim_state_to_numpy(state: SimState) -> dict:
    """The numpy leaves of an engine state (the generator is not carried);
    ``ustate`` is there when the update keeps a tensor state (the private
    update's counts)."""
    leaves = ("Theta", "hist", "ptr", "active", "applied", "dropped", "messages")
    out = {k: getattr(state, k).to("cpu", copy=True).numpy() for k in leaves}
    if isinstance(state.ustate, torch.Tensor):
        out["ustate"] = state.ustate.to("cpu", copy=True).numpy()
    return out


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(value)


def load_reference_params(module: torch.nn.Module, tree, stacked=()) -> torch.nn.Module:
    """Copy the reference parameter ``tree`` into ``module`` and return it.

    Leaf ``a.b.c`` of the tree goes to the state-dict entry ``a.b.c``; under
    a top-level key in ``stacked`` the leaves carry a leading layer axis,
    and layer i goes to ``<key>.<i>.<rest>`` (a ``ModuleList``). Names,
    shapes and types must match exactly (bfloat16 leaves, as numpy reads
    them, included); anything else raises.
    """
    state = {}
    for name, arr in _flatten(tree):
        head, _, rest = name.partition(".")
        if head in stacked:
            for i in range(arr.shape[0]):
                state[f"{head}.{i}.{rest}"] = arr[i]
        else:
            state[name] = arr
    own = module.state_dict()
    if set(own) != set(state):
        raise KeyError(f"parameter names differ: missing {sorted(set(own) - set(state))}, "
                       f"unexpected {sorted(set(state) - set(own))}")
    with torch.no_grad():
        for name, dst in own.items():
            arr = state[name]
            bf16 = arr.dtype.name == "bfloat16"  # numpy reads it as ml_dtypes' type
            src = torch.from_numpy(np.array(arr, dtype=np.float32 if bf16 else arr.dtype))
            src_dtype = torch.bfloat16 if bf16 else src.dtype
            if src_dtype != dst.dtype or tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: reference {src_dtype} {tuple(src.shape)}, "
                                 f"port {dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
    return module


def hybrid_params_from_reference(tree, cfg, device="cuda"):
    """The reference hybrid's ``init_params(key, cfg)`` tree (its leaves as
    numpy, the ``layers`` axis stacked) -> a :class:`HybridLM` on ``device``."""
    return load_reference_params(HybridLM(cfg, device=device), tree, stacked=("layers",))


def topology_state_from_numpy(nbr, w, valid, version, *, device="cuda") -> TopologyState:
    """A :class:`TopologyState` of tensors on ``device`` from the arrays of a
    reference ``TopologyState`` (``nbr`` (n, capacity) int32, ``w`` float,
    ``valid`` bool, ``version`` 0-d int32), copied."""
    dev = resolve_device(device)
    nbr, w, valid = (np.array(a, copy=True) for a in (nbr, w, valid))
    if not (nbr.ndim == 2 and nbr.shape == w.shape == valid.shape):
        raise ValueError(f"nbr, w and valid must share one (n, capacity) shape, got "
                         f"{nbr.shape}, {w.shape}, {valid.shape}")

    def t(a, dt):
        return torch.as_tensor(a).to(device=dev, dtype=dt)

    return TopologyState(nbr=t(nbr, torch.int32), w=t(w, torch.as_tensor(w).dtype),
                         valid=t(valid, torch.bool),
                         version=t(np.asarray(version, dtype=np.int32), torch.int32))

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
  streams differ, so the port's state takes a fresh generator seed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dp_cd import DPConfig
from repro_torch.core.graph import AgentGraph, CSRGraph
from repro_torch.core.objective import AgentData, Objective, make_objective
from repro_torch.device import resolve_device
from repro_torch.sim.engine import SimState
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


def sim_state_to_numpy(state: SimState) -> dict:
    """The numpy leaves of an engine state (the generator is not carried);
    ``ustate`` is there when the update keeps a tensor state (the private
    update's counts)."""
    leaves = ("Theta", "hist", "ptr", "active", "applied", "dropped", "messages")
    out = {k: getattr(state, k).to("cpu", copy=True).numpy() for k in leaves}
    if isinstance(state.ustate, torch.Tensor):
        out["ustate"] = state.ustate.to("cpu", copy=True).numpy()
    return out

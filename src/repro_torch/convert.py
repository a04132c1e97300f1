"""Carry problems and engine states across from the JAX package, as numpy.

The port never imports ``repro``; these functions take the reference's
objects as plain numpy arrays (``np.asarray`` of any of its arrays) and
build the port's, or give the port's back as numpy:

* :func:`objective_from_numpy` — an :class:`~repro_torch.core.objective.Objective`
  from a CSR graph (``indptr``/``indices``/``data``) or dense ``weights``,
  the padded data, and the constants;
* :func:`objective_from_reference` — the same, read off any object with
  the reference ``Objective``'s attribute names;
* :func:`sim_state_from_numpy` / :func:`sim_state_to_numpy` — an engine
  ``SimState``. The random key is not carried: the two packages' random
  streams differ, so the port's state takes a fresh generator seed.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import AgentGraph, CSRGraph
from repro_torch.core.objective import AgentData, Objective, make_objective
from repro_torch.device import resolve_device
from repro_torch.sim.engine import SimState


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
    """An engine state from numpy leaves; the generator starts from ``seed``."""
    dev = resolve_device(device)

    def t(a, dt):
        return torch.as_tensor(np.array(a, copy=True)).to(device=dev, dtype=dt)

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
    """The numpy leaves of an engine state (the generator is not carried)."""
    leaves = ("Theta", "hist", "ptr", "active", "applied", "dropped", "messages")
    return {k: getattr(state, k).to("cpu", copy=True).numpy() for k in leaves}

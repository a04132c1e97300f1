"""Minimal optax-style optimizers (dependency-free).

Port of ``repro/optim/optimizers.py``. The paper's update IS the optimizer
for P2P training (:mod:`repro_torch.core.spmd`); these exist for the
centralized baselines the paper compares against and for the train
launcher's baselines. Moments are float32 whatever the parameters' type.

Each factory returns (init_fn, update_fn):
    state = init_fn(params)
    updates, state = update_fn(grads, state, params)
    params = apply_updates(params, updates)
"""

from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

F32 = torch.float32


def apply_updates(params, updates):
    """Float32 ``p + u``, cast back to each leaf's type."""
    return tree_map(lambda p, u: (p.to(F32) + u).to(p.dtype), params, updates)


def sgd(lr: float, momentum: float = 0.0):
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)

    def update(grads, state, params=None):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g.to(F32), grads), state
        new_state = tree_map(lambda m, g: momentum * m + g.to(F32), state, grads)
        return tree_map(lambda m: -lr * m, new_state), new_state

    return init, update


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01):
    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=F32)  # noqa: E731
        leaves = tree_leaves(params)
        return {
            "mu": tree_map(z, params),
            "nu": tree_map(z, params),
            "t": torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None),
        }

    def update(grads, state, params):
        t = state["t"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(F32), state["mu"], grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(F32)), state["nu"], grads)
        mhat = tree_map(lambda m: m / (1 - b1 ** t.to(F32)), mu)
        vhat = tree_map(lambda v: v / (1 - b2 ** t.to(F32)), nu)
        upd = tree_map(
            lambda m, v, p: -lr * (m / (torch.sqrt(v) + eps) + weight_decay * p.to(F32)),
            mhat, vhat, params,
        )
        return upd, {"mu": mu, "nu": nu, "t": t}

    return init, update

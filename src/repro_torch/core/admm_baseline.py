"""Asynchronous gossip ADMM baseline of Vanhaesebrouck et al. (2017).

Port of ``repro.core.admm_baseline``. The paper's Fig. 1 compares its
coordinate-descent algorithm against this ADMM. Following the description
in Sec. 4 / Sec. 5.1:

* the objective (Eq. 2) is cast as partial consensus by duplicating each
  node variable once per incident edge: for edge e = (i, j) the copies
  Theta_i^e, Theta_j^e carry the smoothness term, with consensus
  constraints Theta_i^e = Theta_i. This yields **4 auxiliary variables per
  edge** (two primal copies + two scaled duals), exactly as the paper notes;
* communication is gossip-based: at each tick one *edge* (i, j) is activated
  and the two endpoints exchange; auxiliary variables of an edge are updated
  only when that edge is activated (the inefficiency the paper blames for
  ADMM's slowness);
* each primal update runs ``local_grad_steps`` gradient steps (10 in the
  paper's experiment) on the local augmented Lagrangian.

Message accounting matches Fig. 1's x-axis: each edge activation transmits
2 p-dimensional vectors (one each way).

The edge sampling, incidence lists, edge (z) and dual (u) updates and the
message count are host-side numpy in float64, copied from the reference,
so the same ``rng`` activates the same edges. The node update (the
reference's jitted ``lax.scan`` of gradient steps) is a plain PyTorch
function on ``device`` in float32, as the reference runs it, with the
gradient of the objective's own loss; the objective is recorded in
float32 on ``device`` too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.objective import Objective
from repro_torch.device import resolve_device


@dataclasses.dataclass
class ADMMResult:
    Theta: np.ndarray
    objective: np.ndarray
    messages: np.ndarray


def node_update(loss, X, y, mask, lam, dc, theta, zs, us, deg_mask, rho: float, lr: float,
                steps: int):
    """``steps`` gradient steps on one node's local augmented Lagrangian
    ``f_i(theta) + (rho/2) sum_{e in i} ||theta - z_e^i + u_e^i||^2``,
    ``f_i = mu D_ii c_i L_i``, from ``theta``.

    ``X`` (m, p), ``y``/``mask`` (m,): the node's padded data; ``lam`` and
    ``dc`` (= mu D_ii c_i): its scalars as 0-d tensors; ``zs``/``us``
    (max_deg, p): its edge copies and duals, rows masked by ``deg_mask``
    (max_deg,). All on one device in one dtype; returns the new (p,) theta.
    """
    m = mask.sum().clamp(min=1.0)
    for _ in range(steps):
        g = torch.sum(loss.point_grad(theta, X, y) * mask[:, None], dim=0) / m
        g = dc * (g + 2.0 * lam * theta)
        g = g + rho * torch.sum((theta[None, :] - zs + us) * deg_mask[:, None], dim=0)
        theta = theta - lr * g
    return theta


def run_admm(
    obj: Objective,
    Theta0: np.ndarray,
    T: int,
    rng: np.random.Generator,
    rho: float = 1.0,
    local_grad_steps: int = 10,
    local_lr: float | None = None,
    record_every: int = 1,
    device="cuda",
) -> ADMMResult:
    dev = resolve_device(device)
    f32 = torch.float32
    n, p = obj.n, obj.p
    erows, ecols, evals = obj.graph.edge_list()
    edges = list(zip(erows.tolist(), ecols.tolist()))
    E = len(edges)
    incident: list[list[int]] = [[] for _ in range(n)]
    for e, (i, j) in enumerate(edges):
        incident[i].append(e)
        incident[j].append(e)

    d = obj.degrees
    c = obj.confidences
    mu = obj.mu
    # f_i(theta) = mu D_ii c_i L_i(theta) — the separable part.
    if local_lr is None:
        # Safe step size: smoothness of f_i + rho * deg_i.
        L_f = mu * d * c * obj.local_smoothness()
        local_lr = float(1.0 / (L_f.max() + rho * max(len(ic) for ic in incident)))

    Theta = np.array(Theta0, dtype=np.float64, copy=True)
    # Edge copies z[e, 0] ~ node i's copy, z[e, 1] ~ node j's copy; duals u likewise.
    z = np.zeros((E, 2, p))
    for e, (i, j) in enumerate(edges):
        z[e, 0] = Theta[i]
        z[e, 1] = Theta[j]
    u = np.zeros((E, 2, p))

    t = obj.tensors(dev, f32)
    X, Y, M, lam = t["X"], t["y"], t["mask"], t["lam"]
    dc = torch.as_tensor(mu * d * c).to(device=dev, dtype=f32)
    max_deg = max(len(ic) for ic in incident)

    def update(i, theta_i):
        ic = incident[i]
        zs = np.zeros((max_deg, p), np.float32)
        us = np.zeros((max_deg, p), np.float32)
        mask = np.zeros(max_deg, np.float32)
        for k, e in enumerate(ic):
            side = 0 if edges[e][0] == i else 1
            zs[k] = z[e, side]
            us[k] = u[e, side]
            mask[k] = 1.0
        th = node_update(
            obj.loss, X[i], Y[i], M[i], lam[i], dc[i],
            torch.as_tensor(theta_i, dtype=f32).to(dev), torch.as_tensor(zs).to(dev),
            torch.as_tensor(us).to(dev), torch.as_tensor(mask).to(dev),
            rho, local_lr, local_grad_steps,
        )
        return th.cpu().numpy().astype(np.float64)

    def value():
        return float(obj.value(torch.as_tensor(Theta, dtype=f32).to(dev)))

    objective = [value()]
    messages = [0.0]
    msg = 0.0
    for step in range(T):
        e = int(rng.integers(E))
        i, j = edges[e]
        # Primal node updates (each endpoint uses current copies/duals).
        Theta[i] = update(i, Theta[i])
        Theta[j] = update(j, Theta[j])
        # Edge (z) update: minimize the edge smoothness + proximity to the
        # broadcasted node variables: closed form for
        #   (W_ij/2)||z_i - z_j||^2 + rho/2 (||z_i - a||^2 + ||z_j - b||^2)
        a = Theta[i] + u[e, 0]
        b = Theta[j] + u[e, 1]
        w = evals[e]
        denom = rho * (rho + 2.0 * w)
        z[e, 0] = ((rho + w) * rho * a + w * rho * b) / denom
        z[e, 1] = (w * rho * a + (rho + w) * rho * b) / denom
        # Dual ascent.
        u[e, 0] += Theta[i] - z[e, 0]
        u[e, 1] += Theta[j] - z[e, 1]
        msg += 2.0
        if (step + 1) % record_every == 0 or step == T - 1:
            objective.append(value())
            messages.append(msg)
    return ADMMResult(Theta=Theta, objective=np.asarray(objective), messages=np.asarray(messages))

"""The paper's non-private algorithm (Sec. 2.3): asynchronous decentralized
block coordinate descent under the Poisson-clock / broadcast model.

Port of ``repro.core.coordinate_descent``. At each global tick t one
uniformly-random agent i wakes up and performs the Eq. 4 update

    Theta_i <- (1 - alpha_i) Theta_i
               + alpha_i ( sum_j (W_ij / D_ii) Theta_j - mu c_i grad L_i(Theta_i) )

with alpha_i = 1 / (1 + mu c_i L_i^loc), and broadcasts Theta_i to its
|N_i| neighbours (the message count).

Two execution paths share the same math, both Python loops over a wake
sequence (the reference's ``run_scan`` is a ``lax.scan``):

* ``run``      — records Q every ``record_every`` ticks;
* ``run_scan`` — the same loop with the optional Eq. 6 gradient noise.

Both take an explicit ``device`` (default ``"cuda"``) and ``dtype``
(default float32, as the reference runs them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.graph import neighbor_counts
from repro_torch.core.objective import Objective
from repro_torch.device import resolve_device

@dataclasses.dataclass
class CDResult:
    Theta: np.ndarray  # final (n, p)
    objective: np.ndarray  # recorded Q values (0 = init)
    messages: np.ndarray  # cumulative p-vectors transmitted at the same ticks
    wake_sequence: np.ndarray  # (T,)


def sample_wake_sequence(n: int, T: int, rng: np.random.Generator) -> np.ndarray:
    """Global-clock view of n i.i.d. rate-1 Poisson clocks: uniform agent per tick."""
    return rng.integers(0, n, size=T)


def _agent_grad_from_data(obj: Objective, theta, X, y, mask, lam):
    """grad L_i at theta from already-gathered data rows, batched.

    theta ``(..., p)``, X ``(..., m, p)``, y/mask ``(..., m)``, lam ``(...)``,
    all in theta's dtype. The one gradient formula every execution path
    (sequential loops, the engine) reduces to.
    """
    m = mask.sum(dim=-1).clamp(min=1.0)
    g = obj._point_grads(theta, X, y)
    return torch.sum(g * mask[..., None], dim=-2) / m[..., None] + 2.0 * lam[..., None] * theta


def _single_agent_grad(obj: Objective, theta_i, i):
    """grad L_i at theta_i for agent index i."""
    t = obj.tensors(theta_i.device, theta_i.dtype)
    return _agent_grad_from_data(obj, theta_i, t["X"][i], t["y"][i], t["mask"][i], t["lam"][i])


def eq4_agent_constants(obj: Objective) -> dict:
    """The per-agent host arrays (leading dim n) the Eq. 4 row step reads:
    ``deg``/``conf``/``alpha``/``lam`` (n,) theory constants and the
    padded datasets ``X`` (n, m, p), ``y``/``mask`` (n, m). Their device
    copies are :meth:`Objective.tensors`."""
    return {
        "deg": obj.degrees,
        "conf": obj.confidences,
        "alpha": obj.alphas(),
        "lam": obj.lambdas,
        "X": obj.data.X,
        "y": obj.data.y,
        "mask": obj.data.mask,
    }


def eq4_theta_rows_from(obj: Objective, theta, neigh, consts, grad_noise=None):
    """Batched Eq. 4 update from pre-gathered per-agent constants.

    ``theta``/``neigh``: (B, p) current rows and their raw neighbour sums
    ``sum_j W_ij Theta_j``. ``consts``: the row-gathered slice of
    :func:`eq4_agent_constants` as tensors — each (B, ...), row-aligned
    with ``theta``. ``grad_noise``: optional (B, p) perturbation added to
    the local gradient (the Eq. 6 private update); None is the
    non-private algorithm. Returns the (B, p) replacement rows.
    """
    dt = theta.dtype
    d, c, a = (consts[k].to(dt) for k in ("deg", "conf", "alpha"))
    grads = _agent_grad_from_data(
        obj, theta, consts["X"].to(dt), consts["y"].to(dt), consts["mask"].to(dt),
        consts["lam"].to(dt),
    )
    if grad_noise is not None:
        grads = grads + grad_noise
    return (1.0 - a[:, None]) * theta + a[:, None] * (
        neigh / d[:, None] - obj.mu * c[:, None] * grads
    )


def eq4_theta_rows(obj: Objective, theta, rows, neigh, grad_noise=None):
    """Batched Eq. 4 update for already-gathered rows.

    ``theta``: (B, p) current rows; ``rows``: (B,) agent indices, used to
    gather the per-agent constants (the padding sentinel n is clamped to
    n-1 for the gather; callers drop those rows on scatter); ``neigh``:
    (B, p) raw neighbour sums. Returns the (B, p) replacement rows.
    """
    safe = torch.clamp(rows.long(), max=obj.n - 1)
    t = obj.tensors(theta.device, theta.dtype)
    consts = {k: v[safe] for k, v in t.items()}
    return eq4_theta_rows_from(obj, theta, neigh, consts, grad_noise=grad_noise)


def eq4_rows(obj: Objective, Theta, rows, neigh, grad_noise=None):
    """:func:`eq4_theta_rows` with the row gather from the global (n, p) Theta."""
    safe = torch.clamp(rows.long(), max=obj.n - 1)
    return eq4_theta_rows(obj, Theta[safe], rows, neigh, grad_noise=grad_noise)


def _cd_row(obj: Objective, Theta, i, eta=None):
    """The Eq. 4 replacement row (p,) for agent i read from Theta."""
    t = obj.tensors(Theta.device, Theta.dtype)
    theta_i = Theta[i]
    neigh = obj.mix.row(Theta, i) / t["deg"][i]
    grad_i = _single_agent_grad(obj, theta_i, i)
    if eta is not None:
        grad_i = grad_i + eta
    a = t["alpha"][i]
    return (1.0 - a) * theta_i + a * (neigh - obj.mu * t["conf"][i] * grad_i)


def _cd_step(obj: Objective, Theta, i):
    """One Eq. 4 tick for agent i, written into Theta in place; returns Theta."""
    Theta[i] = _cd_row(obj, Theta, i)
    return Theta


def cd_update(obj: Objective, Theta, i):
    """One Eq. 4 update for agent ``i``: a new (n, p) tensor (Theta untouched)."""
    return _cd_step(obj, Theta.clone(), i)


def _record_ticks(T: int, record_every: int) -> set:
    return {t for t in range(1, T + 1) if t % record_every == 0 or t == T}


def run(
    obj: Objective,
    Theta0: np.ndarray,
    T: int,
    rng: np.random.Generator,
    record_every: int = 1,
    wake_sequence: np.ndarray | None = None,
    device="cuda",
    dtype=torch.float32,
) -> CDResult:
    """Python-loop reference implementation (exact Eq. 4 semantics)."""
    dev = resolve_device(device)
    n = obj.n
    if wake_sequence is None:
        wake_sequence = sample_wake_sequence(n, T, rng)
    Theta = torch.as_tensor(np.asarray(Theta0)).to(device=dev, dtype=dtype).clone()
    deg_counts = neighbor_counts(obj.graph)
    objective = [float(obj.value(Theta))]
    messages = [0.0]
    msg = 0.0
    marks = _record_ticks(T, record_every)
    for t in range(T):
        i = int(wake_sequence[t])
        _cd_step(obj, Theta, i)
        msg += float(deg_counts[i])
        if t + 1 in marks:
            objective.append(float(obj.value(Theta)))
            messages.append(msg)
    return CDResult(
        Theta=Theta.cpu().numpy(),
        objective=np.asarray(objective),
        messages=np.asarray(messages),
        wake_sequence=np.asarray(wake_sequence),
    )


def run_scan(
    obj: Objective,
    Theta0: np.ndarray,
    T: int,
    rng: np.random.Generator,
    record_every: int = 1,
    wake_sequence: np.ndarray | None = None,
    noise_scales: np.ndarray | None = None,
    noise_seed: int | None = None,
    record_objective: bool = True,
    device="cuda",
    dtype=torch.float32,
) -> CDResult:
    """The tick loop with optional Laplace noise on the local gradient,
    scale ``noise_scales[t]`` for the agent waking at tick t (the Eq. 6
    private update; scale 0 is the non-private algorithm). The noise comes
    from a ``torch.Generator`` on ``device`` seeded by ``noise_seed`` (drawn
    from ``rng`` when None); its draws differ from the reference's
    ``jax.random`` stream, only their distribution is the same.
    """
    dev = resolve_device(device)
    n, p = obj.n, obj.p
    if wake_sequence is None:
        wake_sequence = sample_wake_sequence(n, T, rng)
    noise = None
    if noise_scales is not None:
        if noise_seed is None:
            noise_seed = int(rng.integers(2**31 - 1))
        gen = torch.Generator(device=dev).manual_seed(noise_seed)
        u = torch.rand((T, p), generator=gen, device=dev, dtype=dtype) - 0.5
        lap = -torch.sign(u) * torch.log1p(-2.0 * u.abs())  # standard Laplace
        noise = lap * torch.as_tensor(np.asarray(noise_scales), device=dev, dtype=dtype)[:, None]

    Theta = torch.as_tensor(np.asarray(Theta0)).to(device=dev, dtype=dtype).clone()
    deg_counts = neighbor_counts(obj.graph)
    msgs = np.concatenate([[0.0], np.cumsum(deg_counts[np.asarray(wake_sequence[:T])])])
    marks = [0] + sorted(_record_ticks(T, record_every))
    objective = [float(obj.value(Theta)) if record_objective else 0.0]
    for t in range(T):
        i = int(wake_sequence[t])
        Theta[i] = _cd_row(obj, Theta, i, None if noise is None else noise[t])
        if record_objective and t + 1 in marks:
            objective.append(float(obj.value(Theta)))
    if not record_objective:
        objective = [0.0] * len(marks)
    return CDResult(
        Theta=Theta.cpu().numpy(),
        objective=np.asarray(objective),
        messages=msgs[marks],
        wake_sequence=np.asarray(wake_sequence),
    )


def synchronous_round(obj: Objective, Theta):
    """All agents apply Eq. 4 simultaneously from the same snapshot.

    One round = n async ticks in expectation, with the same fixed points:
    a round is ``Theta <- Theta - diag(1/L_i) grad Q(Theta)`` blockwise.
    """
    t = obj.tensors(Theta.device, Theta.dtype)
    neigh = obj.mix.all(Theta) / t["deg"][:, None]
    grads = obj.local_grad(Theta)
    a = t["alpha"][:, None]
    return (1.0 - a) * Theta + a * (neigh.to(Theta.dtype) - obj.mu * t["conf"][:, None] * grads)


def proposition1_bound(obj: Objective, gap0: float, T: int) -> np.ndarray:
    """E[Q(T)] - Q* <= (1 - sigma/(n L_max))^T (Q(0) - Q*)."""
    C = obj.contraction()
    return gap0 * (C ** np.arange(T + 1))

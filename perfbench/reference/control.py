"""The control: the reference put in the program's place, computed in bfloat16.

The configurations state float32; the nearest precision below is bfloat16.
The control runs the slot that the program runs (churn, wake draws, the
slot capacity, the budget mask, the Eq. 4 / Eq. 6 step, the counters) or
the synchronous round, with every draw and every operation in bfloat16,
and hands back a state for the comparison to judge as it judges the
program's. The comparison has to find it not correct (``control.py``).
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.eq4 import Eq4Reference

BF16 = torch.bfloat16


def _laplace(shape, gen, device):
    u = torch.rand(shape, generator=gen, device=device, dtype=BF16) * 2.0 - 1.0
    a = u.abs().clamp(max=1.0 - torch.finfo(BF16).eps)
    return torch.sign(u) * torch.log1p(-a)


class ControlSlot:
    """One slot of the engine's semantics in bfloat16 on the benchmark's
    own inputs. ``probs`` are the clocks' wake probabilities, ``batch`` the
    slot capacity, ``scales`` Theorem 1's noise scales (None: Eq. 4)."""

    def __init__(self, ref: Eq4Reference, probs: float, batch: int, churn=None,
                 planned=None, scales=None):
        self.ref, self.probs, self.batch = ref, probs, batch
        self.churn, self.planned, self.scales = churn, planned, scales

    def __call__(self, snap, thetas, seed: int):
        """The state after one slot from ``snap`` (a ``Snapshot``); ``thetas``
        are the delayed model matrices (``thetas[0]`` is ``snap.theta``)."""
        ref, dev = self.ref, snap.theta.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        n = snap.theta.shape[0]
        active = snap.active.clone()
        if self.churn is not None:
            leave = torch.rand(n, generator=gen, device=dev, dtype=BF16) < self.churn[0]
            rejoin = torch.rand(n, generator=gen, device=dev, dtype=BF16) < self.churn[1]
            active = torch.where(active, ~leave, rejoin)
        wake = (torch.rand(n, generator=gen, device=dev, dtype=BF16) < self.probs) & active
        woken = torch.nonzero(wake).squeeze(1)
        dropped = max(int(woken.numel()) - self.batch, 0)
        woken = woken[: self.batch]
        counts = None if snap.counts is None else snap.counts.clone()
        if counts is not None:
            woken = woken[counts[woken] < self.planned]
        noise = None
        if self.scales is not None:
            z = _laplace((woken.numel(), ref.p), gen, dev)
            noise = z * self.scales[woken].to(device=dev, dtype=BF16)[:, None]
        new = ref.step(woken, [t.to(BF16) for t in thetas], dtype=BF16, grad_noise=noise)
        theta = snap.theta.clone()
        theta[woken] = new.to(device=dev, dtype=theta.dtype)
        if counts is not None:
            counts[woken] += 1
        msgs = float(ref.counts[woken.to(ref.device)].sum())
        return snap.advanced(theta=theta, active=active, counts=counts, applied=int(woken.numel()),
                             dropped=dropped, messages=msgs)


def control_round(ref: Eq4Reference, theta: torch.Tensor) -> torch.Tensor:
    """A synchronous round computed in bfloat16 (as float32 out)."""
    return ref.round(theta.to(BF16), dtype=BF16).to(theta.device, torch.float32)


def wake_probability(slot_wakes: float, n: int) -> float:
    """The clocks' per-slot wake probability of a rate-1 agent:
    1 - exp(-tau) with tau = slot_wakes / n."""
    return -math.expm1(-float(slot_wakes) / n)

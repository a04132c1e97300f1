"""Mixture-of-Experts FFN: top-k router, grouped one-hot dispatch with
capacity (GShard-style), SwiGLU experts, load-balance auxiliary loss.

Port of ``repro/models/moe.py``, plain ``jnp`` there (no Pallas kernel),
plain PyTorch here. The tokens are cut into groups of ``group_size`` (the
last one padded with zero rows, which are routed like any other token, as
in the reference); each expert takes at most C = ceil(gs * top_k * cf /
E) of a group's (token, choice) pairs, queued rank-major (every token's
first choice, then every token's second, ...), and a pair whose queue
position is C or more is dropped.

Where the reference builds a (G, gs, k, E, C) one-hot of the queue
positions and sums it over k, the port compares each (token, expert)
position with ``arange(C)`` once: a token picks an expert at most once,
so the two give the same 0/1 dispatch, and a position past C gives a
zero row in both (``torch.nn.functional.one_hot`` would raise there). The
top-k is a stable descending sort, so a tie goes to the lower expert
index, as ``lax.top_k`` breaks it. The router computes in float32;
``dispatch`` and ``combine`` are cast to the model type before the
einsums, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Dense, _param, normal_
from repro_torch.models.sharding import einsum, gather_unless_divides, split_group


class MoE(nn.Module):
    """``router`` (d, E) float32; ``gate``/``up`` (E, d, f), ``down`` (E, f, d)
    in the model type, initialised N(0, 1/d) and N(0, 1/f)."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
        self.router = Dense(d, E, device=device, dtype=torch.float32, generator=generator)
        self.gate = _param((E, d, f), device, dtype)
        self.up = _param((E, d, f), device, dtype)
        self.down = _param((E, f, d), device, dtype)
        if generator is not None:
            for t, fan_in in ((self.gate, d), (self.up, d), (self.down, f)):
                normal_(t, generator, 1.0 / math.sqrt(fan_in))


def capacity(group_size: int, top_k: int, num_experts: int, cf: float) -> int:
    return max(int(math.ceil(group_size * top_k * cf / num_experts)), 1)


@dataclasses.dataclass
class Routing:
    """One call's routing over G groups of gs tokens (float32 unless noted)."""

    probs: torch.Tensor  # (G, gs, E) router softmax
    top_w: torch.Tensor  # (G, gs, k) renormalized weights of the chosen experts
    top_idx: torch.Tensor  # (G, gs, k) int64 chosen experts, best first
    onehot: torch.Tensor  # (G, gs, k, E)
    keep: torch.Tensor  # (G, gs, k) bool: the choice got a slot under capacity
    dispatch: torch.Tensor  # (G, gs, E, C) 0/1
    combine: torch.Tensor  # (G, gs, E, C) the choice's weight at its slot


def _groups(x, gs: int):
    """(B, S, d) -> ((G, gs, d) with the last group zero-padded, T)."""
    B, S, d = x.shape
    T = B * S
    G = -(-T // gs)
    xt = x.reshape(T, d)
    if G * gs != T:
        xt = F.pad(xt, (0, 0, 0, G * gs - T))
    return xt.reshape(G, gs, d), T


def route(params: MoE, xg, cfg) -> Routing:
    """The router's choices for the grouped tokens ``xg`` (G, gs, d)."""
    mcfg = cfg.moe
    E, k = mcfg.num_experts, mcfg.top_k
    gs = xg.shape[1]
    logits = (xg.to(torch.float32) @ params.router.w).to(torch.float32)  # (G, gs, E)
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = srt[..., :k], order[..., :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    C = capacity(gs, k, E, mcfg.capacity_factor)
    onehot = F.one_hot(top_idx, E).to(torch.float32)  # (G, gs, k, E)
    # Queue position of each (token, choice) in its expert: rank order,
    # then token order.
    G = xg.shape[0]
    flat = onehot.transpose(1, 2).reshape(G, k * gs, E)  # rank-major
    qpos = torch.cumsum(flat, dim=1) - flat
    qpos = qpos.reshape(G, k, gs, E).transpose(1, 2)  # (G, gs, k, E)
    kept = (qpos < C) & (onehot > 0)  # (G, gs, k, E)
    # One (token, expert) pair holds at most one choice: its position and
    # whether it was kept, summed over k, select its slot.
    pos_e = (qpos * onehot).sum(dim=2)  # (G, gs, E)
    kept_e = kept.any(dim=2)
    slots = torch.arange(C, device=xg.device, dtype=torch.float32)
    dispatch = ((pos_e[..., None] == slots) & kept_e[..., None]).to(torch.float32)
    w_e = (onehot * top_w[..., None]).sum(dim=2)  # (G, gs, E): the choice's weight
    combine = dispatch * w_e[..., None]
    return Routing(probs=probs, top_w=top_w, top_idx=top_idx, onehot=onehot,
                   keep=kept.any(dim=-1), dispatch=dispatch, combine=combine)


def moe_ffn(params: MoE, x, cfg):
    """x: (B, S, d) -> (y (B, S, d), aux_loss: a float32 scalar)."""
    mcfg = cfg.moe
    B, S, d = x.shape
    E = mcfg.num_experts
    gs = min(mcfg.group_size, B * S)
    x = gather_unless_divides(x, 0, -(-B * S // gs))  # identity off a mesh
    xg, T = _groups(x, gs)
    r = route(params, xg, cfg)

    # The expert products on the weights' own shards (d_ff on "model", the
    # reference's tensor-parallel experts): the layout hooks of
    # models/sharding.py, the identity off a mesh. A decode step's single
    # group, gathered for the router, is split again on its tokens.
    xd = einsum("gsec,gsd->gecd", split_group(r.dispatch.to(x.dtype), 1),
                split_group(xg, 1, 2))  # (G, E, C, d)
    h = F.silu(einsum("gecd,edf->gecf", xd, params.gate)) * einsum(
        "gecd,edf->gecf", xd, params.up)
    ye = einsum("gecf,efd->gecd", h, params.down)  # (G, E, C, d)
    y = einsum("gsec,gecd->gsd", split_group(r.combine.to(x.dtype), 1), ye)  # (G, gs, d)
    y = y.reshape(-1, d)
    if y.shape[0] != T:  # the last group's padding
        y = y[:T]
    y = y.reshape(B, S, d)

    # Load-balance loss (Switch/GShard): E * sum_e f_e * p_e.
    me = r.probs.mean(dim=(0, 1))  # mean router prob per expert
    fe = r.onehot.sum(dim=2).mean(dim=(0, 1))  # fraction routed per expert
    aux = E * torch.sum(me * fe) * mcfg.router_aux_weight
    return y, aux


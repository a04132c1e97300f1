"""GQA self-attention with RoPE, optional QKV bias, sliding window, logit
soft-capping, and a KV-cache decode path (ring buffer for windowed attention).

Port of ``repro/models/attention.py``: the causal self-attention of the
decoder families. The reference writes it in plain ``jnp`` (no Pallas
kernel), so plain PyTorch (``einsum``, ``softmax``) ports it as it is,
with the same cast points: scores in float32, softmax weights cast back
to the model type. Cross-attention (``kv_memory``, ``decode_cross_attention``)
and ``prefill_into_cache`` come with the enc-dec family.

Decode assumption, as in the reference: batched aligned decode, every
sequence of the batch at the same absolute position ``pos``. The port
writes the new key and value into the cache tensors in place (one row per
step) and returns the same cache.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import Dense, apply_rope, dense

NEG_INF = -1e30
CHUNKED_ATTN_THRESHOLD = 16384  # above this S, q-block chunking (flash-style)


class Attention(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        kw = dict(bias=cfg.qkv_bias, device=device, dtype=dtype, generator=generator)
        self.q = Dense(d, cfg.num_heads * hd, **kw)
        self.k = Dense(d, cfg.num_kv_heads * hd, **kw)
        self.v = Dense(d, cfg.num_kv_heads * hd, **kw)
        self.o = Dense(cfg.num_heads * hd, d, device=device, dtype=dtype, generator=generator)


def _split_heads(x, n_heads, hd):
    return x.reshape(*x.shape[:-1], n_heads, hd)


def _repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _softcap(scores, cap):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _scores(q, kr, hd):
    """(B, Sq, H, hd) x (B, Sk, H, hd) -> (B, H, Sq, Sk) float32 / sqrt(hd)."""
    return torch.einsum("bqhd,bkhd->bhqk", q, kr).to(torch.float32) / math.sqrt(hd)


def _chunked_causal_attention(q, kr, vr, positions, cfg, window, q_chunk=1024):
    """Causal attention one block of ``q_chunk`` queries at a time, so the
    (S, S) score matrix is never held whole: per block it is (q_chunk, S)."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = []
    for start in range(0, S, q_chunk):
        qc = q[:, start:start + q_chunk]
        pc = positions[start:start + q_chunk]
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, kr).to(torch.float32) * scale
        scores = _softcap(scores, cfg.logit_softcap)
        mask = positions[None, :] <= pc[:, None]
        if window is not None:
            mask = mask & (pc[:, None] - positions[None, :] < window)
        bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
        w = torch.softmax(scores + bias[None, None], dim=-1).to(qc.dtype)
        out.append(torch.einsum("bhqk,bkhd->bqhd", w, vr))
    return torch.cat(out, dim=1)


def attention(params: Attention, x, cfg, positions=None, window=None):
    """Causal self-attention over the whole sequence (prefill).

    x: (B, S, d) -> (y (B, S, d), (k, v)), the cached K/V in
    (B, S, KV, hd) layout with RoPE applied.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = _split_heads(dense(params.q, x), H, hd)
    k = _split_heads(dense(params.k, x), KV, hd)
    v = _split_heads(dense(params.v, x), KV, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kr = _repeat_kv(k, H // KV)
    vr = _repeat_kv(v, H // KV)
    if S >= CHUNKED_ATTN_THRESHOLD and S % 1024 == 0:
        y = _chunked_causal_attention(q, kr, vr, positions, cfg, window)
        return dense(params.o, y.reshape(B, S, H * hd)), (k, v)
    scores = _softcap(_scores(q, kr, hd), cfg.logit_softcap)
    qi = positions[:, None]
    ki = positions[None, :]
    mask = ki <= qi
    if window is not None:
        mask = mask & (qi - ki < window)
    bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    w = torch.softmax(scores + bias[None, None], dim=-1).to(x.dtype)
    y = torch.einsum("bhqk,bkhd->bqhd", w, vr).reshape(B, S, H * hd)
    return dense(params.o, y), (k, v)


def init_cache(cfg, batch, max_len, dtype, device):
    """KV cache. For windowed attention the buffer is the window (ring)."""
    hd = cfg.resolved_head_dim
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, size, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((size,), -1, dtype=torch.int32, device=device),  # absolute pos per slot
    }


def decode_attention(params: Attention, x, cfg, cache, pos: int):
    """One-token decode. x: (B, 1, d); pos: the absolute position (an int).

    Writes the token's K (RoPE applied) and V into ``cache`` in place and
    returns ``(y, cache)``.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = _split_heads(dense(params.q, x), H, hd)
    k = _split_heads(dense(params.k, x), KV, hd)
    v = _split_heads(dense(params.v, x), KV, hd)
    posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)

    size = cache["k"].shape[1]
    if cfg.sliding_window:
        slot = pos % size
    elif not 0 <= pos < size:
        raise ValueError(f"pos={pos} is outside the cache of {size} positions")
    else:
        slot = pos
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["slot_pos"][slot] = pos

    kr = _repeat_kv(cache["k"], H // KV)
    vr = _repeat_kv(cache["v"], H // KV)
    scores = _softcap(_scores(q, kr, hd), cfg.logit_softcap)
    slot_pos = cache["slot_pos"]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    scores = scores + torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, None, None, :]
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    y = torch.einsum("bhqk,bkhd->bqhd", w, vr).reshape(B, 1, H * hd)
    return dense(params.o, y), cache

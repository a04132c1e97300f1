"""GQA self-attention with RoPE, optional QKV bias, sliding window, logit
soft-capping, and a KV-cache decode path (ring buffer for windowed attention).

Port of ``repro/models/attention.py``, the attention of every family
built on it: zamba2's shared block (``hybrid``), the decoder-only
transformer (dense, MoE, VLM: ``transformer``) and the enc-dec
transformer (``encdec``: the bidirectional encoder, ``causal=False``, and
cross-attention, ``kv_memory`` and :func:`decode_cross_attention`). The
reference writes it in plain ``jnp`` (no Pallas kernel), so plain PyTorch
(``einsum``, ``softmax``) ports it as it is, with the same cast points:
scores in float32, softmax weights cast back to the model type.

Decode assumption, as in the reference: batched aligned decode, every
sequence of the batch at the same absolute position ``pos``. The port
writes the prefill's keys and values (:func:`prefill_into_cache`) and
each decode step's into the cache tensors in place and returns the same
cache; a position past the end of a full (not windowed) cache raises.

``REPEAT_KV_IN_CACHE`` (:func:`set_repeat_kv_cache`) stores the cache
pre-repeated to the query-head count, as the reference's lever does; the
prefill's compact keys and values are repeated as they are written.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import Dense, apply_rope, dense
from repro_torch.models.sharding import (batch_zeros, einsum, gather_unless_divides,
                                         repeat_heads, set_position, shard_like)

NEG_INF = -1e30
CHUNKED_ATTN_THRESHOLD = 16384  # above this S, q-block chunking (flash-style)

# The decode lever of the reference: store the KV cache pre-repeated to the
# full query-head count (H // KV times the memory of the compact cache).
REPEAT_KV_IN_CACHE = False


def set_repeat_kv_cache(flag: bool):
    global REPEAT_KV_IN_CACHE
    REPEAT_KV_IN_CACHE = flag


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
    # A DTensor split over more ranks than heads (8 KV heads over 16) is
    # gathered first: the split must keep whole heads.
    x = gather_unless_divides(x, x.ndim - 1, n_heads)
    return x.reshape(*x.shape[:-1], n_heads, hd)


def _repeat_kv(k, n_rep):
    return repeat_heads(k, n_rep, dim=2)


def _softcap(scores, cap):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _scores(q, kr, hd):
    """(B, Sq, H, hd) x (B, Sk, H, hd) -> (B, H, Sq, Sk) float32 / sqrt(hd)."""
    return einsum("bqhd,bkhd->bhqk", q, kr).to(torch.float32) / math.sqrt(hd)


def _chunked_causal_attention(q, kr, vr, positions, cfg, window, q_chunk=1024):
    """Causal attention one block of ``q_chunk`` queries at a time, so the
    (S, S) score matrix is never held whole: per block it is (q_chunk, S)."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    out = []
    for start in range(0, S, q_chunk):
        qc = q[:, start:start + q_chunk]
        pc = positions[start:start + q_chunk]
        scores = einsum("bqhd,bkhd->bhqk", qc, kr).to(torch.float32) * scale
        scores = _softcap(scores, cfg.logit_softcap)
        mask = positions[None, :] <= pc[:, None]
        if window is not None:
            mask = mask & (pc[:, None] - positions[None, :] < window)
        bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
        w = torch.softmax(scores + bias[None, None], dim=-1).to(qc.dtype)
        out.append(einsum("bhqk,bkhd->bqhd", w, vr))
    return torch.cat(out, dim=1)


def attention(params: Attention, x, cfg, positions=None, causal=True, window=None,
              kv_memory=None):
    """Full-sequence attention (train, prefill, encoder).

    x: (B, S, d). ``kv_memory``: an optional (B, S_kv, d) for
    cross-attention (then ``causal`` and ``window`` are ignored and no RoPE
    is applied). Returns ``(y (B, S, d), (k, v))``, the cached K/V in
    (B, S_kv, KV, hd) layout (RoPE applied to self-attention keys).
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    src = kv_memory if kv_memory is not None else x
    q = _split_heads(dense(params.q, x), H, hd)
    k = _split_heads(dense(params.k, src), KV, hd)
    v = _split_heads(dense(params.v, src), KV, hd)
    if kv_memory is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    # On a mesh: split like the queries' heads (identity off a mesh).
    kr = shard_like(_repeat_kv(k, H // KV), q, 2)
    vr = shard_like(_repeat_kv(v, H // KV), q, 2)
    if kv_memory is None and causal and S >= CHUNKED_ATTN_THRESHOLD and S % 1024 == 0:
        y = _chunked_causal_attention(q, kr, vr, positions, cfg, window)
        return dense(params.o, y.reshape(B, S, H * hd)), (k, v)
    scores = _softcap(_scores(q, kr, hd), cfg.logit_softcap)
    if kv_memory is None and causal:
        qi = positions[:, None]
        ki = positions[None, :]
        mask = ki <= qi
        if window is not None:
            mask = mask & (qi - ki < window)
        bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
        scores = scores + bias[None, None]
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    y = einsum("bhqk,bkhd->bqhd", w, vr).reshape(B, S, H * hd)
    return dense(params.o, y), (k, v)


def init_cache(cfg, batch, max_len, dtype, device):
    """KV cache. For windowed attention the buffer is the window (ring);
    with ``REPEAT_KV_IN_CACHE`` it holds every query head."""
    hd = cfg.resolved_head_dim
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    heads = cfg.num_heads if REPEAT_KV_IN_CACHE else cfg.num_kv_heads
    shape = (batch, size, heads, hd)
    return {  # batch-sharded on a mesh (models/sharding.py::batch_zeros)
        "k": batch_zeros(shape, dtype, device),
        "v": batch_zeros(shape, dtype, device),
        "slot_pos": torch.full((size,), -1, dtype=torch.int32, device=device),  # absolute pos per slot
    }


def prefill_into_cache(cfg, cache, k, v, seq_len: int):
    """Write the prefill's K/V (B, seq_len, KV, hd), RoPE applied, into
    ``cache`` in place and return it. A windowed cache shorter than the
    prompt keeps the last ``size`` positions, each at its ring slot
    ``pos % size``; a full cache shorter than the prompt raises."""
    size = cache["k"].shape[1]
    rep = cache["k"].shape[2] // k.shape[2]
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    if seq_len <= size:
        cache["k"][:, :seq_len] = k
        cache["v"][:, :seq_len] = v
        cache["slot_pos"][:seq_len] = torch.arange(seq_len, dtype=torch.int32,
                                                   device=k.device)
        return cache
    if not cfg.sliding_window:
        raise ValueError(f"a prompt of {seq_len} positions does not fit the cache of {size}")
    # Windowed: keep the last `size` positions, ring-aligned.
    start = seq_len - size
    pos = torch.arange(start, seq_len, device=k.device)
    slots = pos % size
    cache["k"][:, slots] = k[:, start:]
    cache["v"][:, slots] = v[:, start:]
    cache["slot_pos"][slots] = pos.to(torch.int32)
    return cache


def decode_attention(params: Attention, x, cfg, cache, pos: int | torch.Tensor):
    """One-token decode. x: (B, 1, d); pos: the absolute position, an int
    or a 0-d integer tensor on ``x``'s device (one program for every
    position: :class:`~repro_torch.models.decode_graph.DecodeGraph`).

    Writes the token's K (RoPE applied) and V into ``cache`` in place and
    returns ``(y, cache)``. An int past the end of a full cache raises
    here; a tensor is never read on the host, so its caller checks it.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = _split_heads(dense(params.q, x), H, hd)
    k = _split_heads(dense(params.k, x), KV, hd)
    v = _split_heads(dense(params.v, x), KV, hd)
    on_device = isinstance(pos, torch.Tensor)
    if on_device:
        posv = pos.reshape(1).to(torch.int32)
    else:
        posv = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    # The cache's layout (compact, or repeated: ``REPEAT_KV_IN_CACHE`` when
    # it was made) decides how the new row is written and read.
    heads = cache["k"].shape[2]
    k, v = _repeat_kv(k, heads // KV), _repeat_kv(v, heads // KV)

    size = cache["k"].shape[1]
    if on_device:  # the slot on the device: a (1,) long index
        slot = (pos % size if cfg.sliding_window else pos).reshape(1).long()
    elif cfg.sliding_window:
        slot = pos % size
    elif not 0 <= pos < size:
        raise ValueError(f"pos={pos} is outside the cache of {size} positions")
    else:
        slot = pos
    set_position(cache["k"], slot, k[:, 0])  # on a mesh: the rank holding the slot
    set_position(cache["v"], slot, v[:, 0])
    set_position(cache["slot_pos"], slot, posv[0], dim=0)

    kr = _repeat_kv(cache["k"], H // heads)
    vr = _repeat_kv(cache["v"], H // heads)
    scores = _softcap(_scores(q, kr, hd), cfg.logit_softcap)
    slot_pos = cache["slot_pos"]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    scores = scores + torch.where(valid, 0.0, NEG_INF).to(torch.float32)[None, None, None, :]
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    y = einsum("bhqk,bkhd->bqhd", w, vr).reshape(B, 1, H * hd)
    return dense(params.o, y), cache


def decode_cross_attention(params: Attention, x, cfg, mem_k, mem_v):
    """Cross-attention of one decode token against a fixed encoder memory:
    x (B, 1, d); ``mem_k``/``mem_v`` (B, S_enc, KV, hd), no RoPE."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = _split_heads(dense(params.q, x), H, hd)
    kr = _repeat_kv(mem_k, H // KV)
    vr = _repeat_kv(mem_v, H // KV)
    w = torch.softmax(_scores(q, kr, hd), dim=-1).to(x.dtype)
    y = einsum("bhqk,bkhd->bqhd", w, vr).reshape(B, 1, H * hd)
    return dense(params.o, y)

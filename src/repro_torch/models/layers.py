"""Shared building blocks: norms, projections, RoPE, SwiGLU, embeddings.

Port of ``repro/models/layers.py``. Parameters live in small
``nn.Module``s whose parameter names follow the reference's parameter
tree (``Dense.w`` is its ``{"w": (d_in, d_out)}``, ``RMSNorm.scale``,
``Embedding.table``), so a reference tree maps onto a module's
``state_dict`` name for name (:func:`repro_torch.convert.load_reference_params`).
The functions take such a module where the reference takes its dict.

Every module is built with an explicit device and dtype. Given a
``torch.Generator`` (on the same device) it draws its initial values as
the reference does (normal in float32, scaled, then cast); without one
its parameters are left uninitialised, to be loaded.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    """The model's parameter type, from ``cfg.dtype`` ("bfloat16", "float32")."""
    return getattr(torch, cfg.dtype)


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


@torch.no_grad()
def normal_(t: torch.Tensor, generator: torch.Generator, std: float) -> None:
    """Fill ``t`` with normal draws in float32 times ``std``, cast to its type."""
    t.copy_(torch.randn(t.shape, generator=generator, device=t.device, dtype=torch.float32) * std)


class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` (d_in, d_out), initialised N(0, 1/d_in)."""

    def __init__(self, d_in, d_out, bias=False, *, device, dtype, generator=None):
        super().__init__()
        self.w = _param((d_in, d_out), device, dtype)
        if bias:
            self.b = _param((d_out,), device, dtype)
        else:
            self.register_parameter("b", None)
        if generator is not None:
            normal_(self.w, generator, 1.0 / math.sqrt(d_in))
            if self.b is not None:
                with torch.no_grad():
                    self.b.zero_()


def dense(p: Dense, x):
    from repro_torch.models.sharding import matmul

    y = matmul(x, p.w)  # x @ p.w off a mesh
    if p.b is not None:
        y = y + p.b
    return y


class RMSNorm(nn.Module):
    def __init__(self, d, *, device, dtype, generator=None):
        super().__init__()
        self.scale = _param((d,), device, dtype)
        if generator is not None:
            with torch.no_grad():
                self.scale.fill_(1.0)


def rms_norm(p: RMSNorm, x, eps=1e-5):
    """RMS norm computed in float32 and cast back to ``x``'s type (on a
    mesh the scale whole, as the features are)."""
    from repro_torch.models.sharding import replicate_features

    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * replicate_features(p.scale).to(torch.float32)).to(x.dtype)


class SwiGLU(nn.Module):
    def __init__(self, d, f, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.gate = Dense(d, f, **kw)
        self.up = Dense(d, f, **kw)
        self.down = Dense(f, d, **kw)


def swiglu(p: SwiGLU, x):
    return dense(p.down, F.silu(dense(p.gate, x)) * dense(p.up, x))


def rope_frequencies(head_dim, theta, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (..., S, H, head_dim); positions: (S,) or (..., S) absolute ids."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Embedding(nn.Module):
    """A (vocab, d) table, initialised N(0, 0.02^2)."""

    def __init__(self, vocab, d, *, device, dtype, generator=None):
        super().__init__()
        self.table = _param((vocab, d), device, dtype)
        if generator is not None:
            normal_(self.table, generator, 0.02)


def embed(p: Embedding, tokens):
    """``table[tokens]``; on a serving mesh the vocab-parallel lookup
    (``sharding.embedding``), split on the batch over the activation axes
    with whole features (``sharding.constrain_batch``)."""
    from repro_torch.models.sharding import constrain_batch, embedding

    return constrain_batch(embedding(p.table, tokens))


def unembed(p: Embedding, x):
    """Logits against the (tied) table: ``x @ table.T`` (on a mesh, ``x``
    with whole features, ``sharding.replicate_features``; in a training
    round the table gathered over the mesh dims that split its features
    (FSDP) and ``x`` over those that split its vocab,
    ``sharding.replicate_where_split``: vocab-split logits, never partial
    sums; on a serving mesh the vocab-split table's product on the local
    batch, ``sharding.matmul``)."""
    from repro_torch.models import sharding

    x = sharding.replicate_features(x)
    if sharding._ACT_AXES is None:
        table = sharding.replicate_where_split(p.table, p.table, 1)
        return sharding.replicate_where_split(x, table, 0) @ table.T
    return sharding.matmul(x, p.table.T)


def _vocab_sharded(logits) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(logits, DTensor) and any(
        p.is_shard(logits.ndim - 1) and logits.device_mesh.size(i) > 1
        for i, p in enumerate(logits.placements))


def _vocab_parallel_nll(logits, labels):
    """-log softmax(logits)[label] of float32 logits split on the vocab over
    one mesh dim (Megatron's vocab-parallel cross entropy): the max and the
    sum of exponentials reduce over the split, and each rank picks the
    label's logit from its own slice of the vocab, the picks summed. The
    gradient stays split on the vocab (DTensor's own ``cross_entropy``
    gathers it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, places = logits.device_mesh, list(logits.placements)
    vdim = [i for i, p in enumerate(places) if p.is_shard(logits.ndim - 1)][0]
    m = logits.detach().amax(dim=-1, keepdim=True)
    m = m.redistribute(mesh, [Replicate() if i == vdim else p for i, p in enumerate(places)])
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    rows = [Replicate() if i == vdim else p for i, p in enumerate(places)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    labels = labels.redistribute(mesh, rows).to_local().long()
    local = logits.to_local()
    width = local.shape[-1]
    lab = labels - mesh.get_local_rank(vdim) * width
    inside = (lab >= 0) & (lab < width)
    pick = torch.gather(local, -1, torch.where(inside, lab, 0)[..., None])[..., 0]
    pick = torch.where(inside, pick, 0.0)
    picked = DTensor.from_local(pick, mesh, [Partial() if i == vdim else p for i, p in
                                             enumerate(rows)], run_check=False)
    return logz - picked.redistribute(mesh, rows)


def cross_entropy_loss(logits, labels, mask=None):
    """Mean next-token NLL in float32; logits (..., V), labels int (...).
    With ``mask``, the masked sum over ``max(sum(mask), 1)``. Logits that
    are a DTensor split on the vocab dim (a tensor-parallel lm head) take
    the vocab-parallel route instead, which never gathers the vocab
    (:func:`_vocab_parallel_nll`)."""
    logits = logits.to(torch.float32)
    if _vocab_sharded(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0] - logz
        nll = -ll
    if mask is None:
        return torch.mean(nll)
    mask = torch.as_tensor(mask, device=nll.device).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

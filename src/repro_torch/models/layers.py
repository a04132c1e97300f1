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
    y = x @ p.w
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
    """RMS norm computed in float32 and cast back to ``x``'s type."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.to(torch.float32)).to(x.dtype)


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
    return p.table[tokens]


def unembed(p: Embedding, x):
    """Logits against the (tied) table: ``x @ table.T``."""
    return x @ p.table.T

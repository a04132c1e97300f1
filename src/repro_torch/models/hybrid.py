"""Zamba2-style hybrid: Mamba2 backbone + a single *shared* attention block
applied every ``shared_attn_every`` layers (arXiv:2411.15242).

Port of ``repro/models/hybrid.py``: ``forward`` (prefill with
``last_only``, and training with ``remat``), ``loss_fn``, ``init_cache``
and ``decode_step``. The reference's ``lax.scan`` over the stacked layers
with a ``lax.cond`` on the shared block becomes a Python loop over
``HybridLM.layers``; the shared block has one copy of its weights, applied
after layers i with ``i % every == every - 1``, and each application site
keeps its own KV cache in decode.

Remat: the reference wraps the layer body (the Mamba2 block and, at a
site, the shared block) in ``jax.checkpoint``; here it goes through
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, so the
backward recomputes each layer's forward (and launches ``ssm_chunk`` a
second time on the card) from its saved input.

The agents of the P2P layer hold the reference's tree, nested dicts of
tensors with the ``layers`` axis stacked (:func:`param_tree`);
:func:`bind` lays a ``HybridLM`` over one agent's tree without a copy.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm
from repro_torch.models.sharding import constrain_batch, replicate_features
from repro_torch.models.layers import (
    Embedding,
    RMSNorm,
    SwiGLU,
    cross_entropy_loss,
    dtype_of,
    embed,
    rms_norm,
    swiglu,
    unembed,
)
from repro_torch.utils.tree import bind_module, module_tree


class HybridLayer(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device=device, dtype=dtype, generator=generator)
        self.mamba = ssm.Mamba2(cfg, device=device, dtype=dtype, generator=generator)


class SharedAttention(nn.Module):
    """The one attention + SwiGLU block, shared by every application site."""

    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln1 = RMSNorm(cfg.d_model, **kw)
        self.attn = attn_mod.Attention(cfg, **kw)
        self.ln2 = RMSNorm(cfg.d_model, **kw)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, **kw)


class HybridLM(nn.Module):
    """The parameters of the reference's ``init_params`` tree, with its
    names (``embed.table``, ``layers.<i>.mamba.in_proj.w``, ...): the
    stacked leading layer axis of the reference is ``layers``, a
    ``ModuleList``. Without a ``generator`` the parameters are left
    uninitialised, to be loaded (:mod:`repro_torch.convert`). On
    ``device="meta"`` it holds no storage: :func:`bind` fills it."""

    def __init__(self, cfg, *, device="cuda", generator=None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        kw = dict(device=dev, dtype=dtype_of(cfg), generator=generator)
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.layers = nn.ModuleList(HybridLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.shared_attn = SharedAttention(cfg, **kw)
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(cfg.padded_vocab, cfg.d_model, **kw)


def init_params(cfg, seed: int = 0, device="cuda") -> HybridLM:
    """A randomly initialised model on ``device``, drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return HybridLM(cfg, device=dev, generator=gen)


def attn_sites(cfg) -> list[int]:
    """The layers after which the shared block runs."""
    every = cfg.shared_attn_every or (cfg.num_layers + 1)
    return [i for i in range(cfg.num_layers) if i % every == every - 1]


def _head(params: HybridLM):
    return params.embed if params.cfg.tie_embeddings else params.lm_head


def _shared_block(cfg, shared: SharedAttention, x, positions, window):
    x = replicate_features(x)  # on a mesh: heads split by column-parallel q, k, v
    h, _ = attn_mod.attention(shared.attn, rms_norm(shared.ln1, x, cfg.norm_eps), cfg,
                              positions=positions, window=window)
    x = x + h
    return x + swiglu(shared.ffn, rms_norm(shared.ln2, x, cfg.norm_eps))


def forward(params: HybridLM, tokens, cfg, remat=True, window=None, last_only=False,
            use_kernel=None):
    """tokens (B, S) -> (logits (B, S or 1, vocab), aux 0.0).

    ``remat``: with autograd recording, each layer's body runs under
    ``torch.utils.checkpoint`` (no effect without a gradient: nothing is
    saved then). ``use_kernel`` goes to every Mamba2 block (None: the
    ``ssm_chunk`` kernel on the card, the plain einsums on the CPU). Each
    block runs in a profiler range, "mamba2" or "shared_attn", so a trace
    can split the device time between them (a range costs a few
    microseconds when no profiler runs)."""
    x = constrain_batch(embed(params.embed, tokens))
    positions = torch.arange(tokens.shape[1], device=x.device)
    window = window if window is not None else cfg.sliding_window
    sites = set(attn_sites(cfg))
    shared = params.shared_attn

    def body(x, layer, site):
        with record_function("mamba2"):
            x = x + ssm.mamba2_forward(layer.mamba, rms_norm(layer.ln, x, cfg.norm_eps), cfg,
                                       use_kernel=use_kernel)
        if site:
            with record_function("shared_attn"):
                x = _shared_block(cfg, shared, x, positions, window)
        return x

    remat = remat and torch.is_grad_enabled()
    for i, layer in enumerate(params.layers):
        if remat:
            # The body draws nothing at random: no RNG state to keep.
            x = checkpoint(body, x, layer, i in sites, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(x, layer, i in sites)
        x = constrain_batch(x)
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = unembed(_head(params), x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: HybridLM, batch, cfg, remat=True, use_kernel=None):
    """Mean next-token loss of ``batch["tokens"]`` (B, S + 1): the logits
    of ``tokens[:, :-1]`` against ``tokens[:, 1:]``, plus the aux term."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens[:, :-1], cfg, remat=remat, use_kernel=use_kernel)
    return cross_entropy_loss(logits, tokens[:, 1:]) + aux


def param_tree(params: HybridLM) -> dict:
    """The reference's ``init_params`` tree of a model: nested dicts of
    tensors by the reference's names, each ``layers`` leaf the stack of the
    layers' tensors (a copy)."""
    return module_tree(params)


def bind(cfg, tree) -> HybridLM:
    """A ``HybridLM`` whose parameters are views of one agent's reference
    tree (``layers`` stacked): leaf ``layers.mamba.in_proj.w[i]`` becomes
    ``layers.<i>.mamba.in_proj.w``, sharing storage, so the module computes
    with the tree's values and autograd gives each view its own gradient."""
    return bind_module(HybridLM(cfg, device="meta"), tree)


def init_cache(params: HybridLM, cfg, batch, max_len):
    """``{"mamba": [one cache per layer], "attn": [one KV cache per site]}``."""
    dtype, dev = params.embed.table.dtype, params.embed.table.device
    return {
        "mamba": [ssm.init_mamba2_cache(cfg, batch, dtype, dev) for _ in range(cfg.num_layers)],
        "attn": [attn_mod.init_cache(cfg, batch, max_len, dtype, dev)
                 for _ in range(max(len(attn_sites(cfg)), 1))],
    }


def decode_step(params: HybridLM, token, cfg, caches, pos: int):
    """token (B, 1) at absolute position ``pos`` -> (logits (B, 1, vocab),
    caches). The Mamba2 states are new tensors; the KV caches are written
    in place."""
    x = embed(params.embed, token)
    sites = attn_sites(cfg)
    shared = params.shared_attn
    new_mamba = []
    for i, layer in enumerate(params.layers):
        h, m = ssm.mamba2_decode(layer.mamba, rms_norm(layer.ln, x, cfg.norm_eps), cfg,
                                 caches["mamba"][i])
        x = x + h
        new_mamba.append(m)
        if i in sites:
            cache = caches["attn"][sites.index(i)]
            h, _ = attn_mod.decode_attention(shared.attn, rms_norm(shared.ln1, x, cfg.norm_eps),
                                             cfg, cache, pos)
            x = x + h
            x = x + swiglu(shared.ffn, rms_norm(shared.ln2, x, cfg.norm_eps))
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    return unembed(_head(params), x), {"mamba": new_mamba, "attn": caches["attn"]}

"""Decoder-only transformer: dense GQA, MoE and early-fusion VLM.

Port of ``repro/models/transformer.py``. A block is ``ln1``, ``attn``,
``ln2`` and ``ffn`` (``SwiGLU``, or ``MoE`` when ``cfg.moe`` is set, its
load-balance loss summed over the layers into ``aux``); the embeddings
are tied unless the config unties them (``lm_head``). The VLM family needs
nothing of its own: its image tokens are a reserved slice of the vocab
(``cfg.image_vocab_offset``, which no model code reads, here or in the
reference).

The reference's ``lax.scan`` over stacked layers is a Python loop over
``TransformerLM.layers``; ``jax.checkpoint`` of the layer body is
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``. Each layer's
attention and FFN run in the profiler ranges "attention" and "ffn", so a
trace can split the device time between them. The caches are a list, one
KV cache a layer, written in place (``src/repro_torch/DEVIATIONS.md``).
The reference's ``constrain_seq``/``constrain_batch`` sit where the
reference has them (``models/sharding.py``): the identity without an
ambient mesh, a DTensor redistribution with one.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
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
from repro_torch.models.sharding import constrain_batch, constrain_seq
from repro_torch.utils.tree import bind_module, module_tree


class Block(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln1 = RMSNorm(cfg.d_model, **kw)
        self.attn = attn_mod.Attention(cfg, **kw)
        self.ln2 = RMSNorm(cfg.d_model, **kw)
        self.ffn = moe_mod.MoE(cfg, **kw) if cfg.moe is not None else SwiGLU(
            cfg.d_model, cfg.d_ff, **kw)


class TransformerLM(nn.Module):
    """The parameters of the reference's ``init_params`` tree, with its
    names (``embed.table``, ``layers.<i>.attn.q.w``, ``layers.<i>.ffn.gate``
    ...): the stacked layer axis is ``layers``, a ``ModuleList``. Without a
    ``generator`` the parameters are left uninitialised, to be loaded; on
    ``device="meta"`` it holds no storage (:func:`bind` fills it)."""

    def __init__(self, cfg, *, device="cuda", generator=None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        kw = dict(device=dev, dtype=dtype_of(cfg), generator=generator)
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Block(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(cfg.padded_vocab, cfg.d_model, **kw)


def init_params(cfg, seed: int = 0, device="cuda") -> TransformerLM:
    """A randomly initialised model on ``device``, drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return TransformerLM(cfg, device=dev, generator=gen)


def head(params):
    """The unembedding table: ``lm_head`` if untied, else ``embed``."""
    return params.embed if params.cfg.tie_embeddings else params.lm_head


def ffn(cfg, layer, h):
    """The block's FFN on its normed input: (y, aux), aux 0 for SwiGLU."""
    if cfg.moe is not None:
        return moe_mod.moe_ffn(layer.ffn, h, cfg)
    return swiglu(layer.ffn, h), torch.zeros((), dtype=torch.float32, device=h.device)


def _block(cfg, layer: Block, x, positions, window):
    x = constrain_seq(x)  # seq-parallel residual (no-op unless enabled)
    with record_function("attention"):
        h, _ = attn_mod.attention(layer.attn, rms_norm(layer.ln1, x, cfg.norm_eps), cfg,
                                  positions=positions, window=window)
        x = constrain_seq(x + h)
    with record_function("ffn"):
        f, aux = ffn(cfg, layer, rms_norm(layer.ln2, x, cfg.norm_eps))
    return x + f, aux


def forward(params: TransformerLM, tokens, cfg, remat=True, window=None):
    """tokens (B, S) -> (logits (B, S, vocab), aux: the summed MoE loss).

    ``remat``: with autograd recording, each layer's body runs under
    ``torch.utils.checkpoint`` (no effect without a gradient)."""
    x = embed(params.embed, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)
    window = window if window is not None else cfg.sliding_window
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for layer in params.layers:
        if remat:
            # The body draws nothing at random: no RNG state to keep.
            x, a = checkpoint(_block, cfg, layer, x, positions, window, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _block(cfg, layer, x, positions, window)
        aux = aux + a
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    return unembed(head(params), x), aux


def loss_fn(params: TransformerLM, batch, cfg, remat=True):
    """Next-token loss of ``batch["tokens"]`` (B, S + 1) plus the MoE aux."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens[:, :-1], cfg, remat=remat)
    return cross_entropy_loss(logits, tokens[:, 1:]) + aux


def init_cache(params: TransformerLM, cfg, batch, max_len):
    """One KV cache a layer (``attention.init_cache``), in a list."""
    dtype, dev = params.embed.table.dtype, params.embed.table.device
    return [attn_mod.init_cache(cfg, batch, max_len, dtype, dev) for _ in range(cfg.num_layers)]


def prefill(params: TransformerLM, tokens, cfg, max_len=None):
    """Run the prompt (B, S), write every layer's keys and values into a new
    cache of ``max_len`` positions (S by default, as in the reference:
    then a decode at position S raises), and return the last token's
    logits (B, 1, vocab) and the caches."""
    B, S = tokens.shape
    caches = init_cache(params, cfg, B, max_len if max_len is not None else S)
    x = constrain_batch(embed(params.embed, tokens))
    positions = torch.arange(S, device=x.device)
    for layer, cache in zip(params.layers, caches):
        x = constrain_batch(x)
        with record_function("attention"):
            h, (k, v) = attn_mod.attention(layer.attn, rms_norm(layer.ln1, x, cfg.norm_eps), cfg,
                                           positions=positions, window=cfg.sliding_window)
            attn_mod.prefill_into_cache(cfg, cache, k, v, S)
            x = x + h
        with record_function("ffn"):
            f, _ = ffn(cfg, layer, rms_norm(layer.ln2, x, cfg.norm_eps))
        x = x + f
    x = rms_norm(params.final_norm, x[:, -1:], cfg.norm_eps)
    return unembed(head(params), x), caches


def decode_step(params: TransformerLM, token, cfg, caches, pos: int | torch.Tensor):
    """token (B, 1) at absolute position ``pos`` -> (logits (B, 1, vocab),
    caches), each layer's cache written in place."""
    x = embed(params.embed, token)
    for layer, cache in zip(params.layers, caches):
        h, _ = attn_mod.decode_attention(layer.attn, rms_norm(layer.ln1, x, cfg.norm_eps), cfg,
                                         cache, pos)
        x = x + h
        f, _ = ffn(cfg, layer, rms_norm(layer.ln2, x, cfg.norm_eps))
        x = x + f
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    return unembed(head(params), x), caches


def param_tree(params: TransformerLM) -> dict:
    """The reference's ``init_params`` tree of a model (``layers`` stacked; a copy)."""
    return module_tree(params)


def bind(cfg, tree) -> TransformerLM:
    """A ``TransformerLM`` whose parameters are views of one agent's
    reference tree (``layers`` stacked), sharing its storage."""
    return bind_module(TransformerLM(cfg, device="meta"), tree)

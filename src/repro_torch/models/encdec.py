"""Encoder-decoder transformer (seamless-m4t style speech-to-text backbone).

Port of ``repro/models/encdec.py``. The modality frontend is the
reference's documented stub: the encoder consumes precomputed frame
embeddings (B, S_enc, d_model), ``enc_len(S)`` = S // ``ENC_DOWNSAMPLE``
of them for S decoder tokens. A bidirectional encoder (``causal=False``)
and a causal decoder whose every block adds cross-attention to the
encoder's output.

As in :mod:`repro_torch.models.transformer`: a Python loop over the
``encoder`` and ``decoder`` ``ModuleList``s where the reference scans its
stacked layers, ``torch.utils.checkpoint`` for remat, one cache a decoder
layer in a list (``{"self": KV cache, "mem_k", "mem_v"}``, the memory's
cross-attention keys and values written once by the prefill), and the
profiler ranges "attention" (self- and cross-attention) and "ffn".
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
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
from repro_torch.models.sharding import constrain_batch
from repro_torch.models.transformer import head
from repro_torch.utils.tree import bind_module, module_tree

ENC_DOWNSAMPLE = 4  # stubbed conv frontend downsampling factor (frames -> d)
STACKED = ("encoder", "decoder")  # the reference tree's stacked layer axes


def enc_len(seq_len: int) -> int:
    return max(seq_len // ENC_DOWNSAMPLE, 1)


class EncBlock(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln1 = RMSNorm(cfg.d_model, **kw)
        self.attn = attn_mod.Attention(cfg, **kw)
        self.ln2 = RMSNorm(cfg.d_model, **kw)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, **kw)


class DecBlock(nn.Module):
    def __init__(self, cfg, *, device, dtype, generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        self.ln1 = RMSNorm(cfg.d_model, **kw)
        self.self_attn = attn_mod.Attention(cfg, **kw)
        self.ln_x = RMSNorm(cfg.d_model, **kw)
        self.cross_attn = attn_mod.Attention(cfg, **kw)
        self.ln2 = RMSNorm(cfg.d_model, **kw)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, **kw)


class EncDecLM(nn.Module):
    """The reference's ``init_params`` tree as modules: ``embed``,
    ``encoder`` and ``decoder`` (its stacked axes, ``ModuleList``s),
    ``enc_norm``, ``final_norm`` and, untied, ``lm_head``."""

    def __init__(self, cfg, *, device="cuda", generator=None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        kw = dict(device=dev, dtype=dtype_of(cfg), generator=generator)
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.encoder = nn.ModuleList(EncBlock(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.enc_norm = RMSNorm(cfg.d_model, **kw)
        self.decoder = nn.ModuleList(DecBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(cfg.padded_vocab, cfg.d_model, **kw)


def init_params(cfg, seed: int = 0, device="cuda") -> EncDecLM:
    """A randomly initialised model on ``device``, from a seeded generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return EncDecLM(cfg, device=dev, generator=gen)


def _run(body, layers, x, *args, remat):
    remat = remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            x = checkpoint(body, layer, x, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x = body(layer, x, *args)
    return x


def encode(params: EncDecLM, embeds, cfg, remat=True):
    """embeds (B, S_enc, d) from the stubbed frontend -> the memory (B, S_enc, d)."""
    x = constrain_batch(embeds.to(dtype_of(cfg)))
    positions = torch.arange(x.shape[1], device=x.device)

    def body(layer, x):
        with record_function("attention"):
            h, _ = attn_mod.attention(layer.attn, rms_norm(layer.ln1, x, cfg.norm_eps), cfg,
                                      positions=positions, causal=False)
            x = x + h
        with record_function("ffn"):
            return x + swiglu(layer.ffn, rms_norm(layer.ln2, x, cfg.norm_eps))

    x = _run(body, params.encoder, x, remat=remat)
    return rms_norm(params.enc_norm, x, cfg.norm_eps)


def _dec_block(cfg, layer: DecBlock, x, memory, positions, window):
    with record_function("attention"):
        h, _ = attn_mod.attention(layer.self_attn, rms_norm(layer.ln1, x, cfg.norm_eps), cfg,
                                  positions=positions, window=window)
        x = x + h
        h, _ = attn_mod.attention(layer.cross_attn, rms_norm(layer.ln_x, x, cfg.norm_eps), cfg,
                                  kv_memory=memory)
        x = x + h
    with record_function("ffn"):
        return x + swiglu(layer.ffn, rms_norm(layer.ln2, x, cfg.norm_eps))


def forward(params: EncDecLM, embeds, tokens, cfg, remat=True):
    """(embeds (B, S_enc, d), tokens (B, S)) -> (logits (B, S, vocab), aux 0.0)."""
    memory = encode(params, embeds, cfg, remat=remat)
    x = embed(params.embed, tokens)
    positions = torch.arange(tokens.shape[1], device=x.device)

    def body(layer, x):
        return _dec_block(cfg, layer, x, memory, positions, cfg.sliding_window)

    x = _run(body, params.decoder, x, remat=remat)
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    return unembed(head(params), x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: EncDecLM, batch, cfg, remat=True):
    """Next-token loss of ``batch["tokens"]`` (B, S + 1) given ``batch["embeds"]``."""
    logits, aux = forward(params, batch["embeds"], batch["tokens"][:, :-1], cfg, remat=remat)
    return cross_entropy_loss(logits, batch["tokens"][:, 1:]) + aux


def init_cache(params: EncDecLM, cfg, batch, max_len, enc_seq=None):
    """One cache a decoder layer: the self-attention cache (ring or full)
    and zero cross-attention memory keys and values of ``enc_seq``
    (default ``enc_len(max_len)``) positions."""
    dtype, dev = params.embed.table.dtype, params.embed.table.device
    enc_seq = enc_seq if enc_seq is not None else enc_len(max_len)
    shape = (batch, enc_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [{"self": attn_mod.init_cache(cfg, batch, max_len, dtype, dev),
             "mem_k": torch.zeros(shape, dtype=dtype, device=dev),
             "mem_v": torch.zeros(shape, dtype=dtype, device=dev)}
            for _ in range(cfg.num_layers)]


def prefill(params: EncDecLM, embeds, tokens, cfg, max_len=None):
    """Encode, run the decoder prompt (B, S), build each decoder layer's
    self-attention cache (``max_len`` positions, S by default) and its
    cross-attention keys and values; return the last token's logits and
    the caches."""
    memory = encode(params, embeds, cfg, remat=False)
    B, S = tokens.shape
    max_len = max_len if max_len is not None else S
    dtype, dev = params.embed.table.dtype, params.embed.table.device
    x = constrain_batch(embed(params.embed, tokens))
    positions = torch.arange(S, device=x.device)
    caches = []
    for layer in params.decoder:
        x = constrain_batch(x)
        with record_function("attention"):
            h, (k, v) = attn_mod.attention(layer.self_attn, rms_norm(layer.ln1, x, cfg.norm_eps),
                                           cfg, positions=positions, window=cfg.sliding_window)
            self_cache = attn_mod.prefill_into_cache(
                cfg, attn_mod.init_cache(cfg, B, max_len, dtype, dev), k, v, S)
            x = x + h
            h, (mk, mv) = attn_mod.attention(layer.cross_attn,
                                             rms_norm(layer.ln_x, x, cfg.norm_eps), cfg,
                                             kv_memory=memory)
            x = x + h
        with record_function("ffn"):
            x = x + swiglu(layer.ffn, rms_norm(layer.ln2, x, cfg.norm_eps))
        caches.append({"self": self_cache, "mem_k": mk, "mem_v": mv})
    x = rms_norm(params.final_norm, x[:, -1:], cfg.norm_eps)
    return unembed(head(params), x), caches


def decode_step(params: EncDecLM, token, cfg, caches, pos: int | torch.Tensor):
    """token (B, 1) at ``pos`` -> (logits (B, 1, vocab), caches); the
    self-attention caches are written in place."""
    x = embed(params.embed, token)
    for layer, cache in zip(params.decoder, caches):
        h, _ = attn_mod.decode_attention(layer.self_attn, rms_norm(layer.ln1, x, cfg.norm_eps),
                                         cfg, cache["self"], pos)
        x = x + h
        x = x + attn_mod.decode_cross_attention(
            layer.cross_attn, rms_norm(layer.ln_x, x, cfg.norm_eps), cfg, cache["mem_k"],
            cache["mem_v"])
        x = x + swiglu(layer.ffn, rms_norm(layer.ln2, x, cfg.norm_eps))
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    return unembed(head(params), x), caches


def param_tree(params: EncDecLM) -> dict:
    """The reference's ``init_params`` tree (``encoder``, ``decoder`` stacked; a copy)."""
    return module_tree(params, STACKED)


def bind(cfg, tree) -> EncDecLM:
    """An ``EncDecLM`` whose parameters are views of one agent's tree."""
    return bind_module(EncDecLM(cfg, device="meta"), tree, STACKED)

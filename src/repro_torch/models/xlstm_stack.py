"""Full xLSTM language model: mLSTM backbone with periodic sLSTM blocks
(xLSTM[a:b] pattern).

Port of ``repro/models/xlstm_stack.py``. The reference stacks each block
type's parameters (``mlstm``, ``slstm`` and their norms ``ln_m``, ``ln_s``)
and gathers them by index inside a ``lax.scan`` over the layers, with a
``lax.cond`` choosing the block; here each stacked tree is a
``ModuleList`` and the layers are a Python loop that calls the block of
the layer's type. Layer i is an sLSTM block iff ``i % slstm_every ==
slstm_every - 1``; as in the reference each tree holds at least one block.

Remat: each block's body (its norm and block) runs under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` when autograd
records, the reference's ``jax.checkpoint`` of the layer body. Each block
body runs in a profiler range, "mlstm" or "slstm" (the remat recompute
too). The decode caches are lists, one recurrent state a block of each
type. The reference's ``constrain_batch`` calls stand where it has them
(``models/sharding.py``: the identity without an ambient mesh).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import xlstm
from repro_torch.models.sharding import constrain_batch
from repro_torch.models.layers import (
    Embedding,
    RMSNorm,
    cross_entropy_loss,
    dtype_of,
    embed,
    rms_norm,
    unembed,
)
from repro_torch.models.transformer import head
from repro_torch.utils.tree import bind_module, module_tree

STACKED = ("ln_m", "ln_s", "mlstm", "slstm")  # the reference tree's stacked axes


def _layer_types(cfg) -> list[bool]:
    """Per layer: True for an sLSTM block, False for an mLSTM block."""
    every = cfg.xlstm.slstm_every
    return [i % every == every - 1 for i in range(cfg.num_layers)]


def _blocks(cfg) -> list[tuple[bool, int]]:
    """Per layer: (is sLSTM, the index of its block in its type's stack)."""
    out, counts = [], [0, 0]
    for flag in _layer_types(cfg):
        out.append((flag, counts[flag]))
        counts[flag] += 1
    return out


class XLSTMLM(nn.Module):
    """The parameters of the reference's ``init_params`` tree, with its
    names: ``embed``, the stacked ``mlstm``/``ln_m`` (one a mLSTM layer) and
    ``slstm``/``ln_s`` (one a sLSTM layer), each a ``ModuleList`` of at
    least one, ``final_norm`` and, untied, ``lm_head``. Without a
    ``generator`` the parameters are left uninitialised, to be loaded; on
    ``device="meta"`` it holds no storage (:func:`bind` fills it)."""

    def __init__(self, cfg, *, device="cuda", generator=None):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        kw = dict(device=dev, dtype=dtype_of(cfg), generator=generator)
        self.cfg = cfg
        is_s = _layer_types(cfg)
        n_s = max(sum(is_s), 1)
        n_m = max(len(is_s) - sum(is_s), 1)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.mlstm = nn.ModuleList(xlstm.MLSTM(cfg, **kw) for _ in range(n_m))
        self.slstm = nn.ModuleList(xlstm.SLSTM(cfg, **kw) for _ in range(n_s))
        self.ln_m = nn.ModuleList(RMSNorm(cfg.d_model, **kw) for _ in range(n_m))
        self.ln_s = nn.ModuleList(RMSNorm(cfg.d_model, **kw) for _ in range(n_s))
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        if not cfg.tie_embeddings:
            self.lm_head = Embedding(cfg.padded_vocab, cfg.d_model, **kw)


def init_params(cfg, seed: int = 0, device="cuda") -> XLSTMLM:
    """A randomly initialised model on ``device``, drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return XLSTMLM(cfg, device=dev, generator=gen)


def _mlstm_body(cfg, ln, block, x):
    with record_function("mlstm"):
        return x + xlstm.mlstm_forward(block, rms_norm(ln, x, cfg.norm_eps), cfg)


def _slstm_body(cfg, ln, block, x):
    with record_function("slstm"):
        return x + xlstm.slstm_forward(block, rms_norm(ln, x, cfg.norm_eps), cfg)


def forward(params: XLSTMLM, tokens, cfg, remat=True, last_only=False):
    """tokens (B, S) -> (logits (B, S or 1, vocab), aux 0.0).

    ``remat``: with autograd recording, each block's body runs under
    ``torch.utils.checkpoint`` (no effect without a gradient)."""
    x = constrain_batch(embed(params.embed, tokens))
    remat = remat and torch.is_grad_enabled()
    for is_s, j in _blocks(cfg):
        if is_s:
            body, ln, block = _slstm_body, params.ln_s[j], params.slstm[j]
        else:
            body, ln, block = _mlstm_body, params.ln_m[j], params.mlstm[j]
        if remat:
            # The body draws nothing at random: no RNG state to keep.
            x = checkpoint(body, cfg, ln, block, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = body(cfg, ln, block, x)
        x = constrain_batch(x)
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    logits = unembed(head(params), x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: XLSTMLM, batch, cfg, remat=True):
    """Mean next-token loss of ``batch["tokens"]`` (B, S + 1)."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens[:, :-1], cfg, remat=remat)
    return cross_entropy_loss(logits, tokens[:, 1:]) + aux


def init_cache(params: XLSTMLM, cfg, batch, max_len):
    """``{"mlstm": [one state a mLSTM block], "slstm": [one a sLSTM block]}``;
    ``max_len`` is unused (the states are O(1))."""
    dev = params.embed.table.device
    return {"mlstm": [xlstm.init_mlstm_cache(cfg, batch, dev) for _ in params.mlstm],
            "slstm": [xlstm.init_slstm_cache(cfg, batch, dev) for _ in params.slstm]}


def decode_step(params: XLSTMLM, token, cfg, caches, pos: int | torch.Tensor):
    """token (B, 1) -> (logits (B, 1, vocab), caches): new states, the
    inputs left as they were. ``pos`` is unused, as in the reference."""
    x = embed(params.embed, token)
    new = {"mlstm": list(caches["mlstm"]), "slstm": list(caches["slstm"])}
    for is_s, j in _blocks(cfg):
        if is_s:
            h, new["slstm"][j] = xlstm.slstm_decode(
                params.slstm[j], rms_norm(params.ln_s[j], x, cfg.norm_eps), cfg,
                caches["slstm"][j])
        else:
            h, new["mlstm"][j] = xlstm.mlstm_decode(
                params.mlstm[j], rms_norm(params.ln_m[j], x, cfg.norm_eps), cfg,
                caches["mlstm"][j])
        x = x + h
    x = rms_norm(params.final_norm, x, cfg.norm_eps)
    return unembed(head(params), x), new


def param_tree(params: XLSTMLM) -> dict:
    """The reference's ``init_params`` tree of a model (the four block
    trees stacked; a copy)."""
    return module_tree(params, STACKED)


def bind(cfg, tree) -> XLSTMLM:
    """An ``XLSTMLM`` whose parameters are views of one agent's reference
    tree (the four block trees stacked), sharing its storage."""
    return bind_module(XLSTMLM(cfg, device="meta"), tree, STACKED)

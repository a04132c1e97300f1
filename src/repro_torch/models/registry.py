"""Uniform model API: ``build_model(cfg)`` -> :class:`ModelBundle`.

Port of ``repro/models/registry.py``: ``init`` / ``loss`` (train) /
``prefill`` / ``decode`` / ``init_cache`` over every family, as the
reference sends them: the enc-dec transformer (``audio``,
:mod:`~repro_torch.models.encdec`), the zamba2 hybrid
(:mod:`~repro_torch.models.hybrid`), the recurrent xLSTM (``ssm``,
:mod:`~repro_torch.models.xlstm_stack`) and the decoder-only transformer
(``dense``, ``moe``, ``vlm``: :mod:`~repro_torch.models.transformer`).

The bundle is bound to one device, the CUDA card unless the caller passes
``device="cpu"``, and takes token ids (and the enc-dec frame embeddings)
as tensors or numpy arrays. ``prefill``, ``decode`` and ``init_cache`` run
under ``torch.inference_mode()``; ``loss`` runs outside it, so autograd
can record it (a tensor made in inference mode can never enter a graph).
The recurrent families' ``prefill`` (hybrid, xLSTM) is the forward pass's
last-token logits, as in the reference: serving continues through
``decode`` from ``init_cache``. As in the reference, a transformer's
``prefill`` builds a cache of exactly the prompt's S positions;
``prefill(params, batch, max_len=)`` sizes it for the decode steps to
come (the port raises at a position past the cache, where the reference
overwrites its last slot: ``DEVIATIONS.md``).

Beyond the reference's fields, for the P2P layer's stacked agents
(:mod:`repro_torch.core.spmd`): ``bind`` lays the family's model over one
agent's parameter tree without a copy, ``stacked`` names the tree's
stacked layer axes, and :meth:`ModelBundle.init_agents` draws A agents'
trees stacked on a leading axis, the reference's ``jax.vmap(bundle.init)``
layout.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, transformer, xlstm_stack
from repro_torch.utils.tree import module_tree, module_views, tree_map


@dataclasses.dataclass(frozen=True, eq=False)
class ModelBundle:
    cfg: ModelConfig
    init: Callable  # (seed) -> params (an nn.Module on ``device``)
    loss: Callable  # (params, batch) -> scalar
    prefill: Callable  # (params, batch) -> (last-token logits, caches; hybrid: aux)
    decode: Callable  # (params, token, caches, pos: int or 0-d tensor) -> (logits, caches)
    init_cache: Callable  # (params, batch_size, max_len) -> caches
    bind: Callable  # (one agent's parameter tree) -> params over its storage
    device: torch.device
    stacked: tuple = ("layers",)  # the parameter tree's stacked layer axes

    def train_inputs(self, batch, seq):
        """Concrete-shape template for the training batch (used by tests)."""
        out = {"tokens": torch.zeros((batch, seq), dtype=torch.int32, device=self.device)}
        if self.cfg.is_encdec:
            out["embeds"] = torch.zeros((batch, encdec.enc_len(seq), self.cfg.d_model),
                                        dtype=torch.float32, device=self.device)
        return out

    def init_agents(self, n_agents: int, seed: int = 0) -> dict:
        """``n_agents`` models drawn from seeds spawned off ``seed``, as one
        tree whose every leaf is stacked on a leading agent axis (the
        ``layers`` axis under it). One agent's model is held at a time."""
        seeds = np.random.SeedSequence(seed).generate_state(n_agents)
        shapes = module_tree(model_class(self.cfg)(self.cfg, device="meta"), self.stacked)
        stacked = tree_map(lambda x: torch.empty((n_agents, *x.shape), dtype=x.dtype,
                                                 device=self.device), shapes)
        for a, s in enumerate(seeds):
            own = dict(self.init(int(s)).named_parameters())
            with torch.no_grad():
                for name, dst in module_views(tree_map(lambda x: x[a], stacked), self.stacked):
                    dst.copy_(own[name])
            del own
        return stacked


def model_class(cfg: ModelConfig):
    """The ``nn.Module`` class of ``cfg``'s family (its parameter tree)."""
    if cfg.is_encdec:
        return encdec.EncDecLM
    if cfg.family == "hybrid":
        return hybrid.HybridLM
    if cfg.family == "ssm":
        return xlstm_stack.XLSTMLM
    return transformer.TransformerLM  # dense / moe / vlm


def build_model(cfg: ModelConfig, remat: bool = True, device="cuda") -> ModelBundle:
    dev = resolve_device(device)

    def on_device(batch, key="tokens"):
        t = torch.as_tensor(batch[key], device=dev)
        return t.long() if key == "tokens" else t

    if cfg.is_encdec:
        def loss(params, batch):
            return encdec.loss_fn(params, {"tokens": on_device(batch),
                                           "embeds": on_device(batch, "embeds")}, cfg,
                                  remat=remat)

        @torch.inference_mode()
        def prefill(params, batch, max_len=None):
            return encdec.prefill(params, on_device(batch, "embeds"), on_device(batch), cfg,
                                  max_len=max_len)

        return ModelBundle(
            cfg=cfg, init=lambda seed=0: encdec.init_params(cfg, seed, dev), loss=loss,
            prefill=prefill, decode=_decode(encdec.decode_step, cfg, dev),
            init_cache=_init_cache(encdec.init_cache, cfg),
            bind=lambda tree: encdec.bind(cfg, tree), device=dev, stacked=encdec.STACKED)

    if cfg.family == "hybrid":
        def loss(params, batch):
            return hybrid.loss_fn(params, {"tokens": on_device(batch)}, cfg, remat=remat)

        @torch.inference_mode()
        def prefill(params, batch):
            # Recurrent-family prefill = the forward pass; last_only skips the
            # full-sequence lm head (serving continuity goes through decode).
            return hybrid.forward(params, on_device(batch), cfg, remat=False, last_only=True)

        return ModelBundle(
            cfg=cfg, init=lambda seed=0: hybrid.init_params(cfg, seed, dev), loss=loss,
            prefill=prefill, decode=_decode(hybrid.decode_step, cfg, dev),
            init_cache=_init_cache(hybrid.init_cache, cfg),
            bind=lambda tree: hybrid.bind(cfg, tree), device=dev)

    if cfg.family == "ssm":
        def loss(params, batch):
            return xlstm_stack.loss_fn(params, {"tokens": on_device(batch)}, cfg, remat=remat)

        @torch.inference_mode()
        def prefill(params, batch):
            return xlstm_stack.forward(params, on_device(batch), cfg, remat=False,
                                       last_only=True)

        return ModelBundle(
            cfg=cfg, init=lambda seed=0: xlstm_stack.init_params(cfg, seed, dev), loss=loss,
            prefill=prefill, decode=_decode(xlstm_stack.decode_step, cfg, dev),
            init_cache=_init_cache(xlstm_stack.init_cache, cfg),
            bind=lambda tree: xlstm_stack.bind(cfg, tree), device=dev,
            stacked=xlstm_stack.STACKED)

    # dense / moe / vlm are all decoder-only transformers.
    def loss(params, batch):
        return transformer.loss_fn(params, {"tokens": on_device(batch)}, cfg, remat=remat)

    @torch.inference_mode()
    def prefill(params, batch, max_len=None):
        return transformer.prefill(params, on_device(batch), cfg, max_len=max_len)

    return ModelBundle(
        cfg=cfg, init=lambda seed=0: transformer.init_params(cfg, seed, dev), loss=loss,
        prefill=prefill, decode=_decode(transformer.decode_step, cfg, dev),
        init_cache=_init_cache(transformer.init_cache, cfg),
        bind=lambda tree: transformer.bind(cfg, tree), device=dev)


_INT_TYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def _decode(step, cfg, dev):
    @torch.inference_mode()
    def decode(params, token, caches, pos):
        """``pos``: an int, or a 0-d integer tensor on the bundle's device
        (the captured decode's), passed on unread."""
        if isinstance(pos, torch.Tensor):
            if pos.dim() != 0 or pos.dtype not in _INT_TYPES or pos.device != dev:
                raise ValueError(f"pos must be an int or a 0-d integer tensor on {dev}, got a "
                                 f"{pos.dtype} tensor of shape {tuple(pos.shape)} on {pos.device}")
        else:
            pos = operator.index(pos)
        return step(params, torch.as_tensor(token, device=dev).long(), cfg, caches, pos)

    return decode


def _init_cache(make, cfg):
    @torch.inference_mode()
    def init_cache(params, batch_size, max_len):
        return make(params, cfg, batch_size, max_len)

    return init_cache

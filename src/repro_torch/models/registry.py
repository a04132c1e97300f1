"""Uniform model API: ``build_model(cfg)`` -> :class:`ModelBundle`.

Port of ``repro/models/registry.py`` for the ``hybrid`` family (zamba2),
serving only: ``init`` / ``prefill`` / ``decode`` / ``init_cache``. The
bundle is bound to one device, the CUDA card unless the caller passes
``device="cpu"``; ``prefill`` and ``decode`` run under
``torch.inference_mode()`` and take token ids as tensors or numpy
arrays. ``loss`` (training) and every other family raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import hybrid


@dataclasses.dataclass(frozen=True, eq=False)
class ModelBundle:
    cfg: ModelConfig
    init: Callable  # (seed) -> params (an nn.Module on ``device``)
    loss: Callable  # (params, batch) -> scalar
    prefill: Callable  # (params, batch) -> (last-token logits, aux)
    decode: Callable  # (params, token, caches, pos) -> (logits, caches)
    init_cache: Callable  # (params, batch_size, max_len) -> caches


def build_model(cfg: ModelConfig, device="cuda") -> ModelBundle:
    if cfg.family != "hybrid" or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP A15c)")
    dev = resolve_device(device)

    def tokens_on_device(tokens):
        return torch.as_tensor(tokens, device=dev).long()

    def loss(params, batch):
        raise NotImplementedError(f"{cfg.name}: training is not ported yet (ROADMAP A15b)")

    @torch.inference_mode()
    def prefill(params, batch):
        # Recurrent-family prefill = the forward pass; last_only skips the
        # full-sequence lm head (serving continuity goes through decode).
        return hybrid.forward(params, tokens_on_device(batch["tokens"]), cfg, last_only=True)

    @torch.inference_mode()
    def decode(params, token, caches, pos):
        return hybrid.decode_step(params, tokens_on_device(token), cfg, caches, int(pos))

    @torch.inference_mode()
    def init_cache(params, batch_size, max_len):
        return hybrid.init_cache(params, cfg, batch_size, max_len)

    return ModelBundle(
        cfg=cfg,
        init=lambda seed=0: hybrid.init_params(cfg, seed, dev),
        loss=loss,
        prefill=prefill,
        decode=decode,
        init_cache=init_cache,
    )

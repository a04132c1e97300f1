"""Uniform model API: ``build_model(cfg)`` -> :class:`ModelBundle`.

Port of ``repro/models/registry.py`` for the ``hybrid`` family (zamba2):
``init`` / ``loss`` (train) / ``prefill`` / ``decode`` / ``init_cache``.
The bundle is bound to one device, the CUDA card unless the caller
passes ``device="cpu"``, and takes token ids as tensors or numpy arrays.
``prefill``, ``decode`` and ``init_cache`` run under
``torch.inference_mode()``; ``loss`` runs outside it, so autograd can
record it (a tensor made in inference mode can never enter a graph).
Every other family raises ``NotImplementedError`` naming the ROADMAP item
that ports it.

Beyond the reference's fields, for the P2P layer's stacked agents
(:mod:`repro_torch.core.spmd`): ``bind`` lays the model over one agent's
parameter tree without a copy, and :meth:`ModelBundle.init_agents` draws
A agents' trees stacked on a leading axis, the reference's
``jax.vmap(bundle.init)`` layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import hybrid
from repro_torch.utils.tree import module_views, tree_map


@dataclasses.dataclass(frozen=True, eq=False)
class ModelBundle:
    cfg: ModelConfig
    init: Callable  # (seed) -> params (an nn.Module on ``device``)
    loss: Callable  # (params, batch) -> scalar
    prefill: Callable  # (params, batch) -> (last-token logits, aux)
    decode: Callable  # (params, token, caches, pos) -> (logits, caches)
    init_cache: Callable  # (params, batch_size, max_len) -> caches
    bind: Callable  # (one agent's parameter tree) -> params over its storage
    device: torch.device

    def train_inputs(self, batch, seq):
        """Concrete-shape template for the training batch (used by tests)."""
        return {"tokens": torch.zeros((batch, seq), dtype=torch.int32, device=self.device)}

    def init_agents(self, n_agents: int, seed: int = 0) -> dict:
        """``n_agents`` models drawn from seeds spawned off ``seed``, as one
        tree whose every leaf is stacked on a leading agent axis (the
        ``layers`` axis under it). One agent's model is held at a time."""
        seeds = np.random.SeedSequence(seed).generate_state(n_agents)
        shapes = hybrid.param_tree(hybrid.HybridLM(self.cfg, device="meta"))
        stacked = tree_map(lambda x: torch.empty((n_agents, *x.shape), dtype=x.dtype,
                                                 device=self.device), shapes)
        for a, s in enumerate(seeds):
            own = dict(self.init(int(s)).named_parameters())
            with torch.no_grad():
                for name, dst in module_views(tree_map(lambda x: x[a], stacked)):
                    dst.copy_(own[name])
            del own
        return stacked


def build_model(cfg: ModelConfig, remat: bool = True, device="cuda") -> ModelBundle:
    if cfg.family != "hybrid" or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (ROADMAP A15c)")
    dev = resolve_device(device)

    def tokens_on_device(tokens):
        return torch.as_tensor(tokens, device=dev).long()

    def loss(params, batch):
        return hybrid.loss_fn(params, {"tokens": tokens_on_device(batch["tokens"])}, cfg,
                              remat=remat)

    @torch.inference_mode()
    def prefill(params, batch):
        # Recurrent-family prefill = the forward pass; last_only skips the
        # full-sequence lm head (serving continuity goes through decode).
        return hybrid.forward(params, tokens_on_device(batch["tokens"]), cfg, remat=False,
                              last_only=True)

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
        bind=lambda tree: hybrid.bind(cfg, tree),
        device=dev,
    )

"""Assigned architecture configs (+ the paper's native linear configs).

The port's own copies of the ``repro/configs`` modules (pure data). Every
family has a model in the port (``repro_torch.models.registry.build_model``).

Each module defines ``CONFIG`` with the exact assigned hyperparameters and
cites its source. ``get_config(name)`` resolves by arch id.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    DECODE_32K,
    ModelConfig,
    MoEConfig,
    P2PConfig,
    RunConfig,
    ShapeConfig,
    SSMConfig,
    XLSTMConfig,
    reduced,
)

ARCH_IDS = [
    "llama3.2-1b",
    "granite-moe-3b-a800m",
    "qwen1.5-4b",
    "chameleon-34b",
    "seamless-m4t-medium",
    "zamba2-1.2b",
    "qwen2.5-14b",
    "grok-1-314b",
    "xlstm-1.3b",
    "granite-3-8b",
]

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen1.5-4b": "qwen1_5_4b",
    "chameleon-34b": "chameleon_34b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen2.5-14b": "qwen2_5_14b",
    "grok-1-314b": "grok_1_314b",
    "xlstm-1.3b": "xlstm_1_3b",
    "granite-3-8b": "granite_3_8b",
}

# P2P agent-mode per arch (DESIGN.md §5): memory-bound giants run in "silo"
# mode (agent = pod, FSDP+TP within), everything else gets 16/32 personal
# replicas ("full").
AGENT_MODES = {
    "llama3.2-1b": "full",
    "granite-moe-3b-a800m": "full",
    "qwen1.5-4b": "full",
    "chameleon-34b": "silo",
    "seamless-m4t-medium": "full",
    "zamba2-1.2b": "full",
    "qwen2.5-14b": "full",
    "grok-1-314b": "silo",
    "xlstm-1.3b": "full",
    "granite-3-8b": "full",
}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_reduced(arch_id: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch_id), **overrides)


__all__ = [
    "ARCH_IDS",
    "AGENT_MODES",
    "SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "XLSTMConfig",
    "P2PConfig",
    "RunConfig",
    "ShapeConfig",
    "get_config",
    "get_reduced",
    "reduced",
]

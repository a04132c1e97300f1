"""grok-1-314b [moe] — 8 experts top-2, logit softcap [hf:xai-org/grok-1]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    logit_softcap=30.0,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25, group_size=512),
    citation="hf:xai-org/grok-1",
)

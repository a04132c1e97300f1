"""granite-moe-3b-a800m [moe] — 40 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=40, top_k=8, capacity_factor=1.25, group_size=256),
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

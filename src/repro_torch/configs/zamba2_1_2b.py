"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242]."""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm=SSMConfig(state_dim=64, head_dim=64, conv_kernel=4, chunk=128, expand=2),
    shared_attn_every=6,  # shared attn block applied every 6 mamba layers
    tie_embeddings=True,
    citation="arXiv:2411.15242",
)

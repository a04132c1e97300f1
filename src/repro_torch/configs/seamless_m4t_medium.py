"""seamless-m4t-medium [audio] — enc-dec; the mel/conv frontend is stubbed:
the encoder consumes precomputed frame embeddings [arXiv:2308.11596]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,          # decoder layers
    encoder_layers=12,      # speech-encoder transformer layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    citation="arXiv:2308.11596",
)

"""chameleon-34b [vlm] — early-fusion; VQ image tokens live in the vocab
(stubbed VQ tokenizer frontend) [arXiv:2405.09818]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    # last 8192 vocab ids are VQ image codes emitted by the stub frontend
    image_vocab_offset=65536 - 8192,
    citation="arXiv:2405.09818",
)

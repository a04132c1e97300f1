"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks, xLSTM[7:1] [arXiv:2405.04517]."""

from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,  # FFN lives inside the xLSTM blocks (proj_factor)
    vocab_size=50304,
    head_dim=512,
    xlstm=XLSTMConfig(slstm_every=8, proj_factor=2.0, chunk=128),
    tie_embeddings=True,
    citation="arXiv:2405.04517",
)

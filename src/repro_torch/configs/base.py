"""Architecture + run configuration schema.

The port's own copy of ``repro/configs/base.py`` (pure data, numpy only);
``tests/test_torch_hybrid.py`` holds its fields equal to the reference's.
Every assigned architecture gets a ``ModelConfig`` in its own module under
``repro_torch/configs``. The P2P scale layer's settings live in ``P2PConfig``
(agent graph topology, DP budget, gossip schedule) — the paper's technique is
a first-class feature toggled per run, not per architecture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    group_size: int = 256  # tokens per dispatch group (bounds dispatch memory)
    router_aux_weight: float = 0.01  # load-balance loss weight


@dataclasses.dataclass(frozen=True, eq=False)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    conv_kernel: int = 4
    chunk: int = 128
    expand: int = 2


@dataclasses.dataclass(frozen=True, eq=False)
class XLSTMConfig:
    slstm_every: int = 8  # one sLSTM block per this many blocks (rest mLSTM)
    proj_factor: float = 2.0  # up-projection inside mLSTM blocks
    chunk: int = 128


@dataclasses.dataclass(frozen=True, eq=False)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None  # grok-style tanh soft-capping
    sliding_window: Optional[int] = None  # if set, self-attn is windowed
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2-style): a single shared attention block applied every
    # `shared_attn_every` backbone layers.
    shared_attn_every: Optional[int] = None
    # enc-dec (seamless-style): number of encoder layers; encoder consumes
    # precomputed frontend embeddings (the stub carve-out).
    encoder_layers: int = 0
    # VLM early-fusion: image tokens are a reserved slice of the vocab (VQ
    # codes produced by the stubbed tokenizer frontend).
    image_vocab_offset: Optional[int] = None
    dtype: str = "bfloat16"
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding/lm-head
        vocab dim shards over the 16-wide model axis (MaxText-style padding;
        keeps logits vocab-sharded instead of replicated)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Rough analytic parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6 N D."""
        d, hd = self.d_model, self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm" and self.xlstm is not None:
            pf = self.xlstm.proj_factor
            di = int(pf * d)
            # mLSTM block: up/gate proj d->2di, qkv di->3di, out di->d (+ norms)
            per = d * 2 * di + di * 3 * di + di * d
            return emb + self.num_layers * per
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.moe is not None:
            ff = self.moe.num_experts * 3 * d * self.d_ff + d * self.moe.num_experts
        else:
            ff = 3 * d * self.d_ff
        if self.family == "hybrid" and self.ssm is not None:
            di = self.ssm.expand * d
            nheads = di // self.ssm.head_dim
            per = (
                d * (2 * di + 2 * nheads * self.ssm.state_dim + nheads)
                + di * d
                + di * self.ssm.conv_kernel
            )
            n_attn = self.num_layers // (self.shared_attn_every or self.num_layers)
            return emb + self.num_layers * per + attn  # attn is shared (1 copy)
        total_blocks = self.num_layers * (attn + ff)
        if self.is_encdec:
            # decoder cross-attn adds one more attention per decoder layer
            total_blocks += self.num_layers * attn
            total_blocks += self.encoder_layers * (attn + ff)
        return emb + total_blocks

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full_ff = self.moe.num_experts * 3 * d * self.d_ff
        act_ff = self.moe.top_k * 3 * d * self.d_ff
        return self.param_count() - self.num_layers * (full_ff - act_ff)


@dataclasses.dataclass(frozen=True, eq=False)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}


@dataclasses.dataclass(frozen=True, eq=False)
class P2PConfig:
    """The paper's technique at datacenter scale (DESIGN.md §4)."""

    enabled: bool = True
    # "full": one agent per data-axis index (personal model replicas);
    # "silo": one agent per pod (FSDP+TP within; for memory-bound giants).
    agent_mode: str = "full"
    # circulant gossip topology: neighbour offsets on the agent ring.
    neighbor_offsets: tuple = (1, 2)
    mu: float = 0.04
    # DP budget per agent (eps_bar, delta_bar); noise on local grads (Eq. 6).
    dp_enabled: bool = True
    eps_bar: float = 1.0
    delta_bar: float = float(np.exp(-5.0))
    planned_rounds: int = 100  # T_i for budget splitting
    clip: float = 10.0  # per-example grad clip C (Supp. D.2)
    gossip_dtype: str = "bfloat16"  # payload dtype for Theta exchange

    def __post_init__(self):
        # The three gossip paths (ppermute / sparse / dense) carry
        # divergent legacy fallbacks for an empty ring, so reject it here
        # rather than let them silently disagree.
        if self.enabled and not self.neighbor_offsets:
            raise ValueError("neighbor_offsets must name at least one ring offset")


@dataclasses.dataclass(frozen=True, eq=False)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    p2p: P2PConfig = dataclasses.field(default_factory=P2PConfig)
    learning_rate: float = 3e-4  # local-loss step inside the CD update
    remat: bool = True  # activation checkpointing per layer
    seed: int = 0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (<=2 layers, d<=512)."""
    defaults = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 128),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=min(cfg.d_ff, 256),
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=32,
    )
    if cfg.moe is not None:
        defaults["moe"] = MoEConfig(
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            group_size=32,
        )
    if cfg.ssm is not None:
        defaults["ssm"] = SSMConfig(state_dim=16, head_dim=16, chunk=16)
    if cfg.xlstm is not None:
        defaults["xlstm"] = XLSTMConfig(slstm_every=2, chunk=16)
    if cfg.shared_attn_every is not None:
        defaults["shared_attn_every"] = 2
    if cfg.encoder_layers > 0:
        defaults["encoder_layers"] = 2
    if cfg.num_kv_heads == cfg.num_heads:  # MHA archs keep MHA in reduced form
        defaults["num_kv_heads"] = defaults["num_heads"]
    defaults.update(overrides)
    return dataclasses.replace(cfg, **defaults)

"""Model configuration schema (copy of ``repro/models/config.py``).

A model is a token embedding + a sequence of *stages*; each stage is a
block pattern repeated ``repeat`` times (executed interleaved, i.e.
stage = lax.scan over ``repeat`` of its pattern).  This expresses every
assigned architecture exactly:

  * dense LMs:        1 stage, pattern = [attn+dense], repeat = L
  * granite-moe:      1 stage, pattern = [attn+moe],   repeat = L
  * deepseek-v2-lite: stage0 = [attn(mla)+dense] x1, stage1 = [mla+moe] x26
  * jamba:            1 stage, pattern = 8 blocks (mamba/attn x {dense,moe}),
                      repeat = 4
  * xlstm:            1 stage, pattern = [mlstm x7, slstm], repeat = 3

Every (stage, pattern position) is a ZO layer *group* whose parameters are
stacked over ``repeat``; the global LeZO layer index space enumerates all
``sum(repeat * len(pattern))`` blocks.

The port keeps its own copy so it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kind: str          # attn | mla | mamba | mlstm | slstm
    ffn: str = "dense"  # dense | moe | none
    d_ff: int = 0       # override cfg.d_ff for this block (0 = default)


@dataclasses.dataclass(frozen=True)
class StageCfg:
    repeat: int
    pattern: Tuple[BlockCfg, ...]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    stages: Tuple[StageCfg, ...]
    d_head: int = 0                  # 0 -> d_model // n_heads
    # attention flavor
    qk_norm: bool = False
    attn_q_chunk: int = 512       # flash attention q tile
    attn_k_chunk: int = 2048      # flash attention kv tile (acc-carry HBM
                                  # traffic ~ 1/attn_k_chunk; hillclimbed)
    pos_emb: str = "rope"            # rope | learned | none
    rope_theta: float = 10000.0
    act: str = "silu"                # silu(=swiglu) | gelu | relu
    norm: str = "rms"                # rms | ln
    # MLA (deepseek)
    kv_lora: int = 0
    rope_head_dim: int = 64
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_d_ff: int = 0        # deepseek: layer-0 dense FFN width
    moe_renormalize: bool = True     # top-k weights over their sum (Jamba:
                                     # False, the softmax's own)
    expert_shard: Tuple[int, int] = (0, 0)  # (first, count) of the experts
                                     # a layer holds; count 0: all
    # mamba
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    mamba_dtbc_norm: bool = False    # Jamba's RMSNorms on dt_in, B and C
    # xlstm
    lstm_pf: int = 2                 # mLSTM projection factor
    # misc
    tie_embeddings: bool = True
    frontend: str = "none"           # none | audio | vision
    frontend_dim: int = 0            # stub embedding dim (== d_model)
    max_seq: int = 4096
    dtype: str = "bfloat16"
    subquadratic: bool = False       # eligible for long_500k decode
    min_active_layers: int = 1       # forbid rho=1 (paper Fig.3 collapse)

    def __post_init__(self):
        # a configuration file gives the pair as a JSON list
        object.__setattr__(self, "expert_shard", tuple(self.expert_shard))

    @property
    def held_experts(self) -> Tuple[int, int]:
        """(first, count) of the experts each MoE layer holds: all
        ``n_experts`` unless ``expert_shard`` names a share of them."""
        first, count = self.expert_shard
        if not count:
            return 0, self.n_experts
        if first < 0 or first + count > self.n_experts:
            raise ValueError(f"expert_shard {self.expert_shard} outside the "
                             f"{self.n_experts} experts")
        return first, count

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def num_layers(self) -> int:
        return sum(s.repeat * len(s.pattern) for s in self.stages)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        return math.ceil(self.d_model / 16)

    @property
    def lstm_d_inner(self) -> int:
        return self.lstm_pf * self.d_model

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_lm(name, L, d_model, n_heads, n_kv_heads, d_ff, vocab, **kw) -> ModelConfig:
    """Helper for standard dense decoder-only LMs."""
    return ModelConfig(
        name=name, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv_heads,
        d_ff=d_ff, vocab=vocab,
        stages=(StageCfg(L, (BlockCfg("attn", "dense"),)),), **kw)

"""granite-moe-1b-a400m [moe] — 32 experts, top-8.

24L d_model=1024 16H (GQA kv=8) expert d_ff=512 vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/granite_moe_1b.py``.
"""
from repro_torch.models.config import BlockCfg, ModelConfig, StageCfg


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab=49155,
        stages=(StageCfg(24, (BlockCfg("attn", "moe"),)),),
        n_experts=32, top_k=8, moe_d_ff=512,
        tie_embeddings=True, max_seq=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=512, stages=(StageCfg(2, (BlockCfg("attn", "moe"),)),),
        n_experts=4, top_k=2, moe_d_ff=32, dtype="float32", max_seq=128,
    )

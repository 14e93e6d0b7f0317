"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + 2 shared / 64 routed top-6.

27L d_model=2048 16H d_head=128(+64 rope) moe d_ff=1408 vocab=102400;
layer 0 uses a dense FFN (width 10944).  [arXiv:2405.04434; hf]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/deepseek_v2_lite.py``.
"""
from repro_torch.models.config import BlockCfg, ModelConfig, StageCfg


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", d_model=2048, n_heads=16, n_kv_heads=16,
        d_head=128, d_ff=1408, vocab=102400,
        stages=(StageCfg(1, (BlockCfg("mla", "dense", d_ff=10944),)),
                StageCfg(26, (BlockCfg("mla", "moe"),))),
        kv_lora=512, rope_head_dim=64,
        n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
        tie_embeddings=False, max_seq=32768,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", d_model=64, n_heads=4, n_kv_heads=4,
        d_head=16, d_ff=48, vocab=512,
        stages=(StageCfg(1, (BlockCfg("mla", "dense", d_ff=96),)),
                StageCfg(2, (BlockCfg("mla", "moe"),))),
        kv_lora=32, rope_head_dim=8,
        n_experts=4, n_shared_experts=2, top_k=2, moe_d_ff=48,
        tie_embeddings=False, dtype="float32", max_seq=128,
    )

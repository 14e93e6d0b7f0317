"""jamba-v0.1-52b [hybrid] — Mamba+attention 7:1, MoE 16e top-2 every other
layer.  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Period-8 pattern (attention at offset 4, MoE at odd offsets), repeated 4x.
[arXiv:2403.19887; hf]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/jamba_v0_1_52b.py``.
"""
from repro_torch.models.config import BlockCfg, ModelConfig, StageCfg


def _pattern(attn_offset=4):
    out = []
    for i in range(8):
        kind = "attn" if i == attn_offset else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        out.append(BlockCfg(kind, ffn))
    return tuple(out)


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=65536, stages=(StageCfg(4, _pattern()),),
        n_experts=16, top_k=2, moe_d_ff=14336,
        mamba_d_state=16, mamba_expand=2, mamba_conv=4,
        tie_embeddings=False, max_seq=524288, subquadratic=True,
    )


def smoke() -> ModelConfig:
    pat = (BlockCfg("mamba", "dense"), BlockCfg("mamba", "moe"),
           BlockCfg("attn", "dense"), BlockCfg("mamba", "moe"))
    return ModelConfig(
        name="jamba-smoke", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, stages=(StageCfg(2, pat),),
        n_experts=4, top_k=2, moe_d_ff=64, dtype="float32", max_seq=128,
        subquadratic=True,
    )

"""qwen3-14b [dense] — qk_norm, GQA. 40L d_model=5120 40H (kv=8) d_head=128
d_ff=17408 vocab=151936.  [hf:Qwen/Qwen3-8B; hf]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/qwen3_14b.py``.
"""
from repro_torch.models.config import ModelConfig, dense_lm


def full() -> ModelConfig:
    return dense_lm("qwen3-14b", 40, 5120, 40, 8, 17408, 151936,
                    d_head=128, qk_norm=True, tie_embeddings=False,
                    max_seq=32768)


def smoke() -> ModelConfig:
    return dense_lm("qwen3-smoke", 2, 64, 4, 2, 160, 512, d_head=16,
                    qk_norm=True, tie_embeddings=False, dtype="float32",
                    max_seq=128)

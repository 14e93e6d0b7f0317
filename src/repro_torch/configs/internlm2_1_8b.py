"""internlm2-1.8b [dense] — GQA. 24L d_model=2048 16H (kv=8) d_ff=8192
vocab=92544.  [arXiv:2403.17297; hf]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/internlm2_1_8b.py``.
"""
from repro_torch.models.config import ModelConfig, dense_lm


def full() -> ModelConfig:
    return dense_lm("internlm2-1.8b", 24, 2048, 16, 8, 8192, 92544,
                    tie_embeddings=False, max_seq=32768)


def smoke() -> ModelConfig:
    return dense_lm("internlm2-smoke", 2, 64, 4, 2, 128, 512,
                    tie_embeddings=False, dtype="float32", max_seq=128)

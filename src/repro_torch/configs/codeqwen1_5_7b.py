"""codeqwen1.5-7b [dense] — qwen1.5-arch (MHA). 32L d_model=4096 32H (kv=32)
d_ff=13440 vocab=92416.  [hf:Qwen/CodeQwen1.5-7B; hf]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/codeqwen1_5_7b.py``.
"""
from repro_torch.models.config import ModelConfig, dense_lm


def full() -> ModelConfig:
    return dense_lm("codeqwen1.5-7b", 32, 4096, 32, 32, 13440, 92416,
                    tie_embeddings=False, max_seq=32768)


def smoke() -> ModelConfig:
    return dense_lm("codeqwen-smoke", 2, 64, 4, 4, 192, 512,
                    tie_embeddings=False, dtype="float32", max_seq=128)

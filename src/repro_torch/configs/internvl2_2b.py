"""internvl2-2b [vlm] — InternViT (stub) + InternLM2-1.8B backbone.
24L d_model=2048 16H (kv=8) d_ff=8192 vocab=92553; input_specs provides
patch embeddings.  [arXiv:2404.16821; hf]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/internvl2_2b.py``.
"""
from repro_torch.models.config import ModelConfig, dense_lm


def full() -> ModelConfig:
    return dense_lm("internvl2-2b", 24, 2048, 16, 8, 8192, 92553,
                    frontend="vision", tie_embeddings=False, max_seq=32768)


def smoke() -> ModelConfig:
    return dense_lm("internvl2-smoke", 2, 64, 4, 2, 128, 512,
                    frontend="vision", tie_embeddings=False, dtype="float32",
                    max_seq=128)

"""deepseek-coder-33b [dense] — llama-arch. 62L d_model=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256.  [arXiv:2401.14196; hf]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/deepseek_coder_33b.py``.
"""
from repro_torch.models.config import ModelConfig, dense_lm


def full() -> ModelConfig:
    return dense_lm("deepseek-coder-33b", 62, 7168, 56, 8, 19200, 32256,
                    tie_embeddings=False, max_seq=32768)


def smoke() -> ModelConfig:
    return dense_lm("deepseek-coder-smoke", 3, 64, 8, 2, 160, 512,
                    tie_embeddings=False, dtype="float32", max_seq=128)

"""musicgen-large [audio] — decoder-only over EnCodec tokens; frontend
stubbed (input_specs provides frame embeddings).  48L d_model=2048 32H
(kv=32) d_ff=8192 vocab=2048.  [arXiv:2306.05284; hf]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/musicgen_large.py``.
"""
from repro_torch.models.config import ModelConfig, dense_lm


def full() -> ModelConfig:
    return dense_lm("musicgen-large", 48, 2048, 32, 32, 8192, 2048,
                    act="gelu", norm="ln", pos_emb="learned",
                    frontend="audio", tie_embeddings=False, max_seq=32768)


def smoke() -> ModelConfig:
    return dense_lm("musicgen-smoke", 2, 64, 4, 4, 128, 256,
                    act="gelu", norm="ln", pos_emb="learned",
                    frontend="audio", tie_embeddings=False, dtype="float32",
                    max_seq=128)

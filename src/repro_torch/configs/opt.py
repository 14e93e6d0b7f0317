"""OPT family (copy of ``repro/configs/opt.py``): relu, LayerNorm,
learned positions, MHA, tied embeddings.  [arXiv:2205.01068]

``full`` is OPT-13B, the paper's main model and this port's main path;
``smoke``/``tiny``/``bench`` are the reduced variants the CPU tests use.
"""
from repro_torch.models.config import ModelConfig, dense_lm

_COMMON = dict(act="relu", norm="ln", pos_emb="learned", tie_embeddings=True,
               max_seq=2048)


def opt_1_3b() -> ModelConfig:
    return dense_lm("opt-1.3b", 24, 2048, 32, 32, 8192, 50272, **_COMMON)


def opt_13b() -> ModelConfig:
    return dense_lm("opt-13b", 40, 5120, 40, 40, 20480, 50272, **_COMMON)


def opt_30b() -> ModelConfig:
    return dense_lm("opt-30b", 48, 7168, 56, 56, 28672, 50272, **_COMMON)


def full() -> ModelConfig:  # registry default: the paper's main model
    return opt_13b()


def smoke() -> ModelConfig:
    return dense_lm("opt-smoke", 2, 64, 4, 4, 128, 512, dtype="float32",
                    **{**_COMMON, "max_seq": 128})


def opt_tiny(layers=4, d_model=128, vocab=512) -> ModelConfig:
    """CPU-trainable OPT-shaped model for convergence checks."""
    return dense_lm(f"opt-tiny-{layers}L{d_model}", layers, d_model, 4, 4,
                    4 * d_model, vocab, dtype="float32",
                    **{**_COMMON, "max_seq": 256})


def tiny() -> ModelConfig:
    """Registry variant for the fast-tier fixtures (``model.variant``)."""
    return opt_tiny()


def bench() -> ModelConfig:
    """Registry variant at the benchmark suite's params/token ratio."""
    return opt_tiny(layers=4, d_model=512, vocab=2048)

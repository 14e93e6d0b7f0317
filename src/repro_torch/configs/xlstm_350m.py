"""xlstm-350m [ssm] — sLSTM + mLSTM blocks, xLSTM[7:1] interleave.

24L d_model=1024 4H d_ff=0 (the mLSTM block carries its own 2x projection)
vocab=50304.  [arXiv:2405.04517; unverified]

Model-zoo config (DESIGN.md §8); a copy of
``repro/configs/xlstm_350m.py``.
"""
from repro_torch.models.config import BlockCfg, ModelConfig, StageCfg

_PATTERN = tuple([BlockCfg("mlstm", "none")] * 7 + [BlockCfg("slstm", "none")])


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m", d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab=50304, stages=(StageCfg(3, _PATTERN),), lstm_pf=2,
        tie_embeddings=True, max_seq=524288, subquadratic=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke", d_model=64, n_heads=4, n_kv_heads=4, d_ff=0,
        vocab=512, stages=(StageCfg(1, (BlockCfg("mlstm", "none"),
                                        BlockCfg("slstm", "none"))),),
        lstm_pf=2, dtype="float32", max_seq=128, subquadratic=True,
    )

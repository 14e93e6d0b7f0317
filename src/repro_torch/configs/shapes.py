"""The input-shape grid of the dry run (counterpart of
``repro/configs/shapes.py``, field for field).

``train_*`` shapes run ``train_step`` (one full LeZO/MeZO optimization
step); ``decode_*`` / ``long_*`` run ``serve_step`` (one new token
against a KV/state cache of ``seq_len``); ``prefill_*`` runs the cache
build over the full prompt.

``long_500k`` needs sub-quadratic sequence handling, so only configs
with ``subquadratic=True`` (xlstm, jamba) get it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg) -> list:
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out

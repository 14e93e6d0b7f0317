"""Prefix tuning composed with ZO (counterpart of
``repro/peft/prefix.py``; paper Table 4: MeZO/LeZO (prefix)).

Trainable state: ``n_prefix`` learned key/value pairs per attention
layer (stacked over layers).  :func:`inject` hands the forward the base
parameters with ``pk``/``pv`` leaves beside each block's projections,
which ``layers.attn_fwd`` prepends as always-visible positions (kernel
K2 at ``k_offset = -n_prefix``).  ZO perturbs only the prefix tree;
LeZO's layer groups apply via the same stage/block paths.

PEFT trainable subtrees (DESIGN.md §1 subsystem map).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import layers, lm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class PrefixConfig:
    n_prefix: int = 5
    init_std: float = 0.02


def init_prefix(cfg: ModelConfig, gen: torch.Generator,
                pcfg: PrefixConfig = PrefixConfig(), device=None
                ) -> Dict[str, Any]:
    """One (pk, pv) pair per attention block position, stacked over
    repeat, (repeat, P, KV, dh) in the model dtype, drawn from ``gen``
    with std 0.02 (the reference's constant)."""
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    P = pcfg.n_prefix
    dt = getattr(torch, cfg.dtype)
    out = {}
    for si, st in enumerate(cfg.stages):
        for bj, b in enumerate(st.pattern):
            if b.kind != "attn":
                continue
            base = f"stages/s{si}/b{bj}/mix"
            for name in ("pk", "pv"):
                out[f"{base}/{name}"] = layers.randn_scaled(
                    (st.repeat, P, KV, dh), 0.02, gen, dt, device)
    if not out:
        raise ValueError("model has no attention blocks for prefix tuning")
    return out


def inject(params, prefix: Dict[str, Any]) -> lm.Overlay:
    """``params`` read with the pk/pv leaves grafted into the matching
    blocks; ``params`` itself is not changed."""
    return lm.Overlay(params, prefix)


def prefix_group_fn(path: str):
    if path.startswith("stages/"):
        parts = path.split("/")
        return f"{parts[1]}.{parts[2]}"
    return None

"""LoRA composed with ZO (counterpart of ``repro/peft/lora.py``; paper
Table 4: MeZO/LeZO (LoRA)).

Trainable state is *only* the LoRA tree (A, B per target projection,
stacked over layers exactly like the base weights), keyed by the base
leaf's path (``{"stages/s0/b0/mix/wq": {"A": ..., "B": ...}}``), so the
ZO machinery — including LeZO's layer groups — applies unchanged:
``zo.build_spec`` on the LoRA tree with :func:`lora_group_fn`.

``merge`` gives the forward W + (alpha/r) * A @ B for each target as a
:class:`models.lm.Overlay` over the base parameters: the merged stacks
are the only new tensors (two at OPT-13B: 2 x 2.1 GB), every other leaf
is the base's own.

PEFT trainable subtrees (DESIGN.md §1 subsystem map).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import zo
from repro_torch.models import layers, lm


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: int = 16
    targets: Tuple[str, ...] = ("wq", "wv")   # leaf names inside block mix


def _is_target(path_str: str, targets) -> bool:
    leafname = path_str.rsplit("/", 1)[-1]
    return path_str.startswith("stages/") and leafname in targets


def init_lora(params, cfg: LoRAConfig, gen: torch.Generator
              ) -> Dict[str, Any]:
    """Build the LoRA tree mirroring targeted leaves of ``params``, drawn
    from ``gen`` (a generator on the parameters' device): A normal with
    std din^-1/2, B zero, so the merged model starts as the base."""
    out = {}
    for ps, leaf in sorted(zo.leaf_items(params), key=lambda kv: kv[0]):
        if not _is_target(ps, cfg.targets) or leaf.ndim != 3:
            continue  # (R, din, dout) stacked projections only
        R, din, dout = leaf.shape
        out[ps] = {
            "A": layers.randn_scaled((R, din, cfg.rank), din ** -0.5, gen,
                                     leaf.dtype, leaf.device),
            "B": torch.zeros((R, cfg.rank, dout), dtype=leaf.dtype,
                             device=leaf.device),
        }
    if not out:
        raise ValueError(f"no LoRA targets matched {cfg.targets}")
    return out


def merge(params, lora: Dict[str, Any], cfg: LoRAConfig) -> lm.Overlay:
    """``params`` read with W <- W + (alpha/rank) * A @ B for each target,
    in the reference's op order (the product rounded to the leaf dtype,
    scaled, then added to W)."""
    scale = cfg.alpha / cfg.rank
    base = dict(zo.leaf_items(params))
    merged = {}
    for ps, ab in lora.items():
        w = torch.bmm(ab["A"], ab["B"])
        w.mul_(scale)
        merged[ps] = w.add_(base[ps])
    return lm.Overlay(params, merged)


def lora_group_fn(path: str):
    """ZO layer-group labels for the LoRA tree: the dict key IS the base
    path, so reuse its stage/block prefix ('stages/s0/b0/...')."""
    if path.startswith("stages/"):
        parts = path.split("/")
        return f"{parts[1]}.{parts[2]}"
    return None

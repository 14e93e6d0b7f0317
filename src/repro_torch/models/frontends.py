"""Stub modality frontends (counterpart of ``repro/models/frontends.py``).

For `[audio]` (musicgen: EnCodec frame embeddings) and `[vlm]`
(internvl2: InternViT patch embeddings) the frontend is not implemented:
the backbone takes precomputed (B, S, D) embeddings as the batch's
``embeds``.  :func:`stub_embeddings` draws deterministic ones for smoke
runs from a ``torch.Generator``, so its values differ from the
reference's ``jax.random`` draws; tests feed both packages the same
numpy embeddings instead.

Model stack / zoo (DESIGN.md §8).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models.config import ModelConfig


def stub_embeddings(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                    device=None) -> torch.Tensor:
    """Deterministic fake frame/patch embeddings, unit RMS, (batch, seq,
    d_model) in ``cfg.dtype`` on ``device`` (None: the card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    e = torch.randn((batch, seq, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=dev)
    e = e / torch.sqrt(torch.mean(e ** 2, dim=-1, keepdim=True))
    return e.to(getattr(torch, cfg.dtype))


def uses_embeds(cfg: ModelConfig) -> bool:
    return cfg.frontend in ("audio", "vision")

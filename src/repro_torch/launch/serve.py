"""The lockstep generate loop (counterpart of ``repro/launch/serve.py``;
DESIGN.md §12).

One prompt batch goes in and every lane decodes in step: ``lm.prefill``
(kernel K2 over the prompt) then ``lm.serve_step`` per token, greedy.
``python -m repro_torch.launch serve --engine lockstep`` drives it; the
paged engine (``repro_torch.serving``) is the default where the model
supports it.
"""
from __future__ import annotations

import torch

from repro_torch.models import lm


def generate(cfg, params, tokens, gen_steps: int, max_seq: int):
    """Greedy continuation of ``tokens`` (B, S), on their device:
    (B, gen_steps) int64, through a cache of ``max_seq`` slots."""
    S = tokens.shape[1]
    logits, caches = lm.prefill(cfg, params, tokens, max_seq=max_seq)
    tok = torch.argmax(logits, -1)[:, None]
    out = [tok]
    for i in range(gen_steps - 1):
        logits, caches = lm.serve_step(cfg, params, caches, tok, S + i)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)

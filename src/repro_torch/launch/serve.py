"""The lockstep generate loop (counterpart of ``repro/launch/serve.py``;
DESIGN.md §12).

One prompt batch goes in and every lane decodes in step: ``lm.prefill``
(kernel K2 over the prompt) then ``lm.serve_step`` per token, greedy.
``python -m repro_torch.launch serve --engine lockstep`` drives it; the
paged engine (``repro_torch.serving``) is the default where the model
supports it.  ``python -m repro_torch.launch.serve`` is the legacy shim
(:func:`main`) over that command, defaulting to ``--arch xlstm-350m``.
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


def main(argv=None):
    """Shim over ``python -m repro_torch.launch serve`` (``launch/cli.py``):
    spec flags (--arch/--variant/--seed and any --set) plus the serve
    extras; ``--arch`` defaults to ``xlstm-350m``, as the reference's
    legacy surface does."""
    import sys

    from repro_torch.launch import cli
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a == "--arch" or a.startswith("--arch=")
               or a == "--model.arch" or a.startswith("--model.arch=")
               for a in argv):
        argv = ["--arch", "xlstm-350m"] + argv
    return cli.main(["serve"] + argv)


if __name__ == "__main__":
    main()

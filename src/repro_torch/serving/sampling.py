"""Per-request counter-RNG sampling: greedy / temperature / top-k
(counterpart of ``repro/serving/sampling.py``; DESIGN.md §12).

A sampled token is a pure function of (request seed, absolute position),
never of which lane or decode batch happened to serve it: the same
request samples the same continuation whether it rode a full batch, a
lonely lane, or a re-run after preemption.

The reference draws with ``jax.random.categorical`` under
``fold_in(PRNGKey(seed), position)``; the port cannot match those bits
and keeps the contract with its own counter RNG (``core/rng.py``)
instead: the lane's key is ``fold(seed, position)``, vocabulary entry v
gets the uniform ``u = _uniform01(fold(key, v))`` in (0, 1], and the
token is the Gumbel-max ``argmax(logits / T - log(-log(1 - u)))``.
``1 - u`` lies in [0, 1), so the Gumbel noise is finite except at
``u == 1``, where it is -inf and that entry cannot win.  Everything runs
on the logits' device; no global torch RNG is read.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng


def make_sampler(temperature: float, top_k: int):
    """Build the sampler of one engine: ``fn(logits (B, V) f32, seeds (B,)
    int64, positions (B,) int64) -> (B,) int64``, on the logits' device.

    ``temperature == 0`` is greedy (argmax, the first index on ties, as
    JAX's; seeds unused).  ``top_k > 0`` restricts sampling to the
    logits at or above the k-th largest, ties kept, as the reference's
    ``kth`` threshold does.
    """
    if temperature < 0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")

    if temperature == 0.0:
        def greedy(logits, seeds, positions):
            return torch.argmax(logits, dim=-1)
        return greedy

    def sample(logits, seeds, positions):
        if top_k > 0:
            kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits >= kth, logits,
                                 torch.tensor(-torch.inf, dtype=logits.dtype,
                                              device=logits.device))
        key = rng.fold(seeds, positions)                          # (B,)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        u = rng._uniform01(rng.fold(key[:, None], vocab[None, :]))
        gumbel = -torch.log(-torch.log(1.0 - u))
        return torch.argmax(logits / temperature + gumbel, dim=-1)
    return sample

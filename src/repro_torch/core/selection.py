"""Layer-selection policies for LeZO (counterpart of
``repro/core/selection.py``).  This slice ports the paper's uniform
policy; ``round_robin`` and ``weighted`` are not yet ported.

A policy returns a boolean ``active`` mask of shape (num_layers,): True
means the layer is perturbed and updated this step.  Masks are pure
functions of the seed, computed on the host as small CPU tensors; the
uint32 ranking bits come from a bijection, so ``argsort`` has no ties
and the order equals the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng

_SALT = 0x5E1EC7  # "select"


def rank_bits(gseed: int, n: int) -> torch.Tensor:
    """Seeded per-layer ranking bits: mix32(id * GOLDEN + gseed)."""
    ids = torch.arange(n, dtype=torch.int64)
    return rng.mix32((ids * rng.GOLDEN + gseed) & rng.MASK32)


def uniform_active(seed: int, num_layers: int, n_drop: int) -> torch.Tensor:
    """Paper policy: drop ``n_drop`` layers uniformly without replacement."""
    if not 0 <= n_drop < num_layers:
        raise ValueError(f"n_drop must be in [0, {num_layers}), got {n_drop}")
    active = torch.ones((num_layers,), dtype=torch.bool)
    if n_drop == 0:
        return active
    order = torch.argsort(rank_bits(rng.fold_py(seed, _SALT), num_layers))
    active[order[:n_drop]] = False
    return active

"""Layer-selection policies for LeZO (counterpart of
``repro/core/selection.py``): the paper's uniform policy and the two
ablations, ``round_robin`` (a rotating window, no RNG) and ``weighted``
(Gumbel top-k on log-weights), with :func:`make_policy` over the three.

A policy returns a boolean ``active`` mask of shape (num_layers,): True
means the layer is perturbed and updated this step.  Masks are pure
functions of the seed (and step), computed on the host as small CPU
tensors; the uint32 ranking bits come from a bijection, so ``argsort``
has no ties and the order equals the reference's.  ``weighted``'s
float32 Gumbel scores can tie, and torch's ``log`` may round an ulp
away from JAX's: a stable argsort breaks ties by index as the
reference's does, so masks differ only at near-ties.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng

_SALT = 0x5E1EC7  # "select"

POLICIES = ("uniform", "round_robin", "weighted")


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


def round_robin_active(step: int, num_layers: int, n_drop: int,
                       stride: int = 1) -> torch.Tensor:
    """Deterministic rotation: a window of ``num_layers - n_drop``
    active layers starting at ``step * stride`` (mod num_layers), in
    the reference's int32 arithmetic."""
    k = num_layers - n_drop
    start = (torch.tensor(step, dtype=torch.int32) * stride) % num_layers
    pos = (torch.arange(num_layers, dtype=torch.int32) - start) % num_layers
    return pos < k


def weighted_active(seed: int, weights, n_drop: int) -> torch.Tensor:
    """Importance-weighted selection by Gumbel top-k: keep the
    ``num_layers - n_drop`` layers of largest ``log(weight) + gumbel``,
    the float32 draw ``-log(-log(u))`` from the seeded ranking bits.
    ``n_drop == num_layers`` gives the empty mask."""
    w = torch.as_tensor(weights, dtype=torch.float32).cpu()
    num_layers = w.shape[0]
    if not 0 <= n_drop <= num_layers:
        raise ValueError(
            f"n_drop must be in [0, {num_layers}], got {n_drop}")
    k = num_layers - n_drop
    if k == 0:
        return torch.zeros((num_layers,), dtype=torch.bool)
    if n_drop == 0:
        return torch.ones((num_layers,), dtype=torch.bool)
    bits = rank_bits(rng.fold_py(seed, _SALT + 1), num_layers)
    u = torch.clamp((bits >> 8).to(torch.float32) / 16777216.0,
                    1e-7, 1.0 - 1e-7)
    gumbel = -torch.log(-torch.log(u))
    score = torch.log(torch.clamp(w, min=1e-9)) + gumbel
    order = torch.argsort(-score, stable=True)
    active = torch.zeros((num_layers,), dtype=torch.bool)
    active[order[:k]] = True
    return active


def make_policy(name: str, num_layers: int, n_drop: int):
    """``fn(seed, step, weights=None) -> active mask`` for ``name``."""
    if name == "uniform":
        return lambda seed, step, weights=None: uniform_active(
            seed, num_layers, n_drop)
    if name == "round_robin":
        return lambda seed, step, weights=None: round_robin_active(
            step, num_layers, n_drop)
    if name == "weighted":
        return lambda seed, step, weights=None: weighted_active(
            seed, weights, n_drop)
    raise ValueError(f"unknown policy {name!r}; pick from {POLICIES}")

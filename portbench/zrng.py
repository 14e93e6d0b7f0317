"""The benchmark's frozen copy of the ZO algorithm's random streams.

Copied once from the z contract (``src/repro_torch/csrc/rng.cuh``, the
plain expression its kernels are proved bit-identical to) and from
LeZO's stratified layer selection, so that the reference and the work
counters draw what the algorithm defines without importing the program:

    z[l, i] = counter_normal(fold(fold(step_seed, leaf_uid(path)), l), i)

with ``l`` the layer of a leaf stacked over layers (0 for an unstacked
leaf) and ``i`` the flat index of the element within the layer.  The
uint32 arithmetic runs in int64 masked to 32 bits, which is exact on the
CPU and on the card alike.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
M1 = 0x7FEB352D
M2 = 0x846CA68B
S2 = 0x85EBCA6B
TWO_PI = float(np.float32(2.0 * math.pi))
INV_2_24 = 1.0 / 16777216.0
Z_CHUNK = 1 << 24          # elements of z drawn at once


def fold(seed: int, data: int) -> int:
    """A new uint32 seed from (seed, data); order matters."""
    x = (seed * GOLDEN + data + M2) & MASK32
    x ^= x >> 16
    x = (x * M1) & MASK32
    x ^= x >> 15
    x = (x * M2) & MASK32
    x ^= x >> 16
    return x


def leaf_uid(path: str) -> int:
    """FNV-1a of a leaf's path: the key of its z stream."""
    h = 2166136261
    for ch in path.encode():
        h = ((h ^ ch) * 16777619) & MASK32
    return h


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * M1) & MASK32
    x = x ^ (x >> 15)
    x = (x * M2) & MASK32
    return x ^ (x >> 16)


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    return ((bits >> 8).to(torch.float32) + 1.0) * INV_2_24


def counter_normal(seed: int, counters: torch.Tensor) -> torch.Tensor:
    """Standard normals (float32), one for each int64 counter."""
    c = counters & MASK32
    h1 = _mix32((c * GOLDEN + seed) & MASK32)
    h2 = _mix32((((c + S2) & MASK32) * GOLDEN + (seed ^ S2)) & MASK32)
    r = torch.sqrt(-2.0 * torch.log(_uniform01(h1)))
    return r * torch.cos(TWO_PI * _uniform01(h2))


def layer_z(step_seed: int, path: str, layer: int, n: int,
            device) -> torch.Tensor:
    """z of one layer (one row) of a leaf: ``n`` float32 normals."""
    seed = fold(fold(step_seed, leaf_uid(path)), layer)
    out = torch.empty(n, dtype=torch.float32, device=device)
    for c0 in range(0, n, Z_CHUNK):
        c1 = min(n, c0 + Z_CHUNK)
        out[c0:c1] = counter_normal(seed, torch.arange(
            c0, c1, dtype=torch.int64, device=device))
    return out


# ------------------------------------------------------------ selection
def group_of(path: str):
    """The LeZO layer group of a leaf (``s{i}.b{j}`` for a leaf stacked
    over a stage's layers), None for a leaf that is always perturbed."""
    if path.startswith("stages/"):
        parts = path.split("/")
        return f"{parts[1]}.{parts[2]}"
    return None


def groups(leaves):
    """{group: layers} over ``leaves`` [(path, shape, dtype)], sorted by
    group name; the global layer index runs through them in that order."""
    sizes = {}
    for path, shape, _ in leaves:
        g = group_of(path)
        if g is not None:
            sizes[g] = shape[0]
    return dict(sorted(sizes.items()))


def quotas(sizes, n_drop: int):
    """Largest-remainder apportionment of ``n_drop`` over the groups."""
    total = sum(sizes.values())
    if not 0 <= n_drop < total:
        raise ValueError(f"n_drop {n_drop} not in [0, {total})")
    exact = {g: n_drop * L / total for g, L in sizes.items()}
    base = {g: min(int(e), sizes[g]) for g, e in exact.items()}
    order = sorted(exact, key=lambda g: exact[g] - base[g], reverse=True)
    i = 0
    while sum(base.values()) < n_drop:
        g = order[i % len(order)]
        if base[g] < sizes[g]:
            base[g] += 1
        i += 1
    return base


def select(sizes, step_seed: int, n_drop: int):
    """{group: sorted list of active layers} for one step: in each group
    the layers ranked by ``mix32(id * GOLDEN + fold(seed, uid("sel/"+g)))``,
    the group's quota of lowest ranks dropped."""
    q = quotas(sizes, n_drop)
    out = {}
    for g, L in sizes.items():
        gseed = fold(step_seed, leaf_uid("sel/" + g))
        ids = torch.arange(L, dtype=torch.int64)
        bits = _mix32((ids * GOLDEN + gseed) & MASK32)
        order = torch.argsort(bits)
        out[g] = sorted(order[q[g]:].tolist())
    return out


def step_seed(base: int, t: int) -> int:
    return fold(base, t)

"""Counter-based RNG (counterpart of ``repro/core/rng.py``).

``z`` is a pure function of ``(seed, element index)``::

    z[l, i] = counter_normal(fold(leaf_seed, l), i)

with the reference's constants, so the port draws the reference's z.
Integer results (``mix32``, ``fold``, ``leaf_uid``) match bit for bit;
normals match within a few ulp, because ``log``/``cos`` round differently
across frameworks.

PyTorch on the CPU has no uint32 add or right shift, so the uint32 math
runs in int64 masked to 32 bits, masking after every multiply and before
every shift.  An int64 product of two 32-bit words may wrap; the low 32
bits survive the wrap, which is all the mask keeps.  The same code runs
on CUDA tensors; the kernels carry their own native-uint32 copy in
``csrc/rng.cuh``.

Every ``fold`` and ``fold_py`` counts one ``rng_folds`` on the current
tracer (``obs.trace``; free when it is the disabled one).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.obs import trace as obs

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
M1 = 0x7FEB352D
M2 = 0x846CA68B
S2 = 0x85EBCA6B
TWO_PI = float(np.float32(2.0 * math.pi))
INV_2_24 = 1.0 / 16777216.0


def _u32(x, device=None) -> torch.Tensor:
    """Any int / array / tensor -> int64 tensor holding uint32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(np.asarray(x, np.int64) & MASK32,
                           dtype=torch.int64, device=device)


def mix32(x) -> torch.Tensor:
    """Murmur3-style avalanche over uint32 values (int64 carrier)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = (x * M1) & MASK32
    x = x ^ (x >> 15)
    x = (x * M2) & MASK32
    x = x ^ (x >> 16)
    return x


def fold(seed, data) -> torch.Tensor:
    """Derive a new uint32 seed from (seed, data) — order matters."""
    obs.get_tracer().count(obs.CTR_RNG_FOLDS)
    seed = _u32(seed)
    data = _u32(data, seed.device)
    return mix32((seed * GOLDEN + data + M2) & MASK32)


def fold_py(seed: int, data: int) -> int:
    """Python-int version of :func:`fold` (counted as one fold)."""
    obs.get_tracer().count(obs.CTR_RNG_FOLDS)
    x = (seed * GOLDEN + data + M2) & MASK32
    x ^= x >> 16
    x = (x * M1) & MASK32
    x ^= x >> 15
    x = (x * M2) & MASK32
    x ^= x >> 16
    return x


def _uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in (0, 1]; never 0 so log() is safe."""
    return ((bits >> 8).to(torch.float32) + 1.0) * INV_2_24


def counter_normal(seed, counters) -> torch.Tensor:
    """Standard normals (float32), one per counter.  ``seed`` is an int
    or an int tensor broadcastable against ``counters``."""
    c = _u32(counters)
    s = _u32(seed, c.device)
    h1 = mix32((c * GOLDEN + s) & MASK32)
    h2 = mix32((((c + S2) & MASK32) * GOLDEN + (s ^ S2)) & MASK32)
    u1 = _uniform01(h1)
    u2 = _uniform01(h2)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(TWO_PI * u2)


def leaf_uid(path: str) -> int:
    """Stable uint32 id for a parameter leaf from its tree path string."""
    h = 2166136261  # FNV-1a
    for ch in path.encode():
        h = ((h ^ ch) * 16777619) & MASK32
    return h

"""The benchmark's weights, made on the device from ``--seed``.

Both sides take the same weights: the harness builds the program's
parameters with :func:`make_row`, and the reference makes them again,
a layer at a time, with the same function.  Each (leaf, layer) row is
drawn from a generator of its own, seeded by ``(seed, path, layer)``,
so a row is the same whichever rows are made with it and in what order.

Draws are normals in the leaf's dtype, scaled by a rule on the leaf's
path and shape: norm scales ``1 + 0.02 n``,
biases and embeddings ``0.02 n``, a matrix ``n / sqrt(fan_in)`` with
``fan_in`` the second-to-last size of its row.
"""
from __future__ import annotations

import math

import torch

from portbench import zrng

WEIGHT_SALT = 0x5EED


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def row_shape(path: str, shape):
    """The shape of one row: a stacked leaf's layer, or the whole leaf."""
    return tuple(shape[1:]) if zrng.group_of(path) else tuple(shape)


def rows(path: str, shape) -> int:
    return shape[0] if zrng.group_of(path) else 1


def _law(path: str, rshape):
    """(mean, std) of a row's entries."""
    name = path.rsplit("/", 1)[-1]
    if name == "scale":
        return 1.0, 0.02
    if name == "bias" or path.startswith("embed/") or len(rshape) < 2:
        return 0.0, 0.02
    return 0.0, rshape[-2] ** -0.5


def make_row(seed: int, path: str, shape, dtype, layer: int,
             device, out=None) -> torch.Tensor:
    """Row ``layer`` of leaf ``path`` (full shape ``shape``) in
    ``dtype``, drawn in place (into ``out`` when given): no temporary."""
    rshape = row_shape(path, shape)
    gen = torch.Generator(device=device)
    gen.manual_seed(zrng.fold(zrng.fold(zrng.fold(seed, WEIGHT_SALT),
                                        zrng.leaf_uid(path)), layer))
    if out is None:
        out = torch.empty(rshape, dtype=dtype, device=device)
    mean, std = _law(path, rshape)
    return out.normal_(mean, std, generator=gen)


CHUNK = 1 << 24
PROJECTION_SALT = 0x9207


def change(row: torch.Tensor, row0: torch.Tensor, seed: int, path: str,
           layer: int):
    """(||row - row0||, <row - row0, u>) in float64, a chunk at a time:
    how far the row moved, and which way along ``u``, a standard normal
    direction of the row's own drawn from (seed, path, layer).  The
    norm does not change when an update's sign does; the projection
    does."""
    a, b = row.reshape(-1), row0.reshape(-1)
    gen = torch.Generator(device=row.device)
    gen.manual_seed(zrng.fold(zrng.fold(zrng.fold(seed, PROJECTION_SALT),
                                        zrng.leaf_uid(path)), layer))
    sq = torch.zeros((), dtype=torch.float64, device=row.device)
    proj = torch.zeros((), dtype=torch.float64, device=row.device)
    for c0 in range(0, a.numel(), CHUNK):
        d = (a[c0:c0 + CHUNK].to(torch.float32)
             - b[c0:c0 + CHUNK].to(torch.float32))
        sq += torch.sum(d.to(torch.float64) ** 2)
        u = torch.empty_like(d).normal_(generator=gen)
        proj += torch.sum(d * u, dtype=torch.float64)
    return math.sqrt(float(sq)), float(proj)


def make_leaf(seed: int, path: str, shape, dtype, device) -> torch.Tensor:
    """A whole leaf, row by row."""
    t = torch.empty(tuple(shape), dtype=dtype, device=device)
    if zrng.group_of(path):
        for l in range(shape[0]):
            make_row(seed, path, shape, dtype, l, device, out=t[l])
    else:
        make_row(seed, path, shape, dtype, 0, device, out=t)
    return t


def numel_row(path: str, shape) -> int:
    return math.prod(row_shape(path, shape))

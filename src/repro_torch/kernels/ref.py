"""Plain PyTorch axpy (counterpart of ``repro/kernels/ref.py``).

``leaf_normal_nd`` makes z for a leaf in its natural shape: element
(l, i1, ..., ik) has counter = its flat index within layer l and seed
``fold(seed, layer_ids[l])``.  ``zo_axpy_nd`` is the reference's dense
oracle (z for every row, then a select).  ``zo_axpy_2d_`` is the plain
version of kernel K1 (``kernels/zo_axpy.py``): in place over an (L, n)
view, row by row, skipping masked-off rows, in chunks so that a
full-width row never needs int64 counters for all of its elements at
once.  ``zo_axpy_window_`` is the axpy over one shard of a leaf placed
on a mesh: every element draws the z of its *global* index, so the
shards of a leaf together make exactly the unsharded leaf's z.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import rng

CHUNK = 1 << 22


def leaf_normal_nd(seed, shape, layer_ids=None, device=None) -> torch.Tensor:
    """z ~ N(0,1) for an (L, ...) leaf: z[l, i] = f(fold(seed, lid[l]), i)."""
    L = shape[0]
    if layer_ids is None:
        layer_ids = torch.arange(L, device=device)
    seeds = rng.fold(seed, layer_ids.to(device)).reshape(
        (L,) + (1,) * (len(shape) - 1))
    idx = torch.arange(math.prod(shape[1:]), device=device).reshape(shape[1:])
    return rng.counter_normal(seeds, idx)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def zo_axpy_nd(theta, mask, seed, scale, decay, layer_ids=None):
    """decay*theta + scale*z on rows where mask, theta elsewhere (new
    tensor).  theta: (L, ...); mask: (L,) bool or None (all active)."""
    z = leaf_normal_nd(seed, theta.shape, layer_ids, theta.device)
    s, d = _f32(scale).to(theta.device), _f32(decay).to(theta.device)
    y = (d * theta.to(torch.float32) + s * z).to(theta.dtype)
    if mask is None:
        return y
    m = mask.to(theta.device).reshape((-1,) + (1,) * (theta.dim() - 1))
    return torch.where(m, y, theta)


def zo_axpy_2d_(theta, mask, seed: int, scale, decay):
    """In place over theta (L, n): rows where mask get decay*x + scale*z."""
    s, d = _f32(scale).to(theta.device), _f32(decay).to(theta.device)
    n = theta.shape[1]
    rows = torch.nonzero(mask.cpu()).flatten().tolist()
    for r in rows:
        lseed = rng.fold_py(seed, r)
        row = theta[r]
        for c0 in range(0, n, CHUNK):
            c1 = min(n, c0 + CHUNK)
            z = rng.counter_normal(
                lseed, torch.arange(c0, c1, device=theta.device))
            seg = row[c0:c1]
            seg.copy_((d * seg.to(torch.float32) + s * z).to(theta.dtype))
    return theta


def window_counters(offset, lshape, gshape, device=None) -> torch.Tensor:
    """Flat indices within a tensor of shape ``gshape`` of the block of
    shape ``lshape`` at ``offset`` (int64, shape ``lshape``)."""
    idx = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for d in reversed(range(len(gshape))):
        ar = offset[d] + torch.arange(lshape[d], device=device)
        idx = idx + (ar * stride).reshape((-1,) + (1,) * (len(gshape) - 1 - d))
        stride *= gshape[d]
    return idx


def zo_axpy_window_(local, rows, seed: int, scale, decay, offset, gshape):
    """In place over ``local``, the block of a leaf of global shape
    ``gshape`` at ``offset``: ``decay*x + scale*z`` with z of the global
    elements.  ``rows`` (local indices on axis 0) are the layers to
    update, layer ``offset[0] + r`` keyed ``fold(seed, offset[0] + r)``
    with counters within the layer; ``rows=None`` is an unstacked leaf,
    one pseudo-layer 0 with counters over the whole leaf."""
    s, d = _f32(scale).to(local.device), _f32(decay).to(local.device)
    if rows is None:
        z = rng.counter_normal(rng.fold_py(seed, 0), window_counters(
            offset, local.shape, gshape, local.device))
        local.copy_((d * local.to(torch.float32) + s * z).to(local.dtype))
        return local
    idx = window_counters(offset[1:], local.shape[1:], gshape[1:],
                          local.device)
    for r in rows:
        z = rng.counter_normal(rng.fold_py(seed, offset[0] + r), idx)
        row = local[r]
        row.copy_((d * row.to(torch.float32) + s * z).to(local.dtype))
    return local

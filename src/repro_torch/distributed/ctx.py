"""Mesh context for in-model sharding constraints (counterpart of
``repro/distributed/ctx.py``).

Model code is mesh-agnostic: the launcher registers the active
``DeviceMesh`` here and layers call :func:`constrain` on the
intermediates whose layout matters (attention's q/k/v, the MoE dispatch
buffers: without a constraint the reference's partitioner all-gathers
the scatter operand, 80 GiB a step on granite-moe).

``constrain`` is a no-op when no mesh is registered or on a plain
tensor (single-device training, CPU tests), and drops the axes that do
not divide, so the same model code serves every cell of the grid.  On a
DTensor it ``redistribute``s to the reference's spec.
"""
from __future__ import annotations

import torch

_MESH = None


def set_mesh(mesh):
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH


def model_size() -> int:
    """Size of the registered mesh's ``model`` axis; 1 without a mesh."""
    from repro_torch.distributed.sharding import axis_sizes

    return 1 if _MESH is None else axis_sizes(_MESH).get("model", 1)


def spec_for(shape, axes, mesh):
    """The reference's spec for ``axes``: one of None | 'model' | 'batch'
    per dim, an axis dropped where it does not divide its dim."""
    from repro_torch.distributed.sharding import axis_sizes, batch_axes

    sizes = axis_sizes(mesh)
    spec = []
    for d, a in enumerate(axes):
        if a == "batch":
            ba = batch_axes(mesh)
            n = 1
            for ax in ba:
                n *= sizes[ax]
            spec.append(ba if (ba and shape[d] % n == 0 and shape[d] >= n)
                        else None)
        elif a == "model":
            n = sizes.get("model", 1)
            spec.append("model" if (shape[d] % n == 0 and shape[d] >= n)
                        else None)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, *axes):
    """axes: one of None | 'model' | 'batch' per dim of x."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements

    if _MESH is None or not isinstance(x, DTensor):
        return x
    pl = placements(spec_for(x.shape, axes, _MESH), _MESH)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(_MESH, pl)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def tp_apply(fn, x, w):
    """``fn(x_local, w_local, (row0, col0))`` on this rank's block of a
    DTensor weight ``w`` (K, N), Megatron's way (the reference's
    ``shard_map`` layouts): a mesh dim that shards N leaves x whole there
    and shards the output's last dim (column-parallel); one that shards
    K shards x's last dim and leaves partial sums (row-parallel); one
    that replicates W keeps x's batch placement.  x (a plain x counts as
    replicated) is redistributed to that layout first; (row0, col0) is
    the block's global offset in ``w``.  Returns the output DTensor."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)

    from repro_torch.distributed.sharding import (contiguous_stride,
                                                  local_window)

    mesh = w.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    last = x.ndim - 1
    tx, to = [], []
    for wp, xp in zip(w.placements, x.placements):
        if wp == Shard(1):
            tx.append(Replicate()), to.append(Shard(last))
        elif wp == Shard(0):
            tx.append(Shard(last)), to.append(Partial())
        elif isinstance(xp, Shard) and xp.dim != last:
            tx.append(xp), to.append(xp)
        else:
            tx.append(Replicate()), to.append(Replicate())
    x = x.redistribute(mesh, tx)
    _, off = local_window(w.shape, mesh, w.placements)
    out = fn(x.to_local(), w.to_local(), tuple(off))
    shape = (*x.shape[:-1], w.shape[1])
    return DTensor.from_local(out, mesh, to, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def matmul(x, w):
    """``x @ w``; per rank (:func:`tp_apply`) when ``w`` is a DTensor."""
    if is_dtensor(w):
        return tp_apply(lambda a, b, _: a @ b, x, w)
    return x @ w


def _whole(tree):
    """A parameter dict with every DTensor leaf gathered whole (local)."""
    return {k: _whole(v) if isinstance(v, dict) else
            (v.full_tensor() if is_dtensor(v) else v)
            for k, v in tree.items()}


def rowwise(fn, x, params, cache=None):
    """``fn(x_local, params_whole, cache_local) -> (out, new_state)`` per
    rank on the batch rows it holds: x and each cache leaf (this layer's
    (B, ...) views) batch-sharded as the reference's ``constrain(x,
    "batch", ...)`` puts them and whole on ``model``, every weight
    gathered whole.  For blocks DTensor cannot propagate through (the MoE
    dispatch, the recurrent scans): their work is row-local, so a rank
    needs only its rows and the whole weights.  Returns (out, new_state)
    as DTensors, ``new_state`` in each cache leaf's own placements (None
    where ``fn`` returns None)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import placements

    mesh = x.device_mesh

    def rows(t):
        return placements(spec_for(t.shape, ("batch",) + (None,) * (
            t.ndim - 1), mesh), mesh)

    xl = x.redistribute(mesh, rows(x)).to_local()
    cl = None if cache is None else {
        k: t.redistribute(mesh, rows(t)).to_local() for k, t in
        cache.items()}
    out, new = fn(xl, _whole(params), cl)

    def wrap(t, like):
        pl = rows(like)
        return DTensor.from_local(t, mesh, pl, run_check=False,
                                  shape=like.shape, stride=like.stride())
    out = wrap(out, x)
    if new is not None:
        new = {k: wrap(t, cache[k]).redistribute(mesh, cache[k].placements)
               for k, t in new.items()}
    return out, new

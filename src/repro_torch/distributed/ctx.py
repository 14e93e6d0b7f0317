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

The serving arena's page-sharded leaves have no DTensor rule for the
paged engine's flat scatter and page-table gather: :func:`paged_kv` and
:func:`copy_page` run them per rank, on the pages each rank holds, and
combine with one all-reduce whose every element has exactly one
contributor (the others add -0.0, which leaves any value's bits as
they are).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

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
    return {k: _whole(v) if isinstance(v, dict) else whole(v)
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


def whole(x):
    """``x`` as a plain tensor holding all of it (a DTensor gathered)."""
    return x.full_tensor() if is_dtensor(x) else x


def _page_window(leaf, pdim: int):
    """(local tensor, first page, local page count, process group or
    None) of an arena DTensor whose page dim is ``pdim``; the group is
    None where the rank holds every page."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import local_window

    loc = leaf.to_local()
    if loc.shape[pdim] == leaf.shape[pdim]:
        return loc, 0, loc.shape[pdim], None
    mesh = leaf.device_mesh
    mdim = next(i for i, p in enumerate(leaf.placements) if p == Shard(pdim))
    _, off = local_window(leaf.shape, mesh, leaf.placements)
    return loc, off[pdim], loc.shape[pdim], mesh.get_group(mdim)


def paged_kv(leaf, pages, flat, new):
    """Write ``new`` (N, KV, dh) at the flat slots ``flat`` (N,) (page ·
    page_size + offset) of a layer's arena leaf (n_pages, page_size, KV,
    dh) in place, then gather the rows of the page table ``pages`` (B,
    max_pages) in position order: (B, max_pages·page_size, KV, dh).

    On a page-sharded DTensor leaf each rank writes only the slots of
    its own pages, at their local offset, and gathers its own pages'
    rows into a buffer of -0.0; one all-reduce (sum) over the axis that
    shards the pages gives every rank the whole of it, bit for bit.
    Where the rank holds every page (a plain tensor, a replicated leaf)
    it is the plain write and gather."""
    new = whole(new)
    B = pages.shape[0]
    if is_dtensor(leaf):
        loc, p0, n, group = _page_window(leaf, 0)
    else:
        loc, p0, n, group = leaf, 0, leaf.shape[0], None
    psz = loc.shape[1]
    rows = loc.view(n * psz, *loc.shape[2:])
    if group is None:
        rows.index_copy_(0, flat, new)
        return loc[pages].reshape(B, -1, *loc.shape[2:])
    lo = p0 * psz
    mine = (flat >= lo) & (flat < lo + n * psz)
    rows.index_copy_(0, flat[mine] - lo, new[mine])
    idx = pages - p0
    own = (idx >= 0) & (idx < n)
    got = loc[idx.clamp(0, n - 1)]                   # (B, max_pages, psz, ..)
    got = torch.where(own[:, :, None, None, None], got,
                      torch.full((), -0.0, dtype=got.dtype,
                                 device=got.device))
    dist.all_reduce(got, group=group)
    return got.reshape(B, -1, *loc.shape[2:])


def copy_page(leaf, src: int, dst: int):
    """Copy physical page ``src`` into ``dst`` over every layer of an
    arena leaf (R, n_pages, ...), in place (copy-on-write); per rank on
    a page-sharded DTensor leaf, the source page's owner sending it to
    the destination's by one all-reduce."""
    if not is_dtensor(leaf):
        leaf[:, dst].copy_(leaf[:, src])
        return
    loc, p0, n, group = _page_window(leaf, 1)
    if group is None:
        loc[:, dst].copy_(loc[:, src])
        return
    if p0 <= src < p0 + n:
        page = loc[:, src - p0].clone()
    else:
        page = torch.full((loc.shape[0], *loc.shape[2:]), -0.0,
                          dtype=loc.dtype, device=loc.device)
    dist.all_reduce(page, group=group)
    if p0 <= dst < p0 + n:
        loc[:, dst - p0].copy_(page)

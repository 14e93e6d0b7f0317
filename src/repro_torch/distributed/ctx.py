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

Blocks DTensor cannot propagate through (the MoE dispatch, the
recurrent scans) run per rank on the batch rows each rank holds, by one
of two routes, each counted in :data:`ROUTES` by (route, block kind):

  * :func:`tp_block`, the reference's layout: each weight's local shard
    (the MoE experts on d_ff, Mamba on d_inner), the caches as placed,
    the partial sums reduced over ``model`` inside the block (:class:`TP`).
    The MoE and Mamba blocks take it whenever their leaves are sharded
    on ``model`` (:func:`tp_sharded`), on a 1 x 1 mesh too;
  * :func:`rowwise`, every weight gathered whole: mLSTM and sLSTM (their
    block weights are replicated by the rules, so nothing is gathered),
    and an MoE or Mamba block whose widths do not divide the ``model``
    axis (the rules left its leaves replicated).
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist

_MESH = None
ROUTES = collections.Counter()   # (route, block kind) -> calls
F32 = torch.float32


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


def _rows(t, mesh):
    """Placements of ``t`` (B, ...) on its batch rows, as the reference's
    ``constrain(x, "batch", ...)`` puts them: the batch axes shard dim 0
    where B divides them, ``model`` replicates."""
    from repro_torch.distributed.sharding import placements

    return placements(spec_for(t.shape, ("batch",) + (None,) * (t.ndim - 1),
                               mesh), mesh)


def _wrap(t, mesh, pl, like):
    """A local result ``t`` as the DTensor of ``like``'s global shape
    and stride, placed by ``pl``."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, mesh, pl, run_check=False, shape=like.shape,
                              stride=like.stride())


def rowwise(kind, fn, x, params, cache=None):
    """``fn(x_local, params_whole, cache_local) -> (out, new_state)`` per
    rank on the batch rows it holds: x and each cache leaf (this layer's
    (B, ...) views) batch-sharded as the reference's ``constrain(x,
    "batch", ...)`` puts them and whole on ``model``, every weight
    gathered whole.  The route of the blocks whose leaves the rules
    replicate: mLSTM and sLSTM (the gather is then a no-op), and an MoE
    or Mamba block whose widths do not divide the ``model`` axis; the
    MoE and Mamba blocks take :func:`tp_block` otherwise.  Their work is
    row-local, so a rank needs only its rows and the whole weights.
    ``kind`` names the block in :data:`ROUTES`.  Returns (out,
    new_state) as DTensors, ``new_state`` in each cache leaf's own
    placements (None where ``fn`` returns None)."""
    mesh = x.device_mesh
    ROUTES["rowwise", kind] += 1
    xl = x.redistribute(mesh, _rows(x, mesh)).to_local()
    cl = None if cache is None else {
        k: t.redistribute(mesh, _rows(t, mesh)).to_local() for k, t in
        cache.items()}
    out, new = fn(xl, _whole(params), cl)
    out = _wrap(out, mesh, _rows(x, mesh), x)
    if new is not None:
        new = {k: _wrap(t, mesh, _rows(cache[k], mesh), cache[k])
               .redistribute(mesh, cache[k].placements)
               for k, t in new.items()}
    return out, new


class TP:
    """This rank's place on the ``model`` axis inside a block that
    :func:`tp_block` runs per rank: ``n`` ranks in ``group`` (None when
    the rank is alone on it), ``offsets`` the global offset of each
    weight's local shard by its path in the block (``in_proj``,
    ``norm/scale``).  :data:`LOCAL` (no mesh) makes each method the
    identity, so a block's code is the single-device function."""

    def __init__(self, group=None, n: int = 1, offsets=None):
        self.group, self.n, self.offsets = group, n, dict(offsets or {})

    def offset(self, name: str, dim: int) -> int:
        """The global offset of the local shard of leaf ``name`` on
        ``dim`` (0 without a mesh)."""
        off = self.offsets.get(name)
        return 0 if off is None else off[dim]

    def sum(self, t):
        """Partial sums ``t`` added over the ``model`` axis: one
        all-reduce in float32 (``t`` widened first), the total returned
        in ``t``'s dtype (one rounding, for a bf16 ``t``); ``t`` itself
        on a rank alone on the axis."""
        if self.n == 1:
            return t
        import torch.distributed._functional_collectives as fc
        s = fc.wait_tensor(fc.all_reduce(t.to(F32), "sum", self.group))
        return s.to(t.dtype)

    def columns(self, t, parts: int, col0: int):
        """Each of the ``parts`` equal sections of a (..., parts·W)
        activation's last dim, on this rank its 1/n of each: ``t`` is the
        local column block (..., parts·W/n) that starts at global column
        ``col0`` (a weight sharded contiguously on its last dim, as
        ``in_proj``'s (D, 2·Di)), so on 2 ranks rank 0 holds all of
        section 0 and needs half of section 1 from rank 1.  One
        all-to-all over ``model`` moves each element once, to the rank
        whose channels it holds (an all-gather would move n times the
        bytes); on one rank it is ``torch.split``."""
        w = t.shape[-1] // parts
        if self.n == 1:
            return torch.split(t, w, dim=-1)
        import torch.distributed._functional_collectives as fc
        n = self.n
        r = col0 // (parts * w)                     # this rank on the axis
        g = [col0 // w + i for i in range(parts)]   # global chunk indices
        dest = [c % n for c in g]                   # chunk c: piece c % n
        order = sorted(range(parts), key=lambda i: dest[i])
        cf = t.movedim(-1, 0)                       # channels first
        send = torch.cat([cf[i * w:(i + 1) * w] for i in order])
        src = [(p * n + r) // parts for p in range(parts)]
        got = fc.wait_tensor(fc.all_to_all_single(
            send, [w * src.count(s) for s in range(n)],
            [w * dest.count(d) for d in range(n)], self.group))
        return tuple(got[p * w:(p + 1) * w].movedim(0, -1)
                     for p in range(parts))


LOCAL = TP()


def _model_dim(mesh):
    names = tuple(mesh.mesh_dim_names)
    return names.index("model") if "model" in names else None


def tp_sharded(params, cache=None) -> bool:
    """True when every leaf of a block's ``params`` that the rules put on
    ``model`` (``sharding._COL``/``_ROW``), and every leaf of its
    ``cache``, is a DTensor sharded on that axis: the block can run per
    rank on its shards (:func:`tp_block`).  False where a width did not
    divide the axis (the rules replicated the leaf) or the mesh has no
    ``model`` axis."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed.sharding import _COL, _ROW

    leaves = [t for k, t in params.items() if k in _COL or k in _ROW]
    for t in leaves + list((cache or {}).values()):
        mi = _model_dim(t.device_mesh)
        if mi is None or not isinstance(t.placements[mi], Shard):
            return False
    return True


def tp_block(kind, fn, x, params, cache=None):
    """``fn(x_local, params_local, cache_local, tp) -> (out, new_state)``
    per rank, the reference's tensor-parallel layout inside one block:
    x on this rank's batch rows and whole on ``model`` (as
    :func:`rowwise` puts it); each weight's **local** shard
    (``to_local()``, never gathered), with its global offset in
    ``tp.offsets``; each cache leaf (this layer's (B, ...) views) in the
    placements ``cache_pspec`` gave it, not redistributed; ``tp``
    (:class:`TP`) the ``model`` group, whose collectives ``fn`` calls
    where the reference's partitioner reduces.  Those are, by block:

      * MoE: ``we_d``'s partial ``o`` (B_rows, E, C, D) and the shared
        experts' ``ws_d`` partial (B_rows, S, D), each one float32
        all-reduce (the reference's ``preferred_element_type=F32``);
      * Mamba: the (B_rows, S, 2·Di/n) ``in_proj`` output re-split by
        one all-to-all (:meth:`TP.columns`), ``x_proj``'s partial
        (B_rows, S, R + 2·St) and ``out_proj``'s (B_rows, S, D) each one
        all-reduce summed in float32 and rounded once to the model dtype
        (the reference's dots emit the model dtype).

    ``out`` comes back all-reduced, so it is returned on x's batch rows,
    replicated on ``model``; ``new_state`` in each cache leaf's own
    placements.  ``kind`` names the block in :data:`ROUTES`."""
    from repro_torch.distributed.sharding import local_window

    mesh = x.device_mesh
    ROUTES["tp", kind] += 1
    mi = _model_dim(mesh)
    n = 1 if mi is None else mesh.size(mi)
    rows = _rows(x, mesh)
    offsets = {}

    def local(path, t):
        if isinstance(t, dict):
            return {k: local(f"{path}{k}/" if isinstance(v, dict)
                             else f"{path}{k}", v) for k, v in t.items()}
        if not is_dtensor(t):
            return t
        offsets[path] = tuple(local_window(t.shape, mesh, t.placements)[1])
        return t.to_local()

    pl = local("", params)
    cl = None if cache is None else {k: t.to_local()
                                     for k, t in cache.items()}
    tp = TP(mesh.get_group(mi) if n > 1 else None, n, offsets)
    out, new = fn(x.redistribute(mesh, rows).to_local(), pl, cl, tp)
    out = _wrap(out, mesh, rows, x)
    if new is not None:
        new = {k: _wrap(t, mesh, cache[k].placements, cache[k])
               for k, t in new.items()}
    return out, new


def write_seq(leaf, start: int, new):
    """``leaf[:, start:start + S] = new``, in place, for a lockstep cache
    leaf (B, Smax, ...) and ``new`` (B, S, ...).  On a DTensor leaf (its
    sequence dim on ``model`` by ``cache_pspec``) each rank writes the
    positions its shard holds, ``new`` brought to the leaf's batch rows
    and whole on the sequence first: DTensor's own slice assignment on
    a sharded dim writes into a gathered temporary and drops it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import local_window

    S = new.shape[1]
    if not is_dtensor(leaf):
        leaf[:, start:start + S] = new
        return
    mesh, pl = leaf.device_mesh, leaf.placements
    if not is_dtensor(new):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    new = new.redistribute(mesh, [Replicate() if p == Shard(1) else p
                                  for p in pl]).to_local()
    n, off = local_window(leaf.shape, mesh, pl)
    lo, hi = max(start, off[1]), min(start + S, off[1] + n[1])
    if lo < hi:
        leaf.to_local()[:, lo - off[1]:hi - off[1]] = new[:, lo - start:
                                                         hi - start]


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

"""Per-shard invocation of the fused kernels under a mesh (counterpart
of ``repro/fused/sharded.py``).

The counter RNG makes z a pure function of the *global* (row, col) index
of each weight element, so a shard makes exactly its slice of z by
offsetting the kernel's counter window: no communication.  These
functions bind that contract to the two layouts
``distributed/sharding.py`` gives the dense projections:

  * column-parallel (wq/wk/wv/wg/wu/wi): W sharded on its last dim, x
    replicated on ``axis``: each shard passes ``col_off = rank·N/n`` and
    the full row length ``ld = N``; outputs concatenate along N.
  * row-parallel (wo/wd): W sharded on its first dim, x sharded on its
    last: each shard passes ``row_off = rank·K/n``; partial products
    all-reduce.

Both run ``local_map`` over the mesh (the reference's ``shard_map``):
K4 on the card, its plain version on the CPU.  ``x`` and ``w`` are full
tensors (the same on every rank) or DTensors placed as above.
"""
from __future__ import annotations


from repro_torch.fused.matmul import pmatmul


def _placed(t, mesh, pl):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import distribute
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    return distribute(t, mesh, pl)


def _axis_index(mesh, axis) -> int:
    return mesh.get_local_rank(axis)


def pmatmul_col_sharded(mesh, x, w, seed, scale, active, *, axis="model"):
    """Column-parallel fused matmul: w (K, N) sharded on N over ``axis``,
    x replicated, output sharded on its last dim (a DTensor)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    N = w.shape[1]
    shard_n = N // mesh.size(mesh.mesh_dim_names.index(axis))
    dim = mesh.mesh_dim_names.index(axis)
    rep = [Replicate()] * mesh.ndim
    w_pl = list(rep)
    w_pl[dim] = Shard(1)
    out_pl = list(rep)
    out_pl[dim] = Shard(x.ndim - 1)

    def local(x_, w_):
        c0 = _axis_index(mesh, axis) * shard_n
        return pmatmul(x_, w_, seed, scale, active, col_off=c0, ld=N)

    return local_map(local, out_placements=out_pl,
                     in_placements=(rep, w_pl), device_mesh=mesh)(
        _placed(x, mesh, rep), _placed(w, mesh, w_pl))


def pmatmul_row_sharded(mesh, x, w, seed, scale, active, *, axis="model"):
    """Row-parallel fused matmul: w (K, N) sharded on K over ``axis``,
    x sharded on its last dim, partial products all-reduced (a
    replicated DTensor)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    K, N = w.shape
    dim = mesh.mesh_dim_names.index(axis)
    shard_k = K // mesh.size(dim)
    rep = [Replicate()] * mesh.ndim
    w_pl, x_pl, out_pl = list(rep), list(rep), list(rep)
    w_pl[dim], x_pl[dim], out_pl[dim] = Shard(0), Shard(x.ndim - 1), \
        Partial()

    def local(x_, w_):
        r0 = _axis_index(mesh, axis) * shard_k
        return pmatmul(x_, w_, seed, scale, active, row_off=r0, ld=N)

    part = local_map(local, out_placements=out_pl,
                     in_placements=(x_pl, w_pl), device_mesh=mesh)(
        _placed(x, mesh, x_pl), _placed(w, mesh, w_pl))
    return part.redistribute(mesh, rep)

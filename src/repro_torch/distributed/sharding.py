"""Sharding rules: parameter, activation and cache placement per arch
(counterpart of ``repro/distributed/sharding.py``).

Layout (Megatron-style TP on the ``model`` axis, batch on ``data`` and,
multi-pod, ``pod``):

  * embeddings: vocab-sharded; LM head: vocab-sharded output.
  * attention/MLA: column-parallel QKV (heads on model), row-parallel
    output projection.
  * FFN / MoE experts: column-parallel up/gate, row-parallel down.
    Experts are TP-sharded on d_ff, not expert-sharded.
  * mamba: column-parallel in_proj (d_inner on model), channel-sharded
    conv/ssm params, row-parallel out_proj.
  * mLSTM/sLSTM: replicated block weights (their q/k/v maps contract the
    full d_inner).
  * KV caches: batch on data(+pod), *sequence* on model.

Every rule is divisibility-checked against the mesh: a dimension that
does not divide falls back to replication, so the one rule table serves
every (arch x mesh) cell.

A spec is a plain tuple with one entry a dim: ``None``, an axis name, or
a tuple of axis names (the reference's ``PartitionSpec`` entries).
:func:`placements` maps it onto DTensor placements of a
``DeviceMesh``; ``params_sharding`` / ``cache_sharding`` /
``batch_sharding`` / ``arena_sharding`` place every leaf.  A leaf's
local shard is its slice of the full tensor each rank already holds
(the seeded weights are the same on every rank), so placing moves no
data.  A mesh is anything with
``mesh_dim_names`` and ``shape`` (a ``DeviceMesh``) or with
``axis_names`` and a ``shape`` dict (a shape-only stand-in).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

# leaf name -> which dim (negative, from the end) is sharded on `model`
_COL = {"wq": -1, "wk": -1, "wv": -1, "wg": -1, "wu": -1, "wi": -1,
        "ws_g": -1, "ws_u": -1, "in_proj": -1, "dt_w": -1, "conv_w": -1,
        "conv_b": -1, "Dskip": -1, "wuk": -1, "wuv": -1, "we_g": -1,
        "we_u": -1, "dt_b": -1}
_ROW = {"wo": -2, "wd": -2, "ws_d": -2, "out_proj": -2, "x_proj": -2,
        "A_log": -2, "we_d": -2}
_REPL = {"norm", "scale", "bias", "router", "wdkv", "kv_norm", "q_norm",
         "k_norm", "b_i", "b_f", "b", "rh", "out_norm", "A", "B"}

Spec = Tuple


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a shape-only mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def batch_axes(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _nbatch(mesh) -> int:
    sizes, n = axis_sizes(mesh), 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    return n


def _div(shape, dim, mesh, axis="model"):
    n = axis_sizes(mesh)[axis]
    d = dim if dim >= 0 else len(shape) + dim
    return 0 <= d < len(shape) and shape[d] % n == 0 and shape[d] >= n


def _block_kind(cfg, path_parts):
    si = int(path_parts[1][1:])
    bj = int(path_parts[2][1:])
    return cfg.stages[si].pattern[bj].kind


def _on(nd: int, dim: int, axis="model") -> Spec:
    return tuple(axis if i == dim else None for i in range(nd))


def param_pspec(cfg, path: str, shape, mesh) -> Spec:
    parts = path.split("/")
    name = parts[-1]
    nd = len(shape)
    repl = (None,) * nd
    if parts[0] == "embed":
        if name == "tok" and _div(shape, 0, mesh):
            return _on(nd, 0)
        return repl
    if parts[0] == "head":
        if _div(shape, -1, mesh):
            return _on(nd, nd - 1)
        return repl
    if parts[0] != "stages":
        return repl
    kind = _block_kind(cfg, parts)
    if kind in ("mlstm", "slstm") and parts[3] == "mix":
        return repl                       # replicated recurrent blocks
    if name in ("pk", "pv"):              # prefix KV: heads dim is -2
        if _div(shape, -2, mesh):
            return _on(nd, nd - 2)
        return repl
    if name in _COL and _div(shape, _COL[name], mesh):
        return _on(nd, nd + _COL[name])
    if name in _ROW and _div(shape, _ROW[name], mesh):
        return _on(nd, nd + _ROW[name])
    return repl


def cache_pspec(path: str, shape, mesh) -> Spec:
    """Decode/prefill cache leaves: (R, B, ...) — see module docstring."""
    name = path.split("/")[-1]
    nd = len(shape)
    ba = batch_axes(mesh)
    nb = _nbatch(mesh)
    b_ax = ba if (shape[1] % nb == 0 and shape[1] >= nb) else None
    spec = [None, b_ax] + [None] * (nd - 2)
    if name in ("k", "v", "ckv", "kr") and _div(shape, 2, mesh):
        spec[2] = "model"                       # sequence dim
    elif name == "conv" and _div(shape, 3, mesh):
        spec[3] = "model"                       # channels
    elif name == "ssm" and _div(shape, 2, mesh):
        spec[2] = "model"                       # d_inner
    elif name in ("C", "n", "c", "h", "m") and nd >= 3 and _div(shape, -1,
                                                                 mesh):
        spec[-1] = "model"                      # head dim of lstm states
    return tuple(spec)


def arena_pspec(path: str, shape, mesh) -> Spec:
    """Serving KV-arena leaves (R, n_pages, page_size, KV, dh): the *page*
    dim on ``model`` (pages are position-order sequence slabs), no batch
    axis; replication where the page count does not divide."""
    name = path.split("/")[-1]
    spec = [None] * len(shape)
    if name in ("k", "v") and _div(shape, 1, mesh):
        spec[1] = "model"
    return tuple(spec)


def data_pspec(shape, mesh) -> Spec:
    ba = batch_axes(mesh)
    nb = _nbatch(mesh)
    lead = ba if (shape[0] % nb == 0 and shape[0] >= nb) else None
    return (lead,) + (None,) * (len(shape) - 1)


# ------------------------------------------------------------ placement
def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: mesh dim ``i``
    shards the tensor dim whose entry names its axis, else replicates.
    A tuple entry shards one dim over several axes, major to minor in
    mesh order, as the reference's ``PartitionSpec`` does."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def local_window(shape, mesh, pl):
    """(local shape, global offset) of this rank's shard of a tensor of
    global ``shape`` placed by ``pl``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    return compute_local_shape_and_global_offset(tuple(shape), mesh, pl)


def contiguous_stride(shape) -> tuple:
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def distribute(t: torch.Tensor, mesh, pl):
    """``t`` (the full tensor, the same on every rank) as a DTensor of
    placements ``pl``: this rank's slice, contiguous (a view of ``t`` when
    the slice is all of it)."""
    from torch.distributed.tensor import DTensor

    lshape, off = local_window(t.shape, mesh, pl)
    local = t
    for d, (n, o) in enumerate(zip(lshape, off)):
        if n != t.shape[d]:
            local = local.narrow(d, o, n)
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def _param_leaves(params):
    """(path, owning module, attribute name, tensor) for every leaf of a
    parameter tree, ``named_parameters()`` with ``.`` read as ``/``."""
    for prefix, mod in params.named_modules():
        for k, p in mod._parameters.items():
            yield f"{prefix}.{k}".lstrip(".").replace(".", "/"), mod, k, p


def param_pspecs(cfg, params, mesh) -> Dict[str, Spec]:
    return {path: param_pspec(cfg, path, tuple(p.shape), mesh)
            for path, _, _, p in _param_leaves(params)}


def params_sharding(cfg, params, mesh):
    """Place every leaf of ``params`` (an ``LM``) on ``mesh`` in place, by
    :func:`param_pspec`; returns ``params``."""
    for path, mod, k, p in _param_leaves(params):
        pl = placements(param_pspec(cfg, path, tuple(p.shape), mesh), mesh)
        mod._parameters[k] = torch.nn.Parameter(
            distribute(p.data, mesh, pl), requires_grad=False)
    return params


def _map_tree(fn, tree, prefix=""):
    return {k: (_map_tree(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
                else fn(f"{prefix}{k}", v))
            for k, v in tree.items()}


def cache_sharding(caches, mesh):
    """A cache tree (``lm.init_cache``) as DTensors by :func:`cache_pspec`."""
    return _map_tree(lambda ps, t: distribute(
        t, mesh, placements(cache_pspec(ps, t.shape, mesh), mesh)), caches)


def arena_sharding(arena, mesh):
    """A serving KV arena (``lm.init_paged_cache``) as DTensors by
    :func:`arena_pspec`: the page dim on ``model`` where the page count
    divides it, else replicated."""
    return _map_tree(lambda ps, t: distribute(
        t, mesh, placements(arena_pspec(ps, t.shape, mesh), mesh)), arena)


def batch_sharding(batch, mesh):
    """A batch dict as DTensors by :func:`data_pspec`."""
    return _map_tree(lambda ps, t: distribute(
        t, mesh, placements(data_pspec(t.shape, mesh), mesh)), batch)

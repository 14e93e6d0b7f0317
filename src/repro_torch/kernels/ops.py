"""Backend dispatch for the ZO axpy (counterpart of
``repro/kernels/ops.py``).  Every backend updates the leaf in place and
draws the same z, keyed by (seed, leaf uid, global layer id):

  * ``dense``  — z for every row (dropped ones too), then a select: the
                 reference's plain XLA pass.
  * ``scan``   — row by row, dropped rows skipped (the reference's
                 ``lax.cond`` per layer).
  * ``gather`` — only the rows listed in ``active_idx``.
  * ``pallas`` — kernel K1 (``kernels/zo_axpy.py``).  Unstacked leaves go
                 through K1 as one row with mask ``[True]``: the seed is
                 ``fold(leaf_seed, 0)`` and the counter the flat index,
                 which is the z of the reference's single pseudo-layer.
                 So no plain axpy runs on the card's main path.

A leaf placed on a mesh (a DTensor) is updated shard by shard, each on
its ``to_local()`` block with the z of its global elements.  Where the
block holds whole rows (every leaf on a 1 x 1 mesh, a replicated leaf)
it takes the path above as it is; any other block takes the plain
windowed axpy (``kernels/ref.py::zo_axpy_window_``), except under the
``pallas`` backend on the card, where K1 cannot address the block's
counter window and the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng
from repro_torch.distributed.ctx import is_dtensor
from repro_torch.kernels import ref as kref
from repro_torch.kernels import zo_axpy as kzo

BACKENDS = ("dense", "scan", "gather", "pallas")


def zo_axpy_(theta, *, path: str, seed: int, scale, decay=1.0, mask=None,
             active_idx=None, backend="dense"):
    """``theta <- decay*theta + scale*z`` on a parameter leaf, in place.

    theta is stacked over layers on axis 0 iff ``mask`` is given.
    ``path`` keys the leaf's z stream; ``active_idx`` (the active rows)
    is required by the gather backend.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
    if is_dtensor(theta):
        return _zo_axpy_shard_(theta, path=path, seed=seed, scale=scale,
                               decay=decay, mask=mask,
                               active_idx=active_idx, backend=backend)
    leaf_seed = rng.fold_py(seed, rng.leaf_uid(path))
    if mask is None:
        view = theta.view(1, -1)
        if backend == "pallas":
            ones = torch.ones((1,), dtype=torch.bool)
            kzo.zo_axpy_2d_(view, ones, leaf_seed, scale, decay)
        else:
            view.copy_(kref.zo_axpy_nd(view, None, leaf_seed, scale, decay))
        return theta
    view = theta.view(theta.shape[0], -1)
    if backend == "dense":
        view.copy_(kref.zo_axpy_nd(view, mask, leaf_seed, scale, decay))
    elif backend == "scan":
        kref.zo_axpy_2d_(view, mask, leaf_seed, scale, decay)
    elif backend == "gather":
        if active_idx is None:
            raise ValueError("gather backend needs active_idx")
        idx = active_idx.to(theta.device)
        rows = view[idx]
        view[idx] = kref.zo_axpy_nd(rows, None, leaf_seed, scale, decay,
                                    layer_ids=idx)
    else:
        kzo.zo_axpy_2d_(view, mask, leaf_seed, scale, decay)
    return theta


def _zo_axpy_shard_(theta, *, path, seed, scale, decay, mask, active_idx,
                    backend):
    """:func:`zo_axpy_` on this rank's block of a DTensor leaf."""
    from repro_torch.distributed.sharding import local_window

    local = theta.to_local()
    gshape = tuple(theta.shape)
    lshape, off = local_window(gshape, theta.device_mesh, theta.placements)
    whole = 0 if mask is None else 1    # dims from here on must be whole
    if (all(o == 0 for o in off[whole:]) and tuple(lshape[whole:])
            == gshape[whole:] and (mask is None or lshape[0] == gshape[0])):
        zo_axpy_(local, path=path, seed=seed, scale=scale, decay=decay,
                 mask=mask, active_idx=active_idx, backend=backend)
        return theta
    if local.device.type == "cuda" and backend == "pallas":
        raise ValueError(
            f"K1 cannot address the counter window of {path}'s shard "
            f"{tuple(lshape)} at {tuple(off)} of {gshape}: it draws each "
            "row from counter 0")
    leaf_seed = rng.fold_py(seed, rng.leaf_uid(path))
    rows = None
    if mask is not None:
        on = torch.nonzero(mask.cpu()).flatten().tolist()
        rows = [g - off[0] for g in on if off[0] <= g < off[0] + lshape[0]]
    kref.zo_axpy_window_(local, rows, leaf_seed, scale, decay, off, gshape)
    return theta

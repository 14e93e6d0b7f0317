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
"""
from __future__ import annotations

import torch

from repro_torch.core import rng
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

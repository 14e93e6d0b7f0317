"""Plain PyTorch versions of the virtual-perturbation forward
(counterpart of ``repro/fused/ref.py``).

Virtual perturbation evaluates ``loss(theta + s*eps*z)`` without writing
``theta + s*eps*z`` into the parameters: every weight consumer makes its
slice of z from the counter RNG, with the streams of the axpy sweeps
(``kernels/ops.py``)::

    leaf_seed  = fold(step_seed, leaf_uid(path))
    layer_seed = fold(leaf_seed, l)                 # l = 0 for unstacked
    z[i, ...]  = counter_normal(layer_seed, flat_index_within_layer)

Seeds are host ints and LeZO predicates host bools, so an inactive layer
takes the plain product directly: ``w + 0*z`` rounds back to ``w``
exactly, which is what the reference computes there.  The stacked
(``*_stack``) forms evaluate each probe exactly as the single-probe form
does, so a paired forward equals P single-probe forwards bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng

F32 = torch.float32


def layer_seed(step_seed, path: str, layer: int = 0):
    """Per-(leaf, layer) seed; ``step_seed`` an int or a tuple of ints."""
    if isinstance(step_seed, tuple):
        return tuple(layer_seed(s, path, layer) for s in step_seed)
    return rng.fold_py(rng.fold_py(step_seed, rng.leaf_uid(path)), layer)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=F32)


def zmat(seed: int, m: int, n: int, *, row0=0, col0=0, ld=None,
         trans=False, device=None) -> torch.Tensor:
    """z for an (m, n) window of a stored weight matrix.  Window element
    (i, j) has counter ``(row0+i)*ld + (col0+j)``, or through a transpose
    of the stored leaf (``trans``) ``(col0+j)*ld + (row0+i)``; uint32
    wrap-around as in the reference."""
    rows = (row0 + torch.arange(m, device=device))[:, None] & rng.MASK32
    cols = (col0 + torch.arange(n, device=device))[None, :] & rng.MASK32
    if trans:
        idx = cols * (m if ld is None else ld) + rows
    else:
        idx = rows * (n if ld is None else ld) + cols
    return rng.counter_normal(seed, idx & rng.MASK32)


def _perturbed(w, z, scale):
    return (w.to(F32) + _f32(scale).to(w.device) * z).to(w.dtype)


def pvec(w, seed: int, scale, active=True):
    """Virtually perturbed small leaf (norm scale/bias): ``w + scale*z``
    rounded to ``w.dtype``, as the materialized axpy writes it."""
    if not active:
        return w
    z = rng.counter_normal(seed, torch.arange(w.numel(), device=w.device)
                           ).reshape(w.shape)
    return _perturbed(w, z, scale)


def pvec_stack(w, seeds, scales, active):
    """P stacked perturbed views of a vector-sized leaf: (P, *w.shape)."""
    return torch.stack([pvec(w, s, c, a)
                        for s, c, a in zip(seeds, scales, active)])


def pmatmul(x, w, seed: int, scale, active=True, *, trans=False, ld=None,
            row_off=0, col_off=0):
    """``x @ (w + scale*z)``, the plain version of kernel K4.
    ``w``: (K, N), possibly a transposed view of the stored leaf."""
    if not active:
        return x @ w
    z = zmat(seed, w.shape[0], w.shape[1], row0=row_off, col0=col_off,
             ld=ld, trans=trans, device=w.device)
    return x @ _perturbed(w, z, scale)


def pmatmul_stack(x, w, seeds, scales, active, *, trans=False, ld=None,
                  row_off=0, col_off=0):
    """P stacked probes ``x[p] @ (w + scales[p]*z(seeds[p]))``, the plain
    version of kernel K3.  x: (P, ..., K); seeds/scales/active: length P."""
    return torch.stack([
        pmatmul(x[p], w, seeds[p], scales[p], active[p], trans=trans, ld=ld,
                row_off=row_off, col_off=col_off)
        for p in range(x.shape[0])])


def _embed_z(seed: int, tokens, D: int):
    idx = tokens.to(torch.int64)[..., None] * D + torch.arange(
        D, device=tokens.device)
    return rng.counter_normal(seed, idx)


def pembed(tok_w, tokens, seed: int, scale):
    """Perturbed embedding lookup: gather first, then add z only for the
    looked-up rows."""
    rows = tok_w[tokens]
    return _perturbed(rows, _embed_z(seed, tokens, tok_w.shape[-1]), scale)


def ppos(pos_w, pos: int, S: int, seed: int, scale):
    """Perturbed learned-position rows ``pos_w[pos:pos+S]``."""
    D = pos_w.shape[-1]
    idx = (pos + torch.arange(S, device=pos_w.device))[:, None] * D \
        + torch.arange(D, device=pos_w.device)
    return _perturbed(pos_w[pos:pos + S], rng.counter_normal(seed, idx),
                      scale)


def pembed_stack(tok_w, tokens, seeds, scales):
    """P stacked perturbed embedding lookups: (P, B, S, D).  One gather
    serves every probe; z is made once per distinct seed."""
    rows = tok_w[tokens]
    zs = {s: _embed_z(s, tokens, tok_w.shape[-1]) for s in set(seeds)}
    return torch.stack([_perturbed(rows, zs[s], c)
                        for s, c in zip(seeds, scales)])


def ppos_stack(pos_w, pos: int, S: int, seeds, scales):
    """P stacked perturbed learned-position windows: (P, S, D)."""
    return torch.stack([ppos(pos_w, pos, S, s, c)
                        for s, c in zip(seeds, scales)])

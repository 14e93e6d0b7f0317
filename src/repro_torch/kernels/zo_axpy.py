"""Kernel K1: the fused ZO perturb/update axpy (counterpart of
``repro/kernels/zo_axpy.py``, whose Pallas kernel it replaces).

``zo_axpy_2d_(theta, mask, seed, scale, decay)`` updates an (L, n) leaf
view in place: ``theta <- decay*theta + scale*z(fold(seed, l), i)`` on
rows where ``mask``, untouched elsewhere.  The reference donates and
aliases the buffer (``input_output_aliases``); the port writes into the
parameter's own storage.

On a CUDA tensor the wrapper launches ``csrc/zo_axpy.cu`` (bound on the
H100 by the instructions of z, which it makes in registers; 16-byte
loads and stores; masked-off rows skipped before any work).  On a CPU
tensor it runs the plain version, ``kernels/ref.py::zo_axpy_2d_``.

:func:`counter_normal_parts_check` runs ``csrc/rng_check.cu``: the
kernels' float part of z against the plain versions' expressions on
every one of its 2^24 inputs, on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


counter = _build.Counter()


def _launch(theta, mask, seed, scale, decay):
    if theta.dtype not in _DTYPES:
        raise TypeError(f"zo_axpy_2d kernel takes float32/bfloat16, "
                        f"got {theta.dtype}")
    if theta.dim() != 2 or not theta.is_contiguous():
        raise ValueError("zo_axpy_2d kernel takes a contiguous (L, n) view")
    mask = mask.to(device=theta.device, dtype=torch.bool).contiguous()
    if mask.shape != (theta.shape[0],):
        raise ValueError(f"mask shape {tuple(mask.shape)} != "
                         f"({theta.shape[0]},)")
    fn = _build.function(
        "zo_axpy", "zo_axpy_2d_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
         ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(theta.data_ptr(), mask.data_ptr(), theta.shape[0],
                 theta.shape[1], _DTYPES[theta.dtype], seed & 0xFFFFFFFF,
                 float(scale), float(decay), stream)
    _build.check(err, "zo_axpy_2d")
    counter.launches += 1
    return theta


def zo_axpy_2d_(theta, mask, seed: int, scale, decay=1.0):
    """In-place K1 on ``theta`` (L, n); ``mask`` (L,) bool; ``seed`` the
    leaf seed (uint32 int); ``scale``/``decay`` float32 scalars."""
    if theta.device.type == "cuda":
        return _launch(theta, mask, seed, scale, decay)
    return kref.zo_axpy_2d_(theta, mask, seed, scale, decay)


RNG_INPUTS = 1 << 24


def counter_normal_parts_check(device="cuda") -> dict:
    """Compare, on the card, ``r_fast``/``c_fast`` (the kernels' z) with
    ``r_ref``/``c_ref`` (``sqrtf(-2 logf(u))``, ``cosf(2 pi u)``) on all
    2^24 values of u; return the mismatch counts and the first
    mismatching input of each (None where there is none)."""
    out = torch.tensor([0, 0, RNG_INPUTS, RNG_INPUTS], dtype=torch.int64,
                       device=device)
    fn = _build.function("rng_check", "rng_check_launch",
                         [ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(out.device):
        err = fn(out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "rng_check")
    r_bad, c_bad, r_first, c_first = out.tolist()
    return {"inputs": RNG_INPUTS, "r_mismatches": r_bad,
            "c_mismatches": c_bad,
            "r_first": None if r_first == RNG_INPUTS else r_first,
            "c_first": None if c_first == RNG_INPUTS else c_first}

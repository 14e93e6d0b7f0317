"""Kernels K3 and K4: the virtual-perturbation matmul (counterpart of
``repro/fused/matmul.py``, whose Pallas kernels ``pmatmul_stack`` and
``pmatmul`` they replace).

``pmatmul_stack(x, w, seeds, scales, active)`` computes P probes
``x[p] @ (w + scales[p]*z(seeds[p]))`` (K3), off one pass over W for
P <= 2;
``pmatmul`` is the single-probe form with a LeZO ``active`` predicate
(K4).  Both launch ``csrc/pmatmul.cu`` on CUDA tensors: it reads W in its
stored layout through its strides (the tied head passes ``tok.T``, a
view, with ``trans=True, ld=d_model``), masks ragged M/N/K itself, makes
z per W tile (once for all probes when their seeds are equal), skips the
RNG for a launch with no active probe, rounds ``w + s*z`` to bf16 and
accumulates in f32.  Each operand is loaded by TMA where TMA can describe
it (``load_routes``), else by per-thread loads; ``route_counters`` counts
launches by route.  On CPU tensors they run the plain versions in
``fused/ref.py``.

Any P: the kernel is instantiated for P in {1, 2} (``Args<P>`` and the
perturbed W tiles in shared memory grow with P).  For P > 2 the wrapper
launches it on groups of at most two probes of one activity
(``probe_groups``): the active probes first, paired in order, drawing z
only for them; then the inactive ones through the RNG-free route.  Every
output row still runs the single-probe program, so the result equals P
single-probe calls bit for bit; W is read once per group.  A group of
consecutive probes reads x and writes its output in place; any other
group gathers its x rows and scatters its output.

``row_off``/``col_off``/``ld``/``trans`` define the counter window into
the stored leaf, as in the reference.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.fused import ref as fref
from repro_torch.kernels import _build


stack_counter = _build.Counter()     # K3 launches (one per probe group)
single_counter = _build.Counter()    # K4
# K3 and K4 launches by load route: "tma" when TMA loads both x and W,
# "thread" when per-thread loads fill either.
route_counters = {"tma": _build.Counter(), "thread": _build.Counter()}


def _tma_ok(t: torch.Tensor, pitch: int) -> bool:
    """TMA describes a bf16 operand whose base and row pitch (elements)
    are 16-byte aligned."""
    return t.data_ptr() % 16 == 0 and (pitch * t.element_size()) % 16 == 0


def load_routes(x3: torch.Tensor, w: torch.Tensor):
    """(x_tma, w_tma): whether TMA can load x (P, M, K) contiguous and W
    (K, N), read row- (N-contiguous) or column-major (K-contiguous)."""
    pitch = w.stride(0) if w.stride(1) == 1 else w.stride(1)
    return _tma_ok(x3, x3.shape[-1]), _tma_ok(w, pitch)


def probe_groups(active):
    """Probe indices of the K3 launches for P > 2 probes: groups of at
    most two of one activity, the active probes first, each list in
    probe order."""
    on = [p for p, a in enumerate(active) if a]
    off = [p for p, a in enumerate(active) if not a]
    return [ps[i:i + 2] for ps in (on, off) for i in range(0, len(ps), 2)]


# csrc/pmatmul.cu's tilings by activity: (rows of x a block holds, split
# evenly over the P probes; W columns a block holds), and its k-tile
TILINGS = {False: (256, 128), True: (512, 64)}
BK = 64


def launch_tiles(P: int, M: int, K: int, N: int, active: bool,
                 shared_seed: bool):
    """(W tiles loaded, z tiles drawn) by one launch of P probes of M
    rows each: every block walks the K/BK tiles of its W columns, and an
    active launch draws each tile's z once (one seed for all probes) or
    once a probe."""
    rows, bn = TILINGS[active]
    bmp = rows // P
    w = -(-M // bmp) * -(-N // bn) * -(-K // BK)
    return w, (w * (1 if shared_seed else P) if active else 0)


def tile_counts(M: int, K: int, N: int, seeds, active):
    """(W tiles loaded, z tiles drawn) summed over the launches that
    ``pmatmul`` (one probe) or ``pmatmul_stack`` makes for probes of M
    rows with ``seeds`` and LeZO flags ``active``: the counters
    ``w_tile_loads`` and ``z_regens`` (``obs.trace``)."""
    seeds, active = tuple(seeds), tuple(bool(a) for a in active)
    P = len(seeds)
    groups = [list(range(P))] if P <= 2 else probe_groups(active)
    w = z = 0
    for g in groups:
        dw, dz = launch_tiles(len(g), M, K, N, any(active[p] for p in g),
                              len({seeds[p] for p in g}) == 1)
        w, z = w + dw, z + dz
    return w, z


def _launch(x, w, seeds, scales, active, *, trans, ld, row_off, col_off,
            out=None):
    P, K = x.shape[0], x.shape[-1]
    lead = x.shape[1:-1]
    N = w.shape[1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("pmatmul kernel takes bfloat16 x and w")
    if P not in (1, 2):
        raise ValueError(f"pmatmul kernel takes 1 or 2 probes, got {P}")
    if w.shape[0] != K or x.device != w.device:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} "
                         f"({x.device}, {w.device}) do not match")
    if w.stride(1) != 1 and w.stride(0) != 1:
        raise ValueError("pmatmul kernel reads W row- or column-contiguous")
    x3 = x.reshape(P, -1, K).contiguous()
    M = x3.shape[1]
    if out is None:
        out = torch.empty((P, M, N), dtype=x.dtype, device=x.device)
    elif not out.is_contiguous() or out.numel() != P * M * N:
        raise ValueError("pmatmul kernel writes a contiguous (P, M, N) out")
    if ld is None:
        ld = w.shape[0] if trans else N
    eff = [float(s) if a else 0.0 for s, a in zip(scales, active)]
    fn = _build.function(
        "pmatmul", "pmatmul_launch",
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_uint] * 3
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    x_tma, w_tma = load_routes(x3, w)
    seed_arr = (ctypes.c_uint * P)(*[s & 0xFFFFFFFF for s in seeds])
    scale_arr = (ctypes.c_float * P)(*eff)
    with torch.cuda.device(x.device):
        err = fn(P, x3.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                 w.stride(0), w.stride(1), ctypes.addressof(seed_arr),
                 ctypes.addressof(scale_arr), int(any(active)),
                 int(len(set(seeds)) == 1), row_off & 0xFFFFFFFF,
                 col_off & 0xFFFFFFFF, ld & 0xFFFFFFFF, int(trans),
                 int(x_tma), int(w_tma),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "pmatmul")
    route_counters["tma" if x_tma and w_tma else "thread"].launches += 1
    return out.reshape(P, *lead, N)


def pmatmul(x, w, seed: int, scale, active=True, *, trans=False, ld=None,
            row_off=0, col_off=0):
    """K4: ``x @ (w + scale*z)``; x (..., K), w (K, N)."""
    if x.device.type != "cuda":
        return fref.pmatmul(x, w, seed, scale, active, trans=trans, ld=ld,
                            row_off=row_off, col_off=col_off)
    out = _launch(x[None], w, (seed,), (scale,), (bool(active),),
                  trans=trans, ld=ld, row_off=row_off, col_off=col_off)
    single_counter.launches += 1
    return out[0]


def pmatmul_stack(x, w, seeds, scales, active, *, trans=False, ld=None,
                  row_off=0, col_off=0):
    """K3: P stacked probes; x (P, ..., K), seeds/scales/active length P."""
    if x.device.type != "cuda":
        return fref.pmatmul_stack(x, w, seeds, scales, active, trans=trans,
                                  ld=ld, row_off=row_off, col_off=col_off)
    seeds, scales = tuple(seeds), tuple(scales)
    active = tuple(bool(a) for a in active)
    kw = dict(trans=trans, ld=ld, row_off=row_off, col_off=col_off)
    P = x.shape[0]
    if P <= 2:
        out = _launch(x, w, seeds, scales, active, **kw)
        stack_counter.launches += 1
        return out
    out = torch.empty((*x.shape[:-1], w.shape[1]), dtype=x.dtype,
                      device=x.device)
    for g in probe_groups(active):
        if len(g) == 2 and seeds[g[0]] == seeds[g[1]]:
            # direction_seeds folds the direction index into every seed
            raise ValueError(f"probes {g} of one stack share seed "
                             f"{seeds[g[0]]}")
        sub = lambda t: tuple(t[p] for p in g)
        if g[-1] - g[0] == len(g) - 1:          # consecutive: views
            sl = slice(g[0], g[-1] + 1)
            _launch(x[sl], w, sub(seeds), sub(scales), sub(active),
                    out=out[sl], **kw)
        else:
            idx = torch.tensor(g, device=x.device)
            out.index_copy_(0, idx, _launch(
                x.index_select(0, idx), w, sub(seeds), sub(scales),
                sub(active), **kw))
        stack_counter.launches += 1
    return out

"""The norm kernel: LayerNorm and RMSNorm over the last dim in one
launch (``csrc/norm.cu``).  No Pallas kernel answers to it: the
reference leaves its norms to XLA, which fuses each into one pass, where
eager PyTorch runs the same float32 maths as a dozen kernels, each a
pass over the rows.

``layer_norm(x, scale, bias, eps)`` and ``rms_norm(x, scale, eps)``
launch the kernel when the call allows it: x is a bf16/float32 CUDA
tensor, its last dim D lies in 1..``MAX_D``, the parameters are (D,) or
(G, 1, D) against x (G, M, D) (each of G equal groups of rows against
its own vectors: the paired virtual forward's probes), and no autograd
graph is being recorded (the kernel has no backward).  x's rows may lie
at any common stride (MLA's ``dkv[..., :512]``); a layout whose leading
dims do not collapse to one stride is copied first.  A DTensor x whose
rows each rank holds whole (no placement shards D or leaves a partial
sum), with replicated parameters, is normalised block by block on each
rank (:func:`local_blocks`), as the same rows of a plain tensor would
be.  Every other call runs the plain version, the float32 PyTorch ops;
under the dry run's cost counter an off-card call the card would launch
stands as one launch (``_build.plain_region``).

Counters: ``counter.launches``; with a tracer installed,
``obs.CTR_NORM_KERNEL`` a launch and ``obs.CTR_NORM_PLAIN`` a plain call
on a CUDA tensor (the calls that bypass the kernel on the card).  The
profiler range ``kernel/norm`` encloses a launch only, so a
``model/norm`` range with none inside is a bypass.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.distributed.ctx import is_dtensor
from repro_torch.kernels import _build
from repro_torch.obs import trace as obs

F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 16384

counter = _build.Counter()
_fn = None

# Operations an element: LayerNorm sums x, subtracts mu, squares and sums,
# scales twice and adds the bias; RMSNorm squares and sums, scales twice.
OPS_PER_ELEMENT = {"layer": 7.0, "rms": 4.0}


def layer_norm_plain(x, scale, bias, eps=1e-5):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.to(F32) + bias.to(F32)
    return y.to(x.dtype)


def rms_norm_plain(x, scale, eps=1e-5):
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def _dtensor(t) -> bool:
    return type(t) is not torch.Tensor and is_dtensor(t)


def groups(x, params):
    """G, the parameter groups the kernel would take x's rows in, or
    None where the call must run the plain version (whatever x's
    device; a DTensor's local blocks may still take it)."""
    if x.dtype not in _DTYPES or x.dim() == 0 or _dtensor(x):
        return None
    D = x.shape[-1]
    if not 1 <= D <= MAX_D:
        return None
    grad = torch.is_grad_enabled()
    if grad and x.requires_grad:
        return None
    G = None
    dev = x.get_device()
    for p in params:
        if (grad and p.requires_grad) or _dtensor(p) or p.get_device() != dev:
            return None
        if p.shape == (D,):
            g = 1
        elif (p.dim() == 3 and x.dim() == 3 and p.shape[1] == 1
              and p.shape[2] == D and p.shape[0] == x.shape[0]):
            g = p.shape[0]
        else:
            return None
        if G not in (None, g):
            return None
        G = g
    return G


def local_blocks(x, params):
    """(x's local block, the parameters' local tensors) for a DTensor x
    whose rows each rank holds whole, with parameters replicated on its
    mesh (or plain tensors): each rank's rows are then normalised alone.
    None where a mesh dim of more than one rank shards x's last dim or
    holds a partial sum, or shards a parameter (a mesh dim of one rank
    holds everything whatever its placement)."""
    mesh, last = x.device_mesh, x.dim() - 1
    for i, pl in enumerate(x.placements):
        if mesh.size(i) > 1 and not (
                pl.is_replicate()
                or (pl.is_shard() and pl.dim % x.dim() != last)):
            return None
    ps = []
    for p in params:
        if _dtensor(p):
            if p.device_mesh != mesh or not all(
                    mesh.size(i) == 1 or q.is_replicate()
                    for i, q in enumerate(p.placements)):
                return None
            p = p.to_local()
        ps.append(p)
    return x.to_local(), tuple(ps)


def _out_placements(x):
    """x's placements for its norm, a partial sum (on a mesh dim of one
    rank, the whole value) read as replication."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if pl.is_partial() else pl
                 for pl in x.placements)


def _contiguous_strides(shape):
    strides, n = [], 1
    for size in reversed(shape):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


def row_stride(x):
    """The element stride between consecutive rows of x seen as
    (R, D), or None where its leading dims do not collapse to one."""
    D = x.shape[-1]
    if D > 1 and x.stride(-1) != 1:
        return None
    stride = span = None
    for size, st in zip(reversed(x.shape[:-1]), reversed(x.stride()[:-1])):
        if size == 1:
            continue
        if span is not None and st != span:
            return None
        stride = st if stride is None else stride
        span = st * size
    return D if stride is None else stride


def cost(x, params):
    """(flops, bytes) of one launch: x read and y written once, each
    parameter group once."""
    n = x.numel()
    kind = "layer" if len(params) == 2 else "rms"
    nbytes = 2 * n * x.element_size() + sum(p.numel() * 4 for p in params)
    return OPS_PER_ELEMENT[kind] * n, float(nbytes)


def _function():
    global _fn
    if _fn is None:
        _fn = _build.function(
            "norm", "norm_rows_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return _fn


def _launch(x, params, eps, G):
    D = x.shape[-1]
    stride = D if x.is_contiguous() else row_stride(x)
    if stride is None:
        x = x.contiguous()
        stride = D
    R = x.numel() // D
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    # (D,) and (G, 1, D) float32 parameters lie in memory as (G, D) already
    ps = [p if p.dtype == F32 and p.is_contiguous()
          else p.to(F32).contiguous() for p in params]
    if R:
        dev = x.get_device()
        with obs.prange(obs.KERNEL_NORM):
            err = _function()(
                x.data_ptr(), y.data_ptr(), ps[0].data_ptr(),
                ps[1].data_ptr() if len(ps) == 2 else None, R, D, stride,
                R // G, _DTYPES[x.dtype], eps, dev,
                torch._C._cuda_getCurrentRawStream(dev))
        _build.check(err, "norm_rows")
        counter.launches += 1
        obs.get_tracer().count(obs.CTR_NORM_KERNEL)
    return y


def _norm(plain, x, params, eps):
    if _dtensor(x):
        loc = local_blocks(x, params)
        if loc is not None and groups(*loc) is not None:
            from torch.distributed.tensor import DTensor
            y = _norm(plain, *loc, eps)
            return DTensor.from_local(
                y, x.device_mesh, _out_placements(x), run_check=False,
                shape=x.shape, stride=_contiguous_strides(x.shape))
    G = groups(x, params)
    if x.device.type == "cuda":
        if G is not None:
            return _launch(x, params, eps, G)
        obs.get_tracer().count(obs.CTR_NORM_PLAIN)
        return plain(x, *params, eps)
    if G is None:
        return plain(x, *params, eps)
    with _build.plain_region("norm_rows", *cost(x, params)):
        return plain(x, *params, eps)


def layer_norm(x, scale, bias, eps=1e-5):
    """``((x - mu) * rsqrt(var + eps)) * scale + bias`` over x's last
    dim in float32, rounded to x's dtype."""
    return _norm(layer_norm_plain, x, (scale, bias), eps)


def rms_norm(x, scale, eps=1e-5):
    """``(x * rsqrt(mean(x^2) + eps)) * scale`` over x's last dim in
    float32, rounded to x's dtype."""
    return _norm(rms_norm_plain, x, (scale,), eps)

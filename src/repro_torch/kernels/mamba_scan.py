"""The selective-scan kernel: Mamba's diagonal SSM over a whole sequence
and its epilogue in one launch (``csrc/mamba_scan.cu``).  No Pallas
kernel answers to it: the reference's scan is ``lax.associative_scan``,
which XLA fuses, where the port's plain version (``models.ssm``'s
doubling scan) writes a float32 (B, S, Di, St) tensor at each of its
log2(S) steps.

``mamba_scan(plain, dt, dt_b, A_log, x, B, C, Dskip, z, h0, final)``
computes, per batch row and channel d, with h the (St,) state::

    delta_t = softplus(dt_t + dt_b)          (JAX's: logaddexp(v, 0))
    h_t     = exp(delta_t A) h_{t-1} + delta_t B_t x_t,  A = -exp(A_log)
    y_t     = (<h_t, C_t> + Dskip x_t) silu(z_t)

from ``dt`` (B, S, Di) float32 (``dt_in @ dt_w``, before its bias),
``x``, ``z`` (B, S, Di) in the model dtype, ``B``, ``C`` (B, S, St)
float32, ``dt_b``, ``Dskip`` (Di,) and ``A_log`` (Di, St) float32 and
``h0`` (B, Di, St) float32 or None (zeros), and returns y (B, S, Di) in
x's dtype and, when ``final``, the last h (else None).  Di may be a
tensor-parallel rank's local channels.

It launches the kernel when the call allows it: CUDA tensors on one
device, x and z bf16 or float32 of one dtype, the rest float32, St one
of ``STATES``, the (B, S) rows of dt, x, z, B and C each at one stride
(the splits of ``in_proj``'s and ``x_proj``'s outputs are), and no
autograd graph being recorded (the kernel has no backward).  Every other
call runs ``plain``, the same arguments in plain PyTorch; under the dry
run's cost counter an off-card call the card would launch stands as one
launch (``_build.plain_region``).

Counters: ``counter.launches``; with a tracer installed,
``obs.CTR_SCAN_KERNEL`` a launch and ``obs.CTR_SCAN_PLAIN`` a call on
CUDA tensors that ran ``plain`` (a bypass on the card).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.distributed.ctx import is_dtensor
from repro_torch.kernels import _build
from repro_torch.kernels.norm import row_stride
from repro_torch.obs import trace as obs

F32 = torch.float32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STATES = (4, 8, 16)

counter = _build.Counter()
_fn = None

# Operations a (row, step, channel): per state element the decay's
# multiply and exponential, B's multiply, the state's multiply-add and
# C's (6); softplus, delta x, the skip and the gate (about 12).
OPS_PER_STATE, OPS_PER_CHANNEL = 6.0, 12.0


def cost(dt, x, B):
    """(flops, bytes) of one launch: the fused minimum, each input read
    once and y written once (dt, B and C float32; x, z and y in the
    model dtype); the per-channel parameters and h0 are left out."""
    Bn, S, Di = dt.shape
    St = B.shape[-1]
    n = Bn * S * Di
    flops = n * (OPS_PER_STATE * St + OPS_PER_CHANNEL)
    nbytes = n * (4 + 3 * x.element_size()) + 2 * Bn * S * St * 4
    return flops, float(nbytes)


def _fits(dt, dt_b, A_log, x, B, C, Dskip, z, h0) -> bool:
    """Whether the kernel would take these tensors on the card: every
    rule of the module docstring but the device."""
    ts = [dt, dt_b, A_log, x, B, C, Dskip, z] + ([] if h0 is None else [h0])
    if any(type(t) is not torch.Tensor and is_dtensor(t) for t in ts):
        return False
    if any(t.device != x.device for t in ts):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return False
    if x.dtype not in _DTYPES or z.dtype != x.dtype:
        return False
    if any(t.dtype != F32 for t in (dt, dt_b, A_log, B, C, Dskip)):
        return False
    if x.dim() != 3 or dt.shape != x.shape or z.shape != x.shape:
        return False
    Bn, S, Di = x.shape
    St = B.shape[-1]
    if (St not in STATES or B.shape != (Bn, S, St) or C.shape != B.shape
            or A_log.shape != (Di, St) or dt_b.shape != (Di,)
            or Dskip.shape != (Di,)):
        return False
    if h0 is not None and (h0.dtype != F32 or h0.shape != (Bn, Di, St)):
        return False
    return all(row_stride(t) is not None for t in (dt, x, z, B, C))


def _function():
    global _fn
    if _fn is None:
        ll, ptr = ctypes.c_longlong, ctypes.c_void_p
        _fn = _build.function(
            "mamba_scan", "mamba_scan_launch",
            [ptr, ll, ptr, ptr, ptr, ll, ptr, ll, ptr, ll, ptr, ptr, ll,
             ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr])
    return _fn


def _launch(dt, dt_b, A_log, x, B, C, Dskip, z, h0, final):
    Bn, S, Di = x.shape
    St = B.shape[-1]
    y = torch.empty((Bn, S, Di), dtype=x.dtype, device=x.device)
    h = (torch.empty((Bn, Di, St), dtype=F32, device=x.device)
         if final else None)
    dt_b, A_log, Dskip = (t.contiguous() for t in (dt_b, A_log, Dskip))
    h0 = None if h0 is None else h0.contiguous()
    dev = x.get_device()
    err = _function()(
        dt.data_ptr(), row_stride(dt), dt_b.data_ptr(), A_log.data_ptr(),
        x.data_ptr(), row_stride(x), B.data_ptr(), row_stride(B),
        C.data_ptr(), row_stride(C), Dskip.data_ptr(), z.data_ptr(),
        row_stride(z), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        None if h is None else h.data_ptr(), Bn, S, Di, St,
        _DTYPES[x.dtype], dev, torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "mamba_scan")
    counter.launches += 1
    obs.get_tracer().count(obs.CTR_SCAN_KERNEL)
    return y, h


def mamba_scan(plain, dt, dt_b, A_log, x, B, C, Dskip, z, h0=None,
               final=False):
    """(y, last h or None): the kernel where it takes the call, else
    ``plain(dt, dt_b, A_log, x, B, C, Dskip, z, h0)`` (which returns
    (y, last h))."""
    args = (dt, dt_b, A_log, x, B, C, Dskip, z, h0)
    fits = _fits(*args)
    if x.device.type == "cuda":
        if fits:
            return _launch(*args, final)
        obs.get_tracer().count(obs.CTR_SCAN_PLAIN)
        y, h = plain(*args)
    elif fits:
        with _build.plain_region("mamba_scan", *cost(dt, x, B)):
            y, h = plain(*args)
    else:
        y, h = plain(*args)
    return y, (h if final else None)

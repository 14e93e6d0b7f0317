"""Kernel K2: causal flash-attention forward (counterpart of
``repro/kernels/flash_attn.py``, whose Pallas kernel it replaces, and of
the attention ``repro/models/layers.py::flash_attention`` computes).

Layout is the model's: q (B, Sq, KV, G, dh), k/v (B, Sk, KV, dh), out
like q.  ``q_offset`` is the absolute position of q[0]; ``k_offset`` the
position of k[0] (negative: leading always-visible keys).

On a CUDA tensor the wrapper launches ``csrc/flash_attn.cu`` (bf16,
dh in {32, 64, 128}; any Sq/Sk, masked; GQA as an index map; both
products on tensor cores).  On a CPU tensor it runs
:func:`flash_attention_plain`, the reference's chunked online-softmax
algorithm step for step (f32 running max/sum/acc, P rounded to the input
type before P·V).

Gradient (first-order training): when grad is enabled and q, k or v
requires it, the call goes through :class:`FlashAttention`, a
``torch.autograd.Function``.  Its forward is the same kernel (or, on the
CPU, the same plain version), asked also for each row's final running
max m and sum l; its backward, :func:`flash_attention_backward`, is the
standard attention backward in float32 tensor ops: P recomputed from q,
k, m and l, then dV = Pᵀ·dO, dS = P∘(dP − rowsum(dO∘O)), dQ and dK, with
GQA, the causal mask and the offsets.  The JAX package has no backward
kernel: XLA's autodiff computes these products outside any kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

F32 = torch.float32
NEG_INF = -1e30


counter = _build.Counter()


def flash_attention_plain(q, k, v, *, causal=True, q_offset=0, k_offset=0,
                          q_chunk=512, k_chunk=512, stats=False):
    """Plain PyTorch version of K2 (the reference's algorithm).
    ``stats=True`` also returns each row's final running max and sum,
    (out, m, l) with m, l float32 (B, KV, G, Sq)."""
    B, Sq, KV, G, dh = q.shape
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    k_chunk = min(k_chunk, Sk)
    if Sk % k_chunk:  # pad keys (padded slots masked out via position test)
        pad = k_chunk - Sk % k_chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    scale = dh ** -0.5
    dev = q.device
    out = torch.empty_like(q)
    ms, ls = [], []
    for q0 in range(0, Sq, q_chunk):
        qb = q[:, q0:q0 + q_chunk].to(F32)
        qc = qb.shape[1]
        q_pos = q_offset + q0 + torch.arange(qc, device=dev)
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((B, KV, G, qc), dtype=F32, device=dev)
        acc = torch.zeros((B, qc, KV, G, dh), dtype=F32, device=dev)
        for k0 in range(0, k.shape[1], k_chunk):
            if causal and k_offset + k0 > q_offset + q0 + qc - 1:
                continue
            kb = k[:, k0:k0 + k_chunk].to(F32)
            vb = v[:, k0:k0 + k_chunk]
            k_idx = k0 + torch.arange(k_chunk, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            msk = (k_idx < Sk)[None, :]
            if causal:
                msk = msk & (q_pos[:, None] >= (k_offset + k_idx)[None, :])
            s = torch.where(msk, s, torch.tensor(NEG_INF, dtype=F32,
                                                 device=dev))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype).to(F32),
                              vb.to(F32))
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        den = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        out[:, q0:q0 + q_chunk] = (acc / den).to(q.dtype)
        ms.append(m)
        ls.append(l)
    if stats:
        return out, torch.cat(ms, -1), torch.cat(ls, -1)
    return out


def flash_attention_backward(q, k, v, out, m, l, dout, *, causal=True,
                             q_offset=0, k_offset=0):
    """Gradients (dq, dk, dv) of the attention forward, in float32 and
    returned in the inputs' dtype.  ``m``/``l`` (B, KV, G, Sq) are the
    forward's row max and sum: P = exp(S - m) / l with S the scaled,
    masked scores (masked -1e30, as in the forward)."""
    dh = q.shape[-1]
    scale = dh ** -0.5
    qf, kf, vf, of, dof = (t.to(F32) for t in (q, k, v, out, dout))
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.tensor(NEG_INF, dtype=F32, device=q.device))
    p = torch.exp(s - m[..., None]) / torch.clamp(l, min=1e-30)[..., None]
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    rowdot = torch.sum(dof * of, dim=-1).permute(0, 2, 3, 1)  # (B,KV,G,Sq)
    ds = p * (dp - rowdot[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _aligned(t):
    """Contiguous, based on a 16-byte boundary: the kernel moves rows as
    16-byte chunks."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, *, causal, q_offset, k_offset, stats=False):
    B, Sq, KV, G, dh = q.shape
    Sk = k.shape[1]
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernel takes bfloat16 q/k/v")
    if dh not in (32, 64, 128):
        raise ValueError(f"flash kernel takes dh in (32, 64, 128), got {dh}")
    if k.shape != (B, Sk, KV, dh) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    st = (torch.empty((2, B, KV, G, Sq), dtype=F32, device=q.device)
          if stats else None)
    fn = _build.function(
        "flash_attn", "flash_fwd_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if st is None else st.data_ptr(),
                 B, Sq, Sk, KV, G, dh, int(q_offset), int(k_offset),
                 int(bool(causal)), float(dh ** -0.5),
                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_fwd")
    counter.launches += 1
    return (out, st[0], st[1]) if stats else out


class FlashAttention(torch.autograd.Function):
    """K2 with a gradient: the forward keeps each row's m and l, the
    backward is :func:`flash_attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset, q_chunk, k_chunk):
        if q.device.type == "cuda":
            out, m, l = _launch(q, k, v, causal=causal, q_offset=q_offset,
                                k_offset=k_offset, stats=True)
        else:
            out, m, l = flash_attention_plain(
                q, k, v, causal=causal, q_offset=q_offset, k_offset=k_offset,
                q_chunk=q_chunk, k_chunk=k_chunk, stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.mask_args = (causal, q_offset, k_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, q_offset, k_offset = ctx.mask_args
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, m, l, dout, causal=causal, q_offset=q_offset,
            k_offset=k_offset)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, q_offset=0, k_offset=0,
                    q_chunk=512, k_chunk=512):
    """K2 on CUDA tensors (``q_chunk``/``k_chunk`` are the plain path's
    chunking; the kernel uses its own tiles), the plain version on CPU;
    through :class:`FlashAttention` when a gradient is wanted."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_offset, k_offset,
                                    q_chunk, k_chunk)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, q_offset=q_offset,
                       k_offset=k_offset)
    return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset,
                                 k_offset=k_offset, q_chunk=q_chunk,
                                 k_chunk=k_chunk)

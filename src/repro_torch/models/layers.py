"""Transformer layers of the OPT stack (counterpart of
``repro/models/layers.py``): norms, flash attention, the attention block
in train mode and the ReLU FFN.

A block's parameters arrive as one layer's slice of the stacked leaves.
Activations are (B, S, D) in the model dtype.  ``pc``
(``fused.LayerPerturb``) switches every weight read to its virtually
perturbed view; None is the plain path, where ``a @ w`` is PyTorch's
matmul (the reference leaves these products to XLA too).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attn as kflash

F32 = torch.float32


# ----------------------------------------------------------------- norms
def rms_norm(x, scale, eps=1e-5):
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.to(F32) + bias.to(F32)
    return y.to(x.dtype)


def apply_norm(cfg, p, x):
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_params(cfg, d, device):
    p = {"scale": torch.ones((d,), dtype=F32, device=device)}
    if cfg.norm != "rms":
        p["bias"] = torch.zeros((d,), dtype=F32, device=device)
    return p


# -------------------------------------------------------- flash attention
def flash_attention(q, k, v, *, causal=True, q_offset=0, k_offset=0,
                    q_chunk=512, k_chunk=512):
    """q: (B,Sq,KV,G,dh), k/v: (B,Sk,KV,dh). Returns (B,Sq,KV,G,dh).

    Kernel K2 on the card, its plain version on the CPU
    (``kernels/flash_attn.py``).  ``q_offset``: absolute position of
    q[0]; ``k_offset``: position of k[0] (negative marks leading
    always-visible tokens).
    """
    return kflash.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  k_offset=k_offset, q_chunk=q_chunk,
                                  k_chunk=k_chunk)


# --------------------------------------------------------------- blocks
def randn_scaled(shape, std, gen, dtype, device):
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(std)


def attn_params(cfg, gen, L, device):
    """One attention block's leaves, stacked over ``L`` layers."""
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)
    std = D ** -0.5
    return {
        "norm": {k: v.expand(L, -1).clone()
                 for k, v in norm_params(cfg, D, device).items()},
        "wq": randn_scaled((L, D, H * dh), std, gen, dt, device),
        "wk": randn_scaled((L, D, KV * dh), std, gen, dt, device),
        "wv": randn_scaled((L, D, KV * dh), std, gen, dt, device),
        "wo": randn_scaled((L, H * dh, D), (H * dh) ** -0.5, gen, dt, device),
    }


def ffn_params(cfg, gen, L, device):
    """One ReLU FFN block's leaves, stacked over ``L`` layers."""
    D, F = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    return {
        "norm": {k: v.expand(L, -1).clone()
                 for k, v in norm_params(cfg, D, device).items()},
        "wi": randn_scaled((L, D, F), D ** -0.5, gen, dt, device),
        "wd": randn_scaled((L, F, D), F ** -0.5, gen, dt, device),
    }


def _mm(pc):
    return (lambda a, w, name: a @ w) if pc is None else pc.matmul


def attn_fwd(cfg, p, x, *, pc=None):
    """Causal self-attention block in train mode (learned positions are
    added by the caller; OPT has no rope)."""
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mm = _mm(pc)
    h = (apply_norm(cfg, p["norm"], x) if pc is None
         else pc.apply_norm(cfg, p["norm"], x, "norm"))
    q = mm(h, p["wq"], "wq").reshape(B, S, KV, H // KV, dh)
    k = mm(h, p["wk"], "wk").reshape(B, S, KV, dh)
    v = mm(h, p["wv"], "wv").reshape(B, S, KV, dh)
    o = flash_attention(q, k, v, causal=True, q_chunk=cfg.attn_q_chunk,
                        k_chunk=cfg.attn_k_chunk)
    return mm(o.reshape(B, S, H * dh), p["wo"], "wo").to(x.dtype)


def ffn_fwd(cfg, p, x, pc=None):
    """ReLU FFN block (OPT's)."""
    mm = _mm(pc)
    h = (apply_norm(cfg, p["norm"], x) if pc is None
         else pc.apply_norm(cfg, p["norm"], x, "norm"))
    a = torch.relu(mm(h, p["wi"], "wi"))
    return mm(a, p["wd"], "wd").to(x.dtype)

"""Transformer layers (counterpart of ``repro/models/layers.py``):
norms, rope, flash attention, the GQA attention block (qk-norm, rope)
in its four modes (train, and the serving modes prefill, decode and
paged), decode and paged attention, the MLA block (DeepSeek-V2's latent
attention: K2 at dh = dn + dr in train and prefill, the absorbed form
over the latent cache in decode), and the dense FFN (SwiGLU, tanh-GELU
or ReLU).

A block's parameters arrive as one layer's slice of the stacked leaves.
Activations are (B, S, D) in the model dtype.  ``pc``
(``fused.LayerPerturb``) switches every weight read to its virtually
perturbed view; None is the plain path, where ``a @ w`` is PyTorch's
matmul (the reference leaves these products to XLA too).

The serving modes write their K/V into caches in place: the lockstep
cache (R, B, Smax, KV, dh) and the paged arena (R, n_pages, page_size,
KV, dh) are the reference's layouts, one layer's slice at a time.
Decode and paged attention are plain PyTorch, as the reference's are
``einsum``s outside any Pallas kernel; so is rope.  The norms run the
norm kernel on the card (``kernels/norm.py``) and their plain float32
ops elsewhere.

Under a registered mesh (``distributed/ctx.py``) train and prefill
attention pin q/k/v where the reference does: KV heads on ``model`` when
they divide it, else query stripes.  The lockstep caches' sequence dim
lies on ``model``: prefill and decode write each position on the rank
whose shard holds it (``ctx.write_seq``).  The paged mode writes and gathers
a page-sharded arena per rank (``ctx.paged_kv``) and attends over the
whole K/V on every rank, the dense single-device function.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import ctx
from repro_torch.kernels import flash_attn as kflash
from repro_torch.kernels import norm as knorm
from repro_torch.obs import trace as obs

F32 = torch.float32
NEG_INF = -1e30


# ----------------------------------------------------------------- norms
def rms_norm(x, scale, eps=1e-5):
    with obs.prange(obs.MODEL_NORM):
        return knorm.rms_norm(x, scale, eps)


def layer_norm(x, scale, bias, eps=1e-5):
    with obs.prange(obs.MODEL_NORM):
        return knorm.layer_norm(x, scale, bias, eps)


def apply_norm(cfg, p, x):
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_params(cfg, d, device):
    p = {"scale": torch.ones((d,), dtype=F32, device=device)}
    if cfg.norm != "rms":
        p["bias"] = torch.zeros((d,), dtype=F32, device=device)
    return p


# ------------------------------------------------------------------ rope
def rope(x, positions, theta=10000.0):
    """x: (B, S, n, d) with d even; positions: (S,) shared across the
    batch, or (B, S) per lane (the paged serving path, where every lane
    sits at its own position).  float32 in the reference's order:
    frequencies, angles, cos/sin, then the split-half rotation."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32,
                                          device=x.device) / d))
    ang = positions.to(F32)[..., None] * freqs    # (S, d/2) | (B, S, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if positions.ndim == 1:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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


def _stacked(leaf: torch.Tensor, L: int) -> torch.Tensor:
    return leaf.expand(L, *leaf.shape).clone()


def attn_params(cfg, gen, L, device):
    """One attention block's leaves, stacked over ``L`` layers; the
    qk-norm scales are float32 ones, as the reference's."""
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = getattr(torch, cfg.dtype)
    std = D ** -0.5
    p = {
        "norm": {k: _stacked(v, L)
                 for k, v in norm_params(cfg, D, device).items()},
        "wq": randn_scaled((L, D, H * dh), std, gen, dt, device),
        "wk": randn_scaled((L, D, KV * dh), std, gen, dt, device),
        "wv": randn_scaled((L, D, KV * dh), std, gen, dt, device),
        "wo": randn_scaled((L, H * dh, D), (H * dh) ** -0.5, gen, dt, device),
    }
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = {"scale": _stacked(
                torch.ones((dh,), dtype=F32, device=device), L)}
    return p


def mla_params(cfg, gen, L, device):
    """One MLA block's leaves, stacked over ``L`` layers: ``wq`` (D,
    H·(dn + dr)), the down-projection ``wdkv`` (D, kv_lora + dr), the
    float32 ``kv_norm`` scale, the latent up-projections ``wuk``/``wuv``
    (kv_lora, H·dn) and ``wo`` (H·dn, D)."""
    D, H = cfg.d_model, cfg.n_heads
    dn, dr, lora = cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora
    dt = getattr(torch, cfg.dtype)
    std = D ** -0.5
    return {
        "norm": {k: _stacked(v, L)
                 for k, v in norm_params(cfg, D, device).items()},
        "wq": randn_scaled((L, D, H * (dn + dr)), std, gen, dt, device),
        "wdkv": randn_scaled((L, D, lora + dr), std, gen, dt, device),
        "kv_norm": {"scale": _stacked(
            torch.ones((lora,), dtype=F32, device=device), L)},
        "wuk": randn_scaled((L, lora, H * dn), lora ** -0.5, gen, dt,
                            device),
        "wuv": randn_scaled((L, lora, H * dn), lora ** -0.5, gen, dt,
                            device),
        "wo": randn_scaled((L, H * dn, D), (H * dn) ** -0.5, gen, dt,
                           device),
    }


def ffn_params(cfg, gen, L, device, d_ff=None):
    """One dense FFN block's leaves, stacked over ``L`` layers: gate and
    up projections for SwiGLU (``act == "silu"``), one input projection
    otherwise; ``d_ff`` is the block's own width (``BlockCfg.d_ff``),
    ``cfg.d_ff`` when None or 0."""
    D, F = cfg.d_model, d_ff or cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    p = {"norm": {k: _stacked(v, L)
                  for k, v in norm_params(cfg, D, device).items()}}
    if cfg.act == "silu":
        p["wg"] = randn_scaled((L, D, F), D ** -0.5, gen, dt, device)
        p["wu"] = randn_scaled((L, D, F), D ** -0.5, gen, dt, device)
    else:
        p["wi"] = randn_scaled((L, D, F), D ** -0.5, gen, dt, device)
    p["wd"] = randn_scaled((L, F, D), F ** -0.5, gen, dt, device)
    return p


def _mm(pc):
    return (lambda a, w, name: ctx.matmul(a, w)) if pc is None else pc.matmul


def _attend(q, k, v, valid):
    """Softmax attention of q (B,C,KV,G,dh) over k/v (B,S,KV,dh) where
    ``valid`` (B|1, C|1, S) holds; scores and P·V accumulate in float32,
    P rounded to q's type first, as the reference's ``einsum``s with
    ``preferred_element_type=F32``."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(F32),
                     k.to(F32)) * (q.shape[-1] ** -0.5)
    s = torch.where(valid[:, None, None], s,
                    torch.tensor(NEG_INF, dtype=F32, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(q.dtype).to(F32),
                       v.to(F32))
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_len):
    """Single-token attention over a (possibly partially filled) cache.

    q: (B,1,KV,G,dh); caches: (B,Smax,KV,dh); cur_len — number of valid
    cache entries *including* the current token: an int (the lockstep
    path, every lane at the same depth) or a (B,) tensor (per-lane
    depths).
    """
    if ctx.is_dtensor(k_cache):
        return _decode_sharded(q, k_cache, v_cache, cur_len)
    cur = torch.as_tensor(cur_len, device=q.device).reshape(-1, 1, 1)
    slots = torch.arange(k_cache.shape[1], device=q.device)
    return _attend(q, k_cache, v_cache, slots < cur)


def _decode_sharded(q, k_cache, v_cache, cur_len):
    """:func:`decode_attention` per rank over a placed lockstep cache
    (batch rows on the batch axes, the sequence on ``model``): q brought
    to the cache's rows with every head; scores over this rank's window
    of positions, all-gathered over the axes that shard the sequence
    (the flash-decode split the reference's partitioner derives), one
    softmax over all of them, P·V over the window, and the partial
    outputs summed in float32 over those axes.  With the sequence whole
    on every rank it is :func:`_attend` on the local tensors, the plain
    function bit for bit.  Returns (B, 1, KV, G, dh) on the cache's
    rows."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import local_window

    mesh, pl = k_cache.device_mesh, k_cache.placements
    qpl = [p if p == Shard(0) else Replicate() for p in pl]
    if not ctx.is_dtensor(q):
        q = DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    shape = q.shape
    ql = q.redistribute(mesh, qpl).to_local()
    kl, vl = k_cache.to_local(), v_cache.to_local()
    n, off = local_window(k_cache.shape, mesh, pl)
    cur = torch.as_tensor(cur_len, device=ql.device).reshape(-1, 1, 1)
    valid = torch.arange(off[1], off[1] + n[1], device=ql.device) < cur
    groups = [mesh.get_group(i) for i, p in enumerate(pl)
              if p == Shard(1) and mesh.size(i) > 1]
    if not groups:
        out = _attend(ql, kl, vl, valid)
    else:
        s = torch.einsum("bqkgd,bskd->bkgqs", ql.to(F32),
                         kl.to(F32)) * (ql.shape[-1] ** -0.5)
        s = torch.where(valid[:, None, None], s,
                        torch.tensor(NEG_INF, dtype=F32, device=ql.device))
        for g in groups:                   # mesh order: major to minor
            s = fc.wait_tensor(fc.all_gather_tensor(s, s.ndim - 1, g))
        p = torch.softmax(s, dim=-1)[..., off[1]:off[1] + n[1]]
        out = torch.einsum("bkgqs,bskd->bqkgd", p.to(ql.dtype).to(F32),
                           vl.to(F32))
        for g in groups:
            out = fc.wait_tensor(fc.all_reduce(out, "sum", g))
        out = out.to(ql.dtype)
    return DTensor.from_local(out, mesh, qpl, run_check=False, shape=shape,
                              stride=q.stride())


def paged_attention(q, k, v, q_positions):
    """Causal attention over page-gathered caches (DESIGN.md §12).

    q: (B,C,KV,G,dh) — C query tokens per lane (C==1 for a decode step,
    C==prefill_chunk for a prefill call); k/v: (B,Smax,KV,dh), the lane's
    page table gathered back into position order, so buffer index s IS
    absolute position s; q_positions: (B,C) absolute position per query.

    The single causal test ``s <= q_position`` doubles as the validity
    mask: pages are written front to back, so every position <= the
    query's is live and everything beyond it is trash-page content,
    which a probability of exactly 0 leaves out (the arena starts as
    zeros, so that content is always finite).  Dense, as the
    reference's.
    """
    slots = torch.arange(k.shape[1], device=q.device)
    return _attend(q, k, v, slots <= q_positions[:, :, None])


def attn_fwd(cfg, p, x, *, mode="train", cache=None, pos=0, pc=None,
             pages=None):
    """Causal self-attention block with GQA: qk-norm (``cfg.qk_norm``)
    on the (B, S, H, dh) heads, then rope (``cfg.pos_emb == "rope"``;
    learned positions are added by the caller) at the positions
    ``pos + arange(S)``, per lane in ``paged`` mode, and only then the
    fold of query head h = kv·G + g into (B, S, KV, G, dh), the index map
    K2 reads.  Returns the block's output.

    mode: ``train`` (no cache) | ``prefill`` (K2 over the prompt; its K/V
    written to ``cache["k"/"v"]`` (B, Smax, KV, dh) at [0, S), the rest
    left as the zeros it was made with) | ``decode`` (S == 1: K/V written
    at ``pos``, then :func:`decode_attention` over ``pos + 1`` entries) |
    ``paged`` (the serving engine's bucketed call: ``cache`` holds this
    layer's arena {"k"/"v": (n_pages, page_size, KV, dh)}, ``pages`` the
    (B, max_pages) page table (page 0 = trash), ``pos`` a (B,) tensor of
    per-lane start positions; the new K/V land at page
    ``pages[b, pos_b // psz]`` slot ``pos_b % psz``, then each lane's
    pages are gathered back into position order for
    :func:`paged_attention`).  Every cache write is in place.

    Prefix tuning's ``pk``/``pv`` (P, KV, dh) leaves, when present, are
    P always-visible key/value positions ahead of the sequence (K2 at
    ``k_offset = -P``), in train mode only.
    """
    B, S, D = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if pc is not None and "pk" in p:
        raise NotImplementedError(
            "virtual perturbation does not cover prefix-KV leaves")
    if mode != "train" and "pk" in p:
        raise NotImplementedError(
            f"mode={mode!r} serves no prefix-KV leaves")
    mm = _mm(pc)
    h = (apply_norm(cfg, p["norm"], x) if pc is None
         else pc.apply_norm(cfg, p["norm"], x, "norm"))
    q, k, v = (mm(h, p[n], n) for n in ("wq", "wk", "wv"))
    nm = ctx.model_size()
    if ctx.get_mesh() is not None and KV % nm:
        # heads do not divide the model axis, so the column-parallel
        # outputs cannot split into heads where they lie: train/prefill
        # attend query stripes (sequence parallel, as the reference: one
        # k/v gather a layer, no score collectives), decode gathers all
        seq = mode not in ("decode", "paged") and S % nm == 0
        q = ctx.constrain(q, "batch", "model" if seq else None, None)
        k = ctx.constrain(k, "batch", None, None)
        v = ctx.constrain(v, "batch", None, None)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, KV, dh)
    v = v.reshape(B, S, KV, dh)
    if cfg.qk_norm:
        if pc is None:
            q = rms_norm(q, p["q_norm"]["scale"])
            k = rms_norm(k, p["k_norm"]["scale"])
        else:
            q = pc.rms_norm(q, p["q_norm"]["scale"], "q_norm/scale")
            k = pc.rms_norm(k, p["k_norm"]["scale"], "k_norm/scale")
    if mode == "paged" or cfg.pos_emb == "rope":
        steps = torch.arange(S, device=x.device)
        positions = (pos[:, None] + steps[None] if mode == "paged"
                     else pos + steps)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, KV, H // KV, dh)
    if (mode not in ("decode", "paged") and ctx.get_mesh() is not None
            and KV % nm == 0):
        # KV heads on model when they divide: attention is head-local
        k = ctx.constrain(k, "batch", None, "model", None)
        v = ctx.constrain(v, "batch", None, "model", None)
        q = ctx.constrain(q, "batch", None, "model", None, None)
    if mode == "paged":
        psz = cache["k"].shape[1]
        page = torch.gather(pages, 1, torch.div(positions, psz,
                                                rounding_mode="floor"))
        flat = (page * psz + positions % psz).reshape(-1)
        # (B, max_pg*psz, KV, dh), per rank on a page-sharded arena; the
        # new K/V whole first (x may come batch-sharded from an MoE or
        # Mamba block, and DTensor cannot fold a sharded B into B·S)
        kg = ctx.paged_kv(cache["k"], pages, flat,
                          ctx.whole(k).reshape(B * S, KV, dh))
        vg = ctx.paged_kv(cache["v"], pages, flat,
                          ctx.whole(v).reshape(B * S, KV, dh))
        o = paged_attention(ctx.whole(q), kg, vg, positions)
    elif mode == "decode":
        ctx.write_seq(cache["k"], pos, k)
        ctx.write_seq(cache["v"], pos, v)
        o = decode_attention(q, cache["k"], cache["v"], pos + 1)
    else:
        k_offset = 0
        if "pk" in p:
            P = p["pk"].shape[0]
            k = torch.cat([p["pk"].to(k.dtype).expand(B, P, KV, dh), k], 1)
            v = torch.cat([p["pv"].to(v.dtype).expand(B, P, KV, dh), v], 1)
            k_offset = -P
        o = flash_attention(q, k, v, causal=True, q_offset=pos,
                            k_offset=k_offset, q_chunk=cfg.attn_q_chunk,
                            k_chunk=cfg.attn_k_chunk)
        if mode == "prefill":
            ctx.write_seq(cache["k"], 0, k)
            ctx.write_seq(cache["v"], 0, v)
    return mm(o.reshape(B, S, H * dh), p["wo"], "wo").to(x.dtype)


def mla_fwd(cfg, p, x, *, mode="train", cache=None, pos=0):
    """DeepSeek-V2 multi-head latent attention.  The cache holds only
    the latent ``ckv`` (B, Smax, kv_lora) and the shared rope key ``kr``
    (B, Smax, dr) a token.

    ``q`` splits into ``qn`` (dn) and ``qr`` (dr); the down-projection
    into ``ckv`` (rms-normed by ``kv_norm``) and ``kr``; rope goes on
    ``qr`` and ``kr`` only, at ``pos + arange(S)``.  Train and prefill:
    per-head keys ``[ckv·wuk, kr]`` (``kr`` broadcast over the heads)
    and values ``ckv·wuv`` zero-padded to dn + dr, through K2 at dh =
    dn + dr (its scale (dn + dr)^-0.5 is MLA's), the output cut back to
    dn; prefill writes ``ckv``/``kr`` to the cache at [0, S).  Decode:
    the weight-absorbed form against the latent cache in float32, the
    two score terms summed then scaled by ``(dn + dr) ** -0.5``, the
    ``pos + 1`` valid entries softmaxed, the output taken back through
    ``wuv``; per-head K/V never exist.  Cache writes are in place.
    """
    B, S, D = x.shape
    H, dn, dr, lora = (cfg.n_heads, cfg.head_dim, cfg.rope_head_dim,
                       cfg.kv_lora)
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(
            f"mla serves mode={mode!r} nowhere: the paged engine covers "
            "attn mixers only (serve MLA with the lockstep path)")
    h = apply_norm(cfg, p["norm"], x)
    q = (h @ p["wq"]).reshape(B, S, H, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    dkv = h @ p["wdkv"]
    ckv = rms_norm(dkv[..., :lora], p["kv_norm"]["scale"])    # (B, S, lora)
    kr = dkv[..., lora:].reshape(B, S, 1, dr)
    positions = pos + torch.arange(S, device=x.device)
    qr = rope(qr, positions, cfg.rope_theta)
    kr = rope(kr, positions, cfg.rope_theta)
    wuk = p["wuk"].reshape(lora, H, dn)
    wuv = p["wuv"].reshape(lora, H, dn)

    if mode == "decode":
        ctx.write_seq(cache["ckv"], pos, ckv)
        ctx.write_seq(cache["kr"], pos, kr[:, :, 0])
        ckv_c, kr_c = cache["ckv"].to(F32), cache["kr"].to(F32)
        q_lat = torch.einsum("bqhd,lhd->bqhl", qn.to(F32), wuk.to(F32))
        s = torch.einsum("bqhl,bsl->bhqs", q_lat, ckv_c)
        s = s + torch.einsum("bqhd,bsd->bhqs", qr.to(F32), kr_c)
        s = s * (dn + dr) ** -0.5
        valid = torch.arange(ckv_c.shape[1], device=x.device) < pos + 1
        s = torch.where(valid, s, torch.tensor(NEG_INF, dtype=F32,
                                               device=x.device))
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhqs,bsl->bqhl", pr, ckv_c)
        o = torch.einsum("bqhl,lhd->bqhd", o_lat, wuv.to(F32)).to(x.dtype)
    else:
        kn = torch.einsum("bsl,lhd->bshd", ckv, wuk)
        vv = torch.einsum("bsl,lhd->bshd", ckv, wuv)
        kfull = torch.cat([kn, kr.expand(B, S, H, dr)], dim=-1)
        qfull = torch.cat([qn, qr], dim=-1).reshape(B, S, H, 1, dn + dr)
        vpad = torch.nn.functional.pad(vv, (0, dr))
        o = flash_attention(qfull, kfull, vpad, causal=True, q_offset=pos,
                            q_chunk=cfg.attn_q_chunk,
                            k_chunk=cfg.attn_k_chunk)
        o = o.reshape(B, S, H, dn + dr)[..., :dn]
        if mode == "prefill":
            ctx.write_seq(cache["ckv"], 0, ckv)
            ctx.write_seq(cache["kr"], 0, kr[:, :, 0])
    return (o.reshape(B, S, H * dn) @ p["wo"]).to(x.dtype)


def ffn_fwd(cfg, p, x, pc=None):
    """Dense FFN block: SwiGLU ``silu(h·wg in float32) * (h·wu)``,
    tanh-GELU (``jax.nn.gelu``'s default) or ReLU, then ``wd``."""
    mm = _mm(pc)
    h = (apply_norm(cfg, p["norm"], x) if pc is None
         else pc.apply_norm(cfg, p["norm"], x, "norm"))
    if cfg.act == "silu":
        a = (torch.nn.functional.silu(mm(h, p["wg"], "wg").to(F32)).to(
            x.dtype) * mm(h, p["wu"], "wu"))
    elif cfg.act == "gelu":
        a = torch.nn.functional.gelu(mm(h, p["wi"], "wi").to(F32),
                                     approximate="tanh").to(x.dtype)
    else:
        a = torch.relu(mm(h, p["wi"], "wi"))
    return mm(a, p["wd"], "wd").to(x.dtype)

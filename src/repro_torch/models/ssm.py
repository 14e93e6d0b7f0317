"""Recurrent blocks: Mamba (selective SSM), mLSTM and sLSTM (xLSTM)
(counterpart of ``repro/models/ssm.py``).

All three expose the block contract ``lm.py`` uses::

    *_params(cfg, gen, L, device) -> one block's leaves, stacked over L
    *_fwd(cfg, p, x, mode=..., cache=..., pos=...) -> (out, new_cache)

``p`` is one layer's slice of the stacked leaves.  Train and prefill
use chunkwise forms over time chunks of ``CHUNK`` (a Python loop over
the chunks, the reference's ``lax.scan``), so activation memory is
O(chunk), not O(S); decode is the exact O(1)-state recurrence.  A
sequence longer than ``CHUNK`` must be a multiple of it, as the
reference asserts.  ``new_cache`` is the block's whole state after the
sequence (None in train mode); ``lm.py`` copies it into the cache in
place.

PyTorch has no ``lax.associative_scan``: inside a chunk the Mamba
recurrence ``h_t = a_t h_{t-1} + b_t`` runs as a doubling
(Hillis-Steele) scan in ceil(log2 c) steps under the reference's
combine ``(a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2)``, which rounds
differently from XLA's tree.  Every cast of the reference is kept:
activations in the model dtype between the projections, the gates,
scans and states in float32.  ``softplus`` is JAX's,
``log(1 + exp(-|x|)) + max(x, 0)``; ``F.softplus`` returns x past its
threshold and parts from it.

On the card the train and prefill scan, with the softplus before it
and the skip and gate after it, is one launch of the selective-scan
kernel (``kernels/mamba_scan.py``); decode, the CPU and every call the
kernel does not take run the plain PyTorch ops below, as the
reference's are ``einsum``s and scans outside any Pallas kernel.

``cfg.mamba_dtbc_norm`` adds Jamba's RMSNorms on ``dt_in``, ``B`` and
``C`` after ``x_proj`` (HF ``JambaMambaMixer``'s ``dt_layernorm``,
``b_layernorm``, ``c_layernorm``): three float32 ``scale`` leaves.

On a mesh (``lm.py::_recurrent``) Mamba runs per rank on its d_inner
channels, the reference's layout (``ctx.tp_block``): ``in_proj``
column-parallel, the conv, ``dt``, ``A_log`` and ``Dskip`` leaves and
the ``conv``/``ssm`` caches local on their channels, ``x_proj`` and
``out_proj`` row-parallel; mLSTM and sLSTM, whose block weights the
rules replicate, run on whole weights (``ctx.rowwise``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import ctx
from repro_torch.kernels import mamba_scan as kscan
from repro_torch.models import layers
from repro_torch.obs import trace as obs

F32 = torch.float32
CHUNK = 128


def _chunk(S: int) -> int:
    """The time chunk for a sequence of ``S``: ``min(CHUNK, S)``, which
    must divide ``S``."""
    c = min(CHUNK, S)
    if S % c:
        raise ValueError(f"sequence length {S} cannot be chunked: past "
                         f"{c} tokens it must be a multiple of the chunk "
                         f"{c}")
    return c


def softplus(x):
    """JAX's ``softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _norm_stack(cfg, d, L, device):
    return {k: layers._stacked(v, L)
            for k, v in layers.norm_params(cfg, d, device).items()}


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv. x: (B,S,Di), w: (K,Di), b: (Di,).

    cache: (B, K-1, Di) trailing context (decode, prefill) or None
    (train: zero pad).  Returns (y in x's dtype, new_cache: the last
    K-1 inputs, context included).
    """
    B, S, Di = x.shape
    K = w.shape[0]
    ctx = (cache.to(x.dtype) if cache is not None
           else x.new_zeros((B, K - 1, Di)))
    xp = torch.cat([ctx, x], dim=1)                  # (B, S+K-1, Di)
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    y = y + b
    new_cache = xp[:, -(K - 1):] if K > 1 else ctx
    return y.to(x.dtype), new_cache


# ------------------------------------------------------------------ Mamba
def mamba_params(cfg, gen, L, device):
    """One Mamba block's leaves, stacked over ``L`` layers, drawn in the
    reference's order: ``in_proj`` (D, 2Di), ``conv_w`` (K, Di),
    ``x_proj`` (Di, R + 2St), ``dt_w`` (R, Di), ``out_proj`` (Di, D) in
    ``cfg.dtype``; ``conv_b`` zeros in ``cfg.dtype``; ``dt_b`` (-4.6,
    softplus^-1(0.01)), ``A_log`` (log 1..St per channel) and ``Dskip``
    (ones) in float32; with ``cfg.mamba_dtbc_norm`` the ``dt_norm`` (R),
    ``b_norm`` and ``c_norm`` (St) scales, float32 ones."""
    D, Di, St = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    R, K = cfg.mamba_dt_rank, cfg.mamba_conv
    dt = getattr(torch, cfg.dtype)
    rnd = layers.randn_scaled
    p = {"norm": _norm_stack(cfg, D, L, device),
         "in_proj": rnd((L, D, 2 * Di), D ** -0.5, gen, dt, device),
         "conv_w": rnd((L, K, Di), K ** -0.5, gen, dt, device),
         "conv_b": torch.zeros((L, Di), dtype=dt, device=device),
         "x_proj": rnd((L, Di, R + 2 * St), Di ** -0.5, gen, dt, device),
         "dt_w": rnd((L, R, Di), R ** -0.5, gen, dt, device)}
    p["dt_b"] = torch.full((L, Di), -4.6, dtype=F32, device=device)
    p["A_log"] = torch.log(torch.arange(
        1, St + 1, dtype=F32, device=device)).expand(L, Di, St).clone()
    p["Dskip"] = torch.ones((L, Di), dtype=F32, device=device)
    p["out_proj"] = rnd((L, Di, D), Di ** -0.5, gen, dt, device)
    if cfg.mamba_dtbc_norm:
        for name, d in (("dt_norm", R), ("b_norm", St), ("c_norm", St)):
            p[name] = {"scale": torch.ones((L, d), dtype=F32, device=device)}
    return p


def _scan_chunk(a, b, c, h):
    """One chunk of the diagonal SSM: a, b (B, c, Di, St) float32, c
    (B, c, St), h (B, Di, St) the carry.  The doubling scan turns (a, b)
    into the inclusive prefix (A_t, B_t) of the combine, then h_t = A_t h
    + B_t and y_t = sum_s h_t[., s] c_t[s].  Returns (y (B, c, Di), the
    last h)."""
    n, d = a.shape[1], 1
    while d < n:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    h_all = a * h[:, None] + b                       # (B, c, Di, St)
    y = torch.einsum("bcds,bcs->bcd", h_all, c)
    return y, h_all[:, -1]


def _ssm_chunk_scan(dA, dBx, C, h0):
    """Chunked diagonal SSM scan.

    dA, dBx: (B, S, Di, St) f32; C: (B, S, St); h0: (B, Di, St).
    h_t = dA_t * h_{t-1} + dBx_t ; y_t = sum_s h_t[., s] * C_t[s].
    Returns (y (B, S, Di), h_final)."""
    S = dA.shape[1]
    chunk = _chunk(S)
    h, ys = h0, []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        y, h = _scan_chunk(dA[:, sl], dBx[:, sl], C[:, sl], h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _mamba_scan(dt, A, Bp, xf, Cp, h0):
    """``_ssm_chunk_scan`` of dA = exp(dt A), dBx = dt B x, built one
    chunk at a time, so no (B, S, Di, St) tensor exists at once."""
    S = dt.shape[1]
    chunk = _chunk(S)
    h, ys = h0, []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        d = dt[:, sl, :, None]
        dA = torch.exp(d * A)
        dBx = d * Bp[:, sl, None, :] * xf[:, sl, :, None]
        y, h = _scan_chunk(dA, dBx, Cp[:, sl], h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _gate(y, Dskip, xf, z, dtype):
    """The scan's epilogue: (y + Dskip x) silu(z) in float32, rounded
    to ``dtype``."""
    y = y + Dskip * xf
    y = y * F.silu(z.to(F32))
    return y.to(dtype)


def _scan_plain(dt_raw, dt_b, A_log, xc, Bp, Cp, Dskip, z, h0):
    """The selective-scan kernel's plain version (``kscan.mamba_scan``'s
    arguments): softplus, ``_mamba_scan`` and the epilogue; returns (y
    in xc's dtype, the last h)."""
    dt = softplus(dt_raw + dt_b)                                 # (B,S,Di)
    A = -torch.exp(A_log)                                        # (Di,St)
    xf = xc.to(F32)
    if h0 is None:
        Bn, _, Di = xc.shape
        h0 = torch.zeros((Bn, Di, A.shape[-1]), dtype=F32, device=xc.device)
    y, h = _mamba_scan(dt, A, Bp, xf, Cp, h0)
    return _gate(y, Dskip, xf, z, xc.dtype), h


def mamba_fwd(cfg, p, x, *, mode="train", cache=None, pos=0, tp=None):
    """Mamba block: norm, ``in_proj`` into (x, z), the causal conv and
    float32 ``silu`` (back to the model dtype), the selective
    projections (Jamba's norms on them with ``cfg.mamba_dtbc_norm``),
    the scan with the ``Dskip`` term and the ``silu(z)`` gate (the
    selective-scan kernel on the card, the plain chunked scan elsewhere;
    the one-step recurrence in decode), ``out_proj``.  ``cache``
    {"conv" (B, K-1, Di), "ssm" (B, Di, St) f32} is the state the
    sequence starts from (prefill and decode).

    ``tp`` (``ctx.TP``; None off a mesh): the leaves and caches are this
    rank's d_inner channels (Di is then the local width).  ``in_proj``'s
    local columns are re-split into this rank's channels of x and z by
    one all-to-all (``TP.columns``: the weight keeps the reference's
    contiguous placement, which its perturbation runs on); ``x_proj``'s
    (B, S, R + 2·St) partial sums are all-reduced before the split into
    ``dt_in``, ``B`` and ``C``, and ``out_proj``'s (B, S, D) after the
    gate, each summed in float32 and rounded once to the model dtype,
    the dtype of the reference's ``xc @ x_proj`` and ``y @ out_proj``."""
    St, R = cfg.mamba_d_state, cfg.mamba_dt_rank
    tp = tp or ctx.LOCAL
    h = layers.apply_norm(cfg, p["norm"], x)
    xin, z = tp.columns(h @ p["in_proj"], 2, tp.offset("in_proj", -1))
    conv_cache = cache["conv"] if cache is not None else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_cache)
    xc = F.silu(xc.to(F32)).to(x.dtype)

    proj = tp.sum(xc @ p["x_proj"]).to(F32)
    dt_in, Bp, Cp = torch.split(proj, [R, St, St], dim=-1)
    if cfg.mamba_dtbc_norm:
        dt_in = layers.rms_norm(dt_in, p["dt_norm"]["scale"])
        Bp = layers.rms_norm(Bp, p["b_norm"]["scale"])
        Cp = layers.rms_norm(Cp, p["c_norm"]["scale"])
    dt_raw = dt_in @ p["dt_w"].to(F32)                           # (B,S,Di)
    h0 = cache["ssm"].to(F32) if cache is not None else None

    if mode == "decode":
        dt = softplus(dt_raw + p["dt_b"])
        A = -torch.exp(p["A_log"])                               # (Di,St)
        xf = xc.to(F32)
        d = dt[:, 0, :, None]
        h1 = torch.exp(d * A) * h0 + d * Bp[:, 0, None, :] * xf[:, 0, :, None]
        y = torch.einsum("bds,bs->bd", h1, Cp[:, 0])[:, None]
        y, h_final = _gate(y, p["Dskip"], xf, z, x.dtype), h1
    else:
        with obs.prange(obs.MAMBA_SCAN):
            y, h_final = kscan.mamba_scan(
                _scan_plain, dt_raw, p["dt_b"], p["A_log"], xc, Bp, Cp,
                p["Dskip"], z, h0, final=mode == "prefill")
    out = tp.sum((y @ p["out_proj"]).to(x.dtype))
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = {"conv": new_conv, "ssm": h_final}
    return out, new_cache


# ------------------------------------------------------------------ mLSTM
def mlstm_params(cfg, gen, L, device):
    """One mLSTM block's leaves, stacked over ``L`` layers, drawn in the
    reference's order: ``in_proj`` (D, 2Di), ``conv_w`` (4, Di) at std
    0.5, ``wq``/``wk``/``wv`` (Di, Di), ``wif`` (Di, 2H), ``out_proj``
    (Di, D) in ``cfg.dtype``; ``conv_b`` zeros in ``cfg.dtype``; the
    gate biases ``b_i`` (zeros) and ``b_f`` (3.0) and the ``out_norm``
    scale in float32."""
    D, Di, H = cfg.d_model, cfg.lstm_d_inner, cfg.n_heads
    dt = getattr(torch, cfg.dtype)
    rnd = layers.randn_scaled
    p = {"norm": _norm_stack(cfg, D, L, device),
         "in_proj": rnd((L, D, 2 * Di), D ** -0.5, gen, dt, device),
         "conv_w": rnd((L, 4, Di), 0.5, gen, dt, device),
         "conv_b": torch.zeros((L, Di), dtype=dt, device=device)}
    for name in ("wq", "wk", "wv"):
        p[name] = rnd((L, Di, Di), Di ** -0.5, gen, dt, device)
    p["wif"] = rnd((L, Di, 2 * H), Di ** -0.5, gen, dt, device)
    p["b_i"] = torch.zeros((L, H), dtype=F32, device=device)
    p["b_f"] = torch.full((L, H), 3.0, dtype=F32, device=device)
    p["out_norm"] = {"scale": torch.ones((L, Di), dtype=F32, device=device)}
    p["out_proj"] = rnd((L, Di, D), Di ** -0.5, gen, dt, device)
    return p


def _mlstm_chunk(q, k, v, li, lf, state):
    """Stabilized chunkwise mLSTM.

    q,k,v: (B,c,H,dh) f32; li,lf: (B,c,H) log input / log-sigmoid forget
    gates; state = (C (B,H,dh,dh), n (B,H,dh), m (B,H)) — C and n are
    stored *stabilized*: true value = exp(m) * stored.  With m = -inf
    (no history) the carry's weights ``exp(m_inter - m_t)`` and
    ``exp(lf_tot + m - m_next)`` come out exactly 0: the diagonal keeps
    ``m_intra`` and so ``m_t`` and ``m_next`` finite.
    Returns (h (B,c,H,dh), new_state).
    """
    B, c, H, dh = q.shape
    C0, n0, m0 = state
    scale = dh ** -0.5
    lf_cum = torch.cumsum(lf, dim=1)                      # (B,c,H) inclusive
    lf_tot = lf_cum[:, -1]

    # intra-chunk log decay matrix: Dm[t,j] = lf_cum[t]-lf_cum[j]+li[j], j<=t
    Dm = lf_cum[:, :, None] - lf_cum[:, None, :] + li[:, None]   # (B,t,j,H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                device=q.device))[None, :, :, None]
    Dm = torch.where(tri, Dm, float("-inf"))
    m_intra = torch.amax(Dm, dim=2)                       # (B,c,H)
    m_inter = lf_cum + m0[:, None]                        # (B,c,H)
    m_t = torch.maximum(m_intra, m_inter)

    wexp = torch.where(tri, torch.exp(Dm - m_t[:, :, None]), 0.0)
    s = torch.einsum("bthd,bjhd->btjh", q, k) * scale
    w = s * wexp
    dec = torch.exp(m_inter - m_t)                        # (B,c,H) carry decay

    qs = q * scale
    num = (torch.einsum("btjh,bjhd->bthd", w, v)
           + torch.einsum("bthd,bhde->bthe", qs, C0) * dec[..., None])
    n_t = (torch.einsum("btjh,bjhd->bthd", wexp, k)
           + dec[..., None] * n0[:, None])
    qn = torch.einsum("bthd,bthd->bth", qs, n_t)
    denom = torch.maximum(torch.abs(qn), torch.exp(-m_t))
    h = num / denom[..., None]

    # carry update (end of chunk), re-stabilized to m_next
    g = lf_tot[:, None] - lf_cum + li                     # (B,j,H)
    m_next = torch.maximum(lf_tot + m0, torch.amax(g, dim=1))
    wC = torch.exp(g - m_next[:, None])                   # (B,j,H)
    carry = torch.exp(lf_tot + m0 - m_next)               # (B,H)
    C1 = (carry[:, :, None, None] * C0
          + torch.einsum("bjh,bjhd,bjhe->bhde", wC, k, v))
    n1 = carry[..., None] * n0 + torch.einsum("bjh,bjhd->bhd", wC, k)
    return h, (C1, n1, m_next)


def mlstm_fwd(cfg, p, x, *, mode="train", cache=None, pos=0):
    """mLSTM block: norm, ``in_proj`` into (u, gate), the causal conv
    (kernel 4) and float32 ``silu`` of u feeding q, k and the gates (v
    reads u), the chunkwise stabilized recurrence, ``out_norm``, the
    ``silu(gate)`` product and ``out_proj``.  ``cache`` {"conv" (B, 3,
    Di), "C" (B, H, dh, dh), "n" (B, H, dh), "m" (B, H)} is the state
    the sequence starts from (prefill and decode)."""
    B, S, D = x.shape
    Di, H = cfg.lstm_d_inner, cfg.n_heads
    dh = Di // H
    h0 = layers.apply_norm(cfg, p["norm"], x)
    u, gate = torch.split(h0 @ p["in_proj"], Di, dim=-1)
    conv_cache = cache["conv"] if cache is not None else None
    uc, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_cache)
    uc = F.silu(uc.to(F32)).to(x.dtype)

    q = (uc @ p["wq"]).reshape(B, S, H, dh).to(F32)
    k = (uc @ p["wk"]).reshape(B, S, H, dh).to(F32)
    v = (u @ p["wv"]).reshape(B, S, H, dh).to(F32)
    gif = (uc @ p["wif"]).to(F32).reshape(B, S, 2, H)
    li = gif[:, :, 0] + p["b_i"]                       # log-space input gate
    lf = F.logsigmoid(gif[:, :, 1] + p["b_f"])         # log forget gate

    if cache is not None:
        state = (cache["C"].to(F32), cache["n"].to(F32),
                 cache["m"].to(F32))
    else:
        state = (torch.zeros((B, H, dh, dh), dtype=F32, device=x.device),
                 torch.zeros((B, H, dh), dtype=F32, device=x.device),
                 torch.full((B, H), float("-inf"), dtype=F32,
                            device=x.device))

    chunk = _chunk(S)
    hs = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        hc, state = _mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], li[:, sl],
                                 lf[:, sl], state)
        hs.append(hc)
    h = torch.cat(hs, dim=1).reshape(B, S, Di)

    h = layers.rms_norm(h.to(x.dtype), p["out_norm"]["scale"])
    h = h * F.silu(gate.to(F32)).to(x.dtype)
    out = (h @ p["out_proj"]).to(x.dtype)
    new_cache = None
    if mode in ("decode", "prefill"):
        C1, n1, m1 = state
        new_cache = {"conv": new_conv, "C": C1, "n": n1, "m": m1}
    return out, new_cache


# ------------------------------------------------------------------ sLSTM
def slstm_params(cfg, gen, L, device):
    """One sLSTM block's leaves, stacked over ``L`` layers, drawn in the
    reference's order: ``wx`` (D, 4D) in ``cfg.dtype``, the
    block-diagonal recurrent ``rh`` (H, dh, 4dh) in float32, ``out_proj``
    (D, D) in ``cfg.dtype``; the gate bias ``b`` (4D: z and i zeros, f
    3.0, o zeros) and the ``out_norm`` scale in float32."""
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H
    dt = getattr(torch, cfg.dtype)
    rnd = layers.randn_scaled
    p = {"norm": _norm_stack(cfg, D, L, device),
         "wx": rnd((L, D, 4 * D), D ** -0.5, gen, dt, device),
         "rh": rnd((L, H, dh, 4 * dh), dh ** -0.5, gen, F32, device)}
    b = torch.zeros((4 * D,), dtype=F32, device=device)
    b[2 * D:3 * D] = 3.0
    p["b"] = layers._stacked(b, L)
    p["out_norm"] = {"scale": torch.ones((L, D), dtype=F32, device=device)}
    p["out_proj"] = rnd((L, D, D), D ** -0.5, gen, dt, device)
    return p


def slstm_fwd(cfg, p, x, *, mode="train", cache=None, pos=0):
    """Sequential sLSTM with exponential gating + stabilizer state.

    Gate preacts = x W + h_{t-1} R (block-diagonal per head, one batched
    matmul a step) + b.  Truly recurrent (h feeds back): a Python loop
    over every step, writing each h into a preallocated (S, B, H, dh)
    buffer; nothing in the loop reads a value back to the host.
    ``cache`` {"c", "n", "h", "m"} (B, H, dh) float32 is the state the
    sequence starts from (prefill and decode).
    """
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    xin = layers.apply_norm(cfg, p["norm"], x)
    gx = ((xin @ p["wx"]).to(F32) + p["b"]).reshape(B, S, 4, H, dh)

    if cache is not None:
        c, n, h, m = (cache[k].to(F32) for k in ("c", "n", "h", "m"))
    else:
        c = n = h = torch.zeros((B, H, dh), dtype=F32, device=x.device)
        m = torch.full((B, H, dh), float("-inf"), dtype=F32,
                       device=x.device)

    rh = p["rh"].to(F32).reshape(H, dh, 4 * dh)
    hs = torch.empty((S, B, H, dh), dtype=F32, device=x.device)
    for t in range(S):
        gr = torch.bmm(h.transpose(0, 1), rh).reshape(H, B, 4, dh)
        zt, it, ft, ot = (gx[:, t] + gr.permute(1, 2, 0, 3)).unbind(1)
        m_new = torch.maximum(ft + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(ft + m - m_new)
        zt = torch.tanh(zt)
        o_g = torch.sigmoid(ot)
        c = f_g * c + i_g * zt
        n = f_g * n + i_g
        h = o_g * c / torch.clamp(torch.abs(n), min=1.0)
        m = m_new
        hs[t] = h

    out = hs.transpose(0, 1).reshape(B, S, D).to(x.dtype)
    out = layers.rms_norm(out, p["out_norm"]["scale"])
    out = (out @ p["out_proj"]).to(x.dtype)
    new_cache = None
    if mode in ("decode", "prefill"):
        new_cache = {"c": c, "n": n, "h": h, "m": m}
    return out, new_cache

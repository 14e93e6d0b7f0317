"""Plain float32 reference of Jamba (arXiv:2403.19887) as the
configuration file states it, after Hugging Face's ``JambaForCausalLM``:
``num_hidden_layers`` RMSNorm blocks, each a mixer and an FFN.  Layer i
mixes by attention when ``i % attn_layer_period == attn_layer_offset``
and by a Mamba-1 mixer otherwise; its FFN is a mixture of experts when
``i % expert_layer_period == expert_layer_offset`` and a dense SwiGLU
of ``intermediate_size`` otherwise.  An untied head.

* Attention: grouped-query (each key/value head shared by
  ``num_attention_heads / num_key_value_heads`` query heads), no
  positional embedding, causal softmax at 1/sqrt(head width).
* Mamba: ``in_proj`` into (x, z), a depthwise causal conv of
  ``mamba_d_conv`` with bias, silu, ``x_proj`` into (dt_in, B, C) with
  an RMSNorm on each (``JambaMambaMixer``'s ``dt_layernorm``,
  ``b_layernorm``, ``c_layernorm``), delta = softplus(dt_in dt_w +
  dt_b), the recurrence h_t = exp(delta_t A) h_{t-1} + delta_t B_t x_t
  with A = -exp(A_log), run as a loop over t, y_t = <h_t, C_t> + Dskip
  x_t, gated by silu(z), ``out_proj``.
* Experts: a float32 softmax router over all ``n_routed_experts``, the
  ``num_experts_per_tok`` largest probabilities (ties to the lower
  expert) taken as they are, not renormalized; each expert a SwiGLU of
  ``intermediate_size``.

Departures from the published model, each named in the
configuration's ``reduced``: ``num_hidden_layers`` periods cut; this
card's share of an expert-parallel deployment, experts
``[expert_offset, expert_offset + num_experts)`` of
``n_routed_experts``, where an assignment to any other expert adds
nothing (``num_experts``); each row of a batch dispatches its tokens
under an expert capacity, an assignment kept when it is among the first
C of its expert in the row's token order (token-major, rank-minor),
else adding nothing (``capacity_factor``); RMSNorm epsilon 1e-5
(``rms_norm_eps``); bfloat16 storage with float32 norms and router
(``torch_dtype``).

Leaves follow the benchmark's layout: stage ``s0`` holds one period,
``b{j}`` the period's j-th block, each leaf stacked over the periods.
Each expert leaf of a layer is asked for, used and dropped before the
next, so that at most one float32 probe pair of expert weights is held.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (causal_softmax_attend,
                                        cross_entropy, rms_norm)

F32 = torch.float32
ATTN = ("norm/scale", "wq", "wk", "wv", "wo")
MAMBA = ("norm/scale", "in_proj", "conv_w", "conv_b", "x_proj",
         "dt_norm/scale", "b_norm/scale", "c_norm/scale", "dt_w", "dt_b",
         "A_log", "Dskip", "out_proj")
DENSE = ("norm/scale", "wg", "wu", "wd")


def _period(cfg) -> int:
    return cfg["attn_layer_period"]


def _blocks(cfg):
    """[(j, mixer, ffn)] of one period's blocks."""
    return [(j, "attn" if j % cfg["attn_layer_period"]
             == cfg["attn_layer_offset"] else "mamba",
             "moe" if j % cfg["expert_layer_period"]
             == cfg["expert_layer_offset"] else "dense")
            for j in range(_period(cfg))]


def leaves(cfg):
    """[(path, shape, dtype)] of the model's parameters."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh, F_ = D // H, cfg["intermediate_size"]
    Di, St = cfg["mamba_expand"] * D, cfg["mamba_d_state"]
    R, K = cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    E, Eh = cfg["n_routed_experts"], cfg["num_experts"]
    L = cfg["num_hidden_layers"] // _period(cfg)
    dt, f32 = cfg["torch_dtype"], "float32"
    out = [("embed/tok", (V, D), dt), ("final_norm/scale", (D,), f32),
           ("head/w", (D, V), dt)]
    for j, mixer, ffn in _blocks(cfg):
        m = f"stages/s0/b{j}/mix/"
        out.append((m + "norm/scale", (L, D), f32))
        if mixer == "attn":
            out += [(m + "wq", (L, D, H * dh), dt),
                    (m + "wk", (L, D, KV * dh), dt),
                    (m + "wv", (L, D, KV * dh), dt),
                    (m + "wo", (L, H * dh, D), dt)]
        else:
            out += [(m + "in_proj", (L, D, 2 * Di), dt),
                    (m + "conv_w", (L, K, Di), dt), (m + "conv_b", (L, Di), dt),
                    (m + "x_proj", (L, Di, R + 2 * St), dt),
                    (m + "dt_norm/scale", (L, R), f32),
                    (m + "b_norm/scale", (L, St), f32),
                    (m + "c_norm/scale", (L, St), f32),
                    (m + "dt_w", (L, R, Di), dt), (m + "dt_b", (L, Di), f32),
                    (m + "A_log", (L, Di, St), f32), (m + "Dskip", (L, Di), f32),
                    (m + "out_proj", (L, Di, D), dt)]
        f = f"stages/s0/b{j}/ffn/"
        out.append((f + "norm/scale", (L, D), f32))
        if ffn == "dense":
            out += [(f + "wg", (L, D, F_), dt), (f + "wu", (L, D, F_), dt),
                    (f + "wd", (L, F_, D), dt)]
        else:
            out += [(f + "router", (L, D, E), f32),
                    (f + "we_g", (L, Eh, D, F_), dt),
                    (f + "we_u", (L, Eh, D, F_), dt),
                    (f + "we_d", (L, Eh, F_, D), dt)]
    return out


def attention(cfg):
    """[(layers, heads, q.k width, value width)] of the causal attention."""
    n = sum(mixer == "attn" for _, mixer, _ in _blocks(cfg))
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    periods = cfg["num_hidden_layers"] // _period(cfg)
    return [(n * periods, H, D // H, D // H)]


def capacity(cfg, tokens: int) -> int:
    """Expert capacity of a row of ``tokens`` tokens: ceil(tokens k cf /
    E) over all E routed experts, rounded up to a multiple of 4 from 4
    tokens on, at most ``tokens``."""
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    c = -(-int(tokens * k * cfg["capacity_factor"]) // E)
    return max(1, min(tokens, -(-c // 4) * 4 if tokens >= 4 else c))


def _swiglu(prec, h, wg, wu, wd):
    return prec.mm(F.silu(prec.mm(h, wg)) * prec.mm(h, wu), wd)


def gqa(cfg, prec, w, x, eps):
    B, S, D = x.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = D // H
    h = rms_norm(x, w["norm/scale"], eps)
    q = prec.mm(h, w["wq"]).view(B, S, H, dh)
    k = prec.mm(h, w["wk"]).view(B, S, KV, dh)
    v = prec.mm(h, w["wv"]).view(B, S, KV, dh)
    # query head i reads key/value head i // (H / KV)
    k, v = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
    o = causal_softmax_attend(prec, q, k, v).reshape(B, S, H * dh)
    return prec.mm(o, w["wo"])


def mamba(cfg, prec, w, x, eps):
    B, S, D = x.shape
    Di, St = cfg["mamba_expand"] * D, cfg["mamba_d_state"]
    R, K = cfg["mamba_dt_rank"], cfg["mamba_d_conv"]
    h = rms_norm(x, w["norm/scale"], eps)
    xz = prec.mm(h, w["in_proj"])
    xi, z = xz[..., :Di], xz[..., Di:]
    # depthwise causal conv: y_t = sum_i w_i x_{t - K + 1 + i} + b
    xp = torch.cat([xi.new_zeros((B, K - 1, Di)), xi], dim=1)
    conv = w["conv_b"] + sum(xp[:, i:i + S] * w["conv_w"][i]
                             for i in range(K))
    xc = F.silu(conv)
    dt_in, Bm, Cm = torch.split(prec.mm(xc, w["x_proj"]), [R, St, St], -1)
    dt_in = rms_norm(dt_in, w["dt_norm/scale"], eps)
    Bm = rms_norm(Bm, w["b_norm/scale"], eps)
    Cm = rms_norm(Cm, w["c_norm/scale"], eps)
    delta = F.softplus(prec.mm(dt_in, w["dt_w"]) + w["dt_b"])   # (B,S,Di)
    A = -torch.exp(w["A_log"])                                  # (Di,St)
    hs = xc.new_zeros((B, Di, St))
    ys = []
    for t in range(S):
        d = delta[:, t, :, None]
        hs = (torch.exp(d * A) * hs
              + d * xc[:, t, :, None] * Bm[:, t, None, :])
        ys.append((hs * Cm[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, dim=1) + w["Dskip"] * xc) * F.silu(z)
    return prec.mm(y, w["out_proj"])


def moe(cfg, prec, getw, pre, l, xs, eps):
    """The MoE FFN of layer row ``l`` of ``pre`` for the P probes'
    inputs ``xs``: router, top-k and capacity over all experts, then
    the held experts' SwiGLU one leaf at a time (``we_g``, ``we_u``,
    ``we_d``, each asked for once and dropped after use)."""
    B, S, D = xs[0].shape
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    first, Eh = cfg["expert_offset"], cfg["num_experts"]
    norm, router = getw(pre + "norm/scale", l), getw(pre + "router", l)
    routes = []
    for p, x in enumerate(xs):
        h = rms_norm(x, norm[p], eps).reshape(B * S, D)
        probs = torch.softmax(prec.mm(h, router[p]), dim=-1)
        top_w, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_w, top_e = top_w[:, :k], top_e[:, :k]
        e_row = top_e.reshape(B, S * k)
        seen = torch.cumsum(F.one_hot(e_row, E), dim=1)
        e_all = top_e.reshape(-1)
        keep = ((torch.gather(seen, 2, e_row[..., None])[..., 0]
                 <= capacity(cfg, S)).reshape(-1)
                & (e_all >= first) & (e_all < first + Eh))
        tok = torch.arange(B * S, device=x.device).repeat_interleave(k)[keep]
        e_sel, w_sel = e_all[keep] - first, top_w.reshape(-1)[keep]
        order = torch.argsort(e_sel, stable=True)
        tok, e_sel, w_sel = tok[order], e_sel[order], w_sel[order]
        counts = torch.bincount(e_sel, minlength=Eh).tolist()
        routes.append((h, tok, w_sel, counts))

    def per_expert(fn):
        out = []
        for p, (h, tok, _, counts) in enumerate(routes):
            rows, off = h[tok], 0
            parts = []
            for e, n in enumerate(counts):
                parts.append(fn(p, e, rows[off:off + n]))
                off += n
            out.append(parts)
        return out

    wg = getw(pre + "we_g", l)
    acts = per_expert(lambda p, e, r: F.silu(prec.mm(r, wg[p, e])))
    del wg
    wu = getw(pre + "we_u", l)
    ups = per_expert(lambda p, e, r: prec.mm(r, wu[p, e]))
    del wu
    wd = getw(pre + "we_d", l)
    ys = []
    for p, (h, tok, w_sel, counts) in enumerate(routes):
        outs = [prec.mm(acts[p][e] * ups[p][e], wd[p, e])
                for e in range(Eh)]
        y = torch.zeros_like(h).index_add_(
            0, tok, torch.cat(outs) * w_sel[:, None])
        ys.append(y.reshape(B, S, D))
    return ys


def loss(cfg, getw, batch, P, prec):
    """The P probes' mean CE: ``getw(path, layer)`` gives a row's (P, ...)
    float32 weights, each row asked for once a step."""
    eps = cfg["rms_norm_eps"]
    tokens = batch["tokens"].long()
    tok = getw("embed/tok", 0)
    xs = [tok[p][tokens] for p in range(P)]
    for l in range(cfg["num_hidden_layers"] // _period(cfg)):
        for j, mixer, ffn in _blocks(cfg):
            pre = f"stages/s0/b{j}/"
            names, fn = (ATTN, gqa) if mixer == "attn" else (MAMBA, mamba)
            wm = {n: getw(pre + "mix/" + n, l) for n in names}
            for p in range(P):
                xs[p] = xs[p] + fn(cfg, prec, {n: t[p] for n, t in
                                               wm.items()}, xs[p], eps)
            del wm
            if ffn == "moe":
                ys = moe(cfg, prec, getw, pre + "ffn/", l, xs, eps)
                xs = [x + y for x, y in zip(xs, ys)]
                continue
            wf = {n: getw(pre + "ffn/" + n, l) for n in DENSE}
            for p in range(P):
                h = rms_norm(xs[p], wf["norm/scale"][p], eps)
                xs[p] = xs[p] + _swiglu(prec, h, wf["wg"][p], wf["wu"][p],
                                        wf["wd"][p])
            del wf
    fs, head = getw("final_norm/scale", 0), getw("head/w", 0)
    return [cross_entropy(prec.mm(rms_norm(xs[p], fs[p], eps), head[p]),
                          batch["labels"], batch["loss_mask"])
            for p in range(P)]

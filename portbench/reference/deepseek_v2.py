"""Plain float32 reference of DeepSeek-V2 (arXiv:2405.04434) as the
configuration file states it: RMSNorm blocks of multi-head latent
attention (no query compression; keys and values from a normed
``kv_lora_rank`` latent, a rope key of ``qk_rope_head_dim`` shared by
the heads) and an FFN that is dense (SwiGLU) in the first
``first_k_dense_replace`` layers and a mixture of experts after them: a
float32 softmax router, the ``num_experts_per_tok`` largest
probabilities (ties to the lower expert), renormalized, each routed
expert a SwiGLU of ``moe_intermediate_size``, and ``n_shared_experts``
experts' width of shared SwiGLU on every token.  An untied head.

Departures from the published model, each named in the configuration's
``reduced``: the top-k weights renormalized (``norm_topk_prob``), plain
rope over the two halves of the rope dims and no YaRN scaling
(``rope_scaling``), RMSNorm epsilon 1e-5 (``rms_norm_eps``).  Each row
of a batch dispatches its tokens under an expert capacity
(``capacity_factor``, the configuration's own key): an assignment is
kept when it is among the first C of its expert in the row's token
order (token-major, rank-minor), else it adds nothing.

Leaves follow the benchmark's layout: stage ``s0`` holds the dense
layers and ``s1`` the expert layers, each stacked over its layers.
"""
from __future__ import annotations

import torch

from portbench.reference.common import (causal_softmax_attend,
                                        cross_entropy, rms_norm, rope_half)

F32 = torch.float32
MLA = ("norm/scale", "wq", "wdkv", "kv_norm/scale", "wuk", "wuv", "wo")
DENSE = ("norm/scale", "wg", "wu", "wd")
MOE = ("norm/scale", "router", "we_g", "we_u", "we_d", "ws_g", "ws_u",
       "ws_d")


def _stages(cfg):
    k = cfg["first_k_dense_replace"]
    return [("stages/s0/b0/", k, "dense"),
            ("stages/s1/b0/", cfg["num_hidden_layers"] - k, "moe")]


def leaves(cfg):
    """[(path, shape, dtype)] of the model's parameters."""
    D, V, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, lora = cfg["v_head_dim"], cfg["kv_lora_rank"]
    E, F = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    Fs, Fd = cfg["n_shared_experts"] * F, cfg["intermediate_size"]
    dt, f32 = cfg["torch_dtype"], "float32"
    out = [("embed/tok", (V, D), dt), ("final_norm/scale", (D,), f32),
           ("head/w", (D, V), dt)]
    for pre, L, ffn in _stages(cfg):
        m = pre + "mix/"
        out += [(m + "norm/scale", (L, D), f32),
                (m + "wq", (L, D, H * (dn + dr)), dt),
                (m + "wdkv", (L, D, lora + dr), dt),
                (m + "kv_norm/scale", (L, lora), f32),
                (m + "wuk", (L, lora, H * dn), dt),
                (m + "wuv", (L, lora, H * dv), dt),
                (m + "wo", (L, H * dv, D), dt)]
        f = pre + "ffn/"
        out.append((f + "norm/scale", (L, D), f32))
        if ffn == "dense":
            out += [(f + "wg", (L, D, Fd), dt), (f + "wu", (L, D, Fd), dt),
                    (f + "wd", (L, Fd, D), dt)]
        else:
            out += [(f + "router", (L, D, E), f32),
                    (f + "we_g", (L, E, D, F), dt),
                    (f + "we_u", (L, E, D, F), dt),
                    (f + "we_d", (L, E, F, D), dt),
                    (f + "ws_g", (L, D, Fs), dt), (f + "ws_u", (L, D, Fs), dt),
                    (f + "ws_d", (L, Fs, D), dt)]
    return out


def attention(cfg):
    """[(layers, heads, q.k width, value width)] of the causal attention."""
    return [(cfg["num_hidden_layers"], cfg["num_attention_heads"],
             cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
             cfg["v_head_dim"])]


def capacity(cfg, tokens: int) -> int:
    """Expert capacity of a row of ``tokens`` tokens: ceil(tokens k cf /
    E), rounded up to a multiple of 4 from 4 tokens on, at most
    ``tokens``."""
    k, E = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    c = -(-int(tokens * k * cfg["capacity_factor"]) // E)
    return max(1, min(tokens, -(-c // 4) * 4 if tokens >= 4 else c))


def _swiglu(prec, h, wg, wu, wd):
    return prec.mm(torch.nn.functional.silu(prec.mm(h, wg)) * prec.mm(h, wu),
                   wd)


def mla(cfg, prec, w, x, eps):
    B, S, D = x.shape
    H = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, lora = cfg["v_head_dim"], cfg["kv_lora_rank"]
    h = rms_norm(x, w["norm/scale"], eps)
    q = prec.mm(h, w["wq"]).view(B, S, H, dn + dr)
    dkv = prec.mm(h, w["wdkv"])
    ckv = rms_norm(dkv[..., :lora], w["kv_norm/scale"], eps)
    kr = rope_half(dkv[..., lora:].reshape(B, S, 1, dr), cfg["rope_theta"])
    qr = rope_half(q[..., dn:], cfg["rope_theta"])
    kn = prec.mm(ckv, w["wuk"]).view(B, S, H, dn)
    v = prec.mm(ckv, w["wuv"]).view(B, S, H, dv)
    qf = torch.cat([q[..., :dn], qr], -1)
    kf = torch.cat([kn, kr.expand(B, S, H, dr)], -1)
    o = causal_softmax_attend(prec, qf, kf, v).reshape(B, S, H * dv)
    return prec.mm(o, w["wo"])


def moe(cfg, prec, w, x, eps):
    B, S, D = x.shape
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    h = rms_norm(x, w["norm/scale"], eps).reshape(B * S, D)
    probs = torch.softmax(prec.mm(h, w["router"]), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True)
    # kept: among the first C assignments of its expert in the row
    e_row = top_e.reshape(B, S * k)
    seen = torch.cumsum(torch.nn.functional.one_hot(e_row, E), dim=1)
    keep = (torch.gather(seen, 2, e_row[..., None])[..., 0]
            <= capacity(cfg, S)).reshape(-1)
    tok = torch.arange(B * S, device=x.device).repeat_interleave(k)[keep]
    e_sel, w_sel = top_e.reshape(-1)[keep], top_w.reshape(-1)[keep]
    order = torch.argsort(e_sel, stable=True)
    tok, e_sel, w_sel = tok[order], e_sel[order], w_sel[order]
    counts = torch.bincount(e_sel, minlength=E).tolist()
    hs, outs, off = h[tok], [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(_swiglu(prec, hs[off:off + n], w["we_g"][e],
                                w["we_u"][e], w["we_d"][e]))
        off += n
    y = torch.zeros_like(h).index_add_(0, tok, torch.cat(outs) * w_sel[:, None])
    y = y + _swiglu(prec, h, w["ws_g"], w["ws_u"], w["ws_d"])
    return y.reshape(B, S, D)


def loss(cfg, getw, batch, P, prec):
    """The P probes' mean CE: ``getw(path, layer)`` gives a row's (P, ...)
    float32 weights, each row asked for once a step."""
    eps = cfg["rms_norm_eps"]
    tokens = batch["tokens"].long()
    tok = getw("embed/tok", 0)
    xs = [tok[p][tokens] for p in range(P)]
    for pre, L, ffn in _stages(cfg):
        names = DENSE if ffn == "dense" else MOE
        for l in range(L):
            wm = {n: getw(pre + "mix/" + n, l) for n in MLA}
            for p in range(P):
                xs[p] = xs[p] + mla(cfg, prec, {n: t[p] for n, t in
                                                wm.items()}, xs[p], eps)
            wf = {n: getw(pre + "ffn/" + n, l) for n in names}
            for p in range(P):
                wp = {n: t[p] for n, t in wf.items()}
                if ffn == "dense":
                    h = rms_norm(xs[p], wp["norm/scale"], eps)
                    xs[p] = xs[p] + _swiglu(prec, h, wp["wg"], wp["wu"],
                                            wp["wd"])
                else:
                    xs[p] = xs[p] + moe(cfg, prec, wp, xs[p], eps)
    fs, head = getw("final_norm/scale", 0), getw("head/w", 0)
    return [cross_entropy(prec.mm(rms_norm(xs[p], fs[p], eps), head[p]),
                          batch["labels"], batch["loss_mask"])
            for p in range(P)]

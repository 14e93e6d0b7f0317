"""Plain float32 reference of the OPT decoder (arXiv:2205.01068) as the
configuration file states it: learned positions, pre-LayerNorm blocks of
multi-head causal attention and a ReLU FFN, a final LayerNorm and the
head tied to the token embedding.

Departures from the published model, each named in the configuration's
``reduced``: no biases in the attention and FFN projections
(``enable_bias``), bfloat16 weights (``torch_dtype``), no dropout, and
the position table read from row 0 (the published one skips two rows).

Leaves follow the benchmark's layout (the paths key the z streams):
``embed/{tok,pos}``, ``final_norm/{scale,bias}`` and, stacked over the
layers, ``stages/s0/b0/mix/{norm/*,wq,wk,wv,wo}`` and
``stages/s0/b0/ffn/{norm/*,wi,wd}``, matrices stored (in, out).
"""
from __future__ import annotations

import torch

from portbench.reference.common import (causal_softmax_attend,
                                        cross_entropy, layer_norm)

LN_EPS = 1e-5
MIX, FFN = "stages/s0/b0/mix/", "stages/s0/b0/ffn/"


def leaves(cfg):
    """[(path, shape, dtype)] of the model's parameters."""
    D, F, V = cfg["hidden_size"], cfg["ffn_dim"], cfg["vocab_size"]
    L, P = cfg["num_hidden_layers"], cfg["max_position_embeddings"]
    dt, f32 = cfg["torch_dtype"], "float32"
    out = [("embed/tok", (V, D), dt), ("embed/pos", (P, D), dt),
           ("final_norm/scale", (D,), f32), ("final_norm/bias", (D,), f32)]
    for pre in (MIX, FFN):
        out += [(pre + "norm/scale", (L, D), f32),
                (pre + "norm/bias", (L, D), f32)]
    out += [(MIX + n, (L, D, D), dt) for n in ("wq", "wk", "wv", "wo")]
    out += [(FFN + "wi", (L, D, F), dt), (FFN + "wd", (L, F, D), dt)]
    return out


def attention(cfg):
    """[(layers, heads, q.k width, value width)] of the causal attention."""
    H = cfg["num_attention_heads"]
    dh = cfg["hidden_size"] // H
    return [(cfg["num_hidden_layers"], H, dh, dh)]


def loss(cfg, getw, batch, P, prec):
    """The P probes' mean CE: ``getw(path, layer)`` gives a row's (P, ...)
    float32 weights, each row asked for once a step."""
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    tok, pos = getw("embed/tok", 0), getw("embed/pos", 0)
    xs = [tok[p][tokens] + pos[p][:S] for p in range(P)]
    for l in range(cfg["num_hidden_layers"]):
        w = {n: getw(MIX + n, l) for n in ("norm/scale", "norm/bias", "wq",
                                           "wk", "wv", "wo")}
        for p in range(P):
            h = layer_norm(xs[p], w["norm/scale"][p], w["norm/bias"][p],
                           LN_EPS)
            q, k, v = (prec.mm(h, w[n][p]).view(B, S, H, D // H)
                       for n in ("wq", "wk", "wv"))
            o = causal_softmax_attend(prec, q, k, v).reshape(B, S, D)
            xs[p] = xs[p] + prec.mm(o, w["wo"][p])
        w = {n: getw(FFN + n, l) for n in ("norm/scale", "norm/bias", "wi",
                                           "wd")}
        for p in range(P):
            h = layer_norm(xs[p], w["norm/scale"][p], w["norm/bias"][p],
                           LN_EPS)
            xs[p] = xs[p] + prec.mm(torch.relu(prec.mm(h, w["wi"][p])),
                                    w["wd"][p])
    fs, fb = getw("final_norm/scale", 0), getw("final_norm/bias", 0)
    out = []
    for p in range(P):
        h = layer_norm(xs[p], fs[p], fb[p], LN_EPS)
        logits = prec.mm(h, tok[p].T)
        out.append(cross_entropy(logits, batch["labels"], batch["loss_mask"]))
    return out

"""The work a step needs, counted from the configuration, the traffic and
the step's layer selection, and the peaks it is held against.

Nothing here reads the program: shapes come from the family reference's
leaves, the selection from the frozen copy in ``zrng``.
"""
from __future__ import annotations

import json
from pathlib import Path

from portbench import feed, weights, zrng

PEAKS = json.loads((Path(__file__).parent / "peaks.json").read_text())
ROUTED = ("/we_g", "/we_u", "/we_d")     # routed experts' stacks
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}
K1_SWEEPS = {"materialized": 3}          # K1's sweeps a step, by backend


def peaks(kind: str):
    """The published peaks of a card by its ``get_device_name``."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r} in peaks.json")
    return PEAKS[kind]


def head_matrix(cfg, leaves):
    """(path, K, N) of the output head: ``head/w`` (D, V), or the tied
    ``embed/tok`` read through a transpose."""
    paths = {p: s for p, s, _ in leaves}
    if "head/w" in paths:
        return ("head/w", *paths["head/w"])
    V, D = paths["embed/tok"]
    return ("embed/tok", D, V)


def matmuls(cfg, leaves):
    """[(path, layers, K, N, share)]: every weight matrix a token's
    forward multiplies by, with the share of its rows a token reads
    (routed experts: top_k of n_experts)."""
    out = []
    for path, shape, _ in leaves:
        rshape = weights.row_shape(path, shape)
        if not zrng.group_of(path) or len(rshape) < 2:
            continue
        share = 1.0
        K, N = rshape[-2], rshape[-1]
        if path.endswith(ROUTED):
            share = cfg["num_experts_per_tok"] / cfg["n_routed_experts"]
            K, N = K, N * rshape[0]           # the experts side by side
        out.append((path, shape[0], K, N, share))
    h, K, N = head_matrix(cfg, leaves)
    out.append((h, 1, K, N, 1.0))
    return out


def active_params(cfg, leaves) -> float:
    """Parameters a token's matrix products read: every layer matrix,
    routed experts at their top_k / n_experts share, the router, and the
    head (the tied head too); no embedding lookup, no norm."""
    return sum(L * K * N * share for _, L, K, N, share in matmuls(cfg, leaves))


def model_flops_per_step(cfg, family, traffic, leaves, forwards=2) -> float:
    """Model flops of a step: ``forwards`` x (2 N_active tokens +
    attention's score and value products over the causal pairs)."""
    B, S = traffic["batch"], traffic["seq_len"] - 1
    tokens = feed.tokens_per_step(traffic)
    pairs = S * (S + 1) / 2
    attn = sum(2.0 * B * L * H * pairs * (dqk + dv)
               for L, H, dqk, dv in family.attention(cfg))
    return forwards * (2.0 * active_params(cfg, leaves) * tokens + attn)


def k1_bytes(leaves, selections, sweeps: int) -> float:
    """Bytes K1 must move over the steps whose selections are given
    ({group: active layers} a step): each element of each row swept read
    once and written once, in its own dtype, for each of ``sweeps``."""
    total = 0
    for act in selections:
        for path, shape, dt in leaves:
            g = zrng.group_of(path)
            n_rows = 1 if g is None else len(act[g])
            total += n_rows * weights.numel_row(path, shape) * BYTES[dt]
    return 2.0 * sweeps * total

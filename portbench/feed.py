"""The token batches of a run, made on the device from ``--seed``.

Step ``t`` trains on ``batch`` rows of ``seq_len`` tokens drawn
uniformly from the vocabulary by a generator seeded by ``(seed, t)``;
inputs are the first ``seq_len - 1`` tokens, labels the last
``seq_len - 1`` (shifted by one), and the last ``loss_positions`` of each
row carry the loss, as the label word of a prompted classification task
does (the forward computes every position whatever the mask).  So each
step costs the same whatever the seed, and no two steps share a batch.
"""
from __future__ import annotations

import torch

from portbench import zrng

DATA_SALT = 0xDA7A


def batch(seed: int, t: int, traffic, vocab: int, device):
    """{tokens, labels, loss_mask} of step ``t``: int32 (B, S-1) ids and
    a float32 (B, S-1) mask, ones on the last ``loss_positions``."""
    B, S = traffic["batch"], traffic["seq_len"]
    gen = torch.Generator(device=device)
    gen.manual_seed(zrng.fold(zrng.fold(seed, DATA_SALT), t))
    toks = torch.randint(0, vocab, (B, S), generator=gen, device=device,
                         dtype=torch.int64)
    mask = torch.zeros((B, S - 1), dtype=torch.float32, device=device)
    mask[:, S - 1 - traffic["loss_positions"]:] = 1.0
    return {"tokens": toks[:, :-1].to(torch.int32).contiguous(),
            "labels": toks[:, 1:].to(torch.int32).contiguous(),
            "loss_mask": mask}


def tokens_per_step(traffic) -> int:
    """Positions each forward runs: B x (S - 1)."""
    return traffic["batch"] * (traffic["seq_len"] - 1)

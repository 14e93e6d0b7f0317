"""Host-side commit arithmetic for the swarm (DESIGN.md §14), a copy of
``repro/swarm/commit.py`` (numpy only): its outputs are the reference's
bit for bit.

The whole bit-identity story funnels through this file: every shard's
``(l+, l-)`` pair is reduced to the committed step scalars **in fixed
shard order, in float32, on the host** — by the coordinator, by every
worker checking a commit, and by the single-process sharded trainer.
Contributions are keyed by shard index, so the reduction literally
cannot see arrival order; two swarms (or a swarm and a lone process)
that saw the same shard losses commit the same bits.

The quorum fallback reuses the in-trainer quorum math
(``train/trainer.py::quorum_loss_fn``): the same ``n_ok = max(1, round(q·n))``
threshold and the same arrived-weighted mean ``Σ wᵢlᵢ / Σ wᵢ`` —
evaluated here with a left-to-right float32 loop instead of a tensor
reduction, which is what makes the result a function of the shard set
alone.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

f32 = np.float32


def quorum_count(n_shards: int, quorum: float) -> int:
    """Shards required to commit — the trainer's quorum_loss threshold."""
    return max(1, int(round(quorum * n_shards)))


def reduce_losses(pairs: Sequence[Optional[Sequence[float]]]
                  ) -> Tuple[np.float32, np.float32, List[int]]:
    """Arrived-weighted mean of the ±εz shard losses, fixed shard order.

    ``pairs[i]`` is shard i's ``(l+, l-)`` or ``None`` if it never
    arrived.  Returns ``(L+, L-, arrived)`` with the mean accumulated
    left-to-right in float32 — the committed bits depend only on which
    shards arrived, never on when.
    """
    lp = f32(0.0)
    lm = f32(0.0)
    w = f32(0.0)
    arrived = []
    for pair in pairs:
        if pair is None:
            arrived.append(0)
            continue
        arrived.append(1)
        lp = f32(lp + f32(pair[0]))
        lm = f32(lm + f32(pair[1]))
        w = f32(w + f32(1.0))
    if w == 0.0:
        raise ValueError("cannot commit a step with zero arrived shards")
    return f32(lp / w), f32(lm / w), arrived


def commit_scalars(pairs: Sequence[Optional[Sequence[float]]],
                   eps: float) -> Dict[str, object]:
    """The scalars a :class:`~repro_torch.swarm.proto.StepCommit` carries,
    from the per-shard loss pairs: two-point projected gradient
    ``g = (L+ − L−) / 2ε`` and the recorded loss ``(L+ + L−) / 2``."""
    lp, lm, arrived = reduce_losses(pairs)
    e = f32(eps)
    g = f32(f32(lp - lm) / f32(f32(2.0) * e))
    loss = f32(f32(0.5) * f32(lp + lm))
    return {"l_plus": lp, "l_minus": lm, "loss": loss,
            "projected_grad": g, "arrived": arrived}


def shard_losses_dict(pairs: Sequence[Optional[Sequence[float]]]
                      ) -> Dict[str, List[float]]:
    """JSON-row form: ``{shard_index: [l+, l-]}`` for arrived shards
    only (a quorum-degraded step records exactly what it reduced)."""
    return {str(i): [float(f32(p[0])), float(f32(p[1]))]
            for i, p in enumerate(pairs) if p is not None}

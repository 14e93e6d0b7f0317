"""ZO momentum and its Adam-style variant with no extra parameter memory
(counterpart of ``repro/core/zo_adaptive.py``).

The SPSA direction ``g_t * z_t`` regenerates from (base_seed, t), so a
K-step momentum update is a weighted sum of regenerable directions::

    m_t = sum_{j=0..K-1} beta^j * g_{t-j} * z_{t-j}

The state is a ring of the last K projected gradients (K float32
scalars), a scalar second moment ``v`` and a step count.  A step makes
a two-point materialized probe, restores it, then applies the K
directions as K axpy sweeps (kernel K1 under ``backend="pallas"``),
each z and its LeZO layer subset regenerated from its step's seed.
``adam`` divides the learning rate by sqrt(v_hat) of the projected
gradients (Adam's per-parameter v collapses to a scalar under SPSA).

The scalars are numpy float32 values computed in the reference's op
order.  A sweep for a step before 0 has scale 0 in the reference, and
``bf16(w + 0*z) = w``: it is skipped here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core import rng, zo


@dataclasses.dataclass(frozen=True)
class ZOMomentumConfig:
    eps: float = 1e-3
    lr: float = 1e-6
    beta: float = 0.9
    history: int = 8              # K regenerated directions
    n_drop: int = 0
    backend: str = "dense"
    adam: bool = False            # scale by 1/sqrt(v) of projected grads
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8


def momentum_update_(params, spec: zo.ZOSpec, cfg: ZOMomentumConfig,
                     state, g, lr, step_idx: int, base_seed: int):
    """Push ``g`` (this step's projected gradient) into the ring and
    apply the last K directions to ``params`` in place.  Returns
    ``(state, lr)``, the learning rate after the Adam scaling."""
    f32 = np.float32
    g_hist = np.roll(state["g_hist"], 1)
    g_hist[0] = g
    count = state["count"] + 1
    v = f32(cfg.adam_beta2) * state["v"] + f32(1 - cfg.adam_beta2) * g * g
    if cfg.adam:
        vhat = v / (f32(1.0) - f32(cfg.adam_beta2) ** f32(count))
        lr = f32(lr) / (np.sqrt(vhat) + f32(cfg.adam_eps))
    for j in range(cfg.history):
        t_j = step_idx - j
        if t_j < 0:
            continue
        seed_j = rng.fold_py(base_seed, t_j)
        masks_j, idxs_j, _ = zo.stratified_select(spec, seed_j, cfg.n_drop)
        scale = -f32(lr) * f32(cfg.beta) ** f32(j) * g_hist[j]
        zo.tree_axpy_(params, spec, seed_j, scale, masks_j, idxs_j,
                      backend=cfg.backend)
    return {"g_hist": g_hist, "v": v, "count": count}, lr


def make_zo_momentum_step(loss_fn: Callable, spec: zo.ZOSpec,
                          cfg: ZOMomentumConfig,
                          lr_schedule: Optional[Callable] = None):
    """``(step, init_state)``: ``step(params, state, batch, step_idx,
    base_seed) -> (params, state, metrics)``, updating ``params`` in
    place."""
    from repro_torch import estimators  # estimators builds on zo

    sched = lr_schedule or (lambda t: cfg.lr)
    est = estimators.build_estimator(
        spec, estimators.EstimatorConfig(
            name="two_point", eps=cfg.eps, lr=cfg.lr, n_drop=cfg.n_drop,
            policy="stratified", backend=cfg.backend, fused_update=False))

    def init_state():
        return {"g_hist": np.zeros((cfg.history,), np.float32),
                "v": np.float32(0.0), "count": 0}

    def step(params, state, batch, step_idx: int, base_seed: int):
        seed = rng.fold_py(base_seed, step_idx)
        # SPSA probe + immediate restore (momentum owns the update)
        params, dirs, em = est.estimate(loss_fn, params, batch, seed, state)
        est.restore_probe(params, dirs)
        g = dirs.coeffs[0]
        state, lr = momentum_update_(params, spec, cfg, state, g,
                                     sched(step_idx), step_idx, base_seed)
        return params, state, {"loss": em["loss"], "projected_grad": g,
                               "lr": lr}

    return step, init_state

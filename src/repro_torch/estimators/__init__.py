"""ZO gradient estimators of the port (counterpart of
``repro/estimators``).  This slice ports the two-point SPSA pair; the
one-sided, averaged and importance estimators are not yet ported.

    step = estimators.make_step(loss_fn, spec, cfg)
    params, metrics = step(params, batch, step_idx, base_seed)

The step updates ``params`` in place and returns it.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core import rng, zo
from repro_torch.estimators import costs
from repro_torch.estimators.base import (DirectionSet, Estimator,
                                         EstimatorConfig)
from repro_torch.estimators.two_point import TwoPointSPSA

REGISTRY = {"two_point": TwoPointSPSA}

__all__ = ["DirectionSet", "Estimator", "EstimatorConfig", "REGISTRY",
           "TwoPointSPSA", "build_estimator", "costs", "make_step"]


def build_estimator(spec: zo.ZOSpec, cfg: EstimatorConfig) -> Estimator:
    if cfg.name not in REGISTRY:
        raise ValueError(f"estimator {cfg.name!r} is not yet ported; "
                         f"ported: {tuple(REGISTRY)}")
    if cfg.forward_backend not in costs.FORWARD_BACKENDS:
        raise ValueError(
            f"unknown forward_backend {cfg.forward_backend!r}; pick from "
            f"{costs.FORWARD_BACKENDS}")
    return REGISTRY[cfg.name](spec, cfg)


def make_step(loss_fn: Callable, spec: zo.ZOSpec, cfg: EstimatorConfig,
              lr_schedule: Optional[Callable] = None):
    """``step(params, batch, step_idx, base_seed) -> (params, metrics)``.
    The step seed is ``fold(base_seed, step_idx)``, as in the reference."""
    est = build_estimator(spec, cfg)
    sched = lr_schedule or (lambda t: cfg.lr)

    def step(params, batch, step_idx: int, base_seed: int):
        seed = rng.fold_py(base_seed, step_idx)
        params, dirs, metrics = est.estimate(loss_fn, params, batch, seed)
        lr = sched(step_idx)
        est.apply_update(params, dirs, lr, 1.0 - lr * cfg.weight_decay)
        metrics = dict(metrics, lr=lr, seed=seed)
        return params, metrics

    return step

"""ZO gradient estimators of the port (counterpart of
``repro/estimators``): two-point SPSA, FZOO-style one-sided, averaged
pairs, and the importance-weighted selection wrapper.

    cfg = estimators.EstimatorConfig(name="one_sided", q=16, ...)
    step, init_state = estimators.make_step(loss_fn, spec, cfg)
    params, state, metrics = step(params, state, batch, step_idx, base_seed)

The step updates ``params`` in place and returns it.  ``state`` is the
estimator's small host state (the importance scores; ``{}`` for the
others).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import rng, zo
from repro_torch.estimators import costs
from repro_torch.estimators.averaged import AveragedSPSA
from repro_torch.estimators.base import (DirectionSet, Estimator,
                                         EstimatorConfig, direction_seeds)
from repro_torch.estimators.importance import ImportanceSelect
from repro_torch.estimators.one_sided import OneSidedBatched
from repro_torch.estimators.two_point import TwoPointSPSA

REGISTRY = {
    "two_point": TwoPointSPSA,
    "one_sided": OneSidedBatched,
    "averaged": AveragedSPSA,
    "importance": ImportanceSelect,
}
ESTIMATORS = tuple(REGISTRY)

__all__ = ["AveragedSPSA", "DirectionSet", "ESTIMATORS", "Estimator",
           "EstimatorConfig", "ImportanceSelect", "OneSidedBatched",
           "REGISTRY", "TwoPointSPSA", "build_estimator", "costs",
           "direction_seeds", "make_step"]


def build_estimator(spec: zo.ZOSpec, cfg: EstimatorConfig,
                    select_fn: Optional[Callable] = None) -> Estimator:
    if cfg.name not in REGISTRY:
        raise ValueError(f"unknown estimator {cfg.name!r}; pick from "
                         f"{ESTIMATORS}")
    if cfg.q < 1:
        raise ValueError(f"q must be >= 1, got {cfg.q}")
    if cfg.forward_backend not in costs.FORWARD_BACKENDS:
        raise ValueError(
            f"unknown forward_backend {cfg.forward_backend!r}; pick from "
            f"{costs.FORWARD_BACKENDS}")
    return REGISTRY[cfg.name](spec, cfg, select_fn=select_fn)


def make_step(loss_fn: Callable, spec: zo.ZOSpec, cfg: EstimatorConfig,
              lr_schedule: Optional[Callable] = None):
    """``(step, init_state)``: ``step(params, state, batch, step_idx,
    base_seed) -> (params, state, metrics)``.  The step seed is
    ``fold(base_seed, step_idx)``, as in the reference; the metrics carry
    the reference's health scalars (``coeffs``, ``n_active_params``,
    ``layer_sel``) beside the estimator's own."""
    est = build_estimator(spec, cfg)
    sched = lr_schedule or (lambda t: cfg.lr)

    def step(params, state, batch, step_idx: int, base_seed: int):
        seed = rng.fold_py(base_seed, step_idx)
        params, dirs, metrics = est.estimate(loss_fn, params, batch, seed,
                                             state)
        lr = sched(step_idx)
        est.apply_update(params, dirs, lr, 1.0 - lr * cfg.weight_decay)
        state = est.update_state(state, dirs, metrics)
        metrics = dict(metrics, lr=lr, seed=seed)
        if len(dirs):
            metrics["coeffs"] = np.array(dirs.coeffs, np.float32)
            shapes = zo.leaf_shapes(params)
            metrics["n_active_params"] = np.array(
                [zo.active_param_count(spec, shapes, m) for m in dirs.masks],
                np.float32)
            if spec.num_layers:
                metrics["layer_sel"] = sum(
                    zo.global_layer_mask(spec, m).to(torch.int32)
                    for m in dirs.masks).numpy()
        return params, state, metrics

    return step, est.init_state

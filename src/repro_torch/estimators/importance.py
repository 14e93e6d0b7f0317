"""Importance-weighted layer selection (counterpart of
``repro/estimators/importance.py``).

Each step every *active* layer's score takes an EMA step toward that
step's |projected gradient|; selection is Gumbel top-k by score within
each group under the static quotas of ``stratified_select``
(``zo.stratified_select_weighted``).  The state is ``num_layers``
float32 scores (40 for OPT-13B).

A wrapper: it drives the inner estimator (``cfg.inner``) by injecting
its weighted policy as the inner's ``select_fn``; probing, update and
cost counts are the inner estimator's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import zo
from repro_torch.estimators.base import DirectionSet, Estimator


class ImportanceSelect(Estimator):
    name = "importance"

    def __init__(self, spec, cfg, select_fn=None):
        super().__init__(spec, cfg, select_fn=select_fn)
        from repro_torch import estimators as _reg  # registry, post-import
        inner_cls = _reg.REGISTRY[cfg.inner]
        if inner_cls is ImportanceSelect:
            raise ValueError("importance cannot wrap itself")
        self.inner = inner_cls(spec, cfg,
                               select_fn=select_fn or self._weighted_select)

    def _weighted_select(self, seed, state):
        return zo.stratified_select_weighted(self.spec, seed,
                                             self.cfg.n_drop, state["imp"])

    def select(self, seed, state=None):
        return self.inner.select(seed, state)

    def init_state(self):
        st = dict(self.inner.init_state())
        st["imp"] = torch.ones((self.spec.num_layers,), dtype=torch.float32)
        return st

    def update_state(self, state, dirs: DirectionSet, metrics):
        st = dict(self.inner.update_state(state, dirs, metrics))
        imp = state["imp"]
        q = len(dirs)
        mu = self.cfg.importance_decay
        for i in range(q):
            gmask = zo.global_layer_mask(self.spec, dirs.masks[i])
            # coeffs carry the 1/q averaging weight; undo it so the score
            # tracks the raw per-direction |projected grad|
            w = torch.tensor(np.abs(np.float32(dirs.coeffs[i]))
                             * np.float32(q))
            imp = torch.where(gmask, mu * imp + (1.0 - mu) * w, imp)
        st["imp"] = imp
        return st

    def estimate(self, loss_fn, params, batch, seed, state=None):
        return self.inner.estimate(loss_fn, params, batch, seed, state)

    def restore_probe(self, params, dirs):
        return self.inner.restore_probe(params, dirs)

    def apply_update(self, params, dirs, lr, decay=1.0):
        return self.inner.apply_update(params, dirs, lr, decay)

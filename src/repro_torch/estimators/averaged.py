"""q antithetic SPSA pairs, averaged (counterpart of
``repro/estimators/averaged.py``)::

    ghat = (1/q) * sum_i g_i * z_i,   g_i = (L(+eps z_i) - L(-eps z_i)) / 2eps

Under ``forward_backend="virtual"`` each pair is one paired forward (a
K3 call at P = 2 per weight matmul, both probes drawing one z).
Materialized, each probe perturbs the parameters in place and restores
them before the next direction.  The update replays the q directions
as q axpy sweeps, each z regenerated from its seed.  At q = 1 this is
two-point SPSA with an unfused restore.
"""
from __future__ import annotations

import numpy as np

from repro_torch.estimators.base import (DirectionSet, Estimator,
                                         direction_seeds, host_f32)


class AveragedSPSA(Estimator):
    name = "averaged"

    def estimate(self, loss_fn, params, batch, seed, state=None):
        cfg = self.cfg
        q = cfg.q
        seeds = direction_seeds(seed, q)
        coeffs, masks, idxs, gs = [], [], [], []
        loss_acc = g_acc = np.float32(0.0)
        n_active = None
        for s in seeds:
            m, ix, na = self.select(s, state)
            n_active = na if n_active is None else n_active
            if self.virtual and cfg.paired_probes:
                ls = self._vloss_pair(loss_fn, params, batch, s, cfg.eps, m)
                l_plus, l_minus = host_f32(ls[0]), host_f32(ls[1])
            elif self.virtual:
                l_plus = host_f32(self._vloss(loss_fn, params, batch, s,
                                              cfg.eps, m))
                l_minus = host_f32(self._vloss(loss_fn, params, batch, s,
                                               -cfg.eps, m))
            else:
                self._ax(params, cfg.eps, s, m, ix)
                l_plus = host_f32(loss_fn(params, batch))
                self._ax(params, -2.0 * cfg.eps, s, m, ix)
                l_minus = host_f32(loss_fn(params, batch))
                self._ax(params, cfg.eps, s, m, ix)   # restore before next
            g = (l_plus - l_minus) / np.float32(2.0 * cfg.eps)
            coeffs.append(g / np.float32(q))
            gs.append(g)
            masks.append(m)
            idxs.append(ix)
            loss_acc = loss_acc + np.float32(0.5) * (l_plus + l_minus)
            g_acc = g_acc + g
        dirs = DirectionSet(seeds=seeds, coeffs=tuple(coeffs),
                            restore=(0.0,) * q, masks=tuple(masks),
                            idxs=tuple(idxs))
        metrics = {
            "loss": loss_acc / np.float32(q),
            "projected_grad": g_acc / np.float32(q),
            "probe_grads": np.array(gs, np.float32),   # per-direction g_i
            "eps": np.float32(cfg.eps),
            "active_layers": n_active,
        }
        return params, dirs, metrics

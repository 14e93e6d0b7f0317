"""Antithetic SPSA pair, MeZO/LeZO Algorithm 1 (counterpart of
``repro/estimators/two_point.py``): perturb +eps, loss, perturb -2eps,
loss, fused restore+update with scale ``eps - lr*g``.  Under a virtual
forward backend the probes are fused forwards (one paired forward by
default) and the step writes the parameters once, in the update.
"""
from __future__ import annotations

import numpy as np

from repro_torch.estimators.base import DirectionSet, Estimator, host_f32
from repro_torch.obs import trace as obs


class TwoPointSPSA(Estimator):
    name = "two_point"

    def estimate(self, loss_fn, params, batch, seed, state=None):
        cfg = self.cfg
        tr = obs.get_tracer()
        masks, idxs, n_active = self.select(seed, state)
        if self.virtual and cfg.paired_probes:
            with tr.span(obs.FWD_PAIR) as sp:
                losses = sp.fence(self._vloss_pair(loss_fn, params, batch,
                                                   seed, cfg.eps, masks))
            l_plus, l_minus = host_f32(losses[0]), host_f32(losses[1])
            restore = 0.0
        elif self.virtual:
            with tr.span(obs.FWD_PLUS) as sp:
                lp = sp.fence(self._vloss(loss_fn, params, batch, seed,
                                          cfg.eps, masks))
            with tr.span(obs.FWD_MINUS) as sp:
                lm = sp.fence(self._vloss(loss_fn, params, batch, seed,
                                          -cfg.eps, masks))
            l_plus, l_minus = host_f32(lp), host_f32(lm)
            restore = 0.0
        else:
            with tr.span(obs.PERTURB) as sp:
                sp.fence(self._ax(params, cfg.eps, seed, masks, idxs))
            with tr.span(obs.FWD_PLUS) as sp:
                lp = sp.fence(loss_fn(params, batch))
            l_plus = host_f32(lp)
            with tr.span(obs.PERTURB) as sp:
                sp.fence(self._ax(params, -2.0 * cfg.eps, seed, masks, idxs))
            with tr.span(obs.FWD_MINUS) as sp:
                lm = sp.fence(loss_fn(params, batch))
            l_minus = host_f32(lm)
            restore = cfg.eps
        tr.count(obs.CTR_PROBES, 2)
        g = (l_plus - l_minus) / np.float32(2.0 * cfg.eps)
        dirs = DirectionSet(seeds=(seed,), coeffs=(g,), restore=(restore,),
                            masks=(masks,), idxs=(idxs,))
        metrics = {
            "loss": np.float32(0.5) * (l_plus + l_minus),
            "l_plus": l_plus,
            "l_minus": l_minus,
            "projected_grad": g,
            "probe_grads": np.array([g], np.float32),
            "eps": np.float32(cfg.eps),
            "active_layers": n_active,
        }
        return params, dirs, metrics

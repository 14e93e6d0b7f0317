"""FZOO-style batched one-sided estimator (counterpart of
``repro/estimators/one_sided.py``, arXiv:2506.09034).

One unperturbed baseline forward is shared by q one-sided probes::

    g_i  = (L(theta + eps * z_i) - L(theta)) / eps
    ghat = (1/q) * sum_i g_i * z_i

Under ``forward_backend="virtual"`` with ``paired_probes`` the probes
ride stacked forwards, ``q_chunk`` at a time (all q when 0): every weight
matmul is one K3 call over P = q_chunk probes, each with its own seed and
LeZO layer predicate.  Otherwise the probes run one at a time (the
reference's vmap): a virtual forward each, or, materialized, a forward
of a perturbed copy of the parameters, which leaves ``params`` untouched
as the reference's functional perturbation does.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from repro_torch.core import zo
from repro_torch.estimators.base import (DirectionSet, Estimator,
                                         direction_seeds, host_f32)
from repro_torch.obs import trace as obs


class OneSidedBatched(Estimator):
    name = "one_sided"

    def _probe(self, loss_fn, params, batch, seed, masks):
        """loss(theta + eps*z(seed)) of one probe."""
        if self.virtual:
            return self._vloss(loss_fn, params, batch, seed, self.cfg.eps,
                               masks)
        p = copy.deepcopy(params)
        zo.tree_axpy_(p, self.spec, seed, self.cfg.eps, masks, None,
                      backend=self.cfg.backend)
        return loss_fn(p, batch)

    def estimate(self, loss_fn, params, batch, seed, state=None):
        cfg = self.cfg
        q = cfg.q
        seeds = direction_seeds(seed, q)
        sels = [self.select(s, state) for s in seeds]
        masks = tuple(s[0] for s in sels)
        idxs = tuple(s[1] for s in sels)
        n_active = sels[0][2]

        tr = obs.get_tracer()
        with tr.span(obs.FWD_BASE) as sp:
            l0 = sp.fence(loss_fn(params, batch))
        l0 = host_f32(l0)
        chunk = cfg.q_chunk if 0 < cfg.q_chunk < q else q
        parts = []
        # one span over all q probes, as in the reference
        with tr.span(obs.FWD_PLUS) as sp:
            for c0 in range(0, q, chunk):
                part = range(c0, min(c0 + chunk, q))
                if self.virtual and cfg.paired_probes:
                    sub = {g: torch.stack([masks[i][g] for i in part])
                           for g in masks[0]}
                    parts.append(self._vloss_stack(
                        loss_fn, params, batch, [seeds[i] for i in part],
                        cfg.eps, sub))
                else:
                    parts += [self._probe(loss_fn, params, batch, seeds[i],
                                          masks[i]).reshape(1)
                              for i in part]
            sp.fence(parts)
        losses = [np.float32(v) for v in torch.cat(parts).tolist()]
        tr.count(obs.CTR_PROBES, q)
        g = (np.array(losses, np.float32) - l0) / np.float32(cfg.eps)
        coeffs = tuple(g[i] / np.float32(q) for i in range(q))
        dirs = DirectionSet(seeds=seeds, coeffs=coeffs, restore=(0.0,) * q,
                            masks=masks, idxs=idxs)
        metrics = {
            "loss": l0,                                 # unperturbed loss
            "projected_grad": np.mean(g, dtype=np.float32),
            "probe_grads": g,                           # per-probe g_i
            "eps": np.float32(cfg.eps),
            "active_layers": n_active,
        }
        return params, dirs, metrics

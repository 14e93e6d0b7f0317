"""Estimator protocol of the port (counterpart of
``repro/estimators/base.py``): regenerable update directions, never
materialized.

An estimator probes the loss with seeded perturbations and returns a
:class:`DirectionSet` — ``(seed, coefficient)`` pairs whose update is::

    theta <- decay * theta - lr * sum_i coeffs[i] * z(seeds[i])

Each z regenerates from its seed through the counter RNG, so optimizer
state stays O(q) scalars.  The axpy sweeps update the parameters in
place (the reference donates and aliases them).

The scalars (losses, projected gradient, axpy scales) are float32 host
values computed with numpy in the reference's op order, so the scale a
kernel receives is the one the reference computes.

Estimator state (the importance wrapper's per-layer scores) is a dict
of small host tensors, threaded through ``make_step`` like the
reference's state pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import rng, zo
from repro_torch.distributed.ctx import is_dtensor
from repro_torch.estimators import costs
from repro_torch.obs import trace as obs

_DIR_SALT = 0xD16E  # folds the direction index into the step seed


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    name: str = "two_point"  # two_point | one_sided | averaged | importance
    eps: float = 1e-3
    lr: float = 1e-6
    q: int = 1                    # directions per step (ignored by two_point)
    q_chunk: int = 0              # one_sided: probes per stacked forward
                                  # (0 = all q in one forward)
    n_drop: int = 0               # 0 => MeZO; >0 => LeZO layer sparsity
    policy: str = "stratified"    # stratified | uniform
    backend: str = "dense"        # dense | scan | gather | pallas
    fused_update: bool = True
    weight_decay: float = 0.0
    inner: str = "two_point"      # estimator the importance wrapper drives
    importance_decay: float = 0.99  # EMA of the per-layer |g| scores
    # materialized | virtual | virtual_ref — virtual probes evaluate
    # loss(theta + s*eps*z) through the fused forward (repro_torch.fused)
    forward_backend: str = "materialized"
    # stack virtual probes onto ONE forward: two_point's ±εz pair, and
    # one_sided's q-chunks (bit-identical floats to the per-probe path)
    paired_probes: bool = True


@dataclasses.dataclass
class DirectionSet:
    """q regenerable update directions.  ``restore`` is the scale that
    undoes the probe perturbation still in the parameters (0.0 when the
    probe left them untouched)."""
    seeds: Tuple[int, ...]
    coeffs: Tuple[np.float32, ...]
    restore: Tuple[float, ...]
    masks: Tuple
    idxs: Tuple

    def __len__(self):
        return len(self.seeds)


def host_f32(x) -> np.float32:
    """A loss (0-dim tensor or float) as a float32 host scalar; a DTensor
    loss (a mesh step) is reduced over its partial placements first."""
    with obs.prange(obs.ZO_READBACK):
        if is_dtensor(x):
            x = x.full_tensor()
        return np.float32(x.item() if hasattr(x, "item") else x)


def direction_seeds(seed: int, q: int) -> Tuple[int, ...]:
    """Per-direction seeds.  Direction 0 keeps the step seed itself, so
    two_point — and averaged at q=1 — draw exactly the paper's z; further
    directions fold in the direction index."""
    return (seed,) + tuple(rng.fold_py(seed, _DIR_SALT + i)
                           for i in range(1, q))


class Estimator:
    """Selection / axpy / update machinery shared by the estimators.

    ``select_fn(seed, state)`` overrides the layer-selection policy (the
    importance wrapper injects its weighted policy this way)."""
    name = "base"

    def __init__(self, spec: zo.ZOSpec, cfg: EstimatorConfig,
                 select_fn: Optional[Callable] = None):
        if (cfg.backend == "gather" and cfg.policy != "stratified"
                and select_fn is None and cfg.name != "importance"):
            raise ValueError("gather backend requires the stratified policy")
        self.spec, self.cfg = spec, cfg
        self._select = select_fn

    def select(self, seed: int, state=None):
        """-> (masks {g: (L_g,) bool}, idxs {g: (k_g,) int64} | None,
        n_active)."""
        with obs.prange(obs.ZO_SELECT):
            if self._select is not None:
                sel = self._select(seed, state)
            elif self.cfg.policy == "stratified":
                sel = zo.stratified_select(self.spec, seed, self.cfg.n_drop)
            else:
                sel = zo.uniform_select(self.spec, seed, self.cfg.n_drop)
        tr = obs.get_tracer()
        if tr.enabled and not obs.tracing():
            tr.count(obs.CTR_SELECTS)
            tr.gauge(obs.GAUGE_ACTIVE, int(sel[2]))
        return sel

    def init_state(self) -> Dict:
        return {}

    def update_state(self, state, dirs: "DirectionSet", metrics):
        return state

    def _ax(self, p, scale, seed, masks, idxs, decay=1.0):
        return zo.tree_axpy_(p, self.spec, seed, scale, masks, idxs,
                             decay=decay, backend=self.cfg.backend)

    @property
    def virtual(self) -> bool:
        return self.cfg.forward_backend != "materialized"

    def _vloss(self, loss_fn, params, batch, seed, scale, masks):
        """loss(theta + scale*z(seed)) with zero parameter writes."""
        from repro_torch import fused
        ctx = fused.make_ctx(seed, scale, masks, self.cfg.forward_backend)
        return loss_fn(params, batch, perturb=ctx)

    def _vloss_pair(self, loss_fn, params, batch, seed, eps, masks):
        """The ±εz pair as ONE fused forward: the (2,) vector
        [l_plus, l_minus], the floats of two ``_vloss`` calls."""
        from repro_torch import fused
        ctx = fused.make_pair_ctx(seed, eps, masks, self.cfg.forward_backend)
        return loss_fn(params, batch, perturb=ctx)

    def _vloss_stack(self, loss_fn, params, batch, seeds, scale, masks):
        """P independent probes stacked onto one forward (one_sided's
        q-chunks): ``masks`` {g: (P, L_g)}; the (P,) loss vector, the
        floats of P ``_vloss`` calls."""
        from repro_torch import fused
        ctx = fused.make_stack_ctx(seeds, scale, masks,
                                   self.cfg.forward_backend)
        return loss_fn(params, batch, perturb=ctx)

    def estimate(self, loss_fn, params, batch, seed, state=None):
        """Probe the loss -> (params, DirectionSet, metrics)."""
        raise NotImplementedError

    def restore_probe(self, params, dirs: DirectionSet):
        for i, r in enumerate(dirs.restore):
            if r != 0.0:
                self._ax(params, r, dirs.seeds[i], dirs.masks[i],
                         dirs.idxs[i])
        return params

    def apply_update(self, params, dirs: DirectionSet, lr, decay=1.0):
        """theta <- decay*theta - lr * sum_i coeffs[i] * z_i, as q axpy
        passes (restore folded into the single pass when q == 1)."""
        lr32 = np.float32(lr)
        with obs.get_tracer().span(obs.UPDATE) as sp:
            if (self.cfg.fused_update and len(dirs) == 1
                    and dirs.restore[0] != 0.0):
                scale = np.float32(dirs.restore[0]) - lr32 * dirs.coeffs[0]
                return sp.fence(self._ax(params, scale, dirs.seeds[0],
                                         dirs.masks[0], dirs.idxs[0], decay))
            params = self.restore_probe(params, dirs)
            for i in range(len(dirs)):
                self._ax(params, -lr32 * dirs.coeffs[i], dirs.seeds[i],
                         dirs.masks[i], dirs.idxs[i],
                         decay if i == 0 else 1.0)
            return sp.fence(params)

    def step_counts(self) -> Dict:
        """Analytic per-step cost counts (``estimators/costs.py``)."""
        return costs.step_counts(self.cfg.name, q=self.cfg.q,
                                 fused_update=self.cfg.fused_update,
                                 inner=self.cfg.inner,
                                 num_layers=self.spec.num_layers,
                                 forward_backend=self.cfg.forward_backend)

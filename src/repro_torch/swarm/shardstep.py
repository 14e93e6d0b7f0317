"""Decomposed sharded ZO step of the port — the swarm's unit of
execution (counterpart of ``repro/swarm/shardstep.py``; DESIGN.md §14).

When the spec's ``swarm`` node is active, **both** the single-process
trainer and every swarm worker run this decomposed step in place of the
estimator's:

1. ``probe_shard(params, shard, seed) -> (l+, l-)`` — one ±εz two-point
   probe per loss shard, as host float32.  It never changes ``params``,
   not by an ulp: the virtual probes (``forward_backend`` virtual or
   virtual_ref) write nothing, and the materialized probe, which
   perturbs in place (+εz, −2εz), copies the rows it touched back from
   a copy it took first.  So the parameter trajectory is a pure fold of
   commits over the ``(seed, g)`` log, which is what lets a replacement
   worker rebuild the parameters from the commit log without a weight
   transfer.
2. a host-side float32 reduction in fixed shard order
   (:mod:`repro_torch.swarm.commit`) — identical bits no matter which
   process evaluated which shard, or in what order contributions
   arrived.
3. ``apply_commit(params, seed, g)`` — one update axpy sweep
   ``θ ← decay·θ − lr·g·z`` in place (kernel K1 under
   ``runtime.backend=pallas``).

The shard count is fixed by the *spec* (``api.validate.swarm_shards``),
not by live membership, so a 1-, 2- and 4-worker swarm — and a lone
``launch train`` — commit byte-identical steps on the same spec.
``arrived`` (quorum fallback) is an explicit input, recorded per step
and replayed from the run log.

The coordinator holds no parameters: :func:`abstract_trainable` builds
the trainable tree on the ``meta`` device (shapes and dtypes, no
storage), from which :class:`SelectionOracle` derives the selection
metrics and, with ``telemetry.health_norms``, the exact ‖z‖ on its
device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import estimators, resolve_device
from repro_torch.core import rng, zo
from repro_torch.swarm import commit as commit_mod


def shard_batch(batch, n_shards: int) -> List[dict]:
    """Split a batch dict into ``n_shards`` contiguous equal slices
    along axis 0 — shard i is rows ``[i·B/n, (i+1)·B/n)``, the same
    fixed assignment everywhere."""
    n = next(iter(batch.values())).shape[0]
    if n % n_shards:
        raise ValueError(f"batch of {n} does not divide into "
                         f"{n_shards} shards")
    per = n // n_shards
    return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            for i in range(n_shards)]


def _selection_metrics(est, zspec: zo.ZOSpec, shapes, seed: int) -> Dict:
    """The layer-selection health scalars of one seed, as the reference's
    ``sel_metrics`` computes them: a pure function of the seed and the
    tree's shapes."""
    masks, _, n_active = est.select(seed, {})
    out = {
        "active_layers": np.int32(n_active),
        "n_active_params": np.asarray(
            [zo.active_param_count(zspec, shapes, masks)], np.float32),
    }
    if zspec.num_layers:
        out["layer_sel"] = zo.global_layer_mask(zspec, masks).to(
            torch.int32).numpy()
    return out


class ShardedZOStep:
    """Drop-in for the trainer's step on swarm specs.

    ``__call__(params, state, batch, step_idx, base_seed, arrived=None)
    -> (params, state, metrics)`` — the trainer's step interface, plus
    the quorum mask.  ``state`` is the empty dict (two_point is
    stateless), which keeps ``launch replay``'s stateless fast-forward
    path working.  Metrics are host numpy scalars; rows gain ``arrived``
    and ``shard_losses`` so a quorum-degraded commit replays exactly.
    """

    sharded = True

    def __init__(self, loss_fn, zspec: zo.ZOSpec,
                 cfg: estimators.EstimatorConfig, n_shards: int,
                 shapes: Sequence):
        if cfg.name != "two_point":
            raise ValueError("the sharded step carries one (l+, l-) pair "
                             f"per shard — two_point only, got {cfg.name!r}")
        self.n_shards = int(n_shards)
        self.cfg = cfg
        self.zspec = zspec
        self.shapes = tuple(tuple(s) for s in shapes)
        self.loss_fn = loss_fn
        self.est = estimators.build_estimator(zspec, cfg)

    # ------------------------------------------------------ shard-level
    @torch.no_grad()
    def _probe(self, params, shard, seed: int) -> torch.Tensor:
        """The (2,) float32 tensor [l+, l-] of one shard; ``params`` end
        bit-equal to how they began."""
        est, cfg, loss_fn = self.est, self.cfg, self.loss_fn
        masks, idxs, _ = est.select(seed, {})
        if est.virtual and cfg.paired_probes:
            return est._vloss_pair(loss_fn, params, shard, seed, cfg.eps,
                                   masks).to(torch.float32)
        if est.virtual:
            lp = est._vloss(loss_fn, params, shard, seed, cfg.eps, masks)
            lm = est._vloss(loss_fn, params, shard, seed, -cfg.eps, masks)
            return torch.stack([lp, lm]).to(torch.float32)
        saved = self._save_active(params, masks)
        est._ax(params, cfg.eps, seed, masks, idxs)
        lp = loss_fn(params, shard)
        est._ax(params, -2.0 * cfg.eps, seed, masks, idxs)
        lm = loss_fn(params, shard)
        out = torch.stack([lp, lm]).to(torch.float32)
        self._load_active(params, saved)
        return out

    def _save_active(self, params, masks):
        """Copies of what a materialized probe writes: the active rows of
        each stacked leaf and every always-perturbed leaf whole."""
        saved = []
        for (path, leaf), group in zip(zo.leaf_items(params),
                                       self.zspec.groups):
            if group is None:
                saved.append((leaf, None, leaf.detach().clone()))
                continue
            rows = torch.nonzero(masks[group].cpu()).flatten().to(
                leaf.device)
            if rows.numel():
                saved.append((leaf, rows, leaf.detach()[rows]))
        return saved

    @staticmethod
    def _load_active(params, saved):
        for leaf, rows, copy in saved:
            if rows is None:
                leaf.data.copy_(copy)
            else:
                leaf.data.index_copy_(0, rows, copy)

    def probe_shard(self, params, shard, seed: int) -> np.ndarray:
        """(l+, l-) for one shard as host float32 — what a worker puts
        in its :class:`~repro_torch.swarm.proto.StepContribution`."""
        return self._probe(params, shard, int(seed)).cpu().numpy()

    @torch.no_grad()
    def apply_commit(self, params, seed: int, g: float):
        """Fold one committed ``(seed, g)`` into params in place:
        ``θ ← decay·θ − lr·g·z`` — the elastic fast-forward primitive."""
        cfg = self.cfg
        masks, idxs, _ = self.est.select(int(seed), {})
        decay = 1.0 - cfg.lr * cfg.weight_decay
        scale = -np.float32(cfg.lr) * np.float32(g)
        return self.est._ax(params, scale, int(seed), masks, idxs, decay)

    def selection_metrics(self, seed: int) -> Dict:
        """The layer-selection health scalars for a committed seed;
        pure function of the seed — no parameters involved."""
        return _selection_metrics(self.est, self.zspec, self.shapes,
                                  int(seed))

    # ------------------------------------------------------- trainer API
    def __call__(self, params, state, batch, step_idx, base_seed,
                 arrived: Optional[Sequence[int]] = None):
        t = int(step_idx)
        seed = rng.fold_py(int(base_seed), t)
        shards = shard_batch(batch, self.n_shards)
        if arrived is None:
            arrived = [1] * self.n_shards
        if len(arrived) != self.n_shards:
            raise ValueError(f"arrived mask of {len(arrived)} for "
                             f"{self.n_shards} shards")
        # launch every arrived probe before fetching any — the host
        # reduction then drains them in fixed shard order
        pending = {i: self._probe(params, shards[i], seed)
                   for i in range(self.n_shards) if arrived[i]}
        pairs = [pending[i].cpu().numpy() if i in pending else None
                 for i in range(self.n_shards)]
        scal = commit_mod.commit_scalars(pairs, self.cfg.eps)
        g = scal["projected_grad"]
        params = self.apply_commit(params, seed, g)
        metrics = {
            "loss": scal["loss"],
            "projected_grad": g,
            "probe_grads": np.asarray([g], np.float32),
            "coeffs": np.asarray([g], np.float32),
            "eps": np.float32(self.cfg.eps),
            "lr": float(self.cfg.lr),
            "seed": seed,
            "arrived": np.asarray(scal["arrived"], np.int32),
            "shard_losses": commit_mod.shard_losses_dict(pairs),
        }
        metrics.update(self.selection_metrics(seed))
        return params, state, metrics


def from_trainer(trainer, n_shards: int) -> ShardedZOStep:
    """The trainer hook: build the sharded step from an already-built
    Trainer's loss/spec/config (``Trainer._build_step`` calls this when
    the experiment's swarm node is active)."""
    return ShardedZOStep(trainer.loss_fn, trainer.spec, trainer.est_cfg,
                         n_shards, zo.leaf_shapes(trainer.params))


# --------------------------------------------------- paramless builders
def abstract_trainable(experiment):
    """The trainable tree on the ``meta`` device (shapes and dtypes, no
    storage) + its ZO group_fn + the derived configs — so the
    coordinator, which never holds parameters, builds selection metrics
    and z-norms without allocating the model."""
    from repro_torch import api
    from repro_torch.models import lm
    from repro_torch.peft import lora as lora_mod
    from repro_torch.peft import prefix as prefix_mod

    d = api.derive(experiment)
    tcfg, mcfg = d.tcfg, d.model_cfg
    meta = torch.device("meta")
    if tcfg.peft == "lora":
        tr = lora_mod.init_lora(lm.init_params(mcfg, None, meta),
                                d.lora_cfg, None)
        group_fn = lora_mod.lora_group_fn
    elif tcfg.peft == "prefix":
        tr = prefix_mod.init_prefix(mcfg, None, d.prefix_cfg, meta)
        group_fn = prefix_mod.prefix_group_fn
    else:
        tr = lm.init_params(mcfg, None, meta)
        group_fn = lm.zo_group_fn
    return tr, group_fn, d


def trainable_param_count(experiment) -> int:
    """Total trainable parameters — the FO all-reduce baseline is
    ``4 · this`` bytes per step (float32 gradients)."""
    tr, _, _ = abstract_trainable(experiment)
    return int(sum(int(np.prod(s)) for s in zo.leaf_shapes(tr)))


class SelectionOracle:
    """Coordinator-side seed -> health metrics, built without params.

    The same selection program as :class:`ShardedZOStep` plus the exact
    ‖z‖ norm fn the trainer uses for ``telemetry.health_norms``
    (``core/zo.py::tree_z_norm`` on ``device``, the card unless the
    caller asks for the CPU) — all shape-only, from the abstract
    trainable.
    """

    def __init__(self, experiment, device=None):
        tr, group_fn, d = abstract_trainable(experiment)
        self.zspec = zo.build_spec(tr, group_fn)
        self.shapes = zo.leaf_shapes(tr)
        self.est_cfg = d.est_cfg
        self.device = resolve_device(device)
        self._est = estimators.build_estimator(self.zspec, d.est_cfg)
        zspec, shapes = self.zspec, self.shapes

        def norm_fn(seed, layer_sel):
            gmask = torch.as_tensor(np.asarray(layer_sel) > 0)
            return zo.tree_z_norm(zspec, shapes, seed,
                                  zspec.split_mask(gmask), self.device)

        self.norm_fn = norm_fn if self.zspec.num_layers else None

    @property
    def num_layers(self) -> int:
        return self.zspec.num_layers or 0

    def metrics(self, seed: int) -> Dict:
        return _selection_metrics(self._est, self.zspec, self.shapes,
                                  int(seed))

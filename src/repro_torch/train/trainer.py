"""Training driver of the port (counterpart of ``repro/train/trainer.py``):
ZO (any estimator), ZO momentum and first-order (the paper's FT rows) on
the synthetic task; the log and eval cadence; best parameters by
validation loss (the paper's protocol); checkpoints every ``ckpt_every``
steps and resume from the latest; and the loss-shard quorum.

The step seeds and batches are the reference's: ``base_seed =
fold(seed, 0xC0FFEE)``, step seed ``fold(base_seed, t)``, and batches
from ``synthetic.batches(..., seed=seed + 7)``, so from the same initial
weights both packages train on the same data with the same z.  A resumed
run skips the batches of the steps before the checkpoint and so replays
the uninterrupted run.  As in the reference, estimator and optimizer
state (importance scores, the momentum ring, FO moments) is not
checkpointed and starts afresh on resume.

Quorum (``n_loss_shards`` > 1, ``quorum`` < 1): the batch is split into
``n_loss_shards`` shards and each loss averages the shards that
"arrived", a subset fixed by the batch's content as in the reference.

The trainer runs on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import estimators, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import fo, rng, zo, zo_adaptive
from repro_torch.data import synthetic
from repro_torch.models import lm

MODEL_BATCH_KEYS = ("tokens", "labels", "loss_mask")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 500
    batch_size: int = 16
    eval_every: int = 100
    log_every: int = 50
    seed: int = 0
    mode: str = "zo"              # zo | zo_momentum | fo
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    keep_ckpts: int = 2
    n_loss_shards: int = 1        # straggler simulation
    quorum: float = 1.0


def quorum_arrived(labels: torch.Tensor, n_shards: int, n_ok: int):
    """(n_shards,) bool: the shards that "arrive" for this batch — the
    reference's deterministic subset keyed by the batch's last labels."""
    tag = int(labels[:, -1].to(torch.int64).sum().item()) & rng.MASK32
    ids = torch.arange(n_shards, dtype=torch.int64)
    bits = rng.mix32((ids * rng.GOLDEN + rng.fold_py(tag, 0xFA11))
                     & rng.MASK32)
    return torch.argsort(bits) < n_ok


def quorum_loss_fn(base_loss, n_shards: int, quorum: float):
    """``base_loss`` averaged over the arrived shards of the batch."""
    n_ok = max(1, int(round(quorum * n_shards)))

    def loss_fn(params, batch, perturb=None):
        w = quorum_arrived(batch["labels"], n_shards, n_ok).to(torch.float32)
        losses = torch.stack([
            base_loss(params, {k: v.reshape(n_shards, -1, *v.shape[1:])[i]
                               for k, v in batch.items()}, perturb=perturb)
            for i in range(n_shards)])
        w = w.to(losses.device).reshape(-1, *[1] * (losses.dim() - 1))
        return torch.sum(losses * w, dim=0) / torch.sum(w)

    return loss_fn


class Trainer:
    """Built from a spec with :meth:`from_spec`.  ``params`` (an
    ``lm.LM``) replaces the random initial weights, e.g. weights exported
    from the reference with ``lm.params_from_numpy``; it is trained in
    place."""

    @classmethod
    def from_spec(cls, spec, device=None, params=None) -> "Trainer":
        from repro_torch.api import runners
        d = runners.derive(spec)
        return cls(d.model_cfg, d.task, d.tcfg, d.est_cfg, fo_cfg=d.fo_cfg,
                   device=device, params=params, _spec=spec, _derived=d)

    def __init__(self, model_cfg, task: synthetic.TaskConfig,
                 tcfg: TrainConfig, est_cfg: estimators.EstimatorConfig,
                 fo_cfg: fo.FOConfig = fo.FOConfig(), device=None,
                 params: Optional[lm.LM] = None, _spec=None, _derived=None):
        if tcfg.mode != "zo" and est_cfg.forward_backend != "materialized":
            raise ValueError("forward_backend='virtual' requires mode='zo'")
        self.experiment, self.derived = _spec, _derived
        self.mcfg, self.task, self.tcfg = model_cfg, task, tcfg
        self.est_cfg, self.fo_cfg = est_cfg, fo_cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
            params = lm.init_params(model_cfg, gen, self.device)
        self.params = params
        self.spec = zo.build_spec(params, lm.zo_group_fn)
        self.loss_fn = self._make_loss(grad=tcfg.mode == "fo")
        self._eval_loss = self._make_loss(grad=False)
        self._build_step()
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
                     if tcfg.ckpt_dir else None)

    def _make_loss(self, grad: bool):
        """The model's loss, over the arrived shards when the quorum is
        on; ``grad`` records the graph (first-order training)."""
        mcfg, tcfg = self.mcfg, self.tcfg

        def base_loss(p, b, perturb=None):
            return lm.lm_loss(mcfg, p, b, perturb=perturb, grad=grad)

        if tcfg.n_loss_shards > 1 and tcfg.quorum < 1.0:
            return quorum_loss_fn(base_loss, tcfg.n_loss_shards, tcfg.quorum)
        return base_loss

    def _build_step(self):
        mode, e = self.tcfg.mode, self.est_cfg
        if mode == "zo":
            self._step, init = estimators.make_step(self.loss_fn, self.spec,
                                                    e)
            self.state = init()
        elif mode == "zo_momentum":
            mcfg = zo_adaptive.ZOMomentumConfig(
                eps=e.eps, lr=e.lr, n_drop=e.n_drop, backend=e.backend)
            self._step, init = zo_adaptive.make_zo_momentum_step(
                self.loss_fn, self.spec, mcfg)
            self.state = init()
        else:                                        # fo
            step = fo.make_fo_step(self.loss_fn, self.fo_cfg)
            self._step = lambda p, st, b, t, _base: step(p, st, b, t)
            self.state = fo.init_state(self.params, self.fo_cfg)

    # ------------------------------------------------------------- data
    def make_dataset(self, n: int, seed_shift: int = 0):
        return synthetic.make_dataset(
            dataclasses.replace(self.task, seed=self.task.seed + seed_shift)
            if seed_shift else self.task, n)

    def _model_batch(self, np_batch, n=None):
        return {k: torch.as_tensor(v if n is None else v[:n],
                                   device=self.device)
                for k, v in np_batch.items() if k in MODEL_BATCH_KEYS}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ckpt_extra(self) -> Optional[Dict[str, Any]]:
        """A spec-built trainer embeds its spec in every manifest, so a
        resume can check it replays the same experiment."""
        if self.experiment is None:
            return None
        from repro_torch import api
        return {"spec": api.to_dict(self.experiment)}

    def _resume(self, params) -> int:
        """Restore the latest checkpoint into ``params``; its step."""
        if self.experiment is not None:
            from repro_torch import api
            saved = self.ckpt.read_manifest().get("extra", {}).get("spec")
            if saved is not None:
                api.check_resume_spec(saved, self.experiment)
        _, start, _, _ = self.ckpt.restore(params)
        return start

    # ------------------------------------------------------------ train
    def train(self, train_data=None, val_data=None) -> Dict[str, Any]:
        tcfg = self.tcfg
        if train_data is None:
            train_data = self.make_dataset(4096)
        if val_data is None:
            val_data = self.make_dataset(512, seed_shift=1)
        base_seed = rng.fold_py(tcfg.seed, 0xC0FFEE)
        params = self.params
        start = 0
        if self.ckpt and self.ckpt.latest() is not None:
            start = self._resume(params)
        history = {"step": [], "loss": [], "projected_grad": [],
                   "active_layers": [], "step_seconds": [], "val_loss": [],
                   "val_step": [], "val_acc": [], "wall": []}
        best = (-np.inf, None, -1)
        t0 = time.perf_counter()
        stream_data = {k: v for k, v in train_data.items()
                       if k in MODEL_BATCH_KEYS}
        stream = synthetic.batches(stream_data, tcfg.batch_size, tcfg.steps,
                                   seed=tcfg.seed + 7)
        for t, np_batch in enumerate(stream):
            if t < start:
                continue
            batch = self._model_batch(np_batch)
            ts = time.perf_counter()
            params, self.state, metrics = self._step(params, self.state,
                                                     batch, t, base_seed)
            self._sync()
            step_s = time.perf_counter() - ts
            if tcfg.log_every and (t % tcfg.log_every == 0
                                   or t == tcfg.steps - 1):
                history["step"].append(t)
                history["loss"].append(float(metrics["loss"]))
                pg, al = (metrics.get("projected_grad"),
                          metrics.get("active_layers"))
                history["projected_grad"].append(
                    None if pg is None else float(pg))
                history["active_layers"].append(
                    None if al is None else int(al))
                history["step_seconds"].append(step_s)
                history["wall"].append(time.perf_counter() - t0)
            if tcfg.eval_every and (t + 1) % tcfg.eval_every == 0:
                vl, va = self.evaluate(params, val_data)
                history["val_step"].append(t + 1)
                history["val_loss"].append(vl)
                history["val_acc"].append(va)
                if -vl > best[0]:
                    best = (-vl, lm.params_to_numpy(params), t + 1)
            if (self.ckpt and tcfg.ckpt_every
                    and (t + 1) % tcfg.ckpt_every == 0):
                self.ckpt.save(t + 1, params, base_seed,
                               extra=self._ckpt_extra(), blocking=False)
        if self.ckpt:
            self.ckpt.wait()
        history["final_params"] = params
        if best[1] is not None:
            history["best_params"] = best[1]
            history["best_step"] = best[2]
        return history

    def evaluate(self, params, val_data, max_examples=256):
        """(val_loss, verbalizer accuracy or -1 for generation tasks)."""
        n = min(max_examples, val_data["tokens"].shape[0])
        vl = float(self._eval_loss(params, self._model_batch(val_data, n)))
        if self.task.kind in ("classification", "multiple_choice"):
            va = synthetic.classification_accuracy(
                self.mcfg, params, val_data, self.task, lm, max_examples=n)
        else:
            va = -1.0
        return vl, va

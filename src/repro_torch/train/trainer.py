"""Training driver of the port (counterpart of ``repro/train/trainer.py``):
ZO mode on the synthetic task, the log and eval cadence, and best
parameters by validation loss (the paper's protocol).

The step seeds and batches are the reference's: ``base_seed =
fold(seed, 0xC0FFEE)``, step seed ``fold(base_seed, t)``, and batches
from ``synthetic.batches(..., seed=seed + 7)``, so from the same initial
weights both packages train on the same data with the same z.
Checkpoint and resume, the other modes and PEFT are not yet ported.

The trainer runs on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import estimators, resolve_device
from repro_torch.core import rng, zo
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


class Trainer:
    """Built from a spec with :meth:`from_spec`.  ``params`` (an
    ``lm.LM``) replaces the random initial weights, e.g. weights exported
    from the reference with ``lm.params_from_numpy``."""

    @classmethod
    def from_spec(cls, spec, device=None, params=None) -> "Trainer":
        from repro_torch.api import runners
        d = runners.derive(spec)
        return cls(d.model_cfg, d.task, d.tcfg, d.est_cfg, device=device,
                   params=params, _spec=spec, _derived=d)

    def __init__(self, model_cfg, task: synthetic.TaskConfig,
                 tcfg: TrainConfig, est_cfg: estimators.EstimatorConfig,
                 device=None, params: Optional[lm.LM] = None, _spec=None,
                 _derived=None):
        self.experiment, self.derived = _spec, _derived
        self.mcfg, self.task, self.tcfg, self.est_cfg = (model_cfg, task,
                                                         tcfg, est_cfg)
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
            params = lm.init_params(model_cfg, gen, self.device)
        self.params = params
        self.spec = zo.build_spec(params, lm.zo_group_fn)
        self.loss_fn = lambda p, b, perturb=None: lm.lm_loss(
            model_cfg, p, b, perturb=perturb)
        self._step = estimators.make_step(self.loss_fn, self.spec, est_cfg)

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

    # ------------------------------------------------------------ train
    def train(self, train_data=None, val_data=None) -> Dict[str, Any]:
        tcfg = self.tcfg
        if train_data is None:
            train_data = self.make_dataset(4096)
        if val_data is None:
            val_data = self.make_dataset(512, seed_shift=1)
        base_seed = rng.fold_py(tcfg.seed, 0xC0FFEE)
        params = self.params
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
            batch = self._model_batch(np_batch)
            ts = time.perf_counter()
            params, metrics = self._step(params, batch, t, base_seed)
            self._sync()
            step_s = time.perf_counter() - ts
            if tcfg.log_every and (t % tcfg.log_every == 0
                                   or t == tcfg.steps - 1):
                history["step"].append(t)
                history["loss"].append(float(metrics["loss"]))
                history["projected_grad"].append(
                    float(metrics["projected_grad"]))
                history["active_layers"].append(int(metrics["active_layers"]))
                history["step_seconds"].append(step_s)
                history["wall"].append(time.perf_counter() - t0)
            if tcfg.eval_every and (t + 1) % tcfg.eval_every == 0:
                vl, va = self.evaluate(params, val_data)
                history["val_step"].append(t + 1)
                history["val_loss"].append(vl)
                history["val_acc"].append(va)
                if -vl > best[0]:
                    best = (-vl, lm.params_to_numpy(params), t + 1)
        history["final_params"] = params
        if best[1] is not None:
            history["best_params"] = best[1]
            history["best_step"] = best[2]
        return history

    def evaluate(self, params, val_data, max_examples=256):
        """(val_loss, verbalizer accuracy or -1 for generation tasks)."""
        n = min(max_examples, val_data["tokens"].shape[0])
        vl = float(self.loss_fn(params, self._model_batch(val_data, n)))
        if self.task.kind in ("classification", "multiple_choice"):
            va = synthetic.classification_accuracy(
                self.mcfg, params, val_data, self.task, lm, max_examples=n)
        else:
            va = -1.0
        return vl, va

"""Training driver of the port (counterpart of ``repro/train/trainer.py``):
ZO (any estimator), ZO momentum and first-order (the paper's FT rows) on
the synthetic task or a registry task (``tasks``), over the full model
or a PEFT tree (LoRA, prefix); the log and eval cadence; the best
parameters (highest task metric for a registry task, the SuperGLUE
protocol; lowest validation loss otherwise, the paper's); checkpoints
every ``ckpt_every`` steps and resume from the latest; and the
loss-shard quorum.

The step seeds and batches are the reference's: ``base_seed =
fold(seed, 0xC0FFEE)``, step seed ``fold(base_seed, t)``, and batches
from ``synthetic.batches(..., seed=seed + 7)``, so from the same initial
weights both packages train on the same data with the same z.  A resumed
run skips the batches of the steps before the checkpoint and so replays
the uninterrupted run.  As in the reference, estimator and optimizer
state (importance scores, the momentum ring, FO moments) is not
checkpointed and starts afresh on resume.

PEFT: ZO, FO and checkpoints run over the trainable tree alone; the
loss reads the model through ``_to_model`` (``lora.merge`` or
``prefix.inject`` over the base parameters, which are never changed).

Quorum (``n_loss_shards`` > 1, ``quorum`` < 1): the batch is split into
``n_loss_shards`` shards and each loss averages the shards that
"arrived", a subset fixed by the batch's content as in the reference.

The best parameters are kept as a host copy (``host_copy``), as the
reference keeps numpy arrays: at OPT-13B that is 25.7 GB of host memory
and one device-to-host copy for each improvement.

The trainer runs on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import estimators, resolve_device
from repro_torch import tasks as tasks_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import fo, rng, zo, zo_adaptive
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.peft import lora as lora_mod
from repro_torch.peft import prefix as prefix_mod


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
    peft: Optional[str] = None    # None | lora | prefix


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


def host_copy(params) -> Dict[str, torch.Tensor]:
    """``{path: CPU tensor}`` copy of a parameter tree, in its dtypes."""
    return {path: t.detach().to("cpu", copy=True)
            for path, t in zo.leaf_items(params)}


@torch.no_grad()
def load_host_(params, host: Dict[str, torch.Tensor]):
    """Copy a :func:`host_copy` back into ``params``'s tensors in place."""
    for path, t in zo.leaf_items(params):
        t.copy_(host[path])
    return params


class Trainer:
    """Built from a spec with :meth:`from_spec`.  ``params`` (an
    ``lm.LM``) replaces the random initial weights, e.g. weights exported
    from the reference with ``lm.params_from_numpy``; ``trainable`` (a
    PEFT dict tree, e.g. the reference's through ``peft.from_numpy``)
    replaces the random initial LoRA or prefix tree.  The trainable tree
    (``self.params``: the model itself without PEFT) is trained in
    place."""

    @classmethod
    def from_spec(cls, spec, device=None, params=None,
                  trainable=None) -> "Trainer":
        from repro_torch.api import runners
        d = runners.derive(spec)
        return cls(d.model_cfg, d.task, d.tcfg, d.est_cfg, fo_cfg=d.fo_cfg,
                   lora_cfg=d.lora_cfg, prefix_cfg=d.prefix_cfg,
                   device=device, params=params, trainable=trainable,
                   _spec=spec, _derived=d)

    def __init__(self, model_cfg, task, tcfg: TrainConfig,
                 est_cfg: estimators.EstimatorConfig,
                 fo_cfg: fo.FOConfig = fo.FOConfig(),
                 lora_cfg: lora_mod.LoRAConfig = lora_mod.LoRAConfig(),
                 prefix_cfg: prefix_mod.PrefixConfig = (
                     prefix_mod.PrefixConfig()),
                 device=None, params: Optional[lm.LM] = None,
                 trainable=None, _spec=None, _derived=None):
        if est_cfg.forward_backend != "materialized":
            if tcfg.peft:
                raise ValueError("forward_backend='virtual' covers "
                                 "full-parameter ZO only (no PEFT merge)")
            if tcfg.mode != "zo":
                raise ValueError("forward_backend='virtual' requires "
                                 "mode='zo'")
        self.experiment, self.derived = _spec, _derived
        self.mcfg, self.task, self.tcfg = model_cfg, task, tcfg
        self.est_cfg, self.fo_cfg = est_cfg, fo_cfg
        self.registry_task = (task if isinstance(task, tasks_mod.CompiledTask)
                              else None)
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
            params = lm.init_params(model_cfg, gen, self.device)
        self.base_params = params
        # the trainable tree and the model the loss reads through it
        gen = torch.Generator(device=self.device)
        if tcfg.peft == "lora":
            if trainable is None:
                trainable = lora_mod.init_lora(
                    params, lora_cfg,
                    gen.manual_seed(rng.fold_py(tcfg.seed, 1)))
            group_fn = lora_mod.lora_group_fn
            self._to_model = lambda tr: lora_mod.merge(params, tr, lora_cfg)
        elif tcfg.peft == "prefix":
            if trainable is None:
                trainable = prefix_mod.init_prefix(
                    model_cfg, gen.manual_seed(rng.fold_py(tcfg.seed, 2)),
                    prefix_cfg, self.device)
            group_fn = prefix_mod.prefix_group_fn
            self._to_model = lambda tr: prefix_mod.inject(params, tr)
        else:
            trainable = params
            group_fn = lm.zo_group_fn
            self._to_model = lambda tr: tr
        self.params = trainable
        self.spec = zo.build_spec(self.params, group_fn)
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
            return lm.lm_loss(mcfg, self._to_model(p), b, perturb=perturb,
                              grad=grad)

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
        """Dataset in the synthetic batch format, from either task type."""
        if self.registry_task is not None:
            t = self.registry_task
            return t.make_dataset(n, seed=t.seed + seed_shift)
        return synthetic.make_dataset(
            dataclasses.replace(self.task, seed=self.task.seed + seed_shift)
            if seed_shift else self.task, n)

    def _model_batch(self, np_batch, n=None):
        """Strip eval-only keys; the loss sees only token arrays."""
        return {k: torch.as_tensor(v if n is None else v[:n],
                                   device=self.device)
                for k, v in np_batch.items()
                if k in tasks_mod.MODEL_BATCH_KEYS}

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
        if self.tcfg.mode == "fo":      # master copies of the restored leaves
            self.state = fo.init_state(params, self.fo_cfg)
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
        if self.registry_task is not None:
            history["metric_name"] = self.registry_task.metric
        # best score, maximized: the task metric for registry tasks
        # (SuperGLUE protocol), -val_loss otherwise (the paper's protocol)
        best = (-np.inf, None, -1)
        t0 = time.perf_counter()
        stream_data = {k: v for k, v in train_data.items()
                       if k in tasks_mod.MODEL_BATCH_KEYS}
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
                score = va if self.registry_task is not None else -vl
                if score > best[0]:
                    best = (score, host_copy(params), t + 1)
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
        """Returns (val_loss, metric): the registry task's primary metric,
        or verbalizer accuracy for synthetic tasks (-1 if n/a)."""
        n = min(max_examples, val_data["tokens"].shape[0])
        vl = float(self._eval_loss(params, self._model_batch(val_data, n)))
        if self.registry_task is not None:
            va = self.registry_task.evaluate(
                self.mcfg, self._to_model(params), val_data, lm,
                max_examples=n)
        elif self.task.kind in ("classification", "multiple_choice"):
            va = synthetic.classification_accuracy(
                self.mcfg, self._to_model(params), val_data, self.task, lm,
                max_examples=n)
        else:
            va = -1.0
        return vl, va

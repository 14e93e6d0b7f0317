"""Spec consumers of the port (counterpart of ``repro/api/runners.py``):
``derive`` the configs a spec implies, and ``run``, ``evaluate`` and
``sweep`` it.  Each runs on the card unless given ``device="cpu"``.
``dryrun_cell``/``dryrun`` cost the spec's arch on the production mesh
(``launch/dryrun.py``) and need no card.
"""
from typing import Any, Dict, List, NamedTuple, Optional

from repro_torch import estimators
from repro_torch import tasks as tasks_mod
from repro_torch.api import presets as presets_mod
from repro_torch.api.spec import Experiment, SpecError, to_dict, with_overrides
from repro_torch.api.validate import n_drop_for, resolve_model
from repro_torch.api.validate import validate as validate_spec
from repro_torch.core import fo
from repro_torch.data import synthetic
from repro_torch.models import lm
from repro_torch.peft import lora as lora_mod
from repro_torch.peft import prefix as prefix_mod


class Derived(NamedTuple):
    model_cfg: Any
    task: Any                     # synthetic.TaskConfig | tasks.CompiledTask
    tcfg: Any                     # train.trainer.TrainConfig
    est_cfg: estimators.EstimatorConfig
    fo_cfg: fo.FOConfig
    n_drop: int
    lora_cfg: lora_mod.LoRAConfig
    prefix_cfg: prefix_mod.PrefixConfig


def derive(spec: Experiment) -> Derived:
    """Validate ``spec`` and build the configs it implies."""
    from repro_torch.train.trainer import TrainConfig

    mcfg = validate_spec(spec)
    m, t, o, e, rt, r = (spec.model, spec.task, spec.optimizer,
                         spec.estimator, spec.runtime, spec.run)
    if t.name is not None:
        task = tasks_mod.build(t.name, vocab=mcfg.vocab, seq_len=m.seq_len,
                               seed=r.seed)
    else:
        task = synthetic.TaskConfig(vocab=mcfg.vocab, seq_len=m.seq_len,
                                    n_classes=t.n_classes,
                                    signal_rate=t.signal_rate, seed=r.seed)
    n_drop = n_drop_for(spec, mcfg.num_layers)
    eval_every = (max(1, r.steps // 4) if r.eval_every is None
                  else r.eval_every)
    tcfg = TrainConfig(
        steps=r.steps, batch_size=r.batch_size, eval_every=eval_every,
        log_every=r.log_every, seed=r.seed, mode=o.mode,
        ckpt_dir=r.ckpt_dir, ckpt_every=r.ckpt_every,
        keep_ckpts=r.keep_ckpts, n_loss_shards=rt.n_loss_shards,
        quorum=rt.quorum, peft=rt.peft)
    est_cfg = estimators.EstimatorConfig(
        name=e.name, eps=o.eps, lr=o.lr, q=e.q, q_chunk=e.q_chunk,
        n_drop=n_drop, policy=o.policy, backend=rt.backend,
        fused_update=o.fused_update, weight_decay=o.weight_decay,
        inner=e.inner, importance_decay=e.importance_decay,
        forward_backend=rt.forward_backend, paired_probes=rt.paired_probes)
    fo_cfg = fo.FOConfig(optimizer=o.fo_optimizer, lr=o.lr,
                         weight_decay=o.weight_decay, grad_clip=o.grad_clip)
    lora_cfg = lora_mod.LoRAConfig(rank=rt.lora_rank, alpha=rt.lora_alpha,
                                   targets=tuple(rt.lora_targets))
    prefix_cfg = prefix_mod.PrefixConfig(n_prefix=rt.prefix_tokens)
    return Derived(mcfg, task, tcfg, est_cfg, fo_cfg, n_drop, lora_cfg,
                   prefix_cfg)


def preset(name: str) -> Experiment:
    return presets_mod.get(name)


def _summary(spec: Experiment, trainer, hist: Dict) -> Dict:
    d = trainer.derived
    return {
        "arch": spec.model.arch, "mode": spec.optimizer.mode,
        "estimator": spec.estimator.name, "q": spec.estimator.q,
        "forward_backend": spec.runtime.forward_backend,
        "backend": spec.runtime.backend, "device": str(trainer.device),
        "task": spec.task.name or "synthetic",
        "metric": hist.get("metric_name", "val_loss"),
        "n_layers": d.model_cfg.num_layers, "n_drop": d.n_drop,
        "n_params": lm.count_params(trainer.base_params),
        "n_active_params": lm.count_active_params(d.model_cfg,
                                                  trainer.base_params),
        "final_loss": hist["loss"][-1] if hist["loss"] else None,
        "val_loss": hist["val_loss"], "val_acc": hist["val_acc"],
        "best_step": hist.get("best_step"),
        "run_id": hist.get("run_id"), "run_dir": hist.get("run_dir"),
    }


def run(spec: Experiment, device=None, params=None, train_data=None,
        val_data=None) -> Dict:
    """Train per the spec on ``device`` (None = the card).  ``params``
    replaces the random initial model (``Trainer``).  Returns
    ``{"spec", "summary", "history"}``."""
    from repro_torch.train.trainer import Trainer

    trainer = Trainer.from_spec(spec, device=device, params=params)
    hist = trainer.train(train_data=train_data, val_data=val_data)
    return {"spec": to_dict(spec), "summary": _summary(spec, trainer, hist),
            "history": hist}


def evaluate(spec: Experiment, mode: str = "zeroshot",
             n_examples: int = 256, device=None, params=None) -> Dict:
    """One task's metric report (the SuperGLUE protocol; DESIGN.md §9).

    ``mode="zeroshot"`` scores the initial parameters (or, when
    ``run.ckpt_dir`` is set, the latest checkpoint there too);
    ``mode="train"`` fine-tunes first and reports both numbers, scoring
    the best parameters after copying them into the live tensors (no
    second copy of the model on the card).
    """
    from repro_torch.train.trainer import Trainer, load_host_

    if spec.task.name is None:
        raise SpecError("task.name", "evaluate requires a registry task")
    if mode not in ("zeroshot", "train"):
        raise SpecError("<mode>", f"unknown evaluate mode {mode!r}")
    ckpt_dir = spec.run.ckpt_dir
    if ckpt_dir is not None and mode == "train":
        # Trainer auto-resumes from ckpt_dir, which would silently turn
        # "fine-tune then score" into "restore then maybe-train"
        raise SpecError("run.ckpt_dir", "scores an existing checkpoint; "
                        "combine it with mode=zeroshot, not train")
    trainer = Trainer.from_spec(spec, device=device, params=params)
    task = trainer.registry_task
    val = trainer.make_dataset(n_examples, seed_shift=1)
    report = {"task": task.name, "kind": task.kind, "metric": task.metric,
              "arch": spec.model.arch, "variant": spec.model.variant,
              "n_examples": n_examples, "mode": mode,
              "spec": to_dict(spec)}
    zs_loss, zs_metric = trainer.evaluate(trainer.params, val,
                                          max_examples=n_examples)
    report["zeroshot"] = zs_metric
    report["zeroshot_val_loss"] = zs_loss
    if ckpt_dir is not None and mode != "train":
        params, step, _, _ = trainer.ckpt.restore(trainer.params)
        vl, metric = trainer.evaluate(params, val, max_examples=n_examples)
        report.update(trained=metric, trained_val_loss=vl, ckpt_step=step)
    elif mode == "train":
        hist = trainer.train(val_data=val)
        params = hist["final_params"]
        if "best_params" in hist:
            load_host_(params, hist["best_params"])
        vl, metric = trainer.evaluate(params, val, max_examples=n_examples)
        report.update(trained=metric, trained_val_loss=vl,
                      best_step=hist.get("best_step", -1),
                      val_metric_curve=hist["val_acc"])
    return report


def dryrun_cell(spec: Experiment, shape: str, arch: Optional[str] = None,
                multi_pod: Optional[bool] = None,
                lowering: str = "optimized",
                overrides: Optional[Dict] = None) -> Dict:
    """One roofline cell: the single implementation ``dryrun`` and the
    CLI grid share.  The record embeds the spec *of the cell* (arch and
    mesh substituted when the grid varies them)."""
    from repro_torch.launch import dryrun as dryrun_mod

    arch = spec.model.arch if arch is None else arch
    mp = (spec.runtime.mesh == "multi_pod") if multi_pod is None \
        else multi_pod
    rec = dryrun_mod.run_cell(
        arch, shape, mp, lowering, overrides=overrides,
        estimator=spec.estimator.name, q=spec.estimator.q,
        forward_backend=spec.runtime.forward_backend)
    rec["spec"] = to_dict(with_overrides(spec, {
        "model.arch": arch,
        "runtime.mesh": "multi_pod" if mp else "single"}))
    return rec


def dryrun(spec: Experiment, shape: Optional[str] = None,
           lowering: str = "optimized",
           overrides: Optional[Dict] = None) -> List[Dict]:
    """Cost the spec's arch on the production mesh (fake process group,
    meta tensors: no card) and return the roofline records, one a shape
    cell."""
    validate_spec(spec)
    from repro_torch.configs.shapes import SHAPES, shapes_for

    mcfg = resolve_model(with_overrides(spec, {"model.variant": "full"}))
    shapes = [SHAPES[shape]] if shape else shapes_for(mcfg)
    return [dryrun_cell(spec, sh.name, lowering=lowering,
                        overrides=overrides)
            for sh in shapes]


def sweep(spec: Experiment, overrides: List[Dict[str, Any]], device=None,
          train_data=None, val_data=None) -> List[Dict]:
    """Run ``spec`` once per override set (dotted-path dicts), returning
    ``[{"overrides", "result"}, ...]`` — every scenario is a spec diff."""
    out = []
    for ov in overrides:
        varied = with_overrides(spec, dict(ov))
        out.append({"overrides": dict(ov),
                    "result": run(varied, device=device,
                                  train_data=train_data,
                                  val_data=val_data)})
    return out

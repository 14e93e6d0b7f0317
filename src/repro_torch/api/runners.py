"""Spec consumers of the port (counterpart of ``repro/api/runners.py``):
``derive`` the configs a spec implies, and ``run`` it.
"""
from typing import Any, Dict, NamedTuple

from repro_torch import estimators
from repro_torch.api.spec import Experiment, to_dict
from repro_torch.api.validate import n_drop_for
from repro_torch.api.validate import validate as validate_spec
from repro_torch.core import fo
from repro_torch.data import synthetic


class Derived(NamedTuple):
    model_cfg: Any
    task: synthetic.TaskConfig
    tcfg: Any                     # train.trainer.TrainConfig
    est_cfg: estimators.EstimatorConfig
    fo_cfg: fo.FOConfig
    n_drop: int


def derive(spec: Experiment) -> Derived:
    """Validate ``spec`` and build the configs it implies."""
    from repro_torch.train.trainer import TrainConfig

    mcfg = validate_spec(spec)
    m, t, o, e, rt, r = (spec.model, spec.task, spec.optimizer,
                         spec.estimator, spec.runtime, spec.run)
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
        quorum=rt.quorum)
    est_cfg = estimators.EstimatorConfig(
        name=e.name, eps=o.eps, lr=o.lr, q=e.q, q_chunk=e.q_chunk,
        n_drop=n_drop, policy=o.policy, backend=rt.backend,
        fused_update=o.fused_update, weight_decay=o.weight_decay,
        inner=e.inner, importance_decay=e.importance_decay,
        forward_backend=rt.forward_backend, paired_probes=rt.paired_probes)
    fo_cfg = fo.FOConfig(optimizer=o.fo_optimizer, lr=o.lr,
                         weight_decay=o.weight_decay, grad_clip=o.grad_clip)
    return Derived(mcfg, task, tcfg, est_cfg, fo_cfg, n_drop)


def run(spec: Experiment, device=None, params=None, train_data=None,
        val_data=None) -> Dict:
    """Train per the spec on ``device`` (None = the card).  Returns
    ``{"spec", "summary", "history"}``."""
    from repro_torch.train.trainer import Trainer

    trainer = Trainer.from_spec(spec, device=device, params=params)
    hist = trainer.train(train_data=train_data, val_data=val_data)
    d = trainer.derived
    summary = {
        "arch": spec.model.arch, "mode": spec.optimizer.mode,
        "estimator": spec.estimator.name, "q": spec.estimator.q,
        "forward_backend": spec.runtime.forward_backend,
        "backend": spec.runtime.backend, "device": str(trainer.device),
        "n_layers": d.model_cfg.num_layers, "n_drop": d.n_drop,
        "final_loss": hist["loss"][-1] if hist["loss"] else None,
        "val_loss": hist["val_loss"], "val_acc": hist["val_acc"],
        "best_step": hist.get("best_step"),
    }
    return {"spec": to_dict(spec), "summary": summary, "history": hist}

"""Spec validation of the port (counterpart of ``repro/api/validate.py``).

Accepts what the port runs: training and evaluation of the OPT family on
the synthetic task or a registry task, single process, in every
optimizer mode (``zo`` with any estimator, ``zo_momentum``, ``fo``),
over the full model or a PEFT tree (LoRA, prefix), any axpy backend, any
forward backend, the loss-shard quorum and checkpoint/resume, under the
reference's rules.  Meshes, the swarm and telemetry raise
:class:`SpecError` naming the field and saying "not yet ported", before
any parameter is allocated.
"""
from repro_torch import configs
from repro_torch import tasks as tasks_mod
from repro_torch.api.spec import Experiment, SpecError, UnknownTaskError
from repro_torch.estimators import costs

MODES = ("zo", "zo_momentum", "fo")
POLICIES = ("stratified", "uniform")
BACKENDS = ("dense", "scan", "gather", "pallas")
FO_OPTIMIZERS = ("sgd", "momentum", "adamw")
PEFTS = (None, "lora", "prefix")
SCHEDULES = ("constant",)


def _require(cond: bool, path: str, message: str):
    if not cond:
        raise SpecError(path, message)


def _ported(cond: bool, path: str, what: str):
    if not cond:
        raise SpecError(path, f"{what} is not yet ported to repro_torch")


def resolve_model(spec: Experiment):
    """``configs.get`` with spec-path errors instead of KeyError."""
    try:
        return configs.get(spec.model.arch, spec.model.variant)
    except KeyError:
        raise SpecError("model.arch",
                        f"arch {spec.model.arch!r} is not yet ported to "
                        f"repro_torch; ported: {configs.list_archs()}"
                        ) from None
    except AttributeError:
        raise SpecError("model.variant",
                        f"config module for {spec.model.arch!r} has no "
                        f"variant {spec.model.variant!r}") from None


def validate(spec: Experiment):
    """Raise :class:`SpecError` on the first invalid or unported field;
    return the resolved ``ModelConfig`` on success."""
    m, t, o, e, rt, sw, tel, r = (spec.model, spec.task, spec.optimizer,
                                  spec.estimator, spec.runtime, spec.swarm,
                                  spec.telemetry, spec.run)
    mcfg = resolve_model(spec)
    _require(m.seq_len >= 2, "model.seq_len", f"must be >= 2, got {m.seq_len}")
    _require(m.seq_len - 1 <= mcfg.max_seq, "model.seq_len",
             f"must be <= max_seq + 1 = {mcfg.max_seq + 1}, got {m.seq_len}")

    if t.name is not None and t.name not in tasks_mod.names():
        raise UnknownTaskError(
            "task.name", f"unknown task {t.name!r}; registered: "
                         f"{tasks_mod.names()}")
    _require(t.n_classes >= 2, "task.n_classes",
             f"must be >= 2, got {t.n_classes}")
    _require(0.0 < t.signal_rate <= 1.0, "task.signal_rate",
             f"must be in (0, 1], got {t.signal_rate}")

    _require(o.mode in MODES, "optimizer.mode",
             f"unknown mode {o.mode!r}; pick from {MODES}")
    _require(o.eps > 0, "optimizer.eps", f"must be > 0, got {o.eps}")
    _require(o.lr >= 0, "optimizer.lr", f"must be >= 0, got {o.lr}")
    _require(o.schedule in SCHEDULES, "optimizer.schedule",
             f"unknown schedule {o.schedule!r}; pick from {SCHEDULES}")
    _require(o.weight_decay >= 0, "optimizer.weight_decay",
             f"must be >= 0, got {o.weight_decay}")
    _require(0.0 <= o.sparsity < 1.0, "optimizer.sparsity",
             f"must be in [0, 1), got {o.sparsity}")
    if o.n_drop is not None:
        _require(0 <= o.n_drop < mcfg.num_layers, "optimizer.n_drop",
                 f"must be in [0, {mcfg.num_layers}), got {o.n_drop}")
    _require(o.policy in POLICIES, "optimizer.policy",
             f"unknown policy {o.policy!r}; pick from {POLICIES}")
    _require(o.fo_optimizer in FO_OPTIMIZERS, "optimizer.fo_optimizer",
             f"unknown FO optimizer {o.fo_optimizer!r}; pick from "
             f"{FO_OPTIMIZERS}")
    if o.grad_clip is not None:
        _require(o.grad_clip > 0, "optimizer.grad_clip",
                 f"must be > 0 or none, got {o.grad_clip}")

    _require(e.name in costs.ESTIMATORS, "estimator.name",
             f"unknown estimator {e.name!r}; pick from {costs.ESTIMATORS}")
    _require(e.q >= 1, "estimator.q", f"must be >= 1, got {e.q}")
    _require(e.q_chunk >= 0, "estimator.q_chunk",
             f"must be >= 0 (0 = one stacked forward), got {e.q_chunk}")
    _require(e.inner in costs.ESTIMATORS and e.inner != "importance",
             "estimator.inner",
             f"must be a non-importance estimator, got {e.inner!r}")
    _require(0.0 < e.importance_decay <= 1.0, "estimator.importance_decay",
             f"must be in (0, 1], got {e.importance_decay}")

    _require(rt.backend in BACKENDS, "runtime.backend",
             f"unknown kernel backend {rt.backend!r}; pick from {BACKENDS}")
    _require(rt.forward_backend in costs.FORWARD_BACKENDS,
             "runtime.forward_backend",
             f"unknown forward_backend {rt.forward_backend!r}; pick from "
             f"{costs.FORWARD_BACKENDS}")
    _ported(rt.mesh == "single", "runtime.mesh", f"mesh {rt.mesh!r}")
    _require(rt.peft in PEFTS, "runtime.peft",
             f"unknown peft {rt.peft!r}; pick from {PEFTS}")
    _require(rt.lora_rank >= 1, "runtime.lora_rank",
             f"must be >= 1, got {rt.lora_rank}")
    _require(rt.prefix_tokens >= 1, "runtime.prefix_tokens",
             f"must be >= 1, got {rt.prefix_tokens}")
    _require(rt.n_loss_shards >= 1, "runtime.n_loss_shards",
             f"must be >= 1, got {rt.n_loss_shards}")
    _require(0.0 < rt.quorum <= 1.0, "runtime.quorum",
             f"must be in (0, 1], got {rt.quorum}")
    if rt.backend == "gather":
        _require(o.policy == "stratified", "optimizer.policy",
                 "runtime.backend='gather' requires the stratified policy")
    if rt.forward_backend != "materialized":
        _require(rt.peft is None, "runtime.peft",
                 "forward_backend='virtual' covers full-parameter ZO only "
                 "(no PEFT merge)")
        _require(o.mode == "zo", "optimizer.mode",
                 "forward_backend='virtual' requires mode='zo'")

    _ported(sw.workers == 0 and sw.n_shards == 0, "swarm.workers",
            "the multi-process swarm")
    _ported(not tel.enabled and tel.runs_dir is None, "telemetry.enabled",
            "telemetry (tracing and run logs)")

    _require(r.steps >= 1, "run.steps", f"must be >= 1, got {r.steps}")
    _require(r.batch_size >= 1, "run.batch_size",
             f"must be >= 1, got {r.batch_size}")
    if rt.n_loss_shards > 1:
        _require(r.batch_size % rt.n_loss_shards == 0, "run.batch_size",
                 f"must divide into runtime.n_loss_shards="
                 f"{rt.n_loss_shards} loss shards, got {r.batch_size}")
    if r.eval_every is not None:
        _require(r.eval_every >= 0, "run.eval_every",
                 f"must be >= 0, got {r.eval_every}")
    _require(r.log_every >= 0, "run.log_every",
             f"must be >= 0, got {r.log_every}")
    _require(r.ckpt_every >= 0, "run.ckpt_every",
             f"must be >= 0, got {r.ckpt_every}")
    if r.ckpt_every > 0:
        _require(r.ckpt_dir is not None, "run.ckpt_dir",
                 "required when run.ckpt_every > 0")
    _require(r.keep_ckpts >= 1, "run.keep_ckpts",
             f"must be >= 1, got {r.keep_ckpts}")
    return mcfg


def n_drop_for(spec: Experiment, num_layers: int) -> int:
    """The LeZO drop count: 0 for first-order training; explicit
    ``optimizer.n_drop`` wins, else ``int(sparsity * L)``."""
    o = spec.optimizer
    if o.mode == "fo":
        return 0
    if o.n_drop is not None:
        return o.n_drop
    return int(o.sparsity * num_layers)

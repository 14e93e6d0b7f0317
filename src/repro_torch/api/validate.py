"""Spec validation of the port (counterpart of ``repro/api/validate.py``).

Accepts exactly what this slice of the port runs: ZO training of the OPT
family with the two-point estimator on the synthetic task, any axpy
backend, any forward backend, single process.  Everything else raises
:class:`SpecError` naming the field and saying "not yet ported", before
any parameter is allocated.
"""
from repro_torch import configs
from repro_torch.api.spec import Experiment, SpecError
from repro_torch.estimators import costs

POLICIES = ("stratified", "uniform")
BACKENDS = ("dense", "scan", "gather", "pallas")
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

    _ported(t.name is None, "task.name", f"registry task {t.name!r}")
    _require(t.n_classes >= 2, "task.n_classes",
             f"must be >= 2, got {t.n_classes}")
    _require(0.0 < t.signal_rate <= 1.0, "task.signal_rate",
             f"must be in (0, 1], got {t.signal_rate}")

    _ported(o.mode == "zo", "optimizer.mode", f"mode {o.mode!r}")
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

    _ported(e.name == "two_point", "estimator.name", f"estimator {e.name!r}")

    _require(rt.backend in BACKENDS, "runtime.backend",
             f"unknown kernel backend {rt.backend!r}; pick from {BACKENDS}")
    _require(rt.forward_backend in costs.FORWARD_BACKENDS,
             "runtime.forward_backend",
             f"unknown forward_backend {rt.forward_backend!r}; pick from "
             f"{costs.FORWARD_BACKENDS}")
    _ported(rt.peft is None, "runtime.peft", f"PEFT {rt.peft!r}")
    _ported(rt.n_loss_shards == 1, "runtime.n_loss_shards",
            "the loss-shard quorum simulation")
    _ported(rt.mesh == "single", "runtime.mesh", f"mesh {rt.mesh!r}")
    if rt.backend == "gather":
        _require(o.policy == "stratified", "optimizer.policy",
                 "runtime.backend='gather' requires the stratified policy")

    _ported(sw.workers == 0 and sw.n_shards == 0, "swarm.workers",
            "the multi-process swarm")
    _ported(not tel.enabled and tel.runs_dir is None, "telemetry.enabled",
            "telemetry (tracing and run logs)")

    _require(r.steps >= 1, "run.steps", f"must be >= 1, got {r.steps}")
    _require(r.batch_size >= 1, "run.batch_size",
             f"must be >= 1, got {r.batch_size}")
    if r.eval_every is not None:
        _require(r.eval_every >= 0, "run.eval_every",
                 f"must be >= 0, got {r.eval_every}")
    _require(r.log_every >= 0, "run.log_every",
             f"must be >= 0, got {r.log_every}")
    _ported(r.ckpt_dir is None and r.ckpt_every == 0, "run.ckpt_dir",
            "checkpointing")
    return mcfg


def n_drop_for(spec: Experiment, num_layers: int) -> int:
    """The LeZO drop count: explicit ``optimizer.n_drop`` wins, else
    ``int(sparsity * L)``."""
    o = spec.optimizer
    if o.n_drop is not None:
        return o.n_drop
    return int(o.sparsity * num_layers)

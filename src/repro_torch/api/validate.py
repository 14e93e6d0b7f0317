"""Spec validation of the port (counterpart of ``repro/api/validate.py``).

Accepts what the port runs: training and evaluation of OPT and the
model zoo's ``attn``/``mla`` + ``dense``/``moe`` configs (MLA and MoE
blocks on the materialized forward backend only, as in the reference)
on the synthetic task or a registry task, single process, in every
optimizer mode (``zo`` with any estimator, ``zo_momentum``, ``fo``),
over the full model or a PEFT tree (LoRA, prefix), any axpy backend, any
forward backend, the loss-shard quorum and checkpoint/resume, under the
reference's rules, with telemetry (tracing, run directories, optimizer
health) under the reference's telemetry rules, and the seed-synchronized
swarm (``swarm.*``, the decomposed sharded step of ``swarm/shardstep.py``)
under the reference's swarm rules, and the serving engine's knobs
(``serving.*``) under the reference's serving rules.  Both meshes
(``runtime.mesh``: ``single``, ``multi_pod``) validate as in the
reference; only the dry run reads the field.
"""
from typing import List

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
MESHES = ("single", "multi_pod")   # only the dry run reads it


def _require(cond: bool, path: str, message: str):
    if not cond:
        raise SpecError(path, message)


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


def virtual_block_errors(model_cfg) -> List[str]:
    """Block kinds the fused virtual forward cannot cover (DESIGN.md §10)."""
    return sorted({f"{b.kind}+{b.ffn}" for s in model_cfg.stages
                   for b in s.pattern if b.kind != "attn" or b.ffn == "moe"})


def validate(spec: Experiment):
    """Raise :class:`SpecError` on the first invalid or unported field;
    return the resolved ``ModelConfig`` on success."""
    m, t, o, e, rt, sw, tel, r = (spec.model, spec.task, spec.optimizer,
                                  spec.estimator, spec.runtime, spec.swarm,
                                  spec.telemetry, spec.run)
    sv = spec.serving
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
    _require(rt.mesh in MESHES, "runtime.mesh",
             f"unknown mesh {rt.mesh!r}; pick from {MESHES}")
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
        bad = virtual_block_errors(mcfg)
        _require(not bad, "runtime.forward_backend",
                 "'virtual' covers attn + dense blocks; "
                 f"model.arch={m.arch!r} has {bad} (use "
                 "forward_backend='materialized')")

    # serving engine node (DESIGN.md §12): the pool/bucket arithmetic
    # must close before any arena is allocated
    _require(sv.page_size >= 1, "serving.page_size",
             f"must be >= 1, got {sv.page_size}")
    _require(sv.n_pages >= 2, "serving.n_pages",
             f"must be >= 2 (page 0 is the reserved trash page), "
             f"got {sv.n_pages}")
    _require(sv.max_lanes >= 1, "serving.max_lanes",
             f"must be >= 1, got {sv.max_lanes}")
    _require(sv.prefill_chunk >= 1
             and sv.prefill_chunk % sv.page_size == 0,
             "serving.prefill_chunk",
             f"must be a positive multiple of serving.page_size="
             f"{sv.page_size}, got {sv.prefill_chunk}")
    _require(sv.max_seq >= sv.prefill_chunk
             and sv.max_seq % sv.page_size == 0,
             "serving.max_seq",
             f"must be a multiple of serving.page_size={sv.page_size} "
             f">= prefill_chunk={sv.prefill_chunk}, got {sv.max_seq}")
    _require(sv.max_new_tokens >= 1, "serving.max_new_tokens",
             f"must be >= 1, got {sv.max_new_tokens}")
    _require(sv.max_new_tokens < sv.max_seq, "serving.max_new_tokens",
             f"must leave room for a prompt inside serving.max_seq="
             f"{sv.max_seq}, got {sv.max_new_tokens}")
    # the pool must cover at least the smallest default-budget request
    # (1-token prompt padded to the chunk, plus the generation budget) —
    # otherwise every Engine.submit fails and the spec can serve nothing
    min_span = max(sv.prefill_chunk, 1 + sv.max_new_tokens)
    min_pages = -(-min_span // sv.page_size)
    _require(min_pages <= sv.n_pages - 1, "serving.n_pages",
             f"pool has {sv.n_pages - 1} usable pages (page 0 is trash) "
             f"but the smallest default-budget request needs {min_pages} "
             f"({min_span} slots at page_size={sv.page_size})")
    _require(sv.priorities >= 1, "serving.priorities",
             f"must be >= 1 priority classes, got {sv.priorities}")
    if sv.preempt:
        _require(sv.priorities >= 2, "serving.preempt",
                 "preemption needs at least two priority classes "
                 f"(serving.priorities={sv.priorities}) — equal-priority "
                 "requests never evict each other")
    _require(sv.temperature >= 0.0, "serving.temperature",
             f"must be >= 0 (0 = greedy), got {sv.temperature}")
    _require(sv.top_k >= 0, "serving.top_k",
             f"must be >= 0 (0 = full vocab), got {sv.top_k}")
    if sv.eos_id is not None:
        _require(0 <= sv.eos_id < mcfg.vocab, "serving.eos_id",
                 f"must be a {mcfg.name} vocab id in [0, {mcfg.vocab}), "
                 f"got {sv.eos_id}")

    # telemetry node, under the reference's rules: a sink only makes
    # sense on an enabled tracer, an enabled tracer needs a sink, and the
    # health knobs need a run directory to write to
    _require(tel.ring >= 0, "telemetry.ring",
             f"must be >= 0 (0 = no ring buffer), got {tel.ring}")
    if not tel.enabled:
        for path, val in (("telemetry.fence", tel.fence),
                          ("telemetry.jsonl", tel.jsonl),
                          ("telemetry.prometheus", tel.prometheus),
                          ("telemetry.profile_dir", tel.profile_dir)):
            _require(not val, path,
                     "configured while telemetry.enabled=false — the "
                     "sink would silently record nothing; set "
                     "telemetry.enabled=true (or clear this field)")
    if tel.enabled:
        _require(tel.ring > 0 or bool(tel.jsonl), "telemetry.ring",
                 "telemetry.enabled=true needs at least one span sink: "
                 "a ring capacity > 0 or a telemetry.jsonl path")
    if tel.runs_dir is None:
        for path, val in (("telemetry.run_id", tel.run_id),
                          ("telemetry.health_norms", tel.health_norms)):
            _require(not val, path,
                     "configured while telemetry.runs_dir is unset — no "
                     "run directory would be written; set "
                     "telemetry.runs_dir (or clear this field)")

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

    # swarm node (DESIGN.md §14): the scalar-sync topology must close
    # before any process is spawned — a worker that dies on a bad spec
    # after attach is a much worse failure mode than a SpecError here
    from repro_torch.swarm import chaos as chaos_mod  # stdlib-only

    _require(sw.workers >= 0, "swarm.workers",
             f"must be >= 0 (0 = swarm off), got {sw.workers}")
    _require(sw.n_shards >= 0, "swarm.n_shards",
             f"must be >= 0 (0 = auto: one shard per worker), "
             f"got {sw.n_shards}")
    _require(0.0 < sw.quorum <= 1.0, "swarm.quorum",
             f"must be in (0, 1], got {sw.quorum}")
    _require(sw.step_deadline_s > 0, "swarm.step_deadline_s",
             f"must be > 0, got {sw.step_deadline_s}")
    _require(0 <= sw.port <= 65535, "swarm.port",
             f"must be a TCP port in [0, 65535] (0 = ephemeral), "
             f"got {sw.port}")
    _require(0.0 <= sw.chaos_drop < 1.0, "swarm.chaos_drop",
             f"must be in [0, 1) — dropping every message forever "
             f"deadlocks the run, got {sw.chaos_drop}")
    _require(sw.chaos_delay_ms >= 0, "swarm.chaos_delay_ms",
             f"must be >= 0, got {sw.chaos_delay_ms}")
    try:
        chaos_mod.parse_crashes(sw.chaos_crash)
    except ValueError as ex:
        raise SpecError("swarm.chaos_crash", str(ex)) from None
    try:
        chaos_mod.parse_partitions(sw.chaos_partition)
    except ValueError as ex:
        raise SpecError("swarm.chaos_partition", str(ex)) from None

    if swarm_active(spec):
        shards = swarm_shards(spec)
        _require(o.mode == "zo", "optimizer.mode",
                 "the swarm StepCommit carries one projected-gradient "
                 "scalar — mode='zo' only (momentum/fo state cannot be "
                 "reconstructed from the (seed, g) log)")
        _require(e.name == "two_point", "estimator.name",
                 "swarm shard contributions are (l+, l-) pairs reduced "
                 "to a single g — estimator='two_point' only")
        _require(rt.n_loss_shards == 1, "runtime.n_loss_shards",
                 "the swarm shards the loss itself (swarm.n_shards); "
                 "disable the in-trainer quorum simulation")
        _require(r.batch_size % shards == 0, "run.batch_size",
                 f"must divide into the swarm's {shards} loss shards, "
                 f"got {r.batch_size}")
        _require(sw.workers <= shards, "swarm.workers",
                 f"more workers than loss shards would leave "
                 f"{sw.workers - shards} workers permanently idle; "
                 f"raise swarm.n_shards (= {shards}) or drop workers")
    return mcfg


def swarm_active(spec: Experiment) -> bool:
    """True when the spec selects the decomposed sharded step
    (``repro_torch.swarm.shardstep``) — any workers, or explicit shards."""
    return spec.swarm.workers > 0 or spec.swarm.n_shards > 0


def swarm_shards(spec: Experiment) -> int:
    """Resolved loss-shard count: explicit ``swarm.n_shards`` wins, else
    one shard per worker.  Fixed by the spec — NOT by how many processes
    actually show up — so commits are worker-count-invariant."""
    sw = spec.swarm
    return sw.n_shards if sw.n_shards > 0 else max(sw.workers, 1)


def n_drop_for(spec: Experiment, num_layers: int) -> int:
    """The LeZO drop count: 0 for first-order training; explicit
    ``optimizer.n_drop`` wins, else ``int(sparsity * L)``."""
    o = spec.optimizer
    if o.mode == "fo":
        return 0
    if o.n_drop is not None:
        return o.n_drop
    return int(o.sparsity * num_layers)

"""The unified experiment spec (copy of ``repro/api/spec.py``): one
frozen, JSON-round-trippable tree.  A spec written by ``repro.api.to_json``
loads unchanged here and serializes to the same bytes.

Every entrypoint (train, evaluate, dryrun, hillclimb, benchmarks, tests)
consumes an :class:`Experiment` instead of hand-wiring ``ZOConfig`` /
``EstimatorConfig`` / ``TrainConfig`` — those legacy dataclasses are now
*derived* views (see ``repro.api.derive``), so the optimizer recipe is
stated exactly once and a new scenario is a spec diff, not a plumbing PR
(DESIGN.md §11).

Sections:

  * ``model``     — registered architecture + variant + sequence shape
  * ``task``      — registry task name, or the synthetic stream's knobs
  * ``optimizer`` — the step recipe: mode, eps, lr, sparsity, policy
  * ``estimator`` — ZO gradient estimator and its direction budget
  * ``runtime``   — kernel/forward backends, mesh, quorum, PEFT
  * ``swarm``     — multi-process scalar-sync topology (DESIGN.md §14)
  * ``run``       — steps, batch, seed, eval cadence, checkpoint policy

Serialization is byte-stable: ``from_json(to_json(s))`` round-trips and
``to_json(from_json(txt)) == txt`` for any ``to_json``-produced text —
the golden-spec CI test pins this.
"""
import dataclasses
import json
import typing
from typing import Any, Dict, Optional, Tuple


class SpecError(ValueError):
    """A spec field is invalid.  ``path`` names the offending field
    (e.g. ``"optimizer.lr"``) and always appears in the message."""

    def __init__(self, path: str, message: str):
        self.path = path
        super().__init__(f"{path}: {message}")


class UnknownTaskError(SpecError, KeyError):
    """Unknown ``task.name``.  Also a KeyError so legacy callers that
    caught the registry's KeyError keep working."""

    def __str__(self):  # KeyError repr()s its args; keep the message
        return ValueError.__str__(self)


# --------------------------------------------------------------- sections
@dataclasses.dataclass(frozen=True)
class Model:
    arch: str = "opt-13b"         # registry id (repro.configs)
    variant: str = "smoke"        # config-module variant function
    seq_len: int = 64


@dataclasses.dataclass(frozen=True)
class Task:
    # registry task name (repro.tasks); None = legacy synthetic stream
    name: Optional[str] = None
    # synthetic-stream knobs (ignored for registry tasks)
    n_classes: int = 2
    signal_rate: float = 0.25


@dataclasses.dataclass(frozen=True)
class Optimizer:
    mode: str = "zo"              # zo | zo_momentum | fo
    eps: float = 1e-3
    lr: float = 1e-4
    schedule: str = "constant"
    weight_decay: float = 0.0
    # LeZO layer sparsity: fraction of layers dropped per step (0 = MeZO).
    # ``n_drop`` overrides the fraction with an explicit layer count.
    sparsity: float = 0.75
    n_drop: Optional[int] = None
    policy: str = "stratified"    # stratified | uniform
    fused_update: bool = True
    # FO baseline only
    fo_optimizer: str = "adamw"   # sgd | momentum | adamw
    grad_clip: Optional[float] = 1.0


@dataclasses.dataclass(frozen=True)
class Estimator:
    name: str = "two_point"       # two_point | one_sided | averaged | importance
    q: int = 1
    q_chunk: int = 0
    inner: str = "two_point"      # estimator the importance wrapper drives
    importance_decay: float = 0.99


@dataclasses.dataclass(frozen=True)
class Runtime:
    backend: str = "scan"         # axpy kernel: dense | scan | gather | pallas
    forward_backend: str = "materialized"   # | virtual | virtual_ref
    # stack the virtual ±εz pair (and one_sided's q-chunks) onto one
    # paired fused forward — bit-identical floats, half the W-tile loads
    paired_probes: bool = True
    interpret: bool = True        # axpy pallas interpret mode (CPU container)
    mesh: str = "single"          # single | multi_pod (dryrun/sharded lowering)
    n_loss_shards: int = 1
    quorum: float = 1.0
    peft: Optional[str] = None    # None | lora | prefix
    lora_rank: int = 8
    lora_alpha: int = 16
    lora_targets: Tuple[str, ...] = ("wq", "wv")
    prefix_tokens: int = 5


@dataclasses.dataclass(frozen=True)
class Swarm:
    """Seed-synchronized multi-process data-parallel ZO (DESIGN.md §14).

    ``workers > 0`` (or an explicit ``n_shards``) switches the step to
    the decomposed sharded execution path (``repro.swarm.shardstep``):
    the global batch splits into ``n_shards`` fixed loss shards, each
    shard's ±εz probe losses are evaluated independently, and the commit
    reduces them host-side in fixed shard order — so the committed step
    is bit-identical whether 1, 2 or 4 processes evaluated the shards.
    ``launch swarm`` runs the real coordinator + worker processes; a
    plain ``launch train`` on the same spec runs the identical sharded
    step in one process.  The ``chaos_*`` schedule deterministically
    injects transport faults for straggler / crash / partition testing.
    """
    workers: int = 0              # worker processes; 0 = swarm off
    n_shards: int = 0             # loss shards per step; 0 = auto (=workers)
    quorum: float = 1.0           # commit at >= round(quorum*n_shards) shards
    step_deadline_s: float = 5.0  # straggler deadline before quorum fallback
    host: str = "127.0.0.1"
    port: int = 0                 # coordinator TCP port; 0 = ephemeral
    chaos_seed: int = 0           # seeds the deterministic fault schedule
    chaos_drop: float = 0.0      # P(drop) per contribution/commit message
    chaos_delay_ms: float = 0.0  # injected delay upper bound per message
    chaos_crash: str = ""        # "worker:step[,...]" hard-exit points
    chaos_partition: str = ""    # "worker:start-end[,...]" drop-all windows


@dataclasses.dataclass(frozen=True)
class Serving:
    """Continuous-batching inference engine knobs (DESIGN.md §12).
    Pages are the cache allocation unit; buckets (``max_lanes`` decode
    lanes, ``prefill_chunk``-token prefill calls) fix every compiled
    shape, so the engine compiles exactly once per bucket."""
    page_size: int = 16           # cache slots per page
    n_pages: int = 64             # arena pages (page 0 = trash, reserved)
    max_lanes: int = 4            # decode batch bucket (concurrent requests)
    prefill_chunk: int = 32       # tokens per prefill call (page multiple)
    max_seq: int = 256            # per-request cap: prompt + generation
    max_new_tokens: int = 16      # default generation budget per request
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = full-vocab sampling
    eos_id: Optional[int] = None  # None = stop on max_new_tokens only
    # prefix-cache page sharing + preemptive scheduling (DESIGN.md §12)
    prefix_cache: bool = False    # share full-page prompt prefixes (COW)
    priorities: int = 1           # priority classes; FIFO within a class
    preempt: bool = False         # evict lower-priority decoding lanes


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """``repro_torch.obs`` wiring (DESIGN.md §13): stage-level step
    tracing, metrics, and the optional torch.profiler hook.  Disabled by
    default — the hot paths then pay the zero-allocation null tracer.
    Every field is resume-mutable: turning telemetry on (or moving a
    sink) is not a training-recipe change."""
    enabled: bool = False
    ring: int = 4096              # in-memory span ring capacity (0 = off)
    fence: bool = False           # CUDA synchronise at span exit (true
                                  # stage timings; serializes launches)
    jsonl: Optional[str] = None   # JSONL span/event log path
    prometheus: Optional[str] = None  # metrics text-dump path
    profile_dir: Optional[str] = None  # torch.profiler Chrome trace dir
    # --- optimizer-health run log (obs.health / obs.runlog): write a
    # structured run directory <runs_dir>/<run_id>/ (spec + per-step
    # scalar JSONL + summary) that `launch report` renders and `launch
    # replay` re-executes bit-identically.  Independent of `enabled` —
    # the health stream needs no tracer.  None = no run log.
    runs_dir: Optional[str] = None
    run_id: Optional[str] = None  # None = auto (timestamp + seed)
    # exact per-step ‖lr·g·z‖ via tree_z_norm (regenerates every active
    # z at drain time — accurate but costs ~1 axpy-equivalent per
    # logged step; the free E‖z‖²=N estimate is always recorded)
    health_norms: bool = False


@dataclasses.dataclass(frozen=True)
class Run:
    steps: int = 300
    batch_size: int = 16
    seed: int = 0
    # None = auto (max(1, steps // 4)); 0 = no eval
    eval_every: Optional[int] = None
    log_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0
    keep_ckpts: int = 2


@dataclasses.dataclass(frozen=True)
class Experiment:
    model: Model = Model()
    task: Task = Task()
    optimizer: Optimizer = Optimizer()
    estimator: Estimator = Estimator()
    runtime: Runtime = Runtime()
    swarm: Swarm = Swarm()
    serving: Serving = Serving()
    telemetry: Telemetry = Telemetry()
    run: Run = Run()


SECTIONS: Dict[str, type] = {
    "model": Model, "task": Task, "optimizer": Optimizer,
    "estimator": Estimator, "runtime": Runtime, "swarm": Swarm,
    "serving": Serving, "telemetry": Telemetry, "run": Run,
}

# Fields a resumed run may legitimately change relative to the spec
# embedded in its checkpoint (extend the schedule, move the ckpt dir).
# Every serving.* field is mutable too: serving a checkpoint under a
# different engine shape is not a training-recipe change.  Likewise
# every telemetry.* field — observing a run differently never changes
# what the run computes (the obs no-interference rule, DESIGN.md §13).
RESUME_MUTABLE = frozenset({
    "run.steps", "run.eval_every", "run.log_every",
    "run.ckpt_dir", "run.ckpt_every", "run.keep_ckpts",
    # swarm topology/transport knobs a resumed run may move freely —
    # the committed bits depend only on (n_shards, quorum, workers when
    # n_shards is auto), which therefore stay recipe fields
    "swarm.step_deadline_s", "swarm.host", "swarm.port",
    "swarm.chaos_seed", "swarm.chaos_drop", "swarm.chaos_delay_ms",
    "swarm.chaos_crash", "swarm.chaos_partition",
}) | {f"serving.{f.name}" for f in dataclasses.fields(Serving)} \
  | {f"telemetry.{f.name}" for f in dataclasses.fields(Telemetry)}


# ------------------------------------------------------------ field access
def field_of(path: str) -> dataclasses.Field:
    """Resolve ``"section.field"`` to its dataclass field, or raise."""
    sec, _, name = path.partition(".")
    cls = SECTIONS.get(sec)
    if cls is None:
        raise SpecError(path, f"unknown spec section {sec!r}; "
                              f"sections: {sorted(SECTIONS)}")
    for f in dataclasses.fields(cls):
        if f.name == name:
            return f
    known = [f.name for f in dataclasses.fields(cls)]
    raise SpecError(path, f"unknown field in section {sec!r}; "
                          f"fields: {known}")


def field_paths() -> Tuple[str, ...]:
    """Every ``section.field`` path, in schema order."""
    return tuple(f"{sec}.{f.name}" for sec, cls in SECTIONS.items()
                 for f in dataclasses.fields(cls))


_TRUE, _FALSE = {"1", "true", "yes", "on"}, {"0", "false", "no", "off"}
_NONE = {"none", "null", ""}


def coerce(path: str, raw: Any) -> Any:
    """Coerce a raw (usually CLI string) value to the field's type.
    The one parsing site shared by ``--set``, generated flags, and
    ``with_overrides`` — so every surface agrees on spellings."""
    f = field_of(path)
    t = f.type
    origin = typing.get_origin(t)
    if origin is typing.Union:                   # Optional[inner]
        inner = [a for a in typing.get_args(t) if a is not type(None)][0]
        if raw is None or (isinstance(raw, str) and raw.lower() in _NONE):
            return None
        t, origin = inner, typing.get_origin(inner)
    if origin is tuple:                          # Tuple[str, ...]
        if isinstance(raw, str):
            return tuple(s.strip() for s in raw.split(",") if s.strip())
        return tuple(raw)
    if not isinstance(raw, str):
        return raw
    if t is bool:
        low = raw.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise SpecError(path, f"expected a boolean, got {raw!r}")
    try:
        if t is int:
            return int(raw)
        if t is float:
            return float(raw)
    except ValueError:
        raise SpecError(path, f"expected {t.__name__}, got {raw!r}") from None
    return raw


def with_overrides(spec: Experiment, overrides: Dict[str, Any]) -> Experiment:
    """Return ``spec`` with dotted-path overrides applied
    (``{"optimizer.lr": "1e-4", "estimator.q": 16}``).  String values are
    coerced to the field type; unknown paths raise :class:`SpecError`."""
    by_sec: Dict[str, Dict[str, Any]] = {}
    for path, raw in overrides.items():
        sec, _, name = path.partition(".")
        by_sec.setdefault(sec, {})[name] = coerce(path, raw)
    return dataclasses.replace(spec, **{
        sec: dataclasses.replace(getattr(spec, sec), **kv)
        for sec, kv in by_sec.items()})


def get(spec: Experiment, path: str) -> Any:
    field_of(path)
    sec, _, name = path.partition(".")
    return getattr(getattr(spec, sec), name)


# ----------------------------------------------------------- serialization
def to_dict(spec: Experiment) -> Dict[str, Dict[str, Any]]:
    """Nested plain dict, field order preserved, tuples as lists."""
    out: Dict[str, Dict[str, Any]] = {}
    for sec, cls in SECTIONS.items():
        node = getattr(spec, sec)
        out[sec] = {f.name: (list(v) if isinstance(
            v := getattr(node, f.name), tuple) else v)
            for f in dataclasses.fields(cls)}
    return out


def from_dict(d: Dict[str, Any]) -> Experiment:
    """Inverse of :func:`to_dict`.  Missing sections/fields take their
    defaults; unknown keys raise :class:`SpecError` with the path."""
    if not isinstance(d, dict):
        raise SpecError("<root>", f"expected a dict, got {type(d).__name__}")
    sections = {}
    for sec, payload in d.items():
        cls = SECTIONS.get(sec)
        if cls is None:
            raise SpecError(sec, f"unknown spec section; "
                                 f"sections: {sorted(SECTIONS)}")
        if not isinstance(payload, dict):
            raise SpecError(sec, "expected a mapping of fields")
        kv = {}
        for name, val in payload.items():
            kv[name] = coerce(f"{sec}.{name}",
                              tuple(val) if isinstance(val, list) else val)
        sections[sec] = cls(**kv)
    return Experiment(**sections)


def to_json(spec: Experiment) -> str:
    return json.dumps(to_dict(spec), indent=1) + "\n"


def from_json(text: str) -> Experiment:
    return from_dict(json.loads(text))


# ------------------------------------------------------------------- diff
def spec_diff(a: Dict[str, Any], b: Dict[str, Any],
              ignore=RESUME_MUTABLE) -> Tuple[str, ...]:
    """Human-readable field-level differences between two spec dicts,
    as ``"path: <a> != <b>"`` lines.  Paths in ``ignore`` are skipped."""
    lines = []
    for path in field_paths():
        if path in ignore:
            continue
        sec, _, name = path.partition(".")
        default = getattr(SECTIONS[sec](), name)
        default = list(default) if isinstance(default, tuple) else default
        va = a.get(sec, {}).get(name, default)
        vb = b.get(sec, {}).get(name, default)
        if va != vb:
            lines.append(f"{path}: {va!r} != {vb!r}")
    return tuple(lines)


def check_resume_spec(saved: Dict[str, Any], spec: Experiment):
    """Fail loudly when a checkpoint's embedded spec disagrees with the
    resuming run's spec on anything beyond the RESUME_MUTABLE fields."""
    diff = spec_diff(saved, to_dict(spec))
    if diff:
        raise SpecError("<resume>", "checkpoint spec does not match the "
                        "resuming experiment spec:\n  " + "\n  ".join(diff))

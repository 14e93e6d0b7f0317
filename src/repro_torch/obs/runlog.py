"""Structured run directories of the port (counterpart of
``repro/obs/runlog.py``): the durable form of a training run.

A ``launch train`` with ``telemetry.runs_dir`` set writes
``<runs_dir>/<run_id>/``:

  * ``spec.json``    — the full ``repro_torch.api`` Experiment that
    produced the run (the same serializer as ``api.to_dict``).
  * ``steps.jsonl``  — one JSON row per training step from the
    :class:`repro_torch.obs.health.HealthAccumulator` drain: seed lineage
    (``step`` → ``seed``), loss, projected gradient(s), ε/lr applied,
    LeZO layer selection, update magnitudes.
  * ``summary.json`` — running aggregates written at ``finalize()``.
  * ``trace.jsonl``  — the stage-timing trace, when the tracer is
    enabled and no explicit ``telemetry.jsonl`` redirects it.

The four files and their JSON are the reference's, so a run directory
written by either package loads in the other.  Floats survive the JSON
round trip exactly (float32 → Python float → JSON → float32 is
lossless), which is what makes bit-exact replay from a run directory
possible (``launch replay``).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.obs import sinks

DEFAULT_RUNS_DIR = os.path.join("artifacts", "runs")

SPEC_FILE = "spec.json"
STEPS_FILE = "steps.jsonl"
SUMMARY_FILE = "summary.json"
TRACE_FILE = "trace.jsonl"


def _dump_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")


def make_run_id(root: str, seed: int = 0, now: Optional[float] = None) -> str:
    """Timestamped, seed-tagged, collision-free id under ``root``."""
    stamp = time.strftime("%Y%m%d-%H%M%S",
                          time.localtime(time.time() if now is None else now))
    base = f"{stamp}-s{int(seed)}"
    rid, k = base, 1
    while os.path.exists(os.path.join(root, rid)):
        k += 1
        rid = f"{base}-{k}"
    return rid


class RunLog:
    """Writer half: create the dir, stream step rows, finalize."""

    def __init__(self, root: str, run_id: str,
                 spec: Optional[Dict[str, Any]] = None):
        self.root = root
        self.run_id = run_id
        self.dir = os.path.join(root, run_id)
        os.makedirs(self.dir, exist_ok=True)
        if spec is not None:
            _dump_json(os.path.join(self.dir, SPEC_FILE), spec)
        self._sink = sinks.JSONLSink(os.path.join(self.dir, STEPS_FILE))

    @property
    def trace_path(self) -> str:
        """Where the stage trace of this run belongs."""
        return os.path.join(self.dir, TRACE_FILE)

    def append(self, rows: List[Dict[str, Any]]) -> None:
        for row in rows:
            self._sink.emit_event(dict(row, type="step"))
        self._sink.flush()

    def finalize(self, summary: Optional[Dict[str, Any]] = None) -> None:
        if summary is not None:
            _dump_json(os.path.join(self.dir, SUMMARY_FILE), summary)
        self._sink.close()


@dataclass
class RunDir:
    """Reader half: a loaded run directory."""

    dir: str
    run_id: str
    spec: Optional[Dict[str, Any]] = None
    steps: List[Dict[str, Any]] = field(default_factory=list)
    summary: Optional[Dict[str, Any]] = None

    def step_row(self, step: int) -> Dict[str, Any]:
        for row in self.steps:
            if row.get("step") == step:
                return row
        raise KeyError(
            f"run {self.run_id!r} has no recorded step {step} "
            f"(steps {self.first_step}..{self.last_step})")

    @property
    def first_step(self) -> Optional[int]:
        return self.steps[0]["step"] if self.steps else None

    @property
    def last_step(self) -> Optional[int]:
        return self.steps[-1]["step"] if self.steps else None


def is_run_dir(path: str) -> bool:
    return os.path.isfile(os.path.join(path, SPEC_FILE)) or \
        os.path.isfile(os.path.join(path, STEPS_FILE))


def list_runs(root: str = DEFAULT_RUNS_DIR) -> List[str]:
    """Run ids under ``root``, oldest first (mtime then name)."""
    if not os.path.isdir(root):
        return []
    entries = []
    for name in os.listdir(root):
        p = os.path.join(root, name)
        if os.path.isdir(p) and is_run_dir(p):
            entries.append((os.path.getmtime(p), name))
    return [name for _, name in sorted(entries)]


def resolve_run(run: Optional[str], root: str = DEFAULT_RUNS_DIR) -> str:
    """Map a run id / path / None (= latest under root) to its dir."""
    if run is None:
        runs = list_runs(root)
        if not runs:
            raise FileNotFoundError(f"no run directories under {root!r}")
        return os.path.join(root, runs[-1])
    if os.path.isdir(run) and is_run_dir(run):
        return run
    cand = os.path.join(root, run)
    if os.path.isdir(cand) and is_run_dir(cand):
        return cand
    raise FileNotFoundError(
        f"run {run!r} not found (not a run dir, and {cand!r} "
        f"does not exist); known runs: {list_runs(root) or '[]'}")


def load_run(run: Optional[str], root: str = DEFAULT_RUNS_DIR) -> RunDir:
    """Load ``spec.json`` + step rows + ``summary.json`` if present."""
    d = resolve_run(run, root)
    rd = RunDir(dir=d, run_id=os.path.basename(os.path.normpath(d)))
    spec_path = os.path.join(d, SPEC_FILE)
    if os.path.isfile(spec_path):
        with open(spec_path) as f:
            rd.spec = json.load(f)
    steps_path = os.path.join(d, STEPS_FILE)
    if os.path.isfile(steps_path):
        rd.steps = [r for r in sinks.read_jsonl(steps_path)
                    if r.get("type") == "step"]
        rd.steps.sort(key=lambda r: r.get("step", -1))
    summary_path = os.path.join(d, SUMMARY_FILE)
    if os.path.isfile(summary_path):
        with open(summary_path) as f:
            rd.summary = json.load(f)
    return rd

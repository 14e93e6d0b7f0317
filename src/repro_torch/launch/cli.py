"""The port's spec-driven launch CLI (counterpart of
``repro/launch/cli.py``)::

    python -m repro_torch.launch train    --preset lezo-opt13b --set optimizer.lr=1e-4
    python -m repro_torch.launch evaluate --task sst2 --mode train
    python -m repro_torch.launch specs    --out artifacts/specs
    python -m repro_torch.launch report   [RUN] [--runs-root DIR]
    python -m repro_torch.launch replay   [RUN] [--step K] [--device cpu]
    python -m repro_torch.launch swarm    --preset swarm-smoke [--device cpu]
    python -m repro_torch.launch swarm    --attach HOST:PORT [--device cpu]

Every shared flag is *generated* from the spec schema —
``--<section>.<field>`` for each field, plus the reference's short
aliases — so the commands start from the same preset and differ only by
spec overrides.  Precedence: preset < generated/alias flags < command
implications (``train --optimizer mezo`` always means n_drop=0) <
``--set section.field=value``.

``train`` writes a run directory under ``artifacts/runs/`` by default,
as the reference does; ``--runs-dir`` moves it and ``--no-runlog`` turns
it off.  ``report`` renders a run directory as markdown; ``replay``
re-executes it and exits 1 when any recorded scalar differs.  ``swarm``
runs the seed-synchronized swarm (a coordinator here, ``swarm.workers``
local worker processes, 2 unless the spec sets workers or shards) and
writes a run directory the same way; ``--attach`` joins a running
coordinator as one worker.

One flag the reference lacks: ``--device`` (default ``cuda``) on
``train``, ``evaluate``, ``replay`` and ``swarm`` (where the workers
take it too: local workers on the card share that one card); the CPU
runs only when asked
with ``--device cpu``, and without a card the default fails rather than
falling back.  ``specs`` has no ``--markdown``.  The module entry points
``repro_torch.launch.train`` and ``.evaluate`` are thin shims that
forward here.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

from repro_torch import api
from repro_torch.api import presets as presets_mod
from repro_torch.api import spec as spec_mod

# Short ergonomic spellings (the reference's table); the long generated
# form always exists too.
ALIASES = {
    "--arch": "model.arch",
    "--variant": "model.variant",
    "--seq-len": "model.seq_len",
    "--task": "task.name",
    "--lr": "optimizer.lr",
    "--eps": "optimizer.eps",
    "--sparsity": "optimizer.sparsity",
    "--estimator": "estimator.name",
    "--q": "estimator.q",
    "--backend": "runtime.backend",
    "--forward-backend": "runtime.forward_backend",
    "--peft": "runtime.peft",
    "--quorum": "runtime.quorum",
    "--loss-shards": "runtime.n_loss_shards",
    "--steps": "run.steps",
    "--batch-size": "run.batch_size",
    "--seed": "run.seed",
    "--ckpt-dir": "run.ckpt_dir",
    "--ckpt-every": "run.ckpt_every",
    "--telemetry": "telemetry.enabled",
    "--trace-jsonl": "telemetry.jsonl",
    "--profile-dir": "telemetry.profile_dir",
    "--runs-dir": "telemetry.runs_dir",
}

# commands that read a run directory, not a spec
_NO_SPEC_CMDS = {"report", "replay"}

_SPEC_DEST = "spec_overrides"


class _SpecFlag(argparse.Action):
    """Collects any generated/alias spec flag into one ordered dict."""

    def __call__(self, parser, ns, value, option_string=None):
        store = getattr(ns, _SPEC_DEST, None)
        if store is None:
            store = {}
            setattr(ns, _SPEC_DEST, store)
        store[self.metavar] = value   # metavar carries the spec path


def add_spec_flags(ap: argparse.ArgumentParser):
    """Generate ``--section.field`` flags from the spec schema + the
    alias table.  Values are raw strings; ``api.with_overrides`` types
    them, as ``--set`` does."""
    g = ap.add_argument_group("experiment spec (generated from the spec)")
    for path in spec_mod.field_paths():
        sec, _, name = path.partition(".")
        default = getattr(getattr(api.Experiment(), sec), name)
        g.add_argument(f"--{path}", action=_SpecFlag, metavar=path,
                       help=f"(default from preset; base {default!r})")
    for flag, path in sorted(ALIASES.items()):
        g.add_argument(flag, action=_SpecFlag, metavar=path,
                       help=f"alias for --{path}")
    ap.add_argument("--preset", default="default",
                    help=f"base spec; one of {presets_mod.names()}")
    ap.add_argument("--set", action="append", default=[], metavar="PATH=VAL",
                    help="spec override, e.g. --set optimizer.lr=1e-4 "
                         "(highest precedence, repeatable)")
    _add_device(ap)


def _add_device(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs "
                         "the kernels' plain versions)")


def build_spec(ns, implied: Optional[Dict] = None) -> api.Experiment:
    """preset -> flags -> command implications -> --set."""
    spec = presets_mod.get(ns.preset)
    flags = getattr(ns, _SPEC_DEST, None) or {}
    if flags:
        spec = api.with_overrides(spec, flags)
    if implied:
        spec = api.with_overrides(spec, implied)
    sets = {}
    for kv in ns.set:
        path, eq, val = kv.partition("=")
        if not eq:
            raise spec_mod.SpecError(path, "--set expects PATH=VALUE")
        sets[path] = val
    if sets:
        spec = api.with_overrides(spec, sets)
    return spec


def _clean_history(hist: Dict) -> Dict:
    return {k: v for k, v in hist.items() if not k.endswith("params")}


def _write_json(path: str, payload):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)


# ---------------------------------------------------------------- commands
def _cmd_train(ns):
    from repro_torch.obs import runlog

    implied = {}
    if ns.optimizer == "mezo":
        implied = {"optimizer.sparsity": 0.0, "optimizer.n_drop": None}
    elif ns.optimizer == "fo":
        implied = {"optimizer.mode": "fo"}
    # every launch train writes a run directory by default; an explicit
    # flag wins (implications beat generated flags, so check first) and
    # --no-runlog turns the registry off entirely
    flags = getattr(ns, _SPEC_DEST, None) or {}
    user_set = {kv.partition("=")[0] for kv in ns.set}
    if (not ns.no_runlog and "telemetry.runs_dir" not in flags
            and "telemetry.runs_dir" not in user_set):
        implied["telemetry.runs_dir"] = runlog.DEFAULT_RUNS_DIR
    spec = build_spec(ns, implied)
    result = api.run(spec, device=ns.device)
    print(json.dumps(result["summary"], indent=1))
    if ns.out:
        _write_json(ns.out, {"spec": result["spec"],
                             "summary": result["summary"],
                             "history": _clean_history(result["history"])})
    return result


def _cmd_evaluate(ns):
    from repro_torch import tasks
    spec = build_spec(ns)
    raw = spec.task.name
    names = tasks.names() if raw in (None, "all") else [raw]
    reports = [api.evaluate(api.with_overrides(spec, {"task.name": n}),
                            mode=ns.mode, n_examples=ns.n_examples,
                            device=ns.device)
               for n in names]
    print(json.dumps(reports, indent=1))
    if ns.out:
        _write_json(ns.out, reports)
    return reports


def _cmd_report(ns):
    from repro_torch.launch import report as report_mod

    rep = report_mod.report_run(ns.run, runs_root=ns.runs_root, out=ns.out)
    print(rep["markdown"])
    return rep


def _cmd_replay(ns):
    from repro_torch.launch import replay as replay_mod

    rep = replay_mod.replay_run(ns.run, step=ns.step,
                                runs_root=ns.runs_root, device=ns.device)
    rep.pop("final_params")
    print(json.dumps(rep, indent=1))
    return rep


def _cmd_swarm(ns):
    from repro_torch.obs import runlog
    from repro_torch.swarm import driver

    if ns.attach:
        result = driver.run_attached(ns.attach, device=ns.device)
        # one line: the driver reads a worker's result as its last line
        print(json.dumps(result))
        return result
    # like train: every coordinator writes a run directory by default —
    # the (seed, g) log is both the recovery substrate and the replay
    # evidence, so a swarm without one defeats the point
    implied = {}
    flags = getattr(ns, _SPEC_DEST, None) or {}
    user_set = {kv.partition("=")[0] for kv in ns.set}
    if (not ns.no_runlog and "telemetry.runs_dir" not in flags
            and "telemetry.runs_dir" not in user_set):
        implied["telemetry.runs_dir"] = runlog.DEFAULT_RUNS_DIR
    if ("swarm.workers" not in flags and "swarm.workers" not in user_set
            and "swarm.n_shards" not in flags
            and "swarm.n_shards" not in user_set):
        implied["swarm.workers"] = 2
    spec = build_spec(ns, implied)
    summary = driver.run_swarm(spec, respawn=not ns.no_respawn,
                               device=ns.device)
    print(json.dumps(summary, indent=1))
    if ns.out:
        _write_json(ns.out, {"spec": api.to_dict(spec), "summary": summary})
    return summary


def _cmd_specs(ns):
    os.makedirs(ns.out, exist_ok=True)
    written = {}
    for name in presets_mod.names():
        path = os.path.join(ns.out, f"{name}.json")
        with open(path, "w") as f:
            f.write(api.to_json(presets_mod.get(name)))
        written[name] = path
    print(json.dumps(written, indent=1))
    return written


# ------------------------------------------------------------------ parser
def _add_extras(cmd: str, ap: argparse.ArgumentParser):
    """Command-specific flags only — nothing here may shadow a spec field."""
    if cmd == "train":
        ap.add_argument("--optimizer", default="lezo",
                        choices=["lezo", "mezo", "fo"],
                        help="lezo (spec sparsity) | mezo (sparsity=0) | fo")
        ap.add_argument("--out", default=None, help="write history JSON here")
        ap.add_argument("--no-runlog", action="store_true",
                        help="write no run directory (default: one under "
                             "artifacts/runs/)")
    elif cmd == "evaluate":
        ap.add_argument("--mode", default="zeroshot",
                        choices=["zeroshot", "train"])
        ap.add_argument("--n-examples", type=int, default=256)
        ap.add_argument("--out", default=None, help="also write JSON here")
    elif cmd == "specs":
        ap.add_argument("--out", default="artifacts/specs",
                        help="dump every preset spec JSON here")
    elif cmd in _NO_SPEC_CMDS:
        ap.add_argument("run", nargs="?", default=None,
                        help="run id or run-dir path (default: the "
                             "latest run under --runs-root)")
        ap.add_argument("--runs-root", default="artifacts/runs",
                        help="run registry root (launch train default)")
        if cmd == "replay":
            ap.add_argument("--step", type=int, default=None,
                            help="step to verify through (default: last "
                                 "recorded)")
            _add_device(ap)
        else:
            ap.add_argument("--out", default=None,
                            help="also write the markdown here (default: "
                                 "<run_dir>/report.md only)")
    elif cmd == "swarm":
        ap.add_argument("--attach", default=None, metavar="HOST:PORT",
                        help="join an existing swarm as a worker instead "
                             "of starting a coordinator (the spec ships "
                             "over the wire)")
        ap.add_argument("--no-respawn", action="store_true",
                        help="do not respawn workers that die mid-run")
        ap.add_argument("--no-runlog", action="store_true",
                        help="write no run directory (default: one under "
                             "artifacts/runs/)")
        ap.add_argument("--out", default=None,
                        help="also write the summary JSON here")


COMMANDS = {"train": _cmd_train, "evaluate": _cmd_evaluate,
            "specs": _cmd_specs, "report": _cmd_report,
            "replay": _cmd_replay, "swarm": _cmd_swarm}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for cmd in COMMANDS:
        p = sub.add_parser(cmd)
        if cmd not in _NO_SPEC_CMDS:
            add_spec_flags(p)
        _add_extras(cmd, p)
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ns = build_parser().parse_args(argv)
    return COMMANDS[ns.cmd](ns)


def console(argv=None) -> int:
    result = main(argv)
    if isinstance(result, dict) and result.get("failures"):
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(console())

"""CLI/spec reference generation from the port's live schema
(counterpart of ``repro/launch/docgen.py``).

The port's CLI derives every shared flag from the ``repro_torch.api``
spec schema; this module derives the documentation from the same
source and the live argparse tree, so it cannot drift from the code.
Output is a pure function of the schema, byte-stable, and written only
into the directory it is given.

Two products:

  * ``docs/cli.md`` — rewritten wholesale: commands + their extras
    flags (introspected from the live argparse tree), alias table, the
    full ``--section.field`` reference with types and defaults, and the
    preset catalog as diffs against the default spec.
  * ``docs/serving.md`` — hand-written architecture doc; only the span
    between the ``generated:serving-spec`` markers is rewritten (the
    serving-node reference table).
  * ``docs/observability.md`` — hand-written telemetry doc
    (DESIGN.md §13); only the ``generated:telemetry-spec`` marker span
    is rewritten (the telemetry-node reference table).
"""
from __future__ import annotations

import dataclasses
import os
import typing
from typing import Dict, List

from repro_torch.api import presets as presets_mod
from repro_torch.api import spec as spec_mod

PROG = "python -m repro_torch.launch"
GENERATED_NOTE = (f"<!-- GENERATED by `{PROG} specs --markdown docs`. "
                  "Do not edit by hand. -->")
MARK_BEGIN = "<!-- generated:serving-spec:begin -->"
MARK_END = "<!-- generated:serving-spec:end -->"
TEL_MARK_BEGIN = "<!-- generated:telemetry-spec:begin -->"
TEL_MARK_END = "<!-- generated:telemetry-spec:end -->"

_CMD_SUMMARY = {
    "train": "run an experiment spec end to end on the card (`--device "
             "cpu` for the CPU); prints the summary JSON",
    "evaluate": "zero-shot or post-train task metrics, per task or "
                "`--task all`",
    "dryrun": "cost grid cells on the production mesh (a fake process "
              "group over meta tensors: no card, nothing allocated); "
              "prints the H100 roofline terms and per-device memory",
    "hillclimb": "H100 roofline of one (arch, shape) cell under "
                 "model-config overrides (no card)",
    "serve": "drive the continuous-batching paged engine (or the "
             "lockstep loop) on synthetic traffic",
    "swarm": "coordinator + N local worker processes training one spec "
             "with scalar-only sync; `--attach host:port` joins an "
             "existing swarm as a worker",
    "specs": "dump every preset spec JSON; `--markdown DIR` regenerates "
             "the generated docs under DIR",
    "report": "render the markdown convergence/health report for a "
              "recorded run directory (no spec flags — the run's own "
              "spec.json applies)",
    "replay": "re-execute a recorded run's steps and verify every "
              "health scalar bit-for-bit against the run log (no spec "
              "flags — the run's own spec.json applies)",
}


def _type_name(t) -> str:
    origin = typing.get_origin(t)
    if origin is typing.Union:
        inner = [a for a in typing.get_args(t) if a is not type(None)][0]
        return f"{_type_name(inner)} or none"
    if origin is tuple:
        return "comma list"
    return getattr(t, "__name__", str(t))


def _cell(s: str) -> str:
    """Escape the table-breaking pipe in free-text cells."""
    return s.replace("|", "\\|")


def _fmt(v) -> str:
    if v is None:
        return "none"
    if isinstance(v, tuple):
        return ",".join(v)
    return repr(v) if isinstance(v, str) else str(v)


def _alias_by_path() -> Dict[str, str]:
    from repro_torch.launch import cli
    return {path: flag for flag, path in cli.ALIASES.items()}


def _extras_rows(cmd: str) -> List[tuple]:
    """(flag, default, help) for the command-specific flags, introspected
    from the live parser so the doc cannot drift from argparse."""
    import argparse

    from repro_torch.launch import cli
    ap = argparse.ArgumentParser(add_help=False)
    if cmd not in cli._NO_SPEC_CMDS | cli._CARDLESS_CMDS:
        cli._add_device(ap)
    cli._add_extras(cmd, ap)
    rows = []
    for a in ap._actions:
        # positionals (e.g. report/replay's RUN operand) have no option
        # strings — document them by dest
        flag = a.option_strings[0] if a.option_strings else a.dest.upper()
        default = "" if a.default in (None, False, []) else _fmt(a.default)
        extra = (f" (one of: {', '.join(a.choices)})" if a.choices else "")
        rows.append((flag, default, (a.help or "") + extra))
    return rows


def spec_table(section: str) -> List[str]:
    cls = spec_mod.SECTIONS[section]
    alias = _alias_by_path()
    lines = [f"| `{section}.<field>` | type | default | alias |",
             "|---|---|---|---|"]
    for f in dataclasses.fields(cls):
        path = f"{section}.{f.name}"
        al = f"`{alias[path]}`" if path in alias else ""
        lines.append(f"| `{path}` | {_type_name(f.type)} | "
                     f"`{_fmt(f.default)}` | {al} |")
    return lines


def preset_rows() -> List[str]:
    base = spec_mod.to_dict(spec_mod.Experiment())
    lines = ["| preset | overrides vs `default` |", "|---|---|"]
    for name in presets_mod.names():
        cur = spec_mod.to_dict(presets_mod.get(name))
        # structured diff straight off the dict trees — not a reparse of
        # spec_diff's human-readable lines
        diff = [(f"{sec}.{field}", cur[sec][field])
                for sec in spec_mod.SECTIONS
                for field in base[sec]
                if cur[sec][field] != base[sec][field]]
        body = ("; ".join(f"`{p}` = {_cell(repr(v))}" for p, v in diff)
                if diff else "(the default spec)")
        lines.append(f"| `{name}` | {body} |")
    return lines


def cli_markdown() -> str:
    out = [GENERATED_NOTE, "", f"# `{PROG}` — CLI reference",
           "",
           "One spec-driven CLI for every command (DESIGN.md §11).  All",
           "commands share the same generated flag surface: a `--preset`",
           "base, one `--<section>.<field>` flag per spec field, the short",
           "aliases below, and `--set section.field=value` (highest",
           "precedence, repeatable).  Precedence: preset < flags < command",
           "implications < `--set`.", "",
           "```bash", f"PYTHONPATH=src {PROG} <command> "
           "[--preset NAME] [flags] [--set PATH=VAL]", "```", "",
           "## Commands", ""]
    for cmd, summary in _CMD_SUMMARY.items():
        out += [f"### `{cmd}`", "", summary + ".", ""]
        rows = _extras_rows(cmd)
        if rows:
            out += ["| flag | default | help |", "|---|---|---|"]
            out += [f"| `{fl}` | {_cell(df)} | {_cell(hp)} |"
                    for fl, df, hp in rows]
            out += [""]
    out += ["## Experiment-spec flags", "",
            "Generated from the `repro_torch.api` schema — every field is",
            "settable as `--section.field VALUE` on any command; the",
            "alias column lists the short spelling where one exists.", ""]
    for section in spec_mod.SECTIONS:
        out += [f"### `{section}`", ""]
        out += spec_table(section)
        out += [""]
    out += ["## Presets", ""]
    out += preset_rows()
    out += ["", f"Dump them all: `{PROG} specs --out artifacts/specs`.",
            ""]
    return "\n".join(out)


def serving_spec_markdown() -> str:
    out = [MARK_BEGIN, GENERATED_NOTE, ""]
    out += spec_table("serving")
    out += ["", MARK_END]
    return "\n".join(out)


def telemetry_spec_markdown() -> str:
    out = [TEL_MARK_BEGIN, GENERATED_NOTE, ""]
    out += spec_table("telemetry")
    out += ["", TEL_MARK_END]
    return "\n".join(out)


def inject(text: str, generated: str,
           begin: str = MARK_BEGIN, end: str = MARK_END) -> str:
    """Replace the ``begin``..``end`` marker span in ``text`` with
    ``generated`` (which carries its own markers)."""
    try:
        head, rest = text.split(begin, 1)
        _, tail = rest.split(end, 1)
    except ValueError:
        raise ValueError(
            f"marker pair {begin!r}..{end!r} not found — "
            "restore the markers so the generated span can be rewritten"
        ) from None
    return head + generated + tail


def write_docs(docs_dir: str) -> Dict[str, str]:
    """Regenerate ``cli.md`` (wholesale) and the generated spans of
    ``serving.md`` and ``observability.md`` under ``docs_dir``, returning
    {path: new content}.  Idempotent."""
    os.makedirs(docs_dir, exist_ok=True)
    written = {}
    cli_path = os.path.join(docs_dir, "cli.md")
    cli_text = cli_markdown()
    with open(cli_path, "w") as f:
        f.write(cli_text)
    written[cli_path] = cli_text
    # hand-written docs: only their generated marker spans are ours to
    # rewrite — a bare target dir gets cli.md and a note, not a crash
    spans = [("serving.md", serving_spec_markdown, MARK_BEGIN, MARK_END),
             ("observability.md", telemetry_spec_markdown,
              TEL_MARK_BEGIN, TEL_MARK_END)]
    for name, gen, begin, end in spans:
        path = os.path.join(docs_dir, name)
        if not os.path.exists(path):
            print(f"docgen: {path} absent, skipped (hand-written doc "
                  "— restore it from the repo to regenerate its spec table)")
            continue
        with open(path) as f:
            text = f.read()
        new = inject(text, gen(), begin, end)
        with open(path, "w") as f:
            f.write(new)
        written[path] = new
    return written

"""``launch report`` of the port (counterpart of
``repro/launch/report.py``): a markdown convergence and health report
for a run directory.

Renders the optimizer-health stream a ``launch train`` run recorded
(``obs.health`` through ``obs.runlog``) into one markdown page:

  * the run header and the spec fields that shape ZO convergence;
  * the loss trajectory and the projected gradient's mean/variance
    trend (a diverging g-variance means ε or lr is mis-set long before
    the loss shows it);
  * LeZO layer coverage and staleness from the run summary;
  * update magnitudes: the exact RNG-stream norm ‖lr·g·z‖ when the run
    recorded it (``telemetry.health_norms``) and the E‖z‖² = N estimate;
  * stage timings aggregated by span name from the run's
    ``trace.jsonl`` when the tracer was on (``telemetry.enabled``).

Pure text generation, the reference's layout: a run directory written by
either package renders here and there alike.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from repro_torch.obs import runlog
from repro_torch.obs.sinks import spans_from_jsonl

REPORT_FILE = "report.md"

_BAR = "#"
_BAR_WIDTH = 40


def _bar(value: float, peak: float, width: int = _BAR_WIDTH) -> str:
    if peak <= 0:
        return ""
    n = int(round(width * value / peak))
    return _BAR * max(n, 1 if value > 0 else 0)


def _fmt(v: Any, digits: int = 6) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{digits}g}"
    return str(v)


def _spec_highlights(spec: Optional[Dict]) -> List[str]:
    if not spec:
        return ["(run dir carries no spec.json)"]
    get = lambda sec, key: spec.get(sec, {}).get(key)  # noqa: E731
    rows = [
        ("model", f"{get('model', 'arch')} ({get('model', 'variant')}), "
                  f"seq_len {get('model', 'seq_len')}"),
        ("estimator", f"{get('estimator', 'name')} q={get('estimator', 'q')} "
                      f"on {get('runtime', 'forward_backend')} forwards, "
                      f"{get('runtime', 'backend')} axpy"),
        ("optimizer", f"mode {get('optimizer', 'mode')}, "
                      f"lr {_fmt(get('optimizer', 'lr'))}, "
                      f"eps {_fmt(get('optimizer', 'eps'))}, "
                      f"sparsity {_fmt(get('optimizer', 'sparsity'))}"),
        ("run", f"steps {get('run', 'steps')}, "
                f"batch {get('run', 'batch_size')}, "
                f"seed {get('run', 'seed')}"),
    ]
    return [f"- **{k}**: {v}" for k, v in rows]


def _series(rows: List[Dict], key: str) -> List[tuple]:
    return [(r["step"], r[key]) for r in rows if r.get(key) is not None]


def _trend_table(rows: List[Dict], keys: List[str],
                 max_rows: int = 12) -> List[str]:
    """A step-indexed markdown table, thinned to ~max_rows rows."""
    present = [k for k in keys if any(k in r for r in rows)]
    if not present:
        return ["(no health scalars recorded)"]
    stride = max(1, (len(rows) + max_rows - 1) // max_rows)
    picked = rows[::stride]
    if rows and picked[-1] is not rows[-1]:
        picked.append(rows[-1])
    out = ["| step | " + " | ".join(present) + " |",
           "|---" * (len(present) + 1) + "|"]
    for r in picked:
        cells = [_fmt(r.get(k)) for k in present]
        out.append(f"| {r['step']} | " + " | ".join(cells) + " |")
    return out


def _coverage_section(summary: Optional[Dict]) -> List[str]:
    if not summary or "layer_counts" not in summary:
        return ["(no per-layer selection data — flat parameter tree or "
                "no summary.json)"]
    counts = summary["layer_counts"]
    stale = summary.get("layer_staleness", [None] * len(counts))
    peak = max(counts) if counts else 0
    out = ["| layer | selected | staleness | coverage |",
           "|---|---|---|---|"]
    for i, (c, s) in enumerate(zip(counts, stale)):
        st = "never" if s is None or s < 0 else str(s)
        out.append(f"| {i} | {c} | {st} | `{_bar(c, peak)}` |")
    never = summary.get("layers_never_selected")
    if never:
        out.append("")
        out.append(f"**{never} layer(s) never selected** — at this run "
                   "length the LeZO drop schedule left them untouched.")
    return out


def _timing_section(trace_path: str) -> List[str]:
    if not os.path.exists(trace_path):
        return ["(no trace.jsonl — run with `--telemetry` / "
                "`telemetry.enabled=true` to record stage timings)"]
    spans = spans_from_jsonl(trace_path)
    if not spans:
        return ["(trace.jsonl holds no spans)"]
    agg: Dict[str, List[float]] = {}
    for sp in spans:
        agg.setdefault(sp.name, []).append(sp.dt)
    total = sum(sum(v) for v in agg.values())
    out = ["| stage | calls | total s | mean ms | share |",
           "|---|---|---|---|---|"]
    for name, durs in sorted(agg.items(), key=lambda kv: -sum(kv[1])):
        tot = sum(durs)
        share = 100.0 * tot / total if total else 0.0
        out.append(f"| {name} | {len(durs)} | {tot:.4f} | "
                   f"{1e3 * tot / len(durs):.3f} | {share:.1f}% |")
    return out


def render_report(rd: runlog.RunDir) -> str:
    rows = rd.steps
    summary = rd.summary or {}
    lines = [f"# Run report — `{rd.run_id}`", "",
             f"Run directory: `{rd.dir}`", ""]
    lines += ["## Spec", ""] + _spec_highlights(rd.spec) + [""]

    lines += ["## Convergence", ""]
    if rows:
        losses = _series(rows, "loss")
        gvars = _series(rows, "g_var")
        lines += [f"- steps recorded: **{len(rows)}** "
                  f"({rd.first_step}..{rd.last_step})"]
        if losses:
            lines += [f"- loss: {_fmt(losses[0][1])} -> "
                      f"{_fmt(losses[-1][1])}"]
        if "g_mean" in (summary or {}):
            lines += [f"- projected-gradient g: mean {_fmt(summary['g_mean'])}"
                      f", variance {_fmt(summary.get('g_var'))} over "
                      f"{summary.get('g_count')} probes"]
        if gvars:
            first_nz = next((v for _, v in gvars if v), None)
            trend = ("rising" if first_nz and gvars[-1][1] > 2 * first_nz
                     else "stable/decaying")
            lines += [f"- g-variance trend: **{trend}** "
                      f"(last {_fmt(gvars[-1][1])})"]
        lines += [""]
        lines += _trend_table(rows, ["loss", "projected_grad", "g_mean",
                                     "g_var", "update_norm",
                                     "update_norm_est", "active_layers"])
    else:
        lines += ["(steps.jsonl is empty)"]
    lines += [""]

    lines += ["## Applied hyperparameters", ""]
    if rows:
        last = rows[-1]
        lines += [f"- eps actually applied: {_fmt(last.get('eps'))}",
                  f"- lr actually applied: {_fmt(last.get('lr'))}"]
        if last.get("update_norm") is not None:
            lines += [f"- last update magnitude (exact RNG-stream norm): "
                      f"{_fmt(last['update_norm'])}"]
        if last.get("update_norm_est") is not None:
            lines += [f"- last update magnitude (E||z||^2 = N estimate): "
                      f"{_fmt(last['update_norm_est'])}"]
    lines += [""]

    lines += ["## LeZO layer coverage", ""]
    lines += _coverage_section(summary)
    lines += [""]

    lines += ["## Stage timings", ""]
    lines += _timing_section(os.path.join(rd.dir, runlog.TRACE_FILE))
    lines += [""]
    return "\n".join(lines)


def report_run(run: Optional[str] = None,
               runs_root: str = runlog.DEFAULT_RUNS_DIR,
               out: Optional[str] = None) -> Dict[str, Any]:
    """Render the report for ``run`` (default: the latest under
    ``runs_root``), write it to ``<run_dir>/report.md`` (and ``out``
    when given), and return {run_id, run_dir, path, markdown}."""
    rd = runlog.load_run(run, runs_root)
    text = render_report(rd)
    path = os.path.join(rd.dir, REPORT_FILE)
    with open(path, "w") as f:
        f.write(text)
    if out:
        d = os.path.dirname(out)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out, "w") as f:
            f.write(text)
        path = out
    return {"run_id": rd.run_id, "run_dir": rd.dir, "path": path,
            "markdown": text}

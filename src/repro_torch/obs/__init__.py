"""``repro_torch.obs`` — stage-level tracing, metrics, optimizer health
and run directories of the port (counterpart of ``repro/obs``).

  * :mod:`~repro_torch.obs.trace` — ``Span``/``Tracer`` on the monotonic
    ``perf_counter`` clock, with fencing (a CUDA synchronise on a span's
    result when asked), nesting, a zero-allocation disabled path, the
    named ZO step stages and counters for probes, axpy sweeps, RNG folds,
    layer selections, active layers, K3/K4 W tiles and z tiles and the
    norm and selective-scan kernels' launches and bypasses on the card;
    with
    ``annotate``, spans and the finer range sites (:data:`RANGES`,
    opened by :func:`prange`) as ``torch.profiler`` ranges.
  * :mod:`~repro_torch.obs.sinks` — in-memory ring buffer + JSONL log.
  * :mod:`~repro_torch.obs.metrics` — Prometheus-style counters, gauges
    and histograms with a text dump.
  * :mod:`~repro_torch.obs.profiler` — optional ``torch.profiler`` region
    behind ``telemetry.profile_dir``.
  * :mod:`~repro_torch.obs.runtime` — ``session(spec.telemetry)``.
  * :mod:`~repro_torch.obs.health` — per-step ZO optimizer vitals,
    buffered each step and drained at ``log_every``.
  * :mod:`~repro_torch.obs.runlog` — ``artifacts/runs/<run_id>/``
    directories in the reference's format, which ``launch report``
    renders and ``launch replay`` re-executes bit for bit.

Emitters call ``obs.get_tracer()`` unconditionally; the default is the
disabled :data:`NULL` tracer, whose operations are free.
"""
from repro_torch.obs.health import HealthAccumulator
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     LATENCY_BUCKETS, Registry)
from repro_torch.obs.profiler import profile
from repro_torch.obs.runlog import (DEFAULT_RUNS_DIR, RunDir, RunLog,
                                    list_runs, load_run, make_run_id,
                                    resolve_run)
from repro_torch.obs.runtime import NULL_SESSION, Session, session
from repro_torch.obs.sinks import (JSONLSink, RingSink, read_jsonl,
                                   spans_from_jsonl)
from repro_torch.obs.trace import (CTR_AXPY, CTR_NORM_KERNEL,
                                   CTR_NORM_PLAIN, CTR_PROBES, CTR_RNG_FOLDS,
                                   CTR_SCAN_KERNEL, CTR_SCAN_PLAIN,
                                   CTR_SELECTS, CTR_WLOAD, CTR_ZREGEN,
                                   FWD_BASE, FWD_MINUS, FWD_PAIR, FWD_PLUS,
                                   GAUGE_ACTIVE, NULL, PERTURB, RANGES,
                                   SERVE_DECODE, SERVE_PREFILL, STAGES, Span,
                                   SpanRecord, TRAIN_STEP, Tracer, UPDATE,
                                   get_tracer, prange, set_tracer, tracing,
                                   use)

__all__ = [
    "CTR_AXPY", "CTR_NORM_KERNEL", "CTR_NORM_PLAIN", "CTR_PROBES",
    "CTR_RNG_FOLDS", "CTR_SCAN_KERNEL", "CTR_SCAN_PLAIN", "CTR_SELECTS",
    "CTR_WLOAD", "CTR_ZREGEN", "Counter",
    "DEFAULT_RUNS_DIR", "FWD_BASE", "FWD_MINUS", "FWD_PAIR", "FWD_PLUS",
    "GAUGE_ACTIVE", "Gauge", "HealthAccumulator", "Histogram", "JSONLSink",
    "LATENCY_BUCKETS", "NULL", "NULL_SESSION", "PERTURB", "RANGES",
    "Registry", "RingSink", "RunDir", "RunLog", "SERVE_DECODE",
    "SERVE_PREFILL", "STAGES", "Session", "Span", "SpanRecord", "TRAIN_STEP",
    "Tracer", "UPDATE", "get_tracer", "list_runs", "load_run", "make_run_id",
    "prange", "profile", "read_jsonl", "resolve_run", "session", "set_tracer",
    "spans_from_jsonl", "tracing", "use",
]

"""Session wiring of the port (counterpart of ``repro/obs/runtime.py``):
one ``telemetry`` spec node -> tracer + sinks + metrics.

A :class:`Session` is the bundle an instrumented run loop (the Trainer)
holds: a :class:`~repro_torch.obs.trace.Tracer` feeding the configured
sinks, a Prometheus-style :class:`~repro_torch.obs.metrics.Registry`,
and the dump/flush policy the ``telemetry`` node asked for.
:func:`session` builds one from an ``api.spec.Telemetry`` node
(duck-typed: obs never imports the spec module).

``NULL_SESSION`` is the disabled bundle: its tracer is the
zero-allocation :data:`~repro_torch.obs.trace.NULL`, ``enabled`` is
False, and ``flush``/``close`` are no-ops, so callers hold a Session
unconditionally and never branch on None.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs import sinks as sinks_mod
from repro_torch.obs import trace as trace_mod


class Session:
    """Tracer + metrics registry + sink lifecycle for one run."""

    def __init__(self, tracer: trace_mod.Tracer,
                 registry: Optional[metrics_mod.Registry] = None,
                 ring: Optional[sinks_mod.RingSink] = None,
                 jsonl: Optional[sinks_mod.JSONLSink] = None,
                 prometheus_path: Optional[str] = None,
                 profile_dir: Optional[str] = None):
        self.tracer = tracer
        self.registry = registry if registry is not None \
            else metrics_mod.Registry()
        self.ring = ring
        self.jsonl = jsonl
        self.prometheus_path = prometheus_path
        self.profile_dir = profile_dir

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled

    def profile(self):
        """Context manager for the optional torch.profiler region."""
        from repro_torch.obs import profiler
        return profiler.profile(self.profile_dir)

    def flush(self):
        """Make the run's telemetry durable: append a counter snapshot
        to the JSONL log, flush it, and (re)write the Prometheus dump.
        Safe to call repeatedly; a no-op when disabled."""
        if not self.enabled:
            return
        if self.jsonl is not None:
            self.jsonl.emit_event(self.tracer.snapshot())
            self.jsonl.flush()
        if self.prometheus_path:
            self.registry.dump(self.prometheus_path)

    def close(self):
        self.flush()
        if self.jsonl is not None:
            self.jsonl.close()


NULL_SESSION = Session(trace_mod.NULL)


def session(telemetry=None) -> Session:
    """Build a Session from an ``api.spec.Telemetry``-shaped node (any
    object with ``enabled``/``ring``/``fence``/``jsonl``/``prometheus``/
    ``profile_dir`` attributes).  ``None`` or ``enabled=False`` returns
    :data:`NULL_SESSION`."""
    if telemetry is None or not getattr(telemetry, "enabled", False):
        return NULL_SESSION
    sinks = []
    ring = None
    ring_cap = getattr(telemetry, "ring", 0)
    if ring_cap and ring_cap > 0:
        ring = sinks_mod.RingSink(ring_cap)
        sinks.append(ring)
    jsonl = None
    jsonl_path = getattr(telemetry, "jsonl", None)
    if jsonl_path:
        jsonl = sinks_mod.JSONLSink(jsonl_path)
        sinks.append(jsonl)
    tracer = trace_mod.Tracer(sinks=sinks,
                              fence=getattr(telemetry, "fence", False))
    return Session(tracer, ring=ring, jsonl=jsonl,
                   prometheus_path=getattr(telemetry, "prometheus", None),
                   profile_dir=getattr(telemetry, "profile_dir", None))

"""Prometheus-style metrics of the port (copy of
``repro/obs/metrics.py``): counters, gauges, histograms and a text dump.

Aggregate metrics for long-lived processes, rendered by
``Registry.to_text()`` in the Prometheus text exposition format, so the
dump a run writes (``telemetry.prometheus``) is scrapeable and diffable
with standard tooling; no client library is imported.

Histograms use fixed cumulative (``le``) buckets like Prometheus
proper: each bucket counts observations ``<= le``, ``+Inf`` always
exists, and ``_sum``/``_count`` ride along.  The default buckets are
latency-shaped (1 ms .. 60 s).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

# 1ms .. 60s, roughly logarithmic — TTFT and request latency both fit.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) < 0")
        self.value += n

    def lines(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Gauge:
    """A value that goes up and down (queue depth, utilization)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def lines(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = LATENCY_BUCKETS):
        self.name, self.help = name, help
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError(f"histogram {name}: empty buckets")
        self.buckets: Tuple[float, ...] = tuple(bs)
        self.counts = [0] * (len(self.buckets) + 1)   # +1 for +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile off the bucket counts (upper edge of the
        bucket holding the q-th observation; inf if it lands in +Inf)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return float("nan")
        target = q * self.count
        seen = 0
        for i, le in enumerate(self.buckets):
            seen += self.counts[i]
            # seen > 0 guards empty leading buckets: with q == 0 (or all
            # observations past this bucket) `seen >= target` is trivially
            # true and would wrongly return the first bucket's edge.
            if seen > 0 and seen >= target:
                return le
        return float("inf")

    def lines(self) -> List[str]:
        out, cum = [], 0
        for i, le in enumerate(self.buckets):
            cum += self.counts[i]
            out.append(f'{self.name}_bucket{{le="{_fmt(le)}"}} {cum}')
        cum += self.counts[-1]
        out.append(f'{self.name}_bucket{{le="+Inf"}} {cum}')
        out.append(f"{self.name}_sum {_fmt(self.sum)}")
        out.append(f"{self.name}_count {self.count}")
        return out


class Registry:
    """Get-or-create metric store with a text exposition dump."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        kw = {} if buckets is None else {"buckets": buckets}
        return self._get(Histogram, name, help, **kw)

    def metrics(self) -> List[object]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    def to_text(self) -> str:
        """Prometheus text exposition format (sorted, deterministic)."""
        out = []
        for m in self.metrics():
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            out.extend(m.lines())
        return "\n".join(out) + ("\n" if out else "")

    def dump(self, path: str):
        import os
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_text())

"""Span sinks of the port (copy of ``repro/obs/sinks.py``): an
in-memory ring buffer and a JSONL event log.

A sink is anything with ``emit(record: SpanRecord)``; a
:class:`~repro_torch.obs.trace.Tracer` fans every finished span out to
all of its sinks.

  * :class:`RingSink` — bounded deque; the live in-process view the
    trainer keeps and ``chip_smoke.py``'s ``trace`` phase reads.  Old
    records fall off the back, so a long run cannot grow without bound.
  * :class:`JSONLSink` — one JSON object per line, append-only; the
    durable trace (``trace.jsonl`` of a run directory).  ``read_jsonl`` is
    the matching loader and drops a torn last line.

The file format is the reference's, so a trace written by either package
reads back in the other.
"""
from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import SpanRecord


class RingSink:
    """Keep the most recent ``capacity`` span records in memory."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._buf: deque = deque(maxlen=capacity)

    def emit(self, rec: SpanRecord):
        self._buf.append(rec)

    def records(self) -> List[SpanRecord]:
        return list(self._buf)

    def spans(self, name: Optional[str] = None) -> List[SpanRecord]:
        if name is None:
            return self.records()
        return [r for r in self._buf if r.name == name]

    def clear(self):
        self._buf.clear()

    def __len__(self):
        return len(self._buf)


class JSONLSink:
    """Append span records (and arbitrary dict events) to a JSONL file.

    The file handle opens lazily on first emit and stays open — one
    ``write`` per record, no per-record open/close.  ``flush``/``close``
    make the tail durable; the sink doubles as a context manager."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def _handle(self):
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a")
        return self._fh

    def emit(self, rec: SpanRecord):
        self._handle().write(json.dumps(rec.to_dict()) + "\n")

    def emit_event(self, event: Dict[str, Any]):
        """Write a non-span event line (e.g. a counter snapshot)."""
        self._handle().write(json.dumps(event) + "\n")

    def flush(self):
        if self._fh is not None:
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load every event from a JSONL trace (blank lines skipped).

    A truncated *final* line — the writer crashed mid-append — is
    silently dropped; corruption anywhere else still raises, since that
    indicates real damage rather than an interrupted tail write."""
    out = []
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    last = max((i for i, ln in enumerate(lines) if ln), default=-1)
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError:
            if i == last:
                break
            raise
    return out


def spans_from_jsonl(path: str) -> List[SpanRecord]:
    """Reconstruct the ``SpanRecord``s from a JSONL trace — the inverse
    of ``JSONLSink.emit`` for ``type == "span"`` lines."""
    out = []
    for ev in read_jsonl(path):
        if ev.get("type") == "span":
            out.append(SpanRecord(
                name=ev["name"], t0=ev["t0"], dt=ev["dt"],
                depth=ev["depth"], index=ev["index"], parent=ev["parent"],
                meta=ev.get("meta")))
    return out

"""Deterministic fault injection for the swarm transport (DESIGN.md §14),
a copy of ``repro/swarm/chaos.py`` (stdlib): the same schedules.

Straggler-timeout, worker-death and partition-recovery paths are the
hard-to-hit 1% of a distributed trainer; this module makes them the
repeatable 100%.  Every decision (drop this message? delay it how long?
die here?) is a pure hash of ``(chaos_seed, worker, kind, step,
attempt)`` — two runs with the same spec inject byte-identical fault
schedules, so a chaos run is as replayable as a clean one.

Faults are applied at the *worker's* edge of the transport (the
coordinator stays honest — a lying coordinator is a different failure
model than the quorum machinery defends against):

* ``drop``      — an outgoing contribution or incoming commit vanishes.
* ``delay``     — a message is held up to ``delay_ms`` before sending.
* ``crash``     — ``worker:step`` hard-exits (``os._exit``) at the top
                  of that step, before contributing: the reader-side EOF
                  is the coordinator's death signal.
* ``partition`` — ``worker:start-end`` (inclusive) drops *everything*
                  in the window, both directions; the worker recovers
                  through the fetch/resync path afterwards.

Resends pass a fresh ``attempt`` counter into the hash, so a dropped
message is not dropped identically forever — schedules with
``drop < 1`` always make progress.  Stdlib-only: imported by
``api.validate`` to parse the schedules.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

_M = 0xFFFFFFFF
# exit code for an injected crash — distinguishable from real tracebacks
CRASH_EXIT = 43


def _mix(x: int) -> int:
    """Murmur3-style 32-bit avalanche (python-int twin of rng.mix32)."""
    x &= _M
    x ^= x >> 16
    x = (x * 0x7FEB352D) & _M
    x ^= x >> 15
    x = (x * 0x846CA68B) & _M
    x ^= x >> 16
    return x


def _hash01(seed: int, worker: int, kind: str, step: int, attempt: int) -> float:
    """Deterministic uniform in [0, 1) for one fault decision."""
    h = _mix(seed ^ 0x5EEDFA17)
    for part in (worker, step, attempt, len(kind)):
        h = _mix(h * 0x9E3779B9 + (part & _M))
    for ch in kind.encode():
        h = _mix(h ^ ch)
    return h / 4294967296.0


def parse_crashes(text: str) -> Tuple[Tuple[int, int], ...]:
    """``"worker:step[,worker:step...]"`` -> ((worker, step), ...)."""
    out = []
    for item in filter(None, (s.strip() for s in (text or "").split(","))):
        try:
            w, s = item.split(":")
            w, s = int(w), int(s)
        except ValueError:
            raise ValueError(
                f"expected 'worker:step[,...]' with integer fields, "
                f"got {item!r}") from None
        if w < 0 or s < 0:
            raise ValueError(f"worker and step must be >= 0, got {item!r}")
        out.append((w, s))
    return tuple(out)


def parse_partitions(text: str) -> Tuple[Tuple[int, int, int], ...]:
    """``"worker:start-end[,...]"`` -> ((worker, start, end), ...);
    the window is inclusive on both ends."""
    out = []
    for item in filter(None, (s.strip() for s in (text or "").split(","))):
        try:
            w, span = item.split(":")
            start, end = span.split("-")
            w, start, end = int(w), int(start), int(end)
        except ValueError:
            raise ValueError(
                f"expected 'worker:start-end[,...]' with integer fields, "
                f"got {item!r}") from None
        if w < 0 or start < 0 or end < start:
            raise ValueError(
                f"need worker >= 0 and 0 <= start <= end, got {item!r}")
        out.append((w, start, end))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Parsed, hashable form of the spec's ``swarm.chaos_*`` fields."""
    seed: int = 0
    drop: float = 0.0
    delay_ms: float = 0.0
    crashes: Tuple[Tuple[int, int], ...] = ()
    partitions: Tuple[Tuple[int, int, int], ...] = ()

    @classmethod
    def from_spec(cls, sw) -> "ChaosConfig":
        return cls(seed=sw.chaos_seed, drop=sw.chaos_drop,
                   delay_ms=sw.chaos_delay_ms,
                   crashes=parse_crashes(sw.chaos_crash),
                   partitions=parse_partitions(sw.chaos_partition))

    @property
    def enabled(self) -> bool:
        return bool(self.drop or self.delay_ms or self.crashes
                    or self.partitions)


class Chaos:
    """One worker's view of the fault schedule.

    ``worker_id`` is the coordinator-assigned id; a respawned worker
    gets a fresh id, so a ``crash`` entry fires exactly once per id.
    """

    def __init__(self, cfg: ChaosConfig, worker_id: int):
        self.cfg = cfg
        self.wid = worker_id

    def partitioned(self, step: int) -> bool:
        return any(w == self.wid and start <= step <= end
                   for w, start, end in self.cfg.partitions)

    def drop(self, kind: str, step: int, attempt: int = 0) -> bool:
        """Drop this message?  Partition windows drop unconditionally."""
        if self.partitioned(step):
            return True
        if self.cfg.drop <= 0.0:
            return False
        return _hash01(self.cfg.seed, self.wid, kind, step,
                       attempt) < self.cfg.drop

    def delay_s(self, kind: str, step: int, attempt: int = 0) -> float:
        if self.cfg.delay_ms <= 0.0:
            return 0.0
        u = _hash01(self.cfg.seed, self.wid, "delay:" + kind, step, attempt)
        return u * self.cfg.delay_ms / 1000.0

    def sleep(self, kind: str, step: int, attempt: int = 0) -> None:
        d = self.delay_s(kind, step, attempt)
        if d > 0.0:
            time.sleep(d)

    def crash_point(self, step: int) -> bool:
        return (self.wid, step) in self.cfg.crashes

    def maybe_crash(self, step: int) -> None:
        """Hard-exit at an injected ``worker:step`` crash point.

        ``os._exit`` (not ``sys.exit``): no atexit, no flushing, no
        socket shutdown handshake — the closest a test harness gets to
        a host losing power.
        """
        if self.crash_point(step):
            os._exit(CRASH_EXIT)

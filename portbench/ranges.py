"""Device time and idle gaps charged to the program's profiler ranges.

``repro_torch.obs.Tracer(annotate=True)`` opens a ``torch.profiler``
range for each span (the ZO stages) and at each finer site (``zo/step``,
``zo/select``, ``zo/readback``, the model's sublayers, the hand-written
kernels' launches: ``obs.RANGES``).  Given a profiled window of such a
tracer, with the host's events, this module charges

- each device record (kernel, copy, fill) to the ranges open on the host
  when the CUDA runtime call that issued it ran (the call and the record
  share the profiler's correlation id): its *chain*, innermost first, so
  a range's device time includes its nested ranges';
- each idle gap between device records to the chain open on the host at
  the gap's middle; a gap with none is ``outside``;

and reads the four metrics of :data:`METRICS` and the coverage from the
result.  No cell runs it yet: the window's records and host events come
from ``window.measure``'s loop under an annotating tracer.
"""
from __future__ import annotations

import bisect
import collections

OUTSIDE = ()                 # the chain of a gap no range encloses
TOP = 10
# the program's names (``repro_torch.obs.trace``), copied so that reading
# a window needs no import of the program
FORWARDS = ("forward+eps_z", "forward-eps_z", "forward_pair")
ZO_STEP = "zo/step"
NORM_HEAD = ("model/norm", "model/head_ce")
MOE_GLUE = ("model/moe/route", "model/moe/dispatch", "model/moe/combine")


class Ranges:
    """The program ranges of one host thread, properly nested:
    (start, end, name) in any order.  ``chain(t)`` is the tuple of the
    names of the ranges open at host time ``t``, innermost first."""

    def __init__(self, ranges):
        rs = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in rs]
        self.ends = [r[1] for r in rs]
        self.names = [r[2] for r in rs]
        self.parent, open_ = [], []
        for i, (s, e, _) in enumerate(rs):
            while open_ and self.ends[open_[-1]] <= s:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def chain(self, t):
        # the innermost range holding t is the last one to start at or
        # before t, or the first of its ancestors that has not ended
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.names[i])
            i = self.parent[i]
        return tuple(out)


def charge(records, launches, ranges):
    """``records`` [(start, end, correlation)] of the device between the
    window's markers, ``launches`` {correlation: host time of the runtime
    call}, ``ranges`` a :class:`Ranges`; times in µs.  Returns
    {"busy", "idle" (s), "device", "gaps" ({chain: s}), "unmatched"
    (records whose call was not found, charged to no chain)}."""
    device, gaps = collections.defaultdict(float), collections.defaultdict(
        float)
    unmatched, busy, idle = 0, 0.0, 0.0
    records = sorted(records)
    for s, e, corr in records:
        busy += (e - s) / 1e6
        t = launches.get(corr)
        if t is None:
            unmatched += 1
            continue
        device[ranges.chain(t)] += (e - s) / 1e6
    end = records[0][1] if records else 0.0
    for s, e, _ in records[1:]:
        if s > end:
            gaps[ranges.chain((s + end) / 2)] += (s - end) / 1e6
            idle += (s - end) / 1e6
        end = max(end, e)
    return {"busy": busy, "idle": idle, "device": dict(device),
            "gaps": dict(gaps), "unmatched": unmatched}


def _sum(by_chain, keep):
    return sum(v for c, v in by_chain.items() if keep(c))


def _ms(r, by, keep):
    """Milliseconds a step of ``r[by]`` over the chains ``keep`` takes, or
    None where no chain is taken."""
    if not any(keep(c) for c in r[by]):
        return None
    return 1e3 * _sum(r[by], keep) / r["steps"]


def norm_head_ms(r):
    """Device ms a step in the norms and the CE head: the float32 glue."""
    return _ms(r, "device", lambda c: any(n in c for n in NORM_HEAD))


def moe_glue_ms(r):
    """Device ms a step in MoE routing, dispatch and combine (the expert
    products left out); None on a model without MoE blocks."""
    return _ms(r, "device", lambda c: any(n in c for n in MOE_GLUE))


def zo_host_idle_ms(r):
    """Idle ms a step with the host in the ZO step but in no forward:
    selection, readback, the perturb and update launches."""
    return _ms(r, "gaps", lambda c: ZO_STEP in c
               and not any(n in c for n in FORWARDS))


def model_host_idle_ms(r):
    """Idle ms a step with the host inside a probe's forward."""
    return _ms(r, "gaps", lambda c: any(n in c for n in FORWARDS))


METRICS = {"model.norm_head_ms": norm_head_ms,
           "model.moe_glue_ms": moe_glue_ms,
           "zo.host_idle_ms": zo_host_idle_ms,
           "model.host_idle_ms": model_host_idle_ms}


def coverage(r):
    """{"in_step": share of device time charged inside ``zo/step``,
    "idle_outside": share of idle time charged to no range}."""
    return {"in_step": _sum(r["device"], lambda c: ZO_STEP in c)
            / r["busy"] if r["busy"] else None,
            "idle_outside": r["gaps"].get(OUTSIDE, 0.0) / r["idle"]
            if r["idle"] else None}


def top_gaps(r, n=TOP):
    """[[innermost range or "outside", seconds]] of the idle gaps,
    longest first."""
    by = collections.defaultdict(float)
    for c, v in r["gaps"].items():
        by[c[0] if c else "outside"] += v
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])][:n]


def by_range(r, by):
    """{range: seconds} of ``r[by]``, each range inclusive of its nested
    ranges; ``outside`` for the chain of none."""
    out = collections.defaultdict(float)
    for c, v in r[by].items():
        for name in set(c) or ("outside",):
            out[name] += v
    return dict(out)

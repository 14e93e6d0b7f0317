"""A profiled window whose records are whole: the benchmark's copy of the
window design of ``chip_smoke.py::measure_window``.

``torch.profiler`` can lose the first records of a window and the last
ones of a long window.  So fills of a 16 MiB buffer open and close the
window (records it may lose), the device idles ``PAD`` seconds before
it closes, a marker kernel (``torch.cuda._sleep``, named ``MARK`` in the
trace) opens every step and one more ends the last, and the records
between the markers must be whole: each step holds each kernel name as
often as the others, and the records of the kernels that count their own
launches equal those counts.  A window that lost records is measured
once more, then the run fails.
"""
from __future__ import annotations

import bisect
import collections
import time

EDGE, EDGE_BYTES = 1024, 16 << 20
PAD = 0.05
TRIES = 2
MARK = "spin_kernel"
MARK_CYCLES = 1000
TOP = 10


class WindowLost(RuntimeError):
    """A profiled window whose records are not whole."""


def _edge(buf):
    import torch
    for _ in range(EDGE):
        buf.zero_()
    torch.cuda.synchronize()


def _device_record(e):
    return (str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False))


def split_steps(names, steps):
    """Record names in start order, split at the markers into the
    ``steps`` steps they open; raises unless there are ``steps`` + 1
    markers."""
    cuts = [i for i, n in enumerate(names) if MARK in n]
    if len(cuts) != steps + 1:
        raise WindowLost(f"window: {len(cuts)} markers for {steps} steps: "
                         "the profiler lost records")
    return [names[a + 1:b] for a, b in zip(cuts, cuts[1:])]


def check_whole(per_step, launched):
    """Raise unless every step holds each kernel name as often as the
    others, and the records of each name of ``launched`` ({trace name
    part: launches the kernels counted}) equal its launches."""
    counts = [collections.Counter(s) for s in per_step]
    for name in set().union(*counts):
        got = [c[name] for c in counts]
        if len(set(got)) > 1:
            raise WindowLost(f"window: {name[:80]} recorded {got} times by "
                             "step: the profiler lost records")
    for key, n in launched.items():
        seen = sum(c[name] for c in counts for name in c if key in name)
        if seen != n:
            raise WindowLost(f"window: {seen} records of {key} against {n} "
                             "launches counted: the profiler lost records")


def _idle_gaps(dev, cpu):
    """Device idle time between the records ``dev`` [(start, end)] in µs,
    by the innermost host op running at each gap's middle (``cpu``
    [(start, end, name)], the CUDA runtime's calls left out, so a gap
    while the host launches is named by the op that launches):
    [[name, seconds]], longest first."""
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    by = collections.defaultdict(float)
    end = dev[0][1]
    for s, e in dev[1:]:
        if s > end:
            mid = (s + end) / 2
            name = "host outside any op"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - 400), -1):
                if cpu[j][1] >= mid:
                    name = cpu[j][2]
                    break
            by[name] += (s - end) / 1e6
        end = max(end, e)
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])][:TOP]


def measure(step, steps, counters, kernels, cpu=False, warm=1):
    """``step(i)`` for ``i`` in range(warm + steps): ``warm`` calls,
    then ``steps`` in one profiled window (one more window of ``steps``
    if the first lost records); ``cpu`` adds the host's ops, which slow
    the host, to name the device's idle gaps by.
    ``counters`` () -> {trace name part: launches so far}, read from the
    program's own launch counters; ``kernels`` names the parts.  Returns
    {"busy", "wall", "steps", "first" (the ``i`` of the first step
    recorded), "kernels" (a step), "by_name" {name: (s, count)},
    "device_ops", "idle_gaps"}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    buf = torch.empty(EDGE_BYTES // 4, device="cuda")
    for k in range(warm):
        step(k)
    torch.cuda.synchronize()
    k = warm
    for attempt in range(TRIES):
        walls, first = [], k
        with profile(activities=acts) as prof:
            _edge(buf)
            before = counters()
            for k in range(k, k + steps):
                t = time.perf_counter()
                torch.cuda._sleep(MARK_CYCLES)
                step(k)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            torch.cuda._sleep(MARK_CYCLES)
            _edge(buf)
            time.sleep(PAD)
        k += 1
        after = counters()
        launched = {n: after[n] - before[n] for n in kernels}
        events = list(prof.events())
        evs = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in events if _device_record(e))
        try:
            check_whole(split_steps([n for _, _, n in evs], steps), launched)
            break
        except WindowLost:
            if attempt + 1 == TRIES:
                raise
    marks = [i for i, (_, _, n) in enumerate(evs) if MARK in n]
    inside = [r for r in evs[marks[0] + 1:marks[-1]] if MARK not in r[2]]
    by_name = {}
    for s, e, n in inside:
        a, c = by_name.get(n, (0.0, 0))
        by_name[n] = (a + (e - s) / 1e6, c + 1)
    busy = sum(a for a, _ in by_name.values())
    if busy <= 0:
        raise WindowLost("window: no device time between the markers")
    lo, hi = evs[marks[0]][1], evs[marks[-1]][0]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if not _device_record(e) and not e.name.startswith("cuda")
            and e.time_range.end >= lo and e.time_range.start <= hi]
    return {"busy": busy, "wall": sum(walls), "steps": steps, "first": first,
            "kernels": len(inside) / steps, "by_name": by_name,
            "device_ops": [[short(n), v[0]] for n, v in sorted(
                by_name.items(), key=lambda kv: -kv[1][0])][:TOP],
            "idle_gaps": _idle_gaps([(s, e) for s, e, _ in inside],
                                    host) if cpu else []}


def short(name: str) -> str:
    """A kernel's name without its return type, arguments and template
    arguments past the first level: ``at::native::elementwise_kernel``,
    ``zo_axpy_2d_kernel<__nv_bfloat16>``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    out, depth = [], 0
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        if depth <= 1:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out)[:120]

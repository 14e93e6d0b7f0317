"""Span/Tracer core of the port (counterpart of ``repro/obs/trace.py``):
stage-level step tracing for every hot path.

A :class:`Tracer` records nestable :class:`SpanRecord`s on the monotonic
``perf_counter`` clock, with explicit *fencing* (``Span.fence``) so the
card's asynchronous launches cannot hide where time went, plus named
counters and gauges for structural facts (probes evaluated, axpy sweeps,
RNG folds, active layers under LeZO sparsity, W tiles loaded and z tiles
drawn by kernels K3/K4).

Three rules keep the hot paths honest, as in the reference:

  * **Disabled means free.**  The default tracer is :data:`NULL`, whose
    ``span``/``count``/``gauge`` are no-ops; ``span`` returns one shared
    singleton, so nothing is allocated per call.  Instrumented code calls
    ``get_tracer()`` unconditionally.
  * **Never record inside a compiled region.**  ``tracing()`` is
    ``torch.compiler.is_compiling()``: a span timed while ``torch.compile``
    traces would record trace time.  The port compiles nothing today, so
    it is False on every path; the check stays so spans never record
    there.
  * **Fence when asked.**  ``Tracer(fence=True)`` makes a span whose
    result was set with ``Span.fence`` synchronise the result's CUDA
    device before the clock stops (nothing for a CPU result); with
    ``fence=False`` the same call is free and launches stay
    asynchronous.

The stage and counter names are the reference's strings, so tools that
read either package's traces join on them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

# ------------------------------------------------------- stage taxonomy
# `perturb` appears twice per materialized two-point step (+eps, -2eps)
# and zero times under the virtual forward backend (repro_torch.fused).
PERTURB = "perturb"
FWD_PLUS = "forward+εz"
FWD_MINUS = "forward-εz"
FWD_PAIR = "forward_pair"     # one paired ±εz forward (stacked probes)
FWD_BASE = "forward"          # one_sided's unperturbed baseline forward
UPDATE = "update_axpy"
TRAIN_STEP = "train/step"     # the trainer's whole-step record
SERVE_PREFILL = "serve/prefill"
SERVE_DECODE = "serve/decode"
STAGES: Tuple[str, ...] = (PERTURB, FWD_PLUS, FWD_MINUS, FWD_PAIR, UPDATE)

# Counter names (structural per-run facts, deterministic under a seed).
CTR_PROBES = "probes_evaluated"
CTR_AXPY = "axpy_sweeps"
CTR_RNG_FOLDS = "rng_folds"
CTR_SELECTS = "layer_selections"
# Virtual-forward W traffic (repro_torch.fused): W tiles the K3/K4 grid
# loads into shared memory and z tiles it draws, counted on the host from
# the tiling csrc/pmatmul.cu launches (fused.matmul.tile_counts), so the
# kernels and their plain versions report the same dataflow.
CTR_WLOAD = "w_tile_loads"
CTR_ZREGEN = "z_regens"
GAUGE_ACTIVE = "active_layers"


def tracing() -> bool:
    """True while ``torch.compile`` traces: spans and counters must not
    record then.  Public so sites that must make a host value (a gauge)
    can skip the whole block."""
    return torch.compiler.is_compiling()


_tracing = tracing


@dataclasses.dataclass
class SpanRecord:
    """One finished span.  ``index`` is the span's entry sequence number;
    ``parent`` the entry index of the enclosing span (-1 at top level);
    ``depth`` the nesting level."""
    name: str
    t0: float
    dt: float
    depth: int
    index: int
    parent: int
    meta: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"type": "span", "name": self.name, "t0": self.t0,
             "dt": self.dt, "depth": self.depth, "index": self.index,
             "parent": self.parent}
        if self.meta:
            d["meta"] = self.meta
        return d


def _sync_cuda(result):
    """Synchronise the CUDA device of the first CUDA tensor found in
    ``result`` (a tensor, a module's parameters, or a list/tuple/dict of
    them); CPU results and host values need nothing."""
    stack = [result]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, torch.nn.Module):
            stack.extend(x.parameters())
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


class Span:
    """A live span; use as a context manager.  ``fence(x)`` marks ``x``
    as the span's result: when the owning tracer fences, the clock stops
    only after ``x``'s device has finished."""

    __slots__ = ("_tracer", "name", "meta", "_t0", "_result", "_entry")

    def __init__(self, tracer: "Tracer", name: str,
                 meta: Optional[Dict[str, Any]] = None):
        self._tracer = tracer
        self.name = name
        self.meta = meta
        self._result = None

    def fence(self, result):
        self._result = result
        return result

    def __enter__(self) -> "Span":
        self._entry = self._tracer._enter()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._tracer.fence and self._result is not None:
            _sync_cuda(self._result)
        dt = time.perf_counter() - self._t0
        self._tracer._exit(self, dt)
        self._result = None
        return False


class _NullSpan:
    """The shared do-nothing span: one instance for the whole process."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def fence(self, result):
        return result


_NULL_SPAN = _NullSpan()


class Tracer:
    """Records spans and counters into pluggable sinks (``obs.sinks``).

    ``sinks``: objects with ``emit(record: SpanRecord)``.
    ``fence``: synchronise each span's fenced result before the clock
    stops (true stage timings; off for steady-state pipelines).
    """

    enabled = True

    def __init__(self, sinks=(), fence: bool = False):
        self.sinks = list(sinks)
        self.fence = fence
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, float] = {}
        self._depth = 0
        self._index = 0
        self._stack: List[int] = []   # entry indices of open spans

    # ------------------------------------------------------------ spans
    def span(self, name: str, meta: Optional[Dict[str, Any]] = None):
        if _tracing():
            return _NULL_SPAN
        return Span(self, name, meta)

    def _enter(self) -> int:
        entry = self._index
        self._index += 1
        self._stack.append(entry)
        self._depth += 1
        return entry

    def _exit(self, span: Span, dt: float):
        self._depth -= 1
        self._stack.pop()
        parent = self._stack[-1] if self._stack else -1
        rec = SpanRecord(name=span.name, t0=span._t0, dt=dt,
                         depth=self._depth, index=span._entry,
                         parent=parent, meta=span.meta)
        for s in self.sinks:
            s.emit(rec)

    # --------------------------------------------------------- counters
    def count(self, name: str, n: int = 1):
        if _tracing():
            return
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value):
        if _tracing():
            return
        self.gauges[name] = value

    def snapshot(self) -> Dict[str, Any]:
        """Counters + gauges as one JSON-ready event."""
        return {"type": "counters", "counters": dict(self.counters),
                "gauges": dict(self.gauges)}

    def reset(self):
        self.counters.clear()
        self.gauges.clear()


class NullTracer(Tracer):
    """The disabled tracer: every operation is a no-op and ``span``
    returns the process-wide :data:`_NULL_SPAN` singleton."""

    enabled = False

    def __init__(self):
        super().__init__(sinks=(), fence=False)

    def span(self, name: str, meta=None):
        return _NULL_SPAN

    def count(self, name: str, n: int = 1):
        pass

    def gauge(self, name: str, value):
        pass


NULL = NullTracer()
_CURRENT: Tracer = NULL


def get_tracer() -> Tracer:
    return _CURRENT


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` (None -> NULL) globally; returns the previous
    one so callers can restore it."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer if tracer is not None else NULL
    return prev


class use:
    """``with obs.use(tracer): ...`` — scope the global tracer."""

    def __init__(self, tracer: Optional[Tracer]):
        self._tracer = tracer

    def __enter__(self) -> Tracer:
        self._prev = set_tracer(self._tracer)
        return _CURRENT

    def __exit__(self, exc_type, exc, tb):
        set_tracer(self._prev)
        return False

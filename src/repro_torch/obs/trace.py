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

``Tracer(annotate=True)`` also puts the program's structure into a
``torch.profiler`` trace: while a profiler records, every span opens a
profiler range of its name (:func:`range_name`: ``ε`` spelt out), and
:meth:`Tracer.range` opens one at the finer sites below the stages
(the ZO step's host work, the model's sublayers, the hand-written
kernels' launches), so device records and idle gaps share the
profiler's clock with the code that caused them.  ``range`` records
nothing into the sinks, and with no profiler recording (one module
flag read) or on any other tracer it is the shared do-nothing span.
The sites call :func:`prange`, which reads one module flag and goes no
further unless the installed tracer annotates.

The stage and counter names are the reference's strings, so tools that
read either package's traces join on them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

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
# Norm calls on the card (kernels.norm): launches of the norm kernel, and
# calls on CUDA tensors that ran the plain float32 ops instead.
CTR_NORM_KERNEL = "norm_kernel_calls"
CTR_NORM_PLAIN = "norm_plain_calls"
# Mamba scans on the card (kernels.mamba_scan): launches of the
# selective-scan kernel, and train/prefill scans on CUDA tensors that ran
# the plain ops instead.
CTR_SCAN_KERNEL = "scan_kernel_calls"
CTR_SCAN_PLAIN = "scan_plain_calls"
GAUGE_ACTIVE = "active_layers"

# Profiler range names (``Tracer.range``), by the site that opens each.
ZO_STEP = "zo/step"                 # estimators.make_step's step, whole
ZO_SELECT = "zo/select"             # Estimator.select: the layer draw
ZO_READBACK = "zo/readback"         # estimators.base.host_f32's .item()
MODEL_EMBED = "model/embed"         # models.lm: token (+ position) rows
MODEL_ATTN = "model/attn"           # models.lm._run_block: attn, MLA
MODEL_RECURRENT = "model/recurrent"  # models.lm._run_block: Mamba, xLSTM
MODEL_FFN = "model/ffn"             # models.lm._run_block: dense FFN
MAMBA_SCAN = "model/mamba/scan"     # models.ssm.mamba_fwd: the scan, gated
MOE_ROUTE = "model/moe/route"       # models.moe: router, softmax, aux
MOE_DISPATCH = "model/moe/dispatch"  # sort, gather, scatter into slots
MOE_EXPERTS = "model/moe/experts"   # expert and shared-expert products
MOE_COMBINE = "model/moe/combine"   # each token's k terms summed
MODEL_NORM = "model/norm"           # models.layers.rms_norm, layer_norm
MODEL_HEAD_CE = "model/head_ce"     # models.lm.chunked_ce, one a probe
KERNEL_K1 = "kernel/zo_axpy_2d"     # kernels.zo_axpy.zo_axpy_2d_
KERNEL_K2 = "kernel/flash_attention"  # kernels.flash_attn.flash_attention
KERNEL_K34 = "kernel/pmatmul"       # fused.matmul.pmatmul(_stack)
KERNEL_NORM = "kernel/norm"         # kernels.norm.layer_norm, rms_norm
RANGES: Tuple[str, ...] = (
    ZO_STEP, ZO_SELECT, ZO_READBACK, MODEL_EMBED, MODEL_ATTN,
    MODEL_RECURRENT, MODEL_FFN, MAMBA_SCAN, MOE_ROUTE, MOE_DISPATCH,
    MOE_EXPERTS, MOE_COMBINE, MODEL_NORM, MODEL_HEAD_CE, KERNEL_K1,
    KERNEL_K2, KERNEL_K34, KERNEL_NORM)

# The profiler's Chrome trace drops a name outside ASCII: a span opens a
# range of its own name, but the probe forwards' ranges spell ε out.
_SPAN_RANGE = {FWD_PLUS: "forward+eps_z", FWD_MINUS: "forward-eps_z"}


def range_name(span: str) -> str:
    """The name of the profiler range span ``span`` opens."""
    return _SPAN_RANGE.get(span, span)


# One profiler range as a context manager: the C++ RecordFunction, several
# times cheaper under a profiler than ``record_function``'s Python path.
_RANGE = torch._C._profiler._RecordFunctionFast


def tracing() -> bool:
    """True while ``torch.compile`` traces: spans and counters must not
    record then.  Public so sites that must make a host value (a gauge)
    can skip the whole block."""
    return torch.compiler.is_compiling()


_tracing = tracing


def _profiling() -> bool:
    """True while a ``torch.profiler`` records (a module flag: free)."""
    return _autograd_profiler._is_profiler_enabled


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

    __slots__ = ("_tracer", "name", "meta", "_t0", "_result", "_entry",
                 "_range")

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
        self._range = None
        if self._tracer.annotate and _profiling():
            self._range = _RANGE(range_name(self.name))
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._tracer.fence and self._result is not None:
            _sync_cuda(self._result)
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
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
    ``annotate``: while a ``torch.profiler`` records, open a profiler
    range for every span and at every :meth:`range` site.
    """

    enabled = True

    def __init__(self, sinks=(), fence: bool = False,
                 annotate: bool = False):
        self.sinks = list(sinks)
        self.fence = fence
        self.annotate = annotate
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

    def range(self, name: str):
        """A profiler range ``name`` (one of :data:`RANGES`) around a
        fine-grained site, recorded only by an annotating tracer while a
        profiler records; it emits no :class:`SpanRecord`.  Otherwise
        the shared do-nothing span."""
        if not self.annotate or not _profiling() or _tracing():
            return _NULL_SPAN
        return _RANGE(name)

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

    def range(self, name: str):
        return _NULL_SPAN

    def count(self, name: str, n: int = 1):
        pass

    def gauge(self, name: str, value):
        pass


NULL = NullTracer()
_CURRENT: Tracer = NULL


_annotating = False        # the installed tracer annotates


def get_tracer() -> Tracer:
    return _CURRENT


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` (None -> NULL) globally; returns the previous
    one so callers can restore it.  Its ``annotate`` is read here."""
    global _CURRENT, _annotating
    prev = _CURRENT
    _CURRENT = tracer if tracer is not None else NULL
    _annotating = _CURRENT.annotate
    return prev


def prange(name: str):
    """The installed tracer's :meth:`Tracer.range` ``name``: what the
    program's range sites open.  Unless that tracer annotates, the
    shared do-nothing span after one module flag read."""
    if _annotating:
        return _CURRENT.range(name)
    return _NULL_SPAN


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

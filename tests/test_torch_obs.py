"""The port's telemetry (``repro_torch.obs``), a port of
``tests/test_obs.py`` without its serving and benchmark cases, held
against the JAX package where both compute the same thing.

Covers the tracing core (span nesting and parents, the zero-allocation
disabled path, suppression inside a compiled region, fencing), the sinks
(JSONL round trip, torn last line, ring bounds), the Prometheus-style
metrics, the telemetry spec node's validation, the session and the
profiler region, and the instrumented step: span names, nesting and
parents of one eager step and its counters equal the reference's, the
paired forward halves the W tiles the kernels load, the counters follow
the kernels' grid, and ``tree_z_norm`` equals the reference's.  The
annotating tracer's profiler ranges (``Tracer(annotate=True)``,
``Tracer.range``) are the port's alone: their names, nesting and counts
a step, and that they change neither the span stream nor a bit of the
step.

``rng_folds`` equals the reference's for the materialized step and
differs by design under virtual forwards: the reference counts a fold
only when jax runs it eagerly (the per-layer folds of the virtual
matmuls run inside its layer scan, traced, and are not counted), while
every fold of the port runs on the host and counts, so the port's count
is larger there (``test_eager_step_matches_reference``; PERF.md §3).
"""
import contextlib
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import estimators as jest
from repro import obs as jobs
from repro.configs import opt as jopt
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro_torch import api as tapi
from repro_torch import estimators as test_mod
from repro_torch import configs as tconfigs
from repro_torch import fused, obs
from repro_torch.configs import opt as topt
from repro_torch.core import zo as tzo
from repro_torch.fused import matmul as fmm
from repro_torch.models import lm as tlm

torch.set_num_threads(2)              # six xdist workers share the CPUs


# ------------------------------------------------------------ span core
def test_span_nesting_ordering_and_parents():
    ring = obs.RingSink()
    tr = obs.Tracer(sinks=[ring])
    with tr.span("outer"):
        with tr.span("inner_a"):
            pass
        with tr.span("inner_b"):
            pass
    recs = ring.records()
    assert [r.name for r in recs] == ["inner_a", "inner_b", "outer"]
    outer = recs[-1]
    assert outer.depth == 0 and outer.parent == -1
    for child in recs[:2]:
        assert child.depth == 1
        assert child.parent == outer.index
    assert recs[0].index < recs[1].index
    assert all(r.dt >= 0 for r in recs)


def test_null_tracer_is_shared_singleton_and_free():
    assert obs.get_tracer() is obs.NULL       # default: disabled
    s1 = obs.NULL.span("anything")
    s2 = obs.NULL.span("else", meta={"k": 1})
    assert s1 is s2                           # zero-allocation fast path
    with s1 as s:
        assert s.fence("x") == "x"
    obs.NULL.count("c", 5)
    obs.NULL.gauge("g", 1.0)
    assert obs.NULL.counters == {} and obs.NULL.gauges == {}
    assert not obs.NULL.enabled


def test_use_scopes_global_tracer():
    tr = obs.Tracer()
    with obs.use(tr):
        assert obs.get_tracer() is tr
        with obs.use(None):
            assert obs.get_tracer() is obs.NULL
        assert obs.get_tracer() is tr
    assert obs.get_tracer() is obs.NULL


def test_ring_sink_bounded():
    ring = obs.RingSink(capacity=3)
    tr = obs.Tracer(sinks=[ring])
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert len(ring) == 3
    assert [r.name for r in ring.records()] == ["s7", "s8", "s9"]
    with pytest.raises(ValueError, match="capacity"):
        obs.RingSink(capacity=0)


def test_fencing_on_cpu_results():
    """A fenced CPU tensor needs no synchronise; the span still times."""
    ring = obs.RingSink()
    tr = obs.Tracer(sinks=[ring], fence=True)
    with tr.span("fenced") as sp:
        out = sp.fence(torch.ones((64, 64)) @ torch.ones((64, 64)))
    assert out[0, 0].item() == 64.0
    assert ring.spans("fenced")[0].dt > 0


def test_spans_and_counters_suppressed_in_compiled_region(monkeypatch):
    """The reference suppresses under jit tracing; the port under
    ``torch.compiler.is_compiling()``."""
    ring = obs.RingSink()
    tr = obs.Tracer(sinks=[ring])
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert obs.tracing()
    with tr.span("x"):
        tr.count("c")
        tr.gauge("g", 1)
    assert len(ring) == 0 and tr.counters == {} and tr.gauges == {}
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    with tr.span("x"):
        tr.count("c")
    assert len(ring) == 1 and tr.counters == {"c": 1}


# ----------------------------------------------------------- JSONL sink
def test_jsonl_roundtrip(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    sink = obs.JSONLSink(path)
    tr = obs.Tracer(sinks=[sink])
    with tr.span("a", meta={"k": 1}):
        with tr.span("b"):
            pass
    tr.count("probes", 3)
    sink.emit_event(tr.snapshot())
    sink.close()

    events = obs.read_jsonl(path)
    assert [e["type"] for e in events] == ["span", "span", "counters"]
    assert events[-1]["counters"] == {"probes": 3}
    back = obs.spans_from_jsonl(path)
    assert [r.name for r in back] == ["b", "a"]
    assert back[1].meta == {"k": 1}
    for rec, ev in zip(back, [e for e in events if e["type"] == "span"]):
        assert rec.to_dict() == ev
    # the reference reads the port's trace back to the same records
    assert [r.to_dict() for r in jobs.spans_from_jsonl(path)] == \
        [r.to_dict() for r in back]


def test_read_jsonl_tolerates_truncated_final_line(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"type": "span", "name": "a"}) + "\n")
        f.write('{"type": "span", "na')        # torn mid-append
    assert [e["name"] for e in obs.read_jsonl(path)] == ["a"]
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write('{"type": "sp\n')
        f.write(json.dumps({"type": "span", "name": "b"}) + "\n")
    with pytest.raises(json.JSONDecodeError):
        obs.read_jsonl(bad)


# -------------------------------------------------------------- metrics
def test_counter_and_gauge():
    reg = obs.Registry()
    c = reg.counter("c", "a counter")
    c.inc()
    c.inc(2)
    assert reg.counter("c") is c and c.value == 3
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g")
    g.set(5)
    g.set(2.5)
    assert g.value == 2.5
    with pytest.raises(TypeError):
        reg.gauge("c")


def test_histogram_cumulative_buckets_and_text():
    reg = obs.Registry()
    h = reg.histogram("lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.7, 5.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(6.25)
    text = reg.to_text()
    assert 'lat_bucket{le="0.1"} 1' in text
    assert 'lat_bucket{le="1.0"} 3' in text
    assert 'lat_bucket{le="+Inf"} 4' in text
    assert "lat_count 4" in text


def test_histogram_quantile_edge_cases():
    h = obs.Histogram("h", buckets=(1.0, 2.0, 3.0))
    assert np.isnan(h.quantile(0.5))
    for v in (2.5, 2.6):
        h.observe(v)
    assert h.quantile(0.0) == 3.0             # not the empty first bucket
    assert h.quantile(0.5) == 3.0
    assert h.quantile(1.0) == 3.0
    h.observe(10.0)
    assert h.quantile(1.0) == float("inf")
    with pytest.raises(ValueError):
        h.quantile(1.5)
    # the reference's histogram answers the same
    j = jobs.Histogram("h", buckets=(1.0, 2.0, 3.0))
    for v in (2.5, 2.6, 10.0):
        j.observe(v)
    assert [j.quantile(q) for q in (0.0, 0.5, 1.0)] == \
        [h.quantile(q) for q in (0.0, 0.5, 1.0)]


def test_registry_exposition_matches_reference(tmp_path):
    regs = (obs.Registry(), jobs.Registry())
    for reg in regs:
        reg.gauge("b_gauge", "second").set(2)
        reg.counter("a_total", "first").inc(3)
        reg.histogram("c_seconds", buckets=(0.5,)).observe(0.25)
    assert regs[0].to_text() == regs[1].to_text()
    path = str(tmp_path / "sub" / "metrics.prom")
    regs[0].dump(path)
    with open(path) as f:
        assert f.read() == regs[1].to_text()


# ------------------------------------------------------- spec validation
@pytest.mark.parametrize("field,value", [
    ("fence", True), ("jsonl", "t.jsonl"), ("prometheus", "m.prom"),
    ("profile_dir", "p")])
def test_telemetry_sinks_require_enabled(field, value):
    for api in (tapi, japi):
        spec = api.with_overrides(api.preset("tiny-smoke"),
                                  {f"telemetry.{field}": value})
        with pytest.raises(api.SpecError, match="telemetry.enabled") as e:
            api.validate(spec)
        assert e.value.path == f"telemetry.{field}"


def test_telemetry_enabled_needs_a_sink_and_sane_ring():
    base = tapi.preset("tiny-smoke")
    with pytest.raises(tapi.SpecError, match="ring"):
        tapi.validate(tapi.with_overrides(
            base, {"telemetry.enabled": True, "telemetry.ring": 0}))
    with pytest.raises(tapi.SpecError, match="ring"):
        tapi.validate(tapi.with_overrides(base, {"telemetry.ring": -1}))
    tapi.validate(tapi.with_overrides(base, {"telemetry.enabled": True}))
    tapi.validate(tapi.with_overrides(
        base, {"telemetry.enabled": True, "telemetry.ring": 0,
               "telemetry.jsonl": "t.jsonl"}))


def test_health_knobs_require_runs_dir():
    base = tapi.preset("tiny-smoke")
    for field, value in [("run_id", "r1"), ("health_norms", True)]:
        spec = tapi.with_overrides(base, {f"telemetry.{field}": value})
        with pytest.raises(tapi.SpecError, match="telemetry.runs_dir"):
            tapi.validate(spec)
    tapi.validate(tapi.with_overrides(base, {
        "telemetry.runs_dir": "artifacts/runs",
        "telemetry.run_id": "r1", "telemetry.health_norms": True}))


def test_telemetry_fields_resume_mutable():
    from repro_torch.api import spec as spec_mod
    for f in dataclasses.fields(tapi.Telemetry):
        assert f"telemetry.{f.name}" in spec_mod.RESUME_MUTABLE


def test_session_wiring(tmp_path):
    assert obs.session(None) is obs.NULL_SESSION
    assert obs.session(tapi.Telemetry()) is obs.NULL_SESSION
    assert not obs.NULL_SESSION.enabled
    obs.NULL_SESSION.flush()
    path = str(tmp_path / "t.jsonl")
    prom = str(tmp_path / "m.prom")
    sess = obs.session(tapi.Telemetry(enabled=True, ring=16, jsonl=path,
                                      prometheus=prom))
    assert sess.enabled and sess.ring is not None
    with sess.tracer.span("x"):
        pass
    sess.registry.counter("steps").inc()
    sess.close()
    assert len(sess.ring) == 1
    assert [e["name"] for e in obs.read_jsonl(path)
            if e["type"] == "span"] == ["x"]
    with open(prom) as f:
        assert "steps 1.0" in f.read()


def test_profile_region_writes_a_chrome_trace(tmp_path):
    with obs.profile(None):                   # no directory: a no-op
        pass
    d = str(tmp_path / "prof")
    with obs.profile(d):
        torch.ones(8).sum()
    names = os.listdir(d)
    assert len(names) == 1 and names[0].endswith(".json")
    with open(os.path.join(d, names[0])) as f:
        assert "traceEvents" in json.load(f)
    with pytest.raises(KeyError):             # the body's error propagates
        with obs.profile(str(tmp_path / "p2")):
            raise KeyError("body")
    # a trainer session with a profile_dir annotates: its trace holds the
    # ZO step's range and the stage spans as ranges
    d = str(tmp_path / "train")
    spec = tapi.with_overrides(tapi.preset("tiny-smoke"), {
        "run.steps": 1, "run.eval_every": 0, "run.log_every": 1,
        "telemetry.enabled": True, "telemetry.ring": 64,
        "telemetry.profile_dir": d})
    from repro_torch.train.trainer import Trainer
    Trainer.from_spec(spec, device="cpu").train()
    (name,) = os.listdir(d)
    with open(os.path.join(d, name)) as f:
        seen = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {obs.TRAIN_STEP, "zo/step", obs.PERTURB, "forward+eps_z",
            "model/attn", "kernel/flash_attention", obs.UPDATE} <= seen


def test_session_annotates_only_a_profiled_run(tmp_path):
    plain = obs.session(tapi.Telemetry(enabled=True, ring=16))
    prof = obs.session(tapi.Telemetry(enabled=True, ring=16,
                                      profile_dir=str(tmp_path)))
    assert not plain.tracer.annotate and prof.tracer.annotate
    assert not obs.NULL.annotate


# ------------------------------------------------------- profiler ranges
class _CountingRange:
    """Stands in for the profiler's range: counts entries."""
    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        _CountingRange.entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_range_is_free_off_an_annotating_tracer_or_profiler(monkeypatch):
    """``range`` on NULL, on a plain tracer (profiler on or off) and on
    an annotating tracer with no profiler is the shared do-nothing span:
    no profiler range is entered, nothing is allocated; under a profiler
    an annotating tracer enters one a call, and one a span.  ``prange``,
    what the sites call, asks the installed tracer only if it annotates."""
    from repro_torch.obs import trace as obs_trace
    monkeypatch.setattr(obs_trace, "_RANGE", _CountingRange)
    monkeypatch.setattr(_CountingRange, "entered", 0)
    plain, annot = obs.Tracer(), obs.Tracer(annotate=True)
    for tr in (obs.NULL, plain, annot):
        r = tr.range("model/attn")
        assert r is obs.NULL.span("x")
        with r:
            pass
        with obs.use(tr):
            assert obs.prange("model/attn") is obs.NULL.span("x")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for tr in (obs.NULL, plain):
            assert tr.range("model/attn") is obs.NULL.span("x")
            with obs.use(tr):
                assert obs.prange("model/attn") is obs.NULL.span("x")
            with tr.span("s"):
                pass
        assert _CountingRange.entered == 0
        with annot.range("model/attn"):
            with annot.span("s"):
                pass
        assert _CountingRange.entered == 2
        with obs.use(annot), obs.prange("model/attn"):
            pass
        assert _CountingRange.entered == 3
        assert obs.prange("model/attn") is obs.NULL.span("x")
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert annot.range("model/attn") is obs.NULL.span("x")
    assert _CountingRange.entered == 3


def _profiled_ranges(prof):
    """[(name, chain of enclosing range names, innermost first)] of the
    program's ranges and stage spans in a CPU profile, in start order."""
    span = {obs.trace.range_name(n): n for n in obs.STAGES}
    names = set(obs.RANGES) | set(span)
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name not in names:
            continue
        chain, q = [], e.cpu_parent
        while q is not None:
            if q.name in names:
                chain.append(span.get(q.name, q.name))
            q = q.cpu_parent
        out.append((span.get(e.name, e.name), tuple(chain)))
    return out


def _smoke_step(arch, variant, backend):
    cfg = (topt.opt_tiny(**CFG) if arch == "opt"
           else tconfigs.get(arch, variant))
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = tzo.build_spec(params, tlm.zo_group_fn)
    step, init = test_mod.make_step(
        lambda p, b, perturb=None: tlm.lm_loss(cfg, p, b, perturb=perturb),
        spec, test_mod.EstimatorConfig(eps=1e-3, lr=1e-4, n_drop=1,
                                       backend="pallas",
                                       forward_backend=backend))
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg.vocab).items()}
    return cfg, params, step, init, batch


@pytest.mark.parametrize("backend", ["materialized", "virtual"])
def test_annotated_step_ranges_nest_and_count(backend):
    """One LeZO step under an annotating tracer and a CPU profiler: the
    ZO step holds the selection, the stages and the readbacks; each
    forward holds its sublayers, the sublayers their kernels' wrappers;
    K1's wrapper runs inside the perturb and update stages."""
    cfg, params, step, init, batch = _smoke_step("opt", None, backend)
    with obs.use(obs.Tracer(annotate=True)), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(params, init(), batch, 0, 7)
    got = _profiled_ranges(prof)
    count = {n: sum(g[0] == n for g in got) for n in {g[0] for g in got}}
    nested = {(n, c[0] if c else None) for n, c in got}
    fwd = obs.FWD_PLUS if backend == "materialized" else obs.FWD_PAIR
    assert got[0] == ("zo/step", ())
    assert all(c[-1] == "zo/step" for _, c in got[1:])
    assert count["zo/step"] == 1 and count["zo/select"] == 1
    assert count["zo/readback"] == 2 and count["model/head_ce"] == 2
    assert count["model/attn"] == (2 if backend == "materialized" else 1) \
        * CFG["layers"]
    assert ("model/attn", fwd) in nested and ("model/ffn", fwd) in nested
    assert ("model/embed", fwd) in nested
    assert ("model/head_ce", fwd) in nested
    assert ("model/norm", "model/attn") in nested
    # on the CPU every norm runs its plain ops: no launch, no kernel range
    assert "kernel/norm" not in count
    assert ("zo/readback", "zo/step") in nested
    assert ("kernel/zo_axpy_2d", obs.UPDATE) in nested
    if backend == "materialized":
        assert ("kernel/zo_axpy_2d", obs.PERTURB) in nested
        assert ("kernel/flash_attention", "model/attn") in nested
        assert [g for g in got if g[0] == "model/attn"][0][1] == (
            obs.FWD_PLUS, "zo/step")
    else:
        assert ("kernel/pmatmul", "model/attn") in nested
        assert ("kernel/pmatmul", "model/head_ce") in nested


def test_moe_ranges_once_a_moe_layer_a_forward():
    """On deepseek-v2-lite's smoke config (a dense layer, then MoE
    layers with shared experts) each MoE layer of each forward opens
    route, dispatch, experts and combine once, in that order, inside its
    forward, then experts once more for the shared experts."""
    cfg, params, step, init, batch = _smoke_step(
        "deepseek-v2-lite-16b", "smoke", "materialized")
    n_moe = sum(st.repeat for st in cfg.stages
                for b in st.pattern if b.ffn == "moe")
    with obs.use(obs.Tracer(annotate=True)), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(params, init(), batch, 0, 7)
    got = [(n, c[0]) for n, c in _profiled_ranges(prof)
           if n.startswith("model/moe/")]
    parts = ["model/moe/route", "model/moe/dispatch", "model/moe/experts",
             "model/moe/combine", "model/moe/experts"]
    fwds = [obs.FWD_PLUS] * n_moe + [obs.FWD_MINUS] * n_moe
    assert n_moe >= 1 and cfg.n_shared_experts
    assert got == [(p, f) for f in fwds for p in parts]


def test_annotation_leaves_the_span_stream_unchanged():
    """The ring receives the same span records a step, names, depths,
    parents and indices, with annotation on under a profiler as off."""
    recs = []
    for annotate in (False, True):
        cfg, params, step, init, batch = _smoke_step(
            "opt", None, "materialized")
        ring = obs.RingSink()
        with obs.use(obs.Tracer(sinks=[ring], annotate=annotate)), \
                torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
            step(params, init(), batch, 0, 7)
        recs.append(_records(ring))
    assert recs[0] == recs[1]
    assert [r[0] for r in recs[1]] == [obs.PERTURB, obs.FWD_PLUS,
                                       obs.PERTURB, obs.FWD_MINUS,
                                       obs.UPDATE]


@pytest.mark.parametrize("mode", ["plain", "annotate"])
def test_annotation_leaves_the_step_bit_exact(mode):
    """Losses, g and every parameter after a step equal the NULL
    tracer's bit for bit, with a plain tracer and with an annotating
    tracer under a live profiler."""
    out = {}
    for side in ("null", mode):
        cfg, params, step, init, batch = _smoke_step(
            "opt", None, "materialized")
        tr = {"null": obs.NULL, "plain": obs.Tracer(),
              "annotate": obs.Tracer(annotate=True)}[side]
        with obs.use(tr), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
        ) if side == "annotate" else contextlib.nullcontext():
            _, _, m = step(params, init(), batch, 0, 7)
        out[side] = (m, tzo.leaf_items(params))
    (m0, p0), (m1, p1) = out["null"], out[mode]
    for key in ("l_plus", "l_minus", "projected_grad"):
        assert m0[key].tobytes() == m1[key].tobytes(), key
    assert [k for k, _ in p0] == [k for k, _ in p1]
    for (k, a), (_, b) in zip(p0, p1):
        assert torch.equal(a, b), k


# --------------------------------------------- estimator instrumentation
CFG = dict(layers=2, d_model=32, vocab=64)


def _weights():
    """The reference's tiny OPT weights, in both packages."""
    jcfg = jopt.opt_tiny(**CFG)
    jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    tcfg = topt.opt_tiny(**CFG)
    return jcfg, jp, tcfg, tlm.params_from_numpy(tcfg, flat, "cpu")


def _batch(vocab, B=2, S=8):
    rs = np.random.default_rng(3)
    toks = rs.integers(0, vocab, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1),
            "loss_mask": np.ones((B, S), np.float32)}


def _records(ring):
    return [(r.name, r.depth, r.parent, r.index) for r in ring.records()]


@pytest.mark.parametrize("backend,paired", [
    ("materialized", True), ("virtual_ref", True), ("virtual_ref", False)])
def test_eager_step_matches_reference(backend, paired):
    """One eager step of each package on the same weights and batch:
    the same span names, nesting and parents, and the same probe, axpy,
    selection and active-layer counts; rng_folds differs as the module
    docstring says."""
    jcfg, jp, tcfg, tp = _weights()
    nb = _batch(jcfg.vocab)
    kw = dict(name="two_point", eps=1e-3, lr=1e-4, n_drop=1,
              backend="dense", forward_backend=backend, paired_probes=paired)
    out = {}
    for side in ("jax", "torch"):
        ring = (jobs if side == "jax" else obs).RingSink()
        tr = (jobs if side == "jax" else obs).Tracer(sinks=[ring],
                                                     fence=True)
        if side == "jax":
            spec = jzo.build_spec(jp, jlm.zo_group_fn)
            step, init = jest.make_step(
                lambda p, b, perturb=None: jlm.lm_loss(jcfg, p, b,
                                                       perturb=perturb),
                spec, jest.EstimatorConfig(**kw))
            with jobs.use(tr):
                step(jp, init(), {k: jnp.asarray(v) for k, v in nb.items()},
                     jnp.int32(0), jnp.uint32(7))
        else:
            spec = tzo.build_spec(tp, tlm.zo_group_fn)
            step, init = test_mod.make_step(
                lambda p, b, perturb=None: tlm.lm_loss(tcfg, p, b,
                                                       perturb=perturb),
                spec, test_mod.EstimatorConfig(**kw))
            with obs.use(tr):
                step(tp, init(), {k: torch.as_tensor(v)
                                  for k, v in nb.items()}, 0, 7)
        out[side] = (_records(ring), dict(tr.counters), dict(tr.gauges))
    (jrec, jc, jg), (trec, tc, tg) = out["jax"], out["torch"]
    assert trec == jrec
    want = {"materialized": [obs.PERTURB, obs.FWD_PLUS, obs.PERTURB,
                             obs.FWD_MINUS, obs.UPDATE]}.get(
        backend, [obs.FWD_PAIR, obs.UPDATE] if paired
        else [obs.FWD_PLUS, obs.FWD_MINUS, obs.UPDATE])
    assert [r[0] for r in trec] == want
    for key in (obs.CTR_PROBES, obs.CTR_AXPY, obs.CTR_SELECTS):
        assert tc[key] == jc[key], key
    assert tg == jg == {obs.GAUGE_ACTIVE: 1}
    if backend == "materialized":         # every fold of the step is eager
        assert tc[obs.CTR_RNG_FOLDS] == jc[obs.CTR_RNG_FOLDS] > 0
    else:                                 # the reference's scan hides some
        assert tc[obs.CTR_RNG_FOLDS] > jc[obs.CTR_RNG_FOLDS] > 0


def test_counters_deterministic_across_identical_seeded_runs():
    _, _, tcfg, tp = _weights()
    nb = {k: torch.as_tensor(v) for k, v in _batch(tcfg.vocab).items()}
    spec = tzo.build_spec(tp, tlm.zo_group_fn)
    cfg = test_mod.EstimatorConfig(n_drop=1, forward_backend="virtual_ref")
    runs = []
    for _ in range(2):
        p = tlm.params_from_numpy(tcfg, tlm.params_to_numpy(tp), "cpu")
        step, init = test_mod.make_step(
            lambda q, b, perturb=None: tlm.lm_loss(tcfg, q, b,
                                                   perturb=perturb),
            spec, cfg)
        tr = obs.Tracer()
        with obs.use(tr):
            step(p, init(), nb, 3, 11)
        runs.append(dict(tr.counters))
    assert runs[0] == runs[1] and runs[0][obs.CTR_WLOAD] > 0


def test_paired_structural_counters_halve():
    """The reference's claim at the port's kernel grid: ONE paired
    forward loads half the W tiles and draws half the z tiles of the two
    probe forwards it replaces (M = 8 rows fit one block of both)."""
    _, _, tcfg, tp = _weights()
    toks = torch.as_tensor(_batch(tcfg.vocab, B=1, S=8)["tokens"])

    def count(ctxs):
        tr = obs.Tracer()
        with obs.use(tr):
            for ctx in ctxs:
                tlm.forward(tcfg, tp, toks, perturb=ctx)
        return tr.counters[obs.CTR_WLOAD], tr.counters[obs.CTR_ZREGEN]

    pw, pz = count([fused.make_pair_ctx(5, 1e-3, None, "virtual_ref")])
    uw, uz = count([fused.make_ctx(5, 1e-3, None, "virtual_ref"),
                    fused.make_ctx(5, -1e-3, None, "virtual_ref")])
    assert pw > 0 and 2 * pw == uw
    assert pz > 0 and 2 * pz == uz


def test_tile_counts_follow_the_kernel_grid():
    """``tile_counts`` is csrc/pmatmul.cu's grid: 64-deep k-tiles; 512
    rows x 64 columns a block when active (rows split over the probes),
    256 x 128 when not; z drawn once a tile for one seed, once a probe
    for several, never when inactive; probe groups of two beyond P = 2.
    At the main path's (1008, 5120) @ (5120, 20480) the paired launch
    loads as many tiles as the two unpaired ones (4 row blocks against
    2 + 2) and draws each W element's z 4 times."""
    K, N = 5120, 20480
    w_elems = (K // 64) * (N // 64)
    assert fmm.tile_counts(1008, K, N, (1, 1), (True, True)) == \
        (4 * w_elems, 4 * w_elems)
    assert fmm.tile_counts(1008, K, N, (1,), (True,)) == \
        (2 * w_elems, 2 * w_elems)
    assert fmm.tile_counts(1008, K, N, (1, 1), (False, False)) == \
        (8 * (K // 64) * (N // 128), 0)
    assert fmm.tile_counts(8, 64, 64, (1, 2), (True, False)) == (1, 2)
    # P = 5: active probes 0, 3 pair up; inactive 1, 2 pair; 4 alone
    w, z = fmm.tile_counts(8, 64, 128, (1, 2, 3, 4, 5),
                           (True, False, False, True, False))
    assert fmm.probe_groups((True, False, False, True, False)) == \
        [[0, 3], [1, 2], [4]]
    assert (w, z) == (2 + 1 + 1, 2 * 2)


def test_tree_z_norm_matches_reference(monkeypatch):
    """Exact ‖z(seed)‖ over a LeZO selection, within 1e-6 relative of
    the reference's, also when rows are drawn in several chunks."""
    jcfg, jp, tcfg, tp = _weights()
    jspec = jzo.build_spec(jp, jlm.zo_group_fn)
    tspec = tzo.build_spec(tp, tlm.zo_group_fn)
    tmasks, _, _ = tzo.stratified_select(tspec, 99, 1)
    jmasks = {g: jnp.asarray(m.numpy()) for g, m in tmasks.items()}
    want = float(jzo.tree_z_norm(jspec, jzo.leaf_shapes(jp), jnp.uint32(99),
                                 jmasks))
    got = tzo.tree_z_norm(tspec, tzo.leaf_shapes(tp), 99, tmasks)
    assert abs(got - want) <= 1e-6 * want
    monkeypatch.setattr(tzo, "Z_NORM_CHUNK", 1000)
    assert tzo.tree_z_norm(tspec, tzo.leaf_shapes(tp), 99, tmasks) == \
        pytest.approx(got, rel=1e-12)


# ------------------------------------------------------------- trainer
def test_trainer_session_records_steps(tmp_path):
    """With the tracer on, each step records a ``train/step`` span with
    the eager step's stage spans nested under it (the reference's jitted
    step records only the first)."""
    path = str(tmp_path / "train.jsonl")
    spec = tapi.with_overrides(tapi.preset("tiny-smoke"), {
        "run.steps": 3, "run.eval_every": 0, "run.log_every": 1,
        "telemetry.enabled": True, "telemetry.jsonl": path})
    from repro_torch.train.trainer import Trainer
    tr = Trainer.from_spec(spec, device="cpu")
    assert tr.obs.enabled
    h = tr.train()
    assert h["step"] == [0, 1, 2]
    assert obs.get_tracer() is obs.NULL       # restored after train()
    spans = [e for e in obs.read_jsonl(path) if e["type"] == "span"]
    tops = [s for s in spans if s["depth"] == 0]
    assert [s["name"] for s in tops] == [obs.TRAIN_STEP] * 3
    for top in tops:
        kids = [s["name"] for s in spans if s["parent"] == top["index"]]
        assert kids == [obs.PERTURB, obs.FWD_PLUS, obs.PERTURB,
                        obs.FWD_MINUS, obs.UPDATE]
    snaps = [e for e in obs.read_jsonl(path) if e["type"] == "counters"]
    assert snaps and snaps[-1]["counters"][obs.CTR_PROBES] == 6
    assert snaps[-1]["counters"][obs.CTR_AXPY] == 9
    assert snaps[-1]["gauges"][obs.GAUGE_ACTIVE] == 1


def test_telemetry_off_leaves_the_callers_tracer():
    """A run without telemetry keeps whatever tracer the caller
    installed, so an outside tracer can watch it."""
    spec = tapi.with_overrides(tapi.preset("tiny-smoke"), {
        "run.steps": 2, "runtime.forward_backend": "virtual_ref"})
    tr = obs.Tracer()
    with obs.use(tr):
        tapi.run(spec, device="cpu")
    assert tr.counters[obs.CTR_PROBES] == 4
    assert tr.counters[obs.CTR_AXPY] == 2
    assert tr.counters[obs.CTR_WLOAD] > 0

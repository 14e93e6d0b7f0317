"""The port's surface: the spec (byte-identical JSON with ``repro.api``
for every preset), validation of what the slice does not run, the
device default, the import boundary, and the ``tiny-smoke`` trajectory
against ``repro.api.run`` (every logged loss within rtol 1e-3)."""
import ast
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro_torch import api as tapi
from repro_torch import resolve_device
from repro_torch.models import lm as tlm
from _port_cfg import as_reference

ROOT = os.path.join(os.path.dirname(__file__), "..")

torch.set_num_threads(2)              # six xdist workers share the CPUs


@pytest.mark.parametrize("name", sorted(japi.PRESETS))
def test_preset_json_identical(name):
    assert tapi.to_json(tapi.preset(name)) == japi.to_json(japi.preset(name))
    assert tapi.to_json(tapi.from_json(japi.to_json(japi.preset(name)))) \
        == japi.to_json(japi.preset(name))


@pytest.mark.parametrize("override,path", [
    ({"runtime.mesh": "multi_pod"}, "runtime.mesh"),
    ({"model.arch": "jamba-v0.1-52b", "model.variant": "smoke"},
     "model.arch"),
    ({"model.arch": "xlstm-350m", "model.variant": "smoke"}, "model.arch"),
    ({"model.arch": "xlstm-350m"}, "model.arch"),
    ({"model.arch": "jamba-v0.1-52b"}, "model.arch"),
])
def test_unported_fields_raise(override, path):
    """``path`` is the field the case sets.  ``runtime.mesh =
    multi_pod`` now validates to the reference's config (only the dry
    run reads it) and an unknown mesh raises at the field.  The
    recurrent archs are ported: they validate on the preset's materialized
    forward backend and, as in the reference, raise at
    ``runtime.forward_backend`` under the virtual one."""
    spec = tapi.with_overrides(tapi.preset("lezo-opt13b"), override)
    if path == "runtime.mesh":
        want = japi.validate(japi.with_overrides(japi.preset("lezo-opt13b"),
                                                 override))
        assert as_reference(tapi.validate(spec)) == \
            dataclasses.asdict(want)
        with pytest.raises(tapi.SpecError, match="unknown mesh") as e:
            tapi.validate(tapi.with_overrides(spec, {"runtime.mesh": "ring"}))
        assert e.value.path == path
        return
    assert spec.runtime.forward_backend == "materialized"
    assert tapi.validate(spec).name.startswith(override[path][:5])
    with pytest.raises(tapi.SpecError, match="materialized") as e:
        tapi.validate(tapi.with_overrides(
            spec, {"runtime.forward_backend": "virtual"}))
    assert e.value.path == "runtime.forward_backend"


@pytest.mark.parametrize("override", [
    {"runtime.peft": "lora"}, {"runtime.peft": "prefix"},
    {"task.name": "sst2"}])
def test_ported_fields_validate_like_the_reference(override):
    """The fields this slice ports (PEFT, registry tasks) validate and
    derive the reference's configs."""
    d = tapi.derive(tapi.with_overrides(tapi.preset("lezo-opt13b"),
                                        override))
    jd = japi.derive(japi.with_overrides(japi.preset("lezo-opt13b"),
                                         override))
    assert d.tcfg.peft == jd.tcfg.peft
    assert type(d.task).__name__ == type(jd.task).__name__
    assert getattr(d.task, "name", None) == getattr(jd.task, "name", None)


@pytest.mark.parametrize("override", [
    {"telemetry.enabled": True}, {"telemetry.runs_dir": "runs"},
    {"telemetry.runs_dir": "runs", "telemetry.run_id": "r1",
     "telemetry.health_norms": True},
    {"telemetry.enabled": True, "telemetry.ring": 0,
     "telemetry.jsonl": "t.jsonl", "telemetry.fence": True,
     "telemetry.prometheus": "m.prom", "telemetry.profile_dir": "p"}])
def test_telemetry_fields_validate_like_the_reference(override):
    """The telemetry fields (ported in the observability slice) validate
    as in the reference: accepted here, accepted there, and the spec
    reaches the trainer's session."""
    tapi.validate(tapi.with_overrides(tapi.preset("lezo-opt13b"), override))
    japi.validate(japi.with_overrides(japi.preset("lezo-opt13b"), override))


def test_main_path_spec_validates():
    spec = tapi.with_overrides(tapi.preset("lezo-opt13b"), {
        "model.variant": "full", "runtime.backend": "pallas",
        "runtime.forward_backend": "virtual"})
    d = tapi.derive(spec)
    assert d.model_cfg.num_layers == 40 and d.n_drop == 30
    assert d.est_cfg.forward_backend == "virtual"


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 20 and not bad, bad
    scanned = {os.path.relpath(f, os.path.join(ROOT, "src", "repro_torch"))
               for f in files}
    for mod in ("obs/__init__.py", "obs/trace.py", "obs/sinks.py",
                "obs/metrics.py", "obs/profiler.py", "obs/runtime.py",
                "obs/health.py", "obs/runlog.py", "launch/report.py",
                "launch/replay.py", "launch/cli.py", "swarm/__init__.py",
                "swarm/commit.py", "swarm/proto.py", "swarm/chaos.py",
                "swarm/shardstep.py", "swarm/coordinator.py",
                "swarm/worker.py", "swarm/driver.py", "serving/__init__.py",
                "serving/pool.py", "serving/prefix.py",
                "serving/scheduler.py", "serving/sampling.py",
                "serving/engine.py", "launch/serve.py"):
        assert mod in scanned, mod


@pytest.mark.parametrize("overrides", [
    {},                                           # materialized, scan
    {"runtime.backend": "pallas", "runtime.forward_backend": "virtual"},
])
def test_tiny_smoke_trajectory_matches_reference(overrides):
    spec = japi.preset("tiny-smoke")
    want = np.array(japi.run(japi.with_overrides(spec, overrides))
                    ["history"]["loss"])
    jp = jlm.init_params(japi.derive(spec).model_cfg,
                         jax.random.PRNGKey(spec.run.seed))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    tspec = tapi.with_overrides(tapi.from_json(japi.to_json(spec)),
                                overrides)
    params = tlm.params_from_numpy(tapi.derive(tspec).model_cfg, flat, "cpu")
    got = tapi.run(tspec, device="cpu", params=params)
    assert got["summary"]["device"] == "cpu"
    loss = np.array(got["history"]["loss"])
    assert loss.shape == want.shape == (spec.run.steps,)
    np.testing.assert_allclose(loss, want, rtol=1e-3)


# Public names of ``src/repro`` with no namesake in the same port module,
# each with the reason.  Anything else the reference adds and the port
# lacks fails the test below.
SURFACE_EXCEPTIONS = {
    "kernels/zo_axpy.py::zo_axpy_2d":
        "Pallas entry point; the port's kernel is the in-place "
        "zo_axpy_2d_ (K1)",
    "kernels/flash_attn.py::flash_attention_pallas":
        "Pallas entry point; the port's K2 wrapper is flash_attention",
    "kernels/flash_attn.py::flash_attention_ref":
        "the jnp oracle; the port's plain version is "
        "flash_attention_plain",
    "fused/matmul.py::default_interpret":
        "Pallas interpret-mode switch; the port has no interpret mode "
        "(a CPU tensor takes the plain version)",
    "fused/matmul.py::grid_cells":
        "Pallas grid size; the port's tile counters are tile_counts and "
        "launch_tiles",
    "launch/analysis.py::Cost": "XLA HLO cost parser; the port counts "
        "with the TorchDispatchMode CostCounter",
    "launch/analysis.py::Cost.add": "as Cost",
    "launch/analysis.py::HloCost": "as Cost",
    "launch/analysis.py::HloCost.comp_cost": "as Cost",
    "launch/analysis.py::HloCost.total": "as Cost",
    "launch/analysis.py::Op": "as Cost",
    "launch/dryrun.py::collective_bytes":
        "parses collectives out of HLO text; CostCounter counts them",
    "kernels/ops.py::zo_axpy":
        "functional axpy; the port updates in place (zo_axpy_)",
    "kernels/ref.py::zo_axpy_2d":
        "functional axpy; the port's plain version is zo_axpy_2d_",
    "kernels/ref.py::leaf_normal":
        "the port draws a leaf's z through leaf_normal_nd",
}


def _public_names(path):
    """Public top-level functions and classes of a module, and the
    public methods of its public classes (``Class.method``)."""
    out = set()
    for node in ast.parse(open(path).read()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name[0] == "_":
            continue
        out.add(node.name)
        if isinstance(node, ast.ClassDef):
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and m.name[0] != "_"}
    return out


def test_port_covers_reference_api_surface():
    """Every public function, class and method of each ``src/repro``
    module has a namesake in the port module of the same path, but for
    the listed exceptions; every exception still names a reference
    function the port lacks, and its port counterpart exists."""
    ref_root = os.path.join(ROOT, "src", "repro")
    port_root = os.path.join(ROOT, "src", "repro_torch")
    missing, seen = [], set()
    for d, _, names in os.walk(ref_root):
        for n in sorted(names):
            if not n.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, n), ref_root)
            port = os.path.join(port_root, rel)
            assert os.path.exists(port), rel
            gap = _public_names(os.path.join(d, n)) - _public_names(port)
            for name in sorted(gap):
                key = f"{rel}::{name}"
                seen.add(key)
                if key not in SURFACE_EXCEPTIONS:
                    missing.append(key)
    assert not missing, missing
    assert seen == set(SURFACE_EXCEPTIONS), set(SURFACE_EXCEPTIONS) - seen
    counterparts = {"kernels/zo_axpy.py": "zo_axpy_2d_",
                    "kernels/flash_attn.py": "flash_attention_plain",
                    "fused/matmul.py": "tile_counts",
                    "launch/analysis.py": "CostCounter",
                    "kernels/ops.py": "zo_axpy_",
                    "kernels/ref.py": "leaf_normal_nd"}
    for rel, name in counterparts.items():
        assert name in _public_names(os.path.join(port_root, rel)), rel

"""The port's surface: the spec (byte-identical JSON with ``repro.api``
for every preset), validation of what the slice does not run, the
device default, the import boundary, and the ``tiny-smoke`` trajectory
against ``repro.api.run`` (every logged loss within rtol 1e-3)."""
import ast
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

ROOT = os.path.join(os.path.dirname(__file__), "..")

torch.set_num_threads(2)              # six xdist workers share the CPUs


@pytest.mark.parametrize("name", sorted(japi.PRESETS))
def test_preset_json_identical(name):
    assert tapi.to_json(tapi.preset(name)) == japi.to_json(japi.preset(name))
    assert tapi.to_json(tapi.from_json(japi.to_json(japi.preset(name)))) \
        == japi.to_json(japi.preset(name))


@pytest.mark.parametrize("override,path", [
    ({"runtime.mesh": "multi_pod"}, "runtime.mesh"),
    ({"telemetry.enabled": True}, "telemetry.enabled"),
    ({"telemetry.runs_dir": "runs"}, "telemetry.enabled"),
    ({"swarm.workers": 2}, "swarm.workers"),
    ({"swarm.n_shards": 2}, "swarm.workers"),
    ({"model.arch": "xlstm-350m"}, "model.arch"),
    ({"model.arch": "qwen3-14b"}, "model.arch"),
])
def test_unported_fields_raise(override, path):
    spec = tapi.with_overrides(tapi.preset("lezo-opt13b"), override)
    with pytest.raises(tapi.SpecError, match="not yet ported") as e:
        tapi.validate(spec)
    assert e.value.path == path


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

"""The port's launch CLI (``python -m repro_torch.launch``) against the
reference's ``repro.launch``: ``specs`` writes the same bytes for every
preset; ``train`` and ``evaluate`` run ``tiny-smoke`` with ``--device
cpu`` and report what the reference reports; unknown tasks are rejected
with the reference's field path; the default device is the card, with no
fallback."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api import presets as jpresets
from repro.launch import cli as jcli
from repro_torch import api as tapi
from repro_torch.launch import cli as tcli
from repro_torch.launch import evaluate as tevaluate
from repro_torch.launch import train as ttrain

torch.set_num_threads(2)              # six xdist workers share the CPUs

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = ["--preset", "tiny-smoke", "--device", "cpu"]


@pytest.fixture(scope="module")
def spec_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("specs")
    jcli.main(["specs", "--out", str(d / "jax")])
    tcli.main(["specs", "--out", str(d / "torch")])
    return d / "jax", d / "torch"


@pytest.mark.parametrize("name", jpresets.names())
def test_specs_byte_identical(spec_dirs, name):
    jd, td = spec_dirs
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd))
    assert (td / f"{name}.json").read_bytes() == \
        (jd / f"{name}.json").read_bytes()


def test_aliases_and_generated_flags_match_the_reference():
    assert tcli.ALIASES == jcli.ALIASES
    ns = tcli.build_parser().parse_args(
        ["train", "--arch", "opt", "--lr", "3e-4", "--model.seq_len", "48",
         "--set", "run.steps=5"])
    jns = jcli.build_parser().parse_args(
        ["train", "--arch", "opt", "--lr", "3e-4", "--model.seq_len", "48",
         "--set", "run.steps=5"])
    assert tapi.to_json(tcli.build_spec(ns)) == \
        jcli.api.to_json(jcli.build_spec(jns))
    assert ns.device == "cuda"


def test_train_on_cpu(capsys):
    out = tcli.main(["train", *TINY, "--steps", "2", "--task", "sst2",
                     "--set", "run.eval_every=1"])
    summary = json.loads(capsys.readouterr().out)
    assert summary == out["summary"]
    assert summary["task"] == "sst2" and summary["metric"] == "accuracy"
    assert summary["device"] == "cpu" and len(summary["val_acc"]) == 2
    assert np.isfinite(summary["final_loss"])


def test_train_optimizer_implications(tmp_path):
    out = ttrain.main([*TINY, "--steps", "1", "--optimizer", "mezo",
                       "--out", str(tmp_path / "h.json")])
    assert out["summary"]["n_drop"] == 0
    saved = json.loads((tmp_path / "h.json").read_text())
    assert set(saved) == {"spec", "summary", "history"}
    assert not any(k.endswith("params") for k in saved["history"])


def test_evaluate_on_cpu(tmp_path):
    reports = tcli.main(["evaluate", *TINY, "--task", "copa",
                         "--n-examples", "8", "--out",
                         str(tmp_path / "r.json")])
    assert [r["task"] for r in reports] == ["copa"]
    r = reports[0]
    assert r["metric"] == "accuracy" and r["mode"] == "zeroshot"
    assert 0.0 <= r["zeroshot"] <= 1.0
    assert json.loads((tmp_path / "r.json").read_text())[0]["task"] == "copa"


def test_evaluate_task_library_wrapper():
    rep = tevaluate.evaluate_task("squad_copy", variant="tiny", seq_len=32,
                                  n_examples=4, device="cpu")
    assert rep["metric"] == "exact_match" and rep["variant"] == "tiny"


def test_unknown_task_rejected():
    with pytest.raises(tapi.SpecError) as e:
        tcli.main(["evaluate", *TINY, "--task", "nope"])
    assert e.value.path == "task.name"
    with pytest.raises(jcli.spec_mod.SpecError) as je:
        jcli.main(["evaluate", "--preset", "tiny-smoke", "--task", "nope"])
    assert je.value.path == "task.name"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["train", "--preset", "tiny-smoke", "--steps", "1"])


@pytest.mark.parametrize("argv", [
    ["specs", "--out", "{tmp}"],
    ["train", *TINY, "--steps", "1"],
    ["evaluate", *TINY, "--task", "sst2", "--n-examples", "4"],
])
def test_module_entry_point(tmp_path, argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch", *argv],
                         env=env, cwd=str(tmp_path), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout)

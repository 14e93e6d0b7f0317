"""The port's optimizer health and run directories, a port of
``tests/test_runlog.py`` held against the JAX package.

Covers :class:`repro_torch.obs.HealthAccumulator` (record converts
nothing, Welford g statistics, LeZO layer coverage and staleness, the
update-norm identity), the run-dir writer and reader, ``launch train``'s
default run directory, and the two run-dir commands, ``launch report``
and ``launch replay``: replay is bit-exact for the four estimators under
the materialized and the virtual forward, across a checkpoint after a
resume, and a flipped bit of a recorded g fails it.  Against the JAX
package: the health rows of one spec from the same initial weights (the
integer fields bit for bit, the float ones within the loss tolerance of
``test_torch_api.py``, rtol 1e-3), and a run directory written by either
package loads and renders alike in the other.
"""
import json
import math
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import zo as jzo
from repro.launch import report as jreport
from repro.models import lm as jlm
from repro.obs import health as jhealth
from repro.obs import runlog as jrunlog
from repro_torch import api as tapi
from repro_torch.core import rng
from repro_torch.launch import cli
from repro_torch.launch import replay as replay_mod
from repro_torch.launch import report as report_mod
from repro_torch.models import lm as tlm
from repro_torch.obs import health, runlog

torch.set_num_threads(2)              # six xdist workers share the CPUs

SMOKE = "tiny-smoke"
LOSS_RTOL = 1e-3                      # test_torch_api.py's trajectory band


def _spec(**ov):
    return tapi.with_overrides(tapi.preset(SMOKE), ov)


# ===================================================== HealthAccumulator
class _Probe:
    """Counts host conversions, so a test can prove ``record()`` converts
    nothing and ``drain()`` converts once."""

    def __init__(self, value):
        self.value = value
        self.conversions = 0

    def __float__(self):
        self.conversions += 1
        return float(self.value)


def test_health_record_converts_nothing():
    acc = health.HealthAccumulator()
    probe = _Probe(2.5)
    acc.record(0, {"loss": probe, "ignored_key": object()}, seed=11)
    acc.record(1, {"loss": torch.tensor(3.0)})
    assert len(acc) == 2
    assert probe.conversions == 0
    rows = acc.drain()
    assert probe.conversions == 1
    assert len(acc) == 0 and acc.drain() == []
    assert rows[0] == {"step": 0, "seed": 11, "loss": 2.5}
    assert rows[1]["loss"] == 3.0 and "seed" not in rows[1]


def test_health_welford_matches_numpy():
    gs = np.random.default_rng(0).normal(size=12).astype(np.float32)
    acc = health.HealthAccumulator()
    for t, g in enumerate(gs):
        acc.record(t, {"projected_grad": g, "loss": 1.0})
        if t % 3 == 2:
            acc.drain()
    acc.drain()
    g64 = gs.astype(np.float64)
    assert acc.g_count == len(gs)
    assert acc.g_mean == pytest.approx(np.mean(g64), rel=1e-12)
    assert acc.g_var == pytest.approx(np.var(g64, ddof=1), rel=1e-12)
    assert acc.rows[0]["g_var"] == 0.0
    acc.record(len(gs), {"projected_grad": float("nan")})
    acc.drain()
    assert acc.g_count == len(gs) and math.isfinite(acc.g_mean)


def test_health_layer_coverage_and_staleness():
    acc = health.HealthAccumulator(num_layers=3)
    sels = [[1, 0, 0], [1, 1, 0], [0, 1, 0], [1, 0, 0]]
    for t, sel in enumerate(sels):
        acc.record(t, {"layer_sel": np.asarray(sel, np.int32),
                       "active_layers": sum(sel), "loss": float(t)})
    acc.drain()
    assert acc.layer_counts == [3, 2, 0]
    assert acc.staleness() == [0, 1, -1]
    s = acc.summary()
    assert s["steps_recorded"] == 4 and s["last_step"] == 3
    assert s["layers_never_selected"] == 1
    assert s["loss_first"] == 0.0 and s["loss_last"] == 3.0


def test_health_update_norm_identity_matches_reference():
    rows = []
    for mod in (health, jhealth):
        acc = mod.HealthAccumulator(num_layers=2,
                                    norm_fn=lambda seed, sel: 2.0)
        acc.record(0, {"coeffs": np.asarray([0.5], np.float32),
                       "n_active_params": np.asarray([100.0], np.float32),
                       "lr": np.float32(0.01),
                       "layer_sel": np.asarray([1, 0])}, seed=7)
        acc.record(1, {"coeffs": np.asarray([0.5, -0.25], np.float32),
                       "n_active_params": np.asarray([100.0, 400.0],
                                                     np.float32),
                       "lr": np.float32(0.01),
                       "layer_sel": np.asarray([0, 1])}, seed=8)
        rows.append(acc.drain())
        assert acc.summary()["update_norm_est_last"] == \
            rows[-1][1]["update_norm_est"]
    assert rows[0] == rows[1]
    r0, r1 = rows[0]
    lr = float(np.float32(0.01))
    assert r0["update_norm_est"] == pytest.approx(lr * math.sqrt(25.0))
    assert r0["update_norm"] == pytest.approx(abs(lr * 0.5) * 2.0)
    assert "update_norm" not in r1            # exact norm is q == 1 only


# ============================================================== run dirs
def test_runlog_roundtrip(tmp_path):
    root = str(tmp_path)
    log = runlog.RunLog(root, "r1", spec={"estimator": {"name": "x"}})
    log.append([{"step": 1, "loss": 2.0}])
    log.append([{"step": 0, "loss": 1.0}])
    log.finalize({"steps_recorded": 2})
    rd = runlog.load_run("r1", root)
    assert rd.run_id == "r1" and rd.spec == {"estimator": {"name": "x"}}
    assert [r["step"] for r in rd.steps] == [0, 1]
    assert rd.first_step == 0 and rd.last_step == 1
    assert rd.step_row(1)["loss"] == 2.0
    with pytest.raises(KeyError, match="no recorded step 5"):
        rd.step_row(5)
    assert rd.summary == {"steps_recorded": 2}
    g = float(np.float32(np.pi) * np.float32(1e-7))
    log2 = runlog.RunLog(root, "r2")
    log2.append([{"step": 0, "projected_grad": g}])
    log2.finalize()
    back = runlog.load_run("r2", root).steps[0]["projected_grad"]
    assert np.float32(back).tobytes() == np.float32(g).tobytes()


def test_run_resolution_and_ids(tmp_path):
    root = str(tmp_path)
    assert runlog.list_runs(root) == []
    with pytest.raises(FileNotFoundError, match="no run directories"):
        runlog.resolve_run(None, root)
    rid = runlog.make_run_id(root, seed=3, now=0.0)
    assert rid.endswith("-s3")
    assert rid == jrunlog.make_run_id(root, seed=3, now=0.0)
    runlog.RunLog(root, rid, spec={}).finalize()
    rid2 = runlog.make_run_id(root, seed=3, now=0.0)
    assert rid2 == f"{rid}-2"
    os.mkdir(os.path.join(root, "not-a-run"))
    assert runlog.list_runs(root) == [rid]
    assert runlog.resolve_run(None, root) == os.path.join(root, rid)
    assert runlog.resolve_run(rid, root) == os.path.join(root, rid)
    with pytest.raises(FileNotFoundError, match="known runs"):
        runlog.resolve_run("missing", root)


# ============================================== CLI: the train implication
def test_cli_train_implies_run_registry(monkeypatch):
    captured = []

    def fake_run(spec, device=None):
        captured.append(spec)
        return {"summary": {}, "spec": tapi.to_dict(spec), "history": {}}

    monkeypatch.setattr(tapi, "run", fake_run)
    cli.main(["train", "--preset", SMOKE])
    assert captured[-1].telemetry.runs_dir == runlog.DEFAULT_RUNS_DIR
    cli.main(["train", "--preset", SMOKE, "--no-runlog"])
    assert captured[-1].telemetry.runs_dir is None
    cli.main(["train", "--preset", SMOKE, "--runs-dir", "X"])
    assert captured[-1].telemetry.runs_dir == "X"
    cli.main(["train", "--preset", SMOKE, "--set", "telemetry.runs_dir=Y"])
    assert captured[-1].telemetry.runs_dir == "Y"
    cli.main(["train", "--preset", SMOKE, "--telemetry", "true",
              "--trace-jsonl", "t.jsonl", "--profile-dir", "p"])
    tel = captured[-1].telemetry
    assert (tel.enabled, tel.jsonl, tel.profile_dir) == (True, "t.jsonl", "p")


def test_cli_train_report_replay_end_to_end(tmp_path, monkeypatch, capsys):
    """``launch train --preset tiny-smoke --device cpu`` writes
    ``artifacts/runs/<run_id>/``; ``report`` and ``replay`` on it
    succeed, replay bit-exact."""
    monkeypatch.chdir(tmp_path)
    out = cli.main(["train", "--preset", SMOKE, "--device", "cpu",
                    "--steps", "3", "--telemetry", "true"])
    rid = out["summary"]["run_id"]
    assert os.path.isdir(os.path.join("artifacts", "runs", rid))
    assert cli.console(["report"]) == 0
    assert f"# Run report — `{rid}`" in capsys.readouterr().out
    assert cli.console(["replay", "--device", "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["ok"] and rep["run_id"] == rid and rep["step"] == 2


# ================================= end to end: train -> report -> replay
@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """One telemetry-on run of the port (two_point, materialized,
    checkpoints at 2 and 4), shared by the run-dir tests."""
    root = str(tmp_path_factory.mktemp("runs"))
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt") / "run")
    spec = _spec(**{
        "run.steps": 4, "run.log_every": 2, "run.eval_every": 0,
        "run.ckpt_every": 2, "run.ckpt_dir": ckpt_dir, "run.keep_ckpts": 4,
        "telemetry.enabled": True, "telemetry.runs_dir": root,
        "telemetry.health_norms": True})
    result = tapi.run(spec, device="cpu")
    return {"spec": spec, "result": result, "root": root,
            "ckpt_dir": ckpt_dir}


def test_run_dir_contents(trained_run):
    rd = runlog.load_run(None, trained_run["root"])
    assert rd.run_id == trained_run["result"]["summary"]["run_id"]
    assert rd.dir == trained_run["result"]["summary"]["run_dir"]
    for name in (runlog.SPEC_FILE, runlog.STEPS_FILE,
                 runlog.SUMMARY_FILE, runlog.TRACE_FILE):
        assert os.path.isfile(os.path.join(rd.dir, name)), name
    assert rd.spec == tapi.to_dict(trained_run["spec"])
    assert [r["step"] for r in rd.steps] == [0, 1, 2, 3]
    base = rng.fold_py(trained_run["spec"].run.seed, 0xC0FFEE)
    n_layers = len(rd.steps[0]["layer_sel"])
    for t, row in enumerate(rd.steps):
        assert row["seed"] == rng.fold_py(base, t)
        for key in ("loss", "eps", "lr", "g_mean", "g_var",
                    "update_norm", "update_norm_est"):
            assert key in row, key
        assert len(row["probe_grads"]) == len(row["coeffs"]) == 1
        assert len(row["n_active_params"]) == 1
        assert len(row["layer_sel"]) == n_layers
        assert row["active_layers"] == sum(row["layer_sel"])
        assert 1 <= row["active_layers"] < n_layers
        assert row["eps"] == float(np.float32(
            trained_run["spec"].optimizer.eps))
        assert row["lr"] == float(np.float32(
            trained_run["spec"].optimizer.lr))
        assert row["update_norm"] == pytest.approx(
            row["update_norm_est"], rel=0.05)


def test_run_summary_aggregates(trained_run):
    rd = runlog.load_run(None, trained_run["root"])
    s = rd.summary
    gs = [r["projected_grad"] for r in rd.steps]
    assert s["steps_recorded"] == 4 and s["last_step"] == 3
    assert s["g_count"] == 4
    assert s["g_mean"] == pytest.approx(np.mean(gs), rel=1e-9)
    assert s["g_var"] == pytest.approx(np.var(gs, ddof=1), rel=1e-9)
    assert s["loss_first"] == rd.steps[0]["loss"]
    assert s["loss_last"] == rd.steps[-1]["loss"]
    assert sum(s["layer_counts"]) == sum(r["active_layers"]
                                         for r in rd.steps)
    assert s["update_norm_est_last"] == rd.steps[-1]["update_norm_est"]


def test_run_id_lands_in_checkpoint_manifest(trained_run):
    from repro_torch.checkpoint.manager import CheckpointManager
    mgr = CheckpointManager(trained_run["ckpt_dir"])
    assert sorted(mgr.all_steps()) == [2, 4]
    extra = mgr.read_manifest()["extra"]
    assert extra["run_id"] == trained_run["result"]["summary"]["run_id"]


def test_report_renders_from_run_dir(trained_run, tmp_path):
    out = str(tmp_path / "r.md")
    rep = report_mod.report_run(None, runs_root=trained_run["root"],
                                out=out)
    md = rep["markdown"]
    for section in ("# Run report", "## Spec", "## Convergence",
                    "## Applied hyperparameters", "## LeZO layer coverage",
                    "## Stage timings"):
        assert section in md, section
    assert rep["run_id"] in md and "two_point" in md
    assert "| train/step | 4 |" in md and "| update_axpy | 4 |" in md
    assert rep["path"] == out
    for path in (out, os.path.join(rep["run_dir"], report_mod.REPORT_FILE)):
        with open(path) as f:
            assert f.read() == md


def test_port_run_dir_loads_and_renders_in_reference(trained_run):
    mine = runlog.load_run(None, trained_run["root"])
    theirs = jrunlog.load_run(None, trained_run["root"])
    assert (theirs.run_id, theirs.spec, theirs.steps, theirs.summary) == \
        (mine.run_id, mine.spec, mine.steps, mine.summary)
    assert jreport.render_report(theirs) == report_mod.render_report(mine)


def test_replay_verifies_run_bitwise(trained_run):
    rep = replay_mod.replay_run(None, runs_root=trained_run["root"],
                                device="cpu")
    assert rep["ok"], rep["failures"]
    assert rep["step"] == 3 and rep["estimator"] == "two_point"
    assert rep["device"] == "cpu"
    assert rep["param_start"] == 2            # newest checkpoint <= 3
    assert any("seed lineage" in c for c in rep["checks"])
    for key in ("loss", "projected_grad", "eps", "lr", "layer_sel"):
        assert key in rep["matched"], key
    rd = runlog.load_run(None, trained_run["root"])
    assert rep["matched"]["loss"] == rd.step_row(3)["loss"]
    # the re-executed parameters are the run's final ones, bit for bit
    want = trained_run["result"]["history"]["final_params"]
    for (n, a), (_, b) in zip(want.named_parameters(),
                              rep["final_params"].named_parameters()):
        assert torch.equal(a, b), n


def test_replay_detects_corruption(trained_run, tmp_path):
    """A flipped mantissa bit of a recorded g (and a broken seed lineage)
    fails the replay."""
    root = str(tmp_path / "runs")
    rd = runlog.load_run(None, trained_run["root"])
    dst = os.path.join(root, rd.run_id)
    shutil.copytree(rd.dir, dst)
    steps_path = os.path.join(dst, runlog.STEPS_FILE)
    rows = [json.loads(ln) for ln in open(steps_path)]
    for row in rows:
        if row.get("step") == 3:
            bits = np.float32(row["projected_grad"]).view(np.uint32)
            row["projected_grad"] = float(
                (bits ^ np.uint32(1)).view(np.float32))
        if row.get("step") == 0:
            row["seed"] = (row["seed"] + 1) & 0xFFFFFFFF
    with open(steps_path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    rep = replay_mod.replay_run(None, runs_root=root, device="cpu")
    assert not rep["ok"]
    assert any("seed lineage" in msg and "step 0" in msg
               for msg in rep["failures"]), rep["failures"]
    assert any("projected_grad" in msg and "step 3" in msg
               for msg in rep["failures"]), rep["failures"]
    assert not any("loss" in msg for msg in rep["failures"])
    assert cli.console(["replay", "--runs-root", root,
                        "--device", "cpu"]) == 1


@pytest.mark.parametrize("backend", ["materialized", "virtual"])
@pytest.mark.parametrize("est", ["two_point", "one_sided", "averaged",
                                 "importance"])
def test_replay_matrix(tmp_path, est, backend):
    """Bit-exact replay from step 0 across the estimators x forward
    backends (no checkpoints: parameters re-derive from the seed)."""
    ov = {"run.steps": 3, "run.log_every": 1, "run.eval_every": 0,
          "estimator.name": est, "runtime.forward_backend": backend,
          "telemetry.runs_dir": str(tmp_path)}
    if est in ("one_sided", "averaged"):
        ov["estimator.q"] = 2
    if backend == "virtual":
        ov["runtime.backend"] = "pallas"
    tapi.run(_spec(**ov), device="cpu")
    rep = replay_mod.replay_run(None, runs_root=str(tmp_path), device="cpu")
    assert rep["ok"], rep["failures"]
    assert rep["param_start"] == 0 and rep["step"] == 2
    assert rep["estimator"] == est and rep["forward_backend"] == backend


def test_resume_then_replay_across_checkpoint(tmp_path):
    """A resumed run's log starts mid-stream; replay rebuilds the resume
    point from the checkpoint (importance is stateful, so it re-warms
    from the run's own first step) and pins the parameters bitwise
    against a checkpoint inside the replayed range."""
    ckpt_dir = str(tmp_path / "ckpt")
    base = {"run.log_every": 1, "run.eval_every": 0, "run.ckpt_every": 2,
            "run.ckpt_dir": ckpt_dir, "run.keep_ckpts": 8,
            "estimator.name": "importance"}
    tapi.run(_spec(**base, **{"run.steps": 4, "telemetry.runs_dir":
                              str(tmp_path / "runs1")}), device="cpu")
    tapi.run(_spec(**base, **{"run.steps": 8, "telemetry.runs_dir":
                              str(tmp_path / "runs2")}), device="cpu")
    rd = runlog.load_run(None, str(tmp_path / "runs2"))
    assert rd.first_step == 4 and rd.last_step == 7
    rep = replay_mod.replay_run(None, step=7, device="cpu",
                                runs_root=str(tmp_path / "runs2"))
    assert rep["ok"], rep["failures"]
    assert rep["param_start"] == 4
    assert any("[6]" in c for c in rep["checks"]
               if "checkpoint" in c), rep["checks"]


# ======================================== the same spec in both packages
@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The reference and the port train one spec (3 steps, health norms
    on) from the reference's initial weights, each writing a run dir."""
    roots = {side: str(tmp_path_factory.mktemp(f"runs_{side}"))
             for side in ("jax", "torch")}
    spec = japi.with_overrides(japi.preset(SMOKE), {
        "run.steps": 3, "run.log_every": 1, "run.eval_every": 0,
        "telemetry.runs_dir": roots["jax"], "telemetry.health_norms": True})
    japi.run(spec)
    jp = jlm.init_params(japi.derive(spec).model_cfg,
                         jax.random.PRNGKey(spec.run.seed))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    tspec = tapi.with_overrides(tapi.from_json(japi.to_json(spec)),
                                {"telemetry.runs_dir": roots["torch"]})
    params = tlm.params_from_numpy(tapi.derive(tspec).model_cfg, flat,
                                   "cpu")
    tapi.run(tspec, device="cpu", params=params)
    return {side: runlog.load_run(None, r) for side, r in roots.items()}


def test_health_rows_match_reference(both_runs):
    mine, theirs = both_runs["torch"].steps, both_runs["jax"].steps
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        for key in ("step", "seed", "layer_sel", "active_layers"):
            assert a[key] == b[key], key
        for key in ("eps", "lr", "coeffs", "n_active_params"):
            assert key in a and key in b, key
        for key in ("loss", "projected_grad", "update_norm_est",
                    "update_norm"):
            np.testing.assert_allclose(a[key], b[key], rtol=LOSS_RTOL,
                                       err_msg=key)
    assert both_runs["torch"].summary["layer_counts"] == \
        both_runs["jax"].summary["layer_counts"]


def test_reference_run_dir_loads_and_renders_in_port(both_runs):
    theirs = both_runs["jax"]
    mine = runlog.load_run(theirs.dir)
    assert (mine.spec, mine.steps, mine.summary) == \
        (theirs.spec, theirs.steps, theirs.summary)
    assert tapi.from_dict(mine.spec) == tapi.from_json(
        json.dumps(theirs.spec))
    assert report_mod.render_report(mine) == jreport.render_report(theirs)

"""The port's swarm end to end, in processes: ``python -m
repro_torch.launch swarm --device cpu`` (a coordinator and its worker
processes, each worker started with ``--device cpu``) against the
single-process trainer (``api.run``) on the same spec — the scalar
stream and the final parameters (from the designated worker's
checkpoint) bit for bit, with 2 and with 4 workers.

The swarm runs as a subprocess with a time limit, so a broken worker
fails the test instead of hanging it; spawned processes run torch on
one thread (six test workers share the CPUs).  The coordinator's first
step waits until every worker the driver started has attached, so each
worker joins at step 0 however slowly its process starts.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import api
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import zo

torch.set_num_threads(2)              # six xdist workers share the CPUs

ROOT = pathlib.Path(__file__).resolve().parents[1]
STREAM_KEYS = ("loss", "projected_grad", "seed", "arrived", "shard_losses",
               "active_layers", "layer_sel")
SWARM_TIMEOUT_S = 240


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    return env


def _spec(tmp, **over):
    """``swarm-smoke`` with the run directory and checkpoints in ``tmp``."""
    over = {"run.steps": 10, "run.ckpt_every": 5,
            "run.ckpt_dir": str(tmp / "ckpt"),
            "telemetry.runs_dir": str(tmp / "runs"), **over}
    return api.with_overrides(api.preset("swarm-smoke"), over), over


def _run_swarm(tmp, **over):
    """The CLI's ``swarm`` in a subprocess; its summary."""
    tmp.mkdir(parents=True, exist_ok=True)
    spec, over = _spec(tmp, **over)
    cmd = [sys.executable, "-m", "repro_torch.launch", "swarm",
           "--preset", "swarm-smoke", "--device", "cpu",
           "--out", str(tmp / "summary.json")]
    for k, v in over.items():
        cmd += ["--set", f"{k}={v}"]
    out = subprocess.run(cmd, env=_env(), cwd=tmp, capture_output=True,
                         text=True, timeout=SWARM_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(tmp / "summary.json") as f:
        saved = json.load(f)
    assert saved["spec"] == api.to_dict(spec)
    return saved["summary"]


def _rows(runs_root):
    (run_dir,) = [d for d in pathlib.Path(runs_root).iterdir() if d.is_dir()]
    with open(run_dir / "steps.jsonl") as f:
        return run_dir, [json.loads(line) for line in f]


def _stream(rows):
    return [[r.get(k) for k in STREAM_KEYS] for r in rows]


def _bits(params):
    return {p: (t.detach().view(torch.int16) if t.dtype == torch.bfloat16
                else t.detach()).clone()
            for p, t in zo.leaf_items(params)}


def _single_process(tmp, **over):
    tmp.mkdir(parents=True, exist_ok=True)
    spec, _ = _spec(tmp, **over)
    hist = api.run(spec, device="cpu")["history"]
    return hist, _rows(tmp / "runs")[1]


@pytest.mark.parametrize("over", [
    {},                                                # 2 workers, 2 shards
    {"runtime.backend": "pallas", "runtime.forward_backend": "virtual"},
    {"swarm.workers": 4, "swarm.n_shards": 4},
], ids=["2-workers", "2-workers-virtual", "4-workers"])
def test_swarm_bit_identical_to_single_process(tmp_path, over):
    """swarm(N workers) == single-process trainer on the same spec —
    scalar stream and final parameters, to the bit."""
    summary = _run_swarm(tmp_path / "sw", **over)
    _, rows_sw = _rows(tmp_path / "sw" / "runs")
    hist, rows_sp = _single_process(tmp_path / "sp", **over)
    n = api.preset("swarm-smoke").swarm.workers if "swarm.workers" not in \
        over else over["swarm.workers"]
    assert summary["worker_exits"] == [0] * n, summary
    assert summary["respawns"] == 0 and summary["steps"] == 10
    assert 0 < summary["steady_bytes_per_step"] < 2048
    results = summary["worker_results"]
    assert all(r["device"] == "cpu" and r["joined"]
               and r["restored_step"] == r["folded"] == 0
               and r["steps_applied"] == 10 for r in results), results
    assert len(rows_sw) == len(rows_sp) == 10
    assert _stream(rows_sw) == _stream(rows_sp)
    # the designated worker's checkpoint holds the single process's bits
    ck = CheckpointManager(str(tmp_path / "sw" / "ckpt"))
    final = _bits(hist["final_params"])
    got, step, _, _ = ck.restore(hist["final_params"])
    assert step == 10
    got = _bits(got)
    assert all(torch.equal(got[p], final[p]) for p in final)


def test_coordinator_gauges_in_the_metrics_dump(tmp_path):
    """The coordinator publishes the ``swarm_*`` gauges on its telemetry
    session's registry (the Prometheus dump at the end of the run)."""
    prom = tmp_path / "swarm.prom"
    summary = _run_swarm(tmp_path, **{"telemetry.enabled": True,
                                      "telemetry.prometheus": str(prom)})
    vals = {}
    for line in prom.read_text().splitlines():
        if line and not line.startswith("#"):
            name, val = line.split()
            vals[name] = float(val)
    assert vals["swarm_epoch"] == summary["membership_epochs"] >= 2
    assert vals["swarm_live_workers"] == 2
    assert vals["swarm_straggler_steps"] == summary["straggler_steps"] == 0
    assert vals["swarm_bytes_per_step"] > 0


def test_worker_without_card_fails(tmp_path):
    """A worker asked for the card where there is none exits non-zero
    before it attaches — no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "swarm", "--attach",
         "127.0.0.1:9", "--device", "cuda"], env=_env(), cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA is not available" in out.stderr

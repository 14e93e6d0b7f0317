"""The port's swarm under injected faults, in processes (``python -m
repro_torch.launch swarm --device cpu``): a worker hard-crashed at step
3 is respawned, rejoins by folding the committed ``(seed, g)`` log (or
from a checkpoint) and not one committed bit differs from the calm run,
which ``launch replay`` then re-executes bit for bit; and a partitioned
worker forces quorum-degraded commits whose recorded ``arrived`` mask
replays exactly.
"""
import numpy as np
import torch

from repro_torch.launch import replay
from repro_torch.swarm import chaos as chaos_mod
from test_torch_swarm_e2e import _rows, _run_swarm, _stream

torch.set_num_threads(2)              # six xdist workers share the CPUs


def test_crash_rejoin_equals_calm_and_replays(tmp_path):
    """One injected hard crash: the epoch bumps, shards reassign, the
    respawned worker rejoins elastically, and not one committed bit
    differs from a calm run.  The step after the crash waits for the
    respawned process to attach, so it is admitted at step 3 or 4 and
    folds the commits made by the time it fetches them: 3 to 5 (a
    checkpoint at step 10 comes later)."""
    over = {"run.steps": 30, "run.ckpt_every": 10, "swarm.chaos_seed": 7}
    _run_swarm(tmp_path / "calm", **over)
    _, rows_calm = _rows(tmp_path / "calm" / "runs")
    summary = _run_swarm(tmp_path / "chaos", **over,
                         **{"swarm.chaos_crash": "1:3"})
    run_dir, rows_chaos = _rows(tmp_path / "chaos" / "runs")
    assert summary["worker_exits"].count(chaos_mod.CRASH_EXIT) == 1
    assert summary["respawns"] == 1
    assert summary["membership_epochs"] >= 3   # 2 joins + death (+ rejoin)
    rejoined = [r for r in summary["worker_results"]
                if r and r["joined"] and r["worker_id"] >= 2]
    assert rejoined and rejoined[0]["restored_step"] == 0, \
        summary["worker_results"]
    assert 3 <= rejoined[0]["folded"] <= 5, summary["worker_results"]
    assert rejoined[0]["steps_applied"] == 30
    assert len(rows_chaos) == 30
    assert _stream(rows_chaos) == _stream(rows_calm)
    out = replay.replay_run(str(run_dir), device="cpu")
    assert out["ok"], out["failures"]


def test_quorum_degraded_run_replays(tmp_path):
    """A partitioned worker forces deadline commits from a partial shard
    set; the recorded ``arrived`` mask makes the run replayable anyway."""
    _run_swarm(tmp_path, **{
        "swarm.n_shards": 4, "swarm.quorum": 0.5,
        "swarm.step_deadline_s": 1.0,
        "swarm.chaos_seed": 7, "swarm.chaos_partition": "1:2-6"})
    run_dir, rows = _rows(tmp_path / "runs")
    degraded = [r for r in rows if 0 in (r.get("arrived") or [])]
    assert degraded, "partition produced no quorum-degraded step"
    for r in degraded:
        assert len(r["shard_losses"]) == sum(r["arrived"]) >= 2
    out = replay.replay_run(str(run_dir), device="cpu")
    assert out["ok"], out["failures"]
    assert np.array_equal(out["matched"]["arrived"], rows[-1]["arrived"])

"""The port's swarm (``repro_torch.swarm``) against the JAX package's
(``repro.swarm``) in one process, and the bit-identity contracts the
reference pins, within the port.

Against the reference, on the same inputs (numpy, from a seed):
``commit``, ``proto`` and ``chaos`` give the same bits and bytes; both
validators accept and reject the same swarm specs at the same field;
``SelectionOracle.metrics`` gives equal integers and float32 bits; a
shard's ``(l+, l-)`` on the same parameter arrays is within rtol 1e-5
of the reference's (``tests/test_torch_step.py``'s probe-loss
tolerance); the reference's g fed to the port's ``apply_commit`` gives
parameters within rtol 1e-6, atol 1e-9 of the reference's
(``tests/test_torch_zo.py``'s axpy tolerance); and a 10-step
single-process sharded run records the reference's integer fields
exactly, its losses within rtol 1e-3 (``tests/test_torch_api.py``'s
trajectory band) and its g within 8 ulps of the loss over 2 eps.

Within the port: a probe leaves the parameters bit-equal on every
forward backend; the commit cannot see arrival order or a duplicate;
one process playing 1, 2 or 4 workers over 4 shards commits the
single-process trainer's rows bit for bit; and the coordinator's first
step waits for every worker it expects.
"""
import dataclasses
import json
import pathlib
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import zo as jzo
from repro.swarm import chaos as jchaos
from repro.swarm import commit as jcommit
from repro.swarm import proto as jproto
from repro.swarm import shardstep as jss
from repro.swarm.coordinator import StepLedger as JStepLedger
from repro.train.trainer import Trainer as JTrainer
from repro_torch import api as tapi
from repro_torch.api.validate import swarm_active, swarm_shards
from repro_torch.core import rng as trng
from repro_torch.core import zo as tzo
from repro_torch.models import lm as tlm
from repro_torch.swarm import chaos as tchaos
from repro_torch.swarm import commit as tcommit
from repro_torch.swarm import proto as tproto
from repro_torch.swarm import shardstep as tss
from repro_torch.swarm.coordinator import StepLedger as TStepLedger
from repro_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(2)              # six xdist workers share the CPUs

PROBE_RTOL = 1e-5                     # tests/test_torch_step.py
AXPY_RTOL, AXPY_ATOL = 1e-6, 1e-9     # tests/test_torch_zo.py
LOSS_RTOL = 1e-3                      # tests/test_torch_api.py
G_LOSS_ULPS = 8                       # g's band in ulps of the loss / 2 eps
BACKENDS = [
    # (port overrides, reference overrides): the reference's CPU default,
    # and the port's virtual forward (plain versions on the CPU) against
    # the reference's virtual_ref
    ({}, {}),
    ({"runtime.backend": "pallas", "runtime.forward_backend": "virtual"},
     {"runtime.forward_backend": "virtual_ref"}),
]


def _f32_bits(x):
    return np.asarray(x, np.float32).tobytes()


# ====================================================== commit / proto
def _seeded_pairs(seed, n, gaps):
    r = np.random.default_rng(seed)
    vals = r.uniform(1.0, 9.0, size=(n, 2)).astype(np.float32)
    return [None if i in gaps else (float(vals[i, 0]), float(vals[i, 1]))
            for i in range(n)]


@pytest.mark.parametrize("seed,n,gaps", [
    (0, 1, ()), (1, 2, ()), (2, 4, (1,)), (3, 8, (0, 5, 7)),
    (4, 16, (3, 4, 9, 15)), (5, 5, (0, 1, 2, 3))])
def test_commit_bit_identical_to_reference(seed, n, gaps):
    pairs = _seeded_pairs(seed, n, set(gaps))
    for eps in (1e-3, 1e-2, 3e-4):
        got = tcommit.commit_scalars(pairs, eps)
        want = jcommit.commit_scalars(pairs, eps)
        assert got["arrived"] == want["arrived"]
        for k in ("l_plus", "l_minus", "loss", "projected_grad"):
            assert _f32_bits(got[k]) == _f32_bits(want[k]), (k, eps)
    assert tcommit.shard_losses_dict(pairs) == \
        jcommit.shard_losses_dict(pairs)
    for q in (0.25, 0.5, 0.75, 1.0):
        assert tcommit.quorum_count(n, q) == jcommit.quorum_count(n, q)
    with pytest.raises(ValueError):
        tcommit.reduce_losses([None] * n)


def test_proto_bytes_identical_to_reference():
    r = np.random.default_rng(7)
    for i in range(20):
        losses = {str(s): [float(np.float32(v)) for v in r.uniform(2, 6, 2)]
                  for s in sorted(r.choice(8, size=1 + i % 4,
                                           replace=False))}
        kw = dict(run_id=f"r{i}", membership_epoch=int(r.integers(0, 9)),
                  step=i, seed=int(r.integers(0, 2 ** 32)),
                  shard_losses=losses, worker_id=i % 3)
        arrived = [int(x) for x in r.integers(0, 2, 4)]
        cm = dict(step=i, seed=kw["seed"], g=float(np.float32(r.normal())),
                  loss=float(np.float32(r.uniform(2, 6))),
                  active_layers=int(r.integers(1, 40)),
                  membership_epoch=kw["membership_epoch"], arrived=arrived,
                  ckpt_worker=int(r.integers(-1, 3)))
        for t_msg, j_msg in (
                (tproto.StepContribution(**kw).to_wire(),
                 jproto.StepContribution(**kw).to_wire()),
                (tproto.StepCommit(**cm).to_wire(),
                 jproto.StepCommit(**cm).to_wire())):
            assert tproto.encode(t_msg) == jproto.encode(j_msg)
    for msg in ({"type": "hello", "last_step": -1}, {"type": "bye"},
                {"type": "fetch", "from_step": 3},
                {"type": "done", "summary": {"steps": 2}}):
        assert tproto.encode(msg) == jproto.encode(msg)
    assert tproto.MESSAGE_TYPES == jproto.MESSAGE_TYPES
    assert tproto.MAX_FRAME == jproto.MAX_FRAME


def test_proto_framing_roundtrip_timeout_and_eof():
    a, b = (tproto.Conn(s) for s in socket.socketpair())
    c = tproto.StepContribution(
        run_id="r1", membership_epoch=3, step=7, seed=123456789,
        shard_losses={"0": [4.25, 4.5], "2": [3.75, 4.0]}, worker_id=1)
    a.send(c.to_wire())
    assert tproto.StepContribution.from_wire(b.recv(timeout=5.0)) == c
    frame = tproto.encode({"type": "bye"})
    a.sock.sendall(frame[:3])               # half a length prefix
    with pytest.raises(socket.timeout):
        b.recv(timeout=0.05)
    a.sock.sendall(frame[3:])
    assert b.recv(timeout=5.0) == {"type": "bye"}
    assert b.bytes_recv == a.bytes_sent + len(frame) and b.msgs_recv == 2
    with pytest.raises(tproto.ProtocolError):
        tproto.encode({"type": "gossip"})
    a.close()
    assert b.recv(timeout=5.0) is None
    b.close()


# =============================================================== chaos
def test_chaos_schedules_identical_to_reference():
    for seed in (0, 7, 123):
        kw = dict(seed=seed, drop=0.35, delay_ms=3.0, crashes=((1, 4),),
                  partitions=((0, 2, 5), (2, 9, 9)))
        for wid in range(4):
            a = tchaos.Chaos(tchaos.ChaosConfig(**kw), wid)
            b = jchaos.Chaos(jchaos.ChaosConfig(**kw), wid)
            for kind in ("contribution", "commit"):
                for t in range(12):
                    for at in range(3):
                        assert a.drop(kind, t, at) == b.drop(kind, t, at)
                        assert a.delay_s(kind, t, at) == b.delay_s(kind, t,
                                                                   at)
                assert [a.crash_point(t) for t in range(12)] == \
                    [b.crash_point(t) for t in range(12)]
    assert tchaos.CRASH_EXIT == jchaos.CRASH_EXIT == 43


@pytest.mark.parametrize("text", ["", "1:4", "1:4,0:9", " 2:0 , 3:11 ",
                                  "1", "1:", "a:4", "1:4:9", "-1:2"])
def test_chaos_crash_parser_matches_reference(text):
    def run(mod):
        try:
            return mod.parse_crashes(text)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(tchaos) == run(jchaos)


@pytest.mark.parametrize("text", ["", "1:3-5", "0:2-2,1:0-9", "1:3",
                                  "1:5-3", "x:1-2", "1:a-b"])
def test_chaos_partition_parser_matches_reference(text):
    def run(mod):
        try:
            return mod.parse_partitions(text)
        except ValueError as e:
            return ("ValueError", str(e))
    assert run(tchaos) == run(jchaos)


# ========================================================== spec layer
SPEC_CASES = [
    {}, {"swarm.workers": 4}, {"swarm.n_shards": 4},
    {"swarm.n_shards": 4, "swarm.quorum": 0.5},
    {"swarm.chaos_crash": "1:3", "swarm.chaos_seed": 7},
    {"swarm.quorum": 1.5}, {"swarm.quorum": 0.0},
    {"run.batch_size": 5}, {"optimizer.mode": "fo"},
    {"estimator.name": "one_sided"}, {"runtime.n_loss_shards": 4},
    {"swarm.chaos_crash": "nope"}, {"swarm.chaos_partition": "1:9-3"},
    {"swarm.chaos_drop": 1.0}, {"swarm.step_deadline_s": 0.0},
    {"swarm.port": 70000}, {"swarm.chaos_delay_ms": -1.0},
    {"swarm.n_shards": 2, "swarm.workers": 4},
    {"swarm.workers": -1}, {"swarm.n_shards": -2},
]


@pytest.mark.parametrize("override", SPEC_CASES)
def test_swarm_validation_matches_reference(override):
    base = "swarm-smoke"

    def run(api):
        try:
            api.validate(api.with_overrides(api.preset(base), override))
            return None
        except api.SpecError as e:
            return e.path
    assert run(tapi) == run(japi)


def test_swarm_shards_derivation():
    base = tapi.preset("swarm-smoke")
    assert swarm_active(base)
    assert not swarm_active(tapi.preset("tiny-smoke"))
    assert swarm_shards(base) == 2
    assert swarm_shards(tapi.with_overrides(base, {"swarm.n_shards": 4})) == 4


# ============================================== the sharded step itself
def _spec_pair(t_over=None, j_over=None, **common):
    common = {"run.steps": 10, **common}
    js = japi.with_overrides(japi.preset("swarm-smoke"),
                             {**common, **(j_over or {})})
    ts = tapi.with_overrides(tapi.from_json(japi.to_json(
        japi.preset("swarm-smoke"))), {**common, **(t_over or {})})
    return ts, js


def _flat(tree):
    return {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _trainers(t_over=None, j_over=None, **common):
    """The reference's trainer and the port's on the reference's
    initial parameter arrays."""
    ts, js = _spec_pair(t_over, j_over, **common)
    jtr = JTrainer.from_spec(js)
    params = tlm.params_from_numpy(tapi.derive(ts).model_cfg,
                                   _flat(jtr.trainable), "cpu")
    ttr = TTrainer.from_spec(ts, device="cpu", params=params)
    assert getattr(jtr._step, "sharded", False)
    assert getattr(ttr._step, "sharded", False) and ttr.state == {}
    return ttr, jtr


def _batch(trainer, n=8, seed=3):
    data = trainer.make_dataset(64)
    idx = np.random.default_rng(seed).integers(0, 64, n)
    return {k: data[k][idx] for k in ("tokens", "labels", "loss_mask")}


@pytest.mark.parametrize("seed", [0, 1, 77, 2 ** 31 + 5, 4294967295])
def test_selection_oracle_bit_identical_to_reference(seed):
    ts, js = _spec_pair(**{"model.variant": "bench"})
    got = tss.SelectionOracle(ts, device="cpu").metrics(seed)
    want = jss.SelectionOracle(js).metrics(seed)
    assert int(got["active_layers"]) == int(want["active_layers"])
    assert np.array_equal(got["layer_sel"], np.asarray(want["layer_sel"]))
    assert _f32_bits(got["n_active_params"]) == \
        _f32_bits(want["n_active_params"])
    assert tss.trainable_param_count(ts) == jss.trainable_param_count(js)


@pytest.mark.parametrize("runtime", ["lora", "prefix"])
def test_selection_oracle_peft_trees_match_reference(runtime):
    ts, js = _spec_pair(**{"runtime.peft": runtime})
    t, j = tss.SelectionOracle(ts, device="cpu"), jss.SelectionOracle(js)
    assert t.num_layers == j.num_layers
    for seed in (3, 99):
        a, b = t.metrics(seed), j.metrics(seed)
        assert np.array_equal(a["layer_sel"], np.asarray(b["layer_sel"]))
        assert _f32_bits(a["n_active_params"]) == \
            _f32_bits(b["n_active_params"])


def test_oracle_holds_no_parameters_at_13b():
    """The coordinator's oracle at OPT-13B's full width builds on the meta
    device: no storage, and the selection and counts of the real tree."""
    spec = tapi.with_overrides(tapi.preset("lezo-opt13b"), {
        "model.variant": "full", "swarm.workers": 2})
    tr, _, d = tss.abstract_trainable(spec)
    leaves = tzo.leaf_items(tr)
    assert all(t.device.type == "meta" for _, t in leaves)
    assert tss.trainable_param_count(spec) == 12_851_619_840
    o = tss.SelectionOracle(spec, device="cpu")
    m = o.metrics(trng.fold_py(trng.fold_py(0, 0xC0FFEE), 0))
    assert o.num_layers == 40 and int(m["active_layers"]) == 10
    assert int(np.sum(m["layer_sel"])) == 10


@pytest.mark.parametrize("backends", BACKENDS, ids=["materialized",
                                                    "virtual"])
def test_probe_shard_matches_reference(backends):
    ttr, jtr = _trainers(*backends)
    batch = _batch(ttr)
    tshards = tss.shard_batch(ttr._model_batch(batch), 2)
    jshards = jss.shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                              2)
    for seed in (5, 123456):
        for ts_, js_ in zip(tshards, jshards):
            got = ttr._step.probe_shard(ttr.params, ts_, seed)
            want = jtr._step.probe_shard(jtr.trainable, js_, seed)
            assert got.dtype == np.float32 and got.shape == (2,)
            np.testing.assert_allclose(got, want, rtol=PROBE_RTOL)


@pytest.mark.parametrize("backends", BACKENDS, ids=["materialized",
                                                    "virtual"])
def test_teacher_forced_commit_matches_reference(backends):
    """The reference's g for a step, folded by the port's apply_commit,
    with decay 1 - lr·wd = 0.999 as in tests/test_torch_zo.py (so the
    decay path runs too) and |lr·g| of that test's order (its scale is
    3e-3)."""
    ttr, jtr = _trainers(*backends, **{"optimizer.weight_decay": 10.0})
    batch = {k: jnp.asarray(v) for k, v in _batch(ttr).items()}
    jp, _, jm = jtr._step(jtr.trainable, {}, batch, jnp.int32(3),
                          jnp.uint32(77))
    seed = trng.fold_py(77, 3)
    assert abs(1e-4 * float(jm["projected_grad"])) < 1e-2
    ttr._step.apply_commit(ttr.params, seed, np.float32(jm["projected_grad"]))
    got, want = tlm.params_to_numpy(ttr.params), _flat(jp)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w, np.float32),
                                   rtol=AXPY_RTOL, atol=AXPY_ATOL,
                                   err_msg=k)


def _rows(runs_root):
    (run_dir,) = [d for d in pathlib.Path(runs_root).iterdir() if d.is_dir()]
    with open(run_dir / "steps.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("backends", BACKENDS, ids=["materialized",
                                                    "virtual"])
def test_ten_step_sharded_run_matches_reference(backends, tmp_path):
    """10 steps of the single-process sharded trainer in both packages
    from the same weights: seed, arrived, active_layers and layer_sel
    equal; loss within the trajectory band, and g = (l+ - l-) / 2 eps
    within ``G_LOSS_ULPS`` float32 ulps of the loss over 2 eps (the g
    that two losses a few ulps apart give)."""
    t_over, j_over = backends
    ts, js = _spec_pair(t_over, j_over, **{"swarm.n_shards": 4})
    js = dataclasses.replace(js, telemetry=dataclasses.replace(
        js.telemetry, runs_dir=str(tmp_path / "j")))
    ts = dataclasses.replace(ts, telemetry=dataclasses.replace(
        ts.telemetry, runs_dir=str(tmp_path / "t")))
    japi.run(js)
    flat = _flat(JTrainer.from_spec(dataclasses.replace(
        js, telemetry=japi.Telemetry())).trainable)
    params = tlm.params_from_numpy(tapi.derive(ts).model_cfg, flat, "cpu")
    tapi.run(ts, device="cpu", params=params)
    jrows, trows = _rows(tmp_path / "j"), _rows(tmp_path / "t")
    assert len(jrows) == len(trows) == 10
    for a, b in zip(trows, jrows):
        for k in ("step", "seed", "arrived", "active_layers", "layer_sel"):
            assert a[k] == b[k], (a["step"], k)
        assert sorted(a["shard_losses"]) == sorted(b["shard_losses"])
    np.testing.assert_allclose([r["loss"] for r in trows],
                               [r["loss"] for r in jrows], rtol=LOSS_RTOL)
    ulp = np.spacing(np.float32(max(r["loss"] for r in jrows)))
    np.testing.assert_allclose(
        [r["projected_grad"] for r in trows],
        [r["projected_grad"] for r in jrows], rtol=0,
        atol=G_LOSS_ULPS * ulp / (2 * ts.optimizer.eps))


@pytest.mark.parametrize("edit", ["shard_losses", "arrived", "none"])
def test_replay_checks_the_swarm_rows(tmp_path, edit):
    """``launch replay`` of a single-process sharded run: ok as recorded;
    a flipped bit in one shard's loss fails, and so does a changed quorum
    mask, with which the step is re-executed: it reduces another shard
    set than the recorded losses."""
    from repro_torch.launch import replay
    spec = tapi.with_overrides(tapi.preset("swarm-smoke"), {
        "run.steps": 4, "swarm.n_shards": 4,
        "telemetry.runs_dir": str(tmp_path)})
    tapi.run(spec, device="cpu")
    (steps,) = list(tmp_path.glob("*/steps.jsonl"))
    rows = [json.loads(line) for line in steps.read_text().splitlines()]
    if edit == "shard_losses":
        v = np.float32(rows[2]["shard_losses"]["1"][0])
        rows[2]["shard_losses"]["1"][0] = float(
            (v.view(np.uint32) ^ np.uint32(1)).view(np.float32))
    elif edit == "arrived":
        rows[2]["arrived"] = [1, 0, 1, 1]
    steps.write_text("".join(json.dumps(r) + "\n" for r in rows))
    out = replay.replay_run(str(steps.parent), device="cpu")
    if edit == "none":
        assert out["ok"] and out["matched"]["arrived"] == [1, 1, 1, 1]
        return
    want = ("step 2 shard_losses[1]" if edit == "shard_losses"
            else "step 2 shard_losses: recorded shards")
    assert not out["ok"]
    assert any(f.startswith(want) for f in out["failures"]), out["failures"]


# ================================================ within the port: bits
def _bits(params):
    return {p: (t.detach().view(torch.int16) if t.dtype == torch.bfloat16
                else t.detach()).clone()
            for p, t in tzo.leaf_items(params)}


@pytest.mark.parametrize("overrides", [
    {},                                                # materialized, scan
    {"runtime.backend": "pallas"},                     # materialized, K1
    {"runtime.backend": "dense", "optimizer.policy": "uniform"},
    {"runtime.backend": "pallas", "runtime.forward_backend": "virtual"},
    {"runtime.forward_backend": "virtual", "runtime.paired_probes": False},
    {"runtime.forward_backend": "virtual_ref"},
], ids=["mat-scan", "mat-pallas", "mat-uniform", "virtual-paired",
        "virtual-unpaired", "virtual_ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probe_leaves_params_bit_equal(overrides, dtype):
    """A probe never changes θ, not by an ulp: what elastic join rests
    on (a rejoining worker never probes, it only folds commits)."""
    spec = tapi.with_overrides(tapi.preset("swarm-smoke"), overrides)
    cfg = tapi.derive(spec).model_cfg.with_(dtype=dtype)
    params = tlm.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    tr = TTrainer.from_spec(spec, device="cpu", params=params)
    shards = tss.shard_batch(tr._model_batch(_batch(tr)), 2)
    before = _bits(tr.params)
    for seed in (11, 12, 13):
        for sh in shards:
            tr._step.probe_shard(tr.params, sh, seed)
    after = _bits(tr.params)
    assert all(torch.equal(before[p], after[p]) for p in before)


def _contrib(i, shards, losses):
    return tproto.StepContribution(
        run_id="r", membership_epoch=1, step=0, seed=99,
        shard_losses={str(s): losses[s] for s in shards}, worker_id=i)


def test_ledger_arrival_order_and_duplicates_match_reference():
    r = np.random.default_rng(11)
    losses = {s: [float(np.float32(v)) for v in r.uniform(2, 6, 2)]
              for s in range(4)}
    base = None
    for order in ([0, 1, 2, 3], [3, 2, 1, 0], [1, 3, 0, 2], [2, 0, 3, 1],
                  [0, 0, 1, 2, 2, 3, 3]):
        t, j = TStepLedger("r", 0, 99, 1, 4), JStepLedger("r", 0, 99, 1, 4)
        for i, s in enumerate(order):
            assert t.add(_contrib(i, [s], losses), 1) == "ok"
            j.add(jproto.StepContribution(**dataclasses.asdict(
                _contrib(i, [s], losses))), 1)
        got = t.commit(1e-3)
        want = j.commit(1e-3)
        if base is None:
            base = got
        for k in ("l_plus", "l_minus", "loss", "projected_grad"):
            assert _f32_bits(got[k]) == _f32_bits(base[k]), (order, k)
            assert _f32_bits(got[k]) == _f32_bits(want[k]), (order, k)
        assert got["arrived"] == base["arrived"] == [1, 1, 1, 1]


def test_ledger_rejects_stale_epoch_step_and_foreign_run():
    led = TStepLedger("r", 5, 99, 3, 2)

    def mk(**kw):
        return tproto.StepContribution(**{
            "run_id": "r", "membership_epoch": 3, "step": 5, "seed": 99,
            "shard_losses": {"0": [1.0, 2.0]}, **kw})
    assert led.add(mk(membership_epoch=2), 3) == "stale_epoch"
    assert led.add(mk(step=4), 3) == "stale_step"
    assert led.add(mk(run_id="other"), 3) == "run_id"
    assert led.add(mk(shard_losses={"7": [1.0, 2.0]}), 3) == "bad_shard"
    assert led.n_arrived == 0 and sum(led.rejected.values()) == 4
    assert led.add(mk(), 3) == "ok" and led.missing() == [1]


@pytest.mark.parametrize("overrides", [
    {}, {"runtime.backend": "pallas", "runtime.forward_backend": "virtual"}])
def test_worker_assignments_commit_the_trainers_rows(overrides):
    """One process playing 1, 2 and 4 workers over 4 shards (each worker
    its own parameters, probing its round-robin shards, contributions
    into the ledger in reverse order, every worker folding each commit)
    commits the rows of the single-process sharded trainer bit for bit,
    and every worker ends with the trainer's parameters."""
    spec = tapi.with_overrides(tapi.preset("swarm-smoke"), {
        "swarm.n_shards": 4, "swarm.workers": 0, "run.steps": 5,
        **overrides})
    ref = TTrainer.from_spec(spec, device="cpu")
    data = ref.make_dataset(4096)
    from repro_torch.data import synthetic
    batches = [ref._model_batch({k: v for k, v in b.items()
                                 if k in ("tokens", "labels", "loss_mask")})
               for b in synthetic.batches(data, 8, 5, seed=7)]
    base = trng.fold_py(0, 0xC0FFEE)
    want = []
    for t, b in enumerate(batches):
        _, _, m = ref._step(ref.params, {}, b, t, base)
        want.append((_f32_bits(m["projected_grad"]), _f32_bits(m["loss"]),
                     m["arrived"].tolist(), m["shard_losses"]))
    final = _bits(ref.params)
    for n_workers in (1, 2, 4):
        workers = [TTrainer.from_spec(spec, device="cpu")
                   for _ in range(n_workers)]
        got = []
        for t, b in enumerate(batches):
            seed = trng.fold_py(base, t)
            shards = tss.shard_batch(b, 4)
            led = TStepLedger("r", t, seed, 1, 4)
            contribs = []
            for w, tr in enumerate(workers):
                mine = [s for s in range(4) if s % n_workers == w]
                contribs.append(tproto.StepContribution(
                    run_id="r", membership_epoch=1, step=t, seed=seed,
                    shard_losses={str(s): [float(v) for v in
                                           tr._step.probe_shard(
                                               tr.params, shards[s], seed)]
                                  for s in mine}, worker_id=w))
            for c in reversed(contribs):
                assert led.add(c, 1) == "ok"
            scal = led.commit(spec.optimizer.eps)
            for tr in workers:
                tr._step.apply_commit(tr.params, seed,
                                      scal["projected_grad"])
            got.append((_f32_bits(scal["projected_grad"]),
                        _f32_bits(scal["loss"]), scal["arrived"],
                        tcommit.shard_losses_dict(led.pairs)))
        assert got == want, n_workers
        for tr in workers:
            b = _bits(tr.params)
            assert all(torch.equal(b[p], final[p]) for p in final)


def test_first_step_waits_for_every_expected_worker(tmp_path):
    """With ``expected = 2`` (what ``driver.run_swarm`` sets for two
    workers) the first step waits for a worker that attaches 1.5 s after
    the other: both join at step 0, fold nothing and apply every step
    (without the wait a 4-step run is over before the second attaches)."""
    from repro_torch.swarm.coordinator import Coordinator
    from repro_torch.swarm.worker import Worker
    spec = tapi.with_overrides(tapi.preset("swarm-smoke"), {
        "run.steps": 4, "telemetry.runs_dir": str(tmp_path)})
    coord = Coordinator(spec, device="cpu")
    coord.expected = 2
    results = [None, None]

    def work(i, delay_s):
        time.sleep(delay_s)
        results[i] = Worker(coord.host, coord.port, device="cpu").run()

    threads = [threading.Thread(target=work, args=(i, d), daemon=True)
               for i, d in enumerate((0.0, 1.5))]
    for th in threads:
        th.start()
    summary = coord.serve()
    for th in threads:
        th.join(timeout=60)
    assert summary["workers_seen"] == 2 and summary["straggler_steps"] == 0
    for r in results:
        assert r is not None and r["joined"], results
        assert (r["restored_step"], r["folded"], r["steps_applied"]) == \
            (0, 0, 4), results

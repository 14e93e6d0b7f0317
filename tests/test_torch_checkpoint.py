"""The port's checkpoints: the reference's ``arrays.npz`` + manifest
format, keep-k GC, asynchronous save, no partial checkpoint on disk,
shape and leaf mismatches rejected; a checkpoint written by the JAX
package restores into the port bit for bit and the reverse; and resume
replays the uninterrupted run bit for bit (a port of
``tests/test_trainer_resume.py``).  Everything here is exact: no
tolerance.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro.configs import opt as jopt
from repro_torch import api as tapi
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import opt as topt
from repro_torch.models import lm as tlm

torch.set_num_threads(2)              # six xdist workers share the CPUs

CFG = topt.opt_tiny(layers=2, d_model=32, vocab=64)


def _params(seed=0, dtype="float32"):
    cfg = CFG.with_(dtype=dtype)
    return tlm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")


def _bits(params):
    return {n: p.detach().view(torch.int16 if p.dtype == torch.bfloat16
                               else torch.int32).clone()
            for n, p in params.named_parameters()}


def _assert_same(a, b):
    ba, bb = _bits(a), _bits(b)
    assert ba.keys() == bb.keys()
    for k in ba:
        assert torch.equal(ba[k], bb[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roundtrip(tmp_path, dtype):
    mgr = CheckpointManager(str(tmp_path))
    src = _params(1, dtype)
    mgr.save(5, src, base_seed=42, extra={"note": "x"})
    dst = _params(2, dtype)
    params, step, seed, extra = mgr.restore(dst)
    assert params is dst and (step, seed, extra) == (5, 42, {"note": "x"})
    _assert_same(dst, src)
    man = mgr.read_manifest()
    leaf = man["leaves"]["stages/s0/b0/mix/wq"]
    assert leaf == {"shape": [2, 32, 32], "dtype": dtype}
    assert man["leaves"]["final_norm/scale"]["dtype"] == "float32"


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _params(), base_seed=0)
    assert mgr.all_steps() == [3, 4] and mgr.latest() == 4


def test_async_save_takes_the_params_at_save_time(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    p = _params(3)
    want = _params(3)
    mgr.save(7, p, base_seed=1, blocking=False)
    with torch.no_grad():                  # the train loop moves on
        for t in p.parameters():
            t.add_(1.0)
    mgr.wait()
    assert mgr.latest() == 7
    _assert_same(mgr.restore(_params(4))[0], want)


def test_no_partial_checkpoint_on_disk(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(9, _params(), base_seed=0)
    names = os.listdir(tmp_path)
    assert all(n.startswith("step_") for n in names), names
    assert sorted(os.listdir(tmp_path / names[0])) == ["arrays.npz",
                                                       "manifest.json"]


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _params(), base_seed=0)
    other = tlm.init_params(topt.opt_tiny(layers=2, d_model=32, vocab=96),
                            torch.Generator().manual_seed(0), "cpu")
    before = _bits(other)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(other)
    assert all(torch.equal(before[k], v) for k, v in _bits(other).items())


def test_missing_leaf_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _params(), base_seed=0)
    p = _params()
    p.register_parameter("extra", torch.nn.Parameter(torch.zeros(3),
                                                     requires_grad=False))
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(p)


# ------------------------------------------------- across the two packages
def _jax_params():
    jc = jopt.opt_tiny(layers=2, d_model=32, vocab=64)
    return jax.jit(lambda k: jlm.init_params(jc, k))(jax.random.PRNGKey(7))


def _flat(tree):
    return {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_jax_checkpoint_restores_into_port(tmp_path):
    jp = _jax_params()
    JManager(str(tmp_path)).save(12, jp, base_seed=99, extra={"a": 1})
    params, step, seed, extra = CheckpointManager(str(tmp_path)).restore(
        _params(5))
    assert (step, seed, extra) == (12, 99, {"a": 1})
    got = tlm.params_to_numpy(params)
    want = _flat(jp)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].tobytes() == w.tobytes(), k


def test_jax_bfloat16_checkpoint_restores_into_port(tmp_path):
    """The reference stores bfloat16 leaves as 2-byte records under a
    "bfloat16" manifest dtype; the port reads the bits back."""
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), _jax_params())
    JManager(str(tmp_path)).save(3, jp, base_seed=0)
    params = CheckpointManager(str(tmp_path)).restore(_params(5,
                                                              "bfloat16"))[0]
    want = _flat(jp)
    assert params.stages.s0.b0.mix.wq.dtype == torch.bfloat16
    for n, p in params.named_parameters():         # norms stay float32
        k = n.replace(".", "/")
        assert p.float().numpy().tobytes() == \
            want[k].astype(np.float32).tobytes(), k


def test_port_checkpoint_restores_into_jax(tmp_path):
    src = _params(6)
    CheckpointManager(str(tmp_path)).save(4, src, base_seed=8,
                                          extra={"b": 2})
    params, step, seed, extra = JManager(str(tmp_path)).restore(
        _jax_params())
    assert (step, seed, extra) == (4, 8, {"b": 2})
    got, want = _flat(params), tlm.params_to_numpy(src)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].tobytes() == w.tobytes(), k
    with open(tmp_path / "step_0000000004" / "manifest.json") as f:
        assert set(json.load(f)) == {"step", "base_seed", "extra", "leaves"}


# ----------------------------------------------------------------- resume
STEPS, CKPT_AT = 12, 4


def _spec(ckpt_dir=None, **kw):
    ov = {"model.variant": "tiny", "model.seq_len": 16, "run.steps": STEPS,
          "run.batch_size": 4, "run.log_every": 1, "run.eval_every": 0,
          "run.seed": 3, "optimizer.lr": 2e-4, "optimizer.n_drop": 1,
          "runtime.backend": "scan", **kw}
    if ckpt_dir:
        ov["run.ckpt_dir"] = ckpt_dir
    return tapi.with_overrides(tapi.preset("tiny-smoke"), ov)


@pytest.mark.parametrize("kw", [
    {},
    {"estimator.name": "one_sided", "estimator.q": 2,
     "runtime.forward_backend": "virtual", "runtime.backend": "pallas"},
])
def test_resume_trajectory_bit_identical(tmp_path, kw):
    ref = tapi.run(_spec(**kw), device="cpu")["history"]
    d = str(tmp_path / "ckpt")
    tapi.run(_spec(d, **{**kw, "run.steps": CKPT_AT + 3,
                         "run.ckpt_every": CKPT_AT}), device="cpu")
    res = tapi.run(_spec(d, **{**kw, "run.steps": STEPS}),
                   device="cpu")["history"]
    # on failure, say where the runs part: the resume point, the
    # checkpoints on disk, and the first step whose loss bits differ
    ckpts = CheckpointManager(d).all_steps()
    assert res["step"][0] == CKPT_AT, (res["step"], ckpts)
    assert ref["step"][-len(res["step"]):] == res["step"]
    first = next((s for s, a, b in zip(res["step"], ref["loss"][CKPT_AT:],
                                       res["loss"]) if a != b), None)
    assert ref["loss"][-len(res["loss"]):] == res["loss"], (
        f"first differing step {first}: uninterrupted {ref['loss']}, "
        f"resumed {res['loss']}, checkpoints {ckpts}")
    _assert_same(ref["final_params"], res["final_params"])


def test_trajectory_independent_of_thread_count():
    """A candidate cause of a resume mismatch ruled out: the trajectory of
    the resume test's first case is the same bits at 1, 2 and 3 torch
    threads (reductions split by thread would move it)."""
    runs = []
    try:
        for n in (1, 2, 3):
            torch.set_num_threads(n)
            h = tapi.run(_spec(), device="cpu")["history"]
            runs.append((h["loss"], _bits(h["final_params"])))
    finally:
        torch.set_num_threads(2)
    for loss, bits in runs[1:]:
        assert loss == runs[0][0]
        assert all(torch.equal(bits[k], runs[0][1][k]) for k in bits)


def test_matmul_bits_independent_of_operand_alignment():
    """Another ruled out: at the tiny model's shapes (M = 4 x 15 rows) the
    float32 GEMM gives the same bits whatever the operands' alignment
    (MKL may take alignment-dependent paths outside its CNR mode)."""
    g = torch.Generator().manual_seed(0)
    for (M, K, N) in ((60, 128, 128), (60, 128, 512), (60, 512, 128)):
        a0, b0 = torch.randn(M, K, generator=g), torch.randn(K, N, generator=g)
        want = (a0 @ b0).numpy().tobytes()
        for off in (1, 2, 3, 4, 8, 15):
            a = torch.empty(M * K + 16)[off:off + M * K].view(M, K)
            b = torch.empty(K * N + 16)[off:off + K * N].view(K, N)
            a.copy_(a0)
            b.copy_(b0)
            assert (a @ b).numpy().tobytes() == want, (M, K, N, off)


def test_async_save_error_is_raised(tmp_path, monkeypatch):
    """A failed asynchronous write is not lost: the next ``wait()`` (and
    so ``train()``'s end) raises it, instead of a later resume silently
    restarting from step 0."""
    mgr = CheckpointManager(str(tmp_path))

    def broken(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(np, "savez", broken)
    mgr.save(3, _params(), base_seed=0, blocking=False)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint") as e:
        mgr.wait()
    assert isinstance(e.value.__cause__, OSError)
    mgr.wait()                              # reported once
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        tapi.run(_spec(str(tmp_path / "run"), **{
            "run.steps": 2, "run.ckpt_every": 1}), device="cpu")


def test_resume_skips_consumed_batches(tmp_path):
    d = str(tmp_path / "ckpt")
    tapi.run(_spec(d, **{"run.steps": CKPT_AT + 1,
                         "run.ckpt_every": CKPT_AT}), device="cpu")
    res = tapi.run(_spec(d), device="cpu")["history"]
    assert min(res["step"]) == CKPT_AT
    assert len(res["loss"]) == STEPS - CKPT_AT


def test_resume_checks_the_saved_spec(tmp_path):
    d = str(tmp_path / "ckpt")
    tapi.run(_spec(d, **{"run.steps": CKPT_AT, "run.ckpt_every": CKPT_AT}),
             device="cpu")
    with pytest.raises(tapi.SpecError, match="does not match"):
        tapi.run(_spec(d, **{"optimizer.lr": 1e-3}), device="cpu")

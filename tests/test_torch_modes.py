"""The reference's optimizer modes on every config family, held against
``repro`` on the CPU, and the reference functions ported last.

Five smoke configs, one a family: ``qwen3-14b`` (rope, GQA, qk-norm,
SwiGLU, untied head), ``granite-moe-1b-a400m`` (MoE),
``deepseek-v2-lite-16b`` (MLA + MoE), ``xlstm-350m`` (mLSTM/sLSTM) and
``jamba-v0.1-52b`` (Mamba + attn + MoE), all float32.  The modes:

  * FO SGD and FO AdamW, teacher-forced: the port's autograd gradients
    (through K2's plain version, the MoE dispatch and the scans) against
    ``jax.grad`` of the reference's loss (rtol 1e-4, atol 1e-6, as
    ``tests/test_torch_zoo.py``), then one update driven by the
    reference's gradients against the reference's ``make_fo_step``
    (atol 1e-6);
  * ZO momentum, LoRA, prefix and the swarm's sharded step (one
    process, two loss shards), each two steps of the trainer in both
    packages from the reference's initial weights (and PEFT tree):
    losses within rtol 1e-4; each step's projected gradient within
    eight float32 ulps of the loss over 2·eps (it is (L+ − L−)/2eps, so
    each package's few ulps on L± show there, divided by 2eps); the
    active layer counts and each step's layer masks equal; every final
    trainable leaf within atol 1e-6 of the reference's, where the two
    steps moved some leaf by more than ten times that;
  * replay: a sharded run the port recorded, re-executed bit for bit by
    ``launch.replay``.

Where the reference refuses a combination the port raises the same
exception type with the same message at the same point: prefix tuning
on the archs with no ``attn`` block (at construction), and LoRA on the
recurrent archs and prefix on jamba at the spec's default sparsity,
whose drop count (a share of the model's layers) exceeds the PEFT
tree's stacked layers (at the first step's layer selection); those
combinations are held at ``optimizer.n_drop = 0``.

``embed/tok``'s gradient, a scatter-add over repeated tokens summed in
another order by XLA, is held at atol 5e-6 (every other leaf at 1e-6):
on ``qwen3-14b``/``smoke`` its worst element is 1.46e-6 from the
reference's, and against a float64 autograd run the port is 4.4e-7 off
where the reference is 1.9e-6 off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st  # optional-hypothesis shim

from repro import api as japi
from repro import configs as jconfigs
from repro import fused as jfused
from repro.core import fo as jfo
from repro.core import rng as jrng
from repro.core import selection as jsel
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro.swarm import driver as jdriver
from repro.train.trainer import Trainer as JTrainer
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import fused as tfused
from repro_torch import peft as tpeft
from repro_torch.core import fo as tfo
from repro_torch.core import selection as tsel
from repro_torch.core import zo as tzo
from repro_torch.models import lm as tlm
from repro_torch.swarm import driver as tdriver
from repro_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(2)              # six xdist workers share the CPUs

ARCHS = ["qwen3-14b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "xlstm-350m", "jamba-v0.1-52b"]
RECURRENT = ("xlstm-350m", "jamba-v0.1-52b")
NO_ATTN = ("deepseek-v2-lite-16b", "xlstm-350m")
MODES = {"zo_momentum": {"optimizer.mode": "zo_momentum"},
         "lora": {"runtime.peft": "lora"},
         "prefix": {"runtime.peft": "prefix"},
         "swarm": {"swarm.n_shards": 2}}
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6     # tests/test_torch_zoo.py
EMBED_GRAD_ATOL = 5e-6                # the scatter-add (module docstring)
PARAM_ATOL = 1e-6
B, S = 2, 16


def _flat(tree):
    return {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _spec(arch, mode, **extra):
    return japi.with_overrides(japi.preset("tiny-smoke"), {
        "model.arch": arch, "model.variant": "smoke", "model.seq_len": S,
        "run.steps": 2, "run.batch_size": 4, **MODES.get(mode, {}),
        **extra})


# PEFT trees that stack fewer layers than the default sparsity drops
# from the model's (pinned in test_refused_combinations_raise_alike)
SHALLOW_TREES = (("xlstm-350m", "lora"), ("jamba-v0.1-52b", "lora"),
                 ("jamba-v0.1-52b", "prefix"))


def _extra(arch, mode):
    return {"optimizer.n_drop": 0} if (arch, mode) in SHALLOW_TREES else {}


def _trainers(js):
    """The reference's trainer and the port's on its initial weights
    (and PEFT tree)."""
    jt = JTrainer.from_spec(js)
    ts = tapi.from_json(japi.to_json(js))
    peft = js.runtime.peft is not None
    base = _flat(jt.base_params if peft else jt.trainable)
    kw = {}
    if peft:
        kw["trainable"] = tpeft.from_numpy(
            jax.tree.map(np.asarray, jt.trainable), "cpu")
    tt = TTrainer.from_spec(ts, device="cpu", params=tlm.params_from_numpy(
        tapi.derive(ts).model_cfg, base, "cpu"), **kw)
    return jt, tt


# ------------------------------------------------ trainer-driven modes
# every (arch, mode) but prefix where no attn block exists: refused by
# both packages (test_refused_combinations_raise_alike)
HELD = [(a, m) for a in ARCHS for m in MODES
        if not (m == "prefix" and a in NO_ATTN)]


@pytest.mark.parametrize("arch,mode", HELD, ids=[f"{a}-{m}" for a, m in HELD])
def test_mode_matches_reference(arch, mode):
    jt, tt = _trainers(_spec(arch, mode, **_extra(arch, mode)))
    assert sorted(tt.spec.paths) == sorted(jt.spec.paths)
    if mode == "swarm":
        assert getattr(tt._step, "sharded", False)
        assert getattr(jt._step, "sharded", False)
    step_attr = "_mom_step" if mode == "zo_momentum" else "_step"
    jstep, jmetrics = getattr(jt, step_attr), []

    def tap(*args):                     # the reference's per-step metrics
        out = jstep(*args)
        jmetrics.append(out[2])
        return out
    setattr(jt, step_attr, tap)
    start = _flat(jt.trainable)
    want, got = jt.train(), tt.train()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    assert np.all(np.isfinite(got["loss"]))

    eps = jt.est_cfg.eps
    pg_atol = 8 * float(np.spacing(np.float32(max(want["loss"])))) / (2 * eps)
    np.testing.assert_allclose(
        got["projected_grad"],
        [float(m["projected_grad"]) for m in jmetrics], rtol=0, atol=pg_atol)
    if mode != "zo_momentum":           # the momentum step reports none
        assert got["active_layers"] == [int(m["active_layers"])
                                        for m in jmetrics]
    policy = "stratified" if mode == "zo_momentum" else jt.est_cfg.policy
    base = jrng.fold_py(jt.tcfg.seed, 0xC0FFEE)
    for t in range(len(jmetrics)):
        seed = jrng.fold_py(base, t)
        jm = getattr(jzo, f"{policy}_select")(jt.spec, seed,
                                             jt.est_cfg.n_drop)[0]
        tmk = getattr(tzo, f"{policy}_select")(tt.spec, seed,
                                              tt.est_cfg.n_drop)[0]
        assert sorted(jm) == sorted(tmk)
        for g in jm:
            np.testing.assert_array_equal(np.asarray(tmk[g]),
                                          np.asarray(jm[g]), err_msg=g)

    jf = _flat(want["final_params"])
    tf = {p: v.detach().numpy() for p, v in tzo.leaf_items(
        got["final_params"])}
    assert sorted(tf) == sorted(jf)
    for p, w in jf.items():
        np.testing.assert_allclose(tf[p], w, rtol=0, atol=PARAM_ATOL,
                                   err_msg=p)
    assert max(float(np.abs(jf[p] - start[p]).max()) for p in jf) \
        > 10 * PARAM_ATOL


REFUSED = [(a, "prefix", {}, "construction",
            "model has no attention blocks for prefix tuning")
           for a in NO_ATTN] + [
           (a, m, {}, "first step", "n_drop must be in")
           for a, m in SHALLOW_TREES]


@pytest.mark.parametrize("arch,mode,extra,point,msg", REFUSED,
                         ids=[f"{a}-{m}" for a, m, *_ in REFUSED])
def test_refused_combinations_raise_alike(arch, mode, extra, point, msg):
    """The reference refuses (run first, not assumed); the port raises
    the same type with the same message at the same point, and both
    specs validate."""
    js = _spec(arch, mode, **extra)
    ts = tapi.from_json(japi.to_json(js))
    japi.validate(js)
    tapi.validate(ts)
    errs = []
    for make in (lambda: JTrainer.from_spec(js),
                 lambda: TTrainer.from_spec(ts, device="cpu")):
        with pytest.raises(Exception) as e:
            tr = make()
            assert point == "first step", "constructed"
            tr.train()
        errs.append(e.value)
    assert type(errs[0]) is type(errs[1]) is ValueError
    assert str(errs[0]) == str(errs[1]) and msg in str(errs[0])


# -------------------------------------------------------- FO, teacher-forced
def _model(arch):
    jc = jconfigs.get(arch, "smoke")
    tc = tconfigs.get(arch, "smoke")
    jp = jlm.init_params(jc, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "loss_mask": np.ones((B, S), np.float32)}
    return jc, tc, jp, batch


def _tparams(tc, jp):
    return tlm.params_from_numpy(tc, _flat(jp), "cpu")


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fo_teacher_forced(arch, opt):
    """The port's gradients against ``jax.grad`` of the reference's loss
    (autograd through MoE dispatch, MLA's K2 at dh = 192 with v padded,
    the scans), then one update on the reference's gradients against
    the reference's step."""
    jc, tc, jp, batch = _model(arch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(jc, p, b)))(jp, _jb(batch))
    jg = _flat(jg)
    tp = _tparams(tc, jp)
    leaves = tlm.grad_leaves(tp)
    loss = tlm.lm_loss(tc, tp, _tb(batch), grad=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for path, layer, t in leaves:
        want = jg[path] if layer is None else jg[path][layer]
        got = (np.zeros_like(want) if t.grad is None
               else t.grad.numpy())
        np.testing.assert_allclose(
            got, want, rtol=GRAD_RTOL, err_msg=path,
            atol=EMBED_GRAD_ATOL if path == "embed/tok" else GRAD_ATOL)
    kw = dict(optimizer=opt, lr=3e-2 if opt == "sgd" else 1e-2,
              weight_decay=0.01, grad_clip=0.5)
    jcfg, tcfg = jfo.FOConfig(**kw), tfo.FOConfig(**kw)
    jstep = jax.jit(jfo.make_fo_step(lambda p, b: jlm.lm_loss(jc, p, b),
                                     jcfg))
    jp2, _, _ = jstep(jp, jfo.init_state(jp, jcfg), _jb(batch),
                      jnp.int32(0))
    tp = _tparams(tc, jp)
    tst = tfo.init_state(tp, tcfg)
    tfo.apply_update(tst, [torch.tensor(jg[p] if l is None else jg[p][l])
                           for p, l, _ in tst.leaves], tcfg, tcfg.lr)
    got = tlm.params_to_numpy(tp)
    for k, w in _flat(jp2).items():
        np.testing.assert_allclose(got[k], np.asarray(w, np.float32),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)


# ---------------------------------------------------------------- replay
@pytest.mark.parametrize("arch", ARCHS)
def test_replay_of_a_sharded_run_is_bit_exact(arch, tmp_path):
    """``launch.replay`` of a port-recorded two-shard run: every scalar
    of every step and the quorum masks match bit for bit."""
    from repro_torch.launch import replay
    spec = tapi.with_overrides(tapi.from_json(japi.to_json(
        _spec(arch, "swarm"))), {"run.steps": 3,
                                 "telemetry.runs_dir": str(tmp_path)})
    tapi.run(spec, device="cpu")
    (steps,) = list(tmp_path.glob("*/steps.jsonl"))
    out = replay.replay_run(str(steps.parent), device="cpu")
    assert out["ok"], out["failures"]
    assert out["matched"]["arrived"] == [1, 1]


# ------------------------------------------- the reference functions ported
def _policy_cases():
    """(policy, num_layers, n_drop, seed, step, weights) over the grids
    of ``tests/test_selection_properties.py``."""
    rng = np.random.default_rng(0)
    out = []
    for policy in jsel.POLICIES:
        for num_layers in (2, 8, 9, 12, 16, 31, 33):
            w = 0.1 + rng.random(num_layers)
            for n_drop in sorted({0, 1, num_layers // 2, num_layers - 1}):
                for seed, step in ((0, 0), (42, 1), (2 ** 31, 500),
                                   (7, 10_000), (0xFFFFFFFF, 9999)):
                    out.append((policy, num_layers, n_drop, seed, step, w))
    return out


def _both_masks(policy, num_layers, n_drop, seed, step, w):
    jf = jsel.make_policy(policy, num_layers, n_drop)
    tf = tsel.make_policy(policy, num_layers, n_drop)
    want = np.asarray(jf(jnp.uint32(seed), jnp.int32(step),
                         jnp.asarray(w, jnp.float32)))
    got = tf(seed, step, np.asarray(w, np.float32)).numpy()
    return got, want


def test_policies_match_reference_bit_for_bit():
    """Every policy's mask equals the reference's over the property
    grids; the masks that differ are counted (0 of the cases here)."""
    assert tsel.POLICIES == jsel.POLICIES
    cases = _policy_cases()
    differ = [c[:5] for c in cases if not np.array_equal(*_both_masks(*c))]
    assert len(cases) > 300 and differ == [], differ


def test_weighted_mask_under_ties_and_edges_matches_reference():
    """Saturated weights tie the scores (a stable argsort breaks ties by
    index, as the reference's), and the k = 0 / n_drop = 0 edges."""
    w = np.asarray([np.inf] * 6 + [1.0] * 2, np.float32)
    for seed in range(8):
        want = np.asarray(jsel.weighted_active(jnp.uint32(seed),
                                               jnp.asarray(w), 4))
        assert np.array_equal(tsel.weighted_active(seed, w, 4).numpy(),
                              want)
    ones = np.ones(6, np.float32)
    assert int(tsel.weighted_active(3, ones, 0).sum()) == 6
    assert int(tsel.weighted_active(3, ones, 6).sum()) == 0
    with pytest.raises(ValueError):
        tsel.weighted_active(3, ones, 7)
    with pytest.raises(ValueError, match="unknown policy"):
        tsel.make_policy("nope", 4, 1)
    with pytest.raises(ValueError, match="unknown policy"):
        jsel.make_policy("nope", 4, 1)


@given(st.sampled_from(jsel.POLICIES), st.integers(2, 40),
       st.integers(0, 2 ** 32 - 1), st.integers(0, 10 ** 6),
       st.integers(0, 2 ** 31))
@settings(max_examples=60, deadline=None)
def test_policy_property_against_reference(policy, num_layers, seed, step,
                                           wseed):
    w = np.random.default_rng(wseed).exponential(size=num_layers)
    for n_drop in {0, 1, num_layers // 2, num_layers - 1}:
        got, want = _both_masks(policy, num_layers, n_drop, seed, step, w)
        assert np.array_equal(got, want), (policy, num_layers, n_drop)


def test_lm_loss_pair_matches_reference():
    """Raises as the reference does without a stacked ctx; the (P,) loss
    vector of a paired ctx equals the reference's."""
    jc, tc, jp, batch = _model("qwen3-14b")
    tp = _tparams(tc, jp)
    with pytest.raises(ValueError, match="stacked PerturbCtx"):
        tlm.lm_loss_pair(tc, tp, _tb(batch))
    with pytest.raises(ValueError, match="stacked PerturbCtx"):
        jlm.lm_loss_pair(jc, jp, _jb(batch))
    jspec = jzo.build_spec(jp, jlm.zo_group_fn)
    tspec = tzo.build_spec(tp, tlm.zo_group_fn)
    jm, _, _ = jzo.stratified_select(jspec, jnp.uint32(9), 1)
    tm, _, _ = tzo.stratified_select(tspec, 9, 1)
    with pytest.raises(ValueError, match="stacked PerturbCtx"):
        tlm.lm_loss_pair(tc, tp, _tb(batch), perturb=tfused.make_ctx(
            9, 1e-3, tm, "virtual"))
    want = np.asarray(jlm.lm_loss_pair(jc, jp, _jb(batch),
                                       perturb=jfused.make_pair_ctx(
                                           jnp.uint32(9), 1e-3, jm,
                                           "virtual_ref")))
    got = tlm.lm_loss_pair(tc, tp, _tb(batch), perturb=tfused.make_pair_ctx(
        9, 1e-3, tm, "virtual")).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_tree_axpy_is_functional_and_equals_in_place():
    """``tree_axpy`` leaves its input untouched and returns the tree
    ``tree_axpy_`` makes of a copy, bit for bit; both equal the
    reference's ``tree_axpy``."""
    import copy
    jc, tc, jp, _ = _model("granite-moe-1b-a400m")
    tp = _tparams(tc, jp)
    spec = tzo.build_spec(tp, tlm.zo_group_fn)
    masks, idxs, _ = tzo.stratified_select(spec, 5, 1)
    before = {k: v.clone() for k, v in tzo.leaf_items(tp)}
    new = tzo.tree_axpy(tp, spec, 17, 0.25, masks, idxs, decay=0.9)
    assert all(torch.equal(v, before[k]) for k, v in tzo.leaf_items(tp))
    inplace = tzo.tree_axpy_(copy.deepcopy(tp), spec, 17, 0.25, masks, idxs,
                             decay=0.9)
    a, b = dict(tzo.leaf_items(new)), dict(tzo.leaf_items(inplace))
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    jspec = jzo.build_spec(jp, jlm.zo_group_fn)
    jm, ji, _ = jzo.stratified_select(jspec, jnp.uint32(5), 1)
    want = _flat(jzo.tree_axpy(jp, jspec, jnp.uint32(17), 0.25, jm, ji,
                               decay=0.9))
    got = tlm.params_to_numpy(new)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_spawn_worker_command_mirrors_reference(monkeypatch):
    """One attached worker process: the port's command is the
    reference's over ``repro_torch`` with the device, its environment
    puts this checkout's ``src`` first."""
    seen = {}

    class Popen:
        def __init__(self, cmd, env=None, **kw):
            seen.setdefault("cmds", []).append((cmd, env))

    import subprocess
    monkeypatch.setattr(subprocess, "Popen", Popen)
    jdriver.spawn_worker("127.0.0.1", 7001)
    tdriver.spawn_worker("127.0.0.1", 7001, device="cpu")
    tdriver.spawn_worker("127.0.0.1", 7001)
    (jcmd, _), (tcmd, tenv), (dcmd, _) = seen["cmds"]
    assert jcmd[1:] == ["-m", "repro.launch", "swarm", "--attach",
                        "127.0.0.1:7001"]
    assert tcmd[1:] == ["-m", "repro_torch.launch", "swarm", "--attach",
                        "127.0.0.1:7001", "--device", "cpu"]
    assert dcmd[-1] == "cuda"              # the card unless asked
    assert tenv["PYTHONPATH"].split(":")[0].endswith("src")


def test_serve_main_shim_defaults_to_xlstm(monkeypatch):
    """``launch/serve.py::main`` hands ``serve`` to the CLI with
    ``--arch xlstm-350m`` unless an arch is given, as the reference's."""
    from repro.launch import cli as jcli
    from repro.launch import serve as jserve
    from repro_torch.launch import cli as tcli
    from repro_torch.launch import serve as tserve
    seen = []
    monkeypatch.setattr(jcli, "main", lambda argv: seen.append(argv))
    monkeypatch.setattr(tcli, "main", lambda argv: seen.append(argv))
    for mod in (jserve, tserve):
        mod.main(["--variant", "smoke"])
        mod.main(["--arch=qwen3-14b", "--device", "cpu"])
    assert seen[0] == seen[2] == ["serve", "--arch", "xlstm-350m",
                                  "--variant", "smoke"]
    assert seen[1][:2] == seen[3][:2] == ["serve", "--arch=qwen3-14b"]

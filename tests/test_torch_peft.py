"""Port parity of PEFT (``repro_torch.peft``: LoRA, prefix tuning) against
``repro.peft`` on a tiny float32 OPT, with the trees carried across from
the reference (``peft.from_numpy``).

Tolerances: forwards through ``merge``/``inject`` within atol 1e-5 of
the reference's hidden states and losses within rtol 1e-5 (float32
sums in another order); the ZO spec's paths, groups and leaf uids
equal; a teacher-forced two-point step over each tree (the port's probe
losses within rtol 1e-5, then the reference's projected gradient driving
the port's update) at atol 1e-6; inside the port, zero-init LoRA and
resume over a PEFT tree bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import estimators as jest
from repro.configs import opt as jopt
from repro.core import rng as jrng
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro.peft import lora as jlora
from repro.peft import prefix as jprefix
from repro_torch import api as tapi
from repro_torch import estimators as test_
from repro_torch import peft as tpeft
from repro_torch.configs import opt as topt
from repro_torch.core import rng as trng
from repro_torch.core import zo as tzo
from repro_torch.models import lm as tlm
from repro_torch.peft import lora as tlora
from repro_torch.peft import prefix as tprefix
from repro_torch.train.trainer import Trainer

torch.set_num_threads(2)              # six xdist workers share the CPUs

LCFG = dict(rank=4, alpha=8, targets=("wq", "wv"))
LR = 2e-2


def _flat(tree):
    return {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jc = jopt.opt_tiny(layers=3, d_model=32, vocab=128)
    tc = topt.opt_tiny(layers=3, d_model=32, vocab=128)
    jp = jlm.init_params(jc, jax.random.PRNGKey(5))
    jl = jlora.init_lora(jp, jlora.LoRAConfig(**LCFG), jax.random.PRNGKey(6))
    # a non-zero B, so the merge is not the identity
    jl = {k: {"A": v["A"], "B": 0.05 * jax.random.normal(
        jax.random.PRNGKey(7 + i), v["B"].shape, v["B"].dtype)}
        for i, (k, v) in enumerate(sorted(jl.items()))}
    jx = jprefix.init_prefix(jc, jax.random.PRNGKey(8),
                             jprefix.PrefixConfig(n_prefix=3))
    r = np.random.default_rng(5)
    toks = r.integers(0, 128, (4, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "loss_mask": np.ones((4, 12), np.float32)}
    return jc, tc, jp, jl, jx, batch


def _port(setup):
    """Fresh port copies of the base parameters and both PEFT trees."""
    jc, tc, jp, jl, jx, batch = setup
    return (tlm.params_from_numpy(tc, _flat(jp), "cpu"),
            tpeft.from_numpy(_np_tree(jl), "cpu"),
            tpeft.from_numpy(_np_tree(jx), "cpu"))


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("kind", ["lora", "prefix"])
def test_forward_matches_reference(setup, kind):
    jc, tc, jp, jl, jx, batch = setup
    tp, tl, tx = _port(setup)
    if kind == "lora":
        jm = jlora.merge(jp, jl, jlora.LoRAConfig(**LCFG))
        tm = tlora.merge(tp, tl, tlora.LoRAConfig(**LCFG))
    else:
        jm, tm = jprefix.inject(jp, jx), tprefix.inject(tp, tx)
    want, _, _ = jlm.forward(jc, jm, jnp.asarray(batch["tokens"]),
                             mode="train")
    got = tlm.forward(tc, tm, torch.tensor(batch["tokens"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    base = tlm.forward(tc, tp, torch.tensor(batch["tokens"]))
    assert (got - base).abs().max() > 1e-3          # the tree took effect
    np.testing.assert_allclose(
        float(tlm.lm_loss(tc, tm, _tb(batch))),
        float(jlm.lm_loss(jc, jm, _jb(batch))), rtol=1e-5)


def test_zero_init_lora_is_identity(setup):
    _, tc, _, _, _, batch = setup
    tp, _, _ = _port(setup)
    cfg = tlora.LoRAConfig(**LCFG)
    tl = tlora.init_lora(tp, cfg, torch.Generator().manual_seed(0))
    assert all(torch.count_nonzero(ab["B"]) == 0 for ab in tl.values())
    assert all(ab["A"].shape == (3, 32, 4) for ab in tl.values())
    toks = torch.tensor(batch["tokens"])
    assert torch.equal(tlm.forward(tc, tlora.merge(tp, tl, cfg), toks),
                       tlm.forward(tc, tp, toks))


def test_base_tree_not_mutated(setup):
    """merge/inject and a ZO step over either tree leave the base
    parameters (and their leaf set) untouched."""
    _, tc, _, _, _, batch = setup
    tp, tl, tx = _port(setup)
    before = {k: v.clone() for k, v in tzo.leaf_items(tp)}
    cfg = tlora.LoRAConfig(**LCFG)
    for tree, group_fn, to_model in (
            (tl, tlora.lora_group_fn, lambda t: tlora.merge(tp, t, cfg)),
            (tx, tprefix.prefix_group_fn,
             lambda t: tprefix.inject(tp, t))):
        step, init = test_.make_step(
            lambda p, b, perturb=None: tlm.lm_loss(tc, to_model(p), b),
            tzo.build_spec(tree, group_fn),
            test_.EstimatorConfig(lr=LR, n_drop=1))
        before_tree = {k: v.clone() for k, v in tzo.leaf_items(tree)}
        step(tree, init(), _tb(batch), 0, 11)
        assert any(not torch.equal(v, before_tree[k])
                   for k, v in tzo.leaf_items(tree))
    after = dict(tzo.leaf_items(tp))
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())


@pytest.mark.parametrize("kind", ["lora", "prefix"])
def test_build_spec_groups_and_uids_match(setup, kind):
    jc, tc, jp, jl, jx, batch = setup
    _, tl, tx = _port(setup)
    jtree, ttree = (jl, tl) if kind == "lora" else (jx, tx)
    gfn = (jlora.lora_group_fn, tlora.lora_group_fn) if kind == "lora" \
        else (jprefix.prefix_group_fn, tprefix.prefix_group_fn)
    js, ts = jzo.build_spec(jtree, gfn[0]), tzo.build_spec(ttree, gfn[1])
    assert ts.paths == js.paths
    assert ts.groups == js.groups
    assert ts.slices == dict(js.slices) and ts.num_layers == js.num_layers
    assert [trng.leaf_uid(p) for p in ts.paths] == [
        jrng.leaf_uid(p) for p in js.paths]
    assert tzo.leaf_shapes(ttree) == tuple(
        tuple(np.shape(v)) for v in _flat(jtree).values())


@pytest.mark.parametrize("kind", ["lora", "prefix"])
def test_teacher_forced_zo_step(setup, kind):
    jc, tc, jp, jl, jx, batch = setup
    tp, tl, tx = _port(setup)
    kw = dict(eps=1e-3, lr=LR, n_drop=1, weight_decay=0.1)
    if kind == "lora":
        lc = jlora.LoRAConfig(**LCFG)
        jtree, gfn = jl, jlora.lora_group_fn
        jmodel = lambda t: jlora.merge(jp, t, lc)
        ttree, tgfn = tl, tlora.lora_group_fn
        tmodel = lambda t: tlora.merge(tp, t, tlora.LoRAConfig(**LCFG))
    else:
        jtree, gfn, jmodel = jx, jprefix.prefix_group_fn, \
            lambda t: jprefix.inject(jp, t)
        ttree, tgfn, tmodel = tx, tprefix.prefix_group_fn, \
            lambda t: tprefix.inject(tp, t)
    jstep, init = jest.make_step(
        lambda t, b, perturb=None: jlm.lm_loss(jc, jmodel(t), b),
        jzo.build_spec(jtree, gfn), jest.EstimatorConfig(**kw))
    jnew, _, jm = jstep(jtree, init(), _jb(batch), jnp.int32(2),
                        jnp.uint32(31))
    tcfg = test_.EstimatorConfig(**kw)
    est = test_.build_estimator(tzo.build_spec(ttree, tgfn), tcfg)
    loss_fn = lambda t, b, perturb=None: tlm.lm_loss(tc, tmodel(t), b)
    ttree, dirs, met = est.estimate(loss_fn, ttree, _tb(batch),
                                    trng.fold_py(31, 2))
    np.testing.assert_allclose(met["loss"], float(jm["loss"]), rtol=1e-5)
    dirs = dataclasses.replace(
        dirs, coeffs=(np.float32(jm["projected_grad"]),))
    est.apply_update(ttree, dirs, LR, 1.0 - LR * tcfg.weight_decay)
    got = tlm.params_to_numpy(ttree)
    want = _flat(jnew)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)


def _peft_spec(kind, **run):
    return tapi.with_overrides(tapi.preset("tiny-smoke"), {
        "runtime.peft": kind, "run.steps": 4, "run.log_every": 1, **run})


@pytest.mark.parametrize("kind", ["lora", "prefix"])
def test_resume_over_peft_tree_bit_identical(tmp_path, kind):
    ref = tapi.run(_peft_spec(kind), device="cpu")["history"]
    ck = str(tmp_path / "ck")
    tapi.run(_peft_spec(kind, **{"run.steps": 2, "run.ckpt_dir": ck,
                                 "run.ckpt_every": 2}), device="cpu")
    trainer = Trainer.from_spec(_peft_spec(kind, **{"run.ckpt_dir": ck}),
                                device="cpu")
    res = trainer.train()
    assert res["step"][0] == 2 and res["loss"] == ref["loss"][2:]
    a, b = dict(tzo.leaf_items(ref["final_params"])), dict(
        tzo.leaf_items(res["final_params"]))
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert all("stages/" in k for k in a)      # the checkpoint is the tree


@pytest.mark.parametrize("kind", ["lora", "prefix"])
def test_virtual_with_peft_rejected_like_the_reference(kind):
    ov = {"runtime.peft": kind, "runtime.forward_backend": "virtual"}
    with pytest.raises(tapi.SpecError) as e:
        tapi.validate(tapi.with_overrides(tapi.preset("lezo-opt13b"), ov))
    with pytest.raises(japi.SpecError) as je:
        japi.validate(japi.with_overrides(japi.preset("lezo-opt13b"), ov))
    assert e.value.path == je.value.path == "runtime.peft"
    assert str(e.value) == str(je.value)
    d = tapi.derive(tapi.with_overrides(tapi.preset("tiny-smoke"),
                                        {"runtime.peft": kind}))
    with pytest.raises(ValueError, match="full-parameter ZO only"):
        Trainer(d.model_cfg, d.task, d.tcfg, dataclasses.replace(
            d.est_cfg, forward_backend="virtual"), device="cpu")


def test_lora_preset_validates_and_trains():
    spec = tapi.with_overrides(tapi.preset("lezo-opt13b-lora"), {
        "model.variant": "tiny", "model.seq_len": 32, "run.steps": 2,
        "run.batch_size": 4, "run.log_every": 1, "run.eval_every": 0})
    d, jd = tapi.derive(spec), japi.derive(japi.from_json(tapi.to_json(
        spec)))
    assert dataclasses.asdict(d.lora_cfg) == dataclasses.asdict(jd.lora_cfg)
    assert d.tcfg.peft == jd.tcfg.peft == "lora"
    hist = tapi.run(spec, device="cpu")["history"]
    assert len(hist["loss"]) == 2 and np.all(np.isfinite(hist["loss"]))


def test_fo_over_lora_tree_trains_the_tree_only(setup):
    """First-order training over a PEFT tree: gradients reach A and B
    through the merge, the base stays as it was."""
    spec = tapi.with_overrides(tapi.preset("tiny-smoke"), {
        "runtime.peft": "lora", "optimizer.mode": "fo", "run.steps": 2,
        "optimizer.lr": 1e-2})
    trainer = Trainer.from_spec(spec, device="cpu")
    base = {k: v.clone() for k, v in tzo.leaf_items(trainer.base_params)}
    b0 = {k: v.clone() for k, v in tzo.leaf_items(trainer.params)}
    trainer.train()
    assert all(torch.equal(v, base[k])
               for k, v in tzo.leaf_items(trainer.base_params))
    moved = [k for k, v in tzo.leaf_items(trainer.params)
             if not torch.equal(v.detach(), b0[k])]
    assert sorted(moved) == sorted(b0)


@pytest.mark.parametrize("kind", ["lora", "prefix"])
def test_peft_trainer_trajectory_matches_reference(kind):
    """The reference trainer's base weights and PEFT tree carried across
    (``Trainer(params=..., trainable=...)``): 3 ZO steps within rtol 1e-3
    of the reference's losses (g = (l+ - l-)/2eps multiplies loss
    rounding by 500)."""
    from repro.train.trainer import Trainer as JTrainer
    spec = japi.with_overrides(japi.preset("tiny-smoke"), {
        "runtime.peft": kind, "run.steps": 3})
    jt = JTrainer.from_spec(spec)
    base = _flat(jt.base_params)
    tree = _np_tree(jt.trainable)
    want = jt.train()["loss"]
    tspec = tapi.from_json(japi.to_json(spec))
    d = tapi.derive(tspec)
    tt = Trainer.from_spec(tspec, device="cpu",
                           params=tlm.params_from_numpy(d.model_cfg, base,
                                                        "cpu"),
                           trainable=tpeft.from_numpy(tree, "cpu"))
    assert tt.spec.paths == jt.spec.paths
    np.testing.assert_allclose(tt.train()["loss"], want, rtol=1e-3)

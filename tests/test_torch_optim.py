"""Port parity of the optimizers beyond the ZO estimators: ZO momentum
(and its Adam variant), the first-order baselines (SGD, momentum, AdamW
with clipping; in bf16 with float32 master weights), and the trainer's
loss-shard quorum, against the JAX package on a tiny OPT.

Tolerances: losses within rtol 1e-5; teacher-forced updates (the
reference's projected gradient or gradients fed to the port's update)
at atol 1e-6; the port's autograd gradients against ``jax.grad`` at
rtol 1e-4 (atol 1e-6 near zero: sums in another order); the quorum's
arrived subset bit for bit; trajectories through ``api.run`` within
rtol 1e-3, the bound ``test_torch_api`` uses (g = (l+ - l-)/2eps
multiplies loss rounding by 500).  In bf16, FO master weights and
moments within 1 float32 ulp of the reference's float32 parameters and
moments (teacher-forced, the reference's gradients; the CPU update
rounds as XLA's CPU backend does), the card's plain float32 update
within atol 1e-6 (moments: 1e-6 of the leaf's largest), and 8-step FO
losses within rtol 2e-2 (the reference's forward runs in float32 after
its first update, the port's in bf16).  The momentum ring is also held
against an explicit momentum buffer within the port (the reference's
atol 5e-5, rtol 5e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs import opt as jopt
from repro.core import fo as jfo
from repro.core import rng as jrng
from repro.core import zo as jzo
from repro.core import zo_adaptive as jada
from repro.models import lm as jlm
from repro.train.trainer import Trainer as JTrainer
from repro_torch import api as tapi
from repro_torch import estimators as test_
from repro_torch.configs import opt as topt
from repro_torch.core import fo as tfo
from repro_torch.core import rng as trng
from repro_torch.core import zo as tzo
from repro_torch.core import zo_adaptive as tada
from repro_torch.models import lm as tlm
from repro_torch.train import trainer as ttrainer

torch.set_num_threads(2)              # six xdist workers share the CPUs


@pytest.fixture(scope="module")
def setup():
    jc = jopt.opt_tiny(layers=3, d_model=32, vocab=128)
    tc = topt.opt_tiny(layers=3, d_model=32, vocab=128)
    jp = jax.jit(lambda k: jlm.init_params(jc, k))(jax.random.PRNGKey(4))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    r = np.random.default_rng(4)
    toks = r.integers(0, 128, (8, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "loss_mask": (r.random((8, 12)) < 0.8).astype(np.float32)}
    return jc, tc, jp, flat, batch


def _flat(tree):
    return {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_params(got, want, atol=1e-6):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


# -------------------------------------------------------------- momentum
def _state_of(jst):
    return {"g_hist": np.asarray(jst["g_hist"]).copy(),
            "v": np.float32(jst["v"]), "count": int(jst["count"])}


@pytest.mark.parametrize("adam", [False, True])
def test_momentum_teacher_forced(setup, adam):
    """Three steps, each from the reference's weights and ring: the
    port's probe loss against the reference's, then the reference's g
    through the port's ring and K axpy sweeps."""
    jc, tc, jp, _, batch = setup
    kw = dict(eps=1e-3, lr=1e-2, beta=0.8, history=2, n_drop=1,
              backend="dense", adam=adam)
    jstep, jinit = jada.make_zo_momentum_step(
        lambda p, b: jlm.lm_loss(jc, p, b),
        jzo.build_spec(jp, jlm.zo_group_fn), jada.ZOMomentumConfig(**kw))
    jstep = jax.jit(jstep)
    tcfg = tada.ZOMomentumConfig(**kw)
    jst = jinit()
    for t in range(3):
        tp = tlm.params_from_numpy(tc, _flat(jp), "cpu")
        tspec = tzo.build_spec(tp, tlm.zo_group_fn)
        est = test_.build_estimator(tspec, test_.EstimatorConfig(
            eps=tcfg.eps, lr=tcfg.lr, n_drop=tcfg.n_drop, backend="dense",
            fused_update=False))
        tp, dirs, em = est.estimate(lambda p, b: tlm.lm_loss(tc, p, b), tp,
                                    _tb(batch), trng.fold_py(5, t))
        est.restore_probe(tp, dirs)
        tst = _state_of(jst)
        jp, jst, jm = jstep(jp, jst, _jb(batch), jnp.int32(t), jnp.uint32(5))
        np.testing.assert_allclose(em["loss"], float(jm["loss"]), rtol=1e-5)
        tst, lr = tada.momentum_update_(tp, tspec, tcfg, tst,
                                        np.float32(jm["projected_grad"]),
                                        tcfg.lr, t, 5)
        np.testing.assert_allclose(lr, float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(tst["v"], float(jst["v"]), rtol=1e-6)
        _close_params(tlm.params_to_numpy(tp), _flat(jp))


def test_momentum_ring_matches_explicit_buffer(setup):
    """The K-scalar ring + regenerated sweeps equal momentum with an
    explicit K-truncated buffer of z trees, in float64."""
    _, tc, _, flat, batch = setup
    cfg = tada.ZOMomentumConfig(eps=1e-3, lr=1e-2, beta=0.8, history=3,
                                n_drop=1, backend="scan")
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    spec = tzo.build_spec(tp, tlm.zo_group_fn)
    step, init = tada.make_zo_momentum_step(
        lambda p, b, perturb=None: tlm.lm_loss(tc, p, b), spec, cfg)
    st, gs = init(), []
    for t in range(5):
        tp, st, m = step(tp, st, _tb(batch), t, 11)
        gs.append(float(m["projected_grad"]))

    def z_tree(t):                       # z(fold(11, t)) on its layers
        zp = tlm.params_from_numpy(tc, {k: np.zeros_like(v)
                                        for k, v in flat.items()}, "cpu")
        seed = trng.fold_py(11, t)
        masks, idxs, _ = tzo.stratified_select(spec, seed, cfg.n_drop)
        tzo.tree_axpy_(zp, spec, seed, 1.0, masks, idxs)
        return {k: v.astype(np.float64)
                for k, v in tlm.params_to_numpy(zp).items()}

    want = {k: v.astype(np.float64) for k, v in flat.items()}
    for t in range(5):
        for j in range(min(cfg.history, t + 1)):
            w = cfg.lr * cfg.beta ** j * gs[t - j]
            for k, z in z_tree(t - j).items():
                want[k] -= w * z
    for k, v in tlm.params_to_numpy(tp).items():
        np.testing.assert_allclose(v, want[k], atol=5e-5, rtol=5e-4,
                                   err_msg=k)


# ------------------------------------------------------------ first order
def _grads_by_path(leaves):
    """Per-layer gradients of ``lm.grad_leaves`` stacked back per path."""
    out = {}
    for path, layer, t in leaves:
        g = t.grad.detach().numpy()
        out.setdefault(path, []).append(g)
    return {k: np.stack(v) if len(v) > 1 or k.startswith("stages/")
            else v[0] for k, v in out.items()}


def test_fo_gradients_match_jax(setup):
    jc, tc, jp, flat, batch = setup
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(jc, p, b)))(jp, _jb(batch))
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    leaves = tlm.grad_leaves(tp)
    loss = tlm.lm_loss(tc, tp, _tb(batch), grad=True)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got, want = _grads_by_path(leaves), _flat(jg)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_fo_teacher_forced(setup, opt):
    """Two steps (the moments carry over): the reference's gradients
    through the port's clip and update."""
    jc, tc, jp, flat, batch = setup
    kw = dict(optimizer=opt, lr=3e-2, weight_decay=0.01, grad_clip=0.5)
    jcfg, tcfg = jfo.FOConfig(**kw), tfo.FOConfig(**kw)
    jstep = jax.jit(jfo.make_fo_step(lambda p, b: jlm.lm_loss(jc, p, b),
                                     jcfg))
    jgrad = jax.jit(jax.grad(lambda p, b: jlm.lm_loss(jc, p, b)))
    jst = jfo.init_state(jp, jcfg)
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    tst = tfo.init_state(tp, tcfg)
    for t in range(2):
        g = _flat(jgrad(jp, _jb(batch)))
        jp, jst, jm = jstep(jp, jst, _jb(batch), jnp.int32(t))
        grads = [torch.tensor(g[path][layer] if layer is not None
                              else g[path]) for path, layer, _ in tst.leaves]
        tst = tfo.apply_update(tst, grads, tcfg, tcfg.lr)
        _close_params(tlm.params_to_numpy(tp), _flat(jp))
    assert tst.count == 2


def test_fo_step_runs_autograd_through_the_model(setup):
    """``make_fo_step``: the loss of the reference, a finite update, and
    no gradient left on the leaves."""
    jc, tc, jp, flat, batch = setup
    tcfg = tfo.FOConfig(optimizer="adamw", lr=1e-3)
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    step = tfo.make_fo_step(lambda p, b: tlm.lm_loss(tc, p, b, grad=True),
                            tcfg)
    st = tfo.init_state(tp, tcfg)
    tp, st, m = step(tp, st, _tb(batch), 0)
    want = float(jlm.lm_loss(jc, jp, _jb(batch)))
    np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-5)
    assert all(t.grad is None for _, _, t in st.leaves)
    assert all(np.isfinite(v).all() for v in tlm.params_to_numpy(tp).values())


# ----------------------------------------------- FO with float32 masters
@pytest.fixture(scope="module")
def setup_bf16():
    jc = jopt.opt_tiny(layers=2, d_model=32, vocab=128).with_(
        dtype="bfloat16")
    tc = topt.opt_tiny(layers=2, d_model=32, vocab=128).with_(
        dtype="bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(9))
    r = np.random.default_rng(9)
    batches = []
    for _ in range(8):
        toks = r.integers(0, 128, (8, 12)).astype(np.int32)
        batches.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1),
                        "loss_mask": np.ones((8, 12), np.float32)})
    return jc, tc, jp, batches


def _ulps(got, want):
    """|got - want| in float32 ulps of want."""
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want) / np.spacing(
        np.maximum(np.abs(want), np.float32(1e-30)))


def _per_layer(state, arrays):
    """Reference arrays by path -> one per FO leaf (stacked ones split)."""
    return [arrays[p] if layer is None else arrays[p][layer]
            for p, layer, _ in state.leaves]


def _teacher(grads):
    """A loss whose gradient is ``grads``: drives the reference's own
    ``make_fo_step`` with given gradients (teacher forcing)."""
    @jax.custom_vjp
    def f(p):
        return jnp.float32(0.0)

    f.defvjp(lambda p: (jnp.float32(0.0), None), lambda _, ct: (grads,))
    return lambda p, b: f(p)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_fo_master_weights_teacher_forced(setup_bf16, opt):
    """bf16 parameters under a clip scale: the reference's jitted update
    makes them float32; the port's float32 masters and moments equal
    them within 1 float32 ulp after 1 and 3 steps of the reference's
    gradients, and the bf16 leaves are the masters rounded.  The clip
    never binds here (its scale is exactly 1.0 in both packages; the
    global norms are float32 sums in different orders, which the float32
    teacher-forced test above covers)."""
    jc, tc, jp, batches = setup_bf16
    kw = dict(optimizer=opt, lr=1e-2, weight_decay=0.01, grad_clip=1e6)
    jcfg, tcfg = jfo.FOConfig(**kw), tfo.FOConfig(**kw)
    jgrad = jax.jit(jax.grad(lambda p, b: jlm.lm_loss(jc, p, b)))
    jst = jfo.init_state(jp, jcfg)
    tp = tlm.params_from_numpy(tc, _flat(jp), "cpu")
    tst = tfo.init_state(tp, tcfg)
    assert all((m is None) == (t.dtype == torch.float32)
               for (_, _, t), m in zip(tst.leaves, tst.master))
    for t in range(3):
        g = jgrad(jp, _jb(batches[t]))
        jp, jst, _ = jax.jit(jfo.make_fo_step(_teacher(g), jcfg))(
            jp, jst, _jb(batches[t]), jnp.int32(t))
        tst = tfo.apply_update(tst, [tlm.tensor_from_numpy(x) for x in
                                     _per_layer(tst, _flat(g))], tcfg,
                               tcfg.lr)
        if t not in (0, 2):
            continue
        for (path, layer, leaf), m, w in zip(tst.leaves, tst.master,
                                             _per_layer(tst, _flat(jp))):
            assert w.dtype == np.float32, path
            got = (leaf if m is None else m).detach().float().numpy()
            assert _ulps(got, w).max() <= 1, (t, path, layer)
            if m is not None:
                assert torch.equal(leaf.detach(), m.to(leaf.dtype))
        names = {"sgd": (), "momentum": ("mu",), "adamw": ("mu", "nu")}
        for name in names[opt]:
            for (path, layer, _), mt, w in zip(
                    tst.leaves, getattr(tst, name),
                    _per_layer(tst, _flat(getattr(jst, name)))):
                assert mt.dtype == torch.float32
                assert _ulps(mt.numpy(), w).max() <= 1, (t, name, path)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adamw"])
def test_fo_plain_arithmetic_teacher_forced(setup_bf16, opt):
    """The card's update (``PLAIN``: the reference's source order, each
    operation rounded to float32), driven on the CPU, against the
    reference's jitted update on the same gradients for 3 steps.  XLA
    fuses the multiply-adds, so the two round differently: masters
    within atol 1e-6 (the float32 teacher-forced bound above; 8.9e-8
    read), moments within 1e-6 of the leaf's largest moment (1.4e-7
    read)."""
    jc, tc, jp, batches = setup_bf16
    kw = dict(optimizer=opt, lr=1e-2, weight_decay=0.01, grad_clip=1e6)
    jcfg, tcfg = jfo.FOConfig(**kw), tfo.FOConfig(**kw)
    jgrad = jax.jit(jax.grad(lambda p, b: jlm.lm_loss(jc, p, b)))
    jst = jfo.init_state(jp, jcfg)
    tp = tlm.params_from_numpy(tc, _flat(jp), "cpu")
    tst = tfo.init_state(tp, tcfg)
    names = {"sgd": (), "momentum": ("mu",), "adamw": ("mu", "nu")}[opt]
    for t in range(3):
        g = jgrad(jp, _jb(batches[t]))
        jp, jst, _ = jax.jit(jfo.make_fo_step(_teacher(g), jcfg))(
            jp, jst, _jb(batches[t]), jnp.int32(t))
        tst = tfo.apply_update(tst, [tlm.tensor_from_numpy(x) for x in
                                     _per_layer(tst, _flat(g))], tcfg,
                               tcfg.lr, arith=tfo.PLAIN)
        for (path, layer, leaf), m, w in zip(tst.leaves, tst.master,
                                             _per_layer(tst, _flat(jp))):
            got = (leaf if m is None else m).detach().float().numpy()
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6,
                                       err_msg=f"{t} {path} {layer}")
        for n in names:
            for (path, _, _), mt, w in zip(
                    tst.leaves, getattr(tst, n),
                    _per_layer(tst, _flat(getattr(jst, n)))):
                np.testing.assert_allclose(
                    mt.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                    err_msg=f"{t} {n} {path}")


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_fo_bf16_without_clip_stays_bf16(setup_bf16, opt):
    """Without a clip scale the reference's SGD/momentum keep bf16
    parameters, and so does the port: no master copy, moments in bf16."""
    jc, tc, jp, batches = setup_bf16
    kw = dict(optimizer=opt, lr=1e-2, grad_clip=None)
    jst = jfo.init_state(jp, jfo.FOConfig(**kw))
    jnew, _, _ = jax.jit(jfo.make_fo_step(
        lambda p, b: jlm.lm_loss(jc, p, b), jfo.FOConfig(**kw)))(
        jp, jst, _jb(batches[0]), jnp.int32(0))
    assert [a.dtype for a in jax.tree.leaves(jnew)] == [
        a.dtype for a in jax.tree.leaves(jp)]
    tp = tlm.params_from_numpy(tc, _flat(jp), "cpu")
    st = tfo.init_state(tp, tfo.FOConfig(**kw))
    assert all(m is None for m in st.master)
    assert all(m.dtype == t.dtype for (_, _, t), m in zip(
        st.leaves, st.mu or []))
    tfo.make_fo_step(lambda p, b: tlm.lm_loss(tc, p, b, grad=True),
                     tfo.FOConfig(**kw))(tp, st, _tb(batches[0]), 0)
    assert {n: p.dtype for n, p in tp.named_parameters()} == {
        n: p.dtype for n, p in tlm.params_from_numpy(
            tc, _flat(jp), "cpu").named_parameters()}


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_fo_trajectory_bf16_within_band(setup_bf16, opt):
    """8 steps of both packages from the same bf16 weights and batches.
    The reference's forward runs in float32 after its first update, the
    port's stays bf16 (its master weights are float32), so the losses
    agree within a band: rtol 2e-2."""
    jc, tc, jp, batches = setup_bf16
    kw = dict(optimizer=opt, lr=3e-2 if opt == "sgd" else 3e-3)
    jstep = jax.jit(jfo.make_fo_step(lambda p, b: jlm.lm_loss(jc, p, b),
                                     jfo.FOConfig(**kw)))
    jst = jfo.init_state(jp, jfo.FOConfig(**kw))
    tcfg = tfo.FOConfig(**kw)
    tp = tlm.params_from_numpy(tc, _flat(jp), "cpu")
    tstep = tfo.make_fo_step(lambda p, b: tlm.lm_loss(tc, p, b, grad=True),
                             tcfg)
    tst = tfo.init_state(tp, tcfg)
    want, got = [], []
    for t, b in enumerate(batches):
        jp, jst, jm = jstep(jp, jst, _jb(b), jnp.int32(t))
        tp, tst, tm = tstep(tp, tst, _tb(b), t)
        want.append(float(jm["loss"]))
        got.append(float(tm["loss"]))
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert want[-1] < want[0] and got[-1] < got[0]   # both learn


# ----------------------------------------------------------------- quorum
@pytest.mark.parametrize("n_sh,quorum", [(4, 0.75), (8, 0.5), (2, 0.5)])
def test_quorum_arrived_bitwise(setup, n_sh, quorum):
    labels = np.random.default_rng(n_sh).integers(0, 128, (16, 12))
    n_ok = max(1, int(round(quorum * n_sh)))
    # the reference's expression (repro/train/trainer.py quorum_loss)
    tag = jnp.sum(jnp.asarray(labels)[:, -1]).astype(jnp.uint32)
    bits = jrng.mix32(jnp.arange(n_sh, dtype=jnp.uint32) * jnp.uint32(
        0x9E3779B9) + jrng.fold(tag, jnp.uint32(0xFA11)))
    want = np.asarray(jnp.argsort(bits) < n_ok)
    got = ttrainer.quorum_arrived(torch.tensor(labels), n_sh, n_ok)
    assert np.array_equal(got.numpy(), want)


def test_quorum_loss_matches_reference_trainer():
    spec = japi.with_overrides(japi.preset("tiny-smoke"), {
        "runtime.n_loss_shards": 4, "runtime.quorum": 0.75})
    jt = JTrainer.from_spec(spec)
    data = jt.make_dataset(8)
    want = float(jt.loss_fn(jt.trainable, jt._model_batch(data)))
    tt = ttrainer.Trainer.from_spec(tapi.from_json(japi.to_json(spec)),
                                    device="cpu",
                                    params=tlm.params_from_numpy(
                                        jt.mcfg, _flat(jt.trainable), "cpu"))
    got = float(tt.loss_fn(tt.params, tt._model_batch(data)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------------- trajectory
@pytest.mark.parametrize("overrides", [
    {"optimizer.mode": "zo_momentum"},
    {"optimizer.mode": "fo"},
    {"estimator.name": "one_sided", "estimator.q": 3,
     "runtime.n_loss_shards": 4, "runtime.quorum": 0.75},
])
def test_trajectory_matches_reference(overrides):
    """(The reference's quorum loss takes only scalar losses, so the
    quorum case runs materialized.)"""
    spec = japi.with_overrides(japi.preset("tiny-smoke"),
                               {**overrides, "run.steps": 4})
    want = np.array(japi.run(spec)["history"]["loss"])
    jp = jlm.init_params(japi.derive(spec).model_cfg,
                         jax.random.PRNGKey(spec.run.seed))
    tspec = tapi.from_json(japi.to_json(spec))
    params = tlm.params_from_numpy(tapi.derive(tspec).model_cfg, _flat(jp),
                                   "cpu")
    got = np.array(tapi.run(tspec, device="cpu",
                            params=params)["history"]["loss"])
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-3)


# -------------------------------------------------------------- validator
@pytest.mark.parametrize("name", ["fzoo-opt13b-q16", "fo-opt13b",
                                  "mezo-opt13b"])
def test_validator_accepts_presets(name):
    d = tapi.derive(tapi.preset(name))
    jd = japi.derive(japi.preset(name))
    assert d.n_drop == jd.n_drop
    assert d.tcfg.mode == jd.tcfg.mode
    assert dataclasses.asdict(d.fo_cfg) == dataclasses.asdict(jd.fo_cfg)
    for f in ("name", "q", "q_chunk", "inner", "importance_decay", "eps",
              "lr", "n_drop", "forward_backend"):
        assert getattr(d.est_cfg, f) == getattr(jd.est_cfg, f), f


@pytest.mark.parametrize("override,path", [
    ({"runtime.mesh": "multi_pod"}, "runtime.mesh"),
    ({"model.arch": "xlstm-350m"}, "model.arch"),
    ({"model.arch": "internlm2-1.8b"}, "model.arch"),
    ({"model.arch": "jamba-v0.1-52b"}, "model.arch"),
])
def test_validator_still_rejects_unported(override, path):
    spec = tapi.with_overrides(tapi.preset("fo-opt13b"), override)
    with pytest.raises(tapi.SpecError, match="not yet ported") as e:
        tapi.validate(spec)
    assert e.value.path == path


@pytest.mark.parametrize("override,path", [
    ({"optimizer.mode": "zo_momentum",
      "runtime.forward_backend": "virtual"}, "optimizer.mode"),
    ({"runtime.backend": "gather", "optimizer.policy": "uniform"},
     "optimizer.policy"),
    ({"runtime.n_loss_shards": 3}, "run.batch_size"),
    ({"run.ckpt_every": 5}, "run.ckpt_dir"),
    ({"estimator.inner": "importance"}, "estimator.inner"),
])
def test_validator_keeps_reference_rules(override, path):
    spec = tapi.with_overrides(tapi.preset("lezo-opt13b"), override)
    with pytest.raises(tapi.SpecError) as e:
        tapi.validate(spec)
    assert e.value.path == path
    with pytest.raises(japi.SpecError) as je:
        japi.validate(japi.with_overrides(japi.preset("lezo-opt13b"),
                                          override))
    assert je.value.path == path

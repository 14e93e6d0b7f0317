"""Port parity of the estimators other than two-point: one_sided,
averaged and importance, against ``repro.estimators`` on a tiny OPT.

Bit for bit: direction seeds, the weighted and global layer masks, the
active-parameter counts, and the cost counts of every estimator.
Teacher-forced: each estimator's losses within rtol 1e-5 of the
reference's, then the reference's coefficients fed to the port's update
and the parameters compared at atol 1e-6.  Within the port: stacked
one_sided probes equal the per-probe loop bit for bit, ``q_chunk`` does
not change a bit, averaged at q = 1 matches two_point to the reference's
tolerance (atol 2e-6), and the importance scores keep their size and
move only on active layers.  K3's probe grouping for P > 2 is pure
Python and is checked here too.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import estimators as jest
from repro.configs import opt as jopt
from repro.core import zo as jzo
from repro.estimators import costs as jcosts
from repro.models import lm as jlm
from repro_torch import estimators as test_
from repro_torch.configs import opt as topt
from repro_torch.core import rng as trng
from repro_torch.core import zo as tzo
from repro_torch.fused import matmul as fmm
from repro_torch.models import lm as tlm

torch.set_num_threads(2)              # six xdist workers share the CPUs

LR = 2e-2


@pytest.fixture(scope="module")
def setup():
    jc = jopt.opt_tiny(layers=4, d_model=32, vocab=128)
    tc = topt.opt_tiny(layers=4, d_model=32, vocab=128)
    jp = jax.jit(lambda k: jlm.init_params(jc, k))(jax.random.PRNGKey(2))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    r = np.random.default_rng(2)
    toks = r.integers(0, 128, (4, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "loss_mask": np.ones((4, 12), np.float32)}
    return jc, tc, jp, flat, batch


def _tloss(tc):
    return lambda p, b, perturb=None: tlm.lm_loss(tc, p, b, perturb=perturb)


def _tparams(setup):
    _, tc, _, flat, _ = setup
    return tlm.params_from_numpy(tc, flat, "cpu")


def _tbatch(setup):
    return {k: torch.tensor(v) for k, v in setup[4].items()}


# ------------------------------------------------------------ bit for bit
@pytest.mark.parametrize("q", [1, 3, 16])
def test_direction_seeds_bitwise(q):
    for seed in (0, 77, 0xFFFFFFFF):
        want = [int(s) for s in jest.direction_seeds(jnp.uint32(seed), q)]
        assert list(test_.direction_seeds(seed, q)) == want


SLICES = {"a": (0, 3), "b": (3, 7), "c": (10, 2)}


@pytest.mark.parametrize("seed,n_drop", [(1, 0), (5, 4), (99, 9), (2024, 6)])
def test_stratified_select_weighted_bitwise(seed, n_drop):
    js = jzo.ZOSpec((), (), SLICES, 12)
    ts = tzo.ZOSpec((), (), SLICES, 12)
    w = np.random.default_rng(seed).gamma(0.7, size=12).astype(np.float32)
    w[3] = 0.0                                # clipped to 1e-9
    jm, ji, jn = jzo.stratified_select_weighted(js, jnp.uint32(seed), n_drop,
                                                jnp.asarray(w))
    tm, ti, tn = tzo.stratified_select_weighted(ts, seed, n_drop,
                                                torch.tensor(w))
    assert tn == int(jn)
    for g in SLICES:
        assert np.array_equal(tm[g].numpy(), np.asarray(jm[g]))
        assert np.array_equal(ti[g].numpy(), np.asarray(ji[g]))
    jg = np.asarray(jzo.global_layer_mask(js, jm))
    assert np.array_equal(tzo.global_layer_mask(ts, tm).numpy(), jg)


@pytest.mark.parametrize("n_drop", [0, 2, 3])
def test_active_param_count_bitwise(setup, n_drop):
    _, _, jp, _, _ = setup
    tp = _tparams(setup)
    js, ts = (jzo.build_spec(jp, jlm.zo_group_fn),
              tzo.build_spec(tp, tlm.zo_group_fn))
    shapes = tzo.leaf_shapes(tp)
    assert dict(zip(ts.paths, shapes)) == dict(zip(js.paths,
                                                   jzo.leaf_shapes(jp)))
    jm, _, _ = jzo.stratified_select(js, jnp.uint32(31), n_drop)
    tm, _, _ = tzo.stratified_select(ts, 31, n_drop)
    want = np.float32(jzo.active_param_count(js, shapes, jm))
    got = tzo.active_param_count(ts, shapes, tm)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name,q,fused,fb", [
    (n, q, f, fb) for n in jcosts.ESTIMATORS for q in (1, 4)
    for f in (True, False) for fb in jcosts.FORWARD_BACKENDS])
def test_step_counts_match_reference(name, q, fused, fb):
    kw = dict(q=q, fused_update=fused, num_layers=40, forward_backend=fb)
    assert test_.costs.step_counts(name, **kw) == jcosts.step_counts(name,
                                                                     **kw)


@pytest.mark.parametrize("active,want", [
    ((True, False, True, True, False), [[0, 2], [3], [1, 4]]),
    ((False,) * 4, [[0, 1], [2, 3]]),
    ((True,) * 3, [[0, 1], [2]]),
])
def test_probe_groups(active, want):
    """K3 at P > 2: groups of at most two of one activity, active first."""
    assert fmm.probe_groups(active) == want


# ---------------------------------------------------------- teacher-forced
CASES = [
    ("one_sided", 3, "materialized"), ("one_sided", 3, "virtual_ref"),
    ("averaged", 2, "materialized"), ("averaged", 2, "virtual_ref"),
    ("importance", 1, "materialized"), ("importance", 1, "virtual_ref"),
]


def _cfg(mod, name, q, fb, **kw):
    kw = {"weight_decay": 0.1, **kw}
    return mod.EstimatorConfig(name=name, q=q, eps=1e-3, lr=LR, n_drop=2,
                               backend="dense", forward_backend=fb, **kw)


@pytest.mark.parametrize("name,q,fb", CASES)
def test_teacher_forced_estimator_step(setup, name, q, fb):
    jc, tc, jp, _, batch = setup
    base, t = 77, 3
    jstep, jinit = jest.make_step(
        lambda p, b, perturb=None: jlm.lm_loss(jc, p, b, perturb=perturb),
        jzo.build_spec(jp, jlm.zo_group_fn), _cfg(jest, name, q, fb))
    jstate = jinit()
    jp_new, jstate_new, jm = jax.jit(jstep)(
        jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.int32(t), jnp.uint32(base))
    want = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp_new)}

    tp = _tparams(setup)
    tspec = tzo.build_spec(tp, tlm.zo_group_fn)
    cfg = _cfg(test_, name, q, fb)
    est = test_.build_estimator(tspec, cfg)
    state = est.init_state()
    tp, dirs, met = est.estimate(_tloss(tc), tp, _tbatch(setup),
                                 trng.fold_py(base, t), state)
    np.testing.assert_allclose(met["loss"], float(jm["loss"]), rtol=1e-5)
    assert met["active_layers"] == int(jm["active_layers"])
    # teacher forcing: the reference's coefficients drive the update
    dirs = dataclasses.replace(dirs, coeffs=tuple(
        np.float32(c) for c in np.asarray(jm["coeffs"])))
    est.apply_update(tp, dirs, LR, 1.0 - LR * cfg.weight_decay)
    got = tlm.params_to_numpy(tp)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)
    sel = sum(tzo.global_layer_mask(tspec, m).to(torch.int32)
              for m in dirs.masks).numpy()
    assert np.array_equal(sel, np.asarray(jm["layer_sel"]))
    if name == "importance":
        imp = est.update_state(state, dirs, met)["imp"].numpy()
        np.testing.assert_allclose(imp, np.asarray(jstate_new["imp"]),
                                   rtol=1e-6)


# ------------------------------------------------------------ within port
def _run_steps(setup, cfg, steps=2):
    tp = _tparams(setup)
    step, init = test_.make_step(_tloss(setup[1]),
                                 tzo.build_spec(tp, tlm.zo_group_fn), cfg)
    state, mets = init(), []
    for t in range(steps):
        tp, state, m = step(tp, state, _tbatch(setup), t, 5)
        mets.append(m)
    return tlm.params_to_numpy(tp), mets, state


def _assert_same_run(a, b):
    for ma, mb in zip(a[1], b[1]):
        for key in ("loss", "probe_grads", "coeffs"):
            assert np.array_equal(ma[key], mb[key]), key
    for k, v in a[0].items():
        assert np.array_equal(v, b[0][k]), k


@pytest.mark.parametrize("fb", ["virtual_ref", "virtual"])
def test_one_sided_stacked_bitwise_matches_per_probe(setup, fb):
    runs = [_run_steps(setup, _cfg(test_, "one_sided", 4, fb,
                                   paired_probes=paired))
            for paired in (True, False)]
    _assert_same_run(*runs)


@pytest.mark.parametrize("q_chunk", [1, 3])
def test_one_sided_q_chunk_bitwise(setup, q_chunk):
    runs = [_run_steps(setup, _cfg(test_, "one_sided", 4, "virtual",
                                   q_chunk=qc))
            for qc in (0, q_chunk)]
    _assert_same_run(*runs)


def test_averaged_q1_matches_two_point(setup):
    """No weight decay, as in the reference's test: two_point's fused
    update decays the perturbed parameters, averaged's the restored."""
    runs = [_run_steps(setup, _cfg(test_, name, 1, "materialized",
                                   weight_decay=0.0), steps=1)
            for name in ("two_point", "averaged")]
    for k, v in runs[0][0].items():
        np.testing.assert_allclose(runs[1][0][k], v, atol=2e-6, err_msg=k)
    np.testing.assert_allclose(runs[1][1][0]["projected_grad"],
                               runs[0][1][0]["projected_grad"], rtol=1e-5)


def test_importance_state_adapts_and_stays_small(setup):
    cfg = _cfg(test_, "importance", 1, "virtual_ref")
    _, mets, state = _run_steps(setup, cfg, steps=3)
    imp = state["imp"]
    assert imp.shape == (4,) and imp.dtype == torch.float32
    sel = sum(m["layer_sel"] for m in mets)
    assert np.all(imp.numpy()[sel == 0] == 1.0)   # never active: untouched
    assert np.all(imp.numpy()[sel > 0] != 1.0)
    assert test_.costs.step_counts(
        "importance", num_layers=4, forward_backend="virtual_ref")[
        "state_scalars"] == imp.numel()


@pytest.mark.parametrize("name,q", list(itertools.product(
    ("one_sided", "averaged"), (2,))))
def test_step_axpy_sweeps_match_cost_counts(setup, monkeypatch, name, q):
    for fb in ("materialized", "virtual"):
        calls = []
        real = tzo.tree_axpy_
        monkeypatch.setattr(tzo, "tree_axpy_",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
        _run_steps(setup, _cfg(test_, name, q, fb), steps=1)
        monkeypatch.setattr(tzo, "tree_axpy_", real)
        assert len(calls) == test_.costs.step_counts(
            name, q=q, forward_backend=fb)["axpy_sweeps"], fb

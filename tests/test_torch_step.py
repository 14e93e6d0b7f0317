"""Port parity: one two-point step of ``repro_torch.estimators`` against
``repro.estimators``, teacher-forced — the port's probe losses within
rtol 1e-5 of the reference's, then the reference's projected gradient
fed to the port's update and the parameters compared at atol 1e-6.
Within the port, paired and unpaired virtual steps agree bit for bit and
a virtual step writes the parameters exactly once."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import estimators as jest
from repro.configs import opt as jopt
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro_torch import estimators as test_
from repro_torch.configs import opt as topt
from repro_torch.core import rng as trng
from repro_torch.core import zo as tzo
from repro_torch.models import lm as tlm

torch.set_num_threads(2)              # six xdist workers share the CPUs

LR = 2e-2


@pytest.fixture(scope="module")
def setup():
    jc = jopt.opt_tiny(layers=4, d_model=32, vocab=128)
    tc = topt.opt_tiny(layers=4, d_model=32, vocab=128)
    jp = jax.jit(lambda k: jlm.init_params(jc, k))(jax.random.PRNGKey(1))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    r = np.random.default_rng(1)
    toks = r.integers(0, 128, (4, 12)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "loss_mask": np.ones((4, 12), np.float32)}
    return jc, tc, jp, flat, batch


def _cfgs(fb, backend, paired=True):
    kw = dict(eps=1e-3, lr=LR, n_drop=2, backend=backend, weight_decay=0.1,
              forward_backend=fb, paired_probes=paired)
    return jest.EstimatorConfig(**kw), test_.EstimatorConfig(**kw)


_REFERENCE = {}


def _reference_step(setup, fb):
    """The reference's step (dense axpy: every backend draws the same z),
    computed once per forward backend."""
    if fb not in _REFERENCE:
        jc, _, jp, _, batch = setup
        jcfg = _cfgs(fb, "dense")[0]
        jstep, init = jest.make_step(
            lambda p, b, perturb=None: jlm.lm_loss(jc, p, b,
                                                   perturb=perturb),
            jzo.build_spec(jp, jlm.zo_group_fn), jcfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jp_new, _, jm = jax.jit(jstep)(jp, init(), jb, jnp.int32(3),
                                       jnp.uint32(77))
        _REFERENCE[fb] = (jm, {
            jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp_new)})
    return _REFERENCE[fb]


@pytest.mark.parametrize("fb,backend", [("materialized", "scan"),
                                        ("materialized", "pallas"),
                                        ("virtual_ref", "dense"),
                                        ("virtual", "pallas")])
def test_teacher_forced_step(setup, fb, backend):
    _, tc, _, flat, batch = setup
    tcfg = _cfgs(fb, backend)[1]
    jm, want = _reference_step(setup, fb if fb == "materialized"
                               else "virtual_ref")
    base, t = 77, 3
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    tspec = tzo.build_spec(tp, tlm.zo_group_fn)
    est = test_.build_estimator(tspec, tcfg)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    seed = trng.fold_py(base, t)
    loss_fn = lambda p, b, perturb=None: tlm.lm_loss(tc, p, b,
                                                     perturb=perturb)
    tp, dirs, met = est.estimate(loss_fn, tp, tb, seed)
    np.testing.assert_allclose(met["loss"], float(jm["loss"]), rtol=1e-5)
    assert met["active_layers"] == int(jm["active_layers"])
    # teacher forcing: the reference's g drives the port's update
    dirs = dataclasses.replace(
        dirs, coeffs=(np.float32(jm["projected_grad"]),))
    est.apply_update(tp, dirs, LR, 1.0 - LR * tcfg.weight_decay)
    got = tlm.params_to_numpy(tp)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("fb", ["virtual_ref", "virtual"])
def test_paired_step_bitwise_matches_unpaired(setup, fb):
    _, tc, _, flat, batch = setup
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    out = {}
    for paired in (True, False):
        tp = tlm.params_from_numpy(tc, flat, "cpu")
        spec = tzo.build_spec(tp, tlm.zo_group_fn)
        step, init = test_.make_step(
            lambda p, b, perturb=None: tlm.lm_loss(tc, p, b, perturb=perturb),
            spec, _cfgs(fb, "pallas", paired)[1])
        tp, _, met = step(tp, init(), tb, 5, 99)
        out[paired] = (met, tlm.params_to_numpy(tp))
    for key in ("l_plus", "l_minus", "projected_grad"):
        assert out[True][0][key] == out[False][0][key], key
    for k, v in out[True][1].items():
        assert np.array_equal(v, out[False][1][k]), k


@pytest.mark.parametrize("fb,sweeps", [("virtual", 1), ("materialized", 3)])
def test_step_axpy_sweep_count(setup, monkeypatch, fb, sweeps):
    _, tc, _, flat, batch = setup
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    spec = tzo.build_spec(tp, tlm.zo_group_fn)
    calls = []
    real = tzo.tree_axpy_
    monkeypatch.setattr(tzo, "tree_axpy_",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = _cfgs(fb, "pallas")[1]
    step, init = test_.make_step(
        lambda p, b, perturb=None: tlm.lm_loss(tc, p, b, perturb=perturb),
        spec, cfg)
    step(tp, init(), {k: torch.tensor(v) for k, v in batch.items()}, 0, 1)
    assert len(calls) == sweeps
    assert test_.costs.step_counts("two_point", forward_backend=fb)[
        "axpy_sweeps"] == sweeps

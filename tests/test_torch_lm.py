"""Port parity: the OPT forward and loss of ``repro_torch.models.lm`` on
weights made by ``repro.models.lm.init_params`` (through
``params_from_numpy``), f32 tiny model.  Plain, materialized-perturbed
and virtual (paired) losses within rtol 1e-5 of the reference; within
the port, virtual ≈ materialized."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fused as jfused
from repro.configs import opt as jopt
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro_torch import fused as tfused
from repro_torch.configs import opt as topt
from repro_torch.core import zo as tzo
from repro_torch.models import lm as tlm

EPS = 1e-3
SEED = 13


@pytest.fixture(scope="module")
def model():
    jc = jopt.opt_tiny(layers=2, d_model=64, vocab=256)
    tc = topt.opt_tiny(layers=2, d_model=64, vocab=256)
    jp = jax.jit(lambda k: jlm.init_params(jc, k))(jax.random.PRNGKey(0))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    r = np.random.default_rng(0)
    toks = r.integers(0, 256, (3, 16)).astype(np.int32)
    mask = (r.random((3, 16)) < 0.7).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(np.roll(toks, 1)),
          "loss_mask": jnp.asarray(mask)}
    tb = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
    return jc, tc, jp, flat, jb, tb


def _masks(jp, tp):
    jm, _, _ = jzo.stratified_select(jzo.build_spec(jp, jlm.zo_group_fn),
                                     jnp.uint32(SEED), 1)
    tm, ti, _ = tzo.stratified_select(tzo.build_spec(tp, tlm.zo_group_fn),
                                      SEED, 1)
    return jm, tm, ti


def test_params_round_trip(model):
    _, tc, _, flat, _, _ = model
    back = tlm.params_to_numpy(tlm.params_from_numpy(tc, flat, "cpu"))
    assert back.keys() == flat.keys()
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k


def test_loss_and_logits_match(model):
    jc, tc, jp, flat, jb, tb = model
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    want = float(jax.jit(lambda p, b: jlm.lm_loss(jc, p, b))(jp, jb))
    got = float(tlm.lm_loss(tc, tp, tb))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jh = jax.jit(lambda p, t: jlm.forward(jc, p, t)[0])(jp, jb["tokens"])
    th = tlm.forward(tc, tp, tb["tokens"])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tlm.logits_fn(tc, tp, th[:, -1]).numpy(),
                               np.asarray(jlm.logits_fn(jc, jp, jh[:, -1])),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fb", ["virtual_ref", "virtual"])
def test_virtual_pair_matches_reference_and_materialized(model, fb):
    jc, tc, jp, flat, jb, tb = model
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    jm, tm, ti = _masks(jp, tp)
    want = np.asarray(jax.jit(lambda p, b, m: jlm.lm_loss(
        jc, p, b, perturb=jfused.make_pair_ctx(jnp.uint32(SEED), EPS, m,
                                               "virtual_ref")))(jp, jb, jm))
    got = tlm.lm_loss(tc, tp, tb, perturb=tfused.make_pair_ctx(
        SEED, EPS, tm, fb)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # materialized probes in the port: perturb in place, loss, restore
    ts = tzo.build_spec(tp, tlm.zo_group_fn)
    mat = []
    for s in (EPS, -2 * EPS):
        tzo.tree_axpy_(tp, ts, SEED, s, tm, ti, backend="scan")
        mat.append(float(tlm.lm_loss(tc, tp, tb)))
    np.testing.assert_allclose(got, mat, rtol=1e-5)


def test_materialized_probe_matches_reference(model):
    jc, tc, jp, flat, jb, tb = model
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    jm, tm, ti = _masks(jp, tp)
    js = jzo.build_spec(jp, jlm.zo_group_fn)
    want = float(jax.jit(lambda p, b, m: jlm.lm_loss(jc, jzo.tree_axpy(
        p, js, jnp.uint32(SEED), EPS, m, backend="dense"), b))(jp, jb, jm))
    tzo.tree_axpy_(tp, tzo.build_spec(tp, tlm.zo_group_fn), SEED, EPS, tm,
                   ti, backend="pallas")
    np.testing.assert_allclose(float(tlm.lm_loss(tc, tp, tb)), want,
                               rtol=1e-5)

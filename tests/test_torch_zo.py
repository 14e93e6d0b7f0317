"""Port parity: layer selection and the tree axpy of
``repro_torch.core.zo`` against ``repro.core.zo``.

Masks and active indices must equal the reference's exactly; the axpy on
every backend matches the reference's dense pass within rtol 1e-6 on
active rows and leaves masked-off rows bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro.configs import opt as jopt
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch.configs import opt as topt
from repro_torch.core import zo as tzo
from repro_torch.launch import specs as tspecs
from repro_torch.models import lm as tlm

torch.set_num_threads(2)              # six xdist workers share the CPUs


def _flat(params):
    return {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(params)}


@pytest.fixture(scope="module")
def tiny():
    jc = jopt.opt_tiny(layers=4, d_model=32, vocab=64)
    tc = topt.opt_tiny(layers=4, d_model=32, vocab=64)
    jp = jax.jit(lambda k: jlm.init_params(jc, k))(jax.random.PRNGKey(0))
    return jc, tc, jp, tlm.params_from_numpy(tc, _flat(jp), "cpu")


def _multi_group_specs():
    slices = {"s0.b0": (0, 40), "s0.b1": (40, 7), "s1.b0": (47, 13)}
    return (jzo.ZOSpec(("a",), (None,), slices, 60),
            tzo.ZOSpec(("a",), (None,), slices, 60))


def test_spec_paths_and_groups_match(tiny):
    _, _, jp, tp = tiny
    js = jzo.build_spec(jp, jlm.zo_group_fn)
    ts = tzo.build_spec(tp, tlm.zo_group_fn)
    assert dict(zip(js.paths, js.groups)) == dict(zip(ts.paths, ts.groups))
    assert js.slices == ts.slices and js.num_layers == ts.num_layers


@pytest.mark.parametrize("n_drop", [0, 30, 45])
def test_stratified_and_uniform_select_match(n_drop):
    js, ts = _multi_group_specs()
    assert js.quotas(n_drop) == ts.quotas(n_drop)
    strat = jax.jit(lambda s: jzo.stratified_select(js, s, n_drop)[:2])
    unif = jax.jit(lambda s: jzo.uniform_select(js, s, n_drop)[0])
    r = np.random.default_rng(n_drop)
    for seed, step in zip(r.integers(0, 2 ** 32, 20).tolist(),
                          r.integers(0, 10 ** 6, 20).tolist()):
        s = jzo.rng.fold_py(seed, step)
        jm, ji = strat(jnp.uint32(s))
        tm, ti, tn = tzo.stratified_select(ts, s, n_drop)
        assert tn == 60 - n_drop
        for g in js.slices:
            assert np.array_equal(np.asarray(jm[g]), tm[g].numpy())
            assert np.array_equal(np.asarray(ji[g]), ti[g].numpy())
        jm = unif(jnp.uint32(s))
        tm, _, tn = tzo.uniform_select(ts, s, n_drop)
        assert tn == 60 - n_drop
        for g in js.slices:
            assert np.array_equal(np.asarray(jm[g]), tm[g].numpy())


@pytest.mark.parametrize("backend", ["dense", "scan", "gather", "pallas"])
def test_tree_axpy_matches_reference_dense(tiny, backend):
    _, tc, jp, _ = tiny
    js = jzo.build_spec(jp, jlm.zo_group_fn)
    seed = 0xABCDEF
    jm, ji, _ = jzo.stratified_select(js, jnp.uint32(seed), 2)
    want = _flat(jax.jit(lambda p, m: jzo.tree_axpy(
        p, js, jnp.uint32(seed), 3e-3, m, decay=0.999,
        backend="dense"))(jp, jm))
    tp = tlm.params_from_numpy(tc, _flat(jp), "cpu")
    ts = tzo.build_spec(tp, tlm.zo_group_fn)
    tm, ti, _ = tzo.stratified_select(ts, seed, 2)
    tzo.tree_axpy_(tp, ts, seed, 3e-3, tm, ti, decay=0.999, backend=backend)
    got = tlm.params_to_numpy(tp)
    before = _flat(jp)
    for path, w in want.items():
        group = tlm.zo_group_fn(path)
        if group is None:
            np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=1e-9)
            continue
        m = tm[group].numpy()
        np.testing.assert_allclose(got[path][m], w[m], rtol=1e-6, atol=1e-9)
        assert np.array_equal(got[path][~m], before[path][~m]), path


def test_tree_axpy_bf16_masked_rows_untouched():
    cfg = topt.opt_tiny(layers=4, d_model=32, vocab=64).with_(
        dtype="bfloat16")
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    ts = tzo.build_spec(tp, tlm.zo_group_fn)
    tm, ti, _ = tzo.stratified_select(ts, 11, 3)
    tzo.tree_axpy_(tp, ts, 11, 1e-2, tm, ti, backend="pallas")
    for n, p in tp.named_parameters():
        if n.startswith("stages."):
            m = tm["s0.b0"]
            assert torch.equal(p[~m], before[n][~m])
            assert not torch.equal(p[m], before[n][m])
        else:
            assert not torch.equal(p, before[n])


# (arch, published layers, LeZO's n_drop at the preset's sparsity 0.75)
PUBLISHED = [("codeqwen1.5-7b", 32, 24), ("internlm2-1.8b", 24, 18),
             ("musicgen-large", 48, 36), ("internvl2-2b", 24, 18),
             ("deepseek-v2-lite-16b", 27, 20)]


@pytest.mark.parametrize("arch,layers,n_drop", PUBLISHED,
                         ids=[a for a, _, _ in PUBLISHED])
def test_stratified_select_at_published_depth(arch, layers, n_drop):
    """LeZO's selection on each config at its published depth, width and
    stage pattern (shapes only: ``jax.eval_shape`` of the reference's
    init, the port's meta parameters), at the n_drop each package
    derives from the preset: masks and active indices bit for bit over
    16 seeds."""
    over = {"model.arch": arch, "model.variant": "full"}
    jd = japi.derive(japi.with_overrides(japi.preset("lezo-opt13b"), over))
    td = tapi.derive(tapi.with_overrides(tapi.preset("lezo-opt13b"), over))
    assert jd.n_drop == td.n_drop == n_drop
    jc, tc = jconfigs.get(arch, "full"), tconfigs.get(arch, "full")
    js = jzo.build_spec(jax.eval_shape(lambda k: jlm.init_params(jc, k),
                                       jax.random.PRNGKey(0)),
                        jlm.zo_group_fn)
    ts = tzo.build_spec(tspecs.param_specs(tc), tlm.zo_group_fn)
    assert js.slices == ts.slices and ts.num_layers == layers
    assert js.quotas(n_drop) == ts.quotas(n_drop)
    strat = jax.jit(lambda s: jzo.stratified_select(js, s, n_drop)[:2])
    r = np.random.default_rng(layers)
    for seed, step in zip(r.integers(0, 2 ** 32, 16).tolist(),
                          r.integers(0, 10 ** 6, 16).tolist()):
        s = jzo.rng.fold_py(seed, step)
        jm, ji = strat(jnp.uint32(s))
        tm, ti, tn = tzo.stratified_select(ts, s, n_drop)
        assert tn == layers - n_drop
        for g in js.slices:
            assert np.array_equal(np.asarray(jm[g]), tm[g].numpy())
            assert np.array_equal(np.asarray(ji[g]), ti[g].numpy())

"""Port parity of the dense model zoo (every ``attn + dense`` config:
rope, GQA, qk-norm, SwiGLU, tanh-GELU, LayerNorm, learned positions,
untied heads, stub frontends) against the JAX package, on each arch's
``smoke`` variant in float32.

Weights come from ``repro.models.lm.init_params`` through numpy, with
every norm scale and bias replaced by seeded random values (the
reference starts them at ones and zeros, where a missing multiply would
go unseen).  Stub-frontend archs take the same numpy embeddings in both
packages.  Tolerances, stated per test: hidden states and logits rtol
1e-4 / atol 1e-5; losses rtol 1e-5; teacher-forced parameters atol
1e-6; the components (rope, the FFN activations, the perturbed
qk-norm) rtol 1e-5 / atol 1e-6.

The reference's *paired* virtual loss fails on a stub-frontend arch (its
forward does not tile ``embeds`` over the probes); the port tiles them,
and its paired losses equal the reference's two unpaired ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import estimators as jest
from repro import fused as jfused
from repro.core import fo as jfo
from repro.core import zo as jzo
from repro.fused import ref as jfref
from repro.kernels import ops as jops
from repro.models import frontends as jfront
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import estimators as test_
from repro_torch import fused as tfused
from repro_torch import obs as tobs
from repro_torch.core import fo as tfo
from repro_torch.core import rng as trng
from repro_torch.core import zo as tzo
from repro_torch.fused import matmul as tfmm
from repro_torch.fused import ref as tfref
from repro_torch.kernels import ops as tops
from repro_torch.models import frontends as tfront
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from _port_cfg import as_reference

torch.set_num_threads(2)              # six xdist workers share the CPUs

ARCHS = ["qwen3-14b", "codeqwen1.5-7b", "internlm2-1.8b",
         "deepseek-coder-33b", "musicgen-large", "internvl2-2b"]
UNPORTED = ["jamba-v0.1-52b", "xlstm-350m"]
EPS = 1e-3
SEED = 21
LR = 2e-2
B, S = 3, 16

_MODELS = {}


def _flat(tree):
    return {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def model(arch):
    """(jax cfg, port cfg, jax params, flat numpy params, numpy batch),
    built once per arch; norm scales and biases random."""
    if arch not in _MODELS:
        jc, tc = jconfigs.get(arch, "smoke"), tconfigs.get(arch, "smoke")
        jp = jax.jit(lambda k: jlm.init_params(jc, k))(
            jax.random.PRNGKey(0))
        r = np.random.default_rng(3)
        flat = _flat(jp)
        for k, v in flat.items():
            if k.endswith("/scale"):
                flat[k] = (1.0 + 0.3 * r.standard_normal(v.shape)).astype(
                    v.dtype)
            elif k.endswith("/bias"):
                flat[k] = (0.1 * r.standard_normal(v.shape)).astype(v.dtype)
        jp = jax.tree_util.tree_map_with_path(
            lambda p, v: jnp.asarray(flat[jzo._path_str(p)]), jp)
        toks = r.integers(0, jc.vocab, (B, S)).astype(np.int32)
        batch = {"labels": np.roll(toks, -1, axis=1),
                 "loss_mask": (r.random((B, S)) < 0.8).astype(np.float32)}
        if jfront.uses_embeds(jc):
            e = r.standard_normal((B, S, jc.d_model)).astype(np.float32)
            batch["embeds"] = e / np.sqrt(np.mean(e ** 2, -1, keepdims=True))
        else:
            batch["tokens"] = toks
        _MODELS[arch] = (jc, tc, jp, flat, batch)
    return _MODELS[arch]


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _tparams(arch):
    _, tc, _, flat, _ = model(arch)
    return tlm.params_from_numpy(tc, flat, "cpu")


def _masks(arch, tp, n_drop=1):
    jp = model(arch)[2]
    jm, _, _ = jzo.stratified_select(jzo.build_spec(jp, jlm.zo_group_fn),
                                     jnp.uint32(SEED), n_drop)
    tm, ti, _ = tzo.stratified_select(tzo.build_spec(tp, tlm.zo_group_fn),
                                      SEED, n_drop)
    return jm, tm, ti


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    _, tc, jp, flat, _ = model(arch)
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    back = tlm.params_to_numpy(tp)
    assert back.keys() == flat.keys()
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k
    assert tlm.count_params(tp) == jlm.count_params(jp)
    assert tlm.count_active_params(tc, tp) == jlm.count_active_params(
        model(arch)[0], jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    """A seeded port model has the reference's leaves, shapes and
    dtypes: learned positions only where configured, ``head/w`` only
    when untied, float32 qk-norm scales."""
    jc, tc, jp, _, _ = model(arch)
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
           for p, t in tzo.leaf_items(tp)}
    want = {p: (v.shape, str(v.dtype)) for p, v in _flat(jp).items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_logits_match(arch):
    """Hidden states and logits: rtol 1e-4, atol 1e-5."""
    jc, tc, jp, _, batch = model(arch)
    jh = jax.jit(lambda p, t, e: jlm.forward(jc, p, t, embeds=e)[0])(
        jp, batch.get("tokens"), batch.get("embeds"))
    tb = _tb(batch)
    tp = _tparams(arch)
    th = tlm.forward(tc, tp, tb.get("tokens"), embeds=tb.get("embeds"))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        tlm.logits_fn(tc, tp, th[:, -1]).numpy(),
        np.asarray(jlm.logits_fn(jc, jp, jh[:, -1])), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches(arch):
    """``lm_loss``: rtol 1e-5."""
    jc, tc, jp, _, batch = model(arch)
    want = float(jax.jit(lambda p, b: jlm.lm_loss(jc, p, b))(jp, _jb(batch)))
    got = float(tlm.lm_loss(tc, _tparams(arch), _tb(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _reference_unpaired(arch, jm):
    """The reference's two unpaired virtual_ref probe losses (+eps, -eps),
    which work on every arch (its paired form fails on stub frontends)."""
    jc, _, jp, _, batch = model(arch)
    fn = jax.jit(lambda p, b, m, s: jlm.lm_loss(
        jc, p, b, perturb=jfused.make_ctx(jnp.uint32(SEED), s, m,
                                          "virtual_ref")))
    return [float(fn(jp, _jb(batch), jm, jnp.float32(s)))
            for s in (EPS, -EPS)]


@pytest.mark.parametrize("fb", ["virtual_ref", "virtual"])
@pytest.mark.parametrize("arch", ARCHS)
def test_virtual_pair_matches_reference_and_materialized(arch, fb):
    """The port's paired virtual losses against the reference's two
    unpaired ones (rtol 1e-5), and against the port's materialized
    probes (rtol 1e-5); paired equals unpaired in the port bit for
    bit."""
    _, tc, _, _, batch = model(arch)
    tp = _tparams(arch)
    jm, tm, ti = _masks(arch, tp)
    tb = _tb(batch)
    got = tlm.lm_loss(tc, tp, tb, perturb=tfused.make_pair_ctx(
        SEED, EPS, tm, fb)).numpy()
    np.testing.assert_allclose(got, _reference_unpaired(arch, jm),
                               rtol=1e-5)
    single = [float(tlm.lm_loss(tc, tp, tb, perturb=tfused.make_ctx(
        SEED, s, tm, fb))) for s in (EPS, -EPS)]
    assert got.tolist() == single
    ts = tzo.build_spec(tp, tlm.zo_group_fn)
    mat = []
    for s in (EPS, -2 * EPS):
        tzo.tree_axpy_(tp, ts, SEED, s, tm, ti, backend="scan")
        mat.append(float(tlm.lm_loss(tc, tp, tb)))
    np.testing.assert_allclose(got, mat, rtol=1e-5)


def test_paired_embeds_repair_against_reference():
    """Pins the reference fault the port routes around: on
    musicgen-large/smoke the reference's paired loss raises (``embeds``
    is not tiled over the probes), while the port's paired loss equals
    the reference's two unpaired losses (rtol 1e-5)."""
    arch = "musicgen-large"
    jc, tc, jp, _, batch = model(arch)
    tp = _tparams(arch)
    jm, tm, _ = _masks(arch, tp)
    with pytest.raises(TypeError):
        jlm.lm_loss(jc, jp, _jb(batch), perturb=jfused.make_pair_ctx(
            jnp.uint32(SEED), EPS, jm, "virtual_ref"))
    got = tlm.lm_loss(tc, tp, _tb(batch), perturb=tfused.make_pair_ctx(
        SEED, EPS, tm, "virtual_ref")).numpy()
    np.testing.assert_allclose(got, _reference_unpaired(arch, jm),
                               rtol=1e-5)


def _est_cfgs(name="two_point", q=1, fb="virtual_ref", paired=True):
    kw = dict(name=name, q=q, eps=EPS, lr=LR, n_drop=1, backend="dense",
              weight_decay=0.1, forward_backend=fb)
    return (jest.EstimatorConfig(**kw, paired_probes=paired),
            test_.EstimatorConfig(**kw))


def _teacher_forced(arch, name, q, fb, paired=True):
    """One reference step, then the port's probe losses (rtol 1e-5) and
    its update driven by the reference's coefficients (atol 1e-6)."""
    jc, tc, jp, _, batch = model(arch)
    base, t = 77, 3
    jcfg, tcfg = _est_cfgs(name, q, fb, paired)
    jstep, jinit = jest.make_step(
        lambda p, b, perturb=None: jlm.lm_loss(jc, p, b, perturb=perturb),
        jzo.build_spec(jp, jlm.zo_group_fn), jcfg)
    jp_new, _, jm = jax.jit(jstep)(jp, jinit(), _jb(batch), jnp.int32(t),
                                   jnp.uint32(base))
    tp = _tparams(arch)
    est = test_.build_estimator(tzo.build_spec(tp, tlm.zo_group_fn), tcfg)
    tp, dirs, met = est.estimate(
        lambda p, b, perturb=None: tlm.lm_loss(tc, p, b, perturb=perturb),
        tp, _tb(batch), trng.fold_py(base, t), est.init_state())
    np.testing.assert_allclose(met["loss"], float(jm["loss"]), rtol=1e-5)
    assert met["active_layers"] == int(jm["active_layers"])
    dirs = dataclasses.replace(dirs, coeffs=tuple(
        np.float32(c) for c in np.asarray(jm["coeffs"]).reshape(-1)))
    est.apply_update(tp, dirs, LR, 1.0 - LR * tcfg.weight_decay)
    got = tlm.params_to_numpy(tp)
    for k, w in _flat(jp_new).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_two_point_step(arch):
    """The virtual two-point step (paired in the port; unpaired in the
    reference where its paired form fails)."""
    _teacher_forced(arch, "two_point", 1, "virtual_ref",
                    paired=not jfront.uses_embeds(model(arch)[0]))


def test_teacher_forced_one_sided_materialized():
    """one_sided, q = 3, materialized, on qwen3-14b/smoke."""
    _teacher_forced("qwen3-14b", "one_sided", 3, "materialized")


def test_fo_teacher_forced_on_qwen3():
    """FO (AdamW with clipping) on qwen3-14b/smoke: the port's gradients
    against the reference's (rtol 1e-4, atol 1e-6), then two updates
    driven by the reference's gradients (atol 1e-6)."""
    arch = "qwen3-14b"
    jc, tc, jp, _, batch = model(arch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(jc, p, b)))(jp, _jb(batch))
    tp = _tparams(arch)
    leaves = tlm.grad_leaves(tp)
    loss = tlm.lm_loss(tc, tp, _tb(batch), grad=True)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for path, layer, t in leaves:
        want = _flat(jg)[path]
        np.testing.assert_allclose(
            t.grad.numpy(), want if layer is None else want[layer],
            rtol=1e-4, atol=1e-6, err_msg=path)
    kw = dict(optimizer="adamw", lr=3e-2, weight_decay=0.01, grad_clip=0.5)
    jcfg, tcfg = jfo.FOConfig(**kw), tfo.FOConfig(**kw)
    jstep = jax.jit(jfo.make_fo_step(lambda p, b: jlm.lm_loss(jc, p, b),
                                     jcfg))
    jgrad = jax.jit(jax.grad(lambda p, b: jlm.lm_loss(jc, p, b)))
    jst = jfo.init_state(jp, jcfg)
    tp = _tparams(arch)
    tst = tfo.init_state(tp, tcfg)
    for t in range(2):
        g = _flat(jgrad(jp, _jb(batch)))
        jp, jst, _ = jstep(jp, jst, _jb(batch), jnp.int32(t))
        tst = tfo.apply_update(
            tst, [torch.tensor(g[path] if layer is None else g[path][layer])
                  for path, layer, _ in tst.leaves], tcfg, tcfg.lr)
        got = tlm.params_to_numpy(tp)
        for k, w in _flat(jp).items():
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("arch", ["qwen3-14b", "musicgen-large"])
def test_tile_counters_follow_the_kernel_grid(arch):
    """The ``w_tile_loads``/``z_regens`` counters of one paired virtual
    loss equal K3/K4's grid over ``model_matmuls``: each layer's
    projections (7 with SwiGLU, 6 otherwise) as one P = 2 launch, active
    where the LeZO mask says, and the head (untied here) as one
    single-probe launch a probe."""
    _, tc, _, _, batch = model(arch)
    tp = _tparams(arch)
    _, tm, _ = _masks(arch, tp)
    tr = tobs.Tracer()
    with tobs.use(tr):
        tlm.lm_loss(tc, tp, _tb(batch), perturb=tfused.make_pair_ctx(
            SEED, EPS, tm, "virtual"))
    layer, head = tfmm.model_matmuls(tc)
    assert len(layer) == (7 if tc.act == "silu" else 6)
    M, w, z = B * S, 0, 0
    for on in tm["s0.b0"].tolist():
        for K, N in layer:
            dw, dz = tfmm.tile_counts(M, K, N, (1, 1), (on, on))
            w, z = w + dw, z + dz
    dw, dz = tfmm.tile_counts(M, *head, (1,), (True,))
    assert (tr.counters[tobs.CTR_WLOAD], tr.counters[tobs.CTR_ZREGEN]) == \
        (w + 2 * dw, z + 2 * dz)


# ------------------------------------------------------------ components
@pytest.mark.parametrize("shape", ["shared", "per_lane"])
def test_rope_matches(shape):
    """``rope`` at (S,) positions and at (B, S) per-lane positions up to
    2047: rtol 1e-5, atol 1e-6 (torch's cos/sin round differently from
    XLA's)."""
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 8, 3, 16)).astype(np.float32)
    pos = (np.arange(8) + 5 if shape == "shared"
           else r.integers(0, 2040, (2, 1)) + np.arange(8))
    want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos),
                                   1e6))
    got = tlayers.rope(torch.tensor(x), torch.tensor(pos), 1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-14b", "musicgen-large",
                                  "opt-13b"])
def test_ffn_activation_matches(arch):
    """``ffn_fwd`` with SwiGLU (qwen3), tanh-GELU (musicgen, not torch's
    default erf) and ReLU (OPT): rtol 1e-5, atol 1e-6."""
    jc, tc = jconfigs.get(arch, "smoke"), tconfigs.get(arch, "smoke")
    jp = jlayers.ffn_params(jc, jax.random.PRNGKey(1))
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    want = np.asarray(jlayers.ffn_fwd(jc, jp, jnp.asarray(x)))
    tp = jax.tree.map(lambda v: torch.tensor(np.asarray(v)), jp)
    got = tlayers.ffn_fwd(tc, tp, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("paired", [False, True])
def test_layer_perturb_rms_norm_matches(paired):
    """``LayerPerturb.rms_norm`` on a bare qk-norm leaf, unpaired and
    paired (the (P, dh) vectors broadcast over the probe-folded leading
    dim): rtol 1e-5, atol 1e-6."""
    r = np.random.default_rng(8)
    w = (1.0 + 0.3 * r.standard_normal((3, 16))).astype(np.float32)
    x = r.standard_normal((4 if paired else 2, 5, 4, 16)).astype(
        np.float32)
    masks_j = {"s0.b0": jnp.asarray([True, False, True])}
    masks_t = {"s0.b0": torch.tensor([True, False, True])}
    if paired:
        jctx = jfused.make_pair_ctx(jnp.uint32(9), 0.1, masks_j,
                                    "virtual_ref")
        tctx = tfused.make_pair_ctx(9, 0.1, masks_t, "virtual_ref")
        act_j, act_t = jnp.asarray([True, True]), (True, True)
    else:
        jctx = jfused.make_ctx(jnp.uint32(9), 0.1, masks_j, "virtual_ref")
        tctx = tfused.make_ctx(9, 0.1, masks_t, "virtual_ref")
        act_j, act_t = jnp.asarray(True), True
    for layer in range(3):
        want = np.asarray(jctx.block("stages/s0/b0/mix", jnp.uint32(layer),
                                     act_j).rms_norm(
            jnp.asarray(x), jnp.asarray(w[layer]), "q_norm/scale"))
        got = tctx.block("stages/s0/b0/mix", layer, act_t).rms_norm(
            torch.tensor(x), torch.tensor(w[layer]), "q_norm/scale").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_virtual_untied_head_matches_axpy():
    """The untied counterpart of the reference's
    ``test_virtual_tied_head_and_embedding_match_axpy``: ``head/w``
    (D, V) read as stored (``trans=False``, ``ld = V``, here an odd V)
    draws the update sweep's z of ``head/w`` bit for bit, in both
    packages."""
    r = np.random.default_rng(9)
    D, V, step = 24, 41, 31
    w = r.standard_normal((D, V)).astype(np.float32)
    h = r.standard_normal((4, D)).astype(np.float32)
    wp = tops.zo_axpy_(torch.tensor(w), path="head/w", seed=step,
                       scale=1e-3)
    got = tfref.pmatmul(torch.tensor(h), torch.tensor(w),
                        tfref.layer_seed(step, "head/w", 0), 1e-3)
    assert torch.equal(torch.tensor(h) @ wp, got)
    jwp = jops.zo_axpy(jnp.asarray(w), path="head/w", seed=jnp.uint32(step),
                       scale=1e-3)
    jgot = jfref.pmatmul(jnp.asarray(h), jnp.asarray(w), jfref.layer_seed(
        jnp.uint32(step), "head/w", 0), 1e-3)
    assert np.array_equal(np.asarray(jnp.asarray(h) @ jwp),
                          np.asarray(jgot))


def test_stub_embeddings_unit_rms():
    cfg = tconfigs.get("musicgen-large", "smoke")
    e = tfront.stub_embeddings(cfg, 2, 7, seed=3, device="cpu")
    assert e.shape == (2, 7, cfg.d_model) and e.dtype == torch.float32
    rms = torch.sqrt(torch.mean(e ** 2, -1))
    assert torch.allclose(rms, torch.ones_like(rms), atol=1e-5)
    assert torch.equal(e, tfront.stub_embeddings(cfg, 2, 7, seed=3,
                                                 device="cpu"))
    for arch in ARCHS + ["opt-13b"]:
        assert tfront.uses_embeds(tconfigs.get(arch)) == \
            jfront.uses_embeds(jconfigs.get(arch))


# ----------------------------------------------------------- the registry
@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_match_reference(arch):
    """Every field of every variant equals the reference's config."""
    for variant in ("full", "smoke"):
        assert as_reference(tconfigs.get(arch, variant)) == \
            dataclasses.asdict(jconfigs.get(arch, variant)), variant


def test_full_configs_match_assignment():
    """The assigned hyperparameters of the dense ids (as the reference's
    ``test_archs_smoke.py`` spot-checks them)."""
    c = tconfigs.get("deepseek-coder-33b")
    assert (c.num_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.vocab) == (62, 7168, 56, 8, 19200, 32256)
    c = tconfigs.get("qwen3-14b")
    assert c.qk_norm and c.head_dim == 128 and c.vocab == 151936
    assert (c.num_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff,
            c.tie_embeddings) == (40, 5120, 40, 8, 17408, False)
    c = tconfigs.get("musicgen-large")
    assert (c.act, c.norm, c.pos_emb, c.frontend) == ("gelu", "ln",
                                                      "learned", "audio")
    assert tconfigs.get("internvl2-2b").vocab == 92553


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_archs_rejected(arch):
    """The recurrent archs, once the zoo's last unported ids, are in the
    port's registry with the reference's configs; they validate on the
    preset's materialized backend, and the virtual backend is refused
    for them at ``runtime.forward_backend``, as the reference refuses
    it."""
    assert arch in jconfigs.list_archs()
    assert arch in tconfigs.list_archs()
    assert sorted(tconfigs.list_archs()) == sorted(jconfigs.list_archs())
    for variant in ("full", "smoke"):
        assert as_reference(tconfigs.get(arch, variant)) == \
            dataclasses.asdict(jconfigs.get(arch, variant)), variant
    spec = tapi.with_overrides(tapi.preset("lezo-opt13b"),
                               {"model.arch": arch})
    assert tapi.validate(spec) == tconfigs.get(arch, spec.model.variant)
    with pytest.raises(tapi.SpecError, match="materialized") as e:
        tapi.validate(tapi.with_overrides(
            spec, {"runtime.forward_backend": "virtual"}))
    assert e.value.path == "runtime.forward_backend"

"""Port parity of the zoo's recurrent blocks (``models/ssm.py``: the
causal conv, Mamba's chunked scan, the chunkwise stabilized mLSTM, the
per-step sLSTM) and of the two recurrent archs, ``jamba-v0.1-52b``/
``smoke`` (Mamba, attention, MoE) and ``xlstm-350m``/``smoke`` (mLSTM
and sLSTM, no FFN), float32, against the JAX package.

Weights come from the reference's ``init_params`` (or its block
``*_params``) through numpy, with every norm scale and bias made random.
The same numpy inputs go through both packages.  Tolerances, stated
per test: the components atol/rtol 1e-5, except the chunkwise mLSTM
across chunk sizes at the reference's own 2e-4; hidden states and
logits rtol 1e-4 / atol 1e-5; losses rtol 1e-5; teacher-forced
parameters atol 1e-6; three ``api.run`` steps' losses rtol 1e-3;
prefill-then-decode against train 5e-5 of max|logits| (the
reference's ``_decode_check``); greedy tokens and cache layouts
exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro import estimators as jest
from repro.core import zo as jzo
from repro.launch import serve as jserve
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import estimators as test_
from repro_torch import serving as tsv
from repro_torch.core import rng as trng
from repro_torch.core import zo as tzo
from repro_torch.launch import serve as tserve
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models.config import BlockCfg, ModelConfig, StageCfg
from _port_cfg import as_reference

torch.set_num_threads(2)              # six xdist workers share the CPUs

ARCHS = ["jamba-v0.1-52b", "xlstm-350m"]
EPS = 1e-3
LR = 2e-2
B, S = 2, 16
TOL = dict(rtol=1e-5, atol=1e-5)      # the components


def _flat(tree):
    return {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _randomize(flat, r):
    for k, v in flat.items():
        if k.endswith("/scale"):
            flat[k] = (1.0 + 0.3 * r.standard_normal(v.shape)).astype(v.dtype)
        elif k.endswith("/bias"):
            flat[k] = (0.1 * r.standard_normal(v.shape)).astype(v.dtype)
    return flat


def _tree(like, flat):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(flat[jzo._path_str(p)]), like)


def _nest(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.tensor(v)
    return out


def _np(t):
    return t.detach().cpu().numpy()


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, port cfg, jax params, flat numpy params, numpy
    batch, the reference's teacher-forced step), built once."""
    out = {}
    for arch in ARCHS:
        jc = jconfigs.get(arch, "smoke")
        tc = tconfigs.get(arch, "smoke")
        jp = jax.jit(lambda k: jlm.init_params(jc, k))(jax.random.PRNGKey(0))
        r = np.random.default_rng(5)
        flat = _randomize(_flat(jp), r)
        jp = _tree(jp, flat)
        toks = r.integers(0, jc.vocab, (B, S)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
                 "loss_mask": (r.random((B, S)) < 0.8).astype(np.float32)}
        out[arch] = dict(jc=jc, tc=tc, jp=jp, flat=flat, batch=batch)
    return out


def _tp(m):
    return tlm.params_from_numpy(m["tc"], m["flat"], "cpu")


# ------------------------------------------------------------ components
def _block(kind, seed, dtype="float32"):
    """One reference block of ``kind`` (norm scale random) at the jamba
    (mamba) or xlstm (mlstm, slstm) smoke width, and the port's copy."""
    arch = "jamba-v0.1-52b" if kind == "mamba" else "xlstm-350m"
    jc = jconfigs.get(arch, "smoke").with_(dtype=dtype)
    tc = tconfigs.get(arch, "smoke").with_(dtype=dtype)
    jp = getattr(jssm, f"{kind}_params")(jc, jax.random.PRNGKey(seed))
    flat = _randomize(_flat(jp), np.random.default_rng(seed))
    return jc, tc, _tree(jp, flat), _nest(flat)


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv_matches_reference(cached):
    """``_causal_conv`` with a zero pad and with a (B, K-1, Di) trailing
    context: y and the new context within 1e-5."""
    r = np.random.default_rng(1)
    x, w, b = (r.standard_normal(s).astype(np.float32)
               for s in ((B, S, 24), (4, 24), (24,)))
    ctx = r.standard_normal((B, 3, 24)).astype(np.float32) if cached else None
    jy, jc = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b),
                               None if ctx is None else jnp.asarray(ctx))
    ty, tc = tssm._causal_conv(torch.tensor(x), torch.tensor(w),
                               torch.tensor(b),
                               None if ctx is None else torch.tensor(ctx))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **TOL)


def _scan_inputs(seed, Bn=2, Sn=64, Di=8, St=4):
    r = np.random.default_rng(seed)
    dA = 1 / (1 + np.exp(-r.standard_normal((Bn, Sn, Di, St))))
    dBx = r.standard_normal((Bn, Sn, Di, St))
    C = r.standard_normal((Bn, Sn, St))
    h0 = r.standard_normal((Bn, Di, St))
    return [a.astype(np.float32) for a in (dA, dBx, C, h0)]


@pytest.mark.parametrize("chunk", [8, 64])
def test_ssm_chunk_scan_matches_reference(chunk, monkeypatch):
    """``_ssm_chunk_scan`` at chunk 8 (8 chunks, a carried h) and 64 (one
    chunk, 6 doubling steps) from a non-zero h0, against the reference's
    associative scan at the same chunk: y and h_final within 1e-5."""
    ins = _scan_inputs(2)
    monkeypatch.setattr(jssm, "CHUNK", chunk)
    monkeypatch.setattr(tssm, "CHUNK", chunk)
    jy, jh = jssm._ssm_chunk_scan(*map(jnp.asarray, ins))
    ty, th = tssm._ssm_chunk_scan(*map(torch.tensor, ins))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)


def test_ssm_chunk_invariance(monkeypatch):
    """The port's scan does not depend on the chunk (the reference's
    ``test_mamba_chunk_invariance``): chunk 8 against 64 within 1e-5."""
    ins = [torch.tensor(a) for a in _scan_inputs(3)]
    outs = []
    for chunk in (8, 64):
        monkeypatch.setattr(tssm, "CHUNK", chunk)
        outs.append(tssm._ssm_chunk_scan(*ins))
    for a, b in zip(*outs):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=0)


def _mlstm_inputs(seed, Bn=1, Sn=64, H=2, dh=8):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((Bn, Sn, H, dh)).astype(np.float32)
               for _ in range(3))
    li = r.standard_normal((Bn, Sn, H)).astype(np.float32)
    lf = -np.logaddexp(0, -(r.standard_normal((Bn, Sn, H)) + 2.0))
    return q, k, v, li, lf.astype(np.float32)


def _mlstm_run(mod, arrs, chunk, state):
    q, k, v, li, lf = arrs
    cat = jnp.concatenate if mod is jssm else torch.cat
    hs = []
    for i in range(0, q.shape[1], chunk):
        sl = slice(i, i + chunk)
        h, state = mod._mlstm_chunk(q[:, sl], k[:, sl], v[:, sl], li[:, sl],
                                    lf[:, sl], state)
        hs.append(h)
    return cat(hs, 1), state


@pytest.mark.parametrize("chunk", [1, 16, 64])
def test_mlstm_chunk_matches_reference(chunk):
    """``_mlstm_chunk`` from the empty state (m = -inf) over 64 steps in
    chunks of ``chunk``: h and the (C, n, m) carry within 1e-5 of the
    reference's at the same chunk; no NaN at the -inf stabilizer."""
    arrs = _mlstm_inputs(4)
    H, dh = arrs[0].shape[2], arrs[0].shape[3]
    jst = (jnp.zeros((1, H, dh, dh)), jnp.zeros((1, H, dh)),
           jnp.full((1, H), -jnp.inf))
    tst = (torch.zeros((1, H, dh, dh)), torch.zeros((1, H, dh)),
           torch.full((1, H), float("-inf")))
    jh, jstate = _mlstm_run(jssm, [jnp.asarray(a) for a in arrs], chunk, jst)
    th, tstate = _mlstm_run(tssm, [torch.tensor(a) for a in arrs], chunk,
                            tst)
    assert torch.isfinite(th).all()
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
    for a, b in zip(tstate, jstate):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def test_mlstm_chunk_invariance():
    """The port's chunkwise mLSTM equals its step-by-step recurrence
    (chunk 1 against 32; the reference's ``test_mlstm_chunk_invariance``
    at its 2e-4)."""
    arrs = [torch.tensor(a) for a in _mlstm_inputs(3)]
    H, dh = arrs[0].shape[2], arrs[0].shape[3]
    st = (torch.zeros((1, H, dh, dh)), torch.zeros((1, H, dh)),
          torch.full((1, H), float("-inf")))
    h1, st1 = _mlstm_run(tssm, arrs, 1, st)
    h32, st32 = _mlstm_run(tssm, arrs, 32, st)
    np.testing.assert_allclose(_np(h1), _np(h32), atol=2e-4, rtol=0)
    np.testing.assert_allclose(_np(st1[0]), _np(st32[0]), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_block_fwd_matches_reference(kind, mode):
    """``{kind}_fwd`` in each mode against the reference's: train from
    the empty state over 16 steps; prefill and decode (one step) from a
    random state in the reference's cache layout (mLSTM/sLSTM ``m``
    finite), the output and every leaf of the new state within 1e-5."""
    jc, tc, jp, tp = _block(kind, 6)
    r = np.random.default_rng(7)
    Sn = 1 if mode == "decode" else S
    x = r.standard_normal((B, Sn, jc.d_model)).astype(np.float32)
    cache = None
    if mode != "train":
        empty = jlm.init_cache(jc.with_(stages=(StageCfg(1, (
            BlockCfg(kind, "none"),)),)), B, 8)["s0"]["b0"]
        cache = {k: (r.standard_normal(v.shape[1:]) * 0.5).astype(np.float32)
                 for k, v in empty.items()}
        for k in ("n",):
            if k in cache and kind == "slstm":
                cache[k] = np.abs(cache[k]) + 1.0
    fwd = f"{kind}_fwd"
    jout, jnew = getattr(jssm, fwd)(
        jc, jp, jnp.asarray(x), mode=mode,
        cache=None if cache is None else {k: jnp.asarray(v)
                                          for k, v in cache.items()})
    tout, tnew = getattr(tssm, fwd)(
        tc, tp, torch.tensor(x), mode=mode,
        cache=None if cache is None else {k: torch.tensor(v)
                                          for k, v in cache.items()})
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **TOL)
    assert (tnew is None) == (jnew is None) == (mode == "train")
    if jnew is not None:
        assert set(tnew) == set(jnew)
        for k in jnew:
            np.testing.assert_allclose(_np(tnew[k]), np.asarray(jnew[k]),
                                       err_msg=k, **TOL)


def test_softplus_is_jaxs():
    """``ssm.softplus`` equals ``jax.nn.softplus`` within 1e-6 over
    [-40, 40], past ``F.softplus``'s threshold of 20 too."""
    x = np.linspace(-40, 40, 4001).astype(np.float32)
    np.testing.assert_allclose(_np(tssm.softplus(torch.tensor(x))),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_unchunkable_prompt_raises():
    """A sequence past 128 that is not a multiple of it names its length
    and the chunk."""
    jc, tc, _, tp = _block("mamba", 8)
    x = torch.zeros((1, 130, tc.d_model))
    with pytest.raises(ValueError, match="130.*128"):
        tssm.mamba_fwd(tc, tp, x)


# ---------------------------------------------------------- invariances
def _decode_check(cfg, tol=5e-5):
    """The reference's ``_decode_check`` on the port: prefill(S - 1)
    then one decode step against the full train forward's last logits,
    within tol x max|logits|."""
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, S)))
    want = tlm.logits_fn(cfg, params, tlm.forward(cfg, params, toks)[:, -1])
    _, caches = tlm.prefill(cfg, params, toks[:, :-1], max_seq=S + 2)
    got, _ = tlm.serve_step(cfg, params, caches, toks[:, -1:], S - 1)
    scale = float(want.abs().max())
    np.testing.assert_allclose(_np(got), _np(want), atol=tol * max(scale, 1))


@pytest.mark.parametrize("pattern", [
    (BlockCfg("mamba", "none"),),
    (BlockCfg("mlstm", "none"), BlockCfg("slstm", "none"))])
def test_decode_consistency(pattern):
    """Prefill then one decode step against the train forward (the
    reference's ``test_decode_consistency_mamba``/``_xlstm``) on a
    2-repeat stack of the port's own seeded weights."""
    _decode_check(ModelConfig(
        name="r", d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=256,
        stages=(StageCfg(2, pattern),), dtype="float32", max_seq=64))


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    """A seeded port model has the reference's leaves, shapes and
    dtypes, in float32 and in bfloat16 (the norms, the router, the
    recurrent decays, gate biases and ``rh`` stay float32; ``conv_b``
    takes the model dtype); ``params_from_numpy`` casts to the same."""
    for dtype in ("float32", "bfloat16"):
        jc = jconfigs.get(arch, "smoke").with_(dtype=dtype)
        tc = tconfigs.get(arch, "smoke").with_(dtype=dtype)
        jp = jax.eval_shape(lambda k: jlm.init_params(jc, k),
                            jax.random.PRNGKey(0))
        tp = tlm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        got = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
               for p, t in tzo.leaf_items(tp)}
        want = {jzo._path_str(p): (tuple(v.shape), str(v.dtype))
                for p, v in jax.tree_util.tree_leaves_with_path(jp)}
        assert got == want, dtype
        assert {p: str(tlm._leaf_dtype(tc, p)).split(".")[-1]
                for p in want} == {p: d for p, (_, d) in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_counts(arch, models):
    """``params_from_numpy``/``params_to_numpy`` round-trip every leaf;
    ``count_params`` and ``count_active_params`` equal the
    reference's."""
    m = models[arch]
    tp = _tp(m)
    back = tlm.params_to_numpy(tp)
    assert back.keys() == m["flat"].keys()
    for k in m["flat"]:
        assert np.array_equal(back[k], m["flat"][k]), k
    assert tlm.count_params(tp) == jlm.count_params(m["jp"])
    assert tlm.count_active_params(m["tc"], tp) == \
        jlm.count_active_params(m["jc"], m["jp"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_loss_match(arch, models):
    """Hidden states and logits rtol 1e-4 / atol 1e-5; ``lm_loss`` rtol
    1e-5 (jamba's MoE aux with aux_coef 0.01 too)."""
    m = models[arch]
    jc, tc, jp, batch = m["jc"], m["tc"], m["jp"], m["batch"]
    jh, _, jaux = jlm.forward(jc, jp, jnp.asarray(batch["tokens"]))
    tp = _tp(m)
    th, _, taux = tlm.forward_aux(tc, tp, torch.tensor(batch["tokens"]))
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        _np(tlm.logits_fn(tc, tp, th[:, -1])),
        np.asarray(jlm.logits_fn(jc, jp, jh[:, -1])), rtol=1e-4, atol=1e-5)
    assert (taux is None) == (arch == "xlstm-350m")
    for coef in (0.0, 0.01):
        want = float(jlm.lm_loss(jc, jp, _jb(batch), coef))
        got = float(tlm.lm_loss(tc, tp, _tb(batch), coef))
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.fixture(scope="module")
def reference_steps(models):
    """arch -> the reference's two-point materialized step (dense axpy)
    on the smoke model: (updated params, metrics)."""
    out = {}
    for arch, m in models.items():
        kw = dict(name="two_point", q=1, eps=EPS, lr=LR, n_drop=1,
                  weight_decay=0.1, forward_backend="materialized")
        jcfg = jest.EstimatorConfig(**kw, backend="dense")
        jstep, jinit = jest.make_step(
            lambda p, b, perturb=None, jc=m["jc"]: jlm.lm_loss(
                jc, p, b, perturb=perturb),
            jzo.build_spec(m["jp"], jlm.zo_group_fn), jcfg)
        out[arch] = (kw,) + tuple(jax.jit(jstep)(
            m["jp"], jinit(), _jb(m["batch"]), jnp.int32(3),
            jnp.uint32(77)))
    return out


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_two_point_materialized(arch, backend, models,
                                               reference_steps):
    """One reference two-point step (materialized), then the port's: its
    probe loss (rtol 1e-5), active layers, and its update driven by the
    reference's projected gradient (atol 1e-6), with the port's axpy on
    ``dense`` or on K1's dispatch (``pallas``: K1's plain version on the
    CPU) over the float32 recurrent leaves as well."""
    m = models[arch]
    kw, jp_new, _, jm = reference_steps[arch]
    tcfg = test_.EstimatorConfig(**kw, backend=backend)
    tp = _tp(m)
    est = test_.build_estimator(tzo.build_spec(tp, tlm.zo_group_fn), tcfg)
    tp, dirs, met = est.estimate(
        lambda p, b, perturb=None: tlm.lm_loss(m["tc"], p, b,
                                               perturb=perturb),
        tp, _tb(m["batch"]), trng.fold_py(77, 3), est.init_state())
    np.testing.assert_allclose(met["loss"], float(jm["loss"]), rtol=1e-5)
    assert met["active_layers"] == int(jm["active_layers"])
    dirs = dataclasses.replace(dirs, coeffs=tuple(
        np.float32(c) for c in np.asarray(jm["coeffs"]).reshape(-1)))
    est.apply_update(tp, dirs, LR, 1.0 - LR * tcfg.weight_decay)
    got = tlm.params_to_numpy(tp)
    for k, w in _flat(jp_new).items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_through_api_run_in_band(arch):
    """``api.run`` on the smoke variant, materialized, 3 steps from the
    reference's seeded weights: every logged loss within rtol 1e-3 of
    ``repro.api.run``'s, and finite."""
    over = {"model.arch": arch, "model.variant": "smoke",
            "model.seq_len": 17, "runtime.forward_backend": "materialized",
            "runtime.backend": "pallas", "run.steps": 3,
            "run.batch_size": 2, "run.eval_every": 0, "run.log_every": 1}
    jspec = japi.with_overrides(japi.preset("lezo-opt13b"), over)
    want = np.array(japi.run(jspec)["history"]["loss"])
    jp = jlm.init_params(japi.derive(jspec).model_cfg,
                         jax.random.PRNGKey(jspec.run.seed))
    tspec = tapi.with_overrides(tapi.preset("lezo-opt13b"), over)
    params = tlm.params_from_numpy(tapi.derive(tspec).model_cfg, _flat(jp),
                                   "cpu")
    got = np.array(tapi.run(tspec, device="cpu", params=params)["history"]
                   ["loss"])
    assert got.shape == want.shape == (3,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    """``init_cache`` leaf by leaf against the reference's: the same
    leaves, shapes and dtypes (``conv`` tails in the cache dtype, states
    float32, in bfloat16 too) and the same fill (the mLSTM and sLSTM
    stabilizers ``m`` at -inf, every other leaf 0)."""
    for dtype in ("float32", "bfloat16"):
        jc = jconfigs.get(arch, "smoke").with_(dtype=dtype)
        tc = tconfigs.get(arch, "smoke").with_(dtype=dtype)
        want = jlm.init_cache(jc, 3, 20)
        got = tlm.init_cache(tc, 3, 20, device="cpu")
        assert set(got) == set(want)
        n_inf = 0
        for si, blocks in want.items():
            assert set(got[si]) == set(blocks)
            for bj, leaves in blocks.items():
                assert set(got[si][bj]) == set(leaves), (si, bj)
                for name, w in leaves.items():
                    g = got[si][bj][name]
                    assert tuple(g.shape) == w.shape, (bj, name)
                    assert str(g.dtype).split(".")[-1] == str(w.dtype), name
                    w = np.asarray(w.astype(jnp.float32))
                    assert np.array_equal(_np(g.float()), w), (bj, name)
                    n_inf += int(np.isneginf(w).all())
        assert n_inf == (2 if arch == "xlstm-350m" else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_generate_equals_reference(arch, models):
    """The lockstep ``generate`` (recurrent states carried in the cache,
    jamba's attention K/V beside them) gives the reference's greedy
    tokens, batch 2."""
    m = models[arch]
    toks = m["batch"]["tokens"][:, :11]
    want = np.asarray(jserve.generate(m["jc"], m["jp"], jnp.asarray(toks), 6,
                                      max_seq=20))
    got = tserve.generate(m["tc"], _tp(m), torch.tensor(toks), 6, max_seq=20)
    assert _np(got).tolist() == want.tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_served_by_lockstep_only(arch, models):
    """``supports_paged`` is the reference's (false); the engine refuses
    these archs with ``EngineUnsupported`` naming the attn mixers, and
    the paged arena refuses them, as the reference's do."""
    tc = tconfigs.get(arch, "smoke")
    assert tlm.supports_paged(tc) is False
    assert jlm.supports_paged(jconfigs.get(arch, "smoke")) is False
    with pytest.raises(tsv.EngineUnsupported, match="attn mixers"):
        tsv.Engine(tc, _tp(models[arch]), tapi.Serving(), device="cpu")
    with pytest.raises(NotImplementedError, match="attn mixers only"):
        tlm.init_paged_cache(tc, 8, 4, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serve_falls_back_to_lockstep(arch, capsys):
    """``launch serve --engine auto`` takes the lockstep path on these
    archs and generates; ``--engine paged`` exits naming the lockstep."""
    from repro_torch.launch import cli as tcli
    argv = ["serve", "--arch", arch, "--variant", "smoke", "--device",
            "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"]
    result = tcli.main(argv)
    assert result["engine"]["mode"] == "lockstep"
    assert [len(t) for t in result["tokens"]] == [3, 3]
    assert "tok/s" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="lockstep"):
        tcli.main(argv + ["--engine", "paged"])


@pytest.mark.parametrize("fb", ["virtual", "virtual_ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_validate_materialized_only(arch, fb):
    """Both variants validate under ``runtime.forward_backend=
    materialized`` to the reference's config; a virtual backend raises
    at ``runtime.forward_backend`` in both packages, naming the
    materialized backend."""
    for variant in ("full", "smoke"):
        over = {"model.arch": arch, "model.variant": variant,
                "runtime.forward_backend": "materialized"}
        tcfg = tapi.validate(tapi.with_overrides(tapi.preset("lezo-opt13b"),
                                                 over))
        jcfg = japi.validate(japi.with_overrides(japi.preset("lezo-opt13b"),
                                                 over))
        assert as_reference(tcfg) == dataclasses.asdict(jcfg)
        over["runtime.forward_backend"] = fb
        for api in (japi, tapi):
            with pytest.raises(api.SpecError) as e:
                api.validate(api.with_overrides(api.preset("lezo-opt13b"),
                                                over))
            assert e.value.path == "runtime.forward_backend"
        assert "forward_backend='materialized'" in str(e.value)


def test_full_configs_as_published():
    """The published shapes the card runs: jamba's 4 periods of 8 (attn
    at offset 4, MoE at odd offsets; 16 experts top-2, d_state 16, expand
    2, conv 4, dt_rank 256), xlstm's 3 x (7 mLSTM + sLSTM), 4 heads, no
    FFN, tied."""
    j = tconfigs.get("jamba-v0.1-52b")
    kinds = [(b.kind, b.ffn) for b in j.stages[0].pattern]
    assert j.stages[0].repeat == 4 and j.num_layers == 32
    assert [k for k, _ in kinds].index("attn") == 4
    assert [f for _, f in kinds] == ["dense", "moe"] * 4
    assert (j.n_experts, j.top_k, j.mamba_d_state, j.mamba_d_inner,
            j.mamba_dt_rank, j.mamba_conv) == (16, 2, 16, 8192, 256, 4)
    x = tconfigs.get("xlstm-350m")
    assert x.num_layers == 24 and x.tie_embeddings and x.lstm_d_inner == 2048
    assert [b.kind for b in x.stages[0].pattern] == ["mlstm"] * 7 + ["slstm"]

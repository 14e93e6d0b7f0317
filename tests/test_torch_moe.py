"""Port parity of the zoo's MoE and MLA blocks (``models/moe.py``,
``models/layers.py::mla_fwd``) on ``granite-moe-1b-a400m``/``smoke``
(GQA attention, 4 experts, top-2) and ``deepseek-v2-lite-16b``/``smoke``
(MLA at dh = dn + dr = 24, a dense first stage of width 96, then MoE
with 2 shared experts), float32, against the JAX package.

Weights come from ``repro.models.lm.init_params`` through numpy, with
every norm scale and bias made random (``kv_norm`` included).  The same
numpy inputs go through both packages.  Tolerances, stated per test:
hidden states and logits rtol 1e-4 / atol 1e-5; losses rtol 1e-5;
``aux`` rtol 1e-5; teacher-forced parameters atol 1e-6; the latent
cache atol 1e-5; routing integers (top-k experts, the sort order,
``keep``, ``slot``, the drops) and layer selection exactly; greedy
tokens exactly.
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
from repro import serving as jsv
from repro.core import zo as jzo
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import estimators as test_
from repro_torch import serving as tsv
from repro_torch.core import rng as trng
from repro_torch.core import zo as tzo
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from _port_cfg import as_reference

torch.set_num_threads(2)              # six xdist workers share the CPUs

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b"]
UNPORTED = ["jamba-v0.1-52b", "xlstm-350m"]
EPS = 1e-3
SEED = 21
LR = 2e-2
B, S = 3, 16

_MODELS = {}


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


def model(arch, **over):
    """(jax cfg, port cfg, jax params, flat numpy params, numpy batch),
    built once per (arch, config overrides); norm scales random."""
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        jc = jconfigs.get(arch, "smoke").with_(**over)
        tc = tconfigs.get(arch, "smoke").with_(**over)
        jp = jax.jit(lambda k: jlm.init_params(jc, k))(
            jax.random.PRNGKey(0))
        r = np.random.default_rng(3)
        flat = _randomize(_flat(jp), r)
        jp = _tree(jp, flat)
        toks = r.integers(0, jc.vocab, (B, S)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
                 "loss_mask": (r.random((B, S)) < 0.8).astype(np.float32)}
        _MODELS[key] = (jc, tc, jp, flat, batch)
    return _MODELS[key]


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _tparams(arch, **over):
    _, tc, _, flat, _ = model(arch, **over)
    return tlm.params_from_numpy(tc, flat, "cpu")


def _np(t):
    return t.detach().cpu().numpy()


# -------------------------------------------------------------- capacity
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 4.0])
@pytest.mark.parametrize("k,E", [(1, 4), (2, 4), (6, 64), (8, 32)])
def test_capacity_matches_reference(k, E, cf):
    """``capacity`` equals the reference's for every token count 1-300,
    including the round-up to a multiple of 4 from 4 tokens on."""
    cfg = tconfigs.get("granite-moe-1b-a400m").with_(
        top_k=k, n_experts=E, capacity_factor=cf)
    jcfg = jconfigs.get("granite-moe-1b-a400m").with_(
        top_k=k, n_experts=E, capacity_factor=cf)
    got = [tmoe.capacity(cfg, t) for t in range(1, 301)]
    assert got == [jmoe.capacity(jcfg, t) for t in range(1, 301)]


# --------------------------------------------------------------- routing
def _reference_routing(probs, k, E, C):
    """The reference ``moe_fwd``'s routing expressions, on JAX."""
    probs = jnp.asarray(probs)
    Bn, Sn, _ = probs.shape
    top_w, top_e = jax.lax.top_k(probs, k)
    top_w = top_w / jnp.sum(top_w, axis=-1, keepdims=True)
    e_flat = top_e.reshape(Bn, Sn * k)
    order = jnp.argsort(e_flat, axis=-1)
    e_s = jnp.take_along_axis(e_flat, order, axis=-1)
    counts = jax.vmap(lambda e: jnp.zeros((E,), jnp.int32).at[e].add(1))(e_s)
    starts = jnp.cumsum(counts, axis=-1) - counts
    pos = jnp.arange(Sn * k)[None] - jnp.take_along_axis(starts, e_s, axis=-1)
    keep = pos < C
    slot = jnp.where(keep, e_s * C + pos, E * C)
    return [np.asarray(a) for a in (top_w, top_e, order, keep, slot)]


def _probs(shape, seed, tie=False):
    r = np.random.default_rng(seed)
    p = r.random(shape).astype(np.float32)
    if tie:
        p[0, 0] = 0.25                         # all four experts tie
        p[0, 1, 1:3] = p[0, 1].max() + 0.5     # a tie at the top, 1 vs 2
        p[1, 2, ::2] = 0.7                     # a tie at ranks 1-2, 0 vs 2
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("k,E,C,tie", [(2, 4, 8, False), (2, 4, 3, False),
                                       (2, 4, 4, True), (6, 64, 4, False),
                                       (8, 32, 20, False)])
def test_routing_integers_equal_reference(k, E, C, tie):
    """top-k experts, the stable sort order, ``keep`` and ``slot`` equal
    the reference's bit for bit on the same numpy probabilities (ties
    toward the lower expert index, as ``lax.top_k``); the weights within
    1e-7.  C = 3 and 4 drop assignments."""
    probs = _probs((2, 16, E), seed=E + C, tie=tie)
    jw, je, jorder, jkeep, jslot = _reference_routing(probs, k, E, C)
    tw, te = tmoe.route(torch.tensor(probs), k)
    order, _, keep, slot = tmoe.dispatch(te, E, C)
    assert np.array_equal(_np(te), je)
    assert np.array_equal(_np(order), jorder)
    assert np.array_equal(_np(keep), jkeep)
    assert np.array_equal(_np(slot), jslot)
    np.testing.assert_allclose(_np(tw), jw, rtol=0, atol=1e-7)
    if C < 16 * k // E:
        assert not jkeep.all()                  # the drops are exercised
    if tie:
        assert _np(te)[0, 0].tolist() == [0, 1]
        assert _np(te)[0, 1].tolist() == [1, 2]


def _moe_block(arch, seed, **over):
    """One MoE FFN block's reference params (norm scale random) and the
    port's copy, on ``arch``'s smoke config with ``over``."""
    jc = jconfigs.get(arch, "smoke").with_(**over)
    tc = tconfigs.get(arch, "smoke").with_(**over)
    jp = jmoe.moe_params(jc, jax.random.PRNGKey(seed))
    flat = _randomize(_flat(jp), np.random.default_rng(seed))
    jp = _tree(jp, flat)
    tp = {}
    for k, v in flat.items():
        node = tp
        *parents, leaf = k.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.tensor(v)
    return jc, tc, jp, tp


@pytest.mark.parametrize("arch,over", [
    ("granite-moe-1b-a400m", {}),
    ("granite-moe-1b-a400m", {"capacity_factor": 0.5}),
    ("deepseek-v2-lite-16b", {}),
    ("deepseek-v2-lite-16b", {"capacity_factor": 0.5})])
def test_moe_fwd_matches_reference(arch, over):
    """``moe_fwd``'s y (rtol 1e-4, atol 1e-5) and aux (rtol 1e-5)
    against the reference's; deepseek's config runs the shared experts,
    capacity_factor 0.5 drops assignments (checked to)."""
    jc, tc, jp, tp = _moe_block(arch, 4, **over)
    x = np.random.default_rng(7).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_fwd(jc, jp, jnp.asarray(x))
    drops = []
    dispatch = tmoe.dispatch

    def tap(*a):
        out = dispatch(*a)
        drops.append(int((~out[2]).sum()))
        return out
    tmoe.dispatch = tap
    try:
        ty, taux = tmoe.moe_fwd(tc, tp, torch.tensor(x))
    finally:
        tmoe.dispatch = dispatch
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert ("ws_g" in tp) == (arch == "deepseek-v2-lite-16b")
    assert (drops[0] > 0) == ("capacity_factor" in over)


def test_moe_combine_adds_each_tokens_terms_in_sorted_order():
    """The deterministic combine equals a float64 oracle that adds each
    kept assignment's weighted expert output to its token (dropped
    assignments add nothing), at capacity_factor 0.5: rtol 1e-4, atol
    1e-5."""
    jc, tc, _, tp = _moe_block("granite-moe-1b-a400m", 5,
                               capacity_factor=0.5)
    x = torch.tensor(np.random.default_rng(9).standard_normal(
        (2, S, jc.d_model)).astype(np.float32))
    y, _ = tmoe.moe_fwd(tc, tp, x)
    assert torch.isfinite(y).all()
    # float64 oracle of the same routing
    E, k, C = tc.n_experts, tc.top_k, tmoe.capacity(tc, S)
    h = tlayers.apply_norm(tc, tp["norm"], x).double()
    probs = torch.softmax(h.float() @ tp["router"], -1)
    w, e = tmoe.route(probs, k)
    order, e_s, keep, slot = tmoe.dispatch(e, E, C)
    want = torch.zeros_like(h)
    for b in range(2):
        for j in range(S * k):
            if not keep[b, j]:
                continue
            t, r = divmod(int(order[b, j]), k)
            ex = int(e_s[b, j])
            hh = h[b, t]
            g = hh @ tp["we_g"][ex].double()
            u = hh @ tp["we_u"][ex].double()
            a = torch.nn.functional.silu(g) * u
            want[b, t] += w[b, t, r].double() * (a @ tp["we_d"][ex].double())
    np.testing.assert_allclose(_np(y), _np(want), rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------- MLA
def test_mla_train_matches_reference():
    """``mla_fwd`` in train mode (K2's plain version at dh = 24) against
    the reference's: rtol 1e-4, atol 1e-5."""
    jc = jconfigs.get("deepseek-v2-lite-16b", "smoke")
    tc = tconfigs.get("deepseek-v2-lite-16b", "smoke")
    jp = jlayers.mla_params(jc, jax.random.PRNGKey(2))
    flat = _randomize(_flat(jp), np.random.default_rng(2))
    jp = _tree(jp, flat)
    tp = {"norm": {"scale": torch.tensor(flat["norm/scale"])},
          "kv_norm": {"scale": torch.tensor(flat["kv_norm/scale"])},
          **{k: torch.tensor(v) for k, v in flat.items() if "/" not in k}}
    x = np.random.default_rng(8).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    want, _ = jlayers.mla_fwd(jc, jp, jnp.asarray(x), mode="train")
    got = tlayers.mla_fwd(tc, tp, torch.tensor(x), mode="train")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(NotImplementedError, match="lockstep"):
        tlayers.mla_fwd(tc, tp, torch.tensor(x), mode="paged")


def _decode_check(pkg, cfg, params, toks, tol=5e-5):
    """The reference's ``_decode_check``: the last position's logits of
    prefill(S - 1) then one decode step against the full train forward,
    within tol x max|logits|."""
    Sn = toks.shape[1]
    if pkg == "jax":
        h, _, _ = jlm.forward(cfg, params, jnp.asarray(toks))
        want = jlm.logits_fn(cfg, params, h[:, -1])
        _, caches = jlm.prefill(cfg, params, jnp.asarray(toks[:, :-1]),
                                max_seq=Sn + 2)
        got, _ = jlm.serve_step(cfg, params, caches,
                                jnp.asarray(toks[:, -1:]), jnp.int32(Sn - 1))
        got, want = np.asarray(got), np.asarray(want)
    else:
        t = torch.tensor(toks)
        want = _np(tlm.logits_fn(cfg, params, tlm.forward(cfg, params, t)[
            :, -1]))
        _, caches = tlm.prefill(cfg, params, t[:, :-1], max_seq=Sn + 2)
        got, _ = tlm.serve_step(cfg, params, caches, t[:, -1:], Sn - 1)
        got = _np(got)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol * max(scale, 1.0))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistency_dropless(arch, pkg):
    """Prefill then one decode step against the full-sequence forward
    (the reference's ``test_decode_consistency_mla`` /
    ``_moe_dropless``), in both packages, at capacity_factor 4.0, where
    no assignment drops at any S: the absorbed MLA decode over the
    latent cache on deepseek, the GQA cache with MoE on granite."""
    jc, tc, jp, flat, batch = model(arch, capacity_factor=4.0)
    toks = batch["tokens"][:2]
    if pkg == "jax":
        _decode_check(pkg, jc, jp, toks)
    else:
        _decode_check(pkg, tc, _tparams(arch, capacity_factor=4.0), toks)


def test_mla_cache_matches_reference():
    """deepseek's lockstep prefill: the latent cache {ckv, kr} has the
    reference's leaves, shapes and dtypes exactly, its values within
    1e-5 (float32 sums in two orders), the slots past the prompt exact
    zeros; the prefill logits within 1e-5, and one decode step's
    too."""
    jc, tc, jp, _, batch = model("deepseek-v2-lite-16b")
    tp = _tparams("deepseek-v2-lite-16b")
    toks = batch["tokens"][:2, :9]
    jl, jcache = jlm.prefill(jc, jp, jnp.asarray(toks), 16)
    tl, tcache = tlm.prefill(tc, tp, torch.tensor(toks), 16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=1e-5)
    for cache in (jcache, tlm.init_cache(tc, 2, 16, device="cpu")):
        assert {si: {bj: set(lv) for bj, lv in b.items()}
                for si, b in cache.items()} == {
                    "s0": {"b0": {"ckv", "kr"}}, "s1": {"b0": {"ckv", "kr"}}}
    tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    jl, jcache = jlm.serve_step(jc, jp, jcache, jnp.asarray(tok), 9)
    tl, tcache = tlm.serve_step(tc, tp, tcache, torch.tensor(tok), 9)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=1e-5)
    for si, blocks in jcache.items():
        for bj, leaves in blocks.items():
            for name, want in leaves.items():
                got = _np(tcache[si][bj][name])
                assert got.shape == want.shape and got.dtype == want.dtype
                np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                           atol=1e-5)
                assert not got[:, :, 10:].any()


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_and_counts(arch):
    """``params_from_numpy``/``params_to_numpy`` round-trip every leaf
    (the float32 router and ``kv_norm/scale`` included, under the
    reference's paths); ``count_params`` and ``count_active_params``
    (experts at their top-k share) equal the reference's."""
    jc, tc, jp, flat, _ = model(arch)
    tp = tlm.params_from_numpy(tc, flat, "cpu")
    back = tlm.params_to_numpy(tp)
    assert back.keys() == flat.keys()
    for k in flat:
        assert np.array_equal(back[k], flat[k]), k
    assert tlm.count_params(tp) == jlm.count_params(jp)
    assert tlm.count_active_params(tc, tp) == jlm.count_active_params(jc, jp)
    assert tlm.count_active_params(tc, tp) < tlm.count_params(tp)
    full = tconfigs.get(arch).with_(dtype="float32")
    assert tlm._leaf_dtype(full, "stages/s0/b0/ffn/router") == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_tree(arch):
    """A seeded port model has the reference's leaves, shapes and
    dtypes: deepseek's layer-0 dense FFN at its own d_ff (96), the MLA
    and MoE leaves of every stage; also in bfloat16 (the router and
    the norms stay float32)."""
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
    if arch == "deepseek-v2-lite-16b":
        assert got["stages/s0/b0/ffn/wg"][0] == (1, 64, 96)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_loss_match(arch):
    """Hidden states and logits rtol 1e-4 / atol 1e-5; the summed aux
    and ``lm_loss`` rtol 1e-5, with aux_coef 0 (the default) and 0.01."""
    jc, tc, jp, _, batch = model(arch)
    jh, _, jaux = jax.jit(lambda p, t: jlm.forward(jc, p, t))(
        jp, batch["tokens"])
    tp = _tparams(arch)
    tb = _tb(batch)
    th, _, taux = tlm.forward_aux(tc, tp, tb["tokens"])
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(
        _np(tlm.logits_fn(tc, tp, th[:, -1])),
        np.asarray(jlm.logits_fn(jc, jp, jh[:, -1])), rtol=1e-4, atol=1e-5)
    assert torch.equal(tlm.forward(tc, tp, tb["tokens"]), th)
    for coef in (0.0, 0.01):
        want = float(jax.jit(lambda p, b: jlm.lm_loss(jc, p, b, coef))(
            jp, _jb(batch)))
        got = float(tlm.lm_loss(tc, tp, tb, coef))
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("n_drop", [1, 2])
@pytest.mark.parametrize("seed", [0, 7, 21, 12345])
def test_layer_selection_across_two_stages(seed, n_drop):
    """deepseek's two layer groups (s0.b0: 1 layer, s1.b0: 2): the
    stratified masks, active indices and count equal
    ``repro.core.zo.stratified_select`` bit for bit."""
    _, _, jp, _, _ = model("deepseek-v2-lite-16b")
    tp = _tparams("deepseek-v2-lite-16b")
    jspec = jzo.build_spec(jp, jlm.zo_group_fn)
    tspec = tzo.build_spec(tp, tlm.zo_group_fn)
    assert tspec.slices == {"s0.b0": (0, 1), "s1.b0": (1, 2)}
    assert dict(jspec.slices) == tspec.slices
    jm, ji, jn = jzo.stratified_select(jspec, jnp.uint32(seed), n_drop)
    tm, ti, tn = tzo.stratified_select(tspec, seed, n_drop)
    assert int(jn) == tn
    for g in tspec.slices:
        assert np.array_equal(_np(tm[g]), np.asarray(jm[g])), g
        assert np.array_equal(_np(ti[g]), np.asarray(ji[g])), g


@pytest.mark.parametrize("backend", ["dense", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_two_point_materialized(arch, backend):
    """One reference two-point step (materialized, dense axpy), then the
    port's: its probe loss (rtol 1e-5), active layers, and its update
    driven by the reference's projected gradient (atol 1e-6), with the
    port's axpy on ``dense`` or on K1's dispatch (``pallas``: K1's plain
    version on the CPU) over the 4-D expert stacks and the float32
    router."""
    jc, tc, jp, _, batch = model(arch)
    base, t = 77, 3
    kw = dict(name="two_point", q=1, eps=EPS, lr=LR, n_drop=1,
              weight_decay=0.1, forward_backend="materialized")
    jcfg = jest.EstimatorConfig(**kw, backend="dense")
    tcfg = test_.EstimatorConfig(**kw, backend=backend)
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


def test_virtual_forward_refused_on_moe_and_mla():
    """A virtual ctx on an MLA or MoE block raises, naming the
    materialized backend, as the reference's ``_run_block`` does."""
    from repro_torch import fused as tfused
    _, tc, _, _, batch = model("granite-moe-1b-a400m")
    tp = _tparams("granite-moe-1b-a400m")
    masks = {"s0.b0": torch.tensor([True, True])}
    with pytest.raises(NotImplementedError, match="materialized"):
        tlm.lm_loss(tc, tp, _tb(batch), perturb=tfused.make_ctx(
            SEED, EPS, masks, "virtual_ref"))


# --------------------------------------------------------------- serving
def _serving(mod, **over):
    kw = dict(page_size=4, n_pages=32, max_lanes=3, prefill_chunk=8,
              max_seq=64)
    kw.update(over)
    return mod.Serving(**kw)


def _five(vocab):
    rng = np.random.default_rng(0)
    return [dict(rid=i,
                 tokens=rng.integers(0, vocab,
                                     int(rng.integers(3, 18))).tolist(),
                 max_new_tokens=int(rng.integers(2, 7)), seed=i)
            for i in range(5)]


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_granite_engine_greedy_tokens_equal_reference(cf):
    """granite-moe through the paged engine: at the published capacity
    factor (1.25: prefill chunks and decode rows drop what the
    reference's chunks drop) and dropless (4.0), the port's engine gives
    the reference engine's greedy tokens, and the pool drains; dropless,
    the engine equals the port's own lockstep too."""
    jc, tc, jp, _, _ = model("granite-moe-1b-a400m", capacity_factor=cf)
    tp = _tparams("granite-moe-1b-a400m", capacity_factor=cf)
    reqs = _five(jc.vocab)
    want = {r.rid: r.tokens for r in jsv.Engine(jc, jp, _serving(japi)).run(
        [jsv.Request(**q) for q in reqs])}
    eng = tsv.Engine(tc, tp, _serving(tapi), device="cpu")
    got = {r.rid: r.tokens for r in eng.run(
        [tsv.Request(**q) for q in reqs])}
    assert got == want
    assert eng.n_compiles() == 2 and eng.pool.in_use == 0
    eng.pool.check_invariants()
    if cf == 4.0:
        for q in reqs:
            ls = tserve.generate(tc, tp, torch.tensor([q["tokens"]]),
                                 q["max_new_tokens"], max_seq=64)
            assert ls[0].tolist() == got[q["rid"]], q["rid"]


@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_generate_equals_reference(arch):
    """The lockstep ``generate`` (deepseek: MLA's latent cache and the
    absorbed decode) gives the reference's greedy tokens, batch 2."""
    jc, tc, jp, _, batch = model(arch)
    tp = _tparams(arch)
    toks = batch["tokens"][:2, :11]
    want = np.asarray(jserve.generate(jc, jp, jnp.asarray(toks), 6,
                                      max_seq=20))
    got = tserve.generate(tc, tp, torch.tensor(toks), 6, max_seq=20)
    assert _np(got).tolist() == want.tolist()


def test_deepseek_served_by_lockstep_only():
    """``supports_paged`` is the reference's: false for MLA (the engine
    refuses it, the CLI's ``--engine auto`` falls back to the lockstep),
    true for attn + moe."""
    for arch in ARCHS:
        assert tlm.supports_paged(tconfigs.get(arch)) == \
            jlm.supports_paged(jconfigs.get(arch))
    tc = tconfigs.get("deepseek-v2-lite-16b", "smoke")
    with pytest.raises(tsv.EngineUnsupported, match="lockstep"):
        tsv.Engine(tc, _tparams("deepseek-v2-lite-16b"), _serving(tapi),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="lockstep"):
        tlm.init_paged_cache(tc, 8, 4, device="cpu")


@pytest.mark.parametrize("arch,engine", [
    ("granite-moe-1b-a400m", "paged"), ("deepseek-v2-lite-16b", "lockstep")])
def test_cli_serve_archs(arch, engine, capsys):
    from repro_torch.launch import cli as tcli
    result = tcli.main(["serve", "--arch", arch, "--variant", "smoke",
                        "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--gen", "3",
                        "--set", "serving.page_size=4",
                        "--set", "serving.prefill_chunk=8",
                        "--set", "serving.max_seq=64"])
    assert result["engine"]["mode"] == engine
    assert [len(t) for t in result["tokens"]] == [3, 3]
    assert "tok/s" in capsys.readouterr().out


# ------------------------------------------------------------ validation
@pytest.mark.parametrize("fb", ["virtual", "virtual_ref"])
@pytest.mark.parametrize("arch", ARCHS)
def test_virtual_spec_refused_naming_materialized(arch, fb):
    """A virtual spec for an MoE/MLA arch raises at
    ``runtime.forward_backend``, naming the materialized backend; the
    reference refuses the same spec at the same path."""
    over = {"model.arch": arch, "runtime.forward_backend": fb}
    for api in (japi, tapi):
        with pytest.raises(api.SpecError) as e:
            api.validate(api.with_overrides(api.preset("lezo-opt13b"), over))
        assert e.value.path == "runtime.forward_backend"
    assert "forward_backend='materialized'" in str(e.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_materialized_spec_validates_and_runs(arch):
    """The materialized spec validates in both packages to the same
    config, and ``api.run`` on the smoke variant reports the active
    parameter count in its summary."""
    over = {"model.arch": arch, "runtime.forward_backend": "materialized",
            "runtime.backend": "pallas"}
    tcfg = tapi.validate(tapi.with_overrides(tapi.preset("lezo-opt13b"),
                                             over))
    jcfg = japi.validate(japi.with_overrides(japi.preset("lezo-opt13b"),
                                             over))
    assert as_reference(tcfg) == dataclasses.asdict(jcfg)
    spec = tapi.with_overrides(tapi.preset("lezo-opt13b"), {
        **over, "model.variant": "smoke", "model.seq_len": 9,
        "run.steps": 2, "run.batch_size": 2, "run.eval_every": 0})
    out = tapi.run(spec, device="cpu")
    s = out["summary"]
    params = out["history"]["final_params"]
    assert s["n_active_params"] == tlm.count_active_params(
        tconfigs.get(arch, "smoke"), params) < s["n_params"]
    assert all(np.isfinite(out["history"]["loss"]))


@pytest.mark.parametrize("arch", UNPORTED)
def test_ssm_archs_still_unported(arch):
    """The SSM archs (ported since) resolve in the port to the
    reference's config on the preset's materialized backend; the
    virtual one raises at ``runtime.forward_backend``."""
    assert arch in jconfigs.list_archs()
    assert arch in tconfigs.list_archs()
    over = {"model.arch": arch}
    assert as_reference(tapi.validate(tapi.with_overrides(
        tapi.preset("lezo-opt13b"), over))) == dataclasses.asdict(
        japi.validate(japi.with_overrides(japi.preset("lezo-opt13b"), over)))
    with pytest.raises(tapi.SpecError, match="materialized") as e:
        tapi.validate(tapi.with_overrides(tapi.preset("lezo-opt13b"), {
            **over, "runtime.forward_backend": "virtual"}))
    assert e.value.path == "runtime.forward_backend"


def test_ssm_blocks_refused_by_the_model():
    """Each recurrent kind (with an MoE FFN, as jamba's odd layers) is
    built by the model, but the virtual ``pc`` path refuses it, naming
    the materialized backend, as the reference's ``_run_block`` does."""
    from repro_torch import fused as tfused
    from repro_torch.models.config import BlockCfg, StageCfg
    tc = tconfigs.get("granite-moe-1b-a400m", "smoke")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    batch = {"tokens": toks, "labels": toks,
             "loss_mask": torch.ones((1, 4))}
    for kind in ("mamba", "mlstm", "slstm"):
        cfg = tc.with_(stages=(StageCfg(1, (BlockCfg(kind, "moe"),)),))
        params = tlm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
        assert torch.isfinite(tlm.lm_loss(cfg, params, batch))
        ctx = tfused.make_ctx(SEED, EPS, {"s0.b0": torch.tensor([True])},
                              "virtual_ref")
        with pytest.raises(NotImplementedError, match="materialized"):
            tlm.lm_loss(cfg, params, batch, perturb=ctx)


@pytest.mark.parametrize("arch", ARCHS + UNPORTED)
def test_configs_match_reference(arch):
    """Every field of both variants equals the reference's (the MoE/MLA
    archs and the recurrent ones); deepseek's head_dim resolves to 128
    (+ 64 rope) at full size."""
    for variant in ("full", "smoke"):
        assert as_reference(tconfigs.get(arch, variant)) == \
            dataclasses.asdict(jconfigs.get(arch, variant)), variant
    c = tconfigs.get("deepseek-v2-lite-16b")
    assert (c.head_dim, c.rope_head_dim, c.kv_lora, c.num_layers) == (
        128, 64, 512, 27)
    assert c.stages[0].pattern[0].d_ff == 10944

"""Port parity of the serving path on ``opt-13b``/``smoke`` (2 layers,
d_model 64, float32), the reference's weights carried across by
``models.lm.params_from_numpy``.

Tolerances (float32, the same inputs through both packages, absolute):
decode and paged attention within 1e-6; prefill/serve_step/paged_step
logits (O(1)) and the caches and arena they write within 1e-5, as the
two frameworks sum in different orders through two layers.
Greedy tokens are compared exactly: the port's engine and lockstep
against the reference engine's and lockstep's, and, inside the port,
engine = lockstep, sharing on = off and preempt = no preempt.  The rope
archs (``internlm2-1.8b``/``smoke``: GQA, rope; ``qwen3-14b``/``smoke``:
qk-norm too) are held the same way, with per-lane rope positions in
``paged_step``; stub-frontend archs are refused by the engine and the
CLI, through the registry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro import serving as jsv
from repro.core import zo as jzo
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch import api as tapi
from repro_torch import configs as tconfigs
from repro_torch import serving as tsv
from repro_torch.launch import cli as tcli
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving import sampling as tsampling

torch.set_num_threads(2)              # six xdist workers share the CPUs

LOGIT_TOL, CACHE_TOL, ATTN_TOL = 1e-5, 1e-5, 1e-6


@pytest.fixture(scope="module")
def opt_smoke():
    jc = jconfigs.get("opt-13b", "smoke")
    tc = tconfigs.get("opt-13b", "smoke")
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    flat = {jzo._path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(jp)}
    return jc, tc, jp, tlm.params_from_numpy(tc, flat, "cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol, err


def _tree_close(tcache, jcache, tol):
    for si, blocks in jcache.items():
        for bj, leaves in blocks.items():
            for k, v in leaves.items():
                _close(_np(tcache[si][bj][k]), v, tol)


def _serving(mod, **over):
    kw = dict(page_size=4, n_pages=32, max_lanes=3, prefill_chunk=8,
              max_seq=64)
    kw.update(over)
    return mod.Serving(**kw)


def _engine(tc, tp, **over):
    return tsv.Engine(tc, tp, _serving(tapi, **over), device="cpu")


def _lockstep(tc, tp, tokens, gen):
    out = tserve.generate(tc, tp, torch.tensor([tokens]), gen, max_seq=64)
    return out[0].tolist()


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("cur_len", [7, [3, 9, 12]])
def test_decode_attention_matches_reference(cur_len):
    r = np.random.default_rng(0)
    B, Smax, KV, G, dh = 3, 12, 2, 2, 8
    q, k, v = (r.standard_normal(s).astype(np.float32) for s in (
        (B, 1, KV, G, dh), (B, Smax, KV, dh), (B, Smax, KV, dh)))
    want = jlayers.decode_attention(q, k, v, jnp.asarray(cur_len))
    got = tlayers.decode_attention(
        *map(torch.tensor, (q, k, v)),
        cur_len if isinstance(cur_len, int) else torch.tensor(cur_len))
    _close(_np(got), want, ATTN_TOL)


@pytest.mark.parametrize("C", [1, 5])
def test_paged_attention_matches_reference(C):
    r = np.random.default_rng(1)
    B, Smax, KV, G, dh = 3, 16, 2, 2, 8
    q = r.standard_normal((B, C, KV, G, dh)).astype(np.float32)
    k, v = (r.standard_normal((B, Smax, KV, dh)).astype(np.float32)
            for _ in range(2))
    qpos = (np.array([0, 6, 10])[:, None] + np.arange(C)).astype(np.int32)
    want = jlayers.paged_attention(q, k, v, jnp.asarray(qpos))
    got = tlayers.paged_attention(*map(torch.tensor, (q, k, v)),
                                  torch.tensor(qpos, dtype=torch.int64))
    _close(_np(got), want, ATTN_TOL)


# ---------------------------------------------------------- model steps
def test_prefill_and_serve_step_match_reference(opt_smoke):
    jc, tc, jp, tp = opt_smoke
    toks = np.random.default_rng(2).integers(0, jc.vocab, (2, 9))
    jl, jcache = jlm.prefill(jc, jp, jnp.asarray(toks, jnp.int32), 16)
    tl, tcache = tlm.prefill(tc, tp, torch.tensor(toks), 16)
    _close(_np(tl), jl, LOGIT_TOL)
    _tree_close(tcache, jcache, CACHE_TOL)
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None]
        jl, jcache = jlm.serve_step(jc, jp, jcache,
                                    jnp.asarray(tok, jnp.int32),
                                    jnp.int32(9 + i))
        tl, tcache = tlm.serve_step(tc, tp, tcache, torch.tensor(tok), 9 + i)
        _close(_np(tl), jl, LOGIT_TOL)
        _tree_close(tcache, jcache, CACHE_TOL)


@pytest.mark.parametrize("B,C", [(3, 1), (1, 8)])
def test_paged_step_matches_reference(opt_smoke, B, C):
    """One decode bucket (lane 2 inactive on the trash page) and one
    prefill chunk, on an arena carried across from numpy: logits and the
    arena after the in-place write."""
    jc, tc, jp, tp = opt_smoke
    r = np.random.default_rng(3 + C)
    n_pages, psz, width = 16, 4, 6
    KV, dh = jc.n_kv_heads, jc.head_dim
    arena_np = {"s0": {"b0": {
        k: r.standard_normal((jc.stages[0].repeat, n_pages, psz, KV, dh)
                             ).astype(np.float32) for k in ("k", "v")}}}
    arena_np["s0"]["b0"]["k"][:, 0] = 0.0       # the trash page
    arena_np["s0"]["b0"]["v"][:, 0] = 0.0
    pages = np.zeros((B, width), np.int32)
    pos = np.zeros((B,), np.int32)
    if C == 1:
        pages[0, :3], pos[0] = [5, 2, 9], 9
        pages[1, :5], pos[1] = [1, 3, 4, 7, 8], 17
    else:
        pages[0, :4], pos[0] = [6, 11, 12, 13], 8
    toks = r.integers(0, jc.vocab, (B, C))
    sel = np.full((B,), C - 3 if C > 1 else 0, np.int32)
    jlog, jarena = jlm.paged_step(
        jc, jp, jax.tree.map(jnp.asarray, arena_np),
        jnp.asarray(toks, jnp.int32), jnp.asarray(pages), jnp.asarray(pos),
        jnp.asarray(sel))
    tarena = jax.tree.map(lambda a: torch.tensor(np.array(a)), arena_np)
    i64 = lambda a: torch.tensor(a, dtype=torch.int64)
    tlog, tarena = tlm.paged_step(tc, tp, tarena, i64(toks), i64(pages),
                                  i64(pos), i64(sel))
    _close(_np(tlog), jlog, LOGIT_TOL)
    _tree_close(tarena, jarena, CACHE_TOL)


# -------------------------------------------------------------- sampling
def test_greedy_takes_the_first_index_on_ties():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    z = torch.zeros(2, dtype=torch.int64)
    got = tsampling.make_sampler(0.0, 0)(logits, z, z)
    assert got.tolist() == [1, 0]
    assert got.tolist() == np.asarray(jnp.argmax(logits.numpy(), -1)
                                      ).tolist()


def test_sampler_is_a_function_of_seed_and_position():
    """The same (seed, position) draws the same token in any row of any
    batch; top-k never picks outside the k largest; other seeds or
    positions draw other tokens."""
    sample = tsampling.make_sampler(0.8, 5)
    logits = torch.tensor(np.random.default_rng(4).standard_normal(
        (1, 97)).astype(np.float32)).expand(64, 97)
    seeds = torch.arange(64, dtype=torch.int64) // 8
    positions = torch.arange(64, dtype=torch.int64) % 8 + 30
    full = sample(logits, seeds, positions)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sample(logits[perm], seeds[perm], positions[perm]),
                       full[perm])
    one = sample(logits[:1], seeds[9:10], positions[9:10])
    assert one.item() == full[9].item()
    top5 = set(torch.topk(logits[0], 5).indices.tolist())
    assert set(full.tolist()) <= top5 and len(set(full.tolist())) > 1
    with pytest.raises(ValueError, match="temperature"):
        tsampling.make_sampler(-1.0, 0)
    with pytest.raises(ValueError, match="top_k"):
        tsampling.make_sampler(1.0, -1)


# ---------------------------------------------------------------- engine
def _five(vocab):
    rng = np.random.default_rng(0)
    return [dict(rid=i,
                 tokens=rng.integers(0, vocab,
                                     int(rng.integers(3, 18))).tolist(),
                 max_new_tokens=int(rng.integers(2, 7)), seed=i)
            for i in range(5)]


def test_engine_greedy_tokens_equal_reference_engine(opt_smoke):
    """The five requests of the reference's engine gate: the port's
    engine gives the reference engine's tokens, the port's lockstep the
    reference's lockstep tokens, at two bucket shapes, and the pool
    drains."""
    jc, tc, jp, tp = opt_smoke
    reqs = _five(jc.vocab)
    jeng = jsv.Engine(jc, jp, _serving(japi))
    want = {r.rid: r.tokens for r in jeng.run(
        [jsv.Request(**q) for q in reqs])}
    eng = _engine(tc, tp)
    got = {r.rid: r.tokens for r in eng.run(
        [tsv.Request(**q) for q in reqs])}
    assert got == want
    for q in reqs:
        jls = np.asarray(jserve.generate(
            jc, jp, jnp.asarray([q["tokens"]], jnp.int32),
            q["max_new_tokens"], max_seq=64))[0].tolist()
        assert _lockstep(tc, tp, q["tokens"], q["max_new_tokens"]) == jls
    assert eng.n_compiles() == 2
    assert eng.pool.in_use == 0
    eng.pool.check_invariants()


def test_engine_greedy_bit_identical_to_lockstep(opt_smoke):
    """Inside the port: every request's engine output equals the single
    sequence lockstep path token for token, whatever lane/batch
    composition served it."""
    _, tc, _, tp = opt_smoke
    reqs = [tsv.Request(**q) for q in _five(tc.vocab)]
    for r in _engine(tc, tp, max_lanes=2).run(reqs):
        req = reqs[r.rid]
        assert r.tokens == _lockstep(tc, tp, req.tokens,
                                     req.max_new_tokens), r.rid


def test_engine_prefix_sharing_bit_identical(opt_smoke):
    """Greedy output with ``prefix_cache=True`` equals sharing off on a
    shared-system-prompt convoy; pages really share (hit rate > 0, COW
    fires); a drained engine holds pages only through the trie."""
    _, tc, _, tp = opt_smoke
    rng = np.random.default_rng(11)
    system = rng.integers(0, tc.vocab, 12).tolist()   # 3 full pages
    tails = [rng.integers(0, tc.vocab, int(rng.integers(1, 9))).tolist()
             for _ in range(4)]
    mk = lambda: [tsv.Request(rid=i, tokens=system + tails[i],
                              max_new_tokens=4, seed=i) for i in range(4)]
    off = {r.rid: r.tokens for r in _engine(tc, tp).run(mk())}
    eng = _engine(tc, tp, prefix_cache=True)
    assert {r.rid: r.tokens for r in eng.run(mk())} == off
    assert eng.sched.page_hit_rate > 0.0 and eng.sched.cow_copies > 0
    hits0 = eng.sched.prefix_hits
    assert {r.rid: r.tokens for r in eng.run(mk())} == off
    assert eng.sched.prefix_hits > hits0
    assert eng.pool.in_use == eng.sched.trie.reclaimable()
    eng.sched.trie.evict(eng.pool.in_use)
    assert eng.pool.in_use == 0
    eng.pool.check_invariants()


def test_cow_copies_a_page_across_every_leaf(opt_smoke):
    """The copy-on-write device copy, checked directly: chunks start on
    page boundaries, so the chunk that follows a copy rewrites the whole
    page and the tokens cannot show whether it ran."""
    _, tc, _, tp = opt_smoke
    eng = _engine(tc, tp)
    leaves = [t for b in eng.arena.values() for lv in b.values()
              for t in lv.values()]
    for i, t in enumerate(leaves):
        t.copy_(torch.randn(t.shape, generator=torch.Generator()
                            .manual_seed(i)))
    before = [t.clone() for t in leaves]
    eng._cstep(5, 9)
    for t, b in zip(leaves, before):
        assert torch.equal(t[:, 9], b[:, 5])
        keep = torch.ones(t.shape[1], dtype=torch.bool)
        keep[9] = False
        assert torch.equal(t[:, keep], b[:, keep])


def test_engine_preempt_resume_bit_identical(opt_smoke):
    """A decoding low-priority request evicted by a high-priority
    arrival finishes with exactly the tokens of an uncontended run."""
    _, tc, _, tp = opt_smoke
    rng = np.random.default_rng(12)
    lo_prompt = rng.integers(0, tc.vocab, 6).tolist()
    hi_prompt = rng.integers(0, tc.vocab, 6).tolist()
    kw = dict(max_lanes=1, n_pages=8, priorities=2, preempt=True,
              prefix_cache=True, max_seq=32)
    mk_lo = lambda: tsv.Request(rid=0, tokens=lo_prompt, max_new_tokens=6)
    mk_hi = lambda: tsv.Request(rid=1, tokens=hi_prompt, max_new_tokens=3,
                                priority=1)
    solo_lo = _engine(tc, tp, **kw).run([mk_lo()])[0].tokens
    solo_hi = _engine(tc, tp, **kw).run([mk_hi()])[0].tokens
    eng = _engine(tc, tp, **kw)
    eng.submit(mk_lo())
    steps = 0
    while not (eng.sched.decoding()
               and eng.sched.lanes[eng.sched.decoding()[0]].out):
        eng.step()
        steps += 1
        assert steps < 50
    eng.submit(mk_hi())                    # outranks the decoding lane
    got = {r.rid: r.tokens for r in eng.run([])}
    assert eng.sched.preemptions == 1
    assert got == {0: solo_lo, 1: solo_hi}
    assert eng.pool.in_use == eng.sched.trie.reclaimable()
    eng.pool.check_invariants()


def test_engine_sampling_reproducible_across_batch_composition(opt_smoke):
    """temperature > 0: a request's sampled continuation is a pure
    function of (seed, position), served alone or in a full batch."""
    _, tc, _, tp = opt_smoke
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tc.vocab, n).tolist() for n in (9, 14, 5, 11)]
    mk = lambda: [tsv.Request(rid=i, tokens=p, max_new_tokens=6,
                              seed=100 + i) for i, p in enumerate(prompts)]
    full = {r.rid: r.tokens for r in _engine(
        tc, tp, temperature=0.8, top_k=8).run(mk())}
    greedy = {r.rid: r.tokens for r in _engine(tc, tp).run(mk())}
    assert full != greedy
    for i in range(len(prompts)):
        alone = _engine(tc, tp, temperature=0.8, top_k=8).run([mk()[i]])
        assert alone[0].tokens == full[i], f"rid {i} drifted with batch"


def test_engine_eos_stops_early_and_frees_pages(opt_smoke):
    _, tc, _, tp = opt_smoke
    prompt = np.random.default_rng(3).integers(0, tc.vocab, 9).tolist()
    ref = _engine(tc, tp).run(
        [tsv.Request(rid=0, tokens=prompt, max_new_tokens=8)])[0].tokens
    eos = ref[3]
    eng = _engine(tc, tp, eos_id=int(eos))
    out = eng.run([tsv.Request(rid=0, tokens=prompt, max_new_tokens=8)])[0]
    assert out.tokens == ref[:ref.index(eos) + 1]   # cut at the first EOS
    assert eng.pool.in_use == 0


def test_engine_interleaves_prefill_with_decode(opt_smoke):
    """A 4-chunk admission does not pause the running decode lane."""
    _, tc, _, tp = opt_smoke
    rng = np.random.default_rng(4)
    eng = _engine(tc, tp, n_pages=48)
    eng.submit(tsv.Request(rid=0, tokens=rng.integers(0, tc.vocab, 4)
                           .tolist(), max_new_tokens=12))
    while not eng.sched.decoding():
        eng.step()
    d0 = eng.n_decode_steps
    eng.submit(tsv.Request(rid=1, tokens=rng.integers(0, tc.vocab, 30)
                           .tolist(), max_new_tokens=2))
    for _ in range(4):
        eng.step()
    assert eng.n_decode_steps >= d0 + 4
    eng.run([])


def test_prefill_serves_oldest_admission_first(opt_smoke):
    _, tc, _, tp = opt_smoke
    rng = np.random.default_rng(6)
    eng = _engine(tc, tp, max_lanes=2, n_pages=48)
    eng.submit(tsv.Request(rid=0, tokens=rng.integers(0, tc.vocab, 4)
                           .tolist(), max_new_tokens=1))
    eng.submit(tsv.Request(rid=1, tokens=rng.integers(0, tc.vocab, 30)
                           .tolist(), max_new_tokens=2))
    eng.step()                                   # R0 in and out, A waits
    assert eng.sched.lanes[0] is None
    eng.submit(tsv.Request(rid=2, tokens=rng.integers(0, tc.vocab, 4)
                           .tolist(), max_new_tokens=2))
    eng.step()
    a, b = eng.sched.lanes[1], eng.sched.lanes[0]
    assert a is not None and a.next_chunk == 1   # oldest got the chunk
    assert b is not None and b.next_chunk == 0   # newcomer waited
    eng.run([])


def test_engine_applies_spec_max_new_tokens_default(opt_smoke):
    _, tc, _, tp = opt_smoke
    prompt = np.random.default_rng(5).integers(0, tc.vocab, 6).tolist()
    eng = _engine(tc, tp, max_new_tokens=5)
    out = eng.run([tsv.Request(rid=0, tokens=prompt)])
    assert len(out[0].tokens) == 5
    # results are handed over, never retained
    assert [r.rid for r in eng.run([tsv.Request(rid=1, tokens=prompt)])] \
        == [1]
    assert eng.pool.in_use == 0


def test_engine_telemetry_spans_and_metrics(opt_smoke):
    """Through an enabled session: one ``serve/prefill`` span a prefill
    call, one ``serve/decode`` span a decode step, and the reference's
    metric names in the text exposition."""
    from repro_torch import obs
    _, tc, _, tp = opt_smoke
    sess = obs.session(tapi.Telemetry(enabled=True))
    eng = tsv.Engine(tc, tp, _serving(tapi), obs=sess, device="cpu")
    reqs = [tsv.Request(**q) for q in _five(tc.vocab)]
    eng.run(reqs)
    names = [r.name for r in sess.ring.records()]
    assert names.count(obs.SERVE_PREFILL) == eng.n_prefill_calls > 0
    assert names.count(obs.SERVE_DECODE) == eng.n_decode_steps > 0
    text = eng.metrics_text()
    for m in ("serving_ttft_seconds", "serving_tokens_generated",
              "serving_page_hit_rate", "serving_tokens_per_second"):
        assert m in text
    assert f"serving_requests_completed {len(reqs)}" in text


def test_engine_refuses_what_it_does_not_serve(opt_smoke, monkeypatch):
    from repro_torch.models.config import BlockCfg, StageCfg
    _, tc, _, tp = opt_smoke
    mlstm = tc.with_(stages=(StageCfg(2, (BlockCfg("mlstm"),)),))
    with pytest.raises(tsv.EngineUnsupported, match="attn mixers"):
        tsv.Engine(mlstm, tp, tapi.Serving(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsv.Engine(tc, tp, tapi.Serving())          # the card by default


# ------------------------------------------------------ spec validation
@pytest.mark.parametrize("path,bad", [
    ("serving.page_size", 0), ("serving.n_pages", 1),
    ("serving.max_lanes", 0), ("serving.prefill_chunk", 12),
    ("serving.max_seq", 20), ("serving.max_new_tokens", 0),
    ("serving.max_new_tokens", 512), ("serving.temperature", -0.5),
    ("serving.top_k", -1), ("serving.eos_id", 10 ** 9),
    ("serving.priorities", 0), ("serving.preempt", True),
    ("serving.n_pages", 2)])
def test_serving_validation_errors_match_reference(path, bad):
    errs = []
    for api in (japi, tapi):
        with pytest.raises(api.SpecError) as e:
            api.validate(api.with_overrides(api.preset("tiny-smoke"),
                                            {path: bad}))
        errs.append((e.value.path, str(e.value)))
    assert errs[0] == errs[1]
    assert errs[1][0] == path


# ------------------------------------------------------------------ CLI
@pytest.mark.parametrize("engine", ["paged", "lockstep"])
def test_cli_serve_on_the_cpu(engine, capsys):
    result = tcli.main(["serve", "--preset", "tiny-smoke", "--device", "cpu",
                        "--engine", engine, "--batch", "2",
                        "--prompt-len", "8", "--gen", "3",
                        "--set", "serving.page_size=4",
                        "--set", "serving.prefill_chunk=8",
                        "--set", "serving.max_seq=64"])
    assert result["engine"]["mode"] == engine
    assert [len(t) for t in result["tokens"]] == [3, 3]
    if engine == "paged":
        assert result["engine"]["compiles"] == 2
    assert "tok/s" in capsys.readouterr().out


# ------------------------------------------------------------- rope archs
_ROPE = {}


def _rope_smoke(arch):
    """(jax cfg, port cfg, jax params, port params) of a rope arch's
    smoke variant, built once."""
    if arch not in _ROPE:
        jc, tc = jconfigs.get(arch, "smoke"), tconfigs.get(arch, "smoke")
        jp = jlm.init_params(jc, jax.random.PRNGKey(1))
        flat = {jzo._path_str(p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(jp)}
        _ROPE[arch] = (jc, tc, jp, tlm.params_from_numpy(tc, flat, "cpu"))
    return _ROPE[arch]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-14b"])
def test_rope_prefill_decode_and_paged_step_match_reference(arch):
    """Lockstep prefill then decode at ``pos`` (rope at the same integer
    positions as train mode), and a paged decode bucket with lanes at
    different positions: logits and caches within the module's
    tolerances."""
    jc, tc, jp, tp = _rope_smoke(arch)
    r = np.random.default_rng(5)
    toks = r.integers(0, jc.vocab, (2, 9))
    jl, jcache = jlm.prefill(jc, jp, jnp.asarray(toks, jnp.int32), 16)
    tl, tcache = tlm.prefill(tc, tp, torch.tensor(toks), 16)
    _close(_np(tl), jl, LOGIT_TOL)
    _tree_close(tcache, jcache, CACHE_TOL)
    for i in range(2):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None]
        jl, jcache = jlm.serve_step(jc, jp, jcache,
                                    jnp.asarray(tok, jnp.int32),
                                    jnp.int32(9 + i))
        tl, tcache = tlm.serve_step(tc, tp, tcache, torch.tensor(tok), 9 + i)
        _close(_np(tl), jl, LOGIT_TOL)
        _tree_close(tcache, jcache, CACHE_TOL)
    n_pages, psz, KV, dh = 16, 4, jc.n_kv_heads, jc.head_dim
    arena_np = {"s0": {"b0": {
        k: r.standard_normal((jc.stages[0].repeat, n_pages, psz, KV, dh)
                             ).astype(np.float32) for k in ("k", "v")}}}
    for k in ("k", "v"):
        arena_np["s0"]["b0"][k][:, 0] = 0.0      # the trash page
    pages = np.array([[5, 2, 9, 0, 0, 0], [1, 3, 4, 7, 8, 0]], np.int32)
    pos = np.array([9, 17], np.int32)
    toks = r.integers(0, jc.vocab, (2, 1))
    sel = np.zeros((2,), np.int32)
    jlog, jarena = jlm.paged_step(
        jc, jp, jax.tree.map(jnp.asarray, arena_np),
        jnp.asarray(toks, jnp.int32), jnp.asarray(pages), jnp.asarray(pos),
        jnp.asarray(sel))
    i64 = lambda a: torch.tensor(a, dtype=torch.int64)
    tlog, tarena = tlm.paged_step(
        tc, tp, jax.tree.map(lambda a: torch.tensor(np.array(a)), arena_np),
        i64(toks), i64(pages), i64(pos), i64(sel))
    _close(_np(tlog), jlog, LOGIT_TOL)
    _tree_close(tarena, jarena, CACHE_TOL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-14b"])
def test_rope_engine_greedy_tokens_equal_reference(arch):
    """The port's engine gives the reference engine's greedy tokens and
    the port's lockstep the reference lockstep's, on a rope arch."""
    jc, tc, jp, tp = _rope_smoke(arch)
    reqs = _five(jc.vocab)
    want = {r.rid: r.tokens for r in jsv.Engine(jc, jp, _serving(japi)).run(
        [jsv.Request(**q) for q in reqs])}
    eng = _engine(tc, tp)
    got = {r.rid: r.tokens for r in eng.run(
        [tsv.Request(**q) for q in reqs])}
    assert got == want
    for q in reqs[:2]:
        jls = np.asarray(jserve.generate(
            jc, jp, jnp.asarray([q["tokens"]], jnp.int32),
            q["max_new_tokens"], max_seq=64))[0].tolist()
        assert _lockstep(tc, tp, q["tokens"], q["max_new_tokens"]) == jls
    assert eng.pool.in_use == 0


def test_engine_bit_identical_on_rope_arch():
    """The reference's ``test_engine_bit_identical_on_rope_arch``: every
    request's engine tokens equal the port's own lockstep path, on
    ``internlm2-1.8b``/``smoke``."""
    _, tc, _, tp = _rope_smoke("internlm2-1.8b")
    rng = np.random.default_rng(1)
    reqs = [tsv.Request(rid=i, tokens=rng.integers(0, tc.vocab, n).tolist(),
                        max_new_tokens=g, seed=i)
            for i, (n, g) in enumerate([(13, 5), (7, 4), (21, 3)])]
    for r in _engine(tc, tp).run(reqs):
        req = reqs[r.rid]
        assert r.tokens == _lockstep(tc, tp, req.tokens,
                                     req.max_new_tokens), r.rid


def test_rope_engine_sharing_and_preemption_bit_identical():
    """On a rope arch: prefix sharing (with a COW copy) and a preempted
    and resumed request give the tokens of sharing off, uncontended."""
    _, tc, _, tp = _rope_smoke("qwen3-14b")
    rng = np.random.default_rng(13)
    system = rng.integers(0, tc.vocab, 12).tolist()
    tails = [rng.integers(0, tc.vocab, int(rng.integers(1, 9))).tolist()
             for _ in range(4)]
    mk = lambda: [tsv.Request(rid=i, tokens=system + tails[i],
                              max_new_tokens=4, seed=i) for i in range(4)]
    off = {r.rid: r.tokens for r in _engine(tc, tp).run(mk())}
    eng = _engine(tc, tp, prefix_cache=True)
    assert {r.rid: r.tokens for r in eng.run(mk())} == off
    assert eng.sched.page_hit_rate > 0.0 and eng.sched.cow_copies > 0
    kw = dict(max_lanes=1, n_pages=8, priorities=2, preempt=True,
              max_seq=32)
    lo = lambda: tsv.Request(rid=0, tokens=tails[0] + system[:4],
                             max_new_tokens=6)
    hi = lambda: tsv.Request(rid=1, tokens=tails[1], max_new_tokens=3,
                             priority=1)
    solo = {0: _engine(tc, tp, **kw).run([lo()])[0].tokens,
            1: _engine(tc, tp, **kw).run([hi()])[0].tokens}
    eng = _engine(tc, tp, **kw)
    eng.submit(lo())
    while not (eng.sched.decoding()
               and eng.sched.lanes[eng.sched.decoding()[0]].out):
        eng.step()
    eng.submit(hi())
    assert {r.rid: r.tokens for r in eng.run([])} == solo
    assert eng.sched.preemptions == 1


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-2b"])
def test_stub_frontends_refused_through_the_registry(arch, capsys):
    """``EngineUnsupported`` for a stub-frontend arch from the registry,
    as the reference's engine; the CLI refuses both serve paths."""
    cfg = tconfigs.get(arch, "smoke")
    assert not tlm.supports_paged(cfg)
    assert tlm.supports_paged(cfg) == jlm.supports_paged(
        jconfigs.get(arch, "smoke"))
    tp = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(tsv.EngineUnsupported, match="lockstep"):
        tsv.Engine(cfg, tp, tapi.Serving(), device="cpu")
    for engine, msg in (("paged", "paged engine"),
                        ("lockstep", "stub embeddings"),
                        ("auto", "stub embeddings")):
        with pytest.raises(SystemExit, match=msg):
            tcli.main(["serve", "--arch", arch, "--variant", "smoke",
                       "--device", "cpu", "--engine", engine])

"""The zoo's families over a mesh on the CPU, against the reference.

The reference runs MoE experts tensor-parallel on d_ff and Mamba on
d_inner (``repro/distributed/sharding.py``); the port does the same per
rank on the local shards (``distributed/ctx.py::tp_block``).  Smoke
configs of five families, all float32: ``qwen3-14b`` (rope, GQA,
qk-norm), ``granite-moe-1b-a400m`` (MoE), ``deepseek-v2-lite-16b``
(MLA's ``wdkv``/``wuk``/``wuv`` + MoE with shared experts),
``jamba-v0.1-52b`` (Mamba + attn + MoE) and ``xlstm-350m`` (mLSTM,
sLSTM), from the reference's initial weights.

Subprocesses run the port over gloo ranks, one launch a mesh shape,
while this process computes the reference's side:

  * one rank, a 1 x 1 mesh: 3 two-point steps of each config bit-equal
    to the plain step (losses, projected gradients, every leaf), every
    rule a ``Shard`` over a size-1 dim, so the TP route runs with groups
    of one;
  * four ranks as (2 data x 2 model): each trajectory within the
    reference test's gate, 1e-4, of the reference's *single-device*
    ``make_zo_step`` (its multi-device run does not run on this jax);
    jamba's and xlstm's lockstep prefill and decode logits within
    LOGIT_ATOL of the reference's ``prefill``/``serve_step``, with the
    same greedy tokens, and qwen3's and deepseek's (attention's and
    MLA's sequence-sharded caches) within it of the plain port's, which
    ``test_torch_serving.py`` and ``test_torch_moe.py`` hold against the
    reference; granite's ``Engine(mesh=...)`` tokens equal to the
    reference engine's; a jamba with odd widths (d_model 65, Mamba
    d_inner 65, expert d_ff 33), which the rules leave replicated, on
    the ``rowwise`` route within the gate of the plain port.

Every run counts its routes (``ctx.ROUTES``): MoE and Mamba blocks take
the TP route once a layer a forward and ``rowwise`` never, but for the
odd widths; ``rowwise`` serves only mLSTM and sLSTM otherwise.

In this process, on the ``fake`` backend (a 1 x 4 mesh of meta
tensors, ``launch/analysis.py``'s counter): one MoE layer and one Mamba
layer (train and decode) run no all-gather, and the bytes of their
collectives by kind equal a hand count from the widths; the same layers
on the ``rowwise`` route gather their weights, which the counter sees.

No top-k routing flip showed up: the 2 x 2 losses sit within 3e-6 of
the reference's.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro import serving as jsv
from repro.core import rng as jrng
from repro.core import zo as jzo
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.core import zo as tzo
from repro_torch.models import lm as tlm

torch.set_num_threads(2)              # six xdist workers share the CPUs

REPO = os.path.join(os.path.dirname(__file__), "..")
GATE = 1e-4                           # the reference test's own gate
LOGIT_ATOL = 1e-4                     # lockstep logits, float32
STEPS, B, S = 3, 4, 16
ZO_KW = dict(eps=1e-3, lr=2e-4, n_drop=1, backend="gather")
ARCHS = ["qwen3-14b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
         "jamba-v0.1-52b", "xlstm-350m"]
ODD = "jamba-odd"                     # widths the model axis cannot split
ODD_OVER = dict(d_model=65, mamba_expand=1, moe_d_ff=33)
LOCKSTEP = ("jamba-v0.1-52b", "xlstm-350m")      # against the reference
PLAIN_LOCKSTEP = ("qwen3-14b", "deepseek-v2-lite-16b")   # the plain port
PROMPT, GEN, MAX_SEQ = 8, 4, 16
SERVING = dict(page_size=4, n_pages=32, max_lanes=3, prefill_chunk=8,
               max_seq=64)


def _cfg(configs, case):
    if case == ODD:
        return configs.get("jamba-v0.1-52b", "smoke").with_(**ODD_OVER)
    return configs.get(case, "smoke")


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [dict(rid=i, tokens=rng.integers(
        0, vocab, int(rng.integers(3, 18))).tolist(),
        max_new_tokens=int(rng.integers(2, 7)), seed=i) for i in range(5)]


_WORKER = r"""
import functools, json, os, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp

CASES, ODD, ODD_OVER = %(cases)r, %(odd)r, %(odd_over)r
LOCKSTEP = %(lockstep)r + %(plain_lockstep)r
PROMPT, GEN, MAX_SEQ = %(prompt)d, %(gen)d, %(max_seq)d
SERVING, REQUESTS = %(serving)r, %(requests)r
ZO_KW = %(zo_kw)r


def cfg_of(case):
    from repro_torch import configs
    if case == ODD:
        return configs.get("jamba-v0.1-52b", "smoke").with_(**ODD_OVER)
    return configs.get(case, "smoke")


def load(tmp, case):
    from repro_torch.models import lm
    cfg = cfg_of(case)
    flat = dict(np.load(os.path.join(tmp, f"{case}.init.npz")))
    flat = {k.replace(".", "/"): v for k, v in flat.items()}
    data = dict(np.load(os.path.join(tmp, f"{case}.data.npz")))
    batches = [{"tokens": torch.as_tensor(data["tokens"][t]),
                "labels": torch.as_tensor(data["labels"][t]),
                "loss_mask": torch.as_tensor(data["loss_mask"][t])}
               for t in range(len(data["tokens"]))]
    return cfg, lm.params_from_numpy(cfg, flat, "cpu"), batches, data


def train(cfg, params, batches, mesh):
    from repro_torch.core import rng, zo
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import specs
    from repro_torch.models import lm
    base = rng.fold_py(0, 0xC0FFEE)
    zcfg = zo.ZOConfig(**ZO_KW)
    if mesh is None:
        step = zo.make_zo_step(functools.partial(lm.lm_loss, cfg),
                               zo.build_spec(params, lm.zo_group_fn), zcfg)
    else:
        step, _ = specs.build_train_step(cfg, mesh, zcfg=zcfg)
        params = sharding.params_sharding(cfg, params, mesh)
    ctx.ROUTES.clear()
    losses, grads = [], []
    for t, b in enumerate(batches):
        if mesh is not None:
            b = sharding.batch_sharding(b, mesh)
        params, m = step(params, b, t, base)
        losses.append(float(m["loss"]))
        grads.append(float(m["projected_grad"]))
    routes = {f"{r}/{k}": n for (r, k), n in ctx.ROUTES.items()}
    ctx.set_mesh(None)
    return params, losses, grads, routes


def full(params):
    from repro_torch.core import zo
    from repro_torch.distributed.ctx import whole
    return {p.replace("/", "."): whole(t).detach().float().numpy()
            for p, t in zo.leaf_items(params)}


def lockstep(cfg, params, prompt, mesh):
    # prefill + greedy decode: over placed caches on a mesh, else plain
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import specs
    from repro_torch.models import lm
    if mesh is None:
        prefill = lambda p, x: lm.prefill(cfg, p, x, MAX_SEQ)  # noqa: E731
        serve = lambda p, c, x, i: lm.serve_step(cfg, p, c, x, i)  # noqa
        place = lambda x: x  # noqa: E731
    else:
        params = sharding.params_sharding(cfg, params, mesh)
        prefill, _ = specs.build_prefill_step(cfg, mesh, MAX_SEQ)
        serve, _, _ = specs.build_serve_step(cfg, mesh, MAX_SEQ,
                                             prompt.shape[0])
        place = lambda x: sharding.batch_sharding(  # noqa: E731
            {"x": x}, mesh)["x"]
    ctx.ROUTES.clear()
    logits, caches = prefill(params, place(prompt))
    logits = ctx.whole(logits)
    got, toks = [logits.numpy().tolist()], []
    for i in range(GEN - 1):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        toks.append(tok[:, 0].tolist())
        logits, caches = serve(params, caches, place(tok), PROMPT + i)
        logits = ctx.whole(logits)
        got.append(logits.numpy().tolist())
    toks.append(torch.argmax(logits, -1).tolist())
    routes = {f"{r}/{k}": n for (r, k), n in ctx.ROUTES.items()}
    ctx.set_mesh(None)
    return {"logits": got, "tokens": toks, "routes": routes}


def engine(cfg, params, mesh):
    from repro_torch import api, serving
    from repro_torch.distributed import ctx
    ctx.ROUTES.clear()
    eng = serving.Engine(cfg, params, api.Serving(**SERVING), mesh=mesh,
                         device="cpu")
    got = {str(r.rid): r.tokens
           for r in eng.run([serving.Request(**q) for q in REQUESTS])}
    routes = {f"{r}/{k}": n for (r, k), n in ctx.ROUTES.items()}
    ctx.set_mesh(None)
    return {"tokens": got, "routes": routes}


def one_rank(tmp):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for case in CASES + [ODD]:
        cfg, params, batches, data = load(tmp, case)
        p_plain, l_plain, g_plain, _ = train(cfg, params, batches, None)
        want = full(p_plain)
        out[case] = {"plain": l_plain}
        if case == ODD:                    # the odd widths' plain run
            np.savez(os.path.join(tmp, f"{case}.plain.npz"), **want)
            continue
        cfg, params, batches, _ = load(tmp, case)
        p_mesh, l_mesh, g_mesh, routes = train(cfg, params, batches, mesh)
        got = full(p_mesh)
        out[case].update(
            mesh=l_mesh, g_plain=g_plain, g_mesh=g_mesh, routes=routes,
            same_leaves=sorted(got) == sorted(want) and all(
                np.array_equal(got[k], want[k]) for k in want))
        np.savez(os.path.join(tmp, f"{case}.mesh11.npz"), **got)
        if case in LOCKSTEP:
            for tag, m in (("lockstep", None), ("lockstep_mesh", mesh)):
                cfg, params, _, _ = load(tmp, case)
                out[case][tag] = lockstep(
                    cfg, params, torch.as_tensor(data["prompt"]), m)
        if case == "granite-moe-1b-a400m":
            cfg, params, _, _ = load(tmp, case)
            out[case]["engine"] = {"plain": engine(cfg, params, None),
                                   "mesh": engine(cfg, params, mesh)}
    return out


def four_ranks(tmp, rank):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for case in CASES + [ODD]:
        cfg, params, batches, data = load(tmp, case)
        p22, losses, grads, routes = train(cfg, params, batches, mesh)
        leaves = full(p22)
        out[case] = {"mesh": losses, "g": grads, "routes": routes}
        if rank == 0:
            np.savez(os.path.join(tmp, f"{case}.mesh22.npz"), **leaves)
        if case in LOCKSTEP:
            cfg, params, _, _ = load(tmp, case)
            out[case]["lockstep"] = lockstep(
                cfg, params, torch.as_tensor(data["prompt"]), mesh)
        if case == "granite-moe-1b-a400m":
            cfg, params, _, _ = load(tmp, case)
            out[case]["engine"] = engine(cfg, params, mesh)
    return out


def columns(rank):
    # TP.columns over a 1 x 4 mesh: each rank's column block of a
    # (2, 3, parts·W) activation re-split into its 1/4 of every section
    from repro_torch.distributed import ctx
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 4), ("data", "model"))
    tp = ctx.TP(mesh.get_group(1), 4)
    out = {}
    for parts in (2, 3):
        W = 8
        full = torch.arange(2 * 3 * parts * W, dtype=torch.float32).reshape(
            2, 3, parts * W)
        w = parts * W // 4
        got = tp.columns(full[..., rank * w:(rank + 1) * w], parts, rank * w)
        want = [full[..., p * W + rank * W // 4:p * W + (rank + 1) * W // 4]
                for p in range(parts)]
        out[str(parts)] = len(got) == parts and all(
            torch.equal(a, b) for a, b in zip(got, want))
    return out


def rank_main(rank, world, port, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = one_rank(tmp) if world == 1 else four_ranks(tmp, rank)
        if world == 4:
            out["columns"] = columns(rank)
        every = [None] * world
        dist.all_gather_object(every, out)
        if rank == 0:
            with open(os.path.join(tmp, f"zoo{world}.json"), "w") as f:
                json.dump({"ranks": every}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    if world == 1:
        rank_main(0, 1, port, tmp)
    else:
        mp.spawn(rank_main, args=(world, port, tmp), nprocs=world)
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leaves(tree):
    return {jzo._path_str(p).replace("/", "."): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _inputs(tmp, case):
    """Initial weights (the port's seeded draw, the same arrays in the
    reference's tree) and the batches and prompt, written for the
    ranks; returns (cfg, the reference's params, data)."""
    cfg = _cfg(jconfigs, case)
    init = {p: t.numpy() for p, t in tzo.leaf_items(tlm.init_params(
        _cfg(tconfigs, case), torch.Generator().manual_seed(0), "cpu"))}
    np.savez(tmp / f"{case}.init.npz",
             **{p.replace("/", "."): v for p, v in init.items()})
    shapes = jax.eval_shape(lambda: jlm.init_params(cfg,
                                                    jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: jnp.asarray(init[jzo._path_str(p)], leaf.dtype),
        shapes)
    r = np.random.default_rng(7)
    toks = r.integers(0, cfg.vocab, (STEPS, B, S + 1)).astype(np.int32)
    data = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
            "loss_mask": np.ones((STEPS, B, S), np.float32),
            "prompt": r.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)}
    np.savez(tmp / f"{case}.data.npz", **data)
    return cfg, params, data


def _reference_case(case, cfg, params, data):
    """The reference's single-device trajectory (losses, final leaves),
    and for the lockstep and engine cases its serving outputs."""
    spec = jzo.build_spec(params, jlm.zo_group_fn)
    step = jax.jit(jzo.make_zo_step(lambda p, b: jlm.lm_loss(cfg, p, b),
                                    spec, jzo.ZOConfig(**ZO_KW)))
    base = jnp.uint32(jrng.fold_py(0, 0xC0FFEE))
    p, losses = params, []
    for t in range(STEPS):
        b = {k: jnp.asarray(data[k][t])
             for k in ("tokens", "labels", "loss_mask")}
        p, m = step(p, b, jnp.int32(t), base)
        losses.append(float(m["loss"]))
    out = {"losses": losses, "leaves": _leaves(p)}
    if case in LOCKSTEP:
        logits, caches = jlm.prefill(cfg, params, jnp.asarray(data["prompt"]),
                                     max_seq=MAX_SEQ)
        serve = jax.jit(lambda c, t, i: jlm.serve_step(cfg, params, c, t, i))
        got, toks = [np.asarray(logits)], []
        for i in range(GEN - 1):
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok[:, 0]).tolist())
            logits, caches = serve(caches, tok, jnp.int32(PROMPT + i))
            got.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, -1)).tolist())
        out["lockstep"] = {"logits": got, "tokens": toks}
    if case == "granite-moe-1b-a400m":
        eng = jsv.Engine(cfg, params, japi.Serving(**SERVING))
        out["engine"] = {str(q.rid): q.tokens for q in eng.run(
            [jsv.Request(**q) for q in _requests(cfg.vocab)])}
    return out


def _ranks(world, tmp, timeout):
    script = tmp / f"zoo_ranks{world}.py"      # spawned ranks import it
    script.write_text(_WORKER % {
        "cases": ARCHS, "odd": ODD, "odd_over": ODD_OVER,
        "lockstep": LOCKSTEP, "plain_lockstep": PLAIN_LOCKSTEP,
        "prompt": PROMPT, "gen": GEN, "max_seq": MAX_SEQ,
        "serving": SERVING, "zo_kw": ZO_KW,
        "requests": _requests(jconfigs.get("granite-moe-1b-a400m",
                                           "smoke").vocab)})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, str(script), str(world),
                        str(_free_port()), str(tmp)], capture_output=True,
                       text=True, cwd=REPO, timeout=timeout, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    with open(tmp / f"zoo{world}.json") as f:
        return json.load(f)["ranks"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(tmp, the reference's outputs by case, the 1-rank results, the
    4-rank results): the ranks run in subprocesses (1 x 1, then 2 x 2)
    while this process computes the reference's side."""
    tmp = tmp_path_factory.mktemp("mesh_zoo")
    inputs = {case: _inputs(tmp, case) for case in ARCHS + [ODD]}
    got = {}

    def launch():
        try:
            got[1] = _ranks(1, tmp, timeout=300)[0]
            got[4] = _ranks(4, tmp, timeout=400)
        except BaseException as e:       # re-raised below
            got["error"] = e
    th = threading.Thread(target=launch)
    th.start()
    try:
        ref = {case: _reference_case(case, *inputs[case]) for case in ARCHS}
    finally:
        th.join()
    if "error" in got:
        raise got["error"]
    for r in got[4][1:]:                 # every rank steps alike
        for case in ARCHS + [ODD]:
            assert r[case]["mesh"] == got[4][0][case]["mesh"], case
    return tmp, ref, got[1], got[4][0], [r["columns"] for r in got[4]]


def _blocks(case):
    """(MoE layers, Mamba layers, mLSTM + sLSTM layers) of a config."""
    cfg = _cfg(jconfigs, case)
    moe = mamba = lstm = 0
    for st in cfg.stages:
        for b in st.pattern:
            moe += st.repeat * (b.ffn == "moe")
            mamba += st.repeat * (b.kind == "mamba")
            lstm += st.repeat * (b.kind in ("mlstm", "slstm"))
    return moe, mamba, lstm


def _tp_routes(case, forwards):
    """The routes a divisible config's run must count: each MoE and
    Mamba layer on the TP route once a forward, ``rowwise`` for mLSTM
    and sLSTM only."""
    moe, mamba, _ = _blocks(case)
    cfg = _cfg(jconfigs, case)
    want = {}
    if moe:
        want["tp/moe"] = moe * forwards
    if mamba:
        want["tp/mamba"] = mamba * forwards
    for kind in ("mlstm", "slstm"):
        n = sum(st.repeat for st in cfg.stages for b in st.pattern
                if b.kind == kind)
        if n:
            want[f"rowwise/{kind}"] = n * forwards
    return want


def _within(losses, leaves, want_losses, want_leaves):
    d_loss = max(abs(a - b) for a, b in zip(losses, want_losses))
    assert d_loss < GATE, (losses, want_losses)
    assert sorted(leaves) == sorted(want_leaves)
    d_par = max(float(np.abs(leaves[k] - v).max())
                for k, v in want_leaves.items())
    assert d_par < GATE, d_par


@pytest.mark.parametrize("case", ARCHS)
def test_one_by_one_mesh_is_bit_equal_to_plain(runs, case):
    """Losses, projected gradients and every leaf of 3 steps over the
    1 x 1 mesh bit-equal to the plain step's, on the TP route for every
    MoE and Mamba layer (groups of one); within the gate of the
    reference."""
    tmp, ref, got = runs[0], runs[1][case], runs[2][case]
    assert got["mesh"] == got["plain"] and got["g_mesh"] == got["g_plain"]
    assert got["same_leaves"]
    assert got["routes"] == _tp_routes(case, 2 * STEPS)
    _within(got["mesh"], dict(np.load(tmp / f"{case}.mesh11.npz")),
            ref["losses"], ref["leaves"])


@pytest.mark.parametrize("case", ARCHS)
def test_two_by_two_mesh_matches_reference_single_device(runs, case):
    """(2 data x 2 model): every loss and every leaf of 3 steps within
    1e-4 of the reference's single-device ``make_zo_step``; experts on
    their d_ff halves, Mamba on its d_inner halves."""
    tmp, ref, got = runs[0], runs[1][case], runs[3][case]
    assert got["routes"] == _tp_routes(case, 2 * STEPS)
    _within(got["mesh"], dict(np.load(tmp / f"{case}.mesh22.npz")),
            ref["losses"], ref["leaves"])


@pytest.mark.parametrize("case", LOCKSTEP + PLAIN_LOCKSTEP)
def test_one_by_one_lockstep_is_bit_equal_to_plain(runs, case):
    """The lockstep prefill and greedy decode over the 1 x 1 mesh (the
    caches placed by ``cache_pspec``: attention's K/V and MLA's ``ckv``
    and ``kr`` on the sequence, written by ``ctx.write_seq``) against the
    plain ``prefill``/``serve_step``: every step's logits and the greedy
    tokens bit for bit, each MoE and Mamba layer on the TP route once a
    step, the plain run on none."""
    got = runs[2][case]
    mesh, plain = got["lockstep_mesh"], got["lockstep"]
    assert mesh["tokens"] == plain["tokens"]
    assert len(mesh["logits"]) == len(plain["logits"]) == GEN
    for a, b in zip(mesh["logits"], plain["logits"]):
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))
    assert mesh["routes"] == _tp_routes(case, GEN)
    assert not plain["routes"]


@pytest.mark.parametrize("case", LOCKSTEP + PLAIN_LOCKSTEP)
def test_two_by_two_lockstep_matches(runs, case):
    """The lockstep prefill and greedy decode over placed caches (Mamba's
    ``conv``/``ssm`` on their channels, the LSTM states as ``cache_pspec``
    puts them, attention's K/V and MLA's latent on the sequence): each
    step's logits within LOGIT_ATOL of the reference's
    ``prefill``/``serve_step`` (jamba, xlstm) or of the plain port's
    (qwen3, deepseek), the same greedy tokens."""
    got = runs[3][case]["lockstep"]
    want = (runs[1][case] if case in LOCKSTEP else runs[2][case])["lockstep"]
    assert got["tokens"] == want["tokens"]
    for a, b in zip(got["logits"], want["logits"]):
        assert np.abs(np.asarray(a, np.float32)
                      - np.asarray(b, np.float32)).max() < LOGIT_ATOL
    assert got["routes"] == _tp_routes(case, GEN)


def test_one_by_one_engine_is_bit_equal_to_plain(runs):
    """granite-moe's paged engine over the 1 x 1 mesh (the MoE blocks on
    the TP route, x batch-sharded over a size-1 data axis into the paged
    attention): greedy tokens equal to the plain engine's and to the
    reference engine's."""
    got = runs[2]["granite-moe-1b-a400m"]["engine"]
    want = runs[1]["granite-moe-1b-a400m"]["engine"]
    assert got["mesh"]["tokens"] == got["plain"]["tokens"] == want
    assert set(got["mesh"]["routes"]) == {"tp/moe"}
    assert not got["plain"]["routes"]


def test_two_by_two_engine_matches_reference_engine(runs):
    """granite-moe's paged engine over (2 data x 2 model), the experts on
    their d_ff halves: greedy tokens equal to the reference engine's."""
    got = runs[3]["granite-moe-1b-a400m"]["engine"]
    assert got["tokens"] == runs[1]["granite-moe-1b-a400m"]["engine"]
    assert set(got["routes"]) == {"tp/moe"} and got["routes"]["tp/moe"] > 0


def test_indivisible_widths_take_rowwise(runs):
    """Mamba's d_inner 65 and the experts' d_ff 33 do not divide the
    2-wide model axis: the rules replicate those leaves, the blocks take
    ``rowwise`` (which then gathers nothing) and the 2 x 2 trajectory
    stays within the gate of the plain port's."""
    tmp, got = runs[0], runs[3][ODD]
    moe, mamba, _ = _blocks(ODD)
    assert got["routes"] == {"rowwise/moe": moe * 2 * STEPS,
                             "rowwise/mamba": mamba * 2 * STEPS}
    _within(got["mesh"], dict(np.load(tmp / f"{ODD}.mesh22.npz")),
            runs[2][ODD]["plain"], dict(np.load(tmp / f"{ODD}.plain.npz")))


def test_columns_resplit_is_exact_on_four_ranks(runs):
    """``TP.columns`` on a 1 x 4 gloo mesh: a column block holding two or
    three sections' pieces (three: a rank's block straddles sections,
    so its chunks go to ranks out of order) comes back as this rank's
    quarter of each section, bit for bit."""
    assert runs[4] == [{"2": True, "3": True}] * 4


# ------------------------------------------- the fake mesh's collectives
WEIGHTS = ("we_g", "we_u", "we_d", "ws_g", "ws_u", "ws_d", "in_proj",
           "x_proj", "dt_w", "A_log", "conv_w", "conv_b", "out_proj")


@pytest.fixture
def fake14():
    """A (1 data x 4 model) mesh on the ``fake`` backend."""
    from repro_torch.distributed import ctx
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    dryrun.fake_world(4)
    yield make_mesh((1, 4), ("data", "model"))
    ctx.set_mesh(None)
    torch.distributed.destroy_process_group()


def _layer(arch, mesh, want):
    """The first layer of ``arch``'s smoke config whose block matches
    ``want`` ("moe" or "mamba"): (cfg, block, its params as placed)."""
    from repro_torch import configs
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import specs
    cfg = configs.get(arch, "smoke")
    params = sharding.params_sharding(cfg, specs.param_specs(cfg), mesh)
    ctx.set_mesh(mesh)
    for si, st in enumerate(cfg.stages):
        for bj, b in enumerate(st.pattern):
            if want in (b.kind, b.ffn):
                return cfg, b, params["stages"][f"s{si}"][f"b{bj}"].layer(0)
    raise AssertionError(want)


def _x(mesh, *shape):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor.from_local(torch.empty(shape, device="meta"), mesh,
                              [Shard(0), Replicate()], run_check=False)


def _counted(mesh, fn):
    from repro_torch.launch import analysis, specs
    return analysis.analyze(specs._spmd(fn), mesh=mesh)[1]


F32B = 4                              # the smoke configs are float32


@pytest.mark.parametrize("block", ["moe", "mamba-train", "mamba-decode"])
def test_fake_mesh_collectives_equal_hand_count(fake14, block):
    """One layer on a 1 x 4 fake mesh: no all-gather (no weight leaf, no
    cache gathered whole), and each collective's bytes by kind equal
    the hand count (the counter's rule: an all-reduce at twice its
    result, an all-to-all at its result, per device).

    * deepseek's MoE layer (E 4, top-2, F 48, 2 shared experts, D 64) at
      (B 4, S 16): capacity C = 12; ``o`` (B, E, C, D) and the shared
      experts' (B, S, D), each one float32 all-reduce.
    * jamba's Mamba layer (Di 128, R 4, St 16, D 64): the (B, S, 2·Di/4)
      ``in_proj`` columns re-split by one all-to-all, ``x_proj``'s (B, S,
      R + 2·St) and ``out_proj``'s (B, S, D) all-reduced; at S 16 in
      train, at S 1 in decode over the placed ``conv``/``ssm`` caches."""
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import specs
    from repro_torch.models import lm, moe
    mesh, Bx = fake14, 4
    ctx.ROUTES.clear()
    if block == "moe":
        cfg, _, p = _layer("deepseek-v2-lite-16b", mesh, "moe")
        S = 16
        c = _counted(mesh, lambda: moe.moe_fwd(cfg, p["ffn"],
                                               _x(mesh, Bx, S, 64)))
        C = moe.capacity(cfg, S)
        assert C == 12
        want = {"all-reduce": 2 * (Bx * 4 * C * 64 + Bx * S * 64) * F32B}
        assert dict(ctx.ROUTES) == {("tp", "moe"): 1}
    else:
        cfg, b, p = _layer("jamba-v0.1-52b", mesh, "mamba")
        S = 16 if block == "mamba-train" else 1
        kw = {}
        if block == "mamba-decode":
            caches = specs.placed_cache(cfg, mesh, Bx, 32)
            kw = dict(mode="decode", pos=5, cache={
                k: t[0] for k, t in caches["s0"]["b0"].items()})
            assert sharding.cache_pspec("s0/b0/ssm", (2, Bx, 128, 16),
                                        mesh)[2] == "model"
        c = _counted(mesh, lambda: lm._recurrent(
            cfg, b, p["mix"], _x(mesh, Bx, S, 64), **kw))
        Di, R, St, D = 128, 4, 16, 64
        want = {"all-to-all": Bx * S * 2 * Di // 4 * F32B,
                "all-reduce": 2 * (Bx * S * (R + 2 * St)
                                   + Bx * S * D) * F32B}
        assert dict(ctx.ROUTES) == {("tp", "mamba"): 1}
    assert "all-gather" not in c.coll, c.detail
    assert c.coll == want, c.detail
    assert set(c.coll_axes) == {"model"}


@pytest.mark.parametrize("block", ["moe", "mamba"])
def test_fake_mesh_rowwise_gathers_the_weights(fake14, block):
    """The same layers forced onto ``rowwise``: the counter sees every
    sharded weight leaf gathered whole, the traffic the TP route
    removes."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import ctx
    from repro_torch.models import moe, ssm
    mesh = fake14
    if block == "moe":
        cfg, _, p = _layer("deepseek-v2-lite-16b", mesh, "moe")
        p = p["ffn"]
        c = _counted(mesh, lambda: moe._moe_rowwise(cfg, p,
                                                    _x(mesh, 4, 16, 64)))
    else:
        cfg, _, p = _layer("jamba-v0.1-52b", mesh, "mamba")
        p = p["mix"]
        c = _counted(mesh, lambda: ctx.rowwise(
            "mamba", lambda xl, pl, cl: ssm.mamba_fwd(cfg, pl, xl), _x(
                mesh, 4, 16, 64), p))
    sharded = [k for k, t in p.items() if not isinstance(t, dict)
               and any(isinstance(pl, Shard) for pl in t.placements)]
    assert {k for k in WEIGHTS if k in p} <= set(sharded)
    assert len(sharded) == (6 if block == "moe" else 9)
    want = sum(p[k].numel() * p[k].element_size() for k in sharded)
    assert c.coll.get("all-gather") == want, c.detail

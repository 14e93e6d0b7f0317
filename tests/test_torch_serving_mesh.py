"""The port's paged engine over a mesh on the CPU (counterpart of the
reference's ``Engine(mesh=...)``, ``serving/engine.py``), against the
reference.

Subprocesses run the port's engine over gloo ranks on ``opt-13b``/
``smoke`` with the reference's weights carried across:

  * one rank: a 1 x 1 mesh engine against the plain engine in the same
    process, tokens and every arena leaf bit-equal, with and without
    prefix sharing;
  * four ranks as a (2 data x 2 model) mesh, the arena's pages split
    over ``model``: the five-request gate, a shared-prefix convoy with
    ``prefix_cache`` on (copy-on-write pages cross ranks) and a
    preemption; an ``n_pages`` the model axis does not divide, which
    places the arena replicated and takes the plain route.

Greedy tokens are held exactly against the reference's *single-device*
``Engine``: its own mesh engine does not run on this jax (its
``with_sharding_constraint`` rejects Explicit mesh axes).  Every rank
must return the same tokens.  Mesh engines run in subprocesses because
``ctx.set_mesh`` is process-global.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import configs as jconfigs
from repro import serving as jsv
from repro.core import zo as jzo
from repro.distributed import sharding as jsharding
from repro.models import lm as jlm

torch.set_num_threads(2)              # six xdist workers share the CPUs

REPO = os.path.join(os.path.dirname(__file__), "..")
SERVING = dict(page_size=4, n_pages=32, max_lanes=3, prefill_chunk=8,
               max_seq=64)
PREEMPT = dict(max_lanes=1, n_pages=8, priorities=2, preempt=True,
               prefix_cache=True, max_seq=32, page_size=4, prefill_chunk=8)


def _five(vocab):
    rng = np.random.default_rng(0)
    return [dict(rid=i,
                 tokens=rng.integers(0, vocab,
                                     int(rng.integers(3, 18))).tolist(),
                 max_new_tokens=int(rng.integers(2, 7)), seed=i)
            for i in range(5)]


def _convoy(vocab):
    rng = np.random.default_rng(11)
    system = rng.integers(0, vocab, 12).tolist()     # 3 full pages
    return [dict(rid=i, tokens=system + rng.integers(
        0, vocab, int(rng.integers(1, 9))).tolist(), max_new_tokens=4,
        seed=i) for i in range(4)]


def _preempt_prompts(vocab):
    rng = np.random.default_rng(12)
    return rng.integers(0, vocab, 6).tolist(), rng.integers(
        0, vocab, 6).tolist()


_WORKER = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp

SERVING = %(serving)r
PREEMPT = %(preempt)r
WORK = %(work)r


def setup(tmp):
    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get("opt-13b", "smoke")
    flat = dict(np.load(os.path.join(tmp, "init.npz")))
    flat = {k.replace(".", "/"): v for k, v in flat.items()}
    return cfg, lm.params_from_numpy(cfg, flat, "cpu")


def engine(cfg, params, mesh, **over):
    from repro_torch import api, serving
    kw = dict(SERVING)
    kw.update(over)
    return serving.Engine(cfg, params, api.Serving(**kw), mesh=mesh,
                          device="cpu")


def tokens(eng, reqs):
    from repro_torch import serving
    return {str(r.rid): r.tokens
            for r in eng.run([serving.Request(**q) for q in reqs])}


def preempted(cfg, params, mesh):
    # a decoding low-priority lane evicted by a high-priority arrival
    from repro_torch import serving
    lo, hi = WORK["preempt"]
    eng = engine(cfg, params, mesh, **PREEMPT)
    eng.submit(serving.Request(rid=0, tokens=lo, max_new_tokens=6))
    while not (eng.sched.decoding()
               and eng.sched.lanes[eng.sched.decoding()[0]].out):
        eng.step()
    eng.submit(serving.Request(rid=1, tokens=hi, max_new_tokens=3,
                               priority=1))
    got = {str(r.rid): r.tokens for r in eng.run([])}
    return got, eng.sched.preemptions, placed(eng)


def arena(eng):
    from repro_torch.distributed import ctx
    return [ctx.whole(t) for b in eng.arena.values() for lv in b.values()
            for t in lv.values()]


def names(pl):
    return [f"Shard({p.dim})" if hasattr(p, "dim") else type(p).__name__
            for p in pl]


def placed(eng):
    return names(eng.arena["s0"]["b0"]["k"].placements)


def one_rank(tmp):
    from repro_torch.launch.mesh import make_mesh
    cfg, params = setup(tmp)
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for name, reqs, over in (("five", WORK["five"], {}),
                             ("convoy", WORK["convoy"],
                              {"prefix_cache": True})):
        plain = engine(cfg, params, None, **over)
        want = tokens(plain, reqs)
        eng = engine(cfg, params, mesh, **over)
        got = tokens(eng, reqs)
        out[name] = {
            "plain": want, "mesh": got, "placements": placed(eng),
            "arena_equal": all(torch.equal(a, b) for a, b in
                               zip(arena(eng), arena(plain))),
            "cow": eng.sched.cow_copies,
            "params_untouched": not any(
                hasattr(p, "placements") for p in params.parameters())}
    return out


def four_ranks(tmp):
    from repro_torch.launch.mesh import make_mesh
    cfg, params = setup(tmp)
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    eng = engine(cfg, params, mesh)
    out["five"] = {"mesh": tokens(eng, WORK["five"]),
                   "placements": placed(eng)}
    eng = engine(cfg, params, mesh, prefix_cache=True)
    out["convoy"] = {"mesh": tokens(eng, WORK["convoy"]),
                     "placements": placed(eng),
                     "cow": eng.sched.cow_copies,
                     "hit": eng.sched.page_hit_rate}
    got, n_pre, pl = preempted(cfg, params, mesh)
    out["preempt"] = {"mesh": got, "preemptions": n_pre, "placements": pl}
    eng = engine(cfg, params, mesh, n_pages=33)
    out["odd_pages"] = {"mesh": tokens(eng, WORK["five"]),
                        "placements": placed(eng)}
    shapes = {}
    for n_pages in (32, 33):
        from repro_torch.distributed import sharding
        from repro_torch.models import lm
        a = sharding.arena_sharding(lm.init_paged_cache(
            cfg, n_pages, 4, device="cpu"), mesh)
        shapes[str(n_pages)] = {
            f"{s}/{b}/{n}": names(t.placements)
            for s, blocks in a.items() for b, lv in blocks.items()
            for n, t in lv.items()}
    out["arena_sharding"] = shapes
    return out


def rank_main(rank, world, port, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = one_rank(tmp) if world == 1 else four_ranks(tmp)
        every = [None] * world
        dist.all_gather_object(every, out)
        if rank == 0:
            with open(os.path.join(tmp, f"engine{world}.json"), "w") as f:
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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's single-device engine on each workload, and its
    initial parameters written for the ranks."""
    tmp = tmp_path_factory.mktemp("serving_mesh")
    jc = jconfigs.get("opt-13b", "smoke")
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    np.savez(tmp / "init.npz", **{
        jzo._path_str(p).replace("/", "."): np.asarray(v)
        for p, v in jax.tree_util.tree_leaves_with_path(jp)})
    work = {"five": _five(jc.vocab), "convoy": _convoy(jc.vocab),
            "preempt": _preempt_prompts(jc.vocab)}

    def run(reqs, **over):
        kw = dict(SERVING)
        kw.update(over)
        eng = jsv.Engine(jc, jp, japi.Serving(**kw))
        return {str(r.rid): r.tokens
                for r in eng.run([jsv.Request(**q) for q in reqs])}

    lo, hi = work["preempt"]
    eng = jsv.Engine(jc, jp, japi.Serving(**PREEMPT))
    eng.submit(jsv.Request(rid=0, tokens=lo, max_new_tokens=6))
    while not (eng.sched.decoding()
               and eng.sched.lanes[eng.sched.decoding()[0]].out):
        eng.step()
    eng.submit(jsv.Request(rid=1, tokens=hi, max_new_tokens=3, priority=1))
    preempt = {str(r.rid): r.tokens for r in eng.run([])}
    assert eng.sched.preemptions == 1
    want = {"five": run(work["five"]),
            "convoy": run(work["convoy"], prefix_cache=True),
            "preempt": preempt,
            "odd_pages": run(work["five"], n_pages=33)}
    return tmp, work, want, jc


def _ranks(world, reference, timeout):
    tmp, work = reference[0], reference[1]
    script = tmp / f"engine_ranks{world}.py"
    script.write_text(_WORKER % {"serving": SERVING, "preempt": PREEMPT,
                                 "work": work})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, str(script), str(world),
                        str(_free_port()), str(tmp)], capture_output=True,
                       text=True, cwd=REPO, timeout=timeout, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    with open(tmp / f"engine{world}.json") as f:
        return json.load(f)["ranks"]


@pytest.fixture(scope="module")
def one_rank(reference):
    return _ranks(1, reference, timeout=240)[0]


@pytest.fixture(scope="module")
def four_ranks(reference):
    ranks = _ranks(4, reference, timeout=400)
    for r in ranks[1:]:                  # every rank samples the same
        for k in ("five", "convoy", "preempt", "odd_pages"):
            assert r[k]["mesh"] == ranks[0][k]["mesh"], k
    return ranks[0]


@pytest.mark.parametrize("work", ["five", "convoy"])
def test_one_by_one_engine_bit_equal_to_plain(reference, one_rank, work):
    """Tokens and every arena leaf bit-equal to the plain engine's, the
    tokens equal to the reference's; the caller's tree stays plain."""
    got = one_rank[work]
    assert got["mesh"] == got["plain"] == reference[2][work]
    assert got["arena_equal"]
    assert got["placements"] == ["Replicate", "Shard(1)"]
    assert got["params_untouched"]
    if work == "convoy":
        assert got["cow"] > 0


@pytest.mark.parametrize("work", ["five", "convoy", "preempt"])
def test_two_by_two_engine_matches_reference_engine(reference, four_ranks,
                                                    work):
    """(2 data x 2 model), the arena's pages split over ``model``:
    greedy tokens equal to the reference's single-device engine, with
    prefix sharing (copy-on-write across ranks) and preemption."""
    got = four_ranks[work]
    assert got["mesh"] == reference[2][work]
    assert got["placements"] == ["Replicate", "Shard(1)"]
    if work == "convoy":
        assert got["cow"] > 0 and got["hit"] > 0.0
    if work == "preempt":
        assert got["preemptions"] == 1


def test_indivisible_pages_take_the_replicated_route(reference, four_ranks):
    """33 pages do not divide the 2-wide model axis: the arena is
    replicated and the engine runs the plain write and gather."""
    got = four_ranks["odd_pages"]
    assert got["placements"] == ["Replicate", "Replicate"]
    assert got["mesh"] == reference[2]["odd_pages"]


@pytest.mark.parametrize("n_pages", [32, 33])
def test_arena_sharding_equals_reference_arena_pspec(reference, four_ranks,
                                                     n_pages):
    """``arena_sharding``'s placements on the (2, 2) gloo mesh are the
    reference's ``arena_pspec`` on an ``AbstractMesh`` of that shape,
    leaf for leaf."""
    from jax.sharding import AbstractMesh

    from repro_torch.distributed import sharding as tsharding
    jc = reference[3]
    mesh = AbstractMesh((2, 2), ("data", "model"))
    shapes = jax.eval_shape(lambda: jlm.init_paged_cache(jc, n_pages, 4))
    got = four_ranks["arena_sharding"][str(n_pages)]
    assert got
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        ps = jzo._path_str(path)
        spec = tuple(jsharding.arena_pspec(ps, leaf.shape, mesh))
        spec += (None,) * (len(leaf.shape) - len(spec))
        fake = type("M", (), {"mesh_dim_names": ("data", "model")})
        want = [f"Shard({p.dim})" if hasattr(p, "dim") else
                type(p).__name__ for p in tsharding.placements(spec, fake)]
        assert got[ps] == want, ps

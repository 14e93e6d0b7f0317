"""The port's mesh step on the CPU (counterpart of
``tests/test_distributed_train.py``), against the reference.

Subprocesses run the port over gloo ranks on the reference's own tiny
setup (``opt_tiny(layers=2, d_model=64, vocab=256)``, 12 steps of
``make_zo_step`` with the gather backend and ``n_drop = 1``):

  * one rank: the plain step, the same step over a 1 x 1 DTensor mesh
    (bit-equal), a checkpoint saved from the 1 x 1 tree at step 6 and
    ``remesh``ed onto a 1 x 1 mesh again (stepping on bit-equal), and
    ``pmatmul_col/row_sharded`` on a one-device mesh;
  * four ranks as a (2 data x 2 model) mesh: the trajectory, the 1 x 1
    checkpoint remeshed onto (2, 2) stepping on, and the sharded fused
    matmuls over the 2-wide ``model`` axis.

Every trajectory is held within the reference's own gate, 1e-4, of the
reference's *single-device* ``make_zo_step`` (its multi-device run does
not run on this jax).  ``make_zo_step`` is pinned bit-equal to
``estimators.make_step`` with ``from_zo`` in this process.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import opt as jopt
from repro.core import rng as jrng
from repro.core import zo as jzo
from repro.data import synthetic as jsyn
from repro.models import lm as jlm
from repro_torch import estimators as test_
from repro_torch.configs import opt as topt
from repro_torch.core import zo as tzo
from repro_torch.data import synthetic as tsyn
from repro_torch.models import lm as tlm

torch.set_num_threads(2)              # six xdist workers share the CPUs

REPO = os.path.join(os.path.dirname(__file__), "..")
GATE = 1e-4                           # the reference test's own gate
STEPS, RESUME_AT = 12, 6
ZO_KW = dict(eps=1e-3, lr=2e-4, n_drop=1, backend="gather")

_WORKER = r"""
import functools, json, os, sys
import numpy as np, torch, torch.distributed as dist
import torch.multiprocessing as mp

STEPS, RESUME_AT = %(steps)d, %(resume)d
ZO_KW = %(zo_kw)r


def setup(tmp):
    from repro_torch.configs import opt as topt
    from repro_torch.data import synthetic
    from repro_torch.models import lm as tlm
    cfg = topt.opt_tiny(layers=2, d_model=64, vocab=256)
    flat = dict(np.load(os.path.join(tmp, "init.npz")))
    flat = {k.replace(".", "/"): v for k, v in flat.items()}
    data = synthetic.make_dataset(
        synthetic.TaskConfig(vocab=256, seq_len=48, n_classes=2), 256)
    batches = [{k: torch.as_tensor(v) for k, v in b.items()
                if k != "class_labels"}
               for b in synthetic.batches(data, 16, STEPS, seed=7)]
    return cfg, lambda: tlm.params_from_numpy(cfg, flat, "cpu"), batches


def run(cfg, params, batches, mesh, start=0, stop=STEPS, ckpt=None):
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
    losses = []
    for t in range(start, stop):
        b = batches[t]
        if mesh is not None:
            b = sharding.batch_sharding(b, mesh)
        params, m = step(params, b, t, base)
        losses.append(float(m["loss"]))
        if ckpt is not None and t + 1 == RESUME_AT:
            from repro_torch.checkpoint.manager import CheckpointManager
            CheckpointManager(ckpt).save(t + 1, params, base)
    ctx.set_mesh(None)
    return params, losses


def full(params):
    from repro_torch.core import zo
    from repro_torch.distributed.ctx import is_dtensor
    out = {}
    for p, t in zo.leaf_items(params):
        t = t.full_tensor() if is_dtensor(t) else t
        out[p.replace("/", ".")] = t.detach().float().numpy()
    return out


def restored(cfg, make, ckpt, mesh):
    from repro_torch.checkpoint.manager import CheckpointManager, remesh
    from repro_torch.distributed import sharding
    params, step, _, _ = CheckpointManager(ckpt).restore(make())
    saved = full(params)
    pl = {p: sharding.placements(s, mesh)
          for p, s in sharding.param_pspecs(cfg, params, mesh).items()}
    params = remesh(params, mesh, pl)
    same = all(np.array_equal(saved[k], v) for k, v in full(params).items())
    return params, step, same


def fused(mesh):
    # the sharded fused matmuls against the unsharded plain pmatmul
    from repro_torch.fused import ref as fref
    from repro_torch.fused.sharded import (pmatmul_col_sharded,
                                           pmatmul_row_sharded)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 64), generator=g).to(torch.bfloat16)
    w = torch.randn((64, 96), generator=g).to(torch.bfloat16)
    want = fref.pmatmul(x, w, 1234, 0.5, True).float()
    col = pmatmul_col_sharded(mesh, x, w, 1234, 0.5, True).full_tensor()
    row = pmatmul_row_sharded(mesh, x, w, 1234, 0.5, True).full_tensor()
    step = 2.0 ** -7 * want.abs() + 2.0 ** -8 * want.abs().max()
    return {"col_equal": bool(torch.equal(col.float(), want)),
            "col_err": float((col.float() - want).abs().max()),
            "row_steps": float(((row.float() - want).abs() / step).max())}


def one_rank(tmp):
    from repro_torch.launch.mesh import make_mesh
    cfg, make, batches = setup(tmp)
    p_plain, plain = run(cfg, make(), batches, None)
    mesh = make_mesh((1, 1), ("data", "model"))
    ckpt = os.path.join(tmp, "ckpt11")
    p_mesh, losses = run(cfg, make(), batches, mesh, ckpt=ckpt)
    want = full(p_plain)
    same_params = all(np.array_equal(a, want[k])
                      for k, a in full(p_mesh).items())
    # resume the 1 x 1 checkpoint on a 1 x 1 mesh again: bit-equal
    params, at, same_restore = restored(cfg, make, ckpt, mesh)
    _, tail = run(cfg, params, batches, mesh, start=at)
    out = {"plain": plain, "mesh": losses, "same_params": same_params,
           "resume_at": at, "resume_tail": tail,
           "same_restore": same_restore, "fused": fused(mesh)}
    np.savez(os.path.join(tmp, "mesh11.npz"), **full(p_mesh))
    with open(os.path.join(tmp, "one.json"), "w") as f:
        json.dump(out, f)


def rank_main(rank, world, port, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh
        if world == 1:
            one_rank(tmp)
            return
        cfg, make, batches = setup(tmp)
        mesh = make_mesh((2, 2), ("data", "model"))
        p22, losses = run(cfg, make(), batches, mesh)
        params, at, same_restore = restored(
            cfg, make, os.path.join(tmp, "ckpt11"), mesh)
        _, tail = run(cfg, params, batches, mesh, start=at)
        fz = fused(mesh)
        f22 = full(p22)
        if rank == 0:
            np.savez(os.path.join(tmp, "mesh22.npz"), **f22)
            with open(os.path.join(tmp, "four.json"), "w") as f:
                json.dump({"mesh": losses, "resume_at": at,
                           "resume_tail": tail,
                           "same_restore": same_restore, "fused": fz}, f)
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


def _ranks(world: int, tmp, timeout: int):
    script = tmp / "ranks.py"          # spawned ranks import it by path
    script.write_text(_WORKER % {"steps": STEPS, "resume": RESUME_AT,
                                 "zo_kw": ZO_KW})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, str(script), str(world),
                        str(_free_port()), str(tmp)], capture_output=True,
                       text=True, cwd=REPO, timeout=timeout, env=env)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's single-device trajectory (losses, final leaves),
    and its initial parameters written for the ranks."""
    tmp = tmp_path_factory.mktemp("mesh")
    mcfg = jopt.opt_tiny(layers=2, d_model=64, vocab=256)
    task = jsyn.TaskConfig(vocab=256, seq_len=48, n_classes=2)
    data = jsyn.make_dataset(task, 256)
    tdata = tsyn.make_dataset(tsyn.TaskConfig(vocab=256, seq_len=48,
                                              n_classes=2), 256)
    assert all(np.array_equal(data[k], tdata[k]) for k in data)
    params = jlm.init_params(mcfg, jax.random.PRNGKey(0))
    np.savez(tmp / "init.npz", **{
        jzo._path_str(p).replace("/", "."): np.asarray(v)
        for p, v in jax.tree_util.tree_leaves_with_path(params)})
    spec = jzo.build_spec(params, jlm.zo_group_fn)
    step = jax.jit(jzo.make_zo_step(lambda p, b: jlm.lm_loss(mcfg, p, b),
                                    spec, jzo.ZOConfig(**ZO_KW)))
    base = jnp.uint32(jrng.fold_py(0, 0xC0FFEE))
    p, losses = params, []
    for t, batch in enumerate(jsyn.batches(data, 16, STEPS, seed=7)):
        b = {k: jnp.asarray(v) for k, v in batch.items()
             if k != "class_labels"}
        p, m = step(p, b, jnp.int32(t), base)
        losses.append(float(m["loss"]))
    leaves = {jzo._path_str(k).replace("/", "."): np.asarray(v, np.float32)
              for k, v in jax.tree_util.tree_leaves_with_path(p)}
    return tmp, losses, leaves


@pytest.fixture(scope="module")
def one_rank(reference):
    tmp = reference[0]
    _ranks(1, tmp, timeout=120)
    with open(tmp / "one.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def four_ranks(reference, one_rank):
    tmp = reference[0]
    _ranks(4, tmp, timeout=180)
    with open(tmp / "four.json") as f:
        return json.load(f)


def _within_reference(losses, leaves, reference):
    _, ref_losses, ref_leaves = reference
    d_loss = max(abs(a - b) for a, b in zip(losses, ref_losses))
    d_par = max(float(np.abs(leaves[k] - v).max())
                for k, v in ref_leaves.items())
    assert d_loss < GATE, (losses, ref_losses)
    assert d_par < GATE, d_par


def test_one_by_one_mesh_is_bit_equal_to_plain(reference, one_rank):
    assert one_rank["mesh"] == one_rank["plain"]
    assert one_rank["same_params"]
    leaves = dict(np.load(reference[0] / "mesh11.npz"))
    _within_reference(one_rank["mesh"], leaves, reference)


def test_two_by_two_mesh_matches_reference_single_device(reference,
                                                         four_ranks):
    leaves = dict(np.load(reference[0] / "mesh22.npz"))
    _within_reference(four_ranks["mesh"], leaves, reference)


@pytest.mark.parametrize("ranks", ["one", "four"])
def test_remesh_restores_and_steps_on(one_rank, four_ranks, ranks):
    """A checkpoint saved from the 1 x 1 tree at step 6, restored and
    remeshed (onto 1 x 1 again, or onto 2 x 2): every leaf bit-equal to
    the checkpoint's, and stepping on reproduces the 1 x 1 run's last
    six losses — bit for bit on 1 x 1, within the gate on 2 x 2."""
    got = one_rank if ranks == "one" else four_ranks
    assert got["resume_at"] == RESUME_AT and got["same_restore"]
    want = one_rank["mesh"][RESUME_AT:]
    if ranks == "one":
        assert got["resume_tail"] == want
    else:
        assert max(abs(a - b) for a, b in zip(got["resume_tail"],
                                              want)) < GATE


@pytest.mark.parametrize("ranks", ["one", "four"])
def test_sharded_pmatmul_matches_unsharded(one_rank, four_ranks, ranks):
    """Column shards concatenate to the unsharded plain pmatmul bit for
    bit; row shards' all-reduced partial sums sit within 2 bf16 steps
    (bit for bit on one device)."""
    fz = (one_rank if ranks == "one" else four_ranks)["fused"]
    assert fz["col_equal"], fz
    assert fz["row_steps"] <= (0.0 if ranks == "one" else 2.0), fz


@pytest.mark.parametrize("backend", ["gather", "dense", "pallas"])
def test_make_zo_step_is_estimator_step(backend):
    """``make_zo_step`` is ``estimators.make_step(from_zo(cfg))`` bit for
    bit, as the reference's tests pin its shim."""
    cfg = topt.opt_tiny(layers=2, d_model=32, vocab=64)
    zcfg = tzo.ZOConfig(eps=1e-3, lr=1e-2, n_drop=1, backend=backend,
                        weight_decay=0.1)
    loss = functools.partial(tlm.lm_loss, cfg)
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, 64, (4, 12), generator=g, dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1),
             "loss_mask": torch.ones((4, 12))}
    outs = []
    for shim in (True, False):
        p = tlm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        spec = tzo.build_spec(p, tlm.zo_group_fn)
        if shim:
            step = tzo.make_zo_step(loss, spec, zcfg)
            p, m = step(p, batch, 3, 77)
        else:
            est, init = test_.make_step(loss, spec, test_.from_zo(zcfg))
            p, _, m = est(p, init(), batch, 3, 77)
        outs.append((m["loss"], m["projected_grad"],
                     [t.clone() for t in p.parameters()]))
    (l1, g1, p1), (l2, g2, p2) = outs
    assert l1 == l2 and g1 == g2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


def test_zo_config_defaults_match_reference():
    import dataclasses
    ref = {f.name: f.default for f in dataclasses.fields(jzo.ZOConfig)}
    mine = {f.name: f.default for f in dataclasses.fields(tzo.ZOConfig)}
    assert set(ref) - set(mine) == {"interpret"}
    assert all(mine[k] == ref[k] for k in mine)
    with pytest.raises(ValueError, match="stratified"):
        tzo.make_zo_step(None, None, tzo.ZOConfig(backend="gather",
                                                  policy="uniform"))

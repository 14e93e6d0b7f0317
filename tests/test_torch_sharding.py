"""The port's sharding rules against the reference's (counterpart of
``tests/test_sharding.py``).

The rules are integer results, so they must equal the reference's for
every leaf: ``param_pspec`` over ``param_specs`` of the full config of
every arch, ``cache_pspec`` over ``cache_specs`` at (B 128, S 32768),
``arena_pspec`` over the paged arena of every arch the engine serves, and
``data_pspec`` over every (arch x shape) input, on the meshes (16, 16),
(2, 16, 16), (4, 2) and (1, 1).  The reference runs on
``jax.sharding.AbstractMesh`` with shapes from ``jax.eval_shape``, the
port on meta tensors: nothing is allocated.  The reference's own rule
cases follow, then the placement and constraint machinery on a fake
process group.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.distributed import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.core import zo as tzo
from repro_torch.distributed import ctx, sharding
from repro_torch.launch import specs as tspecs
from repro_torch.models import lm as tlm

torch.set_num_threads(2)              # six xdist workers share the CPUs

ARCHS = jconfigs.list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
CACHE_B, CACHE_S = 128, 32768
N_PAGES, PAGE = 513, 16


def _mesh(name):
    return AbstractMesh(*MESHES[name])


def _jpaths(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tpaths(tree):
    return dict(tzo.leaf_items(tree))


@functools.lru_cache(maxsize=None)
def _params(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    return (jcfg, _jpaths(jspecs.param_specs(jcfg)),
            tcfg, _tpaths(tspecs.param_specs(tcfg)))


@functools.lru_cache(maxsize=None)
def _caches(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    return (_jpaths(jspecs.cache_specs(jcfg, CACHE_B, CACHE_S)),
            _tpaths(tspecs.cache_specs(tcfg, CACHE_B, CACHE_S)))


def _same(got, want):
    """A port spec (plain tuple) equals a reference PartitionSpec, entry
    for entry under ``PartitionSpec``'s own equality (which reads a
    one-axis tuple as that axis)."""
    return len(got) == len(want) and P(*got) == want


def test_configs_shapes_match_reference():
    assert [s.__dict__ for s in tshapes.SHAPES.values()] == \
        [s.__dict__ for s in jshapes.SHAPES.values()]
    for arch in ARCHS:
        assert [s.name for s in tshapes.shapes_for(tconfigs.get(arch))] == \
            [s.name for s in jshapes.shapes_for(jconfigs.get(arch))]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_matches_reference(arch, mesh):
    jcfg, jp, tcfg, tp = _params(arch)
    assert set(jp) == set(tp)
    m = _mesh(mesh)
    for path, leaf in jp.items():
        assert tuple(tp[path].shape) == tuple(leaf.shape), path
        want = jsh.param_pspec(jcfg, path, leaf.shape, m)
        got = sharding.param_pspec(tcfg, path, tuple(tp[path].shape), m)
        assert _same(got, want), (path, got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspec_matches_reference(arch, mesh):
    jc, tc = _caches(arch)
    assert set(jc) == set(tc)
    m = _mesh(mesh)
    for path, leaf in jc.items():
        assert tuple(tc[path].shape) == tuple(leaf.shape), path
        want = jsh.cache_pspec(path, leaf.shape, m)
        assert _same(sharding.cache_pspec(path, tuple(tc[path].shape), m),
                     want), path


@pytest.mark.parametrize("arch", ARCHS)
def test_arena_and_data_pspec_match_reference(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for mesh in MESHES:
        m = _mesh(mesh)
        if jlm.supports_paged(jcfg):
            ja = _jpaths(jax.eval_shape(lambda: jlm.init_paged_cache(
                jcfg, N_PAGES, PAGE)))
            ta = _tpaths(tlm.init_paged_cache(tcfg, N_PAGES, PAGE,
                                              device="meta"))
            for path, leaf in ja.items():
                assert _same(sharding.arena_pspec(path, tuple(
                    ta[path].shape), m), jsh.arena_pspec(path, leaf.shape,
                                                         m)), path
        for shape in jshapes.shapes_for(jcfg):
            ins = _jpaths(jspecs.input_specs(jcfg, shape))
            for path, leaf in ins.items():
                if leaf.ndim and not path.startswith("caches"):
                    assert _same(sharding.data_pspec(leaf.shape, m),
                                 jsh.data_pspec(leaf.shape, m)), path


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """Same leaves, shapes and dtypes for every (arch x shape)."""
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for shape in jshapes.shapes_for(jcfg):
        want = _jpaths(jspecs.input_specs(jcfg, shape))
        got = _tpaths(tspecs.input_specs(tcfg, tshapes.SHAPES[shape.name]))
        assert set(got) == set(want), shape.name
        for path, leaf in want.items():
            assert tuple(got[path].shape) == tuple(leaf.shape), path
            assert str(got[path].dtype).removeprefix("torch.") == \
                np.dtype(leaf.dtype).name, path
            assert got[path].device.type == "meta"


# ------------------------------------------- the reference's rule cases
class FakeMesh:
    """Shape-only stand-in, as the reference's tests use."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MP = FakeMesh({"pod": 2, "data": 16, "model": 16})


@pytest.mark.parametrize("arch,path,shape,want", [
    # attention rules
    ("internlm2-1.8b", "stages/s0/b0/mix/wq", (24, 2048, 2048),
     (None, None, "model")),
    ("internlm2-1.8b", "stages/s0/b0/mix/wo", (24, 2048, 2048),
     (None, "model", None)),
    ("internlm2-1.8b", "stages/s0/b0/mix/norm/scale", (24, 2048),
     (None, None)),
    # vocab sharding
    ("internlm2-1.8b", "embed/tok", (92544, 2048), ("model", None)),
    ("internlm2-1.8b", "head/w", (2048, 92544), (None, "model")),
    # indivisible falls back to replication (7 does not divide by 16)
    ("internlm2-1.8b", "stages/s0/b0/mix/wq", (24, 2048, 7),
     (None, None, None)),
    # replicated LSTM blocks
    ("xlstm-350m", "stages/s0/b0/mix/wq", (3, 2048, 2048),
     (None, None, None)),
])
def test_param_rules(arch, path, shape, want):
    got = sharding.param_pspec(tconfigs.get(arch), path, shape, MESH)
    assert got == want
    assert _same(got, jsh.param_pspec(jconfigs.get(arch), path, shape, MESH))


@pytest.mark.parametrize("fn,args,want", [
    # cache: sequence on model, batch on data
    (sharding.cache_pspec, ("s0/b0/k", (24, 128, 32768, 8, 128), MESH),
     (None, ("data",), "model", None, None)),
    # batch=1 long context: batch dim replicated
    (sharding.cache_pspec, ("s0/b0/ckv", (26, 1, 524288, 512), MP),
     (None, None, "model", None)),
    # batch fallback
    (sharding.data_pspec, ((256, 4096), MESH), (("data",), None)),
    (sharding.data_pspec, ((1, 4096), MESH), (None, None)),
    (sharding.data_pspec, ((256, 4096), MP), (("pod", "data"), None)),
])
def test_cache_and_batch_rules(fn, args, want):
    assert fn(*args) == want


def test_constrain_noop_without_mesh():
    ctx.set_mesh(None)
    x = torch.ones((4, 4))
    assert ctx.constrain(x, "batch", "model") is x


# ------------------------------------------------ placement on a mesh
@pytest.fixture(scope="module")
def fake_mesh():
    """A (4, 2) CPU mesh on the fake process group (no data moves)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import dryrun
    dryrun.fake_world(8)
    yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    torch.distributed.destroy_process_group()


def test_placements_and_local_windows(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    m = fake_mesh
    assert sharding.placements((None, None, "model"), m) == \
        (Replicate(), Shard(2))
    assert sharding.placements((("data",), None), m) == \
        (Shard(0), Replicate())
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    d = sharding.distribute(t, m, (Shard(0), Shard(1)))
    # rank 0 holds the first block of each sharded dim
    assert torch.equal(d.to_local(), t[:2, :3])
    assert tuple(d.shape) == (8, 6)


def test_constrain_redistributes_and_drops_indivisible(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard
    ctx.set_mesh(fake_mesh)
    try:
        x = sharding.distribute(torch.zeros((8, 6, 5)), fake_mesh,
                                (Replicate(), Replicate()))
        y = ctx.constrain(x, "batch", "model", "model")
        # 6 divides the 2-wide model axis, the batch the 4-wide data axis
        assert tuple(y.placements) == (Shard(0), Shard(1))
        z = ctx.constrain(x, "batch", None, "model")   # 5 does not divide
        assert tuple(z.placements) == (Shard(0), Replicate())
        assert ctx.constrain(y, "batch", "model", None) is y
    finally:
        ctx.set_mesh(None)


def test_params_sharding_places_every_leaf(fake_mesh):
    cfg = tconfigs.get("opt-13b", "smoke")
    params = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    full = {p: t.clone() for p, t in tzo.leaf_items(params)}
    specs = sharding.param_pspecs(cfg, params, fake_mesh)
    sharding.params_sharding(cfg, params, fake_mesh)
    for path, t in tzo.leaf_items(params):
        assert tuple(t.placements) == sharding.placements(specs[path],
                                                          fake_mesh)
        lshape, off = sharding.local_window(t.shape, fake_mesh,
                                            t.placements)
        want = full[path]
        for d, (n, o) in enumerate(zip(lshape, off)):
            want = want.narrow(d, o, n)
        assert torch.equal(t.to_local(), want), path


def test_cache_and_batch_sharding_place_by_their_rules(fake_mesh):
    cfg = tconfigs.get("opt-13b", "smoke")
    caches = tlm.init_cache(cfg, 8, 16, device="cpu")
    placed = sharding.cache_sharding(caches, fake_mesh)
    for path, t in tzo.leaf_items(placed):
        assert tuple(t.placements) == sharding.placements(
            sharding.cache_pspec(path, tuple(t.shape), fake_mesh), fake_mesh)
    batch = sharding.batch_sharding(
        {"tokens": torch.zeros((8, 16), dtype=torch.int32),
         "labels": torch.zeros((3, 16), dtype=torch.int32)}, fake_mesh)
    assert tuple(batch["tokens"].to_local().shape) == (2, 16)   # 4-way data
    assert tuple(batch["labels"].to_local().shape) == (3, 16)   # replicated

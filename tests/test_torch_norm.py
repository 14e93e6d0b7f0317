"""The norm kernel's routing rule (``repro_torch.kernels.norm``), on the
CPU: which calls the card would launch the kernel for, and that every
call here runs the plain float32 ops and launches nothing.

The kernel itself runs only on the card; ``tests/test_torch_cuda.py``
holds it against the plain version there.  Here: a call under autograd
with an input that wants a gradient, a DTensor whose D is sharded, a
width past ``MAX_D`` or an unsupported dtype takes the plain version (a
DTensor whose rows each rank holds whole goes block by block); grouped
(G, 1, D) parameters against (G, M, D) rows take the kernel with G
groups; x's row stride is found for MLA's strided latent slice; the
dry run's cost counter sees an off-card call as one launch.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import opt
from repro_torch.core import zo
from repro_torch.estimators import EstimatorConfig, make_step
from repro_torch.kernels import norm as knorm
from repro_torch.launch import analysis, dryrun
from repro_torch.models import layers, lm

torch.set_num_threads(2)              # six xdist workers share the CPUs


def _args(kind, shape, dtype=torch.bfloat16, G=None, device="cpu"):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g).to(dtype).to(device)
    D = shape[-1]
    pshape = (D,) if G is None else (G, 1, D)
    n = 2 if kind == "layer" else 1
    ps = tuple((1 + 0.1 * torch.randn(pshape, generator=g)).to(device)
               for _ in range(n))
    return x, ps


def _call(kind, x, ps):
    return (layers.layer_norm(x, *ps) if kind == "layer"
            else layers.rms_norm(x, *ps))


@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_call_runs_plain_ops_and_launches_nothing(kind, dtype):
    """On the CPU a norm is today's float32 expression, bit for bit; no
    launch is counted and neither norm counter moves."""
    x, ps = _args(kind, (3, 5, 64), dtype)
    before = knorm.counter.launches
    tr = obs.Tracer()
    with obs.use(tr):
        got = _call(kind, x, ps)
    xf = x.to(torch.float32)
    if kind == "layer":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        want = ((xf - mu) * torch.rsqrt(var + 1e-5) * ps[0] + ps[1]).to(dtype)
    else:
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        want = (xf * torch.rsqrt(var + 1e-5) * ps[0]).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    assert knorm.counter.launches == before
    assert obs.CTR_NORM_KERNEL not in tr.counters
    assert obs.CTR_NORM_PLAIN not in tr.counters


@pytest.mark.parametrize("which", [0, 1, 2])
def test_grad_recording_takes_plain(which):
    """An input that wants a gradient, with grad mode on, leaves the
    plain version (the kernel has no backward); under ``no_grad`` the
    same call would launch."""
    x, ps = _args("layer", (4, 128))
    ts = [x, *ps]
    ts[which] = ts[which].detach().requires_grad_()
    assert knorm.groups(ts[0], ts[1:]) is None
    with torch.no_grad():
        assert knorm.groups(ts[0], ts[1:]) == 1
    assert knorm.groups(x, ps) == 1


@pytest.fixture()
def fake_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    dryrun.fake_world(2)
    yield init_device_mesh("cuda", (2,), mesh_dim_names=("model",))
    torch.distributed.destroy_process_group()


def test_dtensor_takes_plain(fake_mesh):
    """A DTensor (an activation or a parameter placed on a mesh) runs the
    plain version through DTensor's dispatch."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed import sharding
    x = torch.zeros((8, 256), device="meta", dtype=torch.bfloat16)
    s = torch.ones((256,), device="meta")
    xd = sharding.distribute(x, fake_mesh, (Replicate(),))
    sd = sharding.distribute(s, fake_mesh, (Replicate(),))
    assert knorm.groups(x, (s,)) == 1
    assert knorm.groups(xd, (s,)) is None
    assert knorm.groups(x, (sd,)) is None


@pytest.mark.parametrize("x_pl,s_pl,local", [
    ("R", "R", True), ("S0", "R", True), ("S1", "R", False),
    ("S-1", "R", False), ("P", "R", False), ("R", "S0", False),
    ("R", None, True)])
def test_dtensor_rows_whole_on_each_rank_go_block_by_block(fake_mesh, x_pl,
                                                          s_pl, local):
    """A DTensor whose rows each rank holds whole (replicated, or sharded
    on a leading dim), against replicated or plain parameters, is
    normalised on each rank's local block, which the kernel takes; a
    sharded D, a partial sum or a sharded parameter is not."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pl = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1), "S-1": Shard(-1),
          "P": Partial()}
    x = torch.zeros((8, 256), device="meta", dtype=torch.bfloat16)
    s = torch.ones((256,), device="meta")
    xd = DTensor.from_local(x, fake_mesh, (pl[x_pl],), run_check=False)
    sd = s if s_pl is None else DTensor.from_local(
        s if s_pl == "R" else s[:128], fake_mesh, (pl[s_pl],),
        run_check=False)
    got = knorm.local_blocks(xd, (sd,))
    assert (got is not None) == local
    if local:
        xl, (sl,) = got
        assert type(xl) is torch.Tensor and type(sl) is torch.Tensor
        assert knorm.groups(xl, (sl,)) == 1
        y = layers.rms_norm(xd, sd)
        assert isinstance(y, DTensor) and y.placements == xd.placements
        assert y.shape == xd.shape and y.dtype == xd.dtype


@pytest.mark.parametrize("x_pl,local", [
    (("S1", "S1"), False), (("R", "S1"), True), (("R", "P"), True),
    (("P", "R"), False)])
def test_a_mesh_dim_of_one_rank_holds_the_whole_row(x_pl, local):
    """On a (2, 1) mesh a placement of the one-rank dim keeps each row
    whole: D sharded or a partial sum there still goes block by block
    (a partial sum over one rank comes back replicated)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pl = {"R": Replicate(), "S1": Shard(1), "P": Partial()}
    dryrun.fake_world(2)
    try:
        mesh = init_device_mesh("cuda", (2, 1),
                                mesh_dim_names=("data", "model"))
        x = torch.zeros((8, 256), device="meta", dtype=torch.bfloat16)
        s = torch.ones((256,), device="meta")
        xd = DTensor.from_local(x, mesh, tuple(pl[p] for p in x_pl),
                                run_check=False)
        sd = DTensor.from_local(s, mesh, (Replicate(), Shard(0)),
                                run_check=False)
        assert (knorm.local_blocks(xd, (sd,)) is not None) == local
        if local:
            y = layers.rms_norm(xd, sd)
            assert y.placements == tuple(
                Replicate() if p == "P" else pl[p] for p in x_pl)
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_dtensor_on_one_rank_equals_the_plain_call(kind):
    """On a one-rank mesh a replicated DTensor's norm is the plain
    tensor's, bit for bit, and keeps its placements."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    dryrun.fake_world(1)
    try:
        mesh = init_device_mesh("cpu", (1,))
        x, ps = _args(kind, (4, 6, 96))
        dt = lambda t: DTensor.from_local(t, mesh, (Replicate(),),
                                          run_check=False)
        y = _call(kind, dt(x), tuple(dt(p) for p in ps))
        assert isinstance(y, DTensor) and y.placements == (Replicate(),)
        assert torch.equal(y.to_local(), _call(kind, x, ps))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("kind", ["layer", "rms"])
@pytest.mark.parametrize("P", [2, 3])
def test_grouped_params_take_kernel_with_g_groups(kind, P):
    """The paired forward's (P, 1, D) vectors against (P, M, D) rows are
    P groups; other broadcasts are not the kernel's."""
    x, ps = _args(kind, (P, 10, 96), G=P)
    assert knorm.groups(x, ps) == P
    assert knorm.groups(x, tuple(p[:, 0] for p in ps)) is None   # (P, D)
    assert knorm.groups(x.reshape(P, 2, 5, 96), ps) is None      # 4-D x
    assert knorm.groups(x[:1], ps) is None                       # G != P
    if kind == "layer":                                          # mixed G
        assert knorm.groups(x, (ps[0], ps[1][0, 0])) is None


@pytest.mark.parametrize("D,dtype,want", [
    (knorm.MAX_D, torch.bfloat16, 1), (knorm.MAX_D + 1, torch.bfloat16, None),
    (1, torch.float32, 1), (64, torch.float16, None), (64, torch.float64,
                                                        None)])
def test_width_and_dtype_rule(D, dtype, want):
    x = torch.zeros((2, D), dtype=dtype, device="meta")
    assert knorm.groups(x, (torch.ones((D,), device="meta"),)) == want
    assert knorm.groups(torch.zeros((2, 0)), (torch.ones((0,)),)) is None


def test_row_stride():
    """Rows of any layout whose leading dims collapse to one stride go to
    the kernel as they lie: MLA's ``dkv[..., :512]`` at stride 576."""
    dkv = torch.zeros((4, 7, 576))
    assert knorm.row_stride(dkv) == 576
    assert knorm.row_stride(dkv[..., :512]) == 576
    assert knorm.row_stride(dkv[:, 3:4, :512]) == 7 * 576   # size-1 dim
    assert knorm.row_stride(dkv[:1, :1]) == 576              # one row
    assert knorm.row_stride(dkv.transpose(0, 1)) is None
    assert knorm.row_stride(dkv.transpose(1, 2)) is None     # D strided
    assert knorm.row_stride(dkv[0, 0].expand(3, 576)) == 0
    assert knorm.row_stride(dkv[0].expand(2, 7, 576)) is None
    q = torch.zeros((2, 5, 4, 128))
    assert knorm.row_stride(q) == 128
    assert knorm.row_stride(q[:, :, 1:3]) is None


@pytest.mark.parametrize("kind", ["layer", "rms"])
def test_dry_run_counts_a_norm_as_one_launch(kind):
    """Under the cost counter an off-card call the card would launch
    counts the kernel's flops and bytes once, none of the plain ops."""
    x = torch.zeros((16, 63, 512), dtype=torch.bfloat16, device="meta")
    ps = tuple(torch.ones((512,), device="meta")
               for _ in range(2 if kind == "layer" else 1))
    c = analysis.analyze(lambda x: _call(kind, x, ps), x)[1]
    assert c.kernels == {"norm_rows": 1}
    assert (c.flops, c.bytes) == knorm.cost(x, ps)
    assert c.bytes == 2 * 16 * 63 * 512 * 2 + len(ps) * 512 * 4


def test_cpu_step_counts_no_norm():
    """A CPU ZO step under a tracer counts neither norm counter: the
    plain count is of calls on the card only."""
    cfg = opt.opt_tiny(layers=2, d_model=64, vocab=128)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = zo.build_spec(params, lm.zo_group_fn)
    step, init = make_step(
        lambda p, b, perturb=None: lm.lm_loss(cfg, p, b, perturb=perturb),
        spec, EstimatorConfig(eps=1e-3, lr=1e-4, n_drop=1, backend="pallas",
                              forward_backend="materialized"))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 128, (2, 9)))
    batch = {"tokens": toks, "labels": toks,
             "loss_mask": torch.ones((2, 9))}
    before = knorm.counter.launches
    tr = obs.Tracer()
    with obs.use(tr):
        step(params, init(), batch, 0, 7)
    assert tr.counters[obs.CTR_PROBES] == 2
    assert obs.CTR_NORM_KERNEL not in tr.counters
    assert obs.CTR_NORM_PLAIN not in tr.counters
    assert knorm.counter.launches == before

"""The port's cost counter and dry run (counterparts of
``tests/test_analysis.py`` and the dry-run cases of
``tests/test_sharding.py``).

The counter cases mirror the reference's HLO-walk cases on meta tensors
(nothing is computed): a layer loop's flops, nested loops, elementwise
ops, a matmul's bytes, and, on a fake (4, 2) mesh, flops per device —
never the global shapes DTensor dispatch shows first.  The analytic
pieces (``model_flops``, ``step_counts``, ``estimator_step_cost``) equal
the reference's functions exactly.  One full cell runs in a subprocess:
``opt-13b x train_4k`` on the fake 16 x 16 mesh.  Then the CLI and the
legacy shims.
"""
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.estimators import costs as jcosts
from repro.launch import analysis as janalysis

# the reference's dry-run modules append a 512-device flag to XLA_FLAGS
# when imported: start this process's jax backend first and put the
# variable back, so neither this worker nor its subprocesses see it
jax.devices()
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import hillclimb as jhill  # noqa: E402
if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.estimators import costs as tcosts  # noqa: E402
from repro_torch.launch import analysis, dryrun, hillclimb  # noqa: E402

torch.set_num_threads(2)              # six xdist workers share the CPUs

REPO = os.path.join(os.path.dirname(__file__), "..")
META = "meta"


def _z(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=META)


def _cost(fn, *args):
    return analysis.analyze(fn, *args)[1]


# ----------------------------------------------------------- the counter
def test_layer_loop_flops_are_layers_times_one_layer():
    W = _z(8, 128, 128)

    def f(x):
        for w in W:
            x = x @ w
        return x
    c = _cost(f, _z(4, 128))
    assert c.flops == 2 * 4 * 128 * 128 * 8
    one = _cost(lambda x: x @ W[0], _z(4, 128))
    assert c.flops == 8 * one.flops


def test_nested_loop_flops():
    W = _z(4, 64, 64)

    def f(x):
        for w in W:
            for _ in range(5):
                x = x @ w
        return x
    assert _cost(f, _z(2, 64)).flops == 2 * 2 * 64 * 64 * 20


def test_elementwise_flops_counted():
    c = _cost(lambda x: torch.exp(x) * 2.0 + 1.0, _z(1000))
    assert c.flops == 3000             # 3 elementwise ops x 1000 elems


def test_matmul_bytes_are_operands_plus_result():
    c = _cost(lambda a, b: a @ b, _z(256, 256), _z(256, 256))
    assert c.bytes == 3 * 256 * 256 * 4
    assert c.flops == 2 * 256 ** 3


def test_views_move_nothing_and_gathers_move_their_slice():
    W = _z(64, 256, 256)
    c = _cost(lambda w: w[3].reshape(-1), W)
    assert c.bytes == 0 and c.flops == 0
    idx = torch.zeros((8,), dtype=torch.int64, device=META)
    c = _cost(lambda w, i: w[i], W[0], idx)
    assert c.bytes == 2 * 8 * 256 * 4  # slice-proportional, not the table


def test_kernel_region_counts_the_kernel_once():
    """A kernel wrapper off the card counts as its kernel: K2's flops and
    bytes once, none of its plain version's ops."""
    from repro_torch.kernels import flash_attn as kfa
    q, k = _z(2, 64, 4, 1, 32, dtype=torch.bfloat16), \
        _z(2, 64, 4, 32, dtype=torch.bfloat16)
    c = _cost(lambda q, k: kfa.flash_attention(q, k, k, causal=True), q, k)
    want = kfa.cost(q, k, causal=True, q_offset=0, k_offset=0)
    assert (c.flops, c.bytes) == want and c.kernels == {"flash_attention": 1}
    assert want[0] == 4.0 * 2 * 4 * 32 * (64 * 65 // 2)


def test_peak_memory_tracks_live_temporaries():
    def f(x):
        a = x * 2.0                     # 4 KiB live
        b = a + 1.0                     # 8 KiB live
        del a
        return b.sum()
    c = _cost(f, _z(1024))
    assert c.peak == 2 * 1024 * 4


@pytest.fixture()
def fake_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    dryrun.fake_world(8)
    yield init_device_mesh("cuda", (4, 2), mesh_dim_names=("data", "model"))
    torch.distributed.destroy_process_group()


def test_flops_are_per_device_under_a_mesh(fake_mesh):
    """X (1024, 512) @ W (512, 2048) column-parallel @ W2 (2048, 512)
    row-parallel on (4 data, 2 model): each device multiplies (256, 512)
    by (512, 1024) and (1024, 512) — never the global shapes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import ctx, sharding
    x = sharding.distribute(_z(1024, 512), fake_mesh, (Shard(0), Replicate()))
    w1 = sharding.distribute(_z(512, 2048), fake_mesh,
                             (Replicate(), Shard(1)))
    w2 = sharding.distribute(_z(2048, 512), fake_mesh,
                             (Replicate(), Shard(0)))
    c = analysis.analyze(lambda: ctx.matmul(ctx.matmul(x, w1), w2),
                         mesh=fake_mesh)[1]
    per_device = 2 * 256 * 512 * 1024 * 2
    assert c.flops == per_device
    assert c.flops * 8 == 2 * 1024 * 512 * 2048 * 2   # the global count


def test_collectives_counted_by_kind_and_axis(fake_mesh):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding
    x = sharding.distribute(_z(64, 32), fake_mesh, (Shard(0), Shard(1)))
    c = analysis.analyze(lambda: x.redistribute(
        fake_mesh, (Shard(0), Replicate())), mesh=fake_mesh)[1]
    # the (16, 32) local result of an all-gather over the model axis
    assert c.coll == {"all-gather": 16 * 32 * 4}
    assert c.coll_axes == {"model": 16 * 32 * 4}


# ------------------------------------------- analytic pieces: reference
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_model_flops_matches_reference(arch):
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        for est, q in (("two_point", 1), ("one_sided", 16)):
            assert dryrun.model_flops(tcfg, SHAPES[name], est, q) == \
                jdryrun.model_flops(jcfg, JSHAPES[name], est, q)


def test_step_counts_and_estimator_step_cost_match_reference():
    terms = {"compute_s": 0.125, "memory_s": 0.5, "collective_s": 0.03}
    for name in tcosts.ESTIMATORS:
        for fb in tcosts.FORWARD_BACKENDS:
            for q in (1, 4):
                assert tcosts.step_counts(name, q=q, forward_backend=fb) \
                    == jcosts.step_counts(name, q=q, forward_backend=fb)
                for pb in (None, 2.5e9):
                    kw = dict(q=q, param_bytes=pb, hbm_bw=1.5e12,
                              forward_backend=fb)
                    assert analysis.estimator_step_cost(terms, name, **kw) \
                        == janalysis.estimator_step_cost(terms, name, **kw)
    assert analysis._HBM_BW_DEFAULT == dryrun.HBM_BW == 3.35e12


def test_link_rates_by_axis_span():
    assert dryrun.axis_link_bw({"data": 16, "model": 16}) == {
        "data": dryrun.IB_BW, "model": dryrun.IB_BW}
    assert dryrun.axis_link_bw({"data": 4, "model": 2}) == {
        "data": dryrun.NVLINK_BW, "model": dryrun.NVLINK_BW}
    assert dryrun.axis_link_bw({"data": 2, "model": 8}) == {
        "data": dryrun.IB_BW, "model": dryrun.NVLINK_BW}


# ----------------------------------------------------- one full cell
_CELL = r"""
import json, sys
sys.path.insert(0, "src")
from repro_torch.launch import dryrun
rec = dryrun.run_cell("opt-13b", "train_4k", False, verbose=False)
print(json.dumps(rec))
"""


@pytest.fixture(scope="module")
def opt_cell():
    r = subprocess.run([sys.executable, "-c", _CELL], capture_output=True,
                       text=True, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_opt13b_train_4k_cell_record(opt_cell):
    """Every field of the reference's record, per device on 256 cards."""
    ref_fields = {"arch", "shape", "variant", "estimator", "q",
                  "forward_backend", "step_counts", "mesh", "n_chips",
                  "compile_s", "memory", "roofline", "model_flops_global",
                  "model_flops_per_chip", "useful_flop_ratio"}
    assert ref_fields <= set(opt_cell)
    assert {"argument_bytes", "output_bytes", "temp_bytes",
            "alias_bytes"} <= set(opt_cell["memory"])
    assert {"compute_s", "memory_s", "collective_s", "hlo_flops",
            "hlo_bytes", "collective_bytes", "collective_breakdown",
            "n_chips", "xla_raw_flops", "xla_raw_bytes"} <= \
        set(opt_cell["roofline"])
    assert opt_cell["n_chips"] == 256 and opt_cell["mesh"] == "16x16"
    assert opt_cell["card"]["peak_flops"] == 989e12
    assert opt_cell["cfg_overrides"] == {"max_seq": 4096}


def test_opt13b_train_4k_flops_per_device(opt_cell):
    """Counted flops per device sit within 5 % of model_flops / 256 plus
    what 2·N_active·tokens leaves out: the tied head's product (its vocab
    split over the model axis) and the causal attention of the slowest
    rank's query stripe (40 heads do not divide the 16-wide model axis,
    so attention runs as 16 stripes of 256 queries; the last scores
    256 x ~4000 keys)."""
    cfg = tconfigs.get("opt-13b")
    B, S, D, V, L = 256 // 16, 4096, cfg.d_model, cfg.vocab, cfg.num_layers
    rows = S // 16
    pairs = sum(q + 1 for q in range(S - rows, S))
    attention = 4.0 * B * D * pairs * L
    head = 2.0 * B * S * D * V / 16            # vocab-parallel
    want = (opt_cell["model_flops_per_chip"]
            + 2 * (attention + head))          # two forwards a step
    got = opt_cell["roofline"]["hlo_flops"]
    assert abs(got / want - 1) < 0.05, (got, want)
    # and the useful share the chip gate reads stays a share
    assert 0.5 < opt_cell["useful_flop_ratio"] <= 1.05


def test_opt13b_train_4k_memory_per_device(opt_cell):
    """Arguments are the local shards: OPT-13B's 13B bf16 weights over a
    16-wide model axis (replicated norms and biases aside) and a batch
    of 16 rows."""
    cfg = tconfigs.get("opt-13b")
    args = opt_cell["memory"]["argument_bytes"]
    total = 12.85e9 * 2
    assert total / 16 < args < total / 16 * 1.1
    assert opt_cell["memory"]["temp_bytes"] > 0
    assert opt_cell["memory"]["alias_bytes"] < args


# --------------------------------------------------------------- CLI
@pytest.fixture()
def no_group():
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_cli_dryrun_shape(tmp_path, no_group, capsys):
    from repro_torch.launch import cli
    res = cli.main(["dryrun", "--arch", "internlm2-1.8b", "--shape",
                    "decode_32k", "--out", str(tmp_path)])
    assert not res["failures"] and len(res["cells"]) == 1
    rec = res["cells"][0]
    assert rec["spec"]["model"]["arch"] == "internlm2-1.8b"
    assert (tmp_path / "internlm2-1.8b_decode_32k_sp_optimized.json").exists()
    out = capsys.readouterr().out
    assert "compute=" in out and "1 cells passed, 0 failed" in out
    assert cli.console(["dryrun", "--arch", "internlm2-1.8b", "--shape",
                        "decode_32k", "--out", str(tmp_path)]) == 0


def test_cli_hillclimb_cfg(tmp_path, no_group, capsys, monkeypatch):
    from repro_torch.launch import cli
    monkeypatch.chdir(tmp_path)
    rec = cli.main(["hillclimb", "--arch", "internlm2-1.8b", "--shape",
                    "decode_32k", "--cfg", "attn_k_chunk=1024", "--tag", "t"])
    assert rec["overrides"] == {"attn_k_chunk": 1024}
    assert rec["terms"]["compute_s"] > 0
    assert (tmp_path / "artifacts" / "hillclimb" / "t.json").exists()
    assert "dominant:" in capsys.readouterr().out


@pytest.mark.parametrize("argv,want", [
    (["--variant", "faithful"], ["--lowering", "faithful"]),
    (["--variant=mezo", "--arch", "x"], ["--lowering=mezo", "--arch", "x"]),
])
def test_dryrun_shim_translates_like_reference(argv, want):
    assert dryrun._translate_legacy(argv) == want
    assert jdryrun._translate_legacy(argv) == want


@pytest.mark.parametrize("argv,want", [
    (["--set", "a=1", "--variant", "mezo"], ["--cfg", "a=1", "--lowering",
                                             "mezo"]),
    (["--set=b=2", "--variant=faithful"], ["--cfg=b=2",
                                           "--lowering=faithful"]),
])
def test_hillclimb_shim_translates_like_reference(argv, want):
    assert hillclimb._translate_legacy(argv) == want
    assert jhill._translate_legacy(argv) == want


def test_dryrun_shim_runs_a_cell(tmp_path, no_group):
    assert dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                        "--variant", "optimized", "--out",
                        str(tmp_path)]) == 0


def test_api_dryrun_reads_multi_pod(no_group):
    from repro_torch import api
    spec = api.with_overrides(api.preset("lezo-opt13b"), {
        "model.arch": "internlm2-1.8b", "runtime.mesh": "multi_pod"})
    (rec,) = api.dryrun(spec, shape="decode_32k")
    assert rec["mesh"] == "pod2x16x16" and rec["n_chips"] == 512
    assert rec["spec"]["runtime"]["mesh"] == "multi_pod"

"""The dry run: cost every (arch x shape x mesh) cell on a fake mesh
(counterpart of ``repro/launch/dryrun.py``).

One process stands for every rank of the production mesh: the ``fake``
process-group backend (``torch.testing._internal.distributed.fake_pg``)
answers every collective without moving data, parameters and inputs are
meta tensors placed on the mesh as each rank would hold them, and the
cell's step runs once under ``launch/analysis.py``'s counter, which
sees rank 0's local program.  Nothing is allocated and no card is
needed.

The roofline is the H100's (NVIDIA's data sheet for the SXM part,
700 W): 989e12 flop/s dense bf16 and 3.35e12 B/s of HBM.  Collectives run at the link of the mesh axis they use:
450e9 B/s each way over NVLink for an axis whose ranks sit inside one
8-card host, else 50e9 B/s, one 400 Gb/s NDR InfiniBand port a card
(the DGX/HGX H100 layout: eight ConnectX-7 ports a host, one a card).
Ranks fill hosts in mesh order, so the innermost 16-wide ``model`` axis
spans two hosts and every axis of the production meshes runs at the
InfiniBand rate.
"""
from __future__ import annotations

import math
import time

H100 = {"name": "NVIDIA H100 SXM5 80GB (data sheet)", "power_limit_w": 700,
        "peak_flops": 989e12, "hbm_bw": 3.35e12}
PEAK_FLOPS = H100["peak_flops"]     # bf16 dense
HBM_BW = H100["hbm_bw"]             # bytes/s
NVLINK_BW = 450e9                   # bytes/s each way, inside a host
IB_BW = 50e9                        # bytes/s, 400 Gb/s NDR a card
HOST_CARDS = 8


def axis_link_bw(mesh_sizes) -> dict:
    """{axis: bytes/s} for a mesh laid over hosts of HOST_CARDS ranks in
    row-major order: an axis whose ranks span more than one host runs
    at the InfiniBand rate, else at NVLink's."""
    names, sizes = list(mesh_sizes), list(mesh_sizes.values())
    out = {}
    for i, name in enumerate(names):
        stride = math.prod(sizes[i + 1:])
        out[name] = NVLINK_BW if stride * sizes[i] <= HOST_CARDS else IB_BW
    return out


def roofline_terms(cost, mem, coll, n_chips, coll_axes=None,
                   mesh_sizes=None):
    """Three roofline terms in seconds (per step, per card).  Collective
    time is each axis's bytes over its link (``coll_axes``/
    ``mesh_sizes``), or all bytes at InfiniBand's rate without them."""
    flops = cost.get("flops", 0.0)
    bytes_hbm = cost.get("bytes accessed", 0.0)
    bytes_coll = float(sum(coll.values()))
    if coll_axes and mesh_sizes:
        bw = axis_link_bw(mesh_sizes)
        coll_s = sum(v / bw.get(a, IB_BW) for a, v in coll_axes.items())
    else:
        coll_s = bytes_coll / IB_BW
    return {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": bytes_hbm / HBM_BW,
        "collective_s": coll_s,
        "hlo_flops": flops,
        "hlo_bytes": bytes_hbm,
        "collective_bytes": bytes_coll,
        "collective_breakdown": coll,
        "collective_axes": dict(coll_axes or {}),
        "n_chips": n_chips,
    }


def model_flops(cfg, shape, estimator: str = "two_point", q: int = 1) -> float:
    """Analytic training FLOPs: forwards_per_step * 2*N_active*D tokens
    (ZO has no backward pass); prefill 2*N_active a prompt token; decode
    one token a sequence."""
    from repro_torch.estimators import costs as est_costs
    from repro_torch.launch import specs
    from repro_torch.models import lm

    n_active = lm.count_active_params(cfg, specs.param_specs(cfg))
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        fwd = est_costs.step_counts(estimator, q=q)["forwards"]
        return fwd * 2.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


# ------------------------------------------------------------- lowering
def fake_world(world: int):
    """Make the default process group the ``fake`` backend over
    ``world`` ranks (this process is rank 0), replacing any other."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if (dist.get_backend() == "fake"
                and dist.get_world_size() == world):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(tree) -> int:
    from repro_torch.core import zo
    from repro_torch.distributed.ctx import is_dtensor

    if isinstance(tree, dict):
        leaves = [t for _, t in zo.leaf_items(tree)]
    else:
        leaves = [p.data for p in tree.parameters()]
    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size() for t in leaves)


def lower_cell(arch, shape_name, multi_pod: bool, variant="optimized",
               overrides: dict = None, mesh_shape=None, zcfg=None):
    """Run one cell's per-rank program under the cost counter.

    ``shape_name`` is a ``SHAPES`` key or a ``ShapeCfg``; ``mesh_shape``
    (data, model) replaces the production mesh.  Returns (cfg, shape,
    mesh, counter, memory)."""
    from repro_torch import configs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import analysis, specs
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models import frontends

    cfg = configs.get(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if cfg.pos_emb == "learned" and shape.seq_len > cfg.max_seq:
        # a learned position table must cover the cell's positions (OPT's
        # 2048 rows do not cover train_4k or decode_32k)
        cfg = cfg.with_(max_seq=shape.seq_len)
    if mesh_shape is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        fake_world(math.prod(mesh_shape))
        mesh = make_mesh(mesh_shape, ("data", "model"))
    ins = specs.input_specs(cfg, shape)
    try:
        if shape.kind == "train":
            step, params = specs.build_train_step(cfg, mesh, variant, zcfg)
            sharding.params_sharding(cfg, params, mesh)
            batch = sharding.batch_sharding(ins["batch"], mesh)
            args = (params, batch, 0, 0)
            arg_bytes = _local_bytes(params) + _local_bytes(batch)
            alias = _local_bytes(params)
        elif shape.kind == "prefill":
            step, params = specs.build_prefill_step(cfg, mesh, shape.seq_len)
            sharding.params_sharding(cfg, params, mesh)
            data = sharding.batch_sharding(
                {"x": ins.get("tokens", ins.get("embeds"))}, mesh)["x"]
            args = (params, data)
            arg_bytes = _local_bytes(params) + _local_bytes({"x": data})
            alias = 0
        else:
            step, params, _ = specs.build_serve_step(
                cfg, mesh, shape.seq_len, shape.global_batch)
            sharding.params_sharding(cfg, params, mesh)
            caches = specs.placed_cache(cfg, mesh, shape.global_batch,
                                        shape.seq_len)
            key = "embeds" if frontends.uses_embeds(cfg) else "token"
            data = sharding.batch_sharding({"x": ins[key]}, mesh)["x"]
            args = (params, caches, data, shape.seq_len - 1)
            arg_bytes = (_local_bytes(params) + _local_bytes(caches)
                         + _local_bytes({"x": data}))
            alias = _local_bytes(caches)
        out, counter = analysis.analyze(step, *args, mesh=mesh)
    finally:
        ctx.set_mesh(None)
    out_bytes = 0
    if shape.kind != "train":
        out_bytes = _local_bytes({"logits": out[0]})
        if shape.kind == "prefill":
            out_bytes += _local_bytes(out[1])
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": counter.peak, "alias_bytes": alias}
    return cfg, shape, mesh, counter, memory


def run_cell(arch: str, shape_name, multi_pod: bool,
             variant: str = "optimized", verbose: bool = True,
             overrides: dict = None, estimator: str = "two_point",
             q: int = 1, forward_backend: str = "materialized",
             mesh_shape=None, zcfg=None):
    """One cell's record: the reference's fields, with the card's
    figures (``card``) and the config fields the cell changed
    (``cfg_overrides``) beside them."""
    from repro_torch import configs
    from repro_torch.distributed.sharding import axis_sizes
    from repro_torch.estimators import costs as est_costs

    t0 = time.time()
    cfg, shape, mesh, counter, mem = lower_cell(
        arch, shape_name, multi_pod, variant, overrides, mesh_shape, zcfg)
    base_cfg = configs.get(arch)
    sizes = axis_sizes(mesh)
    n_chips = math.prod(sizes.values())
    terms = roofline_terms({"flops": counter.flops,
                            "bytes accessed": counter.bytes}, mem,
                           counter.coll, n_chips, counter.coll_axes, sizes)
    # no XLA here: the counter's totals are the raw counts too
    terms["xla_raw_flops"] = None
    terms["xla_raw_bytes"] = None
    terms["kernels"] = dict(counter.kernels)
    mf = model_flops(cfg, shape, estimator=estimator, q=q)
    # the lowered step is always two_point: utilization is computed
    # estimator-invariantly (both sides scale with forwards)
    mf_base = mf if estimator == "two_point" else model_flops(cfg, shape)
    mesh_name = ("x".join(str(s) for s in sizes.values())
                 if mesh_shape is not None else
                 ("pod2x16x16" if multi_pod else "16x16"))
    rec = {
        "arch": arch, "shape": shape.name, "variant": variant,
        "estimator": estimator, "q": q,
        "forward_backend": forward_backend,
        "step_counts": est_costs.step_counts(
            estimator, q=q, forward_backend=forward_backend),
        "mesh": mesh_name,
        "n_chips": int(n_chips),
        "compile_s": round(time.time() - t0, 1),
        "memory": mem,
        "roofline": terms,
        "cfg_overrides": {k: getattr(cfg, k) for k in ("max_seq",)
                          if getattr(cfg, k) != getattr(base_cfg, k)}
        | dict(overrides or {}),
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flop_ratio": (mf_base / n_chips) / terms["hlo_flops"]
        if terms["hlo_flops"] else None,
        "card": dict(H100, nvlink_bw=NVLINK_BW, ib_bw=IB_BW,
                     host_cards=HOST_CARDS),
        # the largest collectives: kind, axis and local result shape
        "detail": dict(sorted(counter.detail.items(),
                              key=lambda kv: -kv[1])[:30]),
    }
    if verbose:
        dom = max(("compute_s", "memory_s", "collective_s"),
                  key=lambda k: terms[k])
        useful = rec["useful_flop_ratio"]
        print(f"[{arch} x {shape.name} x {rec['mesh']} x {variant}] "
              f"lower={rec['compile_s']}s "
              f"compute={terms['compute_s']*1e3:.2f}ms "
              f"memory={terms['memory_s']*1e3:.2f}ms "
              f"coll={terms['collective_s']*1e3:.2f}ms "
              f"dom={dom} args={mem['argument_bytes']/2**30:.2f}GiB "
              f"temp={mem['temp_bytes']/2**30:.2f}GiB "
              f"useful={useful and round(useful, 3)} "
              f"(H100 SXM {H100['power_limit_w']} W roofline)")
    return rec


def _translate_legacy(argv):
    """Legacy flag spellings -> the CLI's: ``--variant`` here always
    meant the *lowering* variant (optimized|faithful|mezo)."""
    out = []
    for a in argv:
        if a == "--variant":
            out.append("--lowering")
        elif a.startswith("--variant="):
            out.append("--lowering=" + a.split("=", 1)[1])
        else:
            out.append(a)
    return out


def main(argv=None):
    """Shim over ``python -m repro_torch.launch dryrun`` (launch/cli.py)."""
    import sys

    from repro_torch.launch import cli
    argv = list(sys.argv[1:] if argv is None else argv)
    result = cli.main(["dryrun"] + _translate_legacy(argv))
    return 1 if result["failures"] else 0


if __name__ == "__main__":
    raise SystemExit(main())

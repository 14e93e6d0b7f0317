"""Stand-ins and sharded step functions for the dry run (counterpart of
``repro/launch/specs.py``).

No device memory is ever allocated here: parameters, batches and caches
are meta tensors (the seeded draws of ``lm.init_params`` become meta
allocations with no RNG run), placed on the mesh by
``distributed/sharding.py`` so that each rank's DTensor holds a meta
tensor of its shard's shape.  Each ``build_*_step`` returns a callable
that runs the cell's per-device program over such DTensors (or over
real ones: ``chip_smoke.py`` drives the same train step on the card),
with the mesh registered for the model's ``ctx.constrain`` calls.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch

from repro_torch.core import zo
from repro_torch.distributed import ctx, sharding
from repro_torch.models import frontends, lm
from repro_torch.models.config import ModelConfig

META = "meta"


def param_specs(cfg: ModelConfig):
    """The model's parameters as meta tensors (an ``LM``)."""
    return lm.init_params(cfg, None, META)


def cache_specs(cfg: ModelConfig, batch: int, max_seq: int):
    return lm.init_cache(cfg, batch, max_seq, device=META)


def input_specs(cfg: ModelConfig, shape) -> Dict[str, Any]:
    """Model inputs for one grid cell (see configs.shapes), as meta
    tensors with the reference's shapes and dtypes."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = getattr(torch, cfg.dtype)

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    if shape.kind == "train":
        batch = {"labels": meta((B, S), i32),
                 "loss_mask": meta((B, S), torch.float32)}
        if frontends.uses_embeds(cfg):
            batch["embeds"] = meta((B, S, cfg.d_model), dt)
        else:
            batch["tokens"] = meta((B, S), i32)
        return {"batch": batch}
    if shape.kind == "prefill":
        if frontends.uses_embeds(cfg):
            return {"embeds": meta((B, S, cfg.d_model), dt)}
        return {"tokens": meta((B, S), i32)}
    # decode: one new token against a seq_len cache
    out = {"caches": cache_specs(cfg, B, S), "pos": meta((), i32)}
    if frontends.uses_embeds(cfg):
        out["embeds"] = meta((B, 1, cfg.d_model), dt)
    else:
        out["token"] = meta((B, 1), i32)
    return out


def zo_variant(cfg: ModelConfig, variant: str) -> zo.ZOConfig:
    """faithful = the paper's MeZO-style LeZO (dense masked passes,
    separate restore+update, uniform policy); optimized = beyond-paper
    (static-gather active subset, fused restore+update)."""
    n_drop = int(0.75 * cfg.num_layers)
    if variant == "faithful":
        return zo.ZOConfig(n_drop=n_drop, policy="uniform", backend="dense",
                           fused_update=False)
    if variant == "optimized":
        return zo.ZOConfig(n_drop=n_drop, policy="stratified",
                           backend="gather", fused_update=True)
    if variant == "mezo":
        return zo.ZOConfig(n_drop=0, policy="uniform", backend="dense",
                           fused_update=False)
    raise ValueError(variant)


def _spmd(fn):
    """``fn`` with plain tensors it makes counted as replicated DTensors
    (the model's own aranges, accumulators and masks)."""
    from torch.distributed.tensor.experimental import implicit_replication

    @functools.wraps(fn)
    def run(*args, **kw):
        with implicit_replication():
            return fn(*args, **kw)
    return run


def build_train_step(cfg: ModelConfig, mesh, variant: str = "optimized",
                     zcfg: zo.ZOConfig = None):
    """The LeZO train step over placed leaves: ``(step, pshapes)`` with
    ``step(params, batch, step_idx, base_seed) -> (params, metrics)``,
    ``params`` placed by ``sharding.params_sharding`` and the batch by
    ``sharding.batch_sharding`` (parameters update in place, as the
    reference's donated buffers).  ``zcfg`` replaces the variant's
    config."""
    ctx.set_mesh(mesh)
    zcfg = zcfg or zo_variant(cfg, variant)
    pshapes = param_specs(cfg)
    spec = zo.build_spec(pshapes, lm.zo_group_fn)
    step = zo.make_zo_step(functools.partial(lm.lm_loss, cfg), spec, zcfg)
    return _spmd(step), pshapes


def placed_cache(cfg: ModelConfig, mesh, batch: int, max_seq: int,
                 device=META):
    """An empty cache tree (``lm.init_cache``) whose leaves are this
    rank's shards only, placed by ``sharding.cache_pspec``: no rank ever
    holds the full cache."""
    from torch.distributed.tensor import DTensor

    full = cache_specs(cfg, batch, max_seq)

    def leaf(path, t, fill):
        pl = sharding.placements(sharding.cache_pspec(path, t.shape, mesh),
                                 mesh)
        lshape, _ = sharding.local_window(t.shape, mesh, pl)
        local = torch.full(lshape, fill, dtype=t.dtype, device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    return {s: {b: {n: leaf(f"{s}/{b}/{n}", t,
                            float("-inf") if n == "m" else 0.0)
                    for n, t in leaves.items()}
                for b, leaves in blocks.items()}
            for s, blocks in full.items()}


def build_prefill_step(cfg: ModelConfig, mesh, max_seq: int):
    """``(prefill, pshapes)``: ``prefill(params, data)`` runs the prompt
    (tokens, or stub embeddings) into a fresh placed cache of ``max_seq``
    slots and returns (last logits, caches)."""
    ctx.set_mesh(mesh)
    pshapes = param_specs(cfg)

    def prefill(params, data):
        B = data.shape[0]
        caches = placed_cache(cfg, mesh, B, max_seq, data.device)
        with torch.no_grad():
            emb = data if frontends.uses_embeds(cfg) else None
            hidden, caches = lm.forward(
                cfg, params, None if emb is not None else data,
                mode="prefill", caches=caches, pos=0, embeds=emb)
            return lm.logits_fn(cfg, params, hidden[:, -1]), caches
    return _spmd(prefill), pshapes


def build_serve_step(cfg: ModelConfig, mesh, cache_len: int, batch: int):
    """``(serve, pshapes, cshapes)``: ``serve(params, caches, data, pos)``
    is one decode step (a token, or a stub embedding) at int ``pos``
    against placed caches, written in place (the reference donates
    them)."""
    ctx.set_mesh(mesh)
    pshapes = param_specs(cfg)
    cshapes = cache_specs(cfg, batch, cache_len)

    def serve(params, caches, data, pos: int):
        with torch.no_grad():
            emb = data if frontends.uses_embeds(cfg) else None
            hidden, caches = lm.forward(
                cfg, params, None if emb is not None else data,
                mode="decode", caches=caches, pos=pos, embeds=emb)
            return lm.logits_fn(cfg, params, hidden[:, -1]), caches
    return _spmd(serve), pshapes, cshapes

"""LeZO / MeZO optimizer core (counterpart of ``repro/core/zo.py``).

The optimizer sees parameters through a :class:`ZOSpec`, which labels
each leaf as *always-perturbed* (embeddings, final norm) or *stacked over
a layer group* (axis 0 = the layers of one homogeneous block group).
Leaf paths are ``named_parameters()`` names with ``.`` replaced by
``/`` (or, for a PEFT dict tree, its keys joined by ``/``), which are
the reference's tree paths (``zo._path_str``), so the z streams keyed
by them are the reference's.

Selection runs on the host: masks are (L_g,) CPU bool tensors and
active index vectors CPU int64 tensors, pure functions of the step seed.
The health scalars (``active_param_count``) are numpy float32 values
computed in the reference's op order; ``tree_z_norm`` is the exact
‖z(seed)‖ of one direction, drawn a row chunk at a time.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rng, selection
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace as obs

# elements of z drawn at once by tree_z_norm: the plain RNG's int64
# temporaries of one chunk stay near 1 GB on the card
Z_NORM_CHUNK = 1 << 24


def leaf_items(params):
    """(path, tensor) pairs in ``/`` notation: a module's parameters, or
    the leaves of a dict tree by sorted key as the reference's dicts
    flatten (the PEFT trees: ``stages/s0/b0/mix/wq/A``, ...)."""
    if isinstance(params, torch.nn.Module):
        return [(n.replace(".", "/"), p) for n, p in params.named_parameters()]
    out = []

    def walk(node, prefix):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], f"{prefix}{k}/")
            else:
                out.append((f"{prefix}{k}", node[k]))

    walk(params, "")
    return out


@dataclasses.dataclass(frozen=True)
class ZOSpec:
    """Maps parameter leaves to layer groups (see build_spec)."""
    paths: Tuple[str, ...]
    groups: Tuple[Optional[str], ...]
    slices: Dict[str, Tuple[int, int]]   # group -> (start, length) globally
    num_layers: int

    def split_mask(self, active: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {g: active[s:s + l] for g, (s, l) in self.slices.items()}

    def quotas(self, n_drop: int) -> Dict[str, int]:
        """Largest-remainder apportionment of n_drop over groups."""
        if self.num_layers == 0:
            if n_drop:
                raise ValueError("n_drop > 0 but the spec has no layer groups")
            return {}
        if not 0 <= n_drop < self.num_layers:
            raise ValueError(f"n_drop must be in [0, {self.num_layers})")
        exact = {g: n_drop * L / self.num_layers
                 for g, (_, L) in self.slices.items()}
        base = {g: min(int(e), self.slices[g][1]) for g, e in exact.items()}
        order = sorted(exact, key=lambda g: exact[g] - base[g], reverse=True)
        i = 0
        while sum(base.values()) < n_drop:
            g = order[i % len(order)]
            if base[g] < self.slices[g][1]:
                base[g] += 1
            i += 1
        return base


def build_spec(params, group_fn: Callable[[str], Optional[str]]) -> ZOSpec:
    """``group_fn(path)`` returns the layer-group name for a leaf stacked
    over layers on axis 0, or None for always-perturbed leaves."""
    paths, groups, sizes = [], [], {}
    for ps, leaf in leaf_items(params):
        g = group_fn(ps)
        paths.append(ps)
        groups.append(g)
        if g is not None:
            L = leaf.shape[0]
            if sizes.setdefault(g, L) != L:
                raise ValueError(
                    f"group {g!r}: inconsistent layer counts {sizes[g]} vs "
                    f"{L} at {ps}")
    slices, start = {}, 0
    for g in sorted(sizes):
        slices[g] = (start, sizes[g])
        start += sizes[g]
    return ZOSpec(tuple(paths), tuple(groups), slices, start)


# ----------------------------------------------------------- selection
def _group_rank_bits(seed: int, salt: str, g: str, L: int) -> torch.Tensor:
    """Seeded per-layer ranking bits for group ``g`` — the one hashing
    scheme shared by the uniform and weighted stratified policies."""
    return selection.rank_bits(rng.fold_py(seed, rng.leaf_uid(salt + g)), L)


def _mask_from_active(act: torch.Tensor, L: int) -> torch.Tensor:
    m = torch.zeros((L,), dtype=torch.bool)
    m[act] = True
    return m


def stratified_select(spec: ZOSpec, seed: int, n_drop: int):
    """Per-group masks + active index vectors (ascending).

    Returns (masks: {g: (L_g,) bool}, idxs: {g: (L_g - quota_g,) int64},
    n_active).
    """
    quotas = spec.quotas(n_drop)
    masks, idxs = {}, {}
    n_active = 0
    for g, (_, L) in spec.slices.items():
        order = torch.argsort(_group_rank_bits(seed, "sel/", g, L))
        act = torch.sort(order[quotas[g]:]).values
        masks[g], idxs[g] = _mask_from_active(act, L), act
        n_active += L - quotas[g]
    return masks, idxs, n_active


def stratified_select_weighted(spec: ZOSpec, seed: int, n_drop: int,
                               weights):
    """Importance-weighted LeZO selection with static per-group quotas.

    ``weights`` (num_layers,) >= 0, globally indexed like ZOSpec.slices.
    Gumbel top-k by log-weight within each group, in float32 as the
    reference computes it; the per-group active count is the static
    ``L_g - quota_g`` of :func:`stratified_select`.
    """
    quotas = spec.quotas(n_drop)
    w_all = torch.as_tensor(weights, dtype=torch.float32).cpu()
    masks, idxs = {}, {}
    n_active = 0
    for g, (start, L) in spec.slices.items():
        k = L - quotas[g]
        w = w_all[start:start + L]
        bits = _group_rank_bits(seed, "wsel/", g, L)
        u = torch.clamp((bits >> 8).to(torch.float32) / 16777216.0,
                        1e-7, 1.0 - 1e-7)
        gumbel = -torch.log(-torch.log(u))
        score = torch.log(torch.clamp(w, min=1e-9)) + gumbel
        order = torch.argsort(-score, stable=True)
        act = torch.sort(order[:k]).values
        masks[g], idxs[g] = _mask_from_active(act, L), act
        n_active += k
    return masks, idxs, n_active


def uniform_select(spec: ZOSpec, seed: int, n_drop: int):
    """Paper policy: global uniform drop (dynamic per-group counts)."""
    active = selection.uniform_active(seed, spec.num_layers, n_drop)
    return spec.split_mask(active), None, spec.num_layers - n_drop


def global_layer_mask(spec: ZOSpec, masks) -> torch.Tensor:
    """Per-group masks -> one (num_layers,) bool at the global indices."""
    gmask = torch.zeros((spec.num_layers,), dtype=torch.bool)
    for g, (start, L) in spec.slices.items():
        gmask[start:start + L] = masks[g]
    return gmask


def leaf_shapes(params) -> Tuple[Tuple[int, ...], ...]:
    """Leaf shapes in ``ZOSpec.paths`` order."""
    return tuple(tuple(p.shape) for _, p in leaf_items(params))


def active_param_count(spec: ZOSpec, shapes, masks) -> np.float32:
    """float32 count of parameters one direction's z touches: full sizes
    of always-perturbed leaves + mask-selected rows of stacked leaves,
    summed in the reference's leaf order (its dicts flatten by sorted
    key, so: by path components), which fixes the float32 rounding."""
    total = np.float32(0.0)
    order = sorted(range(len(shapes)), key=lambda i: spec.paths[i].split("/"))
    for shape, group in ((shapes[i], spec.groups[i]) for i in order):
        if group is None:
            total = total + np.float32(math.prod(shape))
        else:
            n_on = np.float32(int(masks[group].sum()))
            total = total + n_on * np.float32(math.prod(shape[1:]))
    return total


@torch.no_grad()
def tree_z_norm(spec: ZOSpec, shapes, seed: int, masks,
                device=None) -> float:
    """Exact ‖z(seed)‖ over the active subset — the RNG-stream norm
    identity: z is a pure function of (seed, leaf, layer, element), so
    the magnitude of the update ``-lr·g·z`` a recorded step applied is
    ``|lr·g| * tree_z_norm(...)`` without z ever existing beside the
    parameters.  Each leaf's stream is drawn as ``kernels/ops.zo_axpy_``
    draws it (``fold(seed, leaf_uid(path))``, one pseudo-layer for
    ungrouped leaves), one active row at a time in chunks of
    ``Z_NORM_CHUNK`` elements on ``device``; squares are summed in
    float64."""
    total = torch.zeros((), dtype=torch.float64, device=device)
    for shape, path, group in zip(shapes, spec.paths, spec.groups):
        leaf_seed = rng.fold_py(seed, rng.leaf_uid(path))
        if group is None:
            rows, n = [0], math.prod(shape)
        else:
            rows = torch.nonzero(masks[group].cpu()).flatten().tolist()
            n = math.prod(shape[1:])
        for r in rows:
            lseed = rng.fold_py(leaf_seed, r)
            for c0 in range(0, n, Z_NORM_CHUNK):
                z = rng.counter_normal(lseed, torch.arange(
                    c0, min(n, c0 + Z_NORM_CHUNK), device=device))
                total += z.square().sum(dtype=torch.float64)
    return math.sqrt(total.item())


# ----------------------------------------------------------------- axpy
@torch.no_grad()
def tree_axpy_(params, spec: ZOSpec, seed: int, scale, masks, idxs=None, *,
               decay=1.0, backend="dense"):
    """theta <- decay*theta + scale*z on active layers, in place."""
    obs.get_tracer().count(obs.CTR_AXPY)
    leaves = leaf_items(params)
    if tuple(p for p, _ in leaves) != spec.paths:
        raise ValueError("params changed since build_spec")
    for (path, leaf), group in zip(leaves, spec.groups):
        mask = None if group is None else masks[group]
        aidx = None if (group is None or idxs is None) else idxs[group]
        kops.zo_axpy_(leaf.data, path=path, seed=seed, scale=scale,
                      decay=decay, mask=mask, active_idx=aidx,
                      backend=backend)
    return params


def tree_axpy(params, spec: ZOSpec, seed: int, scale, masks, idxs=None, *,
              decay=1.0, backend="dense"):
    """The functional :func:`tree_axpy_`: a new tree holding decay*theta +
    scale*z on active layers (a copy elsewhere); ``params`` is left as
    it was."""
    return tree_axpy_(copy.deepcopy(params), spec, seed, scale, masks, idxs,
                      decay=decay, backend=backend)


@dataclasses.dataclass(frozen=True)
class ZOConfig:
    """The reference's legacy step config, field for field but for its
    Pallas ``interpret`` flag (the port's kernels have no interpret
    mode: a CPU tensor takes the plain version)."""
    eps: float = 1e-3
    lr: float = 1e-6
    n_drop: int = 0               # 0 => MeZO; >0 => LeZO
    policy: str = "stratified"    # stratified | uniform
    backend: str = "dense"        # dense | scan | gather | pallas
    fused_update: bool = True     # single restore+update pass
    weight_decay: float = 0.0
    forward_backend: str = "materialized"
    paired_probes: bool = True


def make_zo_step(loss_fn: Callable, spec: ZOSpec, cfg: ZOConfig,
                 lr_schedule: Optional[Callable] = None):
    """``step(params, batch, step_idx, base_seed) -> (params, metrics)``,
    the reference's legacy two-point step: a thin shim over
    ``estimators.make_step`` with ``estimators.from_zo(cfg)``, so every
    result bit is the estimator path's.  Parameters update in place, as
    on every path of the port; DTensor parameters (a mesh) too."""
    if cfg.backend == "gather" and cfg.policy != "stratified":
        raise ValueError("gather backend requires the stratified policy")
    from repro_torch import estimators   # estimators builds on zo

    estep, _ = estimators.make_step(loss_fn, spec, estimators.from_zo(cfg),
                                    lr_schedule)

    def step(params, batch, step_idx, base_seed):
        p, _state, metrics = estep(params, {}, batch, step_idx, base_seed)
        return p, metrics

    return step

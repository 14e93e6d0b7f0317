"""Mixture-of-Experts FFN with sort-based static-shape dispatch
(counterpart of ``repro/models/moe.py``).

Routing is DeepSeek/Granite-style: a float32 router, softmax over
experts, top-k, renormalized (``cfg.moe_renormalize``; Jamba takes the
softmax's own top-k weights).  Dispatch is per batch row: the row's
token-expert assignments are sorted by expert id (a stable sort, as
``jnp.argsort``), each expert takes a contiguous capacity-C slab of a
(B, E·C + 1, D) buffer whose last slot is the trash slot that dropped
assignments write to, the expert FFNs run as one batched SwiGLU
``einsum`` over (E, B·C) rows, and the outputs come back weighted.

The combine is deterministic on the card: every token owns exactly k
sorted assignments, so the port gathers each token's k weighted expert
outputs in the order of their sorted positions (the order the
reference's float32 scatter-add visits them) and adds them in that
order, where ``index_add_`` would add with atomics in no fixed order.
So is the gradient: every gather with a gradient reads its source at
distinct indices (a permutation, or a slot that only a dropped,
zero-weighted assignment shares), so autograd's scatter-add back puts
one term on each element, and a token's k dispatch rows are summed by
the backward of an ``expand``, in a fixed order.

Top-k comes from a stable descending sort: ``lax.top_k`` breaks ties
toward the lower expert index, which ``torch.topk`` does not promise.

Every op is plain PyTorch: the reference computes routing, dispatch and
the expert products outside any Pallas kernel.  On a mesh the block
runs per rank over its batch rows (the reference's ``ctx.constrain``
hints keep the dispatch row-local on the batch axes; the port makes that
explicit).  Where the rules shard the experts on d_ff (every width that
divides the ``model`` axis) it is the reference's tensor parallelism
(:func:`_moe_tp`): every rank of a ``model`` group computes the same
routing and dispatch on the same rows, the expert products run on its
local F slice of ``we_g``/``we_u``/``we_d`` (and of the shared experts'
``ws_*``), and one float32 all-reduce of the partial expert outputs
(one more for the shared experts') precedes the combine.  Where the
widths do not divide the axis the rules replicate the experts and the
block takes ``ctx.rowwise`` (:func:`_moe_rowwise`), which gathers
nothing then.

A layer may hold a share of the experts (``cfg.held_experts``: experts
``[first, first + count)`` of ``n_experts``), as one card of an
expert-parallel deployment does: the router, top-k and capacity stay
over all experts, and an assignment to an expert the layer does not
hold adds nothing.  The exchange that would bring the other experts'
part is not here; with every expert held the path is the one above.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import is_dtensor
from repro_torch.models import layers
from repro_torch.obs import trace as obs

F32 = torch.float32


def capacity(cfg, tokens: int) -> int:
    """Per-dispatch-group expert capacity: ``ceil(tokens·k·cf / E)``,
    rounded up to a multiple of 4 once ``tokens >= 4``, never above
    ``tokens`` (a token gives each expert at most one assignment), so a
    single-token decode row gets C = 1."""
    c = -(-int(tokens * cfg.top_k * cfg.capacity_factor) // cfg.n_experts)
    return max(1, min(tokens, -(-c // 4) * 4 if tokens >= 4 else c))


def moe_params(cfg, gen, L, device):
    """One MoE FFN block's leaves, stacked over ``L`` layers: the float32
    ``router`` (D, E), the held experts' ``we_g``/``we_u`` (Eh, D, F)
    and ``we_d`` (Eh, F, D) (Eh = E unless ``cfg.expert_shard`` holds a
    share), and the shared experts' ``ws_*`` (width
    ``n_shared_experts · F``) when configured."""
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    Eh = cfg.held_experts[1]
    dt = getattr(torch, cfg.dtype)
    rnd = layers.randn_scaled
    p = {
        "norm": {k: layers._stacked(v, L)
                 for k, v in layers.norm_params(cfg, D, device).items()},
        "router": rnd((L, D, E), D ** -0.5, gen, F32, device),
        "we_g": rnd((L, Eh, D, F), D ** -0.5, gen, dt, device),
        "we_u": rnd((L, Eh, D, F), D ** -0.5, gen, dt, device),
        "we_d": rnd((L, Eh, F, D), F ** -0.5, gen, dt, device),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * F
        p["ws_g"] = rnd((L, D, Fs), D ** -0.5, gen, dt, device)
        p["ws_u"] = rnd((L, D, Fs), D ** -0.5, gen, dt, device)
        p["ws_d"] = rnd((L, Fs, D), Fs ** -0.5, gen, dt, device)
    return p


def route(probs, k: int, renormalize: bool = True):
    """(top_w, top_e) of float32 ``probs`` (B, S, E): the k largest
    probabilities, ties toward the lower expert index, renormalized to
    sum to one unless ``renormalize`` is False."""
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    if not renormalize:
        return top_w, top_e
    return top_w / torch.sum(top_w, dim=-1, keepdim=True), top_e


def dispatch(top_e, n_experts: int, C: int):
    """Per-row sort-based dispatch of ``top_e`` (B, S, k): (order, e_s,
    keep, slot), each (B, S·k).  ``order`` sorts the row's assignments
    (token-major, rank-minor) by expert id, stably; ``e_s`` is the
    sorted expert ids; an assignment keeps its place when it is among
    the first C of its expert (``keep``), and ``slot`` is then
    ``e·C + its place``, else E·C (the trash slot)."""
    B, S, k = top_e.shape
    E = n_experts
    e_flat = top_e.reshape(B, S * k)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    e_s = torch.gather(e_flat, 1, order)
    counts = torch.zeros((B, E), dtype=e_s.dtype, device=e_s.device)
    counts.scatter_add_(1, e_s, torch.ones_like(e_s))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos = (torch.arange(S * k, device=e_s.device)[None]
           - torch.gather(starts, 1, e_s))
    keep = pos < C
    slot = torch.where(keep, e_s * C + pos, torch.full_like(e_s, E * C))
    return order, e_s, keep, slot


def _rows(t, idx):
    """``t`` (B, N, D) gathered along axis 1 at ``idx`` (B, M)."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def moe_fwd(cfg, p, x):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux float32 scalar); on
    a mesh per rank over its batch rows, tensor-parallel on d_ff
    (:func:`_moe_tp`) where the rules sharded the experts, else with the
    (replicated) experts whole (:func:`_moe_rowwise`)."""
    if not is_dtensor(x):
        return _moe_local(cfg, p, x)
    if ctx.tp_sharded(p):
        return _moe_tp(cfg, p, x)
    return _moe_rowwise(cfg, p, x)


def _mesh_aux(cfg, y, means):
    """The load-balance term over the global batch: the per-rank batch
    means ``me`` and ``ce`` averaged over the batch axes that shard
    ``y``'s rows (they hold equal row counts), as a replicated DTensor."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = y.device_mesh
    me, ce = means["me"], means["ce"]
    for i, pl in enumerate(y.placements):
        if pl == Shard(0) and mesh.size(i) > 1:
            me = fc.wait_tensor(fc.all_reduce(me, "avg", mesh.get_group(i)))
            ce = fc.wait_tensor(fc.all_reduce(ce, "avg", mesh.get_group(i)))
    aux = cfg.n_experts * torch.sum(me * ce)
    return DTensor.from_local(aux, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _moe_tp(cfg, p, x):
    """The block per rank (``ctx.tp_block``), the reference's layout:
    router, top-k, sort, capacity and dispatch row-local and the same on
    every rank of a ``model`` group; ``we_g``/``we_u`` on the local F
    slice, ``a = silu(g)·u`` in x's dtype, ``we_d`` over the local F
    giving partial ``o`` in float32, one all-reduce of it over
    ``model``, then the combine in its fixed order; the shared experts
    column- then row-parallel, one float32 all-reduce of their partial
    sum.  ``aux`` as :func:`_moe_rowwise` computes it."""
    means = {}

    def fn(xl, pl, _, tp):
        y, _aux = _moe_local(cfg, pl, xl, means=means, tp=tp)
        return y, None
    y, _ = ctx.tp_block("moe", fn, x, p)
    return y, _mesh_aux(cfg, y, means)


def _moe_rowwise(cfg, p, x):
    """The block per rank, dispatch row-local as the reference keeps it,
    the expert weights gathered whole (``ctx.rowwise``): the route where
    the experts' widths do not divide the ``model`` axis, so the rules
    replicated them and nothing is gathered.  ``aux``'s batch means are
    taken over the global batch (the per-rank terms averaged over the
    batch axes, which hold equal row counts)."""
    means = {}

    def fn(xl, pl, _):
        y, _aux = _moe_local(cfg, pl, xl, means=means)
        return y, None
    y, _ = ctx.rowwise("moe", fn, x, p)
    return y, _mesh_aux(cfg, y, means)


def _moe_local(cfg, p, x, means=None, tp=None):
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux float32 scalar);
    ``means`` (a dict) receives aux's two batch means, ``me`` and ``ce``.
    ``tp`` (``ctx.TP``; None off a mesh) is this rank's ``model`` group
    when the expert leaves are its d_ff slices: the partial expert
    outputs are summed over it before the combine.

    ``aux`` is the Switch-style load-balance term E · Σ_e mean-prob_e ·
    mean-assignment-share_e.  The expert products run in the model
    dtype, as the port's dense FFN does (the reference asks XLA for
    float32 results; the smoke configs are float32, where the two are
    the same computation); the combine and the shared experts' sum are
    float32.  A layer holding a share of the experts
    (``cfg.held_experts``) routes over all of them and computes its own
    experts' terms; the others' assignments go to the trash slot."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    first, Eh = cfg.held_experts
    C = capacity(cfg, S)
    tp = tp or ctx.LOCAL
    h = layers.apply_norm(cfg, p["norm"], x)

    with obs.prange(obs.MOE_ROUTE):
        logits = h.to(F32) @ p["router"]
        probs = torch.softmax(logits, dim=-1)
        top_w, top_e = route(probs, k, cfg.moe_renormalize)

        me = torch.mean(probs, dim=(0, 1))
        ce = torch.zeros((B, E), dtype=F32, device=x.device)
        ce.scatter_add_(1, top_e.reshape(B, -1),
                        torch.ones((B, S * k), dtype=F32, device=x.device))
        ce = ce / (S * k)
        aux = E * torch.sum(me * torch.mean(ce, dim=0))
        if means is not None:
            means.update(me=me, ce=torch.mean(ce, dim=0))

    # ---- per-row sort-based dispatch -----------------------------------
    with obs.prange(obs.MOE_DISPATCH):
        order, e_s, keep, slot = dispatch(top_e, E, C)
        if Eh != E:
            keep = keep & (e_s >= first) & (e_s < first + Eh)
            slot = torch.where(keep, slot - first * C,
                               torch.full_like(slot, Eh * C))
        w_s = torch.gather(top_w.reshape(B, S * k), 1, order)
        # each assignment's row of h, read from h repeated k times (flat
        # index t·k + r) at the sort permutation: the gradient goes back
        # through a permutation and a sum over k in a fixed order, where
        # reading h at the token index would scatter-add k rows a token
        hk = h[:, :, None].expand(B, S, k, D).reshape(B, S * k, D)
        buf = torch.zeros((B, Eh * C + 1, D), dtype=x.dtype, device=x.device)
        buf.scatter_(1, slot[..., None].expand(-1, -1, D), _rows(hk, order))
        eb = buf[:, :-1].reshape(B, Eh, C, D)

    # ---- expert FFN (batched SwiGLU over the experts) ------------------
    with obs.prange(obs.MOE_EXPERTS):
        g = torch.einsum("becd,edf->becf", eb, p["we_g"])
        u = torch.einsum("becd,edf->becf", eb, p["we_u"])
        a = (torch.nn.functional.silu(g.to(F32)) * u.to(F32)).to(x.dtype)
        o = tp.sum(torch.einsum("becf,efd->becd", a, p["we_d"]).to(F32))
        o = o.reshape(B, Eh * C, D)

    # ---- combine: each token's k terms in sorted order -----------------
    with obs.prange(obs.MOE_COMBINE):
        contrib = (_rows(o, torch.clamp(slot, 0, Eh * C - 1))
                   * torch.where(keep, w_s, torch.zeros_like(w_s))[..., None])
        inv = torch.empty_like(order)
        inv.scatter_(1, order, torch.arange(S * k, device=x.device).expand(
            B, -1))                               # flat -> sorted position
        mine = torch.sort(inv.reshape(B, S, k), dim=-1).values
        terms = _rows(contrib, mine.reshape(B, S * k)).reshape(B, S, k, D)
        y = torch.zeros((B, S, D), dtype=F32, device=x.device)
        for r in range(k):
            y = y + terms[:, :, r]

    if cfg.n_shared_experts:
        with obs.prange(obs.MOE_EXPERTS):
            sg = torch.nn.functional.silu((h @ p["ws_g"]).to(F32))
            su = (h @ p["ws_u"]).to(F32)
            y = y + tp.sum(((sg * su).to(x.dtype) @ p["ws_d"]).to(F32))
    return y.to(x.dtype), aux

"""Decoder-only LM: parameters, forward, loss, and the serving entry
points (counterpart of ``repro/models/lm.py``).

Parameters live in an ``nn.Module`` tree shaped like the reference's
dict tree::

    embed.tok (V, D) [, embed.pos (max_seq, D)]   # learned positions
    final_norm.{scale[, bias]}
    [head.w (D, V)]                              # absent when tied
    stages.s{i}.b{j}.mix.{norm.*, wq, wk, wv, wo[, q_norm.scale,
                          k_norm.scale]}                       # attn
    stages.s{i}.b{j}.mix.{norm.*, wq, wdkv, kv_norm.scale, wuk, wuv,
                          wo}                                  # mla
    stages.s{i}.b{j}.ffn.{norm.*, wg, wu | wi, wd}               # dense
    stages.s{i}.b{j}.mix.{norm.*, in_proj, conv_w, conv_b, x_proj, dt_w,
                          dt_b, A_log, Dskip, out_proj[, dt_norm.scale,
                          b_norm.scale, c_norm.scale]}         # mamba
    stages.s{i}.b{j}.mix.{norm.*, in_proj, conv_w, conv_b, wq, wk, wv,
                          wif, b_i, b_f, out_norm.scale,
                          out_proj}                            # mlstm
    stages.s{i}.b{j}.mix.{norm.*, wx, rh, b, out_norm.scale,
                          out_proj}                            # slstm
    stages.s{i}.b{j}.ffn.{norm.*, router, we_g, we_u, we_d[, ws_g, ws_u,
                          ws_d]}                               # moe

with every leaf under ``stages`` stacked over its stage's ``repeat`` on
axis 0, so ``named_parameters()`` with ``.`` read as ``/`` gives the
reference's leaf paths, the keys of the z streams.  The forward walks the
layers in a Python loop (the reference's ``lax.scan``), slicing each
stacked leaf without a copy.

Serving (DESIGN.md §12): ``prefill``/``serve_step`` run the lockstep
path over a cache ``init_cache`` makes, (R, B, Smax, KV, dh) per
``s{i}/b{j}`` leaf of an attn block and the latent (R, B, Smax,
kv_lora) and (R, B, Smax, dr) of an MLA block, and the fixed-size
states of the recurrent blocks (Mamba, mLSTM, sLSTM), whatever
``Smax``; ``paged_step`` runs one
bucketed call of the continuous-batching engine over the arena
``init_paged_cache`` makes, (R, n_pages, page_size, KV, dh) per leaf
(attn mixers only, MoE FFNs included).  Both layouts are the
reference's, and both are written in place.

The loss is a chunked cross-entropy over sequence chunks, so the
(B, S, V) logits never exist at once.  Under a paired ctx it runs once
per probe, literally the unpaired program, so paired and unpaired
losses agree bit for bit.

ZO training runs no autograd (``lm_loss`` under no-grad).  First-order
training (``core/fo.py``) calls ``lm_loss(..., grad=True)`` after
:func:`grad_leaves` has split every stacked leaf into per-layer views
that require grad: a layer's gradient is then a tensor of its own, where
the slice of a stacked leaf would make each layer's backward allocate
and add a gradient the size of the whole stack.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.core import zo
from repro_torch.distributed import ctx
from repro_torch.distributed.ctx import is_dtensor
from repro_torch.fused import ref as fused_ref
from repro_torch.models import frontends, layers, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as obs

F32 = torch.float32
CE_CHUNK = 512


class ParamNode(nn.Module):
    """A node of the parameter tree; ``node["wq"]`` reads a child like
    the reference's dicts do.  Leaves are ``requires_grad=False`` unless
    :func:`grad_leaves` made them trainable for first-order training."""

    _split = None     # leaf name -> per-layer views (``grad_leaves``)

    def __init__(self, tree: Dict):
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, ParamNode(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)

    def items(self):
        return [*self._parameters.items(), *self._modules.items()]

    def layer(self, l: int) -> Dict:
        """One layer's slice of every stacked leaf below (views)."""
        split = self._split or {}
        out = {k: split[k][l] if k in split else p[l]
               for k, p in self._parameters.items()}
        out.update({k: m.layer(l) for k, m in self._modules.items()})
        return out


class LM(ParamNode):
    """The model's parameters; ``cfg`` rides along."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__(tree)
        self.cfg = cfg


MIXER_PARAMS = {"attn": layers.attn_params, "mla": layers.mla_params,
                "mamba": ssm.mamba_params, "mlstm": ssm.mlstm_params,
                "slstm": ssm.slstm_params}
FFNS = ("dense", "moe", "none")


def shallow_copy(params: LM) -> LM:
    """A new parameter tree over the same leaf tensors: re-placing its
    leaves (``sharding.params_sharding``) leaves ``params`` as it was."""
    def tree(node):
        return {k: tree(v) if isinstance(v, ParamNode) else v.data
                for k, v in node.items()}
    return LM(params.cfg, tree(params))


def _check_supported(cfg: ModelConfig):
    """The port runs every block of the reference's zoo: ``attn``/``mla``
    and the recurrent ``mamba``/``mlstm``/``slstm`` mixers with
    ``dense``/``moe`` FFNs or none."""
    for st in cfg.stages:
        for b in st.pattern:
            if b.kind not in MIXER_PARAMS or b.ffn not in FFNS:
                raise ValueError(f"unknown block {b.kind}+{b.ffn}")


def _block_params(cfg: ModelConfig, b, gen, L, device):
    """One (stage, pattern position)'s leaves by its kinds, stacked over
    the stage's ``L`` repeats (the reference's ``_block_params``): the
    mixer drawn first, then the FFN; no ``ffn`` for ``"none"``."""
    out = {"mix": MIXER_PARAMS[b.kind](cfg, gen, L, device)}
    if b.ffn == "dense":
        out["ffn"] = layers.ffn_params(cfg, gen, L, device, d_ff=b.d_ff)
    elif b.ffn == "moe":
        out["ffn"] = moe.moe_params(cfg, gen, L, device)
    return out


# ------------------------------------------------------------------ init
def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> LM:
    """Random parameters with the reference's shapes, dtypes and stds,
    drawn from ``gen`` (a generator on ``device``)."""
    _check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    D = cfg.d_model
    embed = {"tok": layers.randn_scaled((cfg.vocab, D), 0.02, gen, dt,
                                        device)}
    if cfg.pos_emb == "learned":
        embed["pos"] = layers.randn_scaled((cfg.max_seq, D), 0.02, gen, dt,
                                           device)
    tree = {
        "embed": embed,
        "final_norm": layers.norm_params(cfg, D, device),
        "stages": {
            f"s{si}": {
                f"b{bj}": _block_params(cfg, b, gen, st.repeat, device)
                for bj, b in enumerate(st.pattern)}
            for si, st in enumerate(cfg.stages)},
    }
    if not cfg.tie_embeddings:
        tree["head"] = {"w": layers.randn_scaled((D, cfg.vocab), D ** -0.5,
                                                 gen, dt, device)}
    return LM(cfg, tree)


# the recurrent mixers' float32 leaves (``conv_b`` takes cfg.dtype)
F32_MIX_LEAVES = ("A_log", "Dskip", "dt_b", "b", "b_i", "b_f", "rh")


def _leaf_dtype(cfg: ModelConfig, path: str) -> torch.dtype:
    """Norm leaves (``kv_norm`` and ``out_norm`` too), the MoE router
    and the recurrent mixers' decays, skips, gate biases and sLSTM's
    ``rh`` are float32 in the reference; the rest take cfg.dtype."""
    parent, _, name = path.rpartition("/")
    if ("norm/" in path or name == "router"
            or (parent.endswith("/mix") and name in F32_MIX_LEAVES)):
        return F32
    return getattr(torch, cfg.dtype)


def tensor_from_numpy(arr) -> torch.Tensor:
    """A numpy array (the reference's ``np.asarray`` of a jax array) as a
    CPU tensor of its dtype; bfloat16 arrays are taken bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def params_from_numpy(cfg: ModelConfig, flat: Dict[str, np.ndarray],
                      device) -> LM:
    """``{path: ndarray}`` (the reference's checkpoint keys,
    ``zo._path_str`` paths) -> the port's parameters.  Arrays are cast
    to the reference's leaf dtype; bfloat16 arrays are taken bit for
    bit."""
    _check_supported(cfg)
    tree: Dict = {}
    for path, arr in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = tensor_from_numpy(arr).to(
            device=device, dtype=_leaf_dtype(cfg, path))
    return LM(cfg, tree)


def params_to_numpy(params) -> Dict[str, np.ndarray]:
    """The port's parameters (an ``LM`` or a PEFT dict tree) ->
    ``{path: ndarray}`` (bfloat16 leaves come back as float32, which
    holds them exactly)."""
    out = {}
    for path, p in zo.leaf_items(params):
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(F32)
        out[path] = t.numpy()
    return out


class Overlay:
    """``base`` (an ``LM`` or one of its nodes) read with the leaves of
    ``leaves`` ({path from the root: tensor}) in place of, or beside, its
    own: what PEFT hands the forward (merged LoRA stacks, prefix keys)
    without copying a base leaf.  Reads like the tree it wraps:
    ``params["stages"]["s0"]["b0"].layer(l)``."""

    def __init__(self, base, leaves: Dict[str, torch.Tensor], prefix=""):
        self._base, self._leaves, self._prefix = base, leaves, prefix

    def __getitem__(self, key):
        path = self._prefix + key
        if path in self._leaves:
            return self._leaves[path]
        child = self._base[key]
        if any(p.startswith(path + "/") for p in self._leaves):
            return Overlay(child, self._leaves, path + "/")
        return child

    def layer(self, l: int) -> Dict:
        out = self._base.layer(l)
        for path, t in self._leaves.items():
            if path.startswith(self._prefix):
                *parents, leaf = path[len(self._prefix):].split("/")
                node = out
                for k in parents:
                    node = node.setdefault(k, {})
                node[leaf] = t[l]
        return out


def grad_leaves(params: LM):
    """Make the parameters trainable by autograd: ``[(path, layer,
    tensor)]`` in ``named_parameters`` order, where each stacked leaf
    (under ``stages/``) is split into per-layer views of its storage
    (``layer`` its index; the forward reads them) and every other leaf
    is itself (``layer`` None).  All require grad; an in-place update of
    a view updates the stacked parameter."""
    out = []
    for prefix, node in params.named_modules():
        for k, p in node._parameters.items():
            path = f"{prefix}.{k}".lstrip(".").replace(".", "/")
            if path.startswith("stages/"):
                views = [p.detach()[l].requires_grad_()
                         for l in range(p.shape[0])]
                node._split = {**(node._split or {}), k: views}
                out.extend((path, l, v) for l, v in enumerate(views))
            else:
                out.append((path, None, p.requires_grad_()))
    return out


def zo_group_fn(path: str) -> Optional[str]:
    """Leaf path -> LeZO layer group (stacked axis 0) or None (always on)."""
    if path.startswith("stages/"):
        parts = path.split("/")
        return f"{parts[1]}.{parts[2]}"          # e.g. "s0.b3"
    return None


def count_params(params) -> int:
    return sum(t.numel() for _, t in zo.leaf_items(params))


def count_active_params(cfg: ModelConfig, params) -> int:
    """Parameters a token's matmuls read, for MODEL_FLOPS =
    6·N_active·tokens: the routed experts' ``we_*`` stacks count at
    their ``top_k / n_experts`` share (integer division of the leaf's
    size, as the reference's), the embedding lookups not at all."""
    total = 0
    for path, t in zo.leaf_items(params):
        n = t.numel()
        if any(w in path for w in ("we_g", "we_u", "we_d")):
            n = n * cfg.top_k // cfg.n_experts
        if "embed/tok" in path or "embed/pos" in path:
            n = 0
        total += n
    return total


# --------------------------------------------------------------- forward
def _recurrent(cfg, b, p, x, mode="train", cache=None, pos=0, pages=None):
    """A recurrent mixer's output; in prefill and decode its new state
    is copied into ``cache`` (this layer's views) in place.  On a mesh
    the block runs per rank over its batch rows: Mamba on its d_inner
    channels where the rules sharded them (``ctx.tp_block``, the
    reference's layout, caches as placed); mLSTM and sLSTM, whose block
    weights the rules replicate, and a Mamba block whose d_inner does
    not divide the ``model`` axis on whole weights (``ctx.rowwise``)."""
    if mode == "paged":
        raise NotImplementedError(
            f"paged serving covers attn mixers only; got {b.kind!r} (use "
            "the lockstep serve path)")
    fwd = {"mamba": ssm.mamba_fwd, "mlstm": ssm.mlstm_fwd,
           "slstm": ssm.slstm_fwd}[b.kind]
    if not is_dtensor(x):
        out, new = fwd(cfg, p, x, mode=mode, cache=cache, pos=pos)
    elif b.kind == "mamba" and ctx.tp_sharded(p, cache):
        out, new = ctx.tp_block("mamba", lambda xl, pl, cl, tp: fwd(
            cfg, pl, xl, mode=mode, cache=cl, pos=pos, tp=tp), x, p, cache)
    else:
        out, new = ctx.rowwise(b.kind, lambda xl, pl, cl: fwd(
            cfg, pl, xl, mode=mode, cache=cl, pos=pos), x, p, cache)
    if new is not None:
        for name, t in new.items():
            cache[name].copy_(t)
    return out


def _run_block(cfg, b, p, x, pc=None, **mix_kw):
    """One block by its kinds: (x, aux), ``aux`` the MoE FFN's
    load-balance term or None for a dense FFN or none."""
    if pc is not None and (b.kind != "attn" or b.ffn == "moe"):
        raise NotImplementedError(
            f"virtual perturbation covers attn + dense blocks; got "
            f"{b.kind}+{b.ffn} (use forward_backend='materialized')")
    if b.kind == "attn":
        with obs.prange(obs.MODEL_ATTN):
            x = x + layers.attn_fwd(
                cfg, p["mix"], x, pc=None if pc is None else pc.child("mix"),
                **mix_kw)
    elif b.kind == "mla":
        mix_kw.pop("pages", None)
        with obs.prange(obs.MODEL_ATTN):
            x = x + layers.mla_fwd(cfg, p["mix"], x, **mix_kw)
    else:
        with obs.prange(obs.MODEL_RECURRENT):
            x = x + _recurrent(cfg, b, p["mix"], x, **mix_kw)
    if b.ffn == "moe":
        y, aux = moe.moe_fwd(cfg, p["ffn"], x)
        return x + y, aux
    if b.ffn == "none":
        return x, None
    with obs.prange(obs.MODEL_FFN):
        return x + layers.ffn_fwd(
            cfg, p["ffn"], x, pc=None if pc is None else pc.child("ffn")), None


def forward(cfg: ModelConfig, params: LM, tokens, perturb=None, *,
            mode="train", caches=None, pos=0, pages=None, embeds=None):
    """tokens (B, S), or ``embeds`` (B, S, D) for stub frontends (cast
    to ``cfg.dtype``) -> hidden (B, S, D) in train mode; (hidden,
    caches) in a serving mode.  :func:`forward_aux` also returns the
    summed MoE load-balance term.

    ``perturb`` (fused.PerturbCtx, train mode only) runs the forward
    against the virtually perturbed weights theta + s*eps*z; a paired ctx
    folds its P probes into the batch, p-major, and returns (P·B, S, D).
    Stub embeddings are tiled p-major over the probes too (the
    reference's paired forward does not tile them and fails there).

    mode: ``prefill`` (fill ``caches``, an ``init_cache`` tree, from
    position 0) | ``decode`` (S == 1 at position ``pos``, an int) |
    ``paged`` (``caches`` is the ``init_paged_cache`` arena, ``pages``
    the (B, max_pages) page table and ``pos`` a (B,) tensor of per-lane
    start positions, each lane at its own positions).  The caches are
    written in place and returned, per stage and block."""
    hidden, caches, _ = forward_aux(cfg, params, tokens, perturb,
                                    mode=mode, caches=caches, pos=pos,
                                    pages=pages, embeds=embeds)
    return hidden if mode == "train" else (hidden, caches)


def _embed(cfg, params, tokens, perturb, mode, pos, embeds):
    """The first hidden state (B, S, D), or (P·B, S, D) p-major under a
    paired ctx: token rows (or stub embeddings) plus learned positions."""
    P = 0 if (perturb is None or perturb.pair is None) else perturb.pair.n
    tok = params["embed"]["tok"]
    if embeds is not None:
        x = embeds.to(getattr(torch, cfg.dtype))
        if P:
            x = x.repeat(P, 1, 1)                    # (P·B, S, D), p-major
    elif perturb is None:
        x = tok[tokens]
    else:
        tseed = fused_ref.layer_seed(perturb.seed, "embed/tok")
        if P:
            x = fused_ref.pembed_stack(tok, tokens, tseed, perturb.scale)
            x = x.reshape(-1, *x.shape[2:])
        else:
            x = fused_ref.pembed(tok, tokens, tseed, perturb.scale)
    S = x.shape[1]
    if cfg.pos_emb == "learned":
        pos_w = params["embed"]["pos"]
        if mode == "paged":
            x = x + pos_w[pos[:, None]
                          + torch.arange(S, device=x.device)[None]]
        elif perturb is None:
            x = x + pos_w[pos:pos + S]
        else:
            pseed = fused_ref.layer_seed(perturb.seed, "embed/pos")
            if P:
                rows = fused_ref.ppos_stack(pos_w, 0, S, pseed, perturb.scale)
                x = (x.reshape(P, -1, *x.shape[1:]) + rows[:, None]
                     ).reshape(x.shape)
            else:
                x = x + fused_ref.ppos(pos_w, 0, S, pseed, perturb.scale)
    return x


def forward_aux(cfg: ModelConfig, params: LM, tokens, perturb=None, *,
                mode="train", caches=None, pos=0, pages=None, embeds=None):
    """:func:`forward`'s computation -> (hidden, caches, aux): ``aux``
    the float32 sum of the MoE blocks' load-balance terms in layer
    order (the reference's ``aux_total``), None without MoE blocks."""
    if mode != "train" and perturb is not None:
        raise NotImplementedError(f"mode={mode!r} takes no perturbation")
    with obs.prange(obs.MODEL_EMBED):
        x = _embed(cfg, params, tokens, perturb, mode, pos, embeds)
    aux_total = None
    for si, st in enumerate(cfg.stages):
        sp = params["stages"][f"s{si}"]
        pmasks = (None if perturb is None else
                  [perturb.group_mask(f"s{si}.b{bj}", st.repeat)
                   for bj in range(len(st.pattern))])
        for l in range(st.repeat):
            for bj, b in enumerate(st.pattern):
                bp = sp[f"b{bj}"].layer(l)
                if mode == "train":
                    pc = (None if perturb is None else perturb.block(
                        f"stages/s{si}/b{bj}", l, pmasks[bj][l]))
                    x, aux = _run_block(cfg, b, bp, x, pc)
                else:
                    bc = caches[f"s{si}"][f"b{bj}"]
                    x, aux = _run_block(
                        cfg, b, bp, x, mode=mode, pos=pos,
                        cache={name: t[l] for name, t in bc.items()},
                        pages=pages)
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
    if mode != "train":
        return (layers.apply_norm(cfg, params["final_norm"], x), caches,
                aux_total)
    if perturb is None:
        return (layers.apply_norm(cfg, params["final_norm"], x), None,
                aux_total)
    return (perturb.leaf("final_norm").apply_norm(cfg, params["final_norm"],
                                                  x), None, aux_total)


def _head_matrix(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"]["tok"].T      # tied head: a view, no copy
    return params["head"]["w"]


def logits_fn(cfg, params, hidden):
    return (hidden @ _head_matrix(cfg, params)).to(F32)


def chunked_ce(cfg, params, hidden, labels, loss_mask, perturb=None):
    """Mean CE over masked positions without materializing (B,S,V)
    logits.  Under a paired ctx each probe's CE runs the unpaired
    program on its slice, so the (P,) loss vector equals P separate
    forwards bit for bit."""
    P = 0 if (perturb is None or perturb.pair is None) else perturb.pair.n
    if P:
        B0 = hidden.shape[0] // P
        return torch.stack([
            chunked_ce(cfg, params, hidden[pi * B0:(pi + 1) * B0], labels,
                       loss_mask, perturb=perturb.probe(pi))
            for pi in range(P)])
    with obs.prange(obs.MODEL_HEAD_CE):
        return _ce(cfg, params, hidden, labels, loss_mask, perturb)


def _ce(cfg, params, hidden, labels, loss_mask, perturb):
    """:func:`chunked_ce` of one probe (or none)."""
    B, S, D = hidden.shape
    chunk = min(CE_CHUNK, S)
    if S % chunk:
        raise ValueError(f"seq len {S} is not a multiple of {chunk}")
    W = _head_matrix(cfg, params)
    if perturb is not None:
        # tied head reads embed/tok through a transpose: trans counters
        # with the stored row length keep z identical to the axpy's; the
        # untied head/w (D, V) is read as stored (ld = V)
        if cfg.tie_embeddings:
            head, head_kw = perturb.leaf("embed/tok"), {"trans": True,
                                                        "ld": cfg.d_model}
        else:
            head, head_kw = perturb.leaf("head/w"), {}
    tot = torch.zeros((), dtype=F32, device=hidden.device)
    cnt = torch.zeros((), dtype=F32, device=hidden.device)
    labels = labels.to(torch.int64)
    for c0 in range(0, S, chunk):
        h = hidden[:, c0:c0 + chunk]
        y = labels[:, c0:c0 + chunk]
        m = loss_mask[:, c0:c0 + chunk].to(F32)
        if perturb is None:
            lg = ctx.matmul(h, W).to(F32)                 # (B, chunk, V)
        else:
            lg = head.matmul(h, W, **head_kw).to(F32)
        if vocab_sharded(lg):
            lse, gold = _vocab_parallel_terms(lg, y)
        else:
            lse = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, y[..., None])[..., 0]
        tot = tot + torch.sum((lse - gold) * m)
        cnt = cnt + torch.sum(m)
    return tot / torch.clamp(cnt, min=1.0)


def vocab_sharded(lg) -> bool:
    """True for DTensor logits whose vocab (last) dim is sharded."""
    from torch.distributed.tensor import Shard
    return is_dtensor(lg) and Shard(lg.ndim - 1) in lg.placements


def _vocab_parallel_terms(lg, y):
    """(logsumexp, gold logit) over the last dim of vocab-sharded DTensor
    logits ``lg`` (B, C, V), the Megatron way: each rank reduces its
    vocab slice, and the max, the sum of exponentials and the gold
    logit (non-zero on the rank that holds the label) are all-reduced
    over the mesh dims that shard the vocab.  Other placements of ``lg``
    (the batch) carry over; ``y`` (B, C) follows ``lg``'s batch
    placement."""
    import torch.distributed._functional_collectives as fc
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed.sharding import (contiguous_stride,
                                                  local_window)

    mesh, last = lg.device_mesh, lg.ndim - 1
    vdims = [i for i, p in enumerate(lg.placements) if p == Shard(last)]
    out_pl = [Replicate() if i in vdims else p
              for i, p in enumerate(lg.placements)]
    if is_dtensor(y):
        y = y.redistribute(mesh, out_pl).to_local()
    else:
        y = DTensor.from_local(y, mesh, [Replicate()] * mesh.ndim,
                               run_check=False).redistribute(
            mesh, out_pl).to_local()
    lshape, off = local_window(lg.shape, mesh, lg.placements)
    loc = lg.to_local()
    groups = [mesh.get_group(i) for i in vdims]
    mx = loc.amax(-1)
    for g in groups:
        mx = fc.wait_tensor(fc.all_reduce(mx, "max", g))
    se = torch.exp(loc - mx[..., None]).sum(-1)
    v0 = off[last]
    mine = (y >= v0) & (y < v0 + lshape[last])
    gold = torch.where(mine, torch.gather(
        loc, -1, torch.clamp(y - v0, 0, lshape[last] - 1)[..., None]
    )[..., 0], torch.zeros((), dtype=loc.dtype, device=loc.device))
    for g in groups:
        se = fc.wait_tensor(fc.all_reduce(se, "sum", g))
        gold = fc.wait_tensor(fc.all_reduce(gold, "sum", g))
    shape = tuple(lg.shape[:-1])
    wrap = lambda t: DTensor.from_local(t, mesh, out_pl, run_check=False,
                                        shape=shape,
                                        stride=contiguous_stride(shape))
    return wrap(mx + torch.log(se)), wrap(gold)


def lm_loss(cfg: ModelConfig, params: LM, batch, aux_coef=0.0,
            perturb=None, *, grad: bool = False):
    """batch: {tokens (B,S), labels (B,S), loss_mask (B,S)} tensors, or
    {embeds (B,S,D), labels, loss_mask} for stub-frontend archs.
    ``perturb``: evaluate loss(theta + s*eps*z) virtually; a paired ctx
    returns the (P,) loss vector ``[l_plus, l_minus]``.  A model with
    MoE blocks adds ``aux_coef`` times their load-balance term (0 by
    default, as the reference's).  ``grad=True`` records the graph for
    a backward (first-order training); otherwise the loss runs under
    no-grad."""
    with torch.set_grad_enabled(grad):
        hidden, _, aux = forward_aux(cfg, params, batch.get("tokens"),
                                     perturb=perturb,
                                     embeds=batch.get("embeds"))
        loss = chunked_ce(cfg, params, hidden, batch["labels"],
                          batch["loss_mask"], perturb=perturb)
        return loss if aux is None else loss + aux_coef * aux


def lm_loss_pair(cfg: ModelConfig, params: LM, batch, aux_coef=0.0,
                 perturb=None):
    """The paired-probe entry point: ``perturb`` must be a stacked ctx
    (``fused.make_pair_ctx`` / ``make_stack_ctx``); returns the (P,)
    per-probe loss vector of one fused forward."""
    if perturb is None or perturb.pair is None:
        raise ValueError("lm_loss_pair requires a stacked PerturbCtx "
                         "(fused.make_pair_ctx / make_stack_ctx)")
    return lm_loss(cfg, params, batch, aux_coef=aux_coef, perturb=perturb)


# ---------------------------------------------------------------- serving
def _cache_tree(cfg: ModelConfig, leaves_of, dtype, device):
    """Per stage-block, the leaves ``leaves_of(block, R)`` gives: {leaf:
    shape} (zeros in ``dtype``, default ``cfg.dtype``) or {leaf: (shape,
    torch dtype, fill)}."""
    dt = getattr(torch, dtype or cfg.dtype)
    dev = resolve_device(device)

    def make(spec):
        shape, ldt, fill = spec if isinstance(spec[0], tuple) else (
            spec, dt, 0.0)
        return torch.full(shape, fill, dtype=ldt, device=dev)
    return {f"s{si}": {
        f"b{bj}": {name: make(spec)
                   for name, spec in leaves_of(b, st.repeat).items()}
        for bj, b in enumerate(st.pattern)}
        for si, st in enumerate(cfg.stages)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None):
    """An empty lockstep cache for ``forward(mode='prefill'|'decode')``,
    per stage-block, on ``device`` (None: the card): {"k", "v"} zeros of
    (R, batch, max_seq, KV, dh) for an attn mixer, {"ckv": (R, batch,
    max_seq, kv_lora), "kr": (R, batch, max_seq, dr)} for MLA; the
    recurrent blocks' fixed-size states as the reference lays them out:
    Mamba {"conv" (R, batch, K-1, Di), "ssm" (R, batch, Di, St) f32},
    mLSTM {"conv" (R, batch, 3, Di), "C" (R, batch, H, dh, dh), "n" (R,
    batch, H, dh), "m" (R, batch, H)} and sLSTM {"c", "n", "h", "m"}
    (R, batch, H, dh), their float32 states zeros but the stabilizers
    ``m`` at -inf; the conv tails take ``dtype``."""
    _check_supported(cfg)
    KV, dh, H = cfg.n_kv_heads, cfg.head_dim, cfg.n_heads
    ninf = float("-inf")

    def leaves(b, R):
        if b.kind == "mla":
            return {"ckv": (R, batch, max_seq, cfg.kv_lora),
                    "kr": (R, batch, max_seq, cfg.rope_head_dim)}
        if b.kind == "mamba":
            Di = cfg.mamba_d_inner
            return {"conv": (R, batch, cfg.mamba_conv - 1, Di),
                    "ssm": ((R, batch, Di, cfg.mamba_d_state), F32, 0.0)}
        if b.kind == "mlstm":
            Di = cfg.lstm_d_inner
            d = Di // H
            return {"conv": (R, batch, 3, Di),
                    "C": ((R, batch, H, d, d), F32, 0.0),
                    "n": ((R, batch, H, d), F32, 0.0),
                    "m": ((R, batch, H), F32, ninf)}
        if b.kind == "slstm":
            s = (R, batch, H, cfg.d_model // H)
            return {"c": (s, F32, 0.0), "n": (s, F32, 0.0),
                    "h": (s, F32, 0.0), "m": (s, F32, ninf)}
        return {"k": (R, batch, max_seq, KV, dh),
                "v": (R, batch, max_seq, KV, dh)}
    return _cache_tree(cfg, leaves, dtype, device)


def serve_step(cfg: ModelConfig, params, caches, token, pos: int):
    """One decode step.  token: (B, 1); pos: the cache's current length
    (an int).  Returns (logits (B, V) f32, caches), the caches advanced
    in place."""
    with torch.no_grad():
        hidden, caches = forward(cfg, params, token, mode="decode",
                                 caches=caches, pos=pos)
        return logits_fn(cfg, params, hidden[:, -1]), caches


def prefill(cfg: ModelConfig, params, tokens, max_seq: int):
    """Run the prompt (B, S) through the model on its device, returning
    (logits of the last position (B, V) f32, caches of ``max_seq``
    slots)."""
    with torch.no_grad():
        caches = init_cache(cfg, tokens.shape[0], max_seq,
                            device=tokens.device)
        hidden, caches = forward(cfg, params, tokens, mode="prefill",
                                 caches=caches, pos=0)
        return logits_fn(cfg, params, hidden[:, -1]), caches


def supports_paged(cfg: ModelConfig) -> bool:
    """True when every mixer is attn and the model reads tokens — the
    block family the paged serving engine covers (DESIGN.md §12), MoE
    FFNs included; MLA's latent cache is served by the lockstep path."""
    return (not frontends.uses_embeds(cfg)
            and all(b.kind == "attn" for s in cfg.stages for b in s.pattern))


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=None, device=None):
    """The serving engine's KV arena: zeros of (R, n_pages, page_size,
    KV, dh) per stage-block leaf, shared by every request via per-lane
    page tables, on ``device`` (None: the card).  Page 0 is the trash
    page: inactive lanes write there and table padding points there,
    and the zeros keep what masked attention reads from it finite."""
    _check_supported(cfg)
    KV, dh = cfg.n_kv_heads, cfg.head_dim

    def shapes(b, R):
        if b.kind != "attn":
            raise NotImplementedError(
                f"paged serving covers attn mixers only; {cfg.name} has "
                f"{b.kind!r} (use the lockstep serve path)")
        return {"k": (R, n_pages, page_size, KV, dh),
                "v": (R, n_pages, page_size, KV, dh)}
    return _cache_tree(cfg, shapes, dtype, device)


def paged_step(cfg: ModelConfig, params, arena, tokens, pages, pos, sel):
    """One bucketed serving call — a prefill chunk or a batched decode
    step are the same computation at different (B, C) buckets
    (DESIGN.md §12).

    tokens: (B, C) — C == 1 for a decode step, C == prefill_chunk for a
    prefill call; pages: (B, max_pages) int64 page-table rows (entry 0 =
    trash page); pos: (B,) int64 absolute position of ``tokens[:, 0]``;
    sel: (B,) int64 chunk index whose logits each lane returns (the last
    valid prompt token for a final prefill chunk, 0 for decode).  Returns
    (logits (B, V) f32, arena), the arena written in place.
    """
    with torch.no_grad():
        hidden, arena = forward(cfg, params, tokens, mode="paged",
                                caches=arena, pos=pos, pages=pages)
        h_sel = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                       sel]
        return logits_fn(cfg, params, h_sel), arena

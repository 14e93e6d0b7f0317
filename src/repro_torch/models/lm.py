"""Decoder-only LM: parameters, train-mode forward and loss
(counterpart of ``repro/models/lm.py``; serving waits for a later slice).

Parameters live in an ``nn.Module`` tree shaped like the reference's
dict tree::

    embed.tok (V, D), embed.pos (max_seq, D), final_norm.{scale,bias},
    stages.s{i}.b{j}.mix.{norm.scale, norm.bias, wq, wk, wv, wo},
    stages.s{i}.b{j}.ffn.{norm.scale, norm.bias, wi, wd}

with every leaf under ``stages`` stacked over its stage's ``repeat`` on
axis 0, so ``named_parameters()`` with ``.`` read as ``/`` gives the
reference's leaf paths, the keys of the z streams.  The forward walks the
layers in a Python loop (the reference's ``lax.scan``), slicing each
stacked leaf without a copy.

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

from repro_torch.core import zo
from repro_torch.fused import ref as fused_ref
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

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


def _check_supported(cfg: ModelConfig):
    for st in cfg.stages:
        for b in st.pattern:
            if b.kind != "attn" or b.ffn != "dense":
                raise NotImplementedError(
                    f"{b.kind}+{b.ffn} blocks are not yet ported")
    if cfg.pos_emb != "learned" or cfg.act != "relu" or not cfg.tie_embeddings:
        raise NotImplementedError(
            "this slice ports the OPT stack (learned positions, relu, tied "
            "head) only")


# ------------------------------------------------------------------ init
def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> LM:
    """Random parameters with the reference's shapes, dtypes and stds,
    drawn from ``gen`` (a generator on ``device``)."""
    _check_supported(cfg)
    dt = getattr(torch, cfg.dtype)
    D = cfg.d_model
    tree = {
        "embed": {
            "tok": layers.randn_scaled((cfg.vocab, D), 0.02, gen, dt,
                                       device),
            "pos": layers.randn_scaled((cfg.max_seq, D), 0.02, gen, dt,
                                       device),
        },
        "final_norm": layers.norm_params(cfg, D, device),
        "stages": {
            f"s{si}": {
                f"b{bj}": {"mix": layers.attn_params(cfg, gen, st.repeat,
                                                     device),
                           "ffn": layers.ffn_params(cfg, gen, st.repeat,
                                                    device)}
                for bj, _ in enumerate(st.pattern)}
            for si, st in enumerate(cfg.stages)},
    }
    return LM(cfg, tree)


def _leaf_dtype(cfg: ModelConfig, path: str) -> torch.dtype:
    """Norm leaves are float32 in the reference; the rest take cfg.dtype."""
    return F32 if "norm/" in path else getattr(torch, cfg.dtype)


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


# --------------------------------------------------------------- forward
def _run_block(cfg, p, x, pc=None):
    x = x + layers.attn_fwd(cfg, p["mix"], x,
                            pc=None if pc is None else pc.child("mix"))
    return x + layers.ffn_fwd(cfg, p["ffn"], x,
                              pc=None if pc is None else pc.child("ffn"))


def forward(cfg: ModelConfig, params: LM, tokens, perturb=None):
    """tokens (B, S) -> hidden (B, S, D), train mode.

    ``perturb`` (fused.PerturbCtx) runs the forward against the virtually
    perturbed weights theta + s*eps*z; a paired ctx folds its P probes
    into the batch, p-major, and returns (P·B, S, D)."""
    P = 0 if (perturb is None or perturb.pair is None) else perturb.pair.n
    tok, pos_w = params["embed"]["tok"], params["embed"]["pos"]
    S = tokens.shape[1]
    if perturb is None:
        x = tok[tokens] + pos_w[:S]
    else:
        tseed = fused_ref.layer_seed(perturb.seed, "embed/tok")
        pseed = fused_ref.layer_seed(perturb.seed, "embed/pos")
        if P:
            x = fused_ref.pembed_stack(tok, tokens, tseed, perturb.scale)
            rows = fused_ref.ppos_stack(pos_w, 0, S, pseed, perturb.scale)
            x = (x + rows[:, None]).reshape(-1, *x.shape[2:])
        else:
            x = (fused_ref.pembed(tok, tokens, tseed, perturb.scale)
                 + fused_ref.ppos(pos_w, 0, S, pseed, perturb.scale))
    for si, st in enumerate(cfg.stages):
        sp = params["stages"][f"s{si}"]
        pmasks = (None if perturb is None else
                  [perturb.group_mask(f"s{si}.b{bj}", st.repeat)
                   for bj in range(len(st.pattern))])
        for l in range(st.repeat):
            for bj in range(len(st.pattern)):
                pc = (None if perturb is None else perturb.block(
                    f"stages/s{si}/b{bj}", l, pmasks[bj][l]))
                x = _run_block(cfg, sp[f"b{bj}"].layer(l), x, pc)
    if perturb is None:
        return layers.apply_norm(cfg, params["final_norm"], x)
    return perturb.leaf("final_norm").apply_norm(cfg, params["final_norm"],
                                                 x)


def _head_matrix(params):
    return params["embed"]["tok"].T          # tied head: a view, no copy


def logits_fn(cfg, params, hidden):
    return (hidden @ _head_matrix(params)).to(F32)


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
    B, S, D = hidden.shape
    chunk = min(CE_CHUNK, S)
    if S % chunk:
        raise ValueError(f"seq len {S} is not a multiple of {chunk}")
    W = _head_matrix(params)
    if perturb is not None:
        # tied head reads embed/tok through a transpose: trans counters
        # with the stored row length keep z identical to the axpy's
        head = perturb.leaf("embed/tok")
    tot = torch.zeros((), dtype=F32, device=hidden.device)
    cnt = torch.zeros((), dtype=F32, device=hidden.device)
    labels = labels.to(torch.int64)
    for c0 in range(0, S, chunk):
        h = hidden[:, c0:c0 + chunk]
        y = labels[:, c0:c0 + chunk]
        m = loss_mask[:, c0:c0 + chunk].to(F32)
        if perturb is None:
            lg = (h @ W).to(F32)                          # (B, chunk, V)
        else:
            lg = head.matmul(h, W, trans=True, ld=cfg.d_model).to(F32)
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, y[..., None])[..., 0]
        tot = tot + torch.sum((lse - gold) * m)
        cnt = cnt + torch.sum(m)
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(cfg: ModelConfig, params: LM, batch, perturb=None, *,
            grad: bool = False):
    """batch: {tokens (B,S), labels (B,S), loss_mask (B,S)} tensors.
    ``perturb``: evaluate loss(theta + s*eps*z) virtually; a paired ctx
    returns the (P,) loss vector ``[l_plus, l_minus]``.  ``grad=True``
    records the graph for a backward (first-order training); otherwise
    the loss runs under no-grad."""
    with torch.set_grad_enabled(grad):
        hidden = forward(cfg, params, batch["tokens"], perturb=perturb)
        return chunked_ce(cfg, params, hidden, batch["labels"],
                          batch["loss_mask"], perturb=perturb)

"""PerturbCtx lens: thread a virtual perturbation through the forward
(counterpart of ``repro/fused/view.py``).

A :class:`PerturbCtx` is one perturbation — seed, scale and LeZO masks —
handed to ``models.lm.lm_loss(..., perturb=ctx)``.  The model asks it
for a :class:`LayerPerturb` per (block, layer) as it walks the stacked
parameters; the handle knows the leaf-path prefix, the layer index and
the layer's active predicate, which is all it needs to draw the axpy
sweeps' z streams (``fused/ref.py``).

Seeds, scales and predicates are host values (ints, floats, bools): the
port's forward is a Python loop over layers, so nothing is traced.

``impl="pallas"`` sends weight matmuls to kernels K3/K4
(``fused/matmul.py``); ``impl="ref"`` to the plain versions.  Vector
leaves (norm scale/bias) and the embeddings always take the plain path:
they are activation-sized.

Paired probes (:class:`ProbePair`): a ctx may carry P probes riding ONE
forward whose activations fold the probe axis into the batch, p-major
((P·B, S, D)): the ±εz pair, or P independent probes of one_sided.
Every weight matmul then runs as one stacked K3 call (one launch for
P <= 2, reading each W tile once for both probes; groups of two beyond).

With a tracer enabled, each matmul counts the W tiles and z tiles of
the launches the kernels make for it (``matmul.tile_counts``), whichever
``impl`` computes it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.fused import matmul as pk
from repro_torch.fused import ref as fref
from repro_torch.obs import trace as obs


@dataclasses.dataclass(frozen=True)
class ProbePair:
    """P stacked probes ride one forward (batch axis P·B, p-major)."""
    n: int


@dataclasses.dataclass(frozen=True)
class PerturbCtx:
    """theta + scale * z(seed) on active layers.

    Unpaired: ``seed`` int, ``scale`` float, ``masks`` group -> (L_g,)
    bool.  Paired: ``seed``/``scale`` are length-P tuples and ``masks``
    group -> (P, L_g); ``lm_loss`` then returns a (P,) loss vector."""
    seed: Any
    scale: Any
    masks: Optional[Dict[str, torch.Tensor]]
    impl: str = "pallas"
    pair: Optional[ProbePair] = None

    def group_mask(self, group: str, L: int):
        """Per-layer predicates: a list of L bools (unpaired) or of L
        P-tuples of bools (paired)."""
        P = None if self.pair is None else self.pair.n
        if self.masks is None or group not in self.masks:
            return [True if P is None else (True,) * P] * L
        m = self.masks[group].tolist()
        return m if P is None else [tuple(c) for c in zip(*m)]

    def probe(self, i: int) -> "PerturbCtx":
        """Probe ``i`` of a paired ctx as a plain unpaired ctx — the
        computations that must stay literally the single-probe program
        (the chunked cross-entropy)."""
        if self.pair is None:
            raise ValueError("probe() requires a paired ctx")
        masks = (None if self.masks is None
                 else {g: m[i] for g, m in self.masks.items()})
        return dataclasses.replace(self, seed=self.seed[i],
                                   scale=self.scale[i], masks=masks,
                                   pair=None)

    def leaf(self, path: str) -> "LayerPerturb":
        """Handle for an always-perturbed unstacked leaf."""
        on = True if self.pair is None else (True,) * self.pair.n
        return LayerPerturb(self, path, 0, on)

    def block(self, prefix: str, layer: int, active) -> "LayerPerturb":
        """Handle for layer ``layer`` of the stacked block at ``prefix``."""
        return LayerPerturb(self, prefix, layer, active)


@dataclasses.dataclass(frozen=True)
class LayerPerturb:
    ctx: PerturbCtx
    prefix: str          # leaf-path prefix
    layer: int           # index into the stacked axis 0
    active: Any          # LeZO predicate: bool, or a P-tuple when paired

    def child(self, name: str) -> "LayerPerturb":
        return dataclasses.replace(self, prefix=self._p(name))

    def _p(self, name: str) -> str:
        if self.prefix and name:
            return f"{self.prefix}/{name}"
        return self.prefix or name

    def _seed(self, name: str):
        return fref.layer_seed(self.ctx.seed, self._p(name), self.layer)

    @property
    def nprobes(self) -> int:
        """Probe count P (0 = unpaired)."""
        return 0 if self.ctx.pair is None else self.ctx.pair.n

    # ----------------------------------------------------------- matmuls
    def matmul(self, x, w, name: str = "", *, trans: bool = False,
               ld: Optional[int] = None):
        """``x @ (w + scale*z)`` for the leaf at ``prefix/name``; paired,
        the probe axis rides x's leading batch dim."""
        seed = self._seed(name)
        ref = self.ctx.impl == "ref"
        tr = obs.get_tracer()
        if tr.enabled and not obs.tracing():
            M = x.numel() // x.shape[-1] // max(1, self.nprobes)
            act = (self.active,) if self.ctx.pair is None else self.active
            seeds = (seed,) if self.ctx.pair is None else seed
            wl, zt = pk.tile_counts(M, w.shape[0], w.shape[1], seeds, act)
            tr.count(obs.CTR_WLOAD, wl)
            tr.count(obs.CTR_ZREGEN, zt)
        if self.ctx.pair is None:
            fn = fref.pmatmul if ref else pk.pmatmul
            return fn(x, w, seed, self.ctx.scale, self.active, trans=trans,
                      ld=ld)
        xs = x.reshape(self.nprobes, -1, x.shape[-1])
        fn = fref.pmatmul_stack if ref else pk.pmatmul_stack
        out = fn(xs, w, seed, self.ctx.scale, self.active, trans=trans, ld=ld)
        return out.reshape(*x.shape[:-1], w.shape[1])

    # ------------------------------------------------------ vector leaves
    def vec(self, w, name: str = ""):
        """Perturbed vector leaf; paired -> (P, *w.shape)."""
        seed = self._seed(name)
        if self.ctx.pair is None:
            return fref.pvec(w, seed, self.ctx.scale, self.active)
        return fref.pvec_stack(w, seed, self.ctx.scale, self.active)

    def apply_norm(self, cfg, p: Dict[str, Any], x, name: str = ""):
        """``layers.apply_norm`` against the perturbed norm leaves.
        Paired: each probe normalizes its slice of the p-major batch
        against its own perturbed (D,) vectors."""
        from repro_torch.models import layers  # local: avoid import cycle
        sub = self.child(name) if name else self
        if self.ctx.pair is None:
            return layers.apply_norm(
                cfg, {k: sub.vec(v, k) for k, v in p.items()}, x)
        shp = x.shape
        xs = x.reshape(self.nprobes, -1, shp[-1])
        bc = lambda v: v[:, None, :]                  # (P, D) -> (P, 1, D)
        if cfg.norm == "rms":
            y = layers.rms_norm(xs, bc(sub.vec(p["scale"], "scale")))
        else:
            y = layers.layer_norm(xs, bc(sub.vec(p["scale"], "scale")),
                                  bc(sub.vec(p["bias"], "bias")))
        return y.reshape(shp)

"""The plain reference's ZO steps and precision, shared by every family.

A family module (``reference/<family>.py``) gives its leaves and its
loss; this module drives the paper's two-point step over them:

    theta+ = theta + eps z,  theta- = theta - eps z      (probes)
    g      = (l(theta+) - l(theta-)) / (2 eps)            (float32)
    theta  <- theta - lr g z                              (update)

on the layers that LeZO's selection keeps (every layer under MeZO) and
the leaves that are always perturbed.  Parameters are stored in the
configuration's dtypes (bfloat16 weights, float32 norms and router), so
every write is rounded to its leaf's dtype as the configuration's
storage does.  The probes are MeZO's in-place ones (the ``materialized``
forward backend): theta + eps z written, then theta + eps z - 2 eps z
written and probed, then the restore and the update written as one
sweep, ``+ (eps - lr g) z``.  The losses are float32 throughout, with
TF32 off.

The control (``prec="fp8"``) is the same computation one precision
below the configuration's bfloat16: every bfloat16 leaf stored, and
every matrix product's operands taken, as float8 e4m3 with a power-of-
two scale a row (leaves) or a tensor (activations).

Nothing here imports the program: z and the selection come from the
benchmark's frozen copy (``portbench/zrng.py``), the weights and batches
from its generators.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import feed, weights, zrng

F32 = torch.float32
FP8_MAX = 448.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _pow2_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.ceil(torch.log2(torch.clamp(
        amax, min=1e-30) / FP8_MAX)))


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) on the float8 e4m3 grid under one power-of-two
    scale, as float32."""
    s = _pow2_scale(x.abs().amax())
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class Prec:
    """Where the computation rounds: ``f32`` (the reference) or ``fp8``
    (the control)."""

    def __init__(self, name: str):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def mm(self, a, b):
        """A matrix product in this precision (float32 accumulation)."""
        if self.name == "fp8":
            a, b = fp8(a), fp8(b)
        return torch.matmul(a, b)

    def store(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """A float32 row written to a leaf of ``dtype``."""
        if self.name == "fp8" and dtype == torch.bfloat16:
            return fp8(x).to(dtype)
        return x.to(dtype)


def _scalar(v, device):
    return torch.tensor(np.float32(v), dtype=F32, device=device)


def _axpy(theta, scale, z, prec, dtype):
    """theta + scale*z: the product rounded, then the sum, then the
    store."""
    return prec.store(theta.to(F32) + scale * z, dtype)


class Steps:
    """The reference's run of ``steps`` ZO steps of one cell from the
    seed: per step (l+, l-, g) and, after the last, the norm of each
    (leaf, layer) row's change."""

    def __init__(self, family, cfg, traffic, seed, device, prec="f32"):
        self.family, self.cfg, self.traffic = family, cfg, traffic
        self.seed, self.device = seed, device
        self.prec = Prec(prec)
        self.leaves = family.leaves(cfg)
        self.sizes = zrng.groups(self.leaves)
        self.n_drop = int(traffic["sparsity"] * sum(self.sizes.values()))
        self.base = zrng.fold(seed, 0xC0FFEE)
        self.eps, self.lr = traffic["eps"], traffic["lr"]
        if traffic["forward_backend"] != "materialized":
            raise ValueError(f"no reference for the forward backend "
                             f"{traffic['forward_backend']!r}")
        self.store = {}
        for path, shape, dt in self.leaves:
            t = weights.make_leaf(seed, path, shape, weights.dtype_of(dt),
                                  device)
            if prec != "f32":
                for r in range(weights.rows(path, shape)):
                    row = t[r] if zrng.group_of(path) else t
                    row.copy_(self.prec.store(row.to(F32), row.dtype))
            self.store[path] = t
        self.dtypes = {p: weights.dtype_of(dt) for p, _, dt in self.leaves}

    def _row(self, path, layer):
        t = self.store[path]
        return t[layer] if zrng.group_of(path) else t

    def _z(self, seed, path, layer):
        row = self._row(path, layer)
        return zrng.layer_z(seed, path, layer, row.numel(),
                            self.device).view(row.shape)

    def _active(self, act, path, layer):
        g = zrng.group_of(path)
        return g is None or layer in act[g]

    def step(self, t: int, follow=None):
        """One step; returns (l_plus, l_minus, g).  The update takes the
        projected gradient worked out, as ``g`` is, from the losses
        ``follow`` = (l_plus, l_minus) when given (the program's of this
        step), else the reference's own ``g``."""
        seed = zrng.step_seed(self.base, t)
        act = zrng.select(self.sizes, seed, self.n_drop)
        batch = feed.batch(self.seed, t, self.traffic, self.cfg["vocab_size"],
                           self.device)
        eps = _scalar(self.eps, self.device)
        two_eps = _scalar(-2.0 * self.eps, self.device)
        memo = {}

        def getw(path, layer):
            """The (2, ...) float32 weights of the two probes of a row."""
            key = (path, layer)
            if key in memo:
                return memo[key]
            theta, dt = self._row(path, layer), self.dtypes[path]
            if not self._active(act, path, layer):
                w = theta.to(F32)
                out = torch.stack([w, w])
            else:
                z = self._z(seed, path, layer)
                plus = _axpy(theta, eps, z, self.prec, dt)
                minus = _axpy(plus, two_eps, z, self.prec, dt)
                theta.copy_(minus)
                out = torch.stack([plus.to(F32), minus.to(F32)])
            if not zrng.group_of(path):
                memo[key] = out
            return out

        with torch.no_grad():
            losses = self.family.loss(self.cfg, getw, batch, 2, self.prec)
        lp, lm = (np.float32(l.item()) for l in losses)
        g = (lp - lm) / np.float32(2.0 * self.eps)
        if follow is not None:
            fp, fm = (np.float32(v) for v in follow)
            g_update = (fp - fm) / np.float32(2.0 * self.eps)
        else:
            g_update = g
        scale = np.float32(self.eps) - np.float32(self.lr) * g_update
        s = _scalar(scale, self.device)
        for path, shape, _ in self.leaves:
            for layer in range(weights.rows(path, shape)):
                if self._active(act, path, layer):
                    row = self._row(path, layer)
                    row.copy_(_axpy(row, s, self._z(seed, path, layer),
                                    self.prec, self.dtypes[path]))
        return lp, lm, g

    def changes(self):
        """{"path:layer": (norm, projection) of theta_now - theta_0}
        over every row (``weights.change``)."""
        out = {}
        for path, shape, dt in self.leaves:
            for layer in range(weights.rows(path, shape)):
                t0 = weights.make_row(self.seed, path, shape,
                                      weights.dtype_of(dt), layer,
                                      self.device)
                out[f"{path}:{layer}"] = weights.change(
                    self._row(path, layer), t0, self.seed, path, layer)
        return out


def run(family, cfg, traffic, seed, steps, device, prec="f32", follow=None):
    """``steps`` reference steps from the seed: {"l_plus", "l_minus",
    "g": [per step], "change": {row: (norm, projection)}}.  ``follow``
    ({"l_plus", "l_minus": [per step]}: the program's losses) is what
    each step's update works its projected gradient out from in place
    of the reference's own losses: the program's float32 loss
    difference is the bf16 forward's rounding times 1 / (2 eps), which
    no float32 forward repeats, so the reference follows it, works out
    the gradient and the update from it itself, and holds the
    program's change to that update, its later probes at the weights
    the program probes."""
    no_tf32()
    s = Steps(family, cfg, traffic, seed, device, prec)
    out = {"l_plus": [], "l_minus": [], "g": []}
    for t in range(steps):
        lp, lm, g = s.step(t, None if follow is None else (
            follow["l_plus"][t], follow["l_minus"][t]))
        out["l_plus"].append(float(lp))
        out["l_minus"].append(float(lm))
        out["g"].append(float(g))
    out["change"] = s.changes()
    return out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean CE over the masked positions (float32)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


def causal_softmax_attend(prec, q, k, v):
    """softmax(q k^T / sqrt(dq)) v under a causal mask, per head:
    q, k (B, S, H, dq), v (B, S, H, dv) float32 -> (B, S, H, dv)."""
    S = q.shape[1]
    s = prec.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * (
        q.shape[-1] ** -0.5)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, torch.tensor(-math.inf, device=q.device))
    p = torch.softmax(s, dim=-1)
    return prec.mm(p, v.transpose(1, 2)).transpose(1, 2)


def rope_half(x, theta):
    """Rotary embedding on the last dim of x (B, S, n, d), its two
    halves rotated as pairs, at positions 0 .. S-1."""
    d, S = x.shape[-1], x.shape[1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=F32,
                                          device=x.device) / d))
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * scale


def layer_norm(x, scale, bias, eps):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.mean((x - mu) ** 2, -1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias

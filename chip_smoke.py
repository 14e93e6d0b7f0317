#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--phases build,rng,parity,train,check,...]

Phases (all by default; ``check`` and ``profile`` need ``train``), each
of which fails the run (non-zero exit) when it fails:

1. build   — compile every CUDA kernel of the main path from
             ``src/repro_torch/csrc`` with ``nvcc`` (one process per
             source, all at once); count from the SASS the instructions
             one K1 element issues (``repro_torch.kernels.sass``) and the
             tensor-core instructions of K2.
2. rng     — the kernels' float part of z against the plain versions'
             expressions on all 2^24 inputs each (``csrc/rng_check.cu``):
             any mismatch fails the run.
3. parity  — call each kernel's wrapper at the main path's shapes and
             hold it against its plain PyTorch version on the same inputs;
             time kernel, plain version and, where one exists, the
             PyTorch library call computing the same function (the timed
             launches queue behind a sleep on the stream, so the card and
             not the host sets the pace).  K3
             is also timed with no active probe at (D, d_ff) and active at
             (D, D), the shape of 4 of a layer's 6 launches; K2 also at
             prefix tuning's shape (Sk = 68, k_offset = -5; SDPA with the
             mask beside), at the task scorers' batch (64) and at a long
             sequence (S = 1024), off the main path; K1 also at the LoRA
             leaves' shapes.
4. train   — the main path: preset ``lezo-opt13b`` at full width and
             depth (OPT-13B, 40 layers, bf16, random weights from a seeded
             ``torch.Generator``) with ``runtime.backend=pallas`` and
             ``runtime.forward_backend=virtual``, 4 steps through
             ``repro_torch.api.run``.  Kernel launch counts are zeroed
             just before and read just after; every K3/K4 launch must
             load by TMA.
5. check   — on the trained weights, the virtual pair's losses against
             the materialized probes (kernel K1 perturbing in place), the
             virtual l- against a materialized theta - eps z made from
             the unperturbed weights (gated at 1e-4 relative, and shown
             failing for a planted theta - 1.25 eps z), and a one-step
             run of a small bf16
             OPT on the card against the same step on the CPU (plain
             versions).  Also read, not gated: the same gaps with K2's
             plain version in the model, on these weights and on weights
             trained with it.
6. profile — one more main-path step under ``torch.profiler``: device
             time by kernel, each port kernel's device time per launch,
             and the device's idle share of the step.
7. estimators — the other ZO estimators on OPT-13B at full width and
             depth (the weights of ``train``, or built once from a seed),
             through ``api.run(spec, params=...)``: ``fzoo-opt13b-q16``
             (one_sided, q = 16 probes stacked in one forward, K3 at
             P = 16), ``averaged`` at q = 2 and ``importance`` over
             two_point, with the main path's overrides.  Step seconds,
             peak memory and launches by kernel; the launches must equal
             what ``costs.step_counts`` and K3's probe grouping imply.
8. momentum — ``zo_momentum`` on the same weights, materialized, K1
             sweeps (probe, restore and the K history sweeps), 3 steps.
9. tasks   — the task registry on fresh seeded weights: the main path on
             ``sst2`` (4 steps, one evaluation of 64 examples), then
             zero-shot ``api.evaluate`` on ``copa`` and ``squad_copy``;
             launches against ``costs.step_counts`` plus the evaluation
             forwards; each scorer with K2 against K2's plain version
             (within 8 bf16 steps), SDPA in K2's place beside it; the
             same read, not gated, on the weights earlier phases trained.
10. peft   — ZO over a LoRA tree (``lezo-opt13b-lora``) and a prefix tree
             (``runtime.peft=prefix``) on the weights of ``tasks``,
             materialized,
             3 steps each: step seconds, peak memory, K1/K2 launches.
11. fo     — K2's backward against autograd through its plain version at
             the main shape; then first-order training with float32
             master weights: ``fo-opt13b`` with SGD at 20 and the
             preset's AdamW at 10 of 40 layers (what 80 GB holds), peak
             memory and state sizes.
12. resume — on the ``bench`` variant in bf16: 4 uninterrupted steps
             against 2 steps, a checkpoint and a resumed run of 2 more;
             the parameters must match bit for bit.

For a quick kernel check: ``--phases build,rng,parity``.

Prints one JSON line of kernels, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when CUDA is unavailable or the port's sources are missing.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12      # dense tensor-core peak (H100 SXM data sheet)
H100_BYTES = 3.35e12          # HBM3 bandwidth
H100_SMS = 132
INSNS_PER_SM_CLOCK = 4 * 32   # 4 schedulers, one warp instruction a clock
# Operations one z needs, counted once from the z contract in
# src/repro_torch/csrc/rng.cuh: a floor that does not move with the build.
# Left out: int->float conversions, the log's exponent split, the cosine's
# quadrant selection, and loop, address and memory work.
RNG_OPS = (2           # the two counter inputs, a multiply-add each
           + 2 * 8     # two mix32: three shift-xors and two multiplies
           + 12        # log: 9 polynomial FMAs, f + f*f*p, + i*ln2
           + 1         # -2 log u
           + 5         # sqrt: rsqrt and its Newton step
           + 8         # cos: 3 reduction FMAs, 3 polynomial, 2 to assemble
           + 1)        # r * c
# A bf16 K1 element at decay 1: z, x + scale*z, an unpack and half a pack.
K1_OPS = RNG_OPS + 2 + 1.5
CLOCK_HZ = None               # the card's maximum SM clock, set by main()

MAIN_OVERRIDES = {
    "model.variant": "full", "runtime.backend": "pallas",
    "runtime.forward_backend": "virtual", "run.steps": 4,
    "run.log_every": 1, "run.eval_every": 0,
}


def log(msg):
    print(msg, flush=True)


def smi(query, *fmt):
    """One card's ``nvidia-smi --query-gpu`` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader") + fmt)],
        capture_output=True, text=True, check=True).stdout.strip(
        ).splitlines()[0]


def time_ms(fn, reps=5, warmup=1):
    """Mean milliseconds of ``fn()`` on the card (CUDA events).  The
    stream first sleeps long enough for the host to enqueue every rep of a
    kernel, so host overhead per call does not set the pace."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(CLOCK_HZ * 2e-4 * (reps + 1)))  # 0.2 ms a call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def issue_ms(instructions):
    """Least time (ms) the SMs take to issue ``instructions`` thread
    instructions, at the card's maximum SM clock (at 1980 MHz this is the
    float32 peak of 67 TFLOP/s, an FMA a lane a clock)."""
    return instructions / (H100_SMS * INSNS_PER_SM_CLOCK * CLOCK_HZ) * 1e3


def bound(nbytes, tensor_flops=0.0, instructions=0.0):
    """Least time (ms) for the work and what bounds it: bytes at the HBM
    rate, or operations (tensor-core flops at the bf16 peak, or thread
    instructions at the issue rate)."""
    t_bytes = nbytes / H100_BYTES * 1e3
    t_ops = max(tensor_flops / H100_BF16_FLOPS * 1e3,
                issue_ms(instructions))
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def close(got, want, name, steps=1):
    """Per element |got - want| <= steps * (2^-7 |want| + 2^-8 max|want|):
    ``steps`` bf16 rounding steps of the output plus a floor near zero."""
    import torch
    got, want = got.float(), want.float()
    err = (got - want).abs()
    tol = steps * (2.0 ** -7 * want.abs() + 2.0 ** -8 * want.abs().max())
    if not bool(torch.isfinite(got).all()) or not bool((err <= tol).all()):
        raise SystemExit(f"{name}: kernel disagrees with its plain version "
                         f"(max abs err {err.max().item():.3e})")
    return err.max().item()


def bf16_ulps(a, b):
    """Distance in bf16 steps between two bf16 tensors."""
    import torch

    def order(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (order(a) - order(b)).abs()


# ------------------------------------------------------------------ phases
def phase_build():
    """Build every kernel; return the SASS instructions one K1 element
    issues in this build."""
    from repro_torch.kernels import _build, sass
    t = time.perf_counter()
    reports = _build.build_all()
    for name, rep in reports.items():
        lines = [ln.strip() for ln in rep.splitlines()
                 if "registers" in ln or "spill" in ln
                 or "warning" in ln.lower()]
        log(f"[build] {name}: " + ("; ".join(lines) or rep.strip()))
    log(f"[build] {len(reports)} sources in "
        f"{time.perf_counter() - t:.1f} s")
    k1 = sass.census(sass.disassemble(str(_build._target("zo_axpy"))),
                     "zo_axpy_2d_kernelI13__nv_bfloat16E", 8)
    log(f"[build] K1 SASS: {k1['per_element']} instructions an element "
        f"(by pipe {k1['by_pipe']}) against {K1_OPS} operations the "
        "function needs")
    hmma = sass.count_ops(sass.disassemble(str(_build._target(
        "flash_attn"))), "flash_fwd_kernelILi128", "HMMA")
    log(f"[build] K2 SASS: flash_fwd_kernel<128> holds {hmma} HMMA "
        "(tensor-core) instructions")
    if hmma == 0:
        raise SystemExit("build: flash_fwd_kernel<128> runs no tensor-core "
                         "instruction")
    return k1["per_element"]


def phase_rng():
    """r_fast/c_fast against r_ref/c_ref on all 2^24 inputs each."""
    import torch
    from repro_torch.kernels import zo_axpy as kzo
    t = time.perf_counter()
    res = kzo.counter_normal_parts_check()
    torch.cuda.synchronize()
    log(f"[rng] r: {res['r_mismatches']} mismatches in {res['inputs']} "
        f"inputs (first {res['r_first']}); c: {res['c_mismatches']} in "
        f"{res['inputs']} (first {res['c_first']}); "
        f"{(time.perf_counter() - t) * 1e3:.1f} ms with the build")
    if res["r_mismatches"] or res["c_mismatches"]:
        raise SystemExit("rng: the kernels' z is not bit-identical to the "
                         "plain versions'")


def phase_parity(cfg, eps, k1_sass):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.fused import matmul as fmm
    from repro_torch.fused import ref as fref
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import zo_axpy as kzo

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    bf = torch.bfloat16
    D, Fd, V, H = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads
    dh = cfg.head_dim
    B, S = 16, 63                      # lezo-opt13b: batch 16, seq_len 64
    M = B * S
    rows = {}

    # K1: masked (4, D*F) rows in place
    theta = (torch.randn((4, D * Fd), generator=g, device=dev, dtype=bf)
             * 0.02)
    mask = torch.tensor([True, False, True, False])
    seed, scale = 0x1234567, -eps
    got, want = theta.clone(), theta.clone()
    kzo.zo_axpy_2d_(got, mask, seed, scale, 1.0)
    kref.zo_axpy_2d_(want, mask, seed, scale, 1.0)
    torch.cuda.synchronize()
    if not torch.equal(got[~mask.to(dev)].view(torch.int16),
                       theta[~mask.to(dev)].view(torch.int16)):
        raise SystemExit("zo_axpy_2d: a masked-off row changed")
    ulps = bf16_ulps(got[mask.to(dev)], want[mask.to(dev)]).max().item()
    if ulps > 1:
        raise SystemExit(f"zo_axpy_2d: active rows differ by {ulps} bf16 ulp")
    err = (got.float() - want.float()).abs().max().item()
    n_act = int(mask.sum()) * D * Fd
    b_ms, b_by = bound(n_act * 2 * 2, instructions=n_act * K1_OPS)
    rows["zo_axpy_2d"] = dict(
        max_abs_err=err, tolerance="masked rows bit-equal; active <= 1 bf16 "
        f"ulp (got {ulps})",
        ms=time_ms(lambda: kzo.zo_axpy_2d_(got, mask, seed, scale, 1.0)),
        plain_ms=time_ms(lambda: kref.zo_axpy_2d_(want, mask, seed, scale,
                                                  1.0), reps=2),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        bytes_bound_ms=n_act * 2 * 2 / H100_BYTES * 1e3,
        ops_bound_ms=issue_ms(n_act * K1_OPS))
    r1 = rows["zo_axpy_2d"]
    if k1_sass is not None:          # this build's instructions, not a bound
        r1["sass_per_element"] = k1_sass
        r1["issue_share"] = issue_ms(n_act * k1_sass) / r1["ms"]
    log(f"[parity] zo_axpy_2d (4, {D * Fd}) bf16: max|err| {err:.3e}, "
        f"{ulps} ulp; {r1['ms']:.4f} ms, bounds: bytes "
        f"{r1['bytes_bound_ms']:.4f} ms, operations "
        f"{r1['ops_bound_ms']:.4f} ms ({K1_OPS} an element at "
        f"{CLOCK_HZ / 1e6:.0f} MHz); issue share of the build's "
        f"{k1_sass} SASS instructions an element: {r1.get('issue_share')}")
    del theta, got, want

    # K1 at the LoRA leaves of lezo-opt13b-lora: A (L, D, r) and B (L, r,
    # D) of wq/wv, each a (L, D*r) stacked view, 10 of 40 layers active
    L, r = cfg.num_layers, 8
    lmask = torch.zeros(L, dtype=torch.bool)
    lmask[torch.randperm(L, generator=torch.Generator().manual_seed(3))[
        :L // 4]] = True
    for shape in ((L, D, r), (L, r, D)):
        theta = torch.randn(shape, generator=g, device=dev, dtype=bf) * 0.02
        got, want = theta.clone(), theta.clone()
        kzo.zo_axpy_2d_(got.view(L, -1), lmask, seed, scale, 1.0)
        kref.zo_axpy_2d_(want.view(L, -1), lmask, seed, scale, 1.0)
        ulps = bf16_ulps(got, want).max().item()
        if ulps > 1 or not torch.equal(got[~lmask.to(dev)].view(torch.int16),
                                       theta[~lmask.to(dev)].view(
                                           torch.int16)):
            raise SystemExit(f"zo_axpy_2d LoRA {shape}: {ulps} bf16 ulp or "
                             "a masked-off row changed")
    n_act = int(lmask.sum()) * D * r
    b_ms, b_by = bound(n_act * 2 * 2, instructions=n_act * K1_OPS)
    flat = got.view(L, -1)
    r1.update(
        lora_max_abs_err=(got.float() - want.float()).abs().max().item(),
        lora_ms=time_ms(lambda: kzo.zo_axpy_2d_(flat, lmask, seed, scale,
                                                1.0), reps=20),
        lora_plain_ms=time_ms(lambda: kref.zo_axpy_2d_(
            want.view(L, -1), lmask, seed, scale, 1.0)),
        lora_bound_ms=b_ms, lora_bound_by=b_by, lora_library_ms=None)
    log(f"[parity] zo_axpy_2d LoRA A ({L}, {D}, {r}) and B ({L}, {r}, {D}) "
        f"bf16, {int(lmask.sum())} of {L} rows: <= 1 ulp; "
        f"{r1['lora_ms']:.4f} ms, plain {r1['lora_plain_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    del theta, got, want, flat

    # K3: P = 2 stacked probes of the +-eps pair, both FFN shapes
    w_seed = 0xBEEF
    for K, N in ((D, Fd), (Fd, D)):
        x = torch.randn((2, M, K), generator=g, device=dev, dtype=bf)
        w = torch.randn((K, N), generator=g, device=dev, dtype=bf) * K ** -0.5
        args = ((w_seed, w_seed), (eps, -eps), (True, True))
        got = fmm.pmatmul_stack(x, w, *args)
        want = fref.pmatmul_stack(x, w, *args)
        err = close(got, want, f"pmatmul_stack ({K}, {N})")
        for p, s in enumerate((eps, -eps)):
            single = fmm.pmatmul(x[p], w, w_seed, s, True)
            if not torch.equal(single.view(torch.int16),
                               got[p].view(torch.int16)):
                raise SystemExit("pmatmul_stack at P = 2 is not bit-equal "
                                 "to two pmatmul calls")
        off = fmm.pmatmul_stack(x, w, (w_seed, w_seed), (eps, -eps),
                                (False, False))
        close(off, x @ w, f"inactive pmatmul_stack ({K}, {N})")
        log(f"[parity] pmatmul_stack x (2, {M}, {K}) @ W ({K}, {N}): "
            f"max|err| {err:.3e}; P=2 == 2 x pmatmul bitwise")
        if (K, N) == (D, Fd):
            b_ms, b_by = bound((x.numel() + w.numel() + got.numel()) * 2,
                               tensor_flops=2.0 * 2 * M * K * N,
                               instructions=K * N * RNG_OPS)
            rows["pmatmul_stack"] = dict(
                max_abs_err=err,
                tolerance="|err| <= 2^-7|plain| + 2^-8 max|plain|; P=2 "
                "and P=16 bit-equal to P pmatmul calls",
                ms=time_ms(lambda: fmm.pmatmul_stack(x, w, *args)),
                plain_ms=time_ms(lambda: fref.pmatmul_stack(x, w, *args),
                                 reps=2),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=time_ms(lambda: torch.matmul(x, w)),
                inactive_ms=time_ms(lambda: fmm.pmatmul_stack(
                    x, w, (w_seed, w_seed), (eps, -eps), (False, False))))
        del x, w, got, want, off

    # K3 active at (D, D): q, k, v and the attention output projection
    x = torch.randn((2, M, D), generator=g, device=dev, dtype=bf)
    w = torch.randn((D, D), generator=g, device=dev, dtype=bf) * D ** -0.5
    args = ((w_seed, w_seed), (eps, -eps), (True, True))
    close(fmm.pmatmul_stack(x, w, *args), fref.pmatmul_stack(x, w, *args),
          f"pmatmul_stack ({D}, {D})")
    rows["pmatmul_stack"]["dd_ms"] = time_ms(
        lambda: fmm.pmatmul_stack(x, w, *args))
    log(f"[parity] pmatmul_stack ({D}, {D}) active: within tolerance; K3 "
        f"ms: active (D, d_ff) {rows['pmatmul_stack']['ms']:.3f}, inactive "
        f"(D, d_ff) {rows['pmatmul_stack']['inactive_ms']:.3f}, active "
        f"(D, D) {rows['pmatmul_stack']['dd_ms']:.3f}")
    del x, w

    # K3 at P = 16: one_sided's stacked probes (fzoo-opt13b-q16), each
    # with its own seed; 4 of 16 active, as LeZO at sparsity 0.75 makes
    # a layer active for about a quarter of the probes
    P16 = 16
    act16 = tuple(p in (1, 6, 7, 12) for p in range(P16))
    seeds16 = tuple(w_seed + 101 * p for p in range(P16))
    args16 = (seeds16, (eps,) * P16, act16)
    n_groups = len(fmm.probe_groups(act16))
    r3 = rows["pmatmul_stack"]
    for K, N, tag in ((D, Fd, "p16"), (D, D, "p16_dd")):
        x = torch.randn((P16, M, K), generator=g, device=dev, dtype=bf)
        w = torch.randn((K, N), generator=g, device=dev, dtype=bf) * K ** -0.5
        fmm.stack_counter.launches = 0
        got = fmm.pmatmul_stack(x, w, *args16)
        n = fmm.stack_counter.launches
        if n != n_groups:
            raise SystemExit(f"pmatmul_stack P = 16: {n} launches, want "
                             f"{n_groups} groups")
        for p in range(P16):
            one = fmm.pmatmul(x[p], w, seeds16[p], eps, act16[p])
            if not torch.equal(one.view(torch.int16), got[p].view(
                    torch.int16)):
                raise SystemExit(f"pmatmul_stack at P = 16 is not bit-equal "
                                 f"to 16 pmatmul calls (probe {p})")
        err = close(got, fref.pmatmul_stack(x, w, *args16),
                    f"pmatmul_stack P = 16 ({K}, {N})")
        b_ms, b_by = bound((x.numel() + w.numel() + got.numel()) * 2,
                           tensor_flops=2.0 * P16 * M * K * N,
                           instructions=sum(act16) * K * N * RNG_OPS)
        r3[f"{tag}_ms"] = time_ms(lambda: fmm.pmatmul_stack(x, w, *args16))
        r3[f"{tag}_bound_ms"], r3[f"{tag}_bound_by"] = b_ms, b_by
        r3[f"{tag}_library_ms"] = time_ms(lambda: torch.matmul(x, w))
        if tag == "p16":
            r3["p16_max_abs_err"] = err
            r3["p16_plain_ms"] = time_ms(
                lambda: fref.pmatmul_stack(x, w, *args16), reps=1)
        log(f"[parity] pmatmul_stack P = 16 x ({P16}, {M}, {K}) @ W ({K}, "
            f"{N}), {sum(act16)} active, {n_groups} launches: max|err| "
            f"{err:.3e}; == 16 x pmatmul bitwise; {r3[tag + '_ms']:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by}), torch.matmul "
            f"{r3[tag + '_library_ms']:.3f} ms")
        del x, w, got
    torch.cuda.empty_cache()

    # K4: the tied head, embed/tok read through trans counters
    tok = torch.randn((V, D), generator=g, device=dev, dtype=bf) * 0.02
    h = torch.randn((B, S, D), generator=g, device=dev, dtype=bf)
    kw = dict(trans=True, ld=D)
    got = fmm.pmatmul(h, tok.T, w_seed, eps, True, **kw)
    want = fref.pmatmul(h, tok.T, w_seed, eps, True, **kw)
    err = close(got, want, "pmatmul head")
    b_ms, b_by = bound((h.numel() + tok.numel() + got.numel()) * 2,
                       tensor_flops=2.0 * M * D * V,
                       instructions=D * V * RNG_OPS)
    rows["pmatmul"] = dict(
        max_abs_err=err, tolerance="|err| <= 2^-7|plain| + 2^-8 max|plain|",
        ms=time_ms(lambda: fmm.pmatmul(h, tok.T, w_seed, eps, True, **kw)),
        plain_ms=time_ms(lambda: fref.pmatmul(h, tok.T, w_seed, eps, True,
                                              **kw), reps=2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.matmul(h, tok.T)))
    log(f"[parity] pmatmul h ({B}, {S}, {D}) @ tok.T ({D}, {V}) trans: "
        f"max|err| {err:.3e}")
    del tok, h, got, want

    # K2: the paired forward's attention, (P*B, S, H, 1, dh)
    q = torch.randn((2 * B, S, H, 1, dh), generator=g, device=dev, dtype=bf)
    k = torch.randn((2 * B, S, H, dh), generator=g, device=dev, dtype=bf)
    v = torch.randn((2 * B, S, H, dh), generator=g, device=dev, dtype=bf)
    got = kfa.flash_attention(q, k, v, causal=True)
    want = kfa.flash_attention_plain(q, k, v, causal=True)
    err = close(got, want, "flash_attention")
    qs, ks, vs = (t.reshape(2 * B, S, H, dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(4 * q.numel() * 2,
                       tensor_flops=4.0 * 2 * B * H * dh * pairs)
    rows["flash_attention"] = dict(
        max_abs_err=err, tolerance="|err| <= 2^-7|plain| + 2^-8 max|plain|",
        ms=time_ms(lambda: kfa.flash_attention(q, k, v, causal=True),
                   reps=50),
        plain_ms=time_ms(lambda: kfa.flash_attention_plain(q, k, v,
                                                           causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), reps=50))
    log(f"[parity] flash_attention ({2 * B}, {S}, {H}, 1, {dh}): "
        f"max|err| {err:.3e}; {rows['flash_attention']['ms']:.4f} ms, SDPA "
        f"{rows['flash_attention']['library_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    # K2 at prefix tuning's shape: 5 always-visible keys ahead of the 63
    # positions (k_offset = -5, Sk = 68), one probe of batch 16
    npre = 5
    q = torch.randn((B, S, H, 1, dh), generator=g, device=dev, dtype=bf)
    k = torch.randn((B, S + npre, H, dh), generator=g, device=dev, dtype=bf)
    v = torch.randn((B, S + npre, H, dh), generator=g, device=dev, dtype=bf)
    kw = dict(causal=True, k_offset=-npre)
    got = kfa.flash_attention(q, k, v, **kw)
    want = kfa.flash_attention_plain(q, k, v, **kw)
    err = close(got, want, "flash_attention prefix")
    qs, ks, vs = (t.reshape(B, t.shape[1], H, dh).transpose(1, 2)
                  .contiguous() for t in (q, k, v))
    allowed = (torch.arange(S, device=dev)[:, None]
               >= torch.arange(S + npre, device=dev)[None, :] - npre)
    b_ms, b_by = bound((2 * q.numel() + k.numel() + v.numel()) * 2,
                       tensor_flops=4.0 * B * H * dh * int(allowed.sum()))
    r2 = rows["flash_attention"]
    r2.update(
        prefix_max_abs_err=err,
        prefix_ms=time_ms(lambda: kfa.flash_attention(q, k, v, **kw),
                          reps=50),
        prefix_plain_ms=time_ms(lambda: kfa.flash_attention_plain(
            q, k, v, **kw)),
        prefix_bound_ms=b_ms, prefix_bound_by=b_by,
        prefix_library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=allowed), reps=50))
    log(f"[parity] flash_attention prefix q ({B}, {S}, {H}, 1, {dh}), k/v "
        f"Sk = {S + npre}, k_offset = -{npre}: max|err| {err:.3e}; "
        f"{r2['prefix_ms']:.4f} ms, SDPA with the mask "
        f"{r2['prefix_library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # K2 at the task scorers' largest batch: copa's chunk of 32 examples
    # with 2 choices each
    from repro_torch.tasks import metrics
    Bs = 2 * metrics.CHUNK
    q = torch.randn((Bs, S, H, 1, dh), generator=g, device=dev, dtype=bf)
    k = torch.randn((Bs, S, H, dh), generator=g, device=dev, dtype=bf)
    v = torch.randn((Bs, S, H, dh), generator=g, device=dev, dtype=bf)
    got = kfa.flash_attention(q, k, v, causal=True)
    want = kfa.flash_attention_plain(q, k, v, causal=True)
    err = close(got, want, "flash_attention scorer batch")
    qs, ks, vs = (t.reshape(Bs, S, H, dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    b_ms, b_by = bound(4 * q.numel() * 2,
                       tensor_flops=4.0 * Bs * H * dh * pairs)
    r2.update(
        scorer_max_abs_err=err,
        scorer_ms=time_ms(lambda: kfa.flash_attention(q, k, v, causal=True),
                          reps=50),
        scorer_plain_ms=time_ms(lambda: kfa.flash_attention_plain(
            q, k, v, causal=True)),
        scorer_bound_ms=b_ms, scorer_bound_by=b_by,
        scorer_library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), reps=50))
    log(f"[parity] flash_attention scorer batch ({Bs}, {S}, {H}, 1, {dh}): "
        f"max|err| {err:.3e}; {r2['scorer_ms']:.4f} ms, SDPA "
        f"{r2['scorer_library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # K2 off the main path: a long sequence, 16 query and key tiles a head
    Bl, Sl = 4, 1024
    q = torch.randn((Bl, Sl, H, 1, dh), generator=g, device=dev, dtype=bf)
    k = torch.randn((Bl, Sl, H, dh), generator=g, device=dev, dtype=bf)
    v = torch.randn((Bl, Sl, H, dh), generator=g, device=dev, dtype=bf)
    close(kfa.flash_attention(q, k, v, causal=True),
          kfa.flash_attention_plain(q, k, v, causal=True),
          f"flash_attention S={Sl}")
    qs, ks, vs = (t.reshape(Bl, Sl, H, dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    rows["flash_attention"]["long_ms"] = time_ms(
        lambda: kfa.flash_attention(q, k, v, causal=True), reps=20)
    rows["flash_attention"]["long_library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True),
        reps=20)
    log(f"[parity] flash_attention ({Bl}, {Sl}, {H}, 1, {dh}), off the "
        f"main path: within tolerance; "
        f"{rows['flash_attention']['long_ms']:.4f} ms, SDPA "
        f"{rows['flash_attention']['long_library_ms']:.4f} ms")
    del q, k, v, got, want, qs, ks, vs
    torch.cuda.empty_cache()
    return rows


def _counters():
    from repro_torch.fused import matmul as fmm
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import zo_axpy as kzo
    return {"zo_axpy_2d": kzo.counter, "flash_attention": kfa.counter,
            "pmatmul_stack": fmm.stack_counter,
            "pmatmul": fmm.single_counter}


def phase_train():
    import torch
    from repro_torch import api

    spec = api.with_overrides(api.preset("lezo-opt13b"), MAIN_OVERRIDES)
    torch.cuda.reset_peak_memory_stats()
    from repro_torch.fused import matmul as fmm
    counters = _counters()
    for c in list(counters.values()) + list(fmm.route_counters.values()):
        c.launches = 0
    t = time.perf_counter()
    result = api.run(spec)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    routes = {n: c.launches for n, c in fmm.route_counters.items()}
    hist = result["history"]
    for i, step in enumerate(hist["step"]):
        log(f"[train] step {step}: loss {hist['loss'][i]:.6f} "
            f"projected_grad {hist['projected_grad'][i]:.6e} "
            f"active_layers {hist['active_layers'][i]} "
            f"seconds {hist['step_seconds'][i]:.3f}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train] {spec.run.steps} steps in {time.perf_counter() - t:.1f} s "
        f"(init included); peak memory {peak:.2f} GiB; launches {launches}")
    losses = hist["loss"]
    if len(losses) != spec.run.steps or not all(map(math.isfinite, losses)):
        raise SystemExit(f"train: losses not finite / missing: {losses}")
    cfg = api.derive(spec).model_cfg
    L = cfg.num_layers
    want = {"zo_axpy_2d": 14 * spec.run.steps,
            "flash_attention": L * spec.run.steps,
            "pmatmul_stack": 6 * L * spec.run.steps,
            "pmatmul": 2 * spec.run.steps}
    if launches != want:
        raise SystemExit(f"train: launches {launches} != expected {want}")
    k34 = launches["pmatmul_stack"] + launches["pmatmul"]
    log(f"[train] K3/K4 launches by load route: {routes}")
    if routes != {"tma": k34, "thread": 0}:
        raise SystemExit(f"train: K3/K4 routes {routes}: every launch of "
                         "the main path must load by TMA")
    return spec, cfg, hist["final_params"], launches


def probe_gap(spec, cfg, params, plant=1.0):
    """The virtual pair's losses (l+, l-) on ``params`` against the
    materialized probes' (kernel K1 perturbing in place, then undoing),
    and their relative differences; then l- of a materialized theta -
    plant * eps z made from the unperturbed weights (one bf16 rounding,
    as the virtual l- has; the probe above reaches it as theta + eps z -
    2 eps z, rounded twice) and its relative difference to the virtual
    l-.  ``plant`` != 1 offsets that probe on purpose, to show the gate
    on it firing.  The weights are put back bit for bit from a copy on
    the card."""
    import torch
    from repro_torch import fused
    from repro_torch.api import runners
    from repro_torch.core import rng, zo
    from repro_torch.data import synthetic
    from repro_torch.models import lm

    d = runners.derive(spec)
    data = synthetic.make_dataset(d.task, 64)
    batch = {k: torch.as_tensor(data[k][:spec.run.batch_size], device="cuda")
             for k in ("tokens", "labels", "loss_mask")}
    zspec = zo.build_spec(params, lm.zo_group_fn)
    seed = rng.fold_py(rng.fold_py(0, 0xC0FFEE), 99)
    masks, idxs, _ = zo.stratified_select(zspec, seed, d.n_drop)
    eps = spec.optimizer.eps
    pair = lm.lm_loss(cfg, params, batch, perturb=fused.make_pair_ctx(
        seed, eps, masks, "virtual")).tolist()
    # a copy of what the probe changes: always-on leaves, active layers
    rows = [slice(None) if g is None else idxs[g].to(params["embed"][
        "tok"].device) for g in zspec.groups]
    snap = [t[r].clone() for (_, t), r in zip(zo.leaf_items(params), rows)]
    zo.tree_axpy_(params, zspec, seed, -eps * plant, masks, idxs,
                  backend="pallas")
    direct = lm.lm_loss(cfg, params, batch).item()
    with torch.no_grad():
        for (_, t), r, old in zip(zo.leaf_items(params), rows, snap):
            t[r] = old
    del snap
    mat = []
    for s in (eps, -2 * eps):
        zo.tree_axpy_(params, zspec, seed, s, masks, idxs, backend="pallas")
        mat.append(lm.lm_loss(cfg, params, batch).item())
    zo.tree_axpy_(params, zspec, seed, eps, masks, idxs, backend="pallas")
    rel = [abs(a - b) / abs(b) for a, b in zip(pair, mat)]
    if not all(math.isfinite(x) for x in pair + mat + [direct]):
        raise SystemExit(f"check: probe losses not finite: {pair} {mat} "
                         f"{direct}")
    return pair, mat, rel, direct, abs(pair[1] - direct) / abs(direct)


@contextlib.contextmanager
def swap_k2(fn):
    """The model's attention through ``fn`` in place of K2 (the model
    calls ``kernels.flash_attn.flash_attention``)."""
    from repro_torch.kernels import flash_attn as kfa
    kernel = kfa.flash_attention
    kfa.flash_attention = fn
    try:
        yield
    finally:
        kfa.flash_attention = kernel


def plain_k2():
    """K2's plain version in the model, for a reading that separates
    K2's rounding from the rest."""
    from repro_torch.kernels import flash_attn as kfa
    return swap_k2(kfa.flash_attention_plain)


def sdpa_attention(q, k, v, *, causal=True, q_offset=0, k_offset=0, **_):
    """K2's function through ``F.scaled_dot_product_attention`` with an
    explicit mask: a second witness beside K2 against its plain version,
    for readings only."""
    import torch
    import torch.nn.functional as F
    B, Sq, KV, G, dh = q.shape
    Sk = k.shape[1]
    qs = q.permute(0, 2, 3, 1, 4).reshape(B, KV * G, Sq, dh)
    ks, vs = (t.permute(0, 2, 1, 3).repeat_interleave(G, 1) for t in (k, v))
    mask = None
    if causal:
        mask = ((q_offset + torch.arange(Sq, device=q.device))[:, None]
                >= (k_offset + torch.arange(Sk, device=q.device))[None, :])
    out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
    return out.reshape(B, KV, G, Sq, dh).permute(0, 3, 1, 2, 4)


# The virtual l- and a materialized theta - eps z round the same bf16
# weights once each; they read equal on the card (0.0 in every run), so
# the gate leaves room for a sum in another order only.
DIRECT_GAP = 1e-4
PLANT = 1.25            # the planted probe: theta - 1.25 eps z


def direct_gate(gap):
    return gap <= DIRECT_GAP


def phase_check(spec, cfg, params):
    """Virtual pair vs materialized probes on the trained weights, and a
    small bf16 model's step on the card vs on the CPU."""
    import numpy as np
    import torch
    from repro_torch import api, fused
    from repro_torch.core import zo
    from repro_torch.data import synthetic
    from repro_torch.models import lm

    pair, mat, rel, direct, gap = probe_gap(spec, cfg, params)
    log(f"[check] OPT-13B virtual pair {pair} vs materialized {mat}: "
        f"rel diff {rel}")
    log(f"[check] materialized theta - eps z from the unperturbed weights: "
        f"l- {direct}, rel diff to the virtual l- {gap} (against "
        f"{rel[1]} for theta + eps z - 2 eps z)")
    if max(rel) > 1e-2:
        raise SystemExit("check: virtual and materialized probe losses "
                         "differ by more than 1e-2 relative")
    if not direct_gate(gap):
        raise SystemExit(f"check: the virtual l- and the materialized "
                         f"theta - eps z differ by {gap} relative, more "
                         f"than {DIRECT_GAP}")
    planted = probe_gap(spec, cfg, params, plant=PLANT)[4]
    log(f"[check] planted theta - {PLANT} eps z: rel diff to the virtual "
        f"l- {planted}, gate {'passes' if direct_gate(planted) else 'fails'}"
        f" (it must fail)")
    if direct_gate(planted):
        raise SystemExit("check: the gate on theta - eps z passed a "
                         f"probe offset to {PLANT} eps")
    with plain_k2():                 # readings, not gated
        pair, mat, rel, direct, gap = probe_gap(spec, cfg, params)
        log(f"[check] same weights, K2's plain version in the model: "
            f"virtual pair {pair} vs materialized {mat}: rel diff {rel}; "
            f"theta - eps z l- {direct}, rel diff {gap}")
        other = api.run(spec)["history"]
        pair, mat, rel, direct, gap = probe_gap(spec, cfg,
                                                other["final_params"])
        log(f"[check] weights trained with K2's plain version (losses "
            f"{other['loss']}): virtual pair {pair} vs materialized {mat}: "
            f"rel diff {rel}; theta - eps z rel diff {gap}")
        del other
    torch.cuda.empty_cache()

    from repro_torch.configs import opt
    small = opt.opt_tiny(layers=2, d_model=128, vocab=512).with_(
        dtype="bfloat16")
    gen = torch.Generator().manual_seed(5)
    p_cpu = lm.init_params(small, gen, "cpu")
    flat = lm.params_to_numpy(p_cpu)
    p_gpu = lm.params_from_numpy(small, flat, "cuda")
    task = synthetic.TaskConfig(vocab=small.vocab, seq_len=32)
    data = synthetic.make_dataset(task, 8)
    out = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        b = {k: torch.as_tensor(data[k], device=dev)
             for k in ("tokens", "labels", "loss_mask")}
        sp = zo.build_spec(p, lm.zo_group_fn)
        m, _, _ = zo.stratified_select(sp, 7, 1)
        out[dev] = lm.lm_loss(small, p, b, perturb=fused.make_pair_ctx(
            7, 1e-3, m, "virtual")).tolist()
    rel = np.abs(np.array(out["cuda"]) - np.array(out["cpu"])) / np.abs(
        np.array(out["cpu"]))
    log(f"[check] small bf16 OPT pair losses card {out['cuda']} vs CPU "
        f"plain {out['cpu']}: rel diff {rel.tolist()}")
    if not np.all(np.isfinite(out["cuda"])) or rel.max() > 1e-2:
        raise SystemExit("check: the card's small-model losses differ from "
                         "the CPU's by more than 1e-2 relative")


def phase_profile(spec, cfg, params, tag="profile"):
    """One more step of ``spec`` (the main path's by default) under
    ``torch.profiler``: device time by kernel and the device's idle
    share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import estimators
    from repro_torch.api import runners
    from repro_torch.core import rng, zo
    from repro_torch.data import synthetic
    from repro_torch.models import lm

    d = runners.derive(spec)
    data = synthetic.make_dataset(d.task, 64)
    batch = {k: torch.as_tensor(data[k][:spec.run.batch_size], device="cuda")
             for k in ("tokens", "labels", "loss_mask")}
    step, init = estimators.make_step(
        lambda p, b, perturb=None: lm.lm_loss(cfg, p, b, perturb=perturb),
        zo.build_spec(params, lm.zo_group_fn), d.est_cfg)
    base = rng.fold_py(spec.run.seed, 0xC0FFEE)
    step(params, init(), batch, spec.run.steps, base)    # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, init(), batch, spec.run.steps + 1, base)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_us = {}                      # device kernels only: an aten op's
    for e in prof.key_averages():    # row repeats its kernels' time
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            dev_us[e.key] = (us, e.count)
    busy = sum(us for us, _ in dev_us.values()) / 1e6
    log(f"[{tag}] step wall {wall:.3f} s, device busy {busy:.3f} s, "
        f"idle share {max(0.0, 1 - busy / wall):.3f}")
    if busy == 0:
        raise SystemExit(f"{tag}: the trace holds no device time")
    for key, (us, n) in sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"[{tag}] {us / 1e3:9.3f} ms {n:6d} x  {key[:90]}")
    for name in ("zo_axpy_2d_kernel", "flash_fwd_kernel", "pmatmul_kernel"):
        for key, (us, n) in dev_us.items():
            if name in key and n:
                log(f"[{tag}] per launch: {us / n / 1e3:.4f} ms over {n} "
                    f"x {key[:70]}")


def expected_launches(spec, params, steps):
    """Launches by kernel that ``steps`` steps of ``spec`` must make,
    from ``costs.step_counts`` and, for stacked one_sided probes, K3's
    probe groups of each layer's active probes (``fmm.probe_groups``).
    ZO modes here run virtual and paired, momentum materialized."""
    from repro_torch import api, estimators
    from repro_torch.core import rng, zo
    from repro_torch.fused import matmul as fmm
    from repro_torch.models import lm

    d = api.derive(spec)
    e, L = d.est_cfg, d.model_cfg.num_layers
    zspec = zo.build_spec(params, lm.zo_group_fn)
    leaves = len(zspec.paths)
    base = rng.fold_py(spec.run.seed, 0xC0FFEE)
    mode = spec.optimizer.mode
    n = {"zo_axpy_2d": 0, "flash_attention": 0, "pmatmul_stack": 0,
         "pmatmul": 0}
    for t in range(steps):
        if mode == "fo":
            n["flash_attention"] += L
            continue
        if mode == "zo_momentum":   # probe, -2 eps, restore, t + 1 <= K
            n["zo_axpy_2d"] += leaves * (3 + min(8, t + 1))
            n["flash_attention"] += 2 * L
            continue
        assert e.forward_backend == "virtual" and e.paired_probes
        est = estimators.build_estimator(zspec, e)
        n["zo_axpy_2d"] += leaves * est.step_counts()["axpy_sweeps"]
        inner = e.inner if e.name == "importance" else e.name
        if inner in ("two_point", "averaged"):     # one paired forward each
            pairs = 1 if inner == "two_point" else e.q
            n["flash_attention"] += L * pairs
            n["pmatmul_stack"] += 6 * L * pairs
            n["pmatmul"] += 2 * pairs
            continue
        seeds = estimators.direction_seeds(rng.fold_py(base, t), e.q)
        masks = [est.select(s)[0]["s0.b0"].tolist() for s in seeds]
        chunk = e.q_chunk if 0 < e.q_chunk < e.q else e.q
        n["flash_attention"] += L * (1 + -(-e.q // chunk))  # + baseline
        n["pmatmul"] += e.q
        for c0 in range(0, e.q, chunk):
            for layer in range(L):
                act = [m[layer] for m in masks[c0:c0 + chunk]]
                n["pmatmul_stack"] += 6 * (
                    1 if len(act) <= 2 else len(fmm.probe_groups(act)))
    return n


def run_counted(tag, spec, params=None, trainer=None, val_data=None):
    """One training run (``api.run``, or ``trainer.train()``) with the
    launch counters zeroed just before and read just after; logs and
    returns (history, launches, peak GiB)."""
    import torch
    from repro_torch import api
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    gc.collect()                     # what an earlier run left is freed
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    hist = (trainer.train(val_data=val_data) if trainer is not None
            else api.run(spec, params=params, val_data=val_data)["history"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {n: c.launches for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    secs = ", ".join(f"{x:.3f}" for x in hist["step_seconds"])
    log(f"[{tag}] losses {hist['loss']}; step seconds [{secs}]; peak memory "
        f"{peak:.2f} GiB; {wall:.1f} s in all; launches {launches}")
    losses = hist["loss"]
    if len(losses) != spec.run.steps or not all(map(math.isfinite, losses)):
        raise SystemExit(f"{tag}: losses not finite / missing: {losses}")
    return hist, launches, peak


def check_launches(tag, spec, params, launches):
    want = expected_launches(spec, params, spec.run.steps)
    if launches != want:
        raise SystemExit(f"{tag}: launches {launches} != expected {want}")


def full_params(hold, cfg):
    """OPT-13B weights at full width and depth, built once: the ``train``
    phase's, or random from a seed."""
    import torch
    from repro_torch.models import lm
    if "params" not in hold:
        hold["params"] = lm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    return hold["params"]


def phase_estimators(hold, cfg):
    from repro_torch import api
    params = full_params(hold, cfg)
    for tag, name, ov in (
            ("one_sided q=16", "fzoo-opt13b-q16", {"run.steps": 2}),
            ("averaged q=2", "lezo-opt13b",
             {"estimator.name": "averaged", "estimator.q": 2,
              "run.steps": 3}),
            ("importance", "lezo-opt13b",
             {"estimator.name": "importance", "run.steps": 3})):
        spec = api.with_overrides(api.preset(name), {**MAIN_OVERRIDES, **ov})
        hist, launches, peak = run_counted(f"estimators {tag}", spec, params)
        check_launches(f"estimators {tag}", spec, params, launches)
        if name == "fzoo-opt13b-q16":
            phase_profile(spec, cfg, params, tag="profile one_sided q=16")


def phase_momentum(hold, cfg):
    from repro_torch import api
    params = full_params(hold, cfg)
    spec = api.with_overrides(api.preset("lezo-opt13b"), {
        **MAIN_OVERRIDES, "optimizer.mode": "zo_momentum",
        "runtime.forward_backend": "materialized", "run.steps": 3})
    hist, launches, peak = run_counted("momentum", spec, params)
    check_launches("momentum", spec, params, launches)


# The task scorers' outputs with K2 against K2's plain version in the
# same model, on fresh seeded weights: within SCORER_STEPS bf16 steps
# (``close``), the 8 ISSUE-time prediction; fresh weights read 3.78,
# 0.35 and 4.08 (PERF.md, NVIDIA H100 80GB HBM3, 700 W).
SCORER_STEPS = 8
N_EVAL = 64                           # examples a task phase scores


def counted(fn):
    """``fn()`` with the launch counters zeroed just before and read just
    after: (result, launches, peak GiB, seconds)."""
    import torch
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, {n: c.launches for n, c in counters.items()},
            torch.cuda.max_memory_allocated() / 2 ** 30,
            time.perf_counter() - t)


def bf16_steps(got, want):
    """max |got - want| in the units of ``close``: 2^-7 |want| + 2^-8
    max|want|."""
    unit = 2.0 ** -7 * want.abs() + 2.0 ** -8 * want.abs().max()
    return ((got - want).abs() / unit).max().item()


def scorer_gap(tag, fn, gate=True):
    """``fn()`` (a tensor of scores or logits) with K2 in the model, and
    with SDPA in K2's place, each against the same with K2's plain
    version; with ``gate``, fails when K2's is past SCORER_STEPS bf16
    steps.  Returns K2's difference in steps."""
    import torch
    got = torch.as_tensor(fn()).float()
    with plain_k2():
        want = torch.as_tensor(fn()).float()
    with swap_k2(sdpa_attention):
        lib = torch.as_tensor(fn()).float()
    steps = bf16_steps(got, want)
    if gate:
        close(got, want, f"tasks {tag} with K2 against K2's plain version",
              steps=SCORER_STEPS)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"[tasks] {tag} {tuple(got.shape)}: K2 vs K2's plain version "
        f"max|err| {(got - want).abs().max().item():.3e} = {steps:.2f} bf16 "
        f"steps (tolerance {SCORER_STEPS if gate else 'none, a reading'}), "
        f"SDPA vs K2's plain version {bf16_steps(lib, want):.2f} steps, "
        f"max|plain| {want.abs().max().item():.3e}, argmax agreement "
        f"{agree:.4f}")
    return steps


def scorers(cfg, params, spec):
    """The three scorers on N_EVAL examples of their tasks, tag -> fn:
    sst2's verbalizer logits, copa's choice scores and squad_copy's
    answer logits (one chunk)."""
    import torch
    from repro_torch import tasks
    from repro_torch.models import lm
    from repro_torch.tasks import metrics
    data = {}
    for name in ("sst2", "copa", "squad_copy"):
        t = tasks.build(name, cfg.vocab, spec.model.seq_len, spec.run.seed)
        data[name] = (t, t.make_dataset(N_EVAL, seed=t.seed + 1))
    (sst2, ds), (_, dc), (_, dq) = (data[n] for n in (
        "sst2", "copa", "squad_copy"))
    mask = torch.as_tensor(dq["loss_mask"][:metrics.CHUNK] > 0,
                           device="cuda")
    return {
        "sst2 verbalizer logits": lambda: metrics.verbalizer_logits(
            cfg, params, ds["tokens"], sst2.verb_ids, lm),
        "copa choice scores": lambda: metrics.choice_scores(
            cfg, params, dc["choice_inputs"], dc["choice_labels"],
            dc["choice_mask"], lm),
        "squad_copy answer logits": lambda: metrics.logits(
            cfg, params, dq["tokens"][:metrics.CHUNK], lm)[mask]}


def phase_tasks(hold, cfg):
    """The SuperGLUE-style registry on OPT-13B: the main path trained on
    ``sst2`` with one evaluation of N_EVAL examples, then zero-shot
    ``api.evaluate`` on ``copa`` (choice scores) and ``squad_copy`` (exact
    match), with launches against ``costs.step_counts`` plus the
    evaluation's forwards, and each scorer with K2 against K2's plain
    version."""
    from repro_torch import api
    from repro_torch.tasks import metrics
    from repro_torch.train.trainer import Trainer

    spec = api.with_overrides(api.preset("lezo-opt13b"), {
        **MAIN_OVERRIDES, "task.name": "sst2", "run.eval_every": 4})
    # readings on the weights the earlier phases trained (the presets'
    # learning rate, set for the CPU variants), with SDPA as a second
    # witness; the gated checks below run on fresh seeded weights
    if "params" in hold:
        for tag, fn in scorers(cfg, hold["params"], spec).items():
            scorer_gap(f"{tag} (trained weights)", fn, gate=False)
        del fn                       # its closure holds those weights
    hold.pop("params", None)
    gc.collect()
    params = full_params(hold, cfg)
    L = cfg.num_layers
    eval_fwd = 1 + -(-N_EVAL // metrics.CHUNK)   # val loss + scorer chunks
    trainer = Trainer.from_spec(spec, params=params)
    val = trainer.make_dataset(N_EVAL, seed_shift=1)
    hist, launches, peak = run_counted("tasks sst2", spec, trainer=trainer,
                                       val_data=val)
    want = expected_launches(spec, params, spec.run.steps)
    want["flash_attention"] += L * eval_fwd
    if launches != want:
        raise SystemExit(f"tasks sst2: launches {launches} != {want}")
    log(f"[tasks] sst2 {hist['metric_name']} {hist['val_acc']} at steps "
        f"{hist['val_step']} (random weights), val loss {hist['val_loss']}, "
        f"best step {hist.get('best_step')}")
    del hist, trainer
    for name in ("copa", "squad_copy"):
        tspec = api.with_overrides(spec, {"task.name": name})
        rep, launches, peak, secs = counted(lambda: api.evaluate(
            tspec, n_examples=N_EVAL, params=params))
        log(f"[tasks] {name} zero-shot {rep['metric']} {rep['zeroshot']} "
            f"(random weights), val loss {rep['zeroshot_val_loss']:.6f}; "
            f"{secs:.2f} s, peak memory {peak:.2f} GiB; launches {launches}")
        if launches != {"zo_axpy_2d": 0, "flash_attention": L * eval_fwd,
                        "pmatmul_stack": 0, "pmatmul": 0}:
            raise SystemExit(f"tasks {name}: launches {launches}")
        if not math.isfinite(rep["zeroshot_val_loss"]):
            raise SystemExit(f"tasks {name}: val loss not finite")
    for tag, fn in scorers(cfg, params, spec).items():
        scorer_gap(tag, fn)


def phase_peft(hold, cfg):
    """ZO over a PEFT tree on the OPT-13B weights (materialized, K1
    perturbing the trainable tree): ``lezo-opt13b-lora`` and
    ``lezo-opt13b`` with ``runtime.peft=prefix`` (K2 at k_offset = -5),
    3 steps each, launches against ``costs.step_counts``."""
    from repro_torch import api
    from repro_torch.core import zo
    from repro_torch.estimators import costs
    from repro_torch.train.trainer import Trainer

    params = full_params(hold, cfg)
    for tag, name, ov in (("lora", "lezo-opt13b-lora", {}),
                          ("prefix", "lezo-opt13b",
                           {"runtime.peft": "prefix"})):
        spec = api.with_overrides(api.preset(name), {
            **MAIN_OVERRIDES, "runtime.forward_backend": "materialized",
            "run.steps": 3, **ov})
        trainer = Trainer.from_spec(spec, params=params)
        n_tr = sum(t.numel() for _, t in zo.leaf_items(trainer.params))
        hist, launches, peak = run_counted(f"peft {tag}", spec,
                                           trainer=trainer)
        c = costs.step_counts("two_point", forward_backend="materialized")
        steps = spec.run.steps
        want = {"zo_axpy_2d": len(trainer.spec.paths) * c["axpy_sweeps"]
                * steps,
                "flash_attention": cfg.num_layers * c["forwards"] * steps,
                "pmatmul_stack": 0, "pmatmul": 0}
        log(f"[peft] {tag}: {len(trainer.spec.paths)} trainable leaves, "
            f"{n_tr / 1e6:.3f} M parameters")
        if launches != want:
            raise SystemExit(f"peft {tag}: launches {launches} != {want}")
        del trainer, hist


# FO at the depths the float32 master weights leave room for on 80 GB:
# SGD holds bf16 params and grads and float32 masters (8 B a parameter),
# AdamW two float32 moments more (16 B); OPT-13B has 314.6 M parameters a
# layer and 267.9 M in the embeddings, so 20 and 10 of 40 layers.
FO_DEPTHS = {"sgd": 20, "adamw": 10}


def fo_state_gib(state):
    """GiB of the FO state by kind: the leaves (their gradients take as
    much), the float32 masters and the moments."""
    nb = lambda ts: sum(t.numel() * t.element_size() for t in ts
                        if t is not None) / 2 ** 30
    return {"leaves": nb(t for _, _, t in state.leaves),
            "master": nb(state.master),
            "moments": nb((state.mu or []) + (state.nu or []))}


def phase_fo(cfg):
    """K2's backward on the card, then FO-SGD and the preset's AdamW at
    full width and the depths of ``FO_DEPTHS``, with float32 master
    weights (the reference's stored precision), each with its peak
    memory and state sizes beside the bf16-state figure."""
    import torch
    from repro_torch import api
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.train.trainer import Trainer

    g = torch.Generator(device="cuda").manual_seed(99)
    shapes = [(32, 63, cfg.n_heads, 1, cfg.head_dim)] + [
        (32, 63, cfg.n_heads, cfg.head_dim)] * 2
    q, k, v = (torch.randn(s, generator=g, device="cuda").bfloat16()
               for s in shapes)
    dout = torch.randn(shapes[0], generator=g, device="cuda").bfloat16()
    grads = []
    for fn in (kfa.flash_attention, kfa.flash_attention_plain):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*ins, causal=True).backward(dout)
        grads.append([t.grad for t in ins])
    errs = [close(a, b, f"flash backward d{n}", steps=2)
            for a, b, n in zip(*grads, "qkv")]
    log(f"[fo] K2 backward {shapes[0]} against autograd through the plain "
        f"version: max|err| dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv "
        f"{errs[2]:.3e} (tolerance: 2 bf16 steps)")
    del q, k, v, dout, grads

    fo_overrides = {"model.variant": "full", "run.steps": 2,
                    "run.log_every": 1, "run.eval_every": 0}
    for opt, depth in FO_DEPTHS.items():
        spec = api.with_overrides(api.preset("fo-opt13b"), {
            **fo_overrides, "optimizer.fo_optimizer": opt})
        d = api.derive(spec)
        cut = dataclasses.replace(d.model_cfg, stages=(dataclasses.replace(
            d.model_cfg.stages[0], repeat=depth),))
        trainer = Trainer(cut, d.task, d.tcfg, d.est_cfg, fo_cfg=d.fo_cfg,
                          _spec=spec, _derived=d)
        gib = fo_state_gib(trainer.state)
        n_par = sum(t.numel() for _, _, t in trainer.state.leaves)
        log(f"[fo] {opt} cut to {depth} of {d.model_cfg.num_layers} layers "
            f"at full width ({n_par / 1e9:.3f} B parameters): state GiB "
            f"{ {k: round(v, 2) for k, v in gib.items()} } and grads as "
            f"much as the leaves; with master weights "
            f"{2 * gib['leaves'] + gib['master'] + gib['moments']:.2f} GiB, "
            f"bf16 state (no masters, moments in bf16) "
            f"{gib['leaves'] * (2 + 2 * (opt == 'adamw')):.2f} GiB")
        hist, launches, peak = run_counted(f"fo {opt} {depth} layers", spec,
                                           trainer=trainer)
        if launches != {"zo_axpy_2d": 0, "flash_attention": depth * 2,
                        "pmatmul_stack": 0, "pmatmul": 0}:
            raise SystemExit(f"fo {opt}: launches {launches}")
        if any(m is None and t.dtype == torch.bfloat16 for (_, _, t), m
               in zip(trainer.state.leaves, trainer.state.master)):
            raise SystemExit(f"fo {opt}: a bf16 leaf has no float32 master")
        del trainer, hist
        gc.collect()
        torch.cuda.empty_cache()


def phase_resume():
    """bench variant in bf16 on the card: 4 steps against 2 + checkpoint
    + resumed 2; parameters bit for bit."""
    import torch
    from repro_torch import api
    from repro_torch.models import lm

    spec = api.with_overrides(api.preset("bench-smoke"), {
        "runtime.backend": "pallas", "runtime.forward_backend": "virtual",
        "run.steps": 4, "run.log_every": 1, "run.eval_every": 0})
    cfg = api.derive(spec).model_cfg.with_(dtype="bfloat16")

    def fresh(seed):
        return lm.init_params(cfg, torch.Generator(
            device="cuda").manual_seed(seed), "cuda")

    ckdir = os.path.join(ROOT, "build", "chip_smoke_resume")
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        ref = api.run(spec, params=fresh(11))["history"]
        api.run(api.with_overrides(spec, {
            "run.steps": 2, "run.ckpt_dir": ckdir, "run.ckpt_every": 2}),
            params=fresh(11))
        res = api.run(api.with_overrides(spec, {"run.ckpt_dir": ckdir}),
                      params=fresh(12))["history"]
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    same = all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
               for a, b in zip(ref["final_params"].parameters(),
                               res["final_params"].parameters()))
    log(f"[resume] bench bf16: uninterrupted losses {ref['loss']}, resumed "
        f"at step {res['step'][0]} {res['loss']}; params bit-equal: {same}")
    if (not same or res["step"][0] != 2
            or res["loss"] != ref["loss"][2:]):
        raise SystemExit("resume: the resumed run is not the uninterrupted "
                         "run bit for bit")


SOURCES = {
    "zo_axpy_2d": ("src/repro_torch/csrc/zo_axpy.cu",
                   "src/repro/kernels/zo_axpy.py:82"),
    "flash_attention": ("src/repro_torch/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:87"),
    "pmatmul_stack": ("src/repro_torch/csrc/pmatmul.cu",
                      "src/repro/fused/matmul.py:273"),
    "pmatmul": ("src/repro_torch/csrc/pmatmul.cu",
                "src/repro/fused/matmul.py:154"),
}


PHASES = ("build", "rng", "parity", "train", "check", "profile",
          "estimators", "momentum", "tasks", "peft", "fo", "resume")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all)")
    phases = ap.parse_args().phases.split(",")
    if set(phases) - set(PHASES) or (
            {"check", "profile"} & set(phases) and "train" not in phases):
        ap.error(f"--phases takes a subset of {','.join(PHASES)}; check "
                 "and profile need train")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails in a checkout without the port)

    global CLOCK_HZ
    CLOCK_HZ = float(smi("clocks.max.sm", "nounits")) * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import api

    t0 = time.perf_counter()
    spec = api.with_overrides(api.preset("lezo-opt13b"), MAIN_OVERRIDES)
    cfg = api.derive(spec).model_cfg
    rows, launches = {}, {}
    k1_sass = phase_build() if "build" in phases else None
    if "rng" in phases:
        phase_rng()
    if "parity" in phases:
        rows = phase_parity(cfg, spec.optimizer.eps, k1_sass)
    hold = {}                        # the full-size weights, built once
    if "train" in phases:
        spec, cfg, hold["params"], launches = phase_train()
    if "check" in phases:
        phase_check(spec, cfg, hold["params"])
    if "profile" in phases:
        phase_profile(spec, cfg, hold["params"])
    if "estimators" in phases:
        phase_estimators(hold, cfg)
    if "momentum" in phases:
        phase_momentum(hold, cfg)
    if "tasks" in phases:
        phase_tasks(hold, cfg)
    if "peft" in phases:
        phase_peft(hold, cfg)
    hold.clear()                     # FO builds its own cut weights
    gc.collect()
    torch.cuda.empty_cache()
    if "fo" in phases:
        phase_fo(cfg)
    if "resume" in phases:
        phase_resume()
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = rows.get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches.get(name),
                        **{k: r.get(k) for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "tolerance")},
                        **{k: v for k, v in r.items() if k not in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "tolerance")}})
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--phases build,rng,parity,train,check,...]

Phases (all by default; ``check`` and ``profile`` need ``train``,
``replay`` needs ``trace``), each of which fails the run (non-zero exit)
when it fails:

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
6. profile — two more main-path steps in one profiled window
             (``measure_window``: ``torch.profiler`` between edge kernels,
             a marker kernel a step, the records refused unless whole):
             device time by kernel, each port kernel's device time per
             launch, and the device's idle share of a step.
7. trace   — the main path's steady state on the weights of ``train``:
             2 warm-up + 10 steps with telemetry off, then as many with
             it on (``fence=false``; ring and ``trace.jsonl`` in a
             temporary run directory), each through ``api.run``: median,
             min and max of ``step_seconds`` and of the ``train/step``
             spans; launches equal with telemetry on and off and to
             ``costs.step_counts``; counters equal to what the steps
             imply (probes, sweeps, selections, the active-layer gauge,
             and W tiles and z tiles from K3/K4's grid); the on/off
             median ratio within 0.80-1.25; the device's idle share over
             10 steady steps (``measure_window``, kernel time); and 4
             steps with ``fence=true``: the median of each stage span.
8. replay  — ``launch replay`` of that telemetry-on run on the card, from
             the weights it started from: every recorded scalar of every
             step bit for bit, the unstacked leaves bit-equal to the
             run's; the drain time of one logged step with
             ``health_norms`` (the exact ‖z‖ at 13B, within 1e-3 of the
             E‖z‖² = N estimate); the report's stage-timing table.
9. estimators — the other ZO estimators on OPT-13B at full width and
             depth (the weights of ``train``, or built once from a seed),
             through ``api.run(spec, params=...)``: ``fzoo-opt13b-q16``
             (one_sided, q = 16 probes stacked in one forward, K3 at
             P = 16), ``averaged`` at q = 2 and ``importance`` over
             two_point, with the main path's overrides.  Step seconds,
             peak memory and launches by kernel; the launches must equal
             what ``costs.step_counts`` and K3's probe grouping imply.
10. mezo   — MeZO (``mezo-opt13b``, sparsity 0) beside LeZO
             (``lezo-opt13b``) on the same weights, each from them and the
             same seed, under the virtual paired forward (K3 active on 40
             layers against 10) and under the materialized probes with
             ``backend=pallas`` (K1's perturb, perturb and restore+update
             sweeps over 40 rows against 10), 1 + 3 steps each with
             telemetry on: finite losses, launches as reckoned, the
             ``obs.trace`` probe, selection and axpy counters, K3/K4's
             tile counters and the active-layer gauge as reckoned, and
             MeZO's first (l+, l-) against its own backend's probes (the
             virtual pair, or the materialized probes) on the same
             weights, batch and seed, the virtual l- against theta - eps
             z (``check``'s gate).  Read: the gap to the other backend's
             probes, step seconds, device time, peak, and MeZO / LeZO
             under each backend.
11. momentum — ``zo_momentum`` on the same weights, materialized, K1
             sweeps (probe, restore and the K history sweeps), 3 steps.
12. tasks   — the task registry on fresh seeded weights: the main path on
             ``sst2`` (4 steps, one evaluation of 64 examples), then
             zero-shot ``api.evaluate`` on ``copa`` and ``squad_copy``;
             launches against ``costs.step_counts`` plus the evaluation
             forwards; each scorer with K2 against K2's plain version
             (within 8 bf16 steps), SDPA in K2's place beside it; the
             same read, not gated, on the weights earlier phases trained.
13. peft   — ZO over a LoRA tree (``lezo-opt13b-lora``) and a prefix tree
             (``runtime.peft=prefix``) on the weights of ``tasks``,
             materialized,
             3 steps each: step seconds, peak memory, K1/K2 launches.
14. serve  — the serving path at OPT-13B full width and depth, on the
             weights of the earlier phases (or from a seed): lockstep
             ``launch.serve.generate`` at batch 4, prompt 1024, 32 new
             tokens (K2 launches must equal the 40 layers of the prefill;
             K2 against its plain version on that prefill's last inputs,
             the ``serve_shapes`` row); the paged engine
             (``repro_torch.serving.Engine``: page_size 16, prefill chunk
             256, 8 lanes, max_seq 1024, 513 pages, 32 new tokens, greedy)
             over 16 requests of 64-700 tokens, 8 sharing a 512-token
             prefix: (a) sharing off under fenced spans (TTFT, decode step
             and prefill chunk ms, tok/s, peak memory, arena GiB), (b)
             ``prefix_cache`` and (c) ``priorities=2, preempt`` with 4
             high-priority requests after 8 steps, each bit-equal to (a),
             2 shapes run and the pool empty after; 4 requests against
             ``generate`` at batch 1 (first-token logits within
             ``SERVE_LOGIT_STEPS`` bf16 steps; streams equal or parting at
             a near-tie), each prompt's lockstep prefill also run through
             K2's plain version as a diagnostic (the engine's first-token
             gap against both lockstep runs, theirs to each other, not
             gated); the plain serving operations' times; a
             ``torch.profiler`` profile of one steady decode step and the
             idle share over 10.
15. zoo    — the dense model zoo, once this process holds no OPT-13B
             weights.  Each kernel against its plain version at
             Qwen3-14B's shapes (the ``zoo_shapes`` rows: K2 at G = 5, 2
             and 7 with 8 KV heads, SDPA with ``enable_gqa`` beside; K3
             at wq/wo, wk/wv, wg/wu and wd; K4 on the untied (5120,
             151936) head read as stored and on internvl2-2b's (2048,
             92553) head, which must load by per-thread loads; K1 on
             head/w as one 778 M-element row).  Then ``lezo-opt13b``
             with ``model.arch=qwen3-14b`` at full width and depth:
             4 steps (launches as ``expected_launches`` reckons: K3 7 a
             layer, K4 2, K2 40 a step, K1 one a leaf; every K3/K4 launch
             by TMA), the virtual pair against the materialized probes
             with ``check``'s gates, 10 steady steps as ``trace`` times
             them (telemetry off) with the idle share, a profiled step;
             serving it: lockstep ``generate`` at (4, 1024) + 32 (K2 40
             launches at (4, 1024, 8, 5, 128), held against its plain
             version), the engine over 8 requests (4 sharing a 512-token
             prefix; the last 4 arrive after 8 steps, so 2 of them can
             find the prefix registered) with sharing off and
             ``prefix_cache`` bit-equal, pages shared, 2
             requests against ``generate`` at batch 1 (``serve``'s gate).
             Then K2, K3 and K4 against their plain versions at the
             shapes of codeqwen1.5-7b, internlm2-1.8b, musicgen-large and
             internvl2-2b, and each of those four at its published depth
             and full width through ``api.run`` (2 + 6 steps, LeZO's
             n_drop from the preset's sparsity; musicgen-large and
             internvl2-2b on stub embeddings): finite losses, launches
             as reckoned, K3/K4 routes, every step's active layers; the
             step seconds, device time and idle share over 3 more steps,
             peak memory.  Last deepseek-coder-33b at full width and
             depth (2 steps, peak memory).
16. moe    — the zoo's MoE and MLA configs, once no earlier weights are
             held.  K2 at MLA's dh = 192 (q (16, 63, 16, 1, 192), v
             zero-padded from 128: pad columns exact zeros) and at
             granite-moe's (16, 63, 8, 2, 64), SDPA beside; K1 on a
             layer's row of deepseek's ``we_g`` (184.5 M elements) and
             on its float32 router stack (the ``moe_shapes`` rows).
             Then deepseek-v2-lite-16b and granite-moe-1b-a400m at full
             width and depth, ``lezo-opt13b`` materialized: 4 steps
             twice from the seed (launches as ``expected_launches``
             reckons: K1 a leaf a sweep, K2 a layer a forward; the two
             runs' losses, projected gradients and parameter digests
             bit-equal), 2 + 5 steady steps, the idle share over 5, a
             profiled step with device time by op.  deepseek serves
             through the lockstep ``generate`` (4, 1024) + 32 (the
             engine must refuse MLA; K2 27 launches at dh = 192, held
             against its plain version and SDPA on the last layer's
             inputs; the absorbed decode step timed and profiled);
             granite through the engine over 8 requests (4 sharing the
             prefix, the last 4 after 8 steps) at the published
             capacity factor (dropped assignments and the first-token
             gap to the lockstep read, not gated) and dropless at 4.0
             (no drop; ``prefix_cache`` bit-equal with pages shared;
             ``serve``'s engine-against-lockstep gate).
17. ssm    — the zoo's recurrent configs, once no earlier weights are
             held.  K2 at jamba's GQA (16, 63, 8, 4, 128) and lockstep
             prefill (4, 1024, 8, 4, 128), SDPA beside; K1 on a layer's
             row of jamba's ``we_g`` (939.5 M elements) and on xlstm's
             float32 ``rh`` stack; the selective-scan kernel against
             its plain ops (``ssm._scan_plain``) at (16, 63, 8192, 16)
             bf16, train and prefill, both timed beside its bytes bound
             (the ``ssm_shapes`` rows); one plain ``slstm_fwd`` at
             (16, 63, 1024) timed.  One layer of each
             recurrent kind at full width: a 128-token prefill and 8
             decode steps against the train forward (within 16 bf16
             steps).  Then xlstm-350m at full width and depth and
             jamba-v0.1-52b at full width cut to the most periods of 8
             layers one card holds (3, else 2: a train step and a (4,
             1024) prefill tried first, the refusing peak logged),
             ``lezo-opt13b`` materialized, as ``moe`` runs its two: 4
             steps twice from the seed bit-equal, launches as reckoned
             (K1 a leaf a sweep; K2 an attention layer a forward),
             2 + 5 steady steps, the idle share, a profiled step with
             the Mamba scan, the mLSTM chunk and the sLSTM block by
             device time; one jamba step with the scan's counters
             zeroed: the kernel once a Mamba layer a forward, the plain
             ops on the card never; jamba's dropped MoE assignments at capacity
             factor 1.25; each served through the lockstep ``generate``
             (4, 1024) + 32 twice (equal tokens; the engine must refuse
             them) with a decode step timed and profiled.
18. modes  — the reference's other optimizer modes on the zoo's config
             families, once no earlier weights are held.  First each
             kernel against its plain version at the shapes only these
             runs give it (the ``modes_shapes`` rows): K3 on Qwen3-14B's
             seven layer leaves and K4 on its untied head (``trans=False``)
             at the swarm's batch shard, x (2, 504, K); K2's forward inside
             FO's autograd ``Function`` at MLA's dh = 192 and granite's
             GQA, its plain float32 backward timed beside; K2 at prefix
             tuning's shape on Qwen3-14B (G = 5); K1 on Qwen3-14B's LoRA
             ``wv/B`` leaf.  Then Qwen3-14B at full width and depth,
             3 steps each, twice from the seed (losses, projected
             gradients and trainable digests bit-equal; launches as
             reckoned): LoRA and prefix (materialized; K1 a tree leaf a
             sweep, K2 a layer a forward), ZO momentum (K1 a leaf for
             each of its 3 + min(8, t + 1) sweeps) and the swarm's sharded
             step in one process (two loss shards: K2 L, K3 7L and K4 2 a
             shard, K1 at the commit).  FO (float32 masters, K2 in the
             forward, its backward plain) on granite-moe-1b-a400m (SGD
             and AdamW) and xlstm-350m (SGD) at full width and depth, and
             SGD on deepseek-v2-lite-16b at the deepest depth whose 8 B a
             parameter fit 75 % of the card: twice each, bit-equal
             (the MoE dispatch's gradient adds in a fixed order).
             The K2 rows also hold the kernel's row statistics and the
             gradients through it.  jamba's FO is reckoned and
             stays on the CPU: one period holds more than the card.
19. fo     — K2's backward against autograd through its plain version at
             the main shape; then first-order training with float32
             master weights: ``fo-opt13b`` with SGD at 20 and the
             preset's AdamW at 10 of 40 layers (what 80 GB holds), peak
             memory and state sizes.
20. resume — on the ``bench`` variant in bf16: 4 uninterrupted steps
             against 2 steps, a checkpoint and a resumed run of 2 more;
             the parameters must match bit for bit.
21. swarm  — the seed-synchronized swarm (``repro_torch.swarm``), once
             this process holds no 13B weights.  First K1-K4 against
             their plain versions at the shapes one worker's loss shard
             gives them (the ``swarm_shapes`` rows of the kernels line).
             Then one part after another: at OPT-13B full width (the main
             path's spec, 12 steps, 2 loss shards of 8 rows, 2 worker
             processes ``python -m repro_torch.launch swarm --attach ...
             --device cuda`` sharing this one card) a calm run (every
             worker exits 0, no respawn, each worker's K1-K4 launches
             consistent with the commits it folded and the probes it
             ran); the same spec in this process through ``api.run``
             (scalar stream bit for bit, launches as
             ``expected_launches``); a crash/rejoin run
             (``swarm.chaos_crash=1:3``: one crash exit, one respawn that
             draws its weights from the seed and folds the commit log;
             stream bit for bit); ``launch replay`` of the calm run.
             Then at OPT-1.3B (``opt_1_3b``, 4 loss shards) one run of 4
             workers with a crash at step 5 and a rejoin from the step-4
             checkpoint (``run.ckpt_every=4``, ``swarm.chaos_crash=1:5``)
             against one process: stream, and the designated worker's
             final checkpoint against the final parameters, bit for bit.
             Each step waits until every running worker has attached, so
             all join at step 0 and a respawned worker by the step after
             the crash.  Wall times, steps a second, steady bytes a step
             beside 4·|θ| for an FO gradient exchange, each worker's
             peak memory.
22. mesh   — the mesh layer at OPT-13B full width and depth (B 16,
             S 63), once no earlier weights are held.  ``make_zo_step``
             (the dry run's ``optimized`` config with the sweeps on K1,
             ``backend=pallas``; n_drop 30) 4 steps plain, then the same
             function over a 1 x 1 DTensor mesh on a one-rank NCCL group
             (``launch/specs.py::build_train_step``, leaves placed by
             ``distributed/sharding.py``): losses, projected gradients and
             every leaf's bit sum equal, K1/K2 launches as reckoned (K1 a
             leaf a sweep, K2 a layer a forward).  2 + 5 steady mesh
             steps: median wall against the plain step's (DTensor's host
             cost), device time and idle share (``torch.profiler``), peak
             memory.  Then the paged engine with the ``serve`` phase's
             settings and 16 requests, plain and then as
             ``Engine(mesh=...)`` over the same 1 x 1 mesh (parameters and
             the arena's pages placed on it): greedy tokens bit-equal, no
             K1-K4 launch (the engine's attention is plain, as the
             reference's), TTFT, tok/s and a steady decode step's wall,
             device time, idle share and kernels for each.  Beside them
             the dry run of the same train step on a fake
             1 x 1 mesh: device time must be at or above max(compute_s,
             memory_s), the predicted peak (arguments + temporaries)
             within +-10 % of the measured one, ``useful_flop_ratio`` at
             most 1.05.  K3 at fc1/fc2 and K4 at the tied head split into
             2, 4, 8 and 16 shards on N (``col_off``, ``ld = N``) and on K
             (``row_off``), launched shard after shard: column shards
             bit-equal to the unsharded launch's columns, row partial sums
             within n + 1 bf16 steps of it, each shard within one step of
             the plain ``pmatmul`` at its window, a shard's time against
             the unsharded time / n, its bound and ``torch.matmul`` at
             the shard's shape (the ``mesh_shapes`` rows).  Last, the
             grid entry point ``python -m repro_torch.launch dryrun --arch
             opt-13b`` at ``train_4k`` and ``decode_32k`` on the fake
             16 x 16 mesh: each cell's terms, dominant term and per-device
             GiB, and its seconds.  Before the dry run, over the same
             1 x 1 mesh, the zoo's MoE and Mamba configs, whose blocks
             take the tensor-parallel route (``ctx.tp_block``) with
             groups of one: deepseek-v2-lite-16b and granite-moe at full
             width and depth, jamba at full width and the deepest of
             ``SSM_PERIODS`` whose mesh run fits (3 periods deep first),
             3 steps of the same ``make_zo_step`` from the seed each,
             mesh then plain: losses, projected gradients and leaf bit
             sums equal, K1/K2 launches as reckoned, every MoE and Mamba
             layer on the TP route once a forward and on ``rowwise``
             never (``ctx.ROUTES``); the step wall, a profiled step's
             device time and kernels, and the peak, side by side.  Then
             jamba's lockstep prefill (4, 128) and 3 decode steps over
             placed caches against the plain lockstep (logits and tokens
             bit-equal, K2 a prefill's attention layers, each MoE and
             Mamba layer on the TP route once a forward), and granite's
             paged engine over 4 requests as ``Engine(mesh=...)`` against
             the plain engine (tokens bit-equal, no K1-K4 launch);
             deepseek-v2-lite's lockstep likewise over its latent cache
             (``ckv``/``kr`` on the sequence, K2 27 launches at dh =
             192), each lockstep's wall, device time and peak beside the
             plain one's.

For a quick kernel check: ``--phases build,rng,parity``.

Prints one JSON line of kernels, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when CUDA is unavailable or the port's sources are missing.
"""
import argparse
import contextlib
import dataclasses
import functools
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
    k2_sass = sass.disassemble(str(_build._target("flash_attn")))
    for dh in (128, 192):
        hmma = sass.count_ops(k2_sass, f"flash_fwd_kernelILi{dh}", "HMMA")
        log(f"[build] K2 SASS: flash_fwd_kernel<{dh}> holds {hmma} HMMA "
            "(tensor-core) instructions")
        if hmma == 0:
            raise SystemExit(f"build: flash_fwd_kernel<{dh}> runs no "
                             "tensor-core instruction")
    for fn, regs in ptxas_registers(reports.get("flash_attn", "")).items():
        log(f"[build] K2 {fn}: {regs}")
    return k1["per_element"]


def ptxas_registers(report):
    """``ptxas -v`` lines of each entry function of a build report:
    {demangled-ish name: "N registers, S bytes spill stores, ..."}."""
    import re
    out, fn = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"flash_fwd_kernelILi(\d+)E", m.group(1))
            fn = f"flash_fwd_kernel<{k.group(1)}>" if k else m.group(1)
        elif fn and ("registers" in ln or "spill" in ln):
            out[fn] = (out.get(fn, "") + "; " + ln.strip()).lstrip("; ")
    return out


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
    # The norm kernel at the cells' shapes: OPT-13B's LayerNorm over the
    # (B*S, D) activations and DeepSeek-V2-Lite's RMSNorm (16 x 255, 2048)
    rows["norm_rows"] = _norm_parity(g, M, D)
    torch.cuda.empty_cache()
    return rows


def _norm_parity(g, M, D):
    """The norm kernel against its plain float32 ops: bf16 results within
    one step on all but 0.01 % of elements (more only where x - mu
    cancels), all but 0.1 % equal; times and bytes bounds at OPT-13B's
    LayerNorm (M, D) and DeepSeek-V2-Lite's RMSNorm."""
    import torch
    from repro_torch.kernels import norm as knorm
    row = {}
    for tag, kind, shape in (("", "layer", (M, D)),
                             ("rms_", "rms", (16 * 255, 2048))):
        x = torch.randn(shape, generator=g, device="cuda",
                        dtype=torch.bfloat16)
        ps = tuple(1 + 0.1 * torch.randn((shape[-1],), generator=g,
                                         device="cuda")
                   for _ in range(2 if kind == "layer" else 1))
        fn, plain = ((knorm.layer_norm, knorm.layer_norm_plain)
                     if kind == "layer"
                     else (knorm.rms_norm, knorm.rms_norm_plain))
        got, want = fn(x, *ps), plain(x, *ps)
        ulps = bf16_ulps(got, want)
        off = (ulps > 0).float().mean().item()
        far = (ulps > 1).float().mean().item()
        if far > 1e-4 or off > 1e-3:
            raise SystemExit(f"norm_rows {kind} {shape}: {far:.2e} of "
                             f"elements past 1 ulp, {off:.2e} differ")
        nbytes = knorm.cost(x, ps)[1]
        row.update({
            f"{tag}max_abs_err": (got.float() - want.float()).abs().max(
            ).item(),
            f"{tag}ms": time_ms(lambda: fn(x, *ps), reps=100),
            f"{tag}plain_ms": time_ms(lambda: plain(x, *ps), reps=20),
            f"{tag}bound_ms": nbytes / H100_BYTES * 1e3,
            f"{tag}bound_by": "bytes"})
        log(f"[parity] norm_rows {kind} {shape} bf16: {off:.2e} of "
            f"elements differ, {far:.2e} past 1 ulp (at most "
            f"{ulps.max().item()}); {row[tag + 'ms']:.4f} ms, "
            f"plain {row[tag + 'plain_ms']:.4f} ms, bound "
            f"{row[tag + 'bound_ms']:.4f} ms (bytes)")
    row.update(library_ms=None, tolerance="bf16: all but 0.01 % of "
               "elements within 1 ulp of the plain float32 ops, all but "
               "0.1 % equal")
    return row


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
    from repro_torch.kernels import norm as knorm
    counters = {**_counters(), "norm_rows": knorm.counter}
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
            "pmatmul": 2 * spec.run.steps,
            # one launch a norm of the paired forward, both probes in it:
            # two a layer and the final norm; a norm that fell back to
            # the plain ops shows as a launch short
            "norm_rows": (2 * L + 1) * spec.run.steps}
    if launches != want:
        raise SystemExit(f"train: launches {launches} != expected {want}")
    k34 = launches["pmatmul_stack"] + launches["pmatmul"]
    log(f"[train] K3/K4 launches by load route: {routes}")
    if routes != {"tma": k34, "thread": 0}:
        raise SystemExit(f"train: K3/K4 routes {routes}: every launch of "
                         "the main path must load by TMA")
    return spec, cfg, hist["final_params"], launches


def probe_gap(spec, cfg, params, plant=1.0, batch=None, seed=None):
    """The virtual pair's losses (l+, l-) on ``params`` against the
    materialized probes' (kernel K1 perturbing in place, then undoing),
    and their relative differences; then l- of a materialized theta -
    plant * eps z made from the unperturbed weights (one bf16 rounding,
    as the virtual l- has; the probe above reaches it as theta + eps z -
    2 eps z, rounded twice) and its relative difference to the virtual
    l-.  ``plant`` != 1 offsets that probe on purpose, to show the gate
    on it firing.  ``batch`` and ``seed`` default to the first rows of
    the spec's dataset and a fixed seed.  The weights are put back bit
    for bit from a copy on the card."""
    import torch
    from repro_torch import fused
    from repro_torch.api import runners
    from repro_torch.core import rng, zo
    from repro_torch.data import synthetic
    from repro_torch.models import lm

    d = runners.derive(spec)
    if batch is None:
        data = synthetic.make_dataset(d.task, 64)
        batch = {k: torch.as_tensor(data[k][:spec.run.batch_size],
                                    device="cuda")
                 for k in ("tokens", "labels", "loss_mask")}
    zspec = zo.build_spec(params, lm.zo_group_fn)
    if seed is None:
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


def step_fn(spec, cfg, params):
    """``run(t)``: step ``t`` of ``spec``'s ZO step function on
    ``params`` and one batch on the card, outside the trainer."""
    import torch
    from repro_torch import estimators
    from repro_torch.api import runners
    from repro_torch.core import rng, zo
    from repro_torch.data import synthetic
    from repro_torch.models import frontends, lm

    d = runners.derive(spec)
    data = synthetic.make_dataset(d.task, 64)
    batch = {k: torch.as_tensor(data[k][:spec.run.batch_size], device="cuda")
             for k in ("tokens", "labels", "loss_mask")}
    if frontends.uses_embeds(cfg):             # the zoo runs' stub frames
        batch["embeds"] = frontends.stub_embeddings(
            cfg, *batch["tokens"].shape, seed=1).float()
    step, init = estimators.make_step(
        lambda p, b, perturb=None: lm.lm_loss(cfg, p, b, perturb=perturb),
        zo.build_spec(params, lm.zo_group_fn), d.est_cfg)
    base = rng.fold_py(spec.run.seed, 0xC0FFEE)
    return lambda t: step(params, init(), batch, t, base)


# A profiled window (``measure_window``): torch.profiler can lose the
# first records of a window, and the last ones of a long window (PERF.md
# §7).  So fills open the window and close it (``window_edge``), the
# device idles WINDOW_PAD seconds before it closes, a marker kernel
# (``torch.cuda._sleep``, WINDOW_MARK in the trace) opens every step and
# one more ends the last, ``window_check`` holds the records between the
# markers to each other and to the K1-K4 counters, and ``edge_losses``
# counts the fills each edge lost.
WINDOW_WARM = 1                  # first calls, before the window
WINDOW_EDGE, WINDOW_EDGE_BYTES = 1024, 16 << 20   # fills of 16 MiB
WINDOW_PAD = 0.05
WINDOW_TRIES = 2
WINDOW_MARK = "spin_kernel"
WINDOW_MARK_CYCLES = 1000
PORT_KERNELS = {"zo_axpy_2d_kernel": ("zo_axpy_2d",),       # trace name:
                "flash_fwd_kernel": ("flash_attention",),   # its counters
                "pmatmul_kernel": ("pmatmul_stack", "pmatmul")}


class WindowLost(SystemExit):
    """A profiled window whose records are not whole."""


def window_edge(buf):
    """One edge of a window: WINDOW_EDGE fills of ``buf`` (≈ 7 ms of
    device time at 16 MiB a fill), records the window may lose."""
    import torch
    for _ in range(WINDOW_EDGE):
        buf.zero_()
    torch.cuda.synchronize()


def device_record(e, labels=()):
    """Whether profiler event ``e`` is a device record (a kernel, copy or
    set) and not the device range of a host annotation (a label of
    ``labels``)."""
    return (str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and e.name not in labels)


def window_steps(records, steps):
    """A window's device record names in start order, split at the
    marker kernels into the ``steps`` steps they open (the last marker
    ends the last step; the records before the first and after the last
    are the window's edges): [[name, ...]].  Raises unless there are
    ``steps`` + 1 markers: the window lost a step's first or last
    records."""
    cuts = [i for i, n in enumerate(records) if WINDOW_MARK in n]
    if len(cuts) != steps + 1:
        raise WindowLost(f"window: {len(cuts)} markers for {steps} steps "
                         f"at records {cuts[:1]}..{cuts[-1:]} of "
                         f"{len(records)}: the profiler lost records")
    return [records[a + 1:b] for a, b in zip(cuts, cuts[1:])]


def edge_losses(records):
    """The fills a window's edges lost, (opening, closing): WINDOW_EDGE
    less its records (names in start order, every marker found) before
    the first marker and after the last."""
    cuts = [i for i, n in enumerate(records) if WINDOW_MARK in n]
    return WINDOW_EDGE - cuts[0], WINDOW_EDGE - (len(records) - 1 - cuts[-1])


WINDOW_ALIKE = ("equal", "steady")
WINDOWS = {"lost": [], "refused": 0}   # every window's edge_losses, refusals


def window_check(per_step, launched=None, alike="equal"):
    """Raise unless a window's records, ``per_step`` ([[name, ...]] by
    step, markers taken out), are whole.  ``alike`` says how its steps
    compare: "equal", each step holds every kernel name as often as the
    others do; "steady" (an engine's decode steps, where a step that
    opens a page may add kernels; 3 steps or more), at least as often as
    most steps do.  ``launched`` ({trace
    name: launches}, from the kernels' own counters, not from the
    profiler) must equal the window's records of those names.  Returns
    {name: count a step} from the first step."""
    import collections
    if alike not in WINDOW_ALIKE:
        raise ValueError(f"alike {alike!r} not in {WINDOW_ALIKE}")
    counts = [collections.Counter(s) for s in per_step]
    for name in set().union(*counts):
        got = [c[name] for c in counts]
        typical = collections.Counter(got).most_common(1)[0][0]
        if (min(got) < typical if alike == "steady"
                else len(set(got)) > 1):
            raise WindowLost(f"window: {name[:80]} recorded {got} times "
                             "by step: the profiler lost records")
    for key, n in (launched or {}).items():
        seen = sum(c[name] for c in counts for name in c if key in name)
        if seen != n:
            raise WindowLost(f"window: {seen} records of {key} against "
                             f"{n} launches counted: the profiler lost "
                             "records")
    return dict(counts[0])


def measure_window(tag, step, steps, *, start=0, cpu=False, alike="equal",
                   labels=(), warm=WINDOW_WARM):
    """``step(i)`` for ``i`` from ``start``: ``warm`` calls, then
    ``steps`` under one ``torch.profiler``, each opened by a marker
    kernel and closed by a synchronize, with a last marker after them and
    the window's edges around them (``window_edge`` at either end,
    WINDOW_PAD seconds of idle device before it closes); ``cpu`` adds
    host activity (the aten ops), ``labels`` are ``record_function``
    labels whose device ranges ``region_times`` reads.  The records
    between the markers are held to ``window_check`` (steps ``alike`` as
    it says, the K1-K4 counters beside them); a window that lost records
    is logged and measured again, up to WINDOW_TRIES windows, and the
    last one's loss raises.  Returns the device busy seconds and host
    wall seconds over the recorded steps, the idle share 1 - busy /
    wall, each step's wall, the kernels a step, (µs, count) by kernel
    name over the steps, and the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    counters = _counters()
    edge = torch.empty(WINDOW_EDGE_BYTES // 4, device="cuda")
    for k in range(warm):
        step(start + k)
    torch.cuda.synchronize()
    k = start + warm
    for attempt in range(WINDOW_TRIES):
        walls = []
        with profile(activities=acts) as prof:
            window_edge(edge)
            before = {n: c.launches for n, c in counters.items()}
            for k in range(k, k + steps):
                t = time.perf_counter()
                torch.cuda._sleep(WINDOW_MARK_CYCLES)
                step(k)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            torch.cuda._sleep(WINDOW_MARK_CYCLES)
            window_edge(edge)
            time.sleep(WINDOW_PAD)
        k += 1
        launched = {name: sum(counters[c].launches - before[c] for c in cs)
                    for name, cs in PORT_KERNELS.items()}
        evs = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                     for e in prof.events() if device_record(e, labels))
        try:
            per_step = window_steps([n for _, n, _ in evs], steps)
            window_check(per_step, launched, alike=alike)
            break
        except WindowLost as e:
            WINDOWS["refused"] += 1
            if attempt + 1 == WINDOW_TRIES:
                raise
            log(f"[{tag}] window {attempt + 1} of {WINDOW_TRIES}: {e}; "
                "measuring again")
    marks = [i for i, (_, n, _) in enumerate(evs) if WINDOW_MARK in n]
    by_name = {}
    for _, n, us in evs[marks[0] + 1:marks[-1]]:
        if WINDOW_MARK not in n:
            a, c = by_name.get(n, (0.0, 0))
            by_name[n] = (a + us, c + 1)
    busy = sum(us for us, _ in by_name.values()) / 1e6
    if busy == 0:
        raise SystemExit(f"{tag}: the window holds no device time")
    kernels = sum(c for _, c in by_name.values()) / steps
    wall = sum(walls)
    lost = edge_losses([n for _, n, _ in evs])
    WINDOWS["lost"].append(lost)
    log(f"[{tag}] window of {steps} steps: {time.perf_counter() - t0:.2f} "
        f"s in all, {wall:.2f} s of them in the recorded steps; the edges "
        f"lost {lost[0]} and {lost[1]} of {WINDOW_EDGE} fills")
    return {"busy": busy, "wall": wall, "walls": walls,
            "idle": 1 - busy / wall, "kernels": kernels, "steps": steps,
            "by_name": by_name, "prof": prof}


PROFILE_STEPS = 2                  # recorded steps of a profile


def phase_profile(spec, cfg, params, tag="profile", ops=False,
                  regions=None, alike="equal", steps=PROFILE_STEPS):
    """``steps`` more steps of ``spec`` (the main path's by default)
    under ``measure_window`` with host activity: device time by kernel,
    the kernels a step, and the device's idle share of the steps' wall
    time; with ``ops``, also the aten ops by the device time of the
    kernels they launched.  ``regions`` ({label: (module, function
    name)}) wraps each function in a ``record_function`` of its label for
    the profiled steps only and logs the device time of the kernels
    launched inside it; ``alike`` is ``measure_window``'s.  Figures are
    a step's."""
    from torch.profiler import record_function

    run = step_fn(spec, cfg, params)
    regions = regions or {}
    saved = {label: getattr(mod, name)
             for label, (mod, name) in regions.items()}

    def labelled(fn, label):
        def wrapped(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return wrapped
    for label, (mod, name) in regions.items():
        setattr(mod, name, labelled(saved[label], label))
    try:
        win = measure_window(tag, run, steps, start=spec.run.steps,
                             cpu=True, alike=alike, labels=tuple(regions))
    finally:
        for label, (mod, name) in regions.items():
            setattr(mod, name, saved[label])
    n = win["steps"]
    wall, busy, prof = win["wall"] / n, win["busy"] / n, win["prof"]
    log(f"[{tag}] step wall {wall:.3f} s, device busy {busy:.3f} s, "
        f"idle share {win['idle']:.3f}, {win['kernels']:g} kernels a step "
        f"({n} recorded steps)")
    for key, (us, span, calls) in region_times(prof, regions).items():
        log(f"[{tag}] region {key}: {us / n / 1e3:.3f} ms of kernel time "
            f"over {calls / n:g} calls ({span / n / 1e3:.3f} ms of "
            "device-side range) a step")
    log_kernels(tag, win)
    if ops:
        op_us = {}                   # an aten op's row repeats its kernels'
        for e in prof.key_averages():
            if e.key.startswith("aten::"):
                us = getattr(e, "device_time_total", None)
                op_us[e.key] = (e.cuda_time_total if us is None else us,
                                e.count)
        for key, (us, c) in sorted(op_us.items(),
                                   key=lambda kv: -kv[1][0])[:16]:
            log(f"[{tag}] op {us / n / 1e3:9.3f} ms {c / n:6g} x  {key} "
                "(device time of its kernels a step, nested ops included)")
    return wall, busy


def log_kernels(tag, win, top=12):
    """Log a window's ``top`` kernels by device time and each port
    kernel's time a launch, a step's figures."""
    n = win["steps"]
    for key, (us, c) in sorted(win["by_name"].items(),
                               key=lambda kv: -kv[1][0])[:top]:
        log(f"[{tag}] {us / n / 1e3:9.3f} ms {c / n:6g} x  {key[:150]}")
    for name in PORT_KERNELS:
        for key, (us, c) in win["by_name"].items():
            if name in key and c:
                log(f"[{tag}] per launch: {us / c / 1e3:.4f} ms over "
                    f"{c / n:g} a step x {key[:70]}")


def region_times(prof, labels):
    """Per ``record_function`` label of ``labels``: (kernel µs, device
    range µs, calls) in the trace ``prof``.  The device-side range of a
    label runs from its first kernel's start to its last's end; on the
    one stream every kernel inside a range was launched inside the
    label, so its kernel time is the sum of the kernels within the
    ranges (the profiler's nested ``device_time_total`` counts some
    kernels twice)."""
    import bisect
    ranges = {label: [] for label in labels}
    kernels = []
    for e in prof.events():
        iv = (e.time_range.start, e.time_range.end)
        if str(e.device_type).endswith("CUDA") and e.name in ranges:
            ranges[e.name].append(iv)
        elif device_record(e, labels):
            kernels.append(iv)
    kernels.sort()
    starts = [k[0] for k in kernels]
    out = {}
    for label, ivs in ranges.items():
        us = 0.0
        for a, b in ivs:
            i = bisect.bisect_left(starts, a)
            while i < len(kernels) and kernels[i][0] < b:
                us += min(kernels[i][1], b) - kernels[i][0]
                i += 1
        out[label] = (us, sum(b - a for a, b in ivs), len(ivs))
    return out


def expected_launches(spec, params, steps, cfg=None):
    """Launches by kernel that ``steps`` steps of ``spec`` must make on
    ``params`` (of ``cfg``, by default the spec's model), from
    ``costs.step_counts``, the model's weight matmuls a layer
    (``fmm.model_matmuls``: 6, or 7 with SwiGLU) and, for stacked
    one_sided probes, K3's probe groups of each layer's active probes
    (``fmm.probe_groups``).  ZO modes here run virtual and paired,
    momentum and the MoE/MLA and recurrent archs materialized (one K1
    launch a leaf a sweep, one K2 launch an attention layer a forward:
    none for a recurrent layer).  A swarm spec's sharded step runs the paired
    probe forward once a loss shard and one commit sweep."""
    from repro_torch import api, estimators
    from repro_torch.api.validate import swarm_active, swarm_shards
    from repro_torch.core import rng, zo
    from repro_torch.fused import matmul as fmm
    from repro_torch.models import lm

    d = api.derive(spec)
    cfg = cfg or d.model_cfg
    e, L = d.est_cfg, cfg.num_layers
    A = attention_layers(cfg)
    mm = len(fmm.model_matmuls(cfg)[0])
    zspec = zo.build_spec(params, lm.zo_group_fn)
    leaves = len(zspec.paths)
    base = rng.fold_py(spec.run.seed, 0xC0FFEE)
    mode = spec.optimizer.mode
    shards = swarm_shards(spec) if swarm_active(spec) else 1
    n = {"zo_axpy_2d": 0, "flash_attention": 0, "pmatmul_stack": 0,
         "pmatmul": 0}
    for t in range(steps):
        if mode == "fo":
            n["flash_attention"] += A
            continue
        if mode == "zo_momentum":   # probe, -2 eps, restore, t + 1 <= K
            n["zo_axpy_2d"] += leaves * (3 + min(8, t + 1))
            n["flash_attention"] += 2 * A
            continue
        if e.forward_backend == "materialized":   # K1 a leaf a sweep
            c = estimators.build_estimator(zspec, e).step_counts()
            n["zo_axpy_2d"] += leaves * c["axpy_sweeps"]
            n["flash_attention"] += A * c["forwards"]
            continue
        assert e.forward_backend == "virtual" and e.paired_probes
        est = estimators.build_estimator(zspec, e)
        n["zo_axpy_2d"] += leaves * est.step_counts()["axpy_sweeps"]
        inner = e.inner if e.name == "importance" else e.name
        if inner in ("two_point", "averaged"):     # one paired forward each
            pairs = (1 if inner == "two_point" else e.q) * shards
            n["flash_attention"] += L * pairs
            n["pmatmul_stack"] += mm * L * pairs
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
                n["pmatmul_stack"] += mm * (
                    1 if len(act) <= 2 else len(fmm.probe_groups(act)))
    return n


def attention_layers(cfg):
    """The layers that launch K2 in a forward: attn and MLA mixers."""
    return sum(st.repeat for st in cfg.stages for b in st.pattern
               if b.kind in ("attn", "mla"))


def run_counted(tag, spec, params=None, trainer=None, val_data=None,
                train_data=None):
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
    hist = (trainer.train(train_data=train_data, val_data=val_data)
            if trainer is not None
            else api.run(spec, params=params, train_data=train_data,
                         val_data=val_data)["history"])
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


def check_launches(tag, spec, params, launches, cfg=None):
    want = expected_launches(spec, params, spec.run.steps, cfg=cfg)
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
        if name == "fzoo-opt13b-q16":      # one recorded step of ≈ 2.7 s
            phase_profile(spec, cfg, params, tag="profile one_sided q=16",
                          steps=1)


# The mezo phase: the paper's baseline (``mezo-opt13b``, sparsity 0)
# beside LeZO on OPT-13B at full width and depth, under each forward
# backend, every run from the same weights and seed.
MEZO_STEPS = 4                               # 1 warm + 3 timed
MEZO_PRESETS = ("mezo-opt13b", "lezo-opt13b")
MEZO_BACKENDS = (("virtual", {}),
                 ("materialized", {"runtime.forward_backend":
                                   "materialized"}))
PAPER_SPEEDUP = "over 3x"                    # LeZO over MeZO (PAPER.md)


@contextlib.contextmanager
def tap_first_pair():
    """Record the first two-point estimate of a run beside it: its batch,
    its seed and (l+, l-).  A reading: the estimate runs as before."""
    from repro_torch.estimators import two_point
    seen = {}
    estimate = two_point.TwoPointSPSA.estimate

    def tapped(self, loss_fn, params, batch, seed, state=None):
        out = estimate(self, loss_fn, params, batch, seed, state)
        if not seen:
            seen.update(batch={k: v.clone() for k, v in batch.items()},
                        seed=seed, pair=[float(out[2]["l_plus"]),
                                         float(out[2]["l_minus"])])
        return out
    two_point.TwoPointSPSA.estimate = tapped
    try:
        yield seen
    finally:
        two_point.TwoPointSPSA.estimate = estimate


def mezo_counters(tag, spec, cfg, params, hist, runs):
    """The run's ``obs.trace`` counters against the reckoning: 2 probes,
    one selection and the estimator's axpy sweeps a step, K3/K4's W and
    z tiles (virtual) from the recorded layer selections, and the
    active-layer gauge and every step's selection at L - n_drop."""
    from repro_torch import api, estimators, obs
    from repro_torch.core import zo
    from repro_torch.models import lm

    d = api.derive(spec)
    steps = spec.run.steps
    rd = obs.load_run(hist["run_id"], runs)
    trace = obs.read_jsonl(os.path.join(rd.dir, obs.runlog.TRACE_FILE))
    last = [e for e in trace if e.get("type") == "counters"][-1]
    c, g = last["counters"], last["gauges"]
    est = estimators.build_estimator(zo.build_spec(params, lm.zo_group_fn),
                                     d.est_cfg)
    sels = [r["layer_sel"] for r in rd.steps]
    want = {obs.CTR_PROBES: 2 * steps, obs.CTR_SELECTS: steps,
            obs.CTR_AXPY: est.step_counts()["axpy_sweeps"] * steps}
    if d.est_cfg.forward_backend == "virtual":
        want[obs.CTR_WLOAD], want[obs.CTR_ZREGEN] = expected_tiles(
            cfg, spec, sels)
    active = cfg.num_layers - d.n_drop
    log(f"[{tag}] counters {c}; gauges {g}; active layers a step "
        f"{[sum(s) for s in sels]} (reckoned {active})")
    bad = {k: (c.get(k), v) for k, v in want.items() if c.get(k) != v}
    if (bad or g.get(obs.GAUGE_ACTIVE) != active or len(sels) != steps
            or any(sum(s) != active for s in sels)):
        raise SystemExit(f"{tag}: counters (got, want) {bad}; gauge "
                         f"{g}, selections {sels}, want {active} active")


def phase_mezo(hold, cfg):
    """MeZO (``mezo-opt13b``) and LeZO (``lezo-opt13b``) on OPT-13B at
    full width and depth with the main path's overrides, under the
    virtual paired forward and under the materialized probes, all four
    from the same weights (a copy on the card puts them back) and seed,
    ``MEZO_STEPS`` steps each through ``api.run`` with telemetry on:
    finite losses, launches as reckoned, the ``obs.trace`` counters and
    gauge (``mezo_counters``), and each MeZO run's first (l+, l-)
    against the probes of its own backend on the same weights, batch and
    seed (the virtual pair, or the materialized probes: within
    DIRECT_GAP) with the virtual l- against a materialized theta - eps z
    (``check``'s gate on it).  Read, not gated: the gap to the other
    backend's probes, step seconds, device time (``measure_window``),
    peak (less the copy), and MeZO / LeZO under each backend."""
    import statistics
    import tempfile
    import torch
    from repro_torch import api
    from repro_torch.core import zo

    params = full_params(hold, cfg)
    start = [t.clone() for _, t in zo.leaf_items(params)]
    held = sum(t.numel() * t.element_size() for t in start) / 2 ** 30

    def restore():
        with torch.no_grad():
            for (_, t), t0 in zip(zo.leaf_items(params), start):
                t.copy_(t0)
    runs = tempfile.mkdtemp(prefix="chip_smoke_mezo_")
    walls = {}
    try:
        for backend, over in MEZO_BACKENDS:
            for name in MEZO_PRESETS:
                tag = f"mezo {name} {backend}"
                spec = api.with_overrides(api.preset(name), {
                    **MAIN_OVERRIDES, **over, "run.steps": MEZO_STEPS,
                    "telemetry.enabled": True, "telemetry.runs_dir": runs})
                restore()
                with tap_first_pair() as first:
                    hist, n, peak = run_counted(tag, spec, params)
                check_launches(tag, spec, params, n)
                mezo_counters(tag, spec, cfg, params, hist, runs)
                secs = hist["step_seconds"][1:]
                walls[name, backend] = statistics.median(secs)
                win = measure_window(tag, step_fn(spec, cfg, params), 2,
                                     start=MEZO_STEPS)
                log(f"[{tag}] {smi('name,power.limit')}: step_seconds "
                    f"{stats(secs)}; device {win['busy'] / win['steps']:.4f} "
                    f"s a step, idle share {win['idle']:.4f}, "
                    f"{win['kernels']:g} kernels a step; peak "
                    f"{peak - held:.2f} GiB (less the {held:.2f} GiB copy "
                    f"of the start); launches {n}")
                if name != MEZO_PRESETS[0]:
                    continue
                restore()                     # the weights its step 0 saw
                gc.collect()                  # the probes copy all 40 layers
                torch.cuda.empty_cache()
                pair, mat, rel, direct, gap = probe_gap(
                    spec, cfg, params, batch=first["batch"],
                    seed=first["seed"])
                same = mat if backend == "materialized" else pair
                other = pair if backend == "materialized" else mat
                rs = [abs(a - b) / abs(b) for a, b in zip(first["pair"],
                                                          same)]
                ro = [abs(a - b) / abs(b) for a, b in zip(first["pair"],
                                                          other)]
                # read, not gated: the materialized l- is theta + eps z -
                # 2 eps z rounded twice on all 40 layers, and its gap to
                # the virtual l- grows with the weights (check's 1e-2 is
                # LeZO's 10 layers); theta - eps z, rounded once, is gated
                log(f"[{tag}] step 0 (l+, l-) {first['pair']}; on the same "
                    f"weights, batch and seed: virtual pair {pair}, "
                    f"materialized {mat}: rel diff to its own kind {rs}, to "
                    f"the other {ro}; theta - eps z rel diff {gap}")
                if max(rs) > DIRECT_GAP or not direct_gate(gap):
                    raise SystemExit(f"{tag}: step 0's probe losses "
                                     "outside the check phase's gates")
        restore()
    finally:
        shutil.rmtree(runs, ignore_errors=True)
    del start
    for backend, _ in MEZO_BACKENDS:
        m, z = (walls[p, backend] for p in MEZO_PRESETS)
        log(f"[mezo] {backend}: MeZO / LeZO step wall median {m:.4f} / "
            f"{z:.4f} s = {m / z:.2f}x (the paper, on its own hardware: "
            f"{PAPER_SPEEDUP})")


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


# The serve phase: the port's serving path at OPT-13B full width and
# depth.  The engine's settings (``spec.serving``), its 16 requests
# (prompt lengths from the seed in 64-700, 8 of them sharing a 512-token
# prefix) and the lockstep batch.  Engine against lockstep: the first
# token's logits within SERVE_LOGIT_STEPS bf16 steps (``close``), the
# prediction written before the first chip run; token streams equal, or
# the first difference explained by a near-tie (the lockstep's top-2 gap
# below the measured max |delta logits| there).
SERVE_OVERRIDES = {
    "serving.page_size": 16, "serving.prefill_chunk": 256,
    "serving.max_lanes": 8, "serving.max_seq": 1024, "serving.n_pages": 513,
    "serving.max_new_tokens": 32}
SERVE_REQUESTS, SERVE_SHARED, SERVE_PREFIX = 16, 8, 512
SERVE_LOCKSTEP = (4, 1024, 32)       # batch, prompt, new tokens
SERVE_LOGIT_STEPS = 16
SEED_BASE = 1000                     # request seeds; inactive lanes are 0


def serve_requests(vocab, seed=0, n=SERVE_REQUESTS, shared=SERVE_SHARED):
    """(rid, tokens) of ``n`` requests: the first ``shared`` even rids
    share a 512-token prefix and run to 513-700 tokens, the others
    64-700."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, SERVE_PREFIX).tolist()
    reqs = []
    for rid in range(n):
        if rid % 2 == 0 and rid // 2 < shared:
            n = int(rng.integers(SERVE_PREFIX + 1, 701))
            toks = prefix + rng.integers(0, vocab,
                                         n - SERVE_PREFIX).tolist()
        else:
            toks = rng.integers(0, vocab, int(rng.integers(64, 701))
                                ).tolist()
        reqs.append((rid, toks))
    return reqs


def tap_sampler(engine, keep):
    """Record every (logits, seeds, positions) the engine's sampler sees,
    on the device (no sync), and return a function that maps (seed,
    position of the sampled token) to its logits row, for the seeds in
    ``keep``.  A reading beside the run: the engine samples as before."""
    import torch
    seen, sample = [], engine._sample

    def tapped(logits, seeds, positions):
        seen.append((logits.clone(), seeds.clone(), positions.clone()))
        return sample(logits, seeds, positions)
    engine._sample = tapped

    def rows():
        out = {}
        for logits, seeds, positions in seen:    # later calls win: a
            s, p = seeds.tolist(), positions.tolist()  # final chunk
            for i, (si, pi) in enumerate(zip(s, p)):   # after its others
                if si in keep:
                    out[(si, pi)] = logits[i].float().cpu()
        return out
    return rows


def lockstep_logits(cfg, params, tokens, steps):
    """The lockstep path's logits for ``steps`` tokens of one prompt
    (``lm.prefill`` then ``lm.serve_step``, the calls ``generate`` makes,
    at batch 1), greedy."""
    import torch
    from repro_torch.models import lm
    S = len(tokens)
    toks = torch.tensor([tokens], device="cuda")
    logits, caches = lm.prefill(cfg, params, toks, max_seq=S + steps + 1)
    out = [logits[0].float().cpu()]
    for i in range(steps - 1):
        tok = torch.argmax(logits, -1)[:, None]
        logits, caches = lm.serve_step(cfg, params, caches, tok, S + i)
        out.append(logits[0].float().cpu())
    del caches
    return out


def serve_engine(cfg, params, spec, session=None):
    from repro_torch import serving
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    return serving.Engine(cfg, params, spec.serving, obs=session,
                          device="cuda")


def drain(engine, reqs, late=(), after=0):
    """``engine.run`` of ``reqs``, the ``late`` ones submitted after
    ``after`` steps: tokens by rid, results, wall seconds."""
    import torch
    t = time.perf_counter()
    results = []
    for r in reqs:
        engine.submit(r)
    for _ in range(after if late else 0):
        results.extend(engine.step())
    results.extend(engine.run(list(late)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return {r.rid: r.tokens for r in results}, results, wall


def serve_plain_ops(cfg, spec):
    """The serving path's plain operations (no TPU kernel stands behind
    them: the reference computes them with ``einsum`` and XLA gathers) at
    the engine's and the lockstep's shapes, one layer: time on the card
    and the bytes bound (each input read once, each output written
    once)."""
    import torch
    from repro_torch.models import layers
    from repro_torch.serving import sampling
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(77)
    sv = spec.serving
    KV, dh, V = cfg.n_kv_heads, cfg.head_dim, cfg.vocab
    B, W, psz = sv.max_lanes, sv.max_seq // sv.page_size, sv.page_size
    arena = torch.randn((sv.n_pages, psz, KV, dh), generator=g, device=dev,
                        dtype=bf)
    pages = torch.randperm(sv.n_pages - 1, generator=g, device=dev)[
        :B * W].reshape(B, W) + 1
    kg = arena[pages].reshape(B, -1, KV, dh)
    q1 = torch.randn((B, 1, KV, 1, dh), generator=g, device=dev, dtype=bf)
    pos = torch.full((B,), sv.max_seq - 1, device=dev)
    qc = torch.randn((1, sv.prefill_chunk, KV, 1, dh), generator=g,
                     device=dev, dtype=bf)
    cpos = (sv.max_seq - sv.prefill_chunk
            + torch.arange(sv.prefill_chunk, device=dev))[None]
    flat = (pages[:, -1] * psz + psz - 1)
    new = torch.randn((B, KV, dh), generator=g, device=dev, dtype=bf)
    Bl, Sl = SERVE_LOCKSTEP[0], SERVE_LOCKSTEP[1] + SERVE_LOCKSTEP[2] + 1
    kc = torch.randn((Bl, Sl, KV, dh), generator=g, device=dev, dtype=bf)
    ql = torch.randn((Bl, 1, KV, 1, dh), generator=g, device=dev, dtype=bf)
    logits = torch.randn((B, V), generator=g, device=dev)
    seeds = torch.arange(B, device=dev) + 1
    greedy = sampling.make_sampler(0.0, 0)
    topk = sampling.make_sampler(0.8, 50)
    kv_b = kg.numel() * 2
    ops = [
        ("arena gather (decode: K or V of 8 lanes x 64 pages)",
         lambda: arena[pages], 2 * kv_b),
        ("arena scatter (decode: 8 slots, index_copy_)",
         lambda: arena.view(-1, KV, dh).index_copy_(0, flat, new),
         2 * new.numel() * 2 + flat.numel() * 8),
        ("paged_attention decode (8, 1) over 1024",
         lambda: layers.paged_attention(q1, kg, kg, pos[:, None]),
         2 * kv_b + 2 * q1.numel() * 2),
        ("paged_attention prefill chunk (1, 256) over 1024",
         lambda: layers.paged_attention(qc, kg[:1], kg[:1], cpos),
         2 * kg[:1].numel() * 2 + 2 * qc.numel() * 2),
        (f"decode_attention lockstep ({Bl}, 1) over {Sl}",
         lambda: layers.decode_attention(ql, kc, kc, Sl),
         2 * kc.numel() * 2 + 2 * ql.numel() * 2),
        ("sampler greedy (8, 50272)",
         lambda: greedy(logits, seeds, seeds), logits.numel() * 4),
        ("sampler T=0.8 top-k 50 (8, 50272)",
         lambda: topk(logits, seeds, seeds), logits.numel() * 4),
    ]
    out = []
    for name, fn, nbytes in ops:
        ms = time_ms(fn, reps=20)
        b_ms, _ = bound(nbytes)
        out.append({"op": name, "ms": ms, "bound_ms": b_ms})
        log(f"[serve] plain op {name}: {ms:.4f} ms a layer, bytes bound "
            f"{b_ms:.4f} ms")
    return out


def engine_vs_lockstep(tag, cfg, params, spec, reqs, base, tapped, check,
                       gate=True, plain=False):
    """Requests ``check`` of an engine run (tokens ``base``, sampler rows
    ``tapped``) against ``generate`` at batch 1: first-token logits within
    ``SERVE_LOGIT_STEPS`` bf16 steps, and the streams equal or parting
    at a near-tie (the lockstep's top-2 gap below max |dlogits|);
    ``gate=False`` reads the same without failing.  ``plain`` also runs
    the lockstep prefill once more with K2's plain version called in the
    model (a diagnostic, on no serving path) and prints the engine's
    first-token gap against both lockstep runs and theirs to each
    other.  Returns the worst gap, or with ``plain`` (worst, worst
    against the plain lockstep, worst between the two lockstep runs)."""
    import torch
    from repro_torch.launch import serve as serve_mod
    gc.collect()
    torch.cuda.empty_cache()
    worst = worst_plain = worst_k2 = 0.0
    for rid in check:
        prompt = reqs[rid][1]
        n = spec.serving.max_new_tokens
        ls = serve_mod.generate(cfg, params, torch.tensor(
            [prompt], device="cuda"), n, max_seq=len(prompt) + n + 1)[0]
        ls = ls.tolist()
        ls_logits = lockstep_logits(cfg, params, prompt, 1)[0]
        en_logits = tapped[(SEED_BASE + rid, len(prompt))]
        steps = bf16_steps(en_logits, ls_logits)
        worst = max(worst, steps)
        if plain:
            with plain_k2():
                pl_logits = lockstep_logits(cfg, params, prompt, 1)[0]
            to_plain = bf16_steps(en_logits, pl_logits)
            k2_plain = bf16_steps(ls_logits, pl_logits)
            worst_plain = max(worst_plain, to_plain)
            worst_k2 = max(worst_k2, k2_plain)
            log(f"[{tag}] rid {rid} first-token logits: engine against the "
                f"K2 lockstep {steps:.2f} bf16 steps, against the lockstep "
                f"with K2's plain version {to_plain:.2f} (max|d| "
                f"{(en_logits - pl_logits).abs().max().item():.3e}); the "
                f"two lockstep runs {k2_plain:.2f} apart")
        if gate:
            close(en_logits, ls_logits, f"{tag}: rid {rid} first-token "
                  "logits, engine against lockstep", steps=SERVE_LOGIT_STEPS)
        first = next((t for t in range(n) if ls[t] != base[rid][t]), None)
        msg = (f"[{tag}] rid {rid} (prompt {len(prompt)}): first-token "
               f"logits {steps:.2f} bf16 steps apart (max|d| "
               f"{(en_logits - ls_logits).abs().max().item():.3e}); ")
        if first is None:
            log(msg + f"all {n} tokens equal")
            continue
        lsl = lockstep_logits(cfg, params, prompt, first + 1)[first]
        enl = tapped[(SEED_BASE + rid, len(prompt) + first)]
        gap = (lsl.topk(2).values[0] - lsl.topk(2).values[1]).item()
        delta = (enl - lsl).abs().max().item()
        log(msg + f"tokens differ first at step {first}: max|dlogits| "
            f"{delta:.4e}, lockstep top-2 gap {gap:.4e}")
        if gate and not gap < delta:
            raise SystemExit(f"{tag}: rid {rid} engine and lockstep differ "
                             f"at step {first} without a near-tie (gap "
                             f"{gap:.4e} >= max|dlogits| {delta:.4e})")
    log(f"[{tag}] engine against lockstep: worst first-token gap "
        f"{worst:.2f} bf16 steps (gate "
        f"{SERVE_LOGIT_STEPS if gate else 'none: a reading'})")
    if plain:
        log(f"[{tag}] engine against the lockstep with K2's plain version: "
            f"worst {worst_plain:.2f} bf16 steps; K2's lockstep against "
            f"the plain one: worst {worst_k2:.2f}")
        return worst, worst_plain, worst_k2
    return worst


def profile_one(tag, fn, what, steps=PROFILE_STEPS, alike="equal"):
    """``fn()``, which its caller has run before, under
    ``measure_window`` with host activity, ``steps`` recorded calls
    (``alike`` as that takes it): a call's wall and device busy ms, the
    device kernels by time and the aten ops that launched them.  Returns
    a call's (wall, busy) seconds and the kernels it ran."""
    win = measure_window(tag, lambda i: fn(), steps, cpu=True, alike=alike,
                         warm=0)
    n = win["steps"]
    one, busy = win["wall"] / n, win["busy"] / n
    log(f"[{tag}] profile of {what}: wall {one * 1e3:.2f} ms, device busy "
        f"{busy * 1e3:.2f} ms, {win['kernels']:g} kernels (a call of "
        f"{n} recorded)")
    log_kernels(tag, win)
    op_us = {}
    for e in win["prof"].key_averages():
        if e.key.startswith("aten::"):     # the ops that launched them
            us = getattr(e, "device_time_total", None)
            op_us[e.key] = (e.cuda_time_total if us is None else us,
                            e.count)
    for key, (us, c) in sorted(op_us.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"[{tag}] op {us / n / 1e3:9.3f} ms {c / n:6g} x  {key} (device "
            "time of its kernels a call, nested ops included)")
    return one, busy, win["kernels"]


def decode_profile(tag, eng, reqs, spec):
    """A steady decode step of ``eng``: every lane decoding (64-token
    prompts of ``reqs``), no admission, no retirement; 3 steps under
    ``profile_one``, then the idle share over 10 (``measure_window``,
    steps alike as "steady": a step that opens a page may add kernels).  Returns the 10 steps' wall
    and device ms a step, idle share and kernels a step."""
    from repro_torch import serving
    steady = [serving.Request(rid=100 + i, tokens=reqs[i][1][:64],
                              max_new_tokens=96, seed=SEED_BASE + 100 + i)
              for i in range(spec.serving.max_lanes)]
    for r in steady:
        eng.submit(r)
    while eng.sched.prefilling() or eng.sched.queue:
        eng.step()
    for _ in range(2):
        eng.step()                                        # warm
    profile_one(tag, eng.step, f"one steady decode step "
                f"({spec.serving.max_lanes} lanes)", steps=3, alike="steady")
    win = measure_window(tag, lambda i: eng.step(), 10, alike="steady",
                         warm=0)
    wall10, busy, kernels = win["wall"], win["busy"], win["kernels"]
    log(f"[{tag}] 10 steady decode steps: wall {wall10:.3f} s "
        f"({wall10 * 100:.2f} ms a step), device busy {busy:.3f} s, idle "
        f"share {win['idle']:.3f}, {kernels:g} kernels a step")
    return {"step_ms": wall10 * 100, "device_ms": busy * 100,
            "idle": 1 - busy / wall10, "kernels": kernels}


def phase_serve(hold, cfg):
    """The serving path at OPT-13B full width and depth on the weights of
    the earlier phases (or from a seed).  Lockstep ``generate`` at batch
    4, prompt 1024, 32 tokens (K2 launches = the 40 layers, K2 against
    its plain version on that prefill's last inputs); the engine over 16
    requests, sharing off (a), on (b), and with priorities and
    preemption (c), (b) and (c) bit-equal to (a); 4 requests against the
    lockstep at batch 1; TTFT, decode and prefill ms, tok/s, memory; the
    plain operations' times; a profile of a steady decode step and the
    idle share over 10.  Returns K2's ``serve_shapes`` rows."""
    import statistics

    import torch
    import torch.nn.functional as F
    from repro_torch import api, obs, serving
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.launch import serve as serve_mod

    params = full_params(hold, cfg)
    spec = api.with_overrides(api.preset("lezo-opt13b"), {
        **MAIN_OVERRIDES, **SERVE_OVERRIDES})
    api.validate(spec)
    L, V = cfg.num_layers, cfg.vocab
    gen = torch.Generator(device="cpu").manual_seed(spec.run.seed)

    # -- lockstep: generate at batch 4, prompt 1024, 32 new tokens
    Bl, Sl, Gl = SERVE_LOCKSTEP
    toks = torch.randint(0, V, (Bl, Sl), generator=gen).cuda()
    last = {}

    def capture(q, k, v, **kw):
        last.update(q=q, k=k, v=v, kw=kw)
        return kernel(q, k, v, **kw)
    kernel = kfa.flash_attention
    with swap_k2(capture):
        out, launches, peak, wall = counted(lambda: serve_mod.generate(
            cfg, params, toks, Gl, max_seq=Sl + Gl + 1))
    log(f"[serve] lockstep generate ({Bl}, {Sl}) + {Gl}: {wall:.3f} s, "
        f"{Bl * Gl / wall:.1f} tok/s, peak {peak:.2f} GiB, launches "
        f"{launches}")
    if launches != {"zo_axpy_2d": 0, "flash_attention": L,
                    "pmatmul_stack": 0, "pmatmul": 0}:
        raise SystemExit(f"serve: lockstep launches {launches}, want K2 "
                         f"= {L} (one a layer of the prefill) and no other")
    if tuple(out.shape) != (Bl, Gl) or not bool(
            ((out >= 0) & (out < V)).all()):
        raise SystemExit(f"serve: lockstep tokens {tuple(out.shape)} out "
                         "of shape or vocabulary")
    q, k, v, kw = last["q"], last["k"], last["v"], last["kw"]
    err = close(kfa.flash_attention(q, k, v, **kw),
                kfa.flash_attention_plain(q, k, v, **kw),
                "flash_attention lockstep prefill")
    H, dh = q.shape[2], q.shape[-1]
    qs, ks, vs = (t.reshape(Bl, Sl, H, dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    b_ms, b_by = bound(4 * q.numel() * 2,
                       tensor_flops=4.0 * Bl * H * dh * (Sl * (Sl + 1) // 2))
    k2_row = dict(
        shape=f"lockstep prefill: {tuple(q.shape)}, the last layer's "
              "inputs", launches=launches["flash_attention"],
        max_abs_err=err, tolerance=CLOSE_TOL,
        ms=time_ms(lambda: kfa.flash_attention(q, k, v, **kw), reps=20),
        plain_ms=time_ms(lambda: kfa.flash_attention_plain(q, k, v, **kw),
                         reps=2),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), reps=20))
    log(f"[serve] K2 at the lockstep prefill {tuple(q.shape)}: max|err| "
        f"{err:.3e}; {k2_row['ms']:.4f} ms, plain {k2_row['plain_ms']:.3f} "
        f"ms, SDPA {k2_row['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by})")
    del q, k, v, qs, ks, vs, last, out, toks

    # -- the engine: (a) sharing off, timed under fenced spans, with the
    # sampler tapped for the engine-against-lockstep check
    reqs = serve_requests(V, seed=spec.run.seed)
    check = [0, 1, 2, 3]                 # two shared-prefix, two not
    def mk(high=0):                    # the last ``high`` at priority 1
        return [serving.Request(rid=rid, tokens=t, seed=SEED_BASE + rid,
                                priority=int(rid >= len(reqs) - high))
                for rid, t in reqs]
    sess = obs.session(api.Telemetry(enabled=True, fence=True, ring=8192))
    eng = serve_engine(cfg, params, spec, sess)
    arena_gib = sum(t.numel() * t.element_size()
                    for b in eng.arena.values() for lv in b.values()
                    for t in lv.values()) / 2 ** 30
    sample = eng._sample
    rows = tap_sampler(eng, {SEED_BASE + r for r in check})
    (base, results, wall), launches, _, _ = counted(
        lambda: drain(eng, mk()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if launches != {n: 0 for n in launches}:
        raise SystemExit(f"serve: engine launches {launches}: its "
                         "attention is plain PyTorch, as the reference's")
    ttft = sorted(r.ttft for r in results)
    n_tok = sum(len(t) for t in base.values())
    dec = [r.dt * 1e3 for r in sess.ring.spans(obs.SERVE_DECODE)]
    pre = [r.dt * 1e3 for r in sess.ring.spans(obs.SERVE_PREFILL)]
    log(f"[serve] engine (a) sharing off: {len(results)} requests, "
        f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; "
        f"{eng.n_prefill_calls} prefill calls, {eng.n_decode_steps} decode "
        f"steps, {eng.n_compiles()} compiles; TTFT median "
        f"{statistics.median(ttft):.3f} s, p90 "
        f"{ttft[int(0.9 * (len(ttft) - 1))]:.3f} s; decode step median "
        f"{statistics.median(dec):.2f} ms (fenced span, {len(dec)} "
        f"steps), prefill chunk median {statistics.median(pre):.2f} ms "
        f"({len(pre)} chunks); peak {peak:.2f} GiB, arena "
        f"{arena_gib:.2f} GiB")
    if (sorted(base) != list(range(SERVE_REQUESTS)) or eng.n_compiles() != 2
            or any(len(t) != spec.serving.max_new_tokens
                   or not all(0 <= x < V for x in t)
                   for t in base.values())):
        raise SystemExit(f"serve: engine (a) results {sorted(base)}, "
                         f"{eng.n_compiles()} compiles")
    if eng.pool.in_use:
        raise SystemExit(f"serve: (a) left {eng.pool.in_use} pages in use")
    eng.pool.check_invariants()
    tapped = rows()
    eng._sample = sample

    decode_profile("serve", eng, reqs, spec)
    eng.run([])
    sess.close()
    plain_ops = serve_plain_ops(cfg, spec)
    del eng, sess

    # (b) prefix sharing, (c) priorities and preemption: tokens bit-equal
    for tag, over, late in (
            ("(b) prefix_cache", {"serving.prefix_cache": True}, 0),
            ("(c) priorities=2 preempt", {"serving.priorities": 2,
                                          "serving.preempt": True}, 4)):
        sp = api.with_overrides(spec, over)
        api.validate(sp)
        eng = serve_engine(cfg, params, sp)
        all_reqs = mk(high=late)
        got, _, wall = drain(eng, all_reqs[:len(all_reqs) - late],
                             late=all_reqs[len(all_reqs) - late:], after=8)
        sched = eng.sched
        log(f"[serve] engine {tag}: {wall:.3f} s, {eng.n_prefill_calls} "
            f"prefill calls, {eng.n_decode_steps} decode steps, "
            f"{eng.n_compiles()} compiles, page hit rate "
            f"{sched.page_hit_rate:.3f}, {sched.cow_copies} COW copies, "
            f"{sched.preemptions} preemptions")
        diff = sorted(r for r in base if got.get(r) != base[r])
        if diff:
            raise SystemExit(f"serve: engine {tag} tokens differ from (a) "
                             f"for rids {diff}")
        if eng.n_compiles() != 2:
            raise SystemExit(f"serve: {tag} ran {eng.n_compiles()} shapes")
        if late and not sched.preemptions:
            raise SystemExit(f"serve: {tag} preempted nothing")
        if not late and not sched.page_hit_rate > 0:
            raise SystemExit(f"serve: {tag} shared no page")
        if sched.trie is not None:
            sched.trie.evict(sched.trie.reclaimable())
            sched.trie.check_invariants()
        if eng.pool.in_use:
            raise SystemExit(f"serve: {tag} left {eng.pool.in_use} pages")
        eng.pool.check_invariants()
        del eng

    # engine against lockstep, 4 requests at batch 1, with the lockstep
    # prefill also run through K2's plain version (a diagnostic: does the
    # gap close when both paths run plain attention?)
    gaps = engine_vs_lockstep("serve", cfg, params, spec, reqs, base,
                              tapped, check, plain=True)
    k2_row["engine_gap_bf16_steps"] = dict(zip(
        ("to_k2_lockstep", "to_plain_lockstep", "k2_to_plain_lockstep"),
        gaps))
    k2_row["plain_ops"] = plain_ops
    return [k2_row]


# The zoo phase: the dense model zoo (every attn + dense config) on the
# card, each at its published depth and full width.  Qwen3-14B (GQA with
# G = 5, qk-norm, rope, SwiGLU, an untied (5120, 151936) head) is also
# checked against the materialized probes and served; deepseek-coder-33b
# takes 2 steps (its peak).
ZOO_ARCH = "qwen3-14b"
ZOO_DENSE = ("codeqwen1.5-7b", "internlm2-1.8b", "musicgen-large",
             "internvl2-2b")
ZOO_BIG = "deepseek-coder-33b"
ZOO_STEADY = 6                           # steady steps after TRACE_WARM
ZOO_WINDOW = 2                           # steps a profiled window
ZOO_REQUESTS, ZOO_SHARED = 8, 4          # engine requests; sharing a prefix
ZOO_LATE, ZOO_AFTER = 4, 8               # the last 4 arrive after 8 steps
ZOO_CHECK = (0, 1)                       # against lockstep at batch 1


def zoo_spec(arch, **over):
    """The main path's spec on ``arch`` at full width and depth."""
    from repro_torch import api
    return api.with_overrides(api.preset("lezo-opt13b"), {
        **MAIN_OVERRIDES, "model.arch": arch, **over})


def zoo_row(out, kernel, shape, run, fn, plain, lib, err, tol, nbytes,
            flops=0.0, insns=0.0, plain_reps=1, reps=20):
    """Time ``fn`` (the kernel), ``plain`` and ``lib`` and append the row
    of ``kernel`` at ``shape`` to ``out``; ``run`` names the zoo run that
    launches the kernel at this shape, whose count the row takes."""
    b_ms, b_by = bound(nbytes, tensor_flops=flops, instructions=insns)
    r = dict(shape=shape, run=run, max_abs_err=err, tolerance=tol,
             ms=time_ms(fn, reps=reps),
             plain_ms=time_ms(plain, reps=plain_reps),
             bound_ms=b_ms, bound_by=b_by,
             library_ms=None if lib is None else time_ms(lib, reps=reps))
    out[kernel].append(r)
    lib_s = "none" if lib is None else f"{r['library_ms']:.4f} ms"
    log(f"[zoo] {kernel} {shape}: max|err| {err:.3e}; {r['ms']:.4f} ms, "
        f"plain {r['plain_ms']:.3f} ms, library {lib_s}, bound "
        f"{b_ms:.4f} ms ({b_by})")


def zoo_k2(out, g, B, S, KV, G, dh, run):
    """K2 against its plain version on the paired forward's attention
    (2B, S) at G query heads a KV head, SDPA with ``enable_gqa`` beside:
    one ``flash_attention`` row of ``out`` for the zoo run ``run``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as kfa
    dev, bf = torch.device("cuda"), torch.bfloat16
    q = torch.randn((2 * B, S, KV, G, dh), generator=g, device=dev, dtype=bf)
    k = torch.randn((2 * B, S, KV, dh), generator=g, device=dev, dtype=bf)
    v = torch.randn((2 * B, S, KV, dh), generator=g, device=dev, dtype=bf)
    err = close(kfa.flash_attention(q, k, v, causal=True),
                kfa.flash_attention_plain(q, k, v, causal=True),
                f"flash_attention {tuple(q.shape)}")
    qs = q.reshape(2 * B, S, KV * G, dh).transpose(1, 2).contiguous()
    ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
    zoo_row(out, "flash_attention", f"q {tuple(q.shape)}, G = {G}", run,
            lambda: kfa.flash_attention(q, k, v, causal=True),
            lambda: kfa.flash_attention_plain(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True),
            err, CLOSE_TOL, (2 * q.numel() + k.numel() + v.numel()) * 2,
            flops=4.0 * 2 * B * KV * G * dh * (S * (S + 1) // 2),
            plain_reps=2, reps=50)


def zoo_k3(out, g, eps, name, K, N, M, run):
    """K3 against its plain version on x (2, M, K) @ W (K, N), both
    probes active, ``torch.matmul`` beside: one ``pmatmul_stack`` row."""
    import torch
    from repro_torch.fused import matmul as fmm
    from repro_torch.fused import ref as fref
    dev, bf = torch.device("cuda"), torch.bfloat16
    args = ((0xBEEF, 0xBEEF), (eps, -eps), (True, True))
    x = torch.randn((2, M, K), generator=g, device=dev, dtype=bf)
    w = torch.randn((K, N), generator=g, device=dev, dtype=bf) * K ** -0.5
    err = close(fmm.pmatmul_stack(x, w, *args),
                fref.pmatmul_stack(x, w, *args),
                f"pmatmul_stack {name} ({K}, {N})")
    zoo_row(out, "pmatmul_stack", f"{name}: x (2, {M}, {K}) @ W ({K}, {N})",
            run, lambda: fmm.pmatmul_stack(x, w, *args),
            lambda: fref.pmatmul_stack(x, w, *args),
            lambda: torch.matmul(x, w), err, CLOSE_TOL,
            (x.numel() + w.numel() + 2 * M * N) * 2,
            flops=2.0 * 2 * M * K * N, insns=K * N * RNG_OPS)


def zoo_k4(out, g, eps, tag, B, S, Dh, Vh, run):
    """K4 against its plain version on an untied head h (B, S, Dh) @ W
    (Dh, Vh) read as stored (``trans=False``), ``torch.matmul`` beside;
    the launch must load by TMA, or by per-thread loads where a row of
    W is not 16-byte aligned (an odd vocabulary): one ``pmatmul`` row."""
    import torch
    from repro_torch.fused import matmul as fmm
    from repro_torch.fused import ref as fref
    dev, bf = torch.device("cuda"), torch.bfloat16
    route = "thread" if (Vh * 2) % 16 else "tma"
    h = torch.randn((B, S, Dh), generator=g, device=dev, dtype=bf)
    w = torch.randn((Dh, Vh), generator=g, device=dev, dtype=bf) * Dh ** -0.5
    for c in fmm.route_counters.values():
        c.launches = 0
    got = fmm.pmatmul(h, w, 0xBEEF, eps, True)
    routes = {n: c.launches for n, c in fmm.route_counters.items()}
    if routes != {"tma": int(route == "tma"),
                  "thread": int(route == "thread")}:
        raise SystemExit(f"zoo: K4 on {tag} ({Dh}, {Vh}) loaded by "
                         f"{routes}, want the {route} route")
    err = close(got, fref.pmatmul(h, w, 0xBEEF, eps, True), f"pmatmul {tag}")
    del got
    zoo_row(out, "pmatmul", f"{tag}: h ({B}, {S}, {Dh}) @ W ({Dh}, {Vh}), "
            f"trans=False, {route} route", run,
            lambda: fmm.pmatmul(h, w, 0xBEEF, eps, True),
            lambda: fref.pmatmul(h, w, 0xBEEF, eps, True),
            lambda: torch.matmul(h, w), err, CLOSE_TOL,
            (h.numel() + w.numel() + B * S * Vh) * 2,
            flops=2.0 * B * S * Dh * Vh, insns=Dh * Vh * RNG_OPS, reps=10)


def zoo_parity(cfg, eps):
    """Each kernel against its plain version at Qwen3-14B's shapes (B =
    16, S = 63, the +-eps pair): K2 at G = 5, 2 and 7 (8 KV heads); K3 at
    wq/wo, wk/wv, wg/wu and wd; K4 on the untied head/w read as stored,
    and on internvl2-2b's odd-vocabulary head by per-thread loads; K1
    on head/w as one row.  Returns the ``zoo_shapes`` rows by kernel."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import zo_axpy as kzo

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2020)
    B, S = 16, 63
    M = B * S
    D, Fd, V = cfg.d_model, cfg.d_ff, cfg.vocab
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    out = {name: [] for name in SOURCES}
    w_seed = 0xBEEF

    # K2: the paired forward's attention at G query heads a KV head
    for G, run in ((cfg.n_heads // KV, ZOO_ARCH), (2, "internlm2-1.8b"),
                   (7, ZOO_BIG)):
        zoo_k2(out, g, B, S, KV, G, dh, run)
    # K3: the layer's projections, both probes active
    for name, (K, N) in (("wq, wo", (D, D)), ("wk, wv", (D, KV * dh)),
                         ("wg, wu", (D, Fd)), ("wd", (Fd, D))):
        zoo_k3(out, g, eps, name, K, N, M, ZOO_ARCH)
    torch.cuda.empty_cache()
    # K4: the untied head read as stored, then an odd vocabulary's head
    internvl = configs.get("internvl2-2b")
    for tag, Dh, Vh, run in (
            ("head/w", D, V, ZOO_ARCH),
            ("internvl2-2b head/w", internvl.d_model, internvl.vocab,
             "internvl2-2b")):
        zoo_k4(out, g, eps, tag, B, S, Dh, Vh, run)
        torch.cuda.empty_cache()

    # K1: head/w's update sweep, one always-on row of D * V elements
    n = D * V
    theta = torch.randn((1, n), generator=g, device=dev, dtype=bf) * 0.02
    one = torch.ones((1,), dtype=torch.bool)
    got, want = theta.clone(), theta.clone()
    kzo.zo_axpy_2d_(got, one, w_seed, -eps, 1.0)
    kref.zo_axpy_2d_(want, one, w_seed, -eps, 1.0)
    ulps = bf16_ulps(got, want).max().item()
    if ulps > 1:
        raise SystemExit(f"zo_axpy_2d head/w row: {ulps} bf16 ulp")
    err = (got.float() - want.float()).abs().max().item()
    del theta
    zoo_row(out, "zo_axpy_2d", f"head/w as one row (1, {n}) bf16", ZOO_ARCH,
            lambda: kzo.zo_axpy_2d_(got, one, w_seed, -eps, 1.0),
            lambda: kref.zo_axpy_2d_(want, one, w_seed, -eps, 1.0),
            None, err, f"<= 1 bf16 ulp (got {ulps})", n * 2 * 2,
            insns=n * K1_OPS, reps=10)
    del got, want
    torch.cuda.empty_cache()
    return out


def zoo_dense_parity(out, eps):
    """K2, K3 and K4 against their plain versions at the shapes the
    ``ZOO_DENSE`` runs give them (B 16, S 63, the +-eps pair), appended to
    ``out``: K3 at each distinct (K, N) of a config's layer
    (``fmm.model_matmuls``), K4 at each head read as stored (internvl2-
    2b's is a ``zoo_parity`` row), K2 at codeqwen1.5-7b's and musicgen-
    large's multi-head attention (a KV head a query head).  A shape an
    earlier config gave is timed once: its row is repeated under the
    later config's run."""
    import torch
    from repro_torch import configs
    from repro_torch.fused import matmul as fmm

    g = torch.Generator(device="cuda").manual_seed(2121)
    B, S = 16, 63
    seen = {}

    def once(kernel, K, N, run, label, timed):
        key = kernel, K, N
        if key in seen:
            row = seen[key]
            out[kernel].append({**row, "run": run, "shape": f"{label}: "
                                + row["shape"].split(": ", 1)[1]})
            log(f"[zoo] {kernel} {out[kernel][-1]['shape']}: as timed for "
                f"{row['run']}")
            return
        timed()
        seen[key] = out[kernel][-1]
    for arch in ZOO_DENSE:
        c = configs.get(arch)
        layer, (Dh, Vh) = fmm.model_matmuls(c)
        names = ["wq", "wk", "wv", "wo"] + (
            ["wg", "wu", "wd"] if len(layer) == 7 else ["wi", "wd"])
        by_shape = {}
        for name, kn in zip(names, layer):
            by_shape.setdefault(kn, []).append(name)
        for (K, N), ns in by_shape.items():
            label = f"{arch} {', '.join(ns)}"
            once("pmatmul_stack", K, N, arch, label, lambda: zoo_k3(
                out, g, eps, label, K, N, B * S, arch))
        torch.cuda.empty_cache()
        if arch != "internvl2-2b":
            label = f"{arch} head/w"
            once("pmatmul", Dh, Vh, arch, label, lambda: zoo_k4(
                out, g, eps, label, B, S, Dh, Vh, arch))
            torch.cuda.empty_cache()
        if c.n_kv_heads == c.n_heads:
            zoo_k2(out, g, B, S, c.n_kv_heads, 1, c.head_dim, arch)


def zoo_train(tag, spec, cfg=None, train_data=None):
    """``steps`` virtual steps of ``spec`` through ``api.run`` (or, with
    a cut ``cfg``, its ``Trainer``), counted: finite losses and the
    launches ``expected_launches`` reckons; every K3/K4 launch by TMA but
    an odd vocabulary's head.  Returns (history, launches, peak GiB)."""
    from repro_torch import api
    from repro_torch.fused import matmul as fmm
    from repro_torch.models import lm
    from repro_torch.train.trainer import Trainer

    trainer = None
    if cfg is not None:
        d = api.derive(spec)
        trainer = Trainer(cfg, d.task, d.tcfg, d.est_cfg, _spec=spec,
                          _derived=d)
    for c in fmm.route_counters.values():
        c.launches = 0
    hist, launches, peak = run_counted(tag, spec, trainer=trainer,
                                       train_data=train_data)
    routes = {n: c.launches for n, c in fmm.route_counters.items()}
    params = hist["final_params"]
    cfg = cfg or api.derive(spec).model_cfg
    want = expected_launches(spec, params, spec.run.steps, cfg=cfg)
    if launches != want:
        raise SystemExit(f"{tag}: launches {launches} != expected {want}")
    thread = launches["pmatmul"] if (cfg.vocab * 2) % 16 else 0
    k34 = launches["pmatmul_stack"] + launches["pmatmul"]
    if routes != {"tma": k34 - thread, "thread": thread}:
        raise SystemExit(f"{tag}: K3/K4 routes {routes}, want "
                         f"{k34 - thread} by TMA and {thread} by thread")
    log(f"[{tag}] {lm.count_params(params) / 1e9:.3f} B parameters; K3/K4 "
        f"routes {routes}")
    return hist, launches, peak


def zoo_dense_run(arch):
    """``arch`` at its published depth and full width through
    ``api.run``: TRACE_WARM + ZOO_STEADY steps of the main path's spec
    with LeZO's n_drop from the preset's sparsity (stub embeddings for an
    audio or vision frontend), gated as ``zoo_train`` gates and on every
    step's active layers; then the device time, idle share and kernels a
    step over ZOO_WINDOW more steps (``measure_window``).  Returns the
    run's launches."""
    import torch
    from repro_torch import api
    from repro_torch.data import synthetic
    from repro_torch.models import frontends

    sp = zoo_spec(arch, **{"run.steps": TRACE_WARM + ZOO_STEADY})
    d = api.derive(sp)
    cfg, L = d.model_cfg, d.model_cfg.num_layers
    data = None
    if frontends.uses_embeds(cfg):
        data = synthetic.make_dataset(d.task, 64)
        data["embeds"] = frontends.stub_embeddings(
            cfg, *data["tokens"].shape, seed=1).float().cpu().numpy()
    hist, launches, peak = zoo_train(f"zoo {arch}", sp, train_data=data)
    active = hist["active_layers"]
    if (d.n_drop != int(sp.optimizer.sparsity * L)
            or active != [L - d.n_drop] * sp.run.steps):
        raise SystemExit(f"zoo: {arch} n_drop {d.n_drop}, active layers "
                         f"{active}; want {L - int(0.75 * L)} of {L}")
    params = hist["final_params"]
    secs = hist["step_seconds"][TRACE_WARM:]
    del hist
    win = measure_window(f"zoo {arch}", step_fn(sp, cfg, params),
                         ZOO_WINDOW, start=sp.run.steps)
    log(f"[zoo] {arch} ({L} layers, {d.n_drop} dropped a step) "
        f"{smi('name,power.limit')}: {ZOO_STEADY} steady steps: "
        f"step_seconds {stats(secs)}; device {win['busy'] / ZOO_WINDOW:.4f}"
        f" s a step, idle share {win['idle']:.4f}, {win['kernels']} "
        f"kernels a step; peak memory {peak:.2f} GiB")
    del params, data
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_zoo(eps):
    """The dense model zoo on the card (see the module docstring); returns
    the ``zoo_shapes`` rows by kernel, each carrying the kernel's
    launches in the zoo run that exercises its shape (``run``: Qwen3-14B's
    4 steps, its lockstep generate, a ``ZOO_DENSE`` config's run,
    deepseek-coder-33b's)."""
    import statistics

    import torch
    from repro_torch import api, configs, obs, serving
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    cfg = configs.get(ZOO_ARCH)
    rows = zoo_parity(cfg, eps)

    # Qwen3-14B at full width and depth: 4 steps, the probe gates
    spec = zoo_spec(ZOO_ARCH)
    hist, launches, peak = zoo_train(f"zoo {ZOO_ARCH}", spec)
    runs = {ZOO_ARCH: launches}        # each zoo run's launches by kernel
    params = hist["final_params"]
    del hist
    pair, mat, rel, direct, gap = probe_gap(spec, cfg, params)
    planted = probe_gap(spec, cfg, params, plant=PLANT)[4]
    log(f"[zoo] {ZOO_ARCH} virtual pair {pair} vs materialized {mat}: rel "
        f"diff {rel}; theta - eps z rel diff {gap}; planted theta - "
        f"{PLANT} eps z {planted} (must fail the gate)")
    if max(rel) > 1e-2 or not direct_gate(gap) or direct_gate(planted):
        raise SystemExit(f"zoo: {ZOO_ARCH} virtual against materialized "
                         "probes outside the check phase's gates")

    # TRACE_STEPS steady steps, telemetry off; idle share; a profiled step
    steady = api.with_overrides(spec, {"run.steps": TRACE_WARM + TRACE_STEPS})
    hist, n, peak = run_counted(f"zoo {ZOO_ARCH} steady", steady, params)
    check_launches(f"zoo {ZOO_ARCH} steady", steady, params, n)
    secs = hist["step_seconds"][TRACE_WARM:]
    del hist
    busy, wall, idle = device_idle_share(spec, cfg, params, TRACE_STEPS)
    log(f"[zoo] {ZOO_ARCH} {TRACE_STEPS} steady steps: step_seconds "
        f"{stats(secs)}; peak memory {peak:.2f} GiB; torch.profiler: wall "
        f"{wall:.4f} s, device busy {busy:.4f} s, idle share {idle:.4f}")
    phase_profile(spec, cfg, params, tag="zoo profile")

    # serving Qwen3-14B: lockstep, then the engine with sharing off and on
    sv = api.with_overrides(spec, SERVE_OVERRIDES)
    api.validate(sv)
    gen = torch.Generator(device="cpu").manual_seed(sv.run.seed)
    Bl, Sl, Gl = SERVE_LOCKSTEP
    toks = torch.randint(0, cfg.vocab, (Bl, Sl), generator=gen).cuda()
    last = {}

    def capture(q, k, v, **kw):
        last.update(q=q, k=k, v=v, kw=kw)
        return kernel(q, k, v, **kw)
    kernel = kfa.flash_attention
    with swap_k2(capture):
        out, n, peak, wall = counted(lambda: serve_mod.generate(
            cfg, params, toks, Gl, max_seq=Sl + Gl + 1))
    log(f"[zoo] lockstep generate ({Bl}, {Sl}) + {Gl}: {wall:.3f} s, "
        f"{Bl * Gl / wall:.1f} tok/s, peak {peak:.2f} GiB, launches {n}")
    if n != {"zo_axpy_2d": 0, "flash_attention": cfg.num_layers,
             "pmatmul_stack": 0, "pmatmul": 0} or tuple(out.shape) != (
                 Bl, Gl):
        raise SystemExit(f"zoo: lockstep launches {n} or tokens "
                         f"{tuple(out.shape)}")
    q, k, v, kw = last["q"], last["k"], last["v"], last["kw"]
    err = close(kfa.flash_attention(q, k, v, **kw),
                kfa.flash_attention_plain(q, k, v, **kw),
                "flash_attention zoo lockstep prefill")
    H = q.shape[2] * q.shape[3]
    qs = q.reshape(Bl, Sl, H, -1).transpose(1, 2).contiguous()
    ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
    runs["lockstep"] = n
    zoo_row(rows, "flash_attention", f"lockstep prefill {tuple(q.shape)}, "
            "the last layer's inputs", "lockstep",
            lambda: kfa.flash_attention(q, k, v, **kw),
            lambda: kfa.flash_attention_plain(q, k, v, **kw),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True), err, CLOSE_TOL,
            (2 * q.numel() + k.numel() + v.numel()) * 2,
            flops=4.0 * Bl * H * q.shape[-1] * (Sl * (Sl + 1) // 2))
    del q, k, v, qs, ks, vs, last, out
    logits, caches = lm.prefill(cfg, params, toks, max_seq=Sl + Gl + 1)
    tok = torch.argmax(logits, -1)[:, None]
    for i in range(2):                                    # warm
        lm.serve_step(cfg, params, caches, tok, Sl + i)
    profile_one("zoo", lambda: lm.serve_step(cfg, params, caches, tok,
                                             Sl + 2),
                f"one lockstep decode step ({Bl} lanes at {Sl + 2})")
    del logits, caches, tok, toks

    reqs = serve_requests(cfg.vocab, seed=sv.run.seed, n=ZOO_REQUESTS,
                          shared=ZOO_SHARED)
    mk = lambda: [serving.Request(rid=rid, tokens=t, seed=SEED_BASE + rid)
                  for rid, t in reqs]
    sess = obs.session(api.Telemetry(enabled=True, fence=True, ring=8192))
    eng = serve_engine(cfg, params, sv, sess)
    arena_gib = sum(t.numel() * t.element_size()
                    for b in eng.arena.values() for lv in b.values()
                    for t in lv.values()) / 2 ** 30
    tapped = tap_sampler(eng, {SEED_BASE + r for r in ZOO_CHECK})
    early, late = mk()[:-ZOO_LATE], mk()[-ZOO_LATE:]
    (base, results, wall), n, _, _ = counted(lambda: drain(
        eng, early, late=late, after=ZOO_AFTER))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ttft = sorted(r.ttft for r in results)
    n_tok = sum(len(t) for t in base.values())
    dec = [r.dt * 1e3 for r in sess.ring.spans(obs.SERVE_DECODE)]
    pre = [r.dt * 1e3 for r in sess.ring.spans(obs.SERVE_PREFILL)]
    log(f"[zoo] engine sharing off: {len(results)} requests, {n_tok} tokens "
        f"in {wall:.3f} s = {n_tok / wall:.1f} tok/s; "
        f"{eng.n_prefill_calls} prefill calls, {eng.n_decode_steps} decode "
        f"steps; TTFT median {statistics.median(ttft):.3f} s, p90 "
        f"{ttft[int(0.9 * (len(ttft) - 1))]:.3f} s; decode step median "
        f"{statistics.median(dec):.2f} ms, prefill chunk median "
        f"{statistics.median(pre):.2f} ms (fenced spans); peak "
        f"{peak:.2f} GiB, arena {arena_gib:.3f} GiB; launches {n}")
    if (sorted(base) != list(range(ZOO_REQUESTS)) or eng.pool.in_use
            or any(n.values())):
        raise SystemExit(f"zoo: engine results {sorted(base)}, "
                         f"{eng.pool.in_use} pages left, launches {n}")
    tapped = tapped()
    decode_profile("zoo", eng, reqs, sv)
    eng.run([])
    sess.close()
    del eng, sess
    on = api.with_overrides(sv, {"serving.prefix_cache": True})
    eng = serve_engine(cfg, params, on)
    got, _, wall = drain(eng, mk()[:-ZOO_LATE], late=mk()[-ZOO_LATE:],
                         after=ZOO_AFTER)
    log(f"[zoo] engine prefix_cache: {wall:.3f} s, page hit rate "
        f"{eng.sched.page_hit_rate:.3f}, {eng.sched.cow_copies} COW copies")
    diff = sorted(r for r in base if got.get(r) != base[r])
    if diff or not eng.sched.page_hit_rate > 0:
        raise SystemExit(f"zoo: prefix_cache tokens differ for rids {diff} "
                         f"or no page shared")
    del eng
    engine_vs_lockstep("zoo", cfg, params, sv, reqs, base, tapped,
                       ZOO_CHECK)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # the other dense configs at their published depth and full width
    zoo_dense_parity(rows, eps)
    for arch in ZOO_DENSE:
        runs[arch] = zoo_dense_run(arch)

    # deepseek-coder-33b at full width and depth on the one card
    hist, runs[ZOO_BIG], peak = zoo_train(
        f"zoo {ZOO_BIG} full", zoo_spec(ZOO_BIG, **{"run.steps": 2}))
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    log(f"[zoo] {ZOO_BIG} at full width and depth: peak memory "
        f"{peak:.2f} GiB of the card's {total:.2f} GiB")
    del hist
    gc.collect()
    torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            r["launches"] = runs[r["run"]][name]
    return rows


# The moe phase: the zoo's MoE and MLA configs at full width and depth,
# materialized (the reference's only backend for these blocks): K1 sweeps
# over the 4-D expert stacks and the float32 router, K2 at MLA's dh = 192
# (deepseek-v2-lite) and at granite-moe's GQA dh = 64, G = 2.
MOE_ARCHS = ("deepseek-v2-lite-16b", "granite-moe-1b-a400m")
MOE_MLA, MOE_GRANITE = MOE_ARCHS
MOE_STEADY = 5                           # steady steps after TRACE_WARM
MOE_DROPLESS = 4.0                       # the reference's dropless factor
MOE_CHECK = (0, 1)                       # against lockstep at batch 1


def moe_spec(arch, **over):
    """The main path's spec on ``arch`` at full width and depth, on the
    materialized forward backend."""
    return zoo_spec(arch, **{"runtime.forward_backend": "materialized",
                             **over})


DIGEST_CHUNK = 1 << 26                   # elements summed at a time


def params_digest(params):
    """Per leaf, the int64 sum of its elements' bit patterns, taken
    DIGEST_CHUNK elements at a time (an expert row's int64 copy would
    not fit beside jamba's weights): equal digests and equal scalars
    read as bit-equal runs."""
    import torch
    from repro_torch.core import zo
    out = {}
    for path, t in zo.leaf_items(params):
        if hasattr(t, "to_local"):           # a leaf placed on a mesh
            t = t.to_local()
        bits = t.detach().reshape(-1).view(
            torch.int16 if t.element_size() == 2 else torch.int32)
        out[path] = sum(int(bits[i:i + DIGEST_CHUNK].sum(dtype=torch.int64))
                        for i in range(0, bits.numel(), DIGEST_CHUNK))
    return out


def moe_parity(ds, gr, eps):
    """Each kernel the moe runs launch, against its plain version at
    their shapes (batch 16, S = 63): K2 at MLA's dh = 192 with v
    zero-padded from 128 (its pad columns must come out exact zeros;
    SDPA at dh = 192 beside), K2 at granite's (16, 63, 8, 2, 64) (SDPA
    with ``enable_gqa``), K1 on one layer's row of deepseek's ``we_g``
    (64 x 2048 x 1408 bf16) and on its float32 router stack.  Returns
    the ``moe_shapes`` rows by kernel."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(2121)
    out = {"flash_attention": [], "zo_axpy_2d": []}
    dn, dr, H = ds.head_dim, ds.rope_head_dim, ds.n_heads
    k2_row(out, g, MOE_MLA, 16, 63, H, 1, dn + dr, pad=dr)
    k2_row(out, g, MOE_GRANITE, 16, 63, gr.n_kv_heads,
           gr.n_heads // gr.n_kv_heads, gr.head_dim)

    # K1: one layer's row of we_g (bf16), then the float32 router stack
    # with every row active
    L1 = ds.stages[1].repeat
    k1_row(out, g, eps, MOE_MLA, "we_g one layer's row",
           (1, ds.n_experts * ds.d_model * ds.moe_d_ff), torch.bfloat16)
    k1_row(out, g, eps, MOE_MLA, "router, float32, all rows",
           (L1, ds.d_model * ds.n_experts), torch.float32)
    torch.cuda.empty_cache()
    return out


def k2_row(out, g, run, B, S, KV, G, dh, pad=0, reps=50):
    """K2 causal on seeded bf16 q (B, S, KV, G, dh), k and v (v's last
    ``pad`` columns zero, which must come out exact zeros) against its
    plain version (``close``), timed into ``out`` by ``zoo_row`` under
    ``run`` with SDPA (``enable_gqa`` when G > 1) beside."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as kfa

    bf = torch.bfloat16
    q = torch.randn((B, S, KV, G, dh), generator=g, device="cuda", dtype=bf)
    k = torch.randn((B, S, KV, dh), generator=g, device="cuda", dtype=bf)
    v = torch.randn((B, S, KV, dh), generator=g, device="cuda", dtype=bf)
    if pad:
        v[..., dh - pad:] = 0
    got = kfa.flash_attention(q, k, v, causal=True)
    err = close(got, kfa.flash_attention_plain(q, k, v, causal=True),
                f"flash_attention {run} dh = {dh}")
    if pad and got[..., dh - pad:].float().abs().max().item() != 0:
        raise SystemExit(f"K2 at dh = {dh} writes non-zero pad columns")
    qs = q.reshape(B, S, KV * G, dh).transpose(1, 2).contiguous()
    ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
    zoo_row(out, "flash_attention", f"{run}: q {tuple(q.shape)}, "
            f"dh = {dh}{', v padded from %d' % (dh - pad) if pad else ''}",
            run, lambda: kfa.flash_attention(q, k, v, causal=True),
            lambda: kfa.flash_attention_plain(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=G > 1),
            err, CLOSE_TOL, (2 * q.numel() + k.numel() + v.numel()) * 2,
            flops=4.0 * B * KV * G * dh * (S * (S + 1) // 2), plain_reps=2,
            reps=reps)


def k1_row(out, g, eps, run, tag, shape, dt):
    """K1 on a seeded (L, n) leaf of ``shape`` and ``dt`` with every row
    active, against its plain version (bf16 within 1 ulp, float32 within
    1e-6 relative), timed into ``out`` by ``zoo_row`` under ``run``."""
    import torch
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import zo_axpy as kzo

    w_seed = 0xBEEF
    theta = torch.randn(shape, generator=g, device="cuda", dtype=dt) * 0.02
    mask = torch.ones((shape[0],), dtype=torch.bool)
    got, want = theta.clone(), theta.clone()
    del theta
    kzo.zo_axpy_2d_(got, mask, w_seed, -eps, 1.0)
    kref.zo_axpy_2d_(want, mask, w_seed, -eps, 1.0)
    if dt == torch.bfloat16:
        ulps = bf16_ulps(got, want).max().item()
        tol = f"<= 1 bf16 ulp (got {ulps})"
        bad = ulps > 1
    else:
        rel = ((got - want).abs() / want.abs().clamp(min=1e-30)).max()
        tol = f"rel <= 1e-6 (got {rel.item():.2e})"
        bad = rel.item() > 1e-6
    if bad:
        raise SystemExit(f"zo_axpy_2d {tag}: {tol}")
    err = (got.float() - want.float()).abs().max().item()
    n = got.numel()
    zoo_row(out, "zo_axpy_2d", f"{run} {tag} {shape} "
            f"{str(dt).split('.')[-1]}", run,
            lambda: kzo.zo_axpy_2d_(got, mask, w_seed, -eps, 1.0),
            lambda: kref.zo_axpy_2d_(want, mask, w_seed, -eps, 1.0),
            None, err, tol, n * got.element_size() * 2,
            insns=n * K1_OPS, reps=10)


def seeded_train(tag, spec, cfg=None, regions=None):
    """``spec`` on its model, or on a depth-cut ``cfg`` through its
    ``Trainer``: 4 steps from the seed twice (launches as
    ``expected_launches`` reckons, finite losses; the two runs' losses,
    projected gradients and final parameters bit-equal), then 2 +
    MOE_STEADY steady steps, the idle share over as many and a profiled
    step with device time by op (and by the ``record_function`` labels
    of ``regions``).
    Returns (cfg, params, launches of the first run)."""
    import torch
    from repro_torch import api
    from repro_torch.models import lm
    from repro_torch.train.trainer import Trainer

    def trainer(sp, params=None):
        if cut is None:
            return None
        d = api.derive(sp)
        return Trainer(cut, d.task, d.tcfg, d.est_cfg, params=params,
                       _spec=sp, _derived=d)

    cut, cfg = cfg, cfg or api.derive(spec).model_cfg
    seen = []
    for run in ("", " again"):
        hist, launches, peak = run_counted(f"{tag}{run}", spec,
                                           trainer=trainer(spec))
        params = hist["final_params"]
        want = expected_launches(spec, params, spec.run.steps, cfg=cfg)
        if launches != want:
            raise SystemExit(f"{tag}: launches {launches} != expected "
                             f"{want}")
        seen.append((hist["loss"], hist["projected_grad"],
                     params_digest(params)))
        if not run:
            first = launches
            log(f"[{tag}] {lm.count_params(params) / 1e9:.3f} B parameters, "
                f"{lm.count_active_params(cfg, params) / 1e9:.3f} B active "
                f"a token; peak {peak:.2f} GiB")
            del hist, params
            gc.collect()
            torch.cuda.empty_cache()
    if seen[0] != seen[1]:
        raise SystemExit(f"{tag}: two runs from the seed differ "
                         f"(losses {seen[0][0]} vs {seen[1][0]})")
    log(f"[{tag}] the second run from the seed is bit-equal "
        f"(losses, projected gradients, {len(seen[0][2])} leaves)")
    del hist

    steady = api.with_overrides(spec, {"run.steps": TRACE_WARM + MOE_STEADY})
    hist, n, peak = run_counted(f"{tag} steady", steady, params,
                                trainer=trainer(steady, params))
    check_launches(f"{tag} steady", steady, params, n, cfg=cfg)
    secs = hist["step_seconds"][TRACE_WARM:]
    del hist
    busy, wall, idle = device_idle_share(spec, cfg, params, MOE_STEADY)
    log(f"[{tag}] {MOE_STEADY} steady steps: step_seconds "
        f"{stats(secs)}; peak memory {peak:.2f} GiB; torch.profiler: wall "
        f"{wall:.4f} s, device busy {busy:.4f} s, idle share {idle:.4f}")
    phase_profile(spec, cfg, params, tag=f"{tag} profile", ops=True,
                  regions=regions)
    return cfg, params, first


def moe_serve_mla(cfg, params, spec, rows):
    """deepseek-v2-lite through the lockstep ``generate`` (the engine
    refuses MLA): (4, 1024) + 32, K2 launched once a layer by the
    prefill at dh = 192 and held against its plain version and SDPA on
    the last layer's inputs (a ``moe_shapes`` row); the absorbed decode
    step over the latent cache, timed and profiled."""
    import torch
    import torch.nn.functional as F
    from repro_torch import serving
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    try:
        serving.Engine(cfg, params, spec.serving, device="cuda")
        raise SystemExit("moe: the engine accepted an MLA model")
    except serving.EngineUnsupported:
        pass
    gen = torch.Generator(device="cpu").manual_seed(spec.run.seed)
    Bl, Sl, Gl = SERVE_LOCKSTEP
    toks = torch.randint(0, cfg.vocab, (Bl, Sl), generator=gen).cuda()
    last = {}

    def capture(q, k, v, **kw):
        last.update(q=q, k=k, v=v, kw=kw)
        return kernel(q, k, v, **kw)
    kernel = kfa.flash_attention
    with swap_k2(capture):
        out, n, peak, wall = counted(lambda: serve_mod.generate(
            cfg, params, toks, Gl, max_seq=Sl + Gl + 1))
    log(f"[moe] {MOE_MLA} lockstep generate ({Bl}, {Sl}) + {Gl}: "
        f"{wall:.3f} s, {Bl * Gl / wall:.1f} tok/s, peak {peak:.2f} GiB, "
        f"launches {n}")
    if n != {"zo_axpy_2d": 0, "flash_attention": cfg.num_layers,
             "pmatmul_stack": 0, "pmatmul": 0} or tuple(out.shape) != (
                 Bl, Gl) or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise SystemExit(f"moe: lockstep launches {n} or tokens "
                         f"{tuple(out.shape)}")
    q, k, v, kw = last["q"], last["k"], last["v"], last["kw"]
    got = kfa.flash_attention(q, k, v, **kw)
    err = close(got, kfa.flash_attention_plain(q, k, v, **kw),
                f"flash_attention {MOE_MLA} lockstep prefill")
    dn = cfg.head_dim
    if got[..., dn:].float().abs().max().item() != 0:
        raise SystemExit("moe: K2's pad columns in the prefill are not 0")
    H, dh = q.shape[2], q.shape[-1]
    qs, ks, vs = (t.reshape(Bl, Sl, H, dh).transpose(1, 2).contiguous()
                  for t in (q, k, v))
    zoo_row(rows, "flash_attention", f"{MOE_MLA} lockstep prefill "
            f"{tuple(q.shape)}, the last layer's inputs", "lockstep_mla",
            lambda: kfa.flash_attention(q, k, v, **kw),
            lambda: kfa.flash_attention_plain(q, k, v, **kw),
            lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                   is_causal=True),
            err, CLOSE_TOL, (2 * q.numel() + k.numel() + v.numel()) * 2,
            flops=4.0 * Bl * H * dh * (Sl * (Sl + 1) // 2))
    del q, k, v, got, qs, ks, vs, last, out
    logits, caches = lm.prefill(cfg, params, toks, max_seq=Sl + Gl + 1)
    tok = torch.argmax(logits, -1)[:, None]
    step = lambda: lm.serve_step(cfg, params, caches, tok, Sl)
    ms = time_ms(step, reps=5)
    log(f"[moe] {MOE_MLA} absorbed decode step ({Bl} lanes at {Sl}, latent "
        f"cache {Sl + Gl + 1} slots): {ms:.2f} ms on the card's clock")
    profile_one(f"moe {MOE_MLA}", step, f"one absorbed decode step ({Bl} "
                f"lanes at {Sl})")
    del logits, caches, tok, toks
    return {"lockstep_mla": n}


def moe_serve_engine(cfg, params, spec):
    """granite-moe through the paged engine over 8 requests (4 sharing a
    512-token prefix; the last 4 arrive after 8 steps, so those can find
    the prefix registered): at the published capacity factor, the dropped
    assignments and the engine-vs-lockstep first-token gap, read and
    not gated (chunking changes the drops by design); then dropless
    (capacity_factor 4.0): sharing on bit-equal to off, pages shared,
    and the engine against the lockstep under ``serve``'s gate."""
    import torch
    from repro_torch import api, serving
    from repro_torch.models import moe

    sv = api.with_overrides(spec, SERVE_OVERRIDES)
    api.validate(sv)
    reqs = serve_requests(cfg.vocab, seed=sv.run.seed, n=ZOO_REQUESTS,
                          shared=ZOO_SHARED)
    mk = lambda: [serving.Request(rid=rid, tokens=t, seed=SEED_BASE + rid)
                  for rid, t in reqs]
    dispatch, drops = moe.dispatch, []

    def tap(*a):
        out = dispatch(*a)
        drops.append((~out[2]).sum())
        return out
    for cf in (cfg.capacity_factor, MOE_DROPLESS):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        eng = serve_engine(c, params, sv)
        tapped = tap_sampler(eng, {SEED_BASE + r for r in MOE_CHECK})
        drops.clear()
        moe.dispatch = tap
        try:
            (base, results, wall), n, _, _ = counted(lambda: drain(
                eng, mk()[:-ZOO_LATE], late=mk()[-ZOO_LATE:],
                after=ZOO_AFTER))
        finally:
            moe.dispatch = dispatch
        dropped = int(sum(d.item() for d in drops))
        n_tok = sum(len(t) for t in base.values())
        log(f"[moe] {MOE_GRANITE} engine at capacity_factor {cf}: "
            f"{len(results)} requests, {n_tok} tokens in {wall:.3f} s = "
            f"{n_tok / wall:.1f} tok/s; {eng.n_prefill_calls} prefill calls, "
            f"{eng.n_decode_steps} decode steps; {dropped} assignments "
            f"dropped over {len(drops)} MoE calls; launches {n}")
        if (sorted(base) != list(range(ZOO_REQUESTS)) or eng.pool.in_use
                or any(n.values()) or eng.n_compiles() != 2):
            raise SystemExit(f"moe: engine results {sorted(base)}, "
                             f"{eng.pool.in_use} pages left, launches {n}")
        tapped = tapped()
        del eng
        if cf == MOE_DROPLESS and dropped:
            raise SystemExit(f"moe: {dropped} drops at the dropless factor")
        if cf != MOE_DROPLESS:
            engine_vs_lockstep(f"moe {MOE_GRANITE} cf {cf}", c, params, sv,
                               reqs, base, tapped, MOE_CHECK, gate=False)
            continue
        on = api.with_overrides(sv, {"serving.prefix_cache": True})
        eng = serve_engine(c, params, on)
        got, _, wall = drain(eng, mk()[:-ZOO_LATE], late=mk()[-ZOO_LATE:],
                             after=ZOO_AFTER)
        log(f"[moe] {MOE_GRANITE} dropless engine prefix_cache: "
            f"{wall:.3f} s, page hit rate {eng.sched.page_hit_rate:.3f}")
        diff = sorted(r for r in base if got.get(r) != base[r])
        if diff or not eng.sched.page_hit_rate > 0:
            raise SystemExit(f"moe: dropless prefix_cache tokens differ "
                             f"for rids {diff} or no page shared")
        del eng
        engine_vs_lockstep(f"moe {MOE_GRANITE} dropless", c, params, sv,
                           reqs, base, tapped, MOE_CHECK)
    torch.cuda.empty_cache()


def phase_moe(eps):
    """The zoo's MoE and MLA configs on the card (see the module
    docstring); returns the ``moe_shapes`` rows by kernel, each carrying
    the kernel's launches in the run that exercises its shape."""
    import torch
    from repro_torch import configs

    ds, gr = configs.get(MOE_MLA), configs.get(MOE_GRANITE)
    rows = moe_parity(ds, gr, eps)
    runs = {}
    for arch in MOE_ARCHS:
        spec = moe_spec(arch)
        cfg, params, runs[arch] = seeded_train(f"moe {arch}", spec)
        if arch == MOE_MLA:
            runs.update(moe_serve_mla(cfg, params, spec, rows))
        else:
            moe_serve_engine(cfg, params, spec)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            r["launches"] = runs[r["run"]][name]
    return rows


# The ssm phase: the zoo's recurrent archs, materialized (the reference's
# only backend for these blocks; K3/K4 stay off the path).  xlstm-350m at
# full width and depth; jamba-v0.1-52b at full width, cut in depth to the
# most periods of its 8-layer pattern that one card holds for training
# and for the lockstep prefill (its 4 periods are 96.07 GiB of bf16
# weights), every width, head, expert, d_state and the vocabulary kept.
SSM_XLSTM, SSM_JAMBA = "xlstm-350m", "jamba-v0.1-52b"
SSM_PERIODS = (3, 2)                     # jamba's depths, deepest first
SSM_DECODE = (128, 8)                    # prompt, then decode steps
SSM_DECODE_STEPS = 16                    # decode against train, bf16 steps


def ssm_regions():
    """The recurrent blocks' scans, labelled in a profile: Mamba's
    selective scan (the kernel's launch, or the plain ops where a call
    bypasses it), one mLSTM chunk, and a whole sLSTM block (its
    per-step loop and the projections)."""
    from repro_torch.kernels import mamba_scan as kscan
    from repro_torch.models import ssm
    return {"ssm/mamba_scan": (kscan, "mamba_scan"),
            "ssm/mlstm_chunk": (ssm, "_mlstm_chunk"),
            "ssm/slstm_fwd": (ssm, "slstm_fwd")}


def ssm_parity(jb, xl, eps):
    """Each kernel the ssm runs launch, against its plain version at
    their shapes: K2 at jamba's GQA train shape (16, 63, 8, 4, 128) and
    lockstep prefill (4, 1024, 8, 4, 128) (SDPA with ``enable_gqa``
    beside); K1 on one layer's row of jamba's ``we_g`` (16 x 4096 x
    14336 = 939,524,096 bf16) and on xlstm's float32 ``rh`` stack (3,
    4 x 256 x 1024), every row active; the selective-scan kernel at
    jamba's train shape (``scan_row``).  Then one plain ``slstm_fwd`` at
    xlstm's (16, 63, 1024), where that model's time goes (no kernel
    stands behind it).  Returns the ``ssm_shapes`` rows by kernel."""
    import torch
    from repro_torch.models import ssm

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2222)
    out = {"flash_attention": [], "zo_axpy_2d": []}
    KV, G, dh = jb.n_kv_heads, jb.n_heads // jb.n_kv_heads, jb.head_dim
    k2_row(out, g, "jamba", 16, 63, KV, G, dh)
    k2_row(out, g, "lockstep_jamba", 4, 1024, KV, G, dh, reps=20)
    k1_row(out, g, eps, "jamba", "we_g one layer's row",
           (1, jb.n_experts * jb.d_model * jb.moe_d_ff), bf)
    k1_row(out, g, eps, "xlstm", "rh, float32, all rows",
           (xl.stages[0].repeat, xl.d_model * 4 * (xl.d_model // xl.n_heads)),
           torch.float32)
    torch.cuda.empty_cache()

    out["mamba_scan"] = [scan_row(g, jb)]
    torch.cuda.empty_cache()

    Bt, St = 16, 63
    p = ssm.slstm_params(xl, g, 1, dev)
    p = {k: ({kk: vv[0] for kk, vv in v.items()} if isinstance(v, dict)
             else v[0]) for k, v in p.items()}
    x = torch.randn((Bt, St, xl.d_model), generator=g, device=dev, dtype=bf)
    fwd = lambda: ssm.slstm_fwd(xl, p, x)
    fwd()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fwd()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    log(f"[ssm] plain slstm_fwd, one layer at ({Bt}, {St}, {xl.d_model}) "
        f"({St} sequential steps): {wall:.3f} ms wall, "
        f"{time_ms(fwd, reps=3):.3f} ms on the card's clock")
    del p, x
    torch.cuda.empty_cache()
    return out


def scan_row(g, jb):
    """The selective-scan kernel against its plain ops
    (``ssm._scan_plain``: softplus, the doubling scan, the skip and the
    gate in float32) at jamba's train shape (16, 63, 8192, 16) bf16, the
    arguments laid out as ``ssm.mamba_fwd`` hands them over (x and z the
    halves of one ``in_proj`` output, B and C slices of the float32
    ``x_proj`` output).  Train: y within one bf16 step of the plain
    result (``close``) and its mean error under 2^-9 of the mean |y|;
    prefill from a nonzero h0: y likewise and the last h within 1e-4 of
    the largest |h| (the two sum the 63 steps in another order).  Both
    timed beside the plain ops and the bytes bound (``kscan.cost``: each
    input read once, y written once).  Returns the row; a launch the
    wrapper did not make, or a gap past a limit, fails the phase."""
    import torch
    from repro_torch.kernels import mamba_scan as kscan
    from repro_torch.models import ssm

    dev = torch.device("cuda")
    Bt, S, Di = 16, 63, jb.mamba_d_inner
    St, R = jb.mamba_d_state, jb.mamba_dt_rank
    xz = torch.randn((Bt, S, 2 * Di), generator=g, device=dev).to(
        torch.bfloat16)
    proj = torch.randn((Bt, S, R + 2 * St), generator=g, device=dev)
    args = (torch.randn((Bt, S, Di), generator=g, device=dev),   # dt_in dt_w
            0.1 * torch.randn((Di,), generator=g, device=dev),   # dt_b
            0.1 * torch.randn((Di, St), generator=g, device=dev),  # A_log
            xz[..., :Di], proj[..., R:R + St], proj[..., R + St:],
            torch.randn((Di,), generator=g, device=dev), xz[..., Di:])
    h0 = torch.randn((Bt, Di, St), generator=g, device=dev)
    shape = f"jamba train ({Bt}, {S}, {Di}, {St}) bf16"
    errs = {}
    for mode, h_in in (("train", None), ("prefill", h0)):
        before = kscan.counter.launches
        y, h = kscan.mamba_scan(ssm._scan_plain, *args, h_in,
                                final=mode == "prefill")
        if kscan.counter.launches != before + 1:
            raise SystemExit(f"mamba_scan {shape} {mode}: the wrapper ran "
                             "the plain ops, not the kernel")
        want_y, want_h = ssm._scan_plain(*args, h_in)
        errs[mode] = close(y, want_y, f"mamba_scan {shape} {mode}")
        mean = ((y.float() - want_y.float()).abs().mean()
                / want_y.float().abs().mean()).item()
        if mean > 2.0 ** -9:
            raise SystemExit(f"mamba_scan {shape} {mode}: mean error "
                             f"{mean:.3e} of the mean |y|")
        if mode == "prefill":
            gap = ((h - want_h).abs().max() / want_h.abs().max()).item()
            if gap > 1e-4:
                raise SystemExit(f"mamba_scan {shape} prefill: last h "
                                 f"{gap:.3e} of the largest |h| away")
        log(f"[ssm] mamba_scan {shape} {mode}: max|err| "
            f"{errs[mode]:.3e}, mean err {mean:.3e} of the mean |y|"
            + (f", last h {gap:.3e} of the largest |h|"
               if mode == "prefill" else ""))
    flops, nbytes = kscan.cost(args[0], args[3], args[4])
    b_ms, b_by = bound(nbytes)
    row = dict(shape=shape, run="jamba", max_abs_err=max(errs.values()),
               tolerance="y: one bf16 step (close) and a mean error under "
               "2^-9 of the mean |y|; the last h within 1e-4 of the largest",
               ms=time_ms(lambda: kscan.mamba_scan(ssm._scan_plain, *args),
                          reps=50),
               plain_ms=time_ms(lambda: ssm._scan_plain(*args, None),
                                reps=3),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               issue_ms=issue_ms(flops))
    log(f"[ssm] mamba_scan {shape}: {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.1f} MB), its operations' issue time "
        f"{row['issue_ms']:.4f} ms")
    return row


def ssm_scan_count(tag, spec, cfg, params):
    """One ZO step of ``spec`` on ``cfg`` with the scan's counters
    zeroed: the kernel launched once a Mamba layer a forward (the
    two-point step's two) and the plain ops on the card never
    (``obs.CTR_SCAN_PLAIN``).  Returns the launches."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels import mamba_scan as kscan

    n_mamba = sum(st.repeat for st in cfg.stages for b in st.pattern
                  if b.kind == "mamba")
    kscan.counter.launches = 0
    tr = obs.Tracer()
    with obs.use(tr):
        step_fn(spec, cfg, params)(0)
    torch.cuda.synchronize()
    n = kscan.counter.launches
    ctr = (tr.counters.get(obs.CTR_SCAN_KERNEL, 0),
           tr.counters.get(obs.CTR_SCAN_PLAIN, 0))
    log(f"[ssm] {tag}: one ZO step launched mamba_scan {n} times "
        f"({n_mamba} Mamba layers, 2 forwards); counters kernel {ctr[0]}, "
        f"plain {ctr[1]}")
    if n != 2 * n_mamba or ctr != (n, 0):
        raise SystemExit(f"ssm: {tag} scan launches {n}, counters {ctr} "
                         f"(want {2 * n_mamba} and 0 plain)")
    return n


def ssm_decode_check(xl, jb):
    """The recurrence on the card at full width: for one layer of each
    recurrent kind at its config's width (bf16, weights from a seed), a
    128-token lockstep prefill then 8 decode steps fed the true tokens,
    against the train forward over 256 tokens at the same 9 positions
    (the prefill's last and the 8 steps'): within SSM_DECODE_STEPS bf16
    steps (``bf16_steps``; the card-side counterpart of the reference's
    ``test_decode_consistency_{mamba,xlstm}``)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.config import BlockCfg, StageCfg

    P, n = SSM_DECODE
    for kind, base in (("mamba", jb), ("mlstm", xl), ("slstm", xl)):
        cfg = base.with_(stages=(StageCfg(1, (BlockCfg(kind, "none"),)),))
        gen = torch.Generator(device="cuda").manual_seed(22)
        params = lm.init_params(cfg, gen, "cuda")
        toks = torch.randint(0, cfg.vocab, (2, 2 * P), generator=gen,
                             device="cuda")
        with torch.no_grad():
            h = lm.forward(cfg, params, toks)
            want = lm.logits_fn(cfg, params, h[:, P - 1:P + n])
            first, caches = lm.prefill(cfg, params, toks[:, :P],
                                       max_seq=P + n + 1)
            got = [first]
            for i in range(n):
                lg, caches = lm.serve_step(cfg, params, caches,
                                           toks[:, P + i:P + i + 1], P + i)
                got.append(lg)
        got = torch.stack(got, dim=1)
        steps = bf16_steps(got, want)
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"[ssm] decode check, one {kind} layer at d_model "
            f"{cfg.d_model}: prefill {P} + {n} steps against the train "
            f"forward over {2 * P}: {steps:.2f} bf16 steps (gate "
            f"{SSM_DECODE_STEPS}), max|err| "
            f"{(got - want).abs().max().item():.3e}, max|logits| "
            f"{want.abs().max().item():.3e}, argmax agreement {agree:.3f}")
        if not bool(torch.isfinite(got).all()) or steps > SSM_DECODE_STEPS:
            raise SystemExit(f"ssm: {kind} decode logits {steps:.2f} bf16 "
                             f"steps from the train forward's (gate "
                             f"{SSM_DECODE_STEPS})")
        del params, caches, h, want, got
    torch.cuda.empty_cache()


def ssm_jamba_depth():
    """The deepest cut of jamba in SSM_PERIODS whose training and
    lockstep prefill fit the card: per depth, the weights from the seed,
    one step of the spec and a (4, 1024) prefill; an out-of-memory there
    is logged with its peak and the next depth tried.  Returns (cut
    config, spec, periods)."""
    import torch
    from repro_torch import api, configs
    from repro_torch.models import lm

    full = configs.get(SSM_JAMBA)
    Bl, Sl, Gl = SERVE_LOCKSTEP
    for periods in SSM_PERIODS:
        cut = dataclasses.replace(full, stages=(dataclasses.replace(
            full.stages[0], repeat=periods),))
        spec = moe_spec(SSM_JAMBA)                 # LeZO's drop at the cut
        spec = api.with_overrides(spec, {"optimizer.n_drop": int(
            spec.optimizer.sparsity * cut.num_layers)})
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, refused = None, None
        try:
            params = lm.init_params(cut, torch.Generator(
                device="cuda").manual_seed(spec.run.seed), "cuda")
            step_fn(spec, cut, params)(0)
            lm.prefill(cut, params, torch.zeros(
                (Bl, Sl), dtype=torch.int64, device="cuda"), Sl + Gl + 1)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            refused = str(e).splitlines()[0]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[ssm] {SSM_JAMBA} at {periods} of 4 periods ({cut.num_layers} "
            f"layers): a train step and a ({Bl}, {Sl}) prefill "
            f"{'do not fit' if refused else 'fit'}; peak {peak:.2f} GiB"
            + (f" ({refused})" if refused else ""))
        if refused is None:
            return cut, spec, periods
    raise SystemExit(f"ssm: {SSM_JAMBA} fits the card at none of "
                     f"{SSM_PERIODS} periods")


def ssm_moe_drops(spec, cfg, params):
    """jamba's MoE layers at ``capacity_factor`` on one train batch: the
    assignments dropped over every MoE call of one forward."""
    import torch
    from repro_torch.api import runners
    from repro_torch.data import synthetic
    from repro_torch.models import lm, moe

    d = runners.derive(spec)
    data = synthetic.make_dataset(d.task, 64)
    batch = {k: torch.as_tensor(data[k][:spec.run.batch_size], device="cuda")
             for k in ("tokens", "labels", "loss_mask")}
    dispatch, seen = moe.dispatch, []

    def tap(*a):
        out = dispatch(*a)
        seen.append(((~out[2]).sum(), out[2].numel()))
        return out
    moe.dispatch = tap
    try:
        loss = float(lm.lm_loss(cfg, params, batch))
    finally:
        moe.dispatch = dispatch
    dropped = int(sum(int(n) for n, _ in seen))
    total = sum(t for _, t in seen)
    log(f"[ssm] {SSM_JAMBA} MoE at capacity_factor {cfg.capacity_factor}, "
        f"one forward at ({spec.run.batch_size}, {batch['tokens'].shape[1]}):"
        f" {dropped} of {total} assignments dropped over {len(seen)} MoE "
        f"calls; loss {loss:.6f}")


def ssm_serve(tag, cfg, params, spec):
    """The lockstep ``generate`` (4, 1024) + 32 twice (the engine refuses
    recurrent mixers): equal tokens, K2 launched once an attention
    layer by the prefill; a decode step timed and profiled.  Returns
    the first run's launches."""
    import torch
    from repro_torch import serving
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import lm

    try:
        serving.Engine(cfg, params, spec.serving, device="cuda")
        raise SystemExit(f"ssm: the engine accepted {tag}")
    except serving.EngineUnsupported:
        pass
    gen = torch.Generator(device="cpu").manual_seed(spec.run.seed)
    Bl, Sl, Gl = SERVE_LOCKSTEP
    toks = torch.randint(0, cfg.vocab, (Bl, Sl), generator=gen).cuda()
    want = {"zo_axpy_2d": 0, "flash_attention": attention_layers(cfg),
            "pmatmul_stack": 0, "pmatmul": 0}
    outs = []
    for run in ("", " again"):
        out, n, peak, wall = counted(lambda: serve_mod.generate(
            cfg, params, toks, Gl, max_seq=Sl + Gl + 1))
        log(f"[ssm] {tag} lockstep generate ({Bl}, {Sl}) + {Gl}{run}: "
            f"{wall:.3f} s, {Bl * Gl / wall:.1f} tok/s, peak {peak:.2f} GiB, "
            f"launches {n}")
        if n != want or tuple(out.shape) != (Bl, Gl) or not bool(
                ((out >= 0) & (out < cfg.vocab)).all()):
            raise SystemExit(f"ssm: {tag} lockstep launches {n} (want "
                             f"{want}) or tokens {tuple(out.shape)}")
        outs.append(out.tolist())
        first = first if run else n
    if outs[0] != outs[1]:
        raise SystemExit(f"ssm: {tag} lockstep tokens differ between two "
                         "runs")
    log(f"[ssm] {tag} lockstep: the second run's {Bl * Gl} tokens equal "
        "the first's")
    with torch.no_grad():
        logits, caches = lm.prefill(cfg, params, toks, max_seq=Sl + Gl + 1)
    tok = torch.argmax(logits, -1)[:, None]
    step = lambda: lm.serve_step(cfg, params, caches, tok, Sl)
    ms = time_ms(step, reps=5)
    log(f"[ssm] {tag} decode step ({Bl} lanes at {Sl}): {ms:.2f} ms on the "
        "card's clock")
    profile_one(f"ssm {tag}", step, f"one decode step ({Bl} lanes at {Sl})")
    del logits, caches, tok, toks
    return first


def phase_ssm(eps):
    """The zoo's recurrent archs on the card (see the module docstring);
    returns the ``ssm_shapes`` rows by kernel, each carrying the
    kernel's launches in the run that exercises its shape."""
    import torch
    from repro_torch import configs

    t0 = time.perf_counter()
    log(f"[ssm] {smi('name,power.limit')}")
    xl, jb = configs.get(SSM_XLSTM), configs.get(SSM_JAMBA)
    rows = ssm_parity(jb, xl, eps)
    ssm_decode_check(xl, jb)
    runs = {}
    spec = moe_spec(SSM_XLSTM)
    cfg, params, runs["xlstm"] = seeded_train(f"ssm {SSM_XLSTM}", spec,
                                              regions=ssm_regions())
    runs["lockstep_xlstm"] = ssm_serve(SSM_XLSTM, cfg, params, spec)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cut, spec, periods = ssm_jamba_depth()
    tag = f"{SSM_JAMBA} at {periods} periods"
    cfg, params, runs["jamba"] = seeded_train(f"ssm {tag}", spec, cfg=cut,
                                              regions=ssm_regions())
    ssm_moe_drops(spec, cfg, params)
    runs["jamba"]["mamba_scan"] = ssm_scan_count(tag, spec, cfg, params)
    runs["lockstep_jamba"] = ssm_serve(tag, cfg, params, spec)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for name, rs in rows.items():
        for r in rs:
            r["launches"] = runs[r["run"]][name]
    log(f"[ssm] phase {time.perf_counter() - t0:.1f} s")
    return rows


# The modes phase: the reference's optimizer modes beyond the two-point
# step on each config family.  Qwen3-14B at full width and depth runs
# LoRA, prefix, ZO momentum and the swarm's sharded step (two loss
# shards, one process); FO runs on granite-moe (SGD and AdamW) and
# xlstm-350m (SGD) at full width and depth, and on deepseek-v2-lite at the
# deepest depth whose FO-SGD state (a float32 master, a bf16 leaf and a
# bf16 gradient: 8 B a parameter) fits MODES_FO_SHARE of the card.
MODES_STEPS = 3
MODES_FO_SHARE = 0.75             # of the card's memory for the FO state
MODES_FO_ARCHS = (("granite-moe-1b-a400m", "sgd"),
                  ("granite-moe-1b-a400m", "adamw"), ("xlstm-350m", "sgd"))
MODES_MLA = "deepseek-v2-lite-16b"
MODES_JAMBA = "jamba-v0.1-52b"


def modes_parity(eps):
    """Each kernel against its plain version at the shapes the modes runs
    give it and no earlier phase ran: K3 on Qwen3-14B's seven layer
    leaves and K4 on its untied head (``trans=False``) at the swarm's
    batch shard (8 of 16 rows: x (2, 504, K)); K2's forward inside FO's
    autograd ``Function`` at MLA's dh = 192 (v zero-padded from 128) and
    at granite's GQA: its output, the row statistics m and l the
    backward reads, and dq, dk, dv through it against autograd through
    the plain version, with the plain float32 backward timed beside it;
    K2 at prefix tuning's shape on Qwen3-14B (G = 5, Sk = 68, k_offset =
    -5); K1 on Qwen3-14B's LoRA ``wv/B`` leaf (40, 8192) with 10 rows
    active.  Returns the rows by kernel, each
    naming the modes run whose launches it takes."""
    import torch
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.fused import matmul as fmm
    from repro_torch.fused import ref as fref
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import zo_axpy as kzo

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2424)
    out = {name: [] for name in SOURCES}
    w_seed = 0xD1CE

    def row(name, shape, run, err, fn, plain, lib, nbytes, tol=CLOSE_TOL,
            extra=None, **work):
        b_ms, b_by = bound(nbytes, **work)
        r = dict(shape=shape, run=run, max_abs_err=err, tolerance=tol,
                 ms=time_ms(fn, reps=20), plain_ms=time_ms(plain, reps=2),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=time_ms(lib, reps=20) if lib else None,
                 **(extra or {}))
        out[name].append(r)
        log(f"[modes parity] {name} {shape}: max|err| {err:.3e}; "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), library {r['library_ms']}"
            + "".join(f", {k} {v}" for k, v in (extra or {}).items()))

    qw = configs.get(ZOO_ARCH)
    D, H, KV, dh = qw.d_model, qw.n_heads, qw.n_kv_heads, qw.head_dim
    M = 8 * 63                                   # one of two loss shards
    args = ((w_seed, w_seed), (eps, -eps), (True, True))
    for K, N, leaves in ((D, H * dh, "wq/wo"), (D, KV * dh, "wk/wv"),
                         (D, qw.d_ff, "wg/wu"), (qw.d_ff, D, "wd")):
        x = torch.randn((2, M, K), generator=g, device=dev, dtype=bf)
        w = torch.randn((K, N), generator=g, device=dev, dtype=bf) * K ** -.5
        err = close(fmm.pmatmul_stack(x, w, *args),
                    fref.pmatmul_stack(x, w, *args),
                    f"pmatmul_stack {ZOO_ARCH} shard {leaves}")
        row("pmatmul_stack", f"{ZOO_ARCH} swarm shard {leaves}: x (2, {M}, "
            f"{K}) @ W ({K}, {N}), P = 2 active", "swarm", err,
            lambda: fmm.pmatmul_stack(x, w, *args),
            lambda: fref.pmatmul_stack(x, w, *args),
            lambda: torch.matmul(x, w), (x.numel() + w.numel() + 2 * M * N)
            * 2, tensor_flops=2.0 * 2 * M * K * N,
            instructions=K * N * RNG_OPS)
        del x, w
    V = qw.vocab
    h = torch.randn((8, 63, D), generator=g, device=dev, dtype=bf)
    w = torch.randn((D, V), generator=g, device=dev, dtype=bf) * 0.02
    err = close(fmm.pmatmul(h, w, w_seed, eps, True),
                fref.pmatmul(h, w, w_seed, eps, True),
                f"pmatmul {ZOO_ARCH} head shard")
    row("pmatmul", f"{ZOO_ARCH} swarm shard: h (8, 63, {D}) @ head/w ({D}, "
        f"{V}), trans=False", "swarm", err,
        lambda: fmm.pmatmul(h, w, w_seed, eps, True),
        lambda: fref.pmatmul(h, w, w_seed, eps, True),
        lambda: torch.matmul(h, w), (h.numel() + w.numel() + M * V) * 2,
        tensor_flops=2.0 * M * D * V, instructions=D * V * RNG_OPS)
    del h, w

    # K2 inside FO: the forward's output and the row statistics m and l
    # that the backward reads, and the gradients through the kernel's
    # forward and the plain backward against autograd through the plain
    # version (within two bf16 steps, as the card's unit test holds them)
    for run, (B, S, kv, G, d, pad) in (
            (f"fo {MODES_MLA} sgd", (16, 63, 16, 1, 192, 64)),
            ("fo granite-moe-1b-a400m sgd", (16, 63, 8, 2, 64, 0))):
        q = torch.randn((B, S, kv, G, d), generator=g, device=dev, dtype=bf)
        k = torch.randn((B, S, kv, d), generator=g, device=dev, dtype=bf)
        v = torch.randn((B, S, kv, d), generator=g, device=dev, dtype=bf)
        dout = torch.randn(q.shape, generator=g, device=dev, dtype=bf)
        if pad:                  # MLA pads v and cuts the output to dn
            v[..., d - pad:] = 0
            dout[..., d - pad:] = 0
        ins = [t.clone().requires_grad_() for t in (q, k, v)]

        def fwd():
            return kfa.FlashAttention.apply(*ins, True, 0, 0, 512, 512)
        got = fwd()
        err = close(got, kfa.flash_attention_plain(q, k, v, causal=True),
                    f"flash_attention FO forward {run}")
        o, m, l = kfa.flash_attention_plain(q, k, v, causal=True,
                                            stats=True)
        _, _, _, _, m_k, l_k = got.grad_fn.saved_tensors
        st_err = max(close(m_k, m, f"flash_attention FO row max m {run}"),
                     close(l_k, l, f"flash_attention FO row sum l {run}"))
        got.backward(dout)
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        kfa.flash_attention_plain(*ref, causal=True).backward(dout)
        g_err = max(close(a.grad, b.grad, f"flash_attention FO d{n} {run}",
                          steps=2) for n, a, b in zip("qkv", ins, ref))
        back = lambda: kfa.flash_attention_backward(  # noqa: E731
            q, k, v, o, m, l, dout, causal=True)
        qs, ks, vs = (t.reshape(B, S, -1, d).transpose(1, 2).contiguous()
                      for t in (q, k, v))
        row("flash_attention", f"FO forward (stats) {tuple(q.shape)}"
            + (f", v zero-padded from {d - pad}" if pad else ""), run, err,
            fwd, lambda: kfa.flash_attention_plain(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=G > 1),
            (2 * q.numel() + k.numel() + v.numel()) * 2,
            tol=f"{CLOSE_TOL}; m and l alike; dq, dk, dv through the "
            "kernel's forward within two such steps of autograd through "
            "the plain version",
            tensor_flops=4.0 * B * kv * G * d * (S * (S + 1) // 2),
            extra={"stats_max_abs_err": st_err, "grad_max_abs_err": g_err,
                   "plain_backward_ms": time_ms(back, reps=5)})
        del q, k, v, dout, ins, ref, got, o, m, l, m_k, l_k, qs, ks, vs

    # K2 at the prefix shape on Qwen3-14B: 5 always-visible keys ahead
    P, B, S = 5, 16, 63
    q = torch.randn((B, S, KV, H // KV, dh), generator=g, device=dev,
                    dtype=bf)
    k = torch.randn((B, S + P, KV, dh), generator=g, device=dev, dtype=bf)
    v = torch.randn((B, S + P, KV, dh), generator=g, device=dev, dtype=bf)
    kw = dict(causal=True, k_offset=-P)
    err = close(kfa.flash_attention(q, k, v, **kw),
                kfa.flash_attention_plain(q, k, v, **kw),
                f"flash_attention {ZOO_ARCH} prefix")
    qs = q.reshape(B, S, H, dh).transpose(1, 2).contiguous()
    ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(S, device=dev)[:, None]
            >= torch.arange(S + P, device=dev)[None] - P)
    row("flash_attention", f"{ZOO_ARCH} prefix: q {tuple(q.shape)}, k/v "
        f"{tuple(k.shape)}, k_offset = -{P}", "prefix", err,
        lambda: kfa.flash_attention(q, k, v, **kw),
        lambda: kfa.flash_attention_plain(q, k, v, **kw),
        lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                               enable_gqa=True),
        (2 * q.numel() + k.numel() + v.numel()) * 2,
        tensor_flops=4.0 * B * H * dh * kfa.visible_keys(S, S + P, True, 0,
                                                         -P))
    del q, k, v, qs, ks, vs, mask

    # K1 on the LoRA wv/B leaf of Qwen3-14B (rank 8)
    L, n = qw.num_layers, 8 * KV * dh
    theta = torch.randn((L, n), generator=g, device=dev, dtype=bf) * 0.02
    mask = torch.zeros(L, dtype=torch.bool)
    mask[torch.randperm(L, generator=torch.Generator().manual_seed(6))[
        :L // 4]] = True
    seed = 0x7777
    got, want = theta.clone(), theta.clone()
    kzo.zo_axpy_2d_(got, mask, seed, -eps, 1.0)
    kref.zo_axpy_2d_(want, mask, seed, -eps, 1.0)
    torch.cuda.synchronize()
    on = mask.to(dev)
    ulps = bf16_ulps(got[on], want[on]).max().item()
    if ulps > 1 or not torch.equal(got[~on].view(torch.int16),
                                   theta[~on].view(torch.int16)):
        raise SystemExit(f"zo_axpy_2d LoRA wv/B ({L}, {n}): {ulps} bf16 ulp "
                         "or a masked-off row changed")
    n_act = int(mask.sum()) * n
    row("zo_axpy_2d", f"{ZOO_ARCH} LoRA wv/B ({L}, {n}), {int(mask.sum())} "
        f"of {L} rows active", "lora",
        (got.float() - want.float()).abs().max().item(),
        lambda: kzo.zo_axpy_2d_(got, mask, seed, -eps, 1.0),
        lambda: kref.zo_axpy_2d_(want, mask, seed, -eps, 1.0), None,
        n_act * 2 * 2, tol=f"masked rows bit-equal; active <= 1 bf16 ulp "
        f"(got {ulps})", instructions=n_act * K1_OPS)
    del theta, got, want
    torch.cuda.empty_cache()
    return out


def modes_run(tag, spec, want_fn, trainer_fn=None):
    """``spec`` twice from the seed (``api.run``, or the trainer
    ``trainer_fn()`` builds): launches equal to ``want_fn(history)``,
    finite losses, and the two runs' losses, projected gradients and
    trainable digests bit-equal.  Logs step seconds (median, min, max over both
    runs' steps after the first) and the peak; returns the first run's
    launches."""
    import torch
    seen, secs, peaks = [], [], []
    for run in ("", " again"):
        gc.collect()                  # the first run's trainer is freed
        torch.cuda.empty_cache()
        hist, launches, peak = run_counted(
            f"{tag}{run}", spec,
            trainer=None if trainer_fn is None else trainer_fn())
        want = want_fn(hist)
        if launches != want:
            raise SystemExit(f"{tag}: launches {launches} != reckoned "
                             f"{want}")
        seen.append((hist["loss"], hist.get("projected_grad"),
                     params_digest(hist["final_params"])))
        secs += hist["step_seconds"][1:]
        peaks.append(peak)
        if not run:
            first = launches
        del hist
    same = seen[0] == seen[1]
    log(f"[{tag}] step seconds after the first, both runs: {stats(secs)}; "
        f"peak {max(peaks):.2f} GiB; launches {first} as reckoned; the two "
        f"runs from the seed bit-equal (losses, projected gradients, "
        f"{len(seen[0][2])} trainable leaves): {same}")
    if not same:
        raise SystemExit(f"{tag}: two runs from the seed differ (losses "
                         f"{seen[0][0]} vs {seen[1][0]})")
    return first


def fo_spec(arch, opt):
    from repro_torch import api
    return api.with_overrides(api.preset("fo-opt13b"), {
        "model.arch": arch, "model.variant": "full",
        "optimizer.fo_optimizer": opt, "run.steps": MODES_STEPS,
        "run.log_every": 1, "run.eval_every": 0})


def cut_params(cfg, depth):
    """Parameters of ``cfg`` cut to ``depth`` repeats of its last stage
    (counted on the meta device)."""
    from repro_torch.launch import specs
    from repro_torch.models import lm
    st = cfg.stages
    cut = dataclasses.replace(cfg, stages=st[:-1] + (dataclasses.replace(
        st[-1], repeat=depth),))
    return cut, lm.count_params(specs.param_specs(cut))


def phase_modes(eps):
    """The reference's other optimizer modes on the zoo's config families
    (see the module docstring); returns the ``modes_shapes`` rows by
    kernel."""
    import torch
    from repro_torch import api, configs
    from repro_torch.core import zo
    from repro_torch.estimators import costs
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    rows = modes_parity(eps)
    runs = {}
    qw = configs.get(ZOO_ARCH)
    A = attention_layers(qw)
    c = costs.step_counts("two_point", forward_backend="materialized")

    def peft_want(hist):           # K1 a tree leaf a sweep, K2 a forward
        n = len(zo.leaf_items(hist["final_params"]))
        return {"zo_axpy_2d": n * c["axpy_sweeps"] * MODES_STEPS,
                "flash_attention": A * c["forwards"] * MODES_STEPS,
                "pmatmul_stack": 0, "pmatmul": 0}

    for tag, ov, want in (
            ("lora", {"runtime.peft": "lora"}, peft_want),
            ("prefix", {"runtime.peft": "prefix"}, peft_want),
            ("zo_momentum", {"optimizer.mode": "zo_momentum"}, None),
            ("swarm", {"swarm.n_shards": 2,
                       "runtime.forward_backend": "virtual"}, None)):
        spec = zoo_spec(ZOO_ARCH, **{
            "runtime.forward_backend": "materialized",
            "run.steps": MODES_STEPS, **ov})
        runs[tag] = modes_run(
            f"modes {ZOO_ARCH} {tag}", spec, want or (
                lambda h, sp=spec: expected_launches(
                    sp, h["final_params"], MODES_STEPS)))
        gc.collect()
        torch.cuda.empty_cache()

    # FO at full width and depth: K2 a forward (its backward is plain)
    total = torch.cuda.get_device_properties(0).total_memory
    for arch, opt in MODES_FO_ARCHS:
        spec = fo_spec(arch, opt)
        A = attention_layers(configs.get(arch))
        n = {"zo_axpy_2d": 0, "flash_attention": A * MODES_STEPS,
             "pmatmul_stack": 0, "pmatmul": 0}
        runs[f"fo {arch} {opt}"] = modes_run(
            f"modes fo {arch} {opt}", spec, lambda h, n=n: n)
        gc.collect()
        torch.cuda.empty_cache()

    # FO-SGD on deepseek-v2-lite at the deepest depth its state fits
    full = configs.get(MODES_MLA)
    depth = max(d for d in range(1, full.stages[-1].repeat + 1)
                if 8 * cut_params(full, d)[1] <= MODES_FO_SHARE * total)
    cut, n_par = cut_params(full, depth)
    log(f"[modes] {MODES_MLA} FO-SGD: 8 B a parameter at "
        f"{cut.num_layers} of {full.num_layers} layers = "
        f"{8 * n_par / 2 ** 30:.2f} GiB ({n_par / 1e9:.3f} B parameters), "
        f"the deepest within {MODES_FO_SHARE:.0%} of the card's "
        f"{total / 2 ** 30:.2f} GiB")
    spec = fo_spec(MODES_MLA, "sgd")
    d = api.derive(spec)
    n = {"zo_axpy_2d": 0, "flash_attention": attention_layers(cut)
         * MODES_STEPS, "pmatmul_stack": 0, "pmatmul": 0}
    runs[f"fo {MODES_MLA} sgd"] = modes_run(
        f"modes fo {MODES_MLA} sgd cut", spec, lambda h: n,
        trainer_fn=lambda: Trainer(cut, d.task, d.tcfg, d.est_cfg,
                                   fo_cfg=d.fo_cfg, _spec=spec, _derived=d))
    gc.collect()
    torch.cuda.empty_cache()

    # jamba's FO stays on the CPU: one period already exceeds the card
    jb = configs.get(MODES_JAMBA)
    _, per = cut_params(jb, 1)
    log(f"[modes] {MODES_JAMBA} FO: one period of "
        f"{len(jb.stages[-1].pattern)} layers holds {per / 1e9:.3f} B "
        f"parameters, {8 * per / 2 ** 30:.2f} GiB at 8 B a parameter "
        f"against the card's {total / 2 ** 30:.2f} GiB: not run on the card")
    for name, rs in rows.items():
        for r in rs:
            r["launches"] = runs[r["run"]][name]
    log(f"[modes] phase {time.perf_counter() - t0:.1f} s")
    return rows


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


# The swarm phase.  Each part drives ``swarm.driver.run_swarm`` (local
# worker processes ``python -m repro_torch.launch swarm --attach ...
# --device cuda``, which all share this one card) or ``api.run`` on the
# same spec, one after another, never at once.
SWARM_STEPS = 12
# The smaller model of the 4-worker, checkpoint and rejoin part: OPT-1.3B
# (24 layers, d_model 2048, bf16), the smallest bf16 OPT of the configs.
# The bench variant (4 layers, d_model 512) is float32 in the config, K2,
# K3 and K4 take bf16 only, and a worker draws its weights from the spec,
# so on the card its forward raises.
SWARM_SMALL_VARIANT = "opt_1_3b"
SWARM_STREAM = ("loss", "projected_grad", "seed", "arrived", "shard_losses",
                "active_layers", "layer_sel")


CLOSE_TOL = "|err| <= 2^-7|plain| + 2^-8 max|plain|"


def swarm_parity(shards, eps):
    """Each kernel against its plain version at the shapes one loss shard
    of a swarm worker gives it, for each ``(tag, cfg, rows)`` of
    ``shards`` (``rows`` of the shard's batch, 63 positions each): K3 for
    the paired probe at (D, d_ff), (d_ff, D) and (D, D), K4 for the tied
    head, K2 for the paired attention; and K1 at the model's stacked FFN
    leaf with a quarter of its layers active, as LeZO at sparsity 0.75
    commits.  Returns, by kernel, a list of rows (shape, error, times,
    bound)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.fused import matmul as fmm
    from repro_torch.fused import ref as fref
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import zo_axpy as kzo

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    bf = torch.bfloat16
    S, w_seed = 63, 0xBEEF
    out = {name: [] for name in SOURCES}

    def row(name, shape, err, fn, plain, lib, nbytes, tol=CLOSE_TOL,
            **work):
        b_ms, b_by = bound(nbytes, **work)
        r = dict(shape=shape, max_abs_err=err, tolerance=tol,
                 ms=time_ms(fn, reps=20), plain_ms=time_ms(plain, reps=2),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=time_ms(lib, reps=20) if lib else None)
        out[name].append(r)
        log(f"[swarm parity] {name} {shape}: max|err| {err:.3e}; "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), library {r['library_ms']}")

    for tag, cfg, B in shards:
        D, Fd, V, H = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads
        dh, M = cfg.head_dim, B * S
        args = ((w_seed, w_seed), (eps, -eps), (True, True))
        for K, N in ((D, Fd), (Fd, D), (D, D)):
            x = torch.randn((2, M, K), generator=g, device=dev, dtype=bf)
            w = (torch.randn((K, N), generator=g, device=dev, dtype=bf)
                 * K ** -0.5)
            err = close(fmm.pmatmul_stack(x, w, *args),
                        fref.pmatmul_stack(x, w, *args),
                        f"pmatmul_stack {tag} shard ({K}, {N})")
            row("pmatmul_stack", f"{tag} shard: x (2, {M}, {K}) @ W ({K}, "
                f"{N}), P = 2 active", err,
                lambda: fmm.pmatmul_stack(x, w, *args),
                lambda: fref.pmatmul_stack(x, w, *args),
                lambda: torch.matmul(x, w),
                (x.numel() + w.numel() + 2 * M * N) * 2,
                tensor_flops=2.0 * 2 * M * K * N,
                instructions=K * N * RNG_OPS)
            del x, w
        tok = torch.randn((V, D), generator=g, device=dev, dtype=bf) * 0.02
        h = torch.randn((B, S, D), generator=g, device=dev, dtype=bf)
        kw = dict(trans=True, ld=D)
        err = close(fmm.pmatmul(h, tok.T, w_seed, eps, True, **kw),
                    fref.pmatmul(h, tok.T, w_seed, eps, True, **kw),
                    f"pmatmul head {tag} shard")
        row("pmatmul", f"{tag} shard: h ({B}, {S}, {D}) @ tok.T ({D}, {V})"
            " trans", err,
            lambda: fmm.pmatmul(h, tok.T, w_seed, eps, True, **kw),
            lambda: fref.pmatmul(h, tok.T, w_seed, eps, True, **kw),
            lambda: torch.matmul(h, tok.T),
            (h.numel() + tok.numel() + M * V) * 2,
            tensor_flops=2.0 * M * D * V, instructions=D * V * RNG_OPS)
        del tok, h
        q = torch.randn((2 * B, S, H, 1, dh), generator=g, device=dev,
                        dtype=bf)
        k = torch.randn((2 * B, S, H, dh), generator=g, device=dev, dtype=bf)
        v = torch.randn((2 * B, S, H, dh), generator=g, device=dev, dtype=bf)
        err = close(kfa.flash_attention(q, k, v, causal=True),
                    kfa.flash_attention_plain(q, k, v, causal=True),
                    f"flash_attention {tag} shard")
        qs, ks, vs = (t.reshape(2 * B, S, H, dh).transpose(1, 2)
                      .contiguous() for t in (q, k, v))
        row("flash_attention", f"{tag} shard: ({2 * B}, {S}, {H}, 1, {dh})",
            err, lambda: kfa.flash_attention(q, k, v, causal=True),
            lambda: kfa.flash_attention_plain(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                   is_causal=True),
            4 * q.numel() * 2,
            tensor_flops=4.0 * 2 * B * H * dh * (S * (S + 1) // 2))
        del q, k, v, qs, ks, vs
    if shards:
        # K1 at the last model's stacked FFN leaf (L, D * d_ff)
        L = cfg.num_layers
        theta = (torch.randn((L, D * Fd), generator=g, device=dev, dtype=bf)
                 * 0.02)
        mask = torch.zeros(L, dtype=torch.bool)
        mask[torch.randperm(L, generator=torch.Generator().manual_seed(5))[
            :L // 4]] = True
        seed, decay = 0x1234567, 1.0          # weight decay 0, as the spec
        got, want = theta.clone(), theta.clone()
        kzo.zo_axpy_2d_(got, mask, seed, -eps, decay)
        kref.zo_axpy_2d_(want, mask, seed, -eps, decay)
        torch.cuda.synchronize()
        on = mask.to(dev)
        ulps = bf16_ulps(got[on], want[on]).max().item()
        if ulps > 1 or not torch.equal(got[~on].view(torch.int16),
                                       theta[~on].view(torch.int16)):
            raise SystemExit(f"zo_axpy_2d {tag} ({L}, {D * Fd}): {ulps} "
                             "bf16 ulp or a masked-off row changed")
        n_act = int(mask.sum()) * D * Fd
        row("zo_axpy_2d", f"{tag}: ({L}, {D * Fd}), {int(mask.sum())} of {L}"
            " rows active", (got.float() - want.float()).abs().max().item(),
            lambda: kzo.zo_axpy_2d_(got, mask, seed, -eps, decay),
            lambda: kref.zo_axpy_2d_(want, mask, seed, -eps, decay), None,
            n_act * 2 * 2, tol=f"masked rows bit-equal; active <= 1 bf16 ulp"
            f" (got {ulps})", instructions=n_act * K1_OPS)
        del theta, got, want
    torch.cuda.empty_cache()
    return out


def swarm_spec(base, root, tag, **over):
    """``base`` with its run directory (and checkpoints, when asked) under
    ``root/tag``."""
    from repro_torch import api
    d = os.path.join(root, tag)
    over = {"telemetry.runs_dir": os.path.join(d, "runs"), **over}
    if over.get("run.ckpt_every"):
        over["run.ckpt_dir"] = os.path.join(d, "ckpt")
    return api.with_overrides(base, over)


def swarm_rows(spec):
    from repro_torch import obs
    (rid,) = obs.list_runs(spec.telemetry.runs_dir)
    rd = obs.load_run(rid, spec.telemetry.runs_dir)
    return rd.dir, rd.steps


def swarm_stream(spec):
    return [[r.get(k) for k in SWARM_STREAM] for r in swarm_rows(spec)[1]]


def swarm_run(tag, spec, leaves, L, *, crash_at=None):
    """One swarm through ``run_swarm`` on the card: its summary, with the
    workers' exits, results and launches checked.  Every worker folds
    every commit (one K1 sweep of ``leaves`` launches each, from its
    starting point), and every probe forward it runs launches K2 ``L``
    times, K3 ``6L`` and K4 twice.  With ``crash_at`` (the step of the
    spec's one crash), one worker exits ``CRASH_EXIT``, one is respawned,
    and the respawned worker reaches the live step from at least
    ``crash_at`` committed steps (a checkpoint and the commits it
    folds)."""
    import torch
    from repro_torch.swarm import chaos, driver
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    summ = driver.run_swarm(spec, device="cuda")
    wall = time.perf_counter() - t
    steps, workers = spec.run.steps, spec.swarm.workers
    res = [r for r in summ["worker_results"] if r is not None]
    log(f"[swarm] {tag}: {workers} workers, {steps} steps, "
        f"{summ['n_shards']} shards, in {wall:.1f} s, "
        f"{steps / wall:.3f} steps/s (process start and weights included; "
        f"coordinator {summ['wall_s']:.1f} s; median step "
        f"{summ['steady_step_s']} s; the workers time-slice one card, so "
        f"this says nothing of a swarm with a card per worker); "
        f"exits {summ['worker_exits']}, respawns {summ['respawns']}, "
        f"epochs {summ['membership_epochs']}, straggler steps "
        f"{summ['straggler_steps']}, steady bytes/step "
        f"{summ['steady_bytes_per_step']:.0f}")
    for r in res:
        if not r["joined"]:
            log(f"[swarm] {tag}: a worker did not join: {r}")
            continue
        log(f"[swarm] {tag}: worker {r['worker_id']} on {r['device']}: "
            f"set-up {r['build_s']:.2f} s, from step {r['restored_step']} "
            f"+ {r['folded']} folded commits in {r['fold_s']:.3f} s, "
            f"{r['steps_applied']} steps; peak memory {r['peak_gib']} GiB; "
            f"launches {r['launches']}")
    exits = list(summ["worker_exits"])
    if crash_at is not None:
        if exits.count(chaos.CRASH_EXIT) != 1 or summ["respawns"] != 1:
            raise SystemExit(f"swarm {tag}: exits {exits}, respawns "
                             f"{summ['respawns']}: want one crash and one "
                             "respawn")
        exits.remove(chaos.CRASH_EXIT)
        if not any(r["worker_id"] >= workers and r["joined"]
                   and r["restored_step"] + r["folded"] >= crash_at
                   for r in res):
            raise SystemExit(f"swarm {tag}: the respawned worker did not "
                             f"rejoin from {crash_at} committed steps")
    elif summ["respawns"]:
        raise SystemExit(f"swarm {tag}: {summ['respawns']} respawns")
    if exits != [0] * len(exits) or len(res) != workers:
        raise SystemExit(f"swarm {tag}: worker exits {summ['worker_exits']}"
                         f", {len(res)} results")
    for r in res:
        if not r["joined"]:
            raise SystemExit(f"swarm {tag}: a worker did not join: {r}")
        n = r["launches"]
        fwd = n["flash_attention"] // L
        if (r["device"] != "cuda"
                or r["steps_applied"] != steps
                or n["zo_axpy_2d"] != leaves * (steps - r["restored_step"])
                or fwd < 1 or n["flash_attention"] != L * fwd
                or n["pmatmul_stack"] != 6 * L * fwd
                or n["pmatmul"] != 2 * fwd):
            raise SystemExit(f"swarm {tag}: worker {r['worker_id']}: {r}")
    return summ, wall


def swarm_single(tag, spec, keep=False):
    """The same spec in this process through ``api.run``: launches against
    ``expected_launches``; with ``keep``, the final parameters as a host
    copy."""
    import torch
    from repro_torch.train.trainer import host_copy
    hist, launches, peak = run_counted(f"swarm {tag}", spec)
    check_launches(f"swarm {tag}", spec, hist["final_params"], launches)
    final = host_copy(hist["final_params"]) if keep else None
    del hist
    gc.collect()
    torch.cuda.empty_cache()
    return final


def swarm_same_params(tag, spec, final):
    """The designated worker's checkpoint at the last step against
    ``final`` (a host copy), bit for bit."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    ck = {p: torch.empty_like(t) for p, t in final.items()}
    _, step, _, _ = CheckpointManager(spec.run.ckpt_dir).restore(ck)
    bad = [p for p in final if not torch.equal(bits(ck[p]), bits(final[p]))]
    log(f"[swarm] {tag}: the designated worker's checkpoint at step {step}"
        f" against the single process's final parameters: "
        f"{len(final) - len(bad)} of {len(final)} leaves bit-equal")
    if step != spec.run.steps or bad:
        raise SystemExit(f"swarm {tag}: checkpoint step {step}, leaves "
                         f"differing {bad[:4]}")


def phase_swarm(full):
    """The seed-synchronized swarm, after every 13B weight of this process
    is freed.  First each kernel against its plain version at the shapes
    a worker's shard gives it (``swarm_parity``; returned by kernel for
    the ``kernels`` line).  Then at OPT-13B full width (``full``: the main
    path's spec, 2 loss shards of 8 rows, 2 workers on this one card) a
    calm run, the same spec in one process (streams bit for bit,
    launches as expected), a crash/rejoin run (stream bit for bit), and
    ``launch replay`` of the calm run; then at OPT-1.3B one run of 4
    workers with a crash at step 5 and a rejoin from the step-4
    checkpoint, against one process (stream and the designated worker's
    final checkpoint, bit for bit)."""
    import torch
    from repro_torch import api
    from repro_torch.core import zo
    from repro_torch.api.validate import swarm_shards
    from repro_torch.launch import replay
    from repro_torch.swarm import shardstep

    root = os.path.join(ROOT, "build", "chip_smoke_swarm")
    shutil.rmtree(root, ignore_errors=True)
    n_theta = shardstep.trainable_param_count(full)
    log(f"[swarm] {smi('name,power.limit')}; an FO gradient exchange moves "
        f"4·|θ| = {4 * n_theta} bytes a step at OPT-13B")
    small = api.with_overrides(full, {
        "model.variant": SWARM_SMALL_VARIANT, "swarm.n_shards": 4,
        "swarm.workers": 4})
    shard_rows = [(tag, api.derive(sp).model_cfg,
                   sp.run.batch_size // swarm_shards(sp))
                  for tag, sp in (("13B", full), ("1.3B", small))]
    parity = swarm_parity(shard_rows, full.optimizer.eps)
    try:
        L = api.derive(full).model_cfg.num_layers
        leaves = len(zo.leaf_items(shardstep.abstract_trainable(full)[0]))
        calm = swarm_spec(full, root, "calm")
        swarm_run("13B calm", calm, leaves, L)
        single = swarm_spec(full, root, "single")
        swarm_single("13B single-process", single)
        same = swarm_stream(calm) == swarm_stream(single)
        log(f"[swarm] 13B: swarm stream == single-process stream "
            f"({len(SWARM_STREAM)} keys, {full.run.steps} rows): {same}")
        if not same:
            raise SystemExit("swarm: the swarm's stream is not the single "
                             "process's bit for bit")
        crash = swarm_spec(full, root, "crash", **{"swarm.chaos_crash": "1:3"})
        swarm_run("13B crash/rejoin", crash, leaves, L, crash_at=3)
        same = swarm_stream(crash) == swarm_stream(calm)
        log(f"[swarm] 13B: crash/rejoin stream == calm stream: {same}")
        if not same:
            raise SystemExit("swarm: the crash/rejoin run is not the calm "
                             "run bit for bit")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        rep = replay.replay_run(swarm_rows(calm)[0], device="cuda")
        torch.cuda.synchronize()
        log(f"[swarm] 13B: launch replay of the calm run on "
            f"{rep['device']}: steps {rep['param_start']}..{rep['step']} in "
            f"{time.perf_counter() - t:.1f} s; ok {rep['ok']}; failures "
            f"{rep['failures'][:3]}")
        if not rep["ok"]:
            raise SystemExit("swarm: the calm run did not replay")
        del rep

        L = api.derive(small).model_cfg.num_layers
        leaves = len(zo.leaf_items(shardstep.abstract_trainable(small)[0]))
        w4 = swarm_spec(small, root, "w4", **{
            "run.ckpt_every": 4, "swarm.chaos_crash": "1:5"})
        summ, _ = swarm_run("1.3B 4 workers, crash at step 5", w4, leaves,
                            L, crash_at=5)
        if not any(r and r["worker_id"] >= small.swarm.workers
                   and r["restored_step"] > 0
                   for r in summ["worker_results"]):
            raise SystemExit("swarm: the respawned worker did not start "
                             "from a checkpoint")
        w1 = swarm_spec(small, root, "w1")
        final = swarm_single("1.3B single-process", w1, keep=True)
        same = swarm_stream(w4) == swarm_stream(w1)
        log(f"[swarm] 1.3B: 4-worker stream (crash and rejoin from a "
            f"checkpoint) == single-process stream: {same}")
        if not same:
            raise SystemExit("swarm: the 4-worker stream is not the single "
                             "process's bit for bit")
        swarm_same_params("1.3B 4 workers", w4, final)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return parity


MESH_STEPS, MESH_WARM, MESH_STEADY = 4, 2, 5
MESH_SPLITS = (2, 4, 8, 16)
MESH_PEAK_GATE = 0.10         # predicted peak within +-10 % of measured
MESH_USEFUL_GATE = 1.05


def mesh_zcfg(cfg):
    """The dry run's ``optimized`` lowering (stratified, gather, fused
    update, n_drop = 0.75 L = 30) with the sweeps on K1: the port's gather
    backend is plain PyTorch, so ``pallas`` is the backend that runs K1
    per local shard."""
    import dataclasses
    from repro_torch.launch import specs
    return dataclasses.replace(specs.zo_variant(cfg, "optimized"),
                               backend="pallas")


def mesh_batch(cfg, B=16, S=63):
    """The main path's shape: B 16 sequences of S 63 inputs, seeded."""
    import numpy as np
    import torch
    r = np.random.default_rng(7)
    toks = torch.as_tensor(r.integers(0, cfg.vocab, (B, S + 1)),
                           dtype=torch.int32, device="cuda")
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous(),
            "loss_mask": torch.ones((B, S), device="cuda")}


def mesh_run(tag, step, params, batch, steps, start=0):
    """``steps`` steps of ``step`` from ``start``: (losses, projected
    grads, per-step walls), each step synchronised."""
    import torch
    losses, grads, walls = [], [], []
    for t in range(start, start + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, m = step(params, batch, t, 0xC0FFEE)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        grads.append(float(m["projected_grad"]))
    if not all(map(math.isfinite, losses)):
        raise SystemExit(f"mesh {tag}: losses not finite: {losses}")
    return losses, grads, walls


def mesh_shard_windows(cfg, eps):
    """K3 at fc1 (D, F) and fc2 (F, D) and K4 at the tied head tok.T (D, V)
    split into n shards on N (column: ``col_off``, ``ld = N``) and on K
    (row: ``row_off``; partial sums added in float32), launched one shard
    after another at the main path's activations.  Column shards must
    equal the unsharded launch's columns bit for bit, row sums sit within
    n + 1 bf16 steps of it, and every shard within ``close``'s one step
    of the plain ``pmatmul`` at its window.  Returns the rows."""
    import torch
    from repro_torch.fused import matmul as fmm
    from repro_torch.fused import ref as fref

    dev, bf = "cuda", torch.bfloat16
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    M = 16 * 63
    g = torch.Generator(device=dev).manual_seed(11)
    seed = 0x5EED
    out = []
    mats = (("fc1", D, F, False), ("fc2", F, D, False), ("head", D, V, True))
    for name, K, N, head in mats:
        if head:
            tok = torch.randn((V, D), generator=g, device=dev, dtype=bf) * .02
            w = tok.T
            x = torch.randn((M, K), generator=g, device=dev, dtype=bf)
            fn, pfn = fmm.pmatmul, fref.pmatmul
            args, kw = (seed, eps, True), dict(trans=True, ld=D)
        else:
            w = torch.randn((K, N), generator=g, device=dev, dtype=bf) * .02
            x = torch.randn((2, M, K), generator=g, device=dev, dtype=bf)
            fn, pfn = fmm.pmatmul_stack, fref.pmatmul_stack
            args, kw = ((seed, seed), (eps, -eps), (True, True)), {}
        full = fn(x, w, *args, **kw)
        full_ms = time_ms(lambda: fn(x, w, *args, **kw))
        for split in ("column", "row"):
            for n in MESH_SPLITS:
                size = (N if split == "column" else K) // n
                parts, worst, same = [], 0.0, True
                routes = set()
                for r in range(n):
                    if split == "column":
                        wr, xr = w[:, r * size:(r + 1) * size], x
                        skw = dict(kw, col_off=r * size,
                                   ld=kw.get("ld", N))
                    else:
                        wr = w[r * size:(r + 1) * size]
                        xr = x[..., r * size:(r + 1) * size]
                        skw = dict(kw, row_off=r * size, ld=kw.get("ld", N))
                    before = {k: c.launches
                              for k, c in fmm.route_counters.items()}
                    got = fn(xr, wr, *args, **skw)
                    routes |= {k for k, c in fmm.route_counters.items()
                               if c.launches > before[k]}
                    worst = max(worst, close(
                        got, pfn(xr, wr, *args, **skw),
                        f"{name} {split} shard {r}/{n}"))
                    if split == "column":
                        same &= torch.equal(
                            got.view(torch.int16),
                            full[..., r * size:(r + 1) * size].contiguous()
                            .view(torch.int16))
                    parts.append(got)
                    del got
                if split == "column":
                    if not same:
                        close(torch.cat(parts, -1), full,
                              f"{name} column x{n} concatenated")
                    gap = 0.0
                else:
                    total = sum(p.float() for p in parts)
                    gap = bf16_steps(total, full.float())
                    if gap > n + 1:
                        raise SystemExit(f"mesh: {name} row x{n} partial "
                                         f"sums {gap:.2f} bf16 steps from "
                                         f"the unsharded launch (gate "
                                         f"{n + 1})")
                r0 = r * size if split == "row" else 0
                c0 = r * size if split == "column" else 0
                ms = time_ms(lambda: fn(xr, wr, *args, **skw))
                Ks, Ns = wr.shape
                P = 1 if head else 2
                b_ms, b_by = bound(
                    (xr.numel() + wr.numel() + P * M * Ns) * 2,
                    tensor_flops=2.0 * P * M * Ks * Ns,
                    instructions=Ks * Ns * RNG_OPS)
                lib_ms = time_ms(lambda: torch.matmul(xr, wr))
                out.append({"matrix": f"{name} ({K}, {N})", "split": split,
                            "n": n, "shard_route": sorted(routes),
                            "column_bit_equal": same if split == "column"
                            else None,
                            "row_sum_bf16_steps": gap if split == "row"
                            else None,
                            "max_abs_err_vs_plain": worst,
                            "shard_ms": ms, "unsharded_ms_over_n":
                            full_ms / n, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": lib_ms,
                            "last_window": [r0, c0]})
                log(f"[mesh] {name} ({K}, {N}) {split} x{n}: shards "
                    f"within 1 bf16 step of plain (max|err| {worst:.3e}); "
                    + (f"concatenated bit-equal to unsharded: {same}"
                       if split == "column" else
                       f"partial sums {gap:.2f} bf16 steps from unsharded")
                    + f"; routes {sorted(routes)}; shard {ms:.4f} ms vs "
                    f"unsharded/n {full_ms / n:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by}), torch.matmul {lib_ms:.4f} ms")
                del parts
        del w, x, full
        torch.cuda.empty_cache()
    return out


def mesh_engine(cfg, mesh, params):
    """The paged engine at OPT-13B full width and depth with the serve
    phase's settings and requests, plain and then over ``mesh`` (the
    1 x 1 one): greedy tokens bit-equal, K1-K4 launched no time (the
    paged attention is plain, as the reference's), the same kernels a
    steady decode step (within one), and for each the TTFT, tok/s and
    that step's wall and device time, idle share and kernels
    (``decode_profile``)."""
    import statistics
    import torch
    from repro_torch import api, serving
    from repro_torch.distributed import ctx

    sv = api.with_overrides(api.preset("lezo-opt13b"), {
        **MAIN_OVERRIDES, **SERVE_OVERRIDES})
    reqs = serve_requests(cfg.vocab, seed=sv.run.seed)
    toks, steady = {}, {}
    for tag, m in (("plain", None), ("mesh 1 x 1", mesh)):
        eng = serving.Engine(cfg, params, sv.serving, mesh=m, device="cuda")
        (got, results, wall), n, peak, _ = counted(lambda: drain(eng, [
            serving.Request(rid=rid, tokens=t, seed=SEED_BASE + rid)
            for rid, t in reqs]))
        ttft = sorted(r.ttft for r in results)
        n_tok = sum(len(t) for t in got.values())
        log(f"[mesh] engine {tag}: {len(results)} requests, {n_tok} tokens "
            f"in {wall:.3f} s = {n_tok / wall:.1f} tok/s; "
            f"{eng.n_prefill_calls} prefill calls, {eng.n_decode_steps} "
            f"decode steps; TTFT median {statistics.median(ttft):.3f} s, "
            f"p90 {ttft[int(0.9 * (len(ttft) - 1))]:.3f} s; peak "
            f"{peak:.2f} GiB; launches {n}")
        if (sorted(got) != list(range(SERVE_REQUESTS)) or eng.pool.in_use
                or any(n.values())):
            raise SystemExit(f"mesh: engine {tag} results {sorted(got)}, "
                             f"{eng.pool.in_use} pages left, launches {n}")
        steady[tag] = decode_profile(f"mesh engine {tag}", eng, reqs, sv)
        toks[tag] = got
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    ctx.set_mesh(None)
    diff = sorted(r for r in toks["plain"]
                  if toks["plain"][r] != toks["mesh 1 x 1"][r])
    log(f"[mesh] engine over the 1 x 1 mesh against the plain engine: "
        f"greedy tokens of {len(toks['plain'])} requests bit-equal: "
        f"{not diff}")
    if diff:
        raise SystemExit(f"mesh: engine tokens differ for rids {diff}")
    a, b = steady["plain"], steady["mesh 1 x 1"]
    log(f"[mesh] engine decode step over the 1 x 1 mesh against plain: "
        f"wall {b['step_ms']:.2f} / {a['step_ms']:.2f} ms (x"
        f"{b['step_ms'] / a['step_ms']:.2f}), device {b['device_ms']:.2f} / "
        f"{a['device_ms']:.2f} ms, kernels {b['kernels']:g} / "
        f"{a['kernels']:g} a step")
    # the 10-step window may catch a kernel or two more or less; a kernel
    # added or dropped on every step moves the mean by one
    if abs(b["kernels"] - a["kernels"]) >= 1:
        raise SystemExit("mesh: the engine over the 1 x 1 mesh runs other "
                         "kernels a decode step than the plain engine")


MESH_ZOO = ("deepseek-v2-lite-16b", "granite-moe-1b-a400m",
            "jamba-v0.1-52b")
MESH_ZOO_STEPS = 3
MESH_ZOO_LOCKSTEP = (4, 128, 4)     # batch, prompt, new tokens
MESH_ZOO_SERVED = ("deepseek-v2-lite-16b", "jamba-v0.1-52b")  # lockstep
MESH_ZOO_REQUESTS = 4               # granite's engine: requests, none shared
MESH_ZOO_NEW = 8                    # new tokens a request


def mesh_zoo_routes(cfg, forwards):
    """The routes ``forwards`` forwards of ``cfg`` must count: every MoE
    and Mamba layer on ``ctx.tp_block`` once a forward (the 1 x 1 mesh
    shards every leaf over a size-1 dim), ``rowwise`` never."""
    moe = sum(st.repeat for st in cfg.stages for b in st.pattern
              if b.ffn == "moe")
    mamba = sum(st.repeat for st in cfg.stages for b in st.pattern
                if b.kind == "mamba")
    want = {}
    if moe:
        want["tp", "moe"] = moe * forwards
    if mamba:
        want["tp", "mamba"] = mamba * forwards
    return want


def mesh_zoo_run(tag, cfg, zcfg, batch, mesh):
    """``MESH_ZOO_STEPS`` steps of ``make_zo_step`` on ``cfg``'s weights
    from the seed, plain (``mesh`` None) or over the 1 x 1 mesh, the
    launch counters and ``ctx.ROUTES`` zeroed just before and read just
    after; then PROFILE_STEPS more steps in a profiled window (kernel
    activity only).  Returns the run's readings and
    its parameters."""
    import statistics
    import torch
    from repro_torch.core import zo
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import specs
    from repro_torch.models import lm

    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    if mesh is None:
        step = zo.make_zo_step(functools.partial(lm.lm_loss, cfg),
                               zo.build_spec(params, lm.zo_group_fn), zcfg)
    else:
        step, _ = specs.build_train_step(cfg, mesh, zcfg=zcfg)
        params = sharding.params_sharding(cfg, params, mesh)
        batch = sharding.batch_sharding(batch, mesh)
    ctx.ROUTES.clear()
    (losses, grads, walls), n, peak, _ = counted(
        lambda: mesh_run(tag, step, params, batch, MESH_ZOO_STEPS))
    routes = dict(ctx.ROUTES)
    out = {"losses": losses, "grads": grads, "launches": n, "peak": peak,
           "routes": routes, "digest": params_digest(params),
           "wall": statistics.median(walls[1:]),
           "leaves": len(zo.leaf_items(params))}
    win = measure_window(f"mesh {tag}", lambda t: step(
        params, batch, t, 0xC0FFEE), PROFILE_STEPS, start=MESH_ZOO_STEPS,
        warm=0)
    out["prof_wall"], out["device"] = (win["wall"] / win["steps"],
                                       win["busy"] / win["steps"])
    out["kernels"] = win["kernels"]
    ctx.set_mesh(None)
    return out, params


def mesh_zoo_compare(arch, cfg, zcfg, plain, mesh):
    """The plain run against the 1 x 1 mesh run of ``arch``: losses,
    projected gradients and every leaf's bit sum equal; K1/K2 launches
    as reckoned (K1 a leaf a sweep, K2 an attention layer a forward) on
    both; every MoE and Mamba layer on the TP route once a forward, on
    ``rowwise`` never; the step wall, device time, kernels and peak
    side by side."""
    steps, A = MESH_ZOO_STEPS, attention_layers(cfg)
    want = {"zo_axpy_2d": plain["leaves"] * 3 * steps,
            "flash_attention": 2 * A * steps, "pmatmul_stack": 0,
            "pmatmul": 0}
    routes = mesh_zoo_routes(cfg, 2 * steps)
    same = (mesh["losses"] == plain["losses"]
            and mesh["grads"] == plain["grads"]
            and mesh["digest"] == plain["digest"])
    log(f"[mesh] {arch} ({cfg.num_layers} layers, B 16, S 63, {zcfg}): "
        f"{steps} steps over the 1 x 1 mesh vs plain: losses "
        f"{mesh['losses']} vs {plain['losses']}; projected grads equal "
        f"{mesh['grads'] == plain['grads']}; {plain['leaves']} leaf digests "
        f"equal {mesh['digest'] == plain['digest']}; launches mesh "
        f"{mesh['launches']}, plain {plain['launches']}, reckoned {want}; "
        f"routes {mesh['routes']} (reckoned {routes}), plain "
        f"{plain['routes']}")
    log(f"[mesh] {arch} {smi('name,power.limit')}: step wall median "
        f"{mesh['wall']:.4f} s vs plain {plain['wall']:.4f} s (x"
        f"{mesh['wall'] / plain['wall']:.2f}); one profiled step: wall "
        f"{mesh['prof_wall']:.4f} / {plain['prof_wall']:.4f} s, device "
        f"{mesh['device']:.4f} / {plain['device']:.4f} s, kernels "
        f"{mesh['kernels']} / {plain['kernels']}; peak "
        f"{mesh['peak']:.2f} / {plain['peak']:.2f} GiB")
    if not same:
        raise SystemExit(f"mesh: {arch} over the 1 x 1 mesh is not the "
                         "plain step bit for bit")
    if mesh["launches"] != want or plain["launches"] != want:
        raise SystemExit(f"mesh: {arch} launches {mesh['launches']} / "
                         f"{plain['launches']} != reckoned {want}")
    if mesh["routes"] != routes or plain["routes"]:
        raise SystemExit(f"mesh: {arch} routes {mesh['routes']} != "
                         f"reckoned {routes} (plain {plain['routes']})")


def mesh_zoo_lockstep(tag, cfg, params, mesh):
    """A lockstep prefill (``MESH_ZOO_LOCKSTEP``) and greedy decode
    steps, plain (``lm.prefill``/``serve_step``) or over ``mesh``
    (``specs.build_prefill_step``/``build_serve_step``: the caches placed
    by ``cache_pspec``, Mamba's on their channels, attention's K/V and
    MLA's latent on the sequence), the counters zeroed just before and
    read just after; then the same run twice more in a profiled window.
    Returns the logits by step, the tokens, launches, routes, wall, peak
    and device seconds."""
    import torch
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import specs
    from repro_torch.models import lm

    Bl, Sl, Gl = MESH_ZOO_LOCKSTEP
    toks = torch.randint(0, cfg.vocab, (Bl, Sl), generator=torch.Generator(
        ).manual_seed(5)).cuda()
    place = lambda x: x  # noqa: E731
    if mesh is None:
        prefill = lambda p, x: lm.prefill(cfg, p, x, Sl + Gl)  # noqa: E731
        serve = lambda p, c, x, i: lm.serve_step(cfg, p, c, x, i)  # noqa
    else:
        prefill, _ = specs.build_prefill_step(cfg, mesh, Sl + Gl)
        serve, _, _ = specs.build_serve_step(cfg, mesh, Sl + Gl, Bl)
        place = lambda x: sharding.batch_sharding(  # noqa: E731
            {"x": x}, mesh)["x"]

    def run():
        logits, caches = prefill(params, place(toks))
        out, got = [ctx.whole(logits)], []
        for i in range(Gl - 1):
            tok = torch.argmax(out[-1], -1)[:, None]
            got.append(tok)
            logits, caches = serve(params, caches, place(tok), Sl + i)
            out.append(ctx.whole(logits))
        got.append(torch.argmax(out[-1], -1)[:, None])
        return out, torch.cat(got, 1)
    ctx.ROUTES.clear()
    (logits, got), n, peak, wall = counted(run)
    routes = dict(ctx.ROUTES)
    win = measure_window(f"mesh {tag} lockstep", lambda i: run(), 2, warm=0)
    ctx.set_mesh(None)
    log(f"[mesh] {tag} lockstep ({Bl}, {Sl}) + {Gl - 1} decode steps: "
        f"{wall:.3f} s, device {win['busy'] / 2:.4f} s, peak {peak:.2f} "
        f"GiB, launches {n}, routes {routes}")
    return {"logits": logits, "tokens": got, "launches": n,
            "routes": routes, "wall": wall, "peak": peak,
            "device": win["busy"] / 2}


def mesh_zoo_engine(cfg, mesh):
    """granite-moe's paged engine over ``MESH_ZOO_REQUESTS`` requests
    with the ``serve`` phase's settings, plain and as
    ``Engine(mesh=...)`` over the 1 x 1 mesh, on the seeded weights:
    greedy tokens bit-equal, no K1-K4 launch, every MoE call on the TP
    route."""
    import torch
    from repro_torch import api, serving
    from repro_torch.distributed import ctx
    from repro_torch.models import lm

    sv = api.with_overrides(api.preset("lezo-opt13b"), {
        **MAIN_OVERRIDES, **SERVE_OVERRIDES,
        "serving.max_new_tokens": MESH_ZOO_NEW})
    reqs = serve_requests(cfg.vocab, seed=sv.run.seed, n=MESH_ZOO_REQUESTS,
                          shared=0)
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda")
    toks, seen = {}, {}
    for tag, m in (("plain", None), ("mesh 1 x 1", mesh)):
        eng = serving.Engine(cfg, params, sv.serving, mesh=m, device="cuda")
        ctx.ROUTES.clear()
        (got, results, wall), n, peak, _ = counted(lambda: drain(eng, [
            serving.Request(rid=rid, tokens=t, seed=SEED_BASE + rid)
            for rid, t in reqs]))
        seen[tag] = dict(ctx.ROUTES)
        n_tok = sum(len(t) for t in got.values())
        log(f"[mesh] {MESH_ZOO[1]} engine {tag}: {len(results)} requests, "
            f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; "
            f"{eng.n_prefill_calls} prefill calls, {eng.n_decode_steps} "
            f"decode steps; peak {peak:.2f} GiB; launches {n}; routes "
            f"{seen[tag]}")
        if (sorted(got) != list(range(MESH_ZOO_REQUESTS)) or eng.pool.in_use
                or any(n.values())):
            raise SystemExit(f"mesh: {MESH_ZOO[1]} engine {tag} results "
                             f"{sorted(got)}, {eng.pool.in_use} pages left, "
                             f"launches {n}")
        toks[tag] = got
        del eng
    ctx.set_mesh(None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if toks["plain"] != toks["mesh 1 x 1"]:
        raise SystemExit(f"mesh: {MESH_ZOO[1]}'s engine tokens over the "
                         "1 x 1 mesh differ from the plain engine's")
    if (seen["plain"] or set(seen["mesh 1 x 1"]) != {("tp", "moe")}
            or not seen["mesh 1 x 1"][("tp", "moe")]):
        raise SystemExit(f"mesh: {MESH_ZOO[1]} engine routes {seen}")
    log(f"[mesh] {MESH_ZOO[1]} engine over the 1 x 1 mesh: greedy tokens "
        f"of {MESH_ZOO_REQUESTS} requests bit-equal to the plain engine's")


def mesh_zoo(mesh):
    """The zoo's MoE and Mamba configs over the 1 x 1 mesh, where every
    rule shards over a size-1 dim and the MoE experts and Mamba mixers
    take the TP route (``ctx.tp_block``) with groups of one: deepseek-
    v2-lite and granite-moe at full width and depth, jamba at full width
    and the deepest depth in ``SSM_PERIODS`` whose mesh run and lockstep
    fit; each bit-equal to the plain run from the same seed (then
    granite's engine, deepseek's and jamba's lockstep)."""
    import torch
    from repro_torch import configs
    from repro_torch.distributed import ctx

    for arch in MESH_ZOO:
        full = configs.get(arch)
        depths = SSM_PERIODS if arch == SSM_JAMBA else (None,)
        for periods in depths:
            cfg = full if periods is None else dataclasses.replace(
                full, stages=(dataclasses.replace(full.stages[0],
                                                  repeat=periods),))
            zcfg = mesh_zcfg(cfg)
            batch = mesh_batch(cfg)
            try:                  # the mesh run first: the one at risk
                mesh_out, params = mesh_zoo_run(f"{arch} mesh", cfg, zcfg,
                                                batch, mesh)
                lock = (mesh_zoo_lockstep(f"{arch} mesh", cfg, params, mesh)
                        if arch in MESH_ZOO_SERVED else None)
            except torch.cuda.OutOfMemoryError as e:
                if periods is None or periods == depths[-1]:
                    raise
                log(f"[mesh] {arch} at {periods} periods does not fit the "
                    f"1 x 1 mesh run ({str(e).splitlines()[0]})")
                ctx.set_mesh(None)
                params = None
                gc.collect()
                torch.cuda.empty_cache()
                continue
            break
        tag = arch if periods is None else f"{arch} at {periods} of 4 " \
            "periods"
        del params
        gc.collect()
        torch.cuda.empty_cache()
        plain, params = mesh_zoo_run(f"{arch} plain", cfg, zcfg, batch, None)
        mesh_zoo_compare(tag, cfg, zcfg, plain, mesh_out)
        if lock:
            want = mesh_zoo_lockstep(f"{arch} plain", cfg, params, None)
            k2 = {"zo_axpy_2d": 0, "flash_attention": attention_layers(cfg),
                  "pmatmul_stack": 0, "pmatmul": 0}
            routes = mesh_zoo_routes(cfg, MESH_ZOO_LOCKSTEP[2])
            same = (len(lock["logits"]) == len(want["logits"]) and all(
                torch.equal(a, b)
                for a, b in zip(lock["logits"], want["logits"]))
                and torch.equal(lock["tokens"], want["tokens"]))
            log(f"[mesh] {tag} lockstep over the 1 x 1 mesh vs plain: "
                f"logits of {len(want['logits'])} steps and tokens "
                f"bit-equal {same}; K2 launches {lock['launches']} / "
                f"{want['launches']} (reckoned {k2}); routes "
                f"{lock['routes']} (reckoned {routes})")
            log(f"[mesh] {tag} lockstep {smi('name,power.limit')}: wall "
                f"{lock['wall']:.4f} / {want['wall']:.4f} s (x"
                f"{lock['wall'] / want['wall']:.2f}), device "
                f"{lock['device']:.4f} / {want['device']:.4f} s, peak "
                f"{lock['peak']:.2f} / {want['peak']:.2f} GiB, mesh / plain")
            if not same:
                raise SystemExit(f"mesh: {tag} lockstep over the 1 x 1 "
                                 "mesh is not the plain one bit for bit")
            if (lock["launches"] != k2 or want["launches"] != k2
                    or lock["routes"] != routes or want["routes"]):
                raise SystemExit(f"mesh: {tag} lockstep launches or routes "
                                 "off the reckoning")
        del params, plain, mesh_out, lock
        gc.collect()
        torch.cuda.empty_cache()
        if arch == MESH_ZOO[1]:
            mesh_zoo_engine(cfg, mesh)


def mesh_grid():
    """``python -m repro_torch.launch dryrun`` for opt-13b at train_4k and
    decode_32k on the fake 16 x 16 mesh (no card): each cell's line."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as tmp:
        for shape in ("train_4k", "decode_32k"):
            t = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch", "dryrun",
                 "--arch", "opt-13b", "--shape", shape, "--out", tmp],
                capture_output=True, text=True, cwd=ROOT, env=env,
                timeout=300)
            secs = time.perf_counter() - t
            cell = [ln for ln in r.stdout.splitlines() if ln.startswith("[")]
            if r.returncode or not cell:
                raise SystemExit(f"mesh: dryrun {shape} failed:\n"
                                 f"{r.stdout[-2000:]}{r.stderr[-2000:]}")
            with open(os.path.join(
                    tmp, f"opt-13b_{shape}_sp_optimized.json")) as f:
                rec = json.load(f)
            log(f"[mesh] grid {cell[0]}; per device: args "
                f"{rec['memory']['argument_bytes'] / 2 ** 30:.3f} GiB, temp "
                f"{rec['memory']['temp_bytes'] / 2 ** 30:.3f} GiB; "
                f"{secs:.1f} s")


def phase_mesh(eps):
    """The mesh layer on the card at OPT-13B full width and depth (see the
    module docstring); returns the shard-window rows by kernel."""
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.core import zo
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    cfg = configs.get("opt-13b")
    zcfg = mesh_zcfg(cfg)
    batch = mesh_batch(cfg)
    fresh = lambda: lm.init_params(  # noqa: E731
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    L, A = cfg.num_layers, attention_layers(cfg)

    # 1. the plain step, then the same function over a 1 x 1 mesh
    params = fresh()
    leaves = len(zo.leaf_items(params))
    plain = zo.make_zo_step(functools.partial(lm.lm_loss, cfg),
                            zo.build_spec(params, lm.zo_group_fn), zcfg)
    (pl_l, pl_g, _), n_plain, _, _ = counted(
        lambda: mesh_run("plain", plain, params, batch, MESH_STEPS))
    pl_digest = params_digest(params)
    _, _, pl_walls = mesh_run("plain steady", plain, params, batch,
                              MESH_WARM + MESH_STEADY, start=MESH_STEPS)
    del params, plain
    gc.collect()
    torch.cuda.empty_cache()

    port = 29400 + os.getpid() % 1000
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        step, _ = specs.build_train_step(cfg, mesh, zcfg=zcfg)
        params = sharding.params_sharding(cfg, fresh(), mesh)
        placed = sharding.batch_sharding(batch, mesh)
        (me_l, me_g, _), n_mesh, _, _ = counted(
            lambda: mesh_run("mesh", step, params, placed, MESH_STEPS))
        me_digest = params_digest(params)
        want = {"zo_axpy_2d": leaves * 3 * MESH_STEPS,
                "flash_attention": 2 * A * MESH_STEPS,
                "pmatmul_stack": 0, "pmatmul": 0}
        same = (me_l == pl_l and me_g == pl_g and me_digest == pl_digest)
        log(f"[mesh] 1 x 1 mesh step vs plain step, {MESH_STEPS} steps of "
            f"OPT-13B (B 16, S 63, {zcfg}): losses {me_l} vs {pl_l}; "
            f"projected grads equal {me_g == pl_g}; {leaves} leaf digests "
            f"equal {me_digest == pl_digest}; launches mesh {n_mesh}, plain "
            f"{n_plain}, reckoned {want}")
        if not same:
            raise SystemExit("mesh: the 1 x 1 mesh step is not the plain "
                             "step bit for bit")
        if n_mesh != want or n_plain != want:
            raise SystemExit(f"mesh: launches {n_mesh} / {n_plain} != "
                             f"reckoned {want}")

        # 2. steady mesh steps: wall, device time, idle share, peak
        mesh_run("mesh warm", step, params, placed, MESH_WARM - WINDOW_WARM,
                 start=MESH_STEPS)
        torch.cuda.reset_peak_memory_stats()
        win = measure_window("mesh steady", lambda t: mesh_run(
            "mesh steady", step, params, placed, 1, start=t),
            MESH_STEADY, start=MESH_STEPS + MESH_WARM - WINDOW_WARM)
        peak = torch.cuda.max_memory_allocated()
        busy, walls = win["busy"], win["walls"]
        dev_s = busy / MESH_STEADY
        wall = statistics.median(walls)
        plain_wall = statistics.median(pl_walls[MESH_WARM:])
        del params, placed, step
        gc.collect()
        torch.cuda.empty_cache()

        # 3. the paged engine over the same mesh against the plain one
        mesh_engine(cfg, mesh, fresh())
        gc.collect()
        torch.cuda.empty_cache()

        # 4. the zoo's MoE and Mamba configs over the same mesh
        t_zoo = time.perf_counter()
        mesh_zoo(mesh)
        log(f"[mesh] zoo over the 1 x 1 mesh {time.perf_counter() - t_zoo:.1f}"
            " s")
    finally:
        dist.destroy_process_group()

    # the dry run's prediction for the same function at the same shape
    try:
        rec = dryrun.run_cell("opt-13b", ShapeCfg("mesh_main", 63, 16,
                                                  "train"),
                              False, mesh_shape=(1, 1), zcfg=zcfg,
                              verbose=False)
    finally:
        dist.destroy_process_group()            # the dry run's fake group
    terms, mem = rec["roofline"], rec["memory"]
    pred_peak = mem["argument_bytes"] + mem["temp_bytes"]
    floor = max(terms["compute_s"], terms["memory_s"])
    log(f"[mesh] {smi('name,power.limit')}: measured over {MESH_STEADY} "
        f"steady mesh steps: wall median {wall:.4f} s (plain step "
        f"{plain_wall:.4f} s: DTensor dispatch adds {wall - plain_wall:+.4f} "
        f"s, x{wall / plain_wall:.3f}), device {dev_s:.4f} s a step, idle "
        f"share {1 - busy / sum(walls):.4f}, peak "
        f"{peak / 2 ** 30:.3f} GiB")
    log(f"[mesh] dry run of the same step on a fake 1 x 1 mesh "
        f"({rec['compile_s']} s, H100 SXM 700 W figures): compute "
        f"{terms['compute_s']:.6f} s, memory {terms['memory_s']:.6f} s, "
        f"collective {terms['collective_s']:.6f} s; flops "
        f"{terms['hlo_flops']:.4e}, bytes {terms['hlo_bytes']:.4e}, kernels "
        f"{terms['kernels']}; peak args {mem['argument_bytes'] / 2 ** 30:.3f}"
        f" + temp {mem['temp_bytes'] / 2 ** 30:.3f} = "
        f"{pred_peak / 2 ** 30:.3f} GiB; useful_flop_ratio "
        f"{rec['useful_flop_ratio']:.4f}")
    log(f"[mesh] side by side: device {dev_s:.6f} s >= roofline "
        f"{floor:.6f} s ({dev_s / floor:.2f}x); peak predicted "
        f"{pred_peak / 2 ** 30:.3f} vs measured {peak / 2 ** 30:.3f} GiB "
        f"({pred_peak / peak - 1:+.2%}, gate +-{MESH_PEAK_GATE:.0%})")
    if dev_s < floor:
        raise SystemExit("mesh: the card beat the dry run's roofline: the "
                         "counter lost work")
    if abs(pred_peak / peak - 1) > MESH_PEAK_GATE:
        raise SystemExit("mesh: predicted peak outside the gate")
    if rec["useful_flop_ratio"] > MESH_USEFUL_GATE:
        raise SystemExit("mesh: useful_flop_ratio above 1.05")

    # 5. K3/K4 per shard at full width
    rows = mesh_shard_windows(cfg, eps)
    # 6. the grid entry point
    mesh_grid()
    log(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")
    return {"pmatmul_stack": [r for r in rows if r["matrix"][:4] != "head"],
            "pmatmul": [r for r in rows if r["matrix"][:4] == "head"]}


TRACE_STEPS, TRACE_WARM = 10, 2     # steady steps, warm-up steps


def expected_tiles(cfg, spec, layer_sels):
    """(w_tile_loads, z_regens) the main path's steps must count, from
    K3/K4's grid (``fused.matmul.tile_counts``): per step, each layer's
    projections (``model_matmuls``) as one K3 launch each of the +-eps
    pair (P = 2, one seed), active where the step's recorded
    ``layer_sel`` says, and the head as two K4 launches (one a probe),
    always active."""
    from repro_torch.fused import matmul as fmm
    layer, head = fmm.model_matmuls(cfg)
    M = spec.run.batch_size * (spec.model.seq_len - 1)
    w = z = 0
    for sel in layer_sels:
        for on in sel:
            for K, N in layer:
                dw, dz = fmm.tile_counts(M, K, N, (1, 1), (bool(on),) * 2)
                w, z = w + dw, z + dz
        dw, dz = fmm.tile_counts(M, *head, (1,), (True,))
        w, z = w + 2 * dw, z + 2 * dz
    return w, z


def stats(xs):
    """'median (min-max)' of a list of seconds."""
    import statistics
    return (f"median {statistics.median(xs):.4f} s (min {min(xs):.4f}, "
            f"max {max(xs):.4f})")


def device_idle_share(spec, cfg, params, steps):
    """``measure_window`` over ``steps`` steady steps of the main path's
    step function after one warm step: device busy seconds (sum of
    kernel times), host wall seconds around the steps, and the idle
    share 1 - busy / wall."""
    win = measure_window("idle share", step_fn(spec, cfg, params), steps,
                         start=1000)
    return win["busy"], win["wall"], win["idle"]


def phase_trace(hold, cfg):
    """Steady-state step time of the main path with telemetry off and on.

    From the weights of ``train`` (kept on the host and put back before
    every run, so every run starts from them and later phases get them
    back): TRACE_WARM + TRACE_STEPS steps with telemetry off, then as
    many with it on (``fence=false``; ring and ``trace.jsonl`` in a
    temporary run directory), then off and on once more, each through
    ``api.run``; the median, min and max of ``step_seconds`` over the
    steady steps and of the ``train/step`` spans; launches equal on and
    off and to ``costs.step_counts``; counters against the steps and
    K3/K4's grid; the on/off ratio of the medians of both runs each way
    within 0.80-1.25.  Between them, the device's idle share over
    TRACE_STEPS steady steps (``torch.profiler``) and 4 steps with
    ``fence=true`` (the median of each stage span).  Returns what the
    ``replay`` phase needs: the last on-run, and the weights on the
    host."""
    import statistics
    import tempfile
    from repro_torch import api, estimators, obs
    from repro_torch.core import zo
    from repro_torch.fused import matmul as fmm
    from repro_torch.models import lm
    from repro_torch.train.trainer import host_copy, load_host_

    params = full_params(hold, cfg)
    steps = TRACE_WARM + TRACE_STEPS
    spec = api.with_overrides(api.preset("lezo-opt13b"), {
        **MAIN_OVERRIDES, "run.steps": steps})
    runs = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    out = {"runs": runs, "host": host_copy(params)}
    on_spec = api.with_overrides(spec, {
        "telemetry.enabled": True, "telemetry.runs_dir": runs})
    secs = {"off": [], "on": []}
    launches = {}

    def run(tag, sp):
        load_host_(params, out["host"])
        hist, n, peak = run_counted(f"trace {tag}", sp, params)
        check_launches(f"trace {tag}", sp, params, n)
        launches[tag] = n
        return hist, peak

    for i, mode in enumerate(("off", "on", "off", "on")):
        if i == 3:                       # between the pairs
            load_host_(params, out["host"])
            busy, wall, idle = device_idle_share(spec, cfg, params,
                                                 TRACE_STEPS)
            log(f"[trace] torch.profiler over {TRACE_STEPS} steady "
                f"steps: wall {wall:.4f} s, device busy {busy:.4f} s, "
                f"idle share {idle:.4f}")
            fence_spec = api.with_overrides(on_spec, {
                "run.steps": 4, "telemetry.fence": True})
            hist_f, _ = run("fence", fence_spec)
            fd = obs.load_run(hist_f["run_id"], runs)
            spans = obs.spans_from_jsonl(
                os.path.join(fd.dir, obs.runlog.TRACE_FILE))
            for name in (obs.TRAIN_STEP, obs.FWD_PAIR, obs.UPDATE):
                dts = [s.dt for s in spans if s.name == name]
                log(f"[trace] fence=true, {name}: {len(dts)} spans, "
                    f"{stats(dts)}")
        hist, peak = run(f"{mode} {i // 2 + 1}",
                         on_spec if mode == "on" else spec)
        steady = hist["step_seconds"][TRACE_WARM:]
        secs[mode] += steady
        log(f"[trace] {TRACE_STEPS} steady steps, telemetry {mode} "
            f"({i // 2 + 1}): step_seconds {stats(steady)}; peak memory "
            f"{peak:.2f} GiB")
    # the last run is the telemetry-on run replay re-executes
    out["run_id"] = hist["run_id"]
    rd = obs.load_run(hist["run_id"], runs)
    trace = obs.read_jsonl(os.path.join(rd.dir, obs.runlog.TRACE_FILE))
    span_s = [e["dt"] for e in trace if e.get("type") == "span"
              and e["name"] == obs.TRAIN_STEP][TRACE_WARM:]
    ratio = statistics.median(secs["on"]) / statistics.median(secs["off"])
    log(f"[trace] telemetry on (fence=false), last run: train/step spans "
        f"{stats(span_s)}; both runs each way: off {stats(secs['off'])}, "
        f"on {stats(secs['on'])}; on/off median ratio {ratio:.4f}")
    counters = [e for e in trace if e.get("type") == "counters"][-1]
    c, g = counters["counters"], counters["gauges"]
    est = estimators.build_estimator(zo.build_spec(params, lm.zo_group_fn),
                                     api.derive(spec).est_cfg)
    sels = [r["layer_sel"] for r in rd.steps]
    w_want, z_want = expected_tiles(cfg, spec, sels)
    want = {obs.CTR_PROBES: 2 * steps, obs.CTR_SELECTS: steps,
            obs.CTR_AXPY: est.step_counts()["axpy_sweeps"] * steps,
            obs.CTR_WLOAD: w_want, obs.CTR_ZREGEN: z_want}
    per_w = (cfg.d_model // 64) * (cfg.d_ff // 64)
    zt = fmm.tile_counts(1008, cfg.d_model, cfg.d_ff, (1, 1), (True,) * 2)
    log(f"[trace] counters {c}; gauges {g}; K3 (D, d_ff) active pair: z "
        f"tiles per W tile {zt[1] / per_w:g}")
    if len({str(n) for n in launches.values() if n is not None}) > 2:
        raise SystemExit(f"trace: launches differ between runs {launches}")
    if launches["on 1"] != launches["off 1"]:
        raise SystemExit(f"trace: launches with telemetry on "
                         f"{launches['on 1']} != off {launches['off 1']}")
    bad = {k: (c.get(k), v) for k, v in want.items() if c.get(k) != v}
    if bad or g.get(obs.GAUGE_ACTIVE) != sum(sels[-1]):
        raise SystemExit(f"trace: counters (got, want) {bad}; gauge {g}")
    if not 0.80 <= ratio <= 1.25:
        raise SystemExit(f"trace: on/off median step ratio {ratio:.4f} "
                         "outside 0.80-1.25")
    return out


def phase_replay(held, params):
    """``launch replay`` of the ``trace`` phase's last telemetry-on run on
    the card: from the weights that run started from, every recorded
    step re-executed through the trainer's step (the last included) and
    every recorded scalar compared bit for bit, then every parameter
    against the run's final ones (``params``).  Then the drain time of
    one logged step with ``health_norms`` (the exact ‖z‖ at 13B) and the
    report's stage-timing table."""
    import copy
    import numpy as np
    import torch
    from repro_torch import api, obs
    from repro_torch.launch import replay, report
    from repro_torch.train.trainer import Trainer, load_host_

    runs, rid = held["runs"], held["run_id"]
    p0 = load_host_(copy.deepcopy(params), held["host"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = replay.replay_run(rid, runs_root=runs, device="cuda", params=p0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    same = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               if a.dtype == torch.bfloat16 else torch.equal(a, b)
               for a, b in zip(p0.parameters(), params.parameters()))
    log(f"[replay] run {rid}: steps {rep['param_start']}..{rep['step']} "
        f"re-executed on {rep['device']} in {secs:.2f} s; ok {rep['ok']}; "
        f"failures {rep['failures'][:3]}; every parameter bit-equal to "
        f"the run's: {same}")
    del p0, rep["final_params"]
    if not rep["ok"] or rep["failures"] or not same:
        raise SystemExit("replay: the run did not replay bit for bit")
    rd = obs.load_run(rid, runs)
    spec = api.with_overrides(api.from_dict(rd.spec), {
        "telemetry.enabled": False, "telemetry.health_norms": True})
    tr = Trainer.from_spec(spec, params=params)
    row = rd.steps[-1]
    tr.health.record(row["step"], {
        "coeffs": np.asarray(row["coeffs"], np.float32),
        "n_active_params": np.asarray(row["n_active_params"], np.float32),
        "lr": np.float32(row["lr"]),
        "layer_sel": np.asarray(row["layer_sel"], np.int32)},
        seed=row["seed"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    drained = tr.health.drain()[0]
    secs = time.perf_counter() - t
    log(f"[replay] health_norms drain of one logged step: {secs:.3f} s; "
        f"update_norm {drained['update_norm']:.6g} against the estimate "
        f"{drained['update_norm_est']:.6g}")
    if not math.isclose(drained["update_norm"], drained["update_norm_est"],
                        rel_tol=1e-3):
        raise SystemExit("replay: exact update norm off the E||z||^2 = N "
                         "estimate by more than 1e-3")
    md = report.report_run(rid, runs_root=runs)["markdown"]
    table = md[md.index("## Stage timings"):].strip().splitlines()
    for line in table:
        log(f"[replay] report: {line}")


SOURCES = {
    "zo_axpy_2d": ("src/repro_torch/csrc/zo_axpy.cu",
                   "src/repro/kernels/zo_axpy.py:82"),
    "flash_attention": ("src/repro_torch/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:87"),
    "pmatmul_stack": ("src/repro_torch/csrc/pmatmul.cu",
                      "src/repro/fused/matmul.py:273"),
    "pmatmul": ("src/repro_torch/csrc/pmatmul.cu",
                "src/repro/fused/matmul.py:154"),
    "norm_rows": ("src/repro_torch/csrc/norm.cu",
                  "no pallas_call: the reference's norms are XLA ops "
                  "(src/repro/models/layers.py:32, :38)"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "no pallas_call: the reference's scan is "
                   "lax.associative_scan (src/repro/models/ssm.py:82)"),
}


PHASES = ("build", "rng", "parity", "train", "check", "profile", "trace",
          "replay", "estimators", "mezo", "momentum", "tasks", "peft",
          "serve", "zoo", "moe", "ssm", "modes", "fo", "resume", "swarm",
          "mesh")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases to run (default: all)")
    phases = ap.parse_args().phases.split(",")
    if set(phases) - set(PHASES) or (
            {"check", "profile"} & set(phases) and "train" not in phases) \
            or ("replay" in phases and "trace" not in phases):
        ap.error(f"--phases takes a subset of {','.join(PHASES)}; check "
                 "and profile need train, replay needs trace")
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

    t0 = last = time.perf_counter()

    def lap(name):                   # each phase's seconds, as it ends
        nonlocal last
        log(f"[time] {name} {time.perf_counter() - last:.1f} s")
        last = time.perf_counter()

    spec = api.with_overrides(api.preset("lezo-opt13b"), MAIN_OVERRIDES)
    cfg = api.derive(spec).model_cfg
    rows, launches = {}, {}
    k1_sass = phase_build() if "build" in phases else None
    lap("build")
    if "rng" in phases:
        phase_rng()
        lap("rng")
    if "parity" in phases:
        rows = phase_parity(cfg, spec.optimizer.eps, k1_sass)
        lap("parity")
    hold = {}                        # the full-size weights, built once
    if "train" in phases:
        spec, cfg, hold["params"], launches = phase_train()
        lap("train")
    if "check" in phases:
        phase_check(spec, cfg, hold["params"])
        lap("check")
    if "profile" in phases:
        phase_profile(spec, cfg, hold["params"])
        lap("profile")
    if "trace" in phases:
        from repro_torch.train.trainer import load_host_
        held = phase_trace(hold, cfg)
        try:
            if "replay" in phases:
                phase_replay(held, hold["params"])
        finally:                     # later phases get train's weights
            load_host_(hold["params"], held["host"])
            shutil.rmtree(held["runs"], ignore_errors=True)
        del held
        gc.collect()
        torch.cuda.empty_cache()
        lap("trace")
    if "estimators" in phases:
        phase_estimators(hold, cfg)
        lap("estimators")
    if "mezo" in phases:
        phase_mezo(hold, cfg)
        lap("mezo")
    if "momentum" in phases:
        phase_momentum(hold, cfg)
        lap("momentum")
    if "tasks" in phases:
        phase_tasks(hold, cfg)
        lap("tasks")
    if "peft" in phases:
        phase_peft(hold, cfg)
        lap("peft")
    if "serve" in phases:
        rows.setdefault("flash_attention", {})["serve_shapes"] = \
            phase_serve(hold, cfg)
        lap("serve")
    hold.clear()                     # the zoo and FO build their own weights
    gc.collect()
    torch.cuda.empty_cache()
    if "zoo" in phases:
        for name, shapes in phase_zoo(spec.optimizer.eps).items():
            rows.setdefault(name, {})["zoo_shapes"] = shapes
        lap("zoo")
    if "moe" in phases:
        for name, shapes in phase_moe(spec.optimizer.eps).items():
            rows.setdefault(name, {})["moe_shapes"] = shapes
        lap("moe")
    if "ssm" in phases:
        for name, shapes in phase_ssm(spec.optimizer.eps).items():
            rows.setdefault(name, {})["ssm_shapes"] = shapes
        lap("ssm")
    if "modes" in phases:
        for name, shapes in phase_modes(spec.optimizer.eps).items():
            rows.setdefault(name, {})["modes_shapes"] = shapes
        lap("modes")
    if "fo" in phases:
        phase_fo(cfg)
        lap("fo")
    if "resume" in phases:
        phase_resume()
        lap("resume")
    if "swarm" in phases:
        parity = phase_swarm(api.with_overrides(api.preset("lezo-opt13b"), {
            **MAIN_OVERRIDES, "run.steps": SWARM_STEPS,
            "swarm.workers": 2}))
        for name, shapes in parity.items():
            rows.setdefault(name, {})["swarm_shapes"] = shapes
        lap("swarm")
    if "mesh" in phases:
        for name, shapes in phase_mesh(spec.optimizer.eps).items():
            rows.setdefault(name, {})["mesh_shapes"] = shapes
        lap("mesh")
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
    lost = WINDOWS["lost"]
    if lost:
        log(f"[windows] {len(lost)} windows whole, {WINDOWS['refused']} "
            "refused and measured again; fills lost of "
            f"{WINDOW_EDGE} at the opening edge: at most "
            f"{max(a for a, _ in lost)} ({sum(a > 0 for a, _ in lost)} "
            f"windows lost any), at the closing edge: at most "
            f"{max(b for _, b in lost)} ({sum(b > 0 for _, b in lost)})")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi("name,power.limit"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

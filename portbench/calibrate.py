#!/usr/bin/env python3
"""The readings that a cell's limits are set from (``limits/<cell>.json``).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out FILE]

For each seed, the program's first steps as a run makes them (set-up
and one window step) against the reference's: the sound reading of each
number.  On the control seeds, the control (the reference one precision
below the configuration's, ``prec="fp8"``) in the program's place.  On
the fault seeds, the program with each of ``program.FAULTS`` planted.
Each reading's reference follows the losses of what it judges, as a
run's does.
One JSON line a reading, to standard output and to ``--out``.  Not part
of a benchmark run.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _seeds(s):
    return [int(x) for x in s.split(",") if x]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    import torch

    from portbench import check, program, spec
    from portbench import run as bench
    from portbench.reference import common

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(args.workload, REPO)
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        line = json.dumps(dict(cell=cell.name, **rec))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def reference(seed, prec="f32", follow=None):
        t = time.perf_counter()
        r = common.run(cell.family, cell.config, cell.traffic, seed,
                       bench.CHECK_STEPS, "cuda", prec=prec, follow=follow)
        return r, time.perf_counter() - t

    def keep(r):
        return {k: r[k] for k in ("l_plus", "l_minus", "g")}

    seeds = list(dict.fromkeys(args.seeds + args.control_seeds
                               + args.fault_seeds))
    for seed in seeds:
        t = time.perf_counter()
        got = bench.program_run(cell, seed, 0, False, "cuda", t)
        if seed in args.seeds:
            ref, ref_s = reference(seed, follow=got["prog"])
            emit(seed=seed, kind="sound",
                 numbers=check.numbers(got["prog"], ref),
                 prog=keep(got["prog"]), ref=keep(ref),
                 setup_s=got["e2e"]["setup_s"], reference_s=ref_s)
        if seed in args.control_seeds:
            ctrl, ctrl_s = reference(seed, "fp8")
            ref, _ = reference(seed, follow=ctrl)
            emit(seed=seed, kind="control", numbers=check.numbers(ctrl, ref),
                 ctrl=keep(ctrl), ref=keep(ref), control_s=ctrl_s)
        if seed in args.fault_seeds:
            for f in program.FAULTS:
                bad = bench.program_run(cell, seed, 0, False, "cuda",
                                        time.perf_counter(), fault=f)
                ref, _ = reference(seed, follow=bad["prog"])
                emit(seed=seed, kind=f"fault:{f}",
                     numbers=check.numbers(bad["prog"], ref),
                     prog=keep(bad["prog"]), ref=keep(ref))
        del got
        torch.cuda.empty_cache()
    print(f"[calibrate] {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

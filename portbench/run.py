#!/usr/bin/env python3
"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's weights on the card from the seed, builds the ZO
step of ``repro_torch`` (the first run of a checkout compiles its
kernels into ``build/repro_torch/``) and drives it through its first
steps, which every later shape reuses.  The window then runs steps for
``--seconds``, each on a new batch made from the seed.  With ``--trace
1`` the same window gives the model flop rate, and fenced spans and a
profiled window follow it.  Once the window has closed and the peak
memory is read, the program's state is freed and the plain reference
repeats the first steps from the seed; their losses, projected
gradients and parameter changes decide ``correct`` (``check.py``).

The last line of standard output is the result, a JSON object; the
numbers compared are the last lines of standard error.  A run without
as many cards as the cell asks for fails and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke")
CHECK_STEPS = 3          # set-up steps the reference repeats
SPAN_STEPS = 4           # fenced steps (--trace 1)
PROFILE_STEPS = 3        # profiled steps (--trace 1)


def _gib(n):
    return n / 2 ** 30


def _finite(m):
    return all(math.isfinite(float(m[k])) for k in ("l_plus", "l_minus"))


def program_run(cell, seed, seconds, trace, device, t0, fault=None):
    """Set-up, the window and (``trace``) the traced phases of the
    program on ``cell``; ``fault`` breaks its step (``program.FAULTS``).
    Returns {"prog": what the first steps made, "e2e": the end-to-end
    values, "steps", "failed", "peak", "traced"}; the program's state is
    freed on return."""
    import torch

    from portbench import feed, program, zrng

    cuda = device == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg, traffic = cell.config, cell.traffic
    mcfg = program.model_config(cfg)
    leaves = cell.family.leaves(cfg)
    if sorted(program.leaves(mcfg)) != sorted(leaves):
        raise ValueError(f"{cfg['name']}: the program's parameters are not "
                         "the configuration's")
    vocab, base = cfg["vocab_size"], zrng.fold(seed, 0xC0FFEE)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {"e2e": {}, "traced": None}
    marks = [("imports", time.perf_counter())]
    with program.fault(fault), torch.no_grad():
        params = program.make_params(mcfg, seed, device)
        step, state = program.build_step(mcfg, traffic, params)
        sync()
        marks.append(("weights", time.perf_counter()))

        def run(t, batch=None):
            nonlocal params, state
            if batch is None:
                batch = feed.batch(seed, t, traffic, vocab, device)
            params, state, m = step(params, state, batch, t, base)
            return m

        first = [feed.batch(seed, t, traffic, vocab, device)
                 for t in range(CHECK_STEPS)]
        rows = torch.cat([b["tokens"] for b in first])
        if torch.unique(rows, dim=0).shape[0] != rows.shape[0]:
            raise ValueError("the checked steps' rows are not all distinct")
        prog = {"l_plus": [], "l_minus": [], "g": []}
        for t, b in enumerate(first):
            m = run(t, b)
            for key, name in (("l_plus", "l_plus"), ("l_minus", "l_minus"),
                              ("g", "projected_grad")):
                prog[key].append(float(m[name]))
        sync()
        marks.append(("first steps", time.perf_counter()))
        out["e2e"]["setup_s"] = marks[-1][1] - t0
        # the check's reading of the changes is neither set-up's time
        # nor its memory: the peak is set-up's before it and the
        # window's after it
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        prog["change"] = program.changes(params, seed, device)
        out["prog"] = prog
        del first, rows
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        marks.append(("changes (the check's, not set-up)",
                      time.perf_counter()))
        print("[setup] " + ", ".join(
            f"{name} {b - a:.3f} s" for (_, a), (name, b) in
            zip([("start", t0)] + marks, marks)), file=sys.stderr)

        t, steps, failed = CHECK_STEPS, 0, 0
        start = time.perf_counter()
        while True:
            failed += not _finite(run(t))
            t, steps = t + 1, steps + 1
            if time.perf_counter() - start >= seconds:
                break
        sync()
        elapsed = time.perf_counter() - start
        out["e2e"]["train_tokens_per_s"] = (
            steps * feed.tokens_per_step(traffic) / elapsed)
        out["peak"] = max(peak, torch.cuda.max_memory_allocated()
                          if cuda else 0)
        out["e2e"]["peak_mem_gib"] = _gib(out["peak"])
        out["steps"], out["failed"] = steps, failed
        if trace:
            out["traced"] = _traced(cell, leaves, run, t, base, steps,
                                    elapsed, seed, device)
        params = state = step = run = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def run_cell(cell, seed, seconds, trace, device, t0, fault=None):
    """The result of one run of ``cell`` (``spec.Cell``) on ``device``."""
    import torch

    from portbench import check
    from portbench.reference import common

    got = program_run(cell, seed, seconds, trace, device, t0, fault)
    ref = common.run(cell.family, cell.config, cell.traffic, seed,
                     CHECK_STEPS, device, follow=got["prog"])
    nums = check.numbers(got["prog"], ref,
                         cell.limits["numbers"]["grad_gap"].get("scale"))
    ok, shown = check.judge(nums, cell.limits)
    traced = got["traced"]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = m["reader"].read(traced)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": got["e2e"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    cuda = device == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": got["peak"]}
    result = {"correct": ok and got["failed"] == 0,
              "attempted": got["steps"], "failed": got["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = traced.window["busy"]
        dev["window_s"] = traced.window["wall"]
        result["breakdown"] = {"device_ops": traced.window["device_ops"],
                               "idle_gaps": traced.window["idle_gaps"]}
    result["check"] = shown
    return result


def _traced(cell, leaves, run, t, base, steps, elapsed, seed, device):
    """What the per-layer readers read: the timed window's rate, fenced
    spans over SPAN_STEPS steps and a profiled window of PROFILE_STEPS
    (device records only), with the work those steps need; and the
    device's idle gaps by host op from a second profiled window that
    records the host too."""
    import torch

    from portbench import feed, program, window, work, zrng

    cfg, traffic, fam = cell.config, cell.traffic, cell.family
    vocab = cfg["vocab_size"]
    sizes = zrng.groups(leaves)
    n_drop = int(traffic["sparsity"] * sum(sizes.values()))
    batches = [feed.batch(seed, t + k, traffic, vocab, device)
               for k in range(SPAN_STEPS)]
    scope, ring, stages = program.spans()
    with scope:
        for k, b in enumerate(batches):
            run(t + k, b)
    t += SPAN_STEPS
    sums = {key: sum(r.dt for r in ring.records() if r.name in names)
            for key, names in stages.items()}
    torch.cuda.synchronize()

    n = window.TRIES * (1 + PROFILE_STEPS)
    batches = [feed.batch(seed, t + k, traffic, vocab, device)
               for k in range(n)]
    win = window.measure(lambda k: run(t + k, batches[k]), PROFILE_STEPS,
                         program.launches, program.KERNELS)
    sel = [zrng.select(sizes, zrng.step_seed(base, t + win["first"] + k),
                       n_drop) for k in range(PROFILE_STEPS)]
    t += n
    batches = [feed.batch(seed, t + k, traffic, vocab, device)
               for k in range(n)]
    win["idle_gaps"] = window.measure(
        lambda k: run(t + k, batches[k]), PROFILE_STEPS, program.launches,
        program.KERNELS, cpu=True)["idle_gaps"]
    return types.SimpleNamespace(
        cell=cell.name, config=cfg, traffic=traffic,
        peak=work.peaks(torch.cuda.get_device_name(0)),
        timed={"steps": steps, "seconds": elapsed,
               "model_flops": steps * work.model_flops_per_step(
                   cfg, fam, traffic, leaves)},
        spans={"steps": SPAN_STEPS, "sums": sums},
        window=win,
        work={"k1_bytes": work.k1_bytes(
            leaves, sel, work.K1_SWEEPS[traffic["forward_backend"]])})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from portbench import spec

    cell = spec.load(args.workload, REPO)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T0)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

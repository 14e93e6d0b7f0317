"""Optional ``torch.profiler`` region behind ``telemetry.profile_dir``
(counterpart of ``repro/obs/profiler.py``).

The obs spans answer "which *stage* is slow"; when the question drops to
"which *kernel* inside the stage", the profiler takes over.  ``with
obs.profile(dir):`` wraps a region in ``torch.profiler.profile`` (host
and, where CUDA is available, device activity) and writes a Chrome trace
into ``dir`` when the region ends; with no directory it is a free no-op,
so call sites carry one line whatever the configuration.  A profiler
that fails to start or stop is demoted to a warning, so it cannot take a
training run down; an exception from the profiled body always
propagates.
"""
from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Optional

import torch

TRACE_NAME = "trace-{stamp}-{pid}.json"


@contextlib.contextmanager
def profile(profile_dir: Optional[str]):
    """``torch.profiler.profile`` writing a Chrome trace into
    ``profile_dir`` when one is given, else a no-op."""
    if not profile_dir:
        yield
        return
    prof = None
    try:
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except (RuntimeError, OSError) as e:  # pragma: no cover - env-dependent
        prof = None
        warnings.warn(f"obs: torch.profiler unavailable ({e!r}); "
                      "continuing without a device trace")
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    profile_dir, TRACE_NAME.format(
                        stamp=time.strftime("%Y%m%d-%H%M%S"),
                        pid=os.getpid())))
            except (RuntimeError, OSError) as e:  # pragma: no cover
                warnings.warn(f"obs: torch.profiler trace close failed "
                              f"({e!r})")

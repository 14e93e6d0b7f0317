"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and loaded with ``ctypes``
(the ``hopper-kernels`` guide's route (b): seconds per build, against
minutes for a source that includes PyTorch's headers).  Libraries land
in ``build/repro_torch/`` at the repo root, named by a hash of their
sources, so an edited source is rebuilt and an unchanged one is reused.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them; ``lib(name)`` loads one library, building it first if needed.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.

Flags: ``-O3`` and no ``--use_fast_math``, since ``__logf``/``__cosf``
would move z far beyond the few ulp the reference tolerates;
``--fmad=false`` keeps ``decay*x + scale*z`` and the RNG's float steps as
separately rounded multiplies and adds, the op order the plain PyTorch
versions and the reference use.  ``-ldl``: ``pmatmul.cu`` takes
``cuTensorMapEncodeTiled`` from ``libcuda.so.1`` with ``dlsym``, so no
library links against ``libcuda``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("zo_axpy", "flash_attn", "pmatmul", "rng_check")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-ldl")

_LIBS: Dict[str, ctypes.CDLL] = {}


class Counter:
    """Launches of one kernel since the last reset.  A wrapper adds one
    where it launches its kernel, and nowhere else: calls that take the
    plain version do not count."""

    def __init__(self):
        self.launches = 0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; return the compiler's
    report (registers, shared memory, spills) per source."""
    jobs = {n: _start(n) for n in names}
    reports = {}
    for n, job in jobs.items():
        if job is None:
            reports[n] = "cached"
            continue
        out, tmp, proc = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
        os.replace(tmp, out)
        reports[n] = log
    return reports


def function(name: str, symbol: str, argtypes):
    """The C launcher ``symbol`` of ``csrc/<name>.cu`` (built and loaded
    on first use), returning a ``cudaError_t`` as int."""
    if name not in _LIBS:
        build_all((name,))
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    fn = getattr(_LIBS[name], symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def check(err: int, what: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")

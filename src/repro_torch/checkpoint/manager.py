"""Checkpoints of the port in the reference's on-disk format
(counterpart of ``repro/checkpoint/manager.py``).

ZO optimizer state is (params, step, base_seed), so a checkpoint is the
parameter tree plus a small manifest::

    <dir>/step_<step:010d>/arrays.npz      one array per leaf path
    <dir>/step_<step:010d>/manifest.json   step, base_seed, extra, leaves

keyed by the reference's leaf paths (``stages/s0/b0/mix/wq``, ...), so a
checkpoint written by either package restores into the other.  bfloat16
leaves are stored as the reference's numpy writes them: 2-byte void
records holding the bfloat16 bits, with ``"dtype": "bfloat16"`` in the
manifest, which is how they are read back bit for bit.

* atomic: written to ``<dir>/tmp.<step>`` and renamed, so no partial
  checkpoint is ever on disk under a ``step_`` name;
* async: ``save(..., blocking=False)`` copies the parameters to the host
  at once (the train loop updates them in place afterwards), then writes
  on a daemon thread; an error of that write is raised by the next
  ``wait()`` (``save`` and the trainer's end of run call it), so a
  checkpoint is never lost silently;
* keep-k GC and newest-first ``latest()``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import zo

_BF16 = np.dtype("V2")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def flatten(params) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` of a parameter module or a PEFT dict tree, the
    reference's keys."""
    return dict(zo.leaf_items(params))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, params, base_seed: int,
             extra: Optional[dict] = None, blocking: bool = True):
        self.wait()
        leaves = flatten(params)
        flat = {k: _to_numpy(v) for k, v in leaves.items()}
        manifest = {
            "step": int(step),
            "base_seed": int(base_seed),
            "extra": extra or {},
            "leaves": {k: {"shape": list(v.shape),
                           "dtype": ("bfloat16" if v.dtype == _BF16
                                     else str(v.dtype))}
                       for k, v in flat.items()},
        }

        def _write():
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        def _write_async():
            try:
                _write()
            except Exception as e:  # re-raised by wait()
                self._error = e

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write_async, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the pending asynchronous write; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                f"asynchronous checkpoint write to {self.dir} failed") \
                from err

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        return sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                      if n.startswith("step_"))

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _dir(self, step: Optional[int]) -> str:
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return os.path.join(self.dir, f"step_{step:010d}")

    def read_manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The manifest alone, so a resume can check the saved spec
        (``extra["spec"]``) before any array is read."""
        with open(os.path.join(self._dir(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, template, step: Optional[int] = None):
        """Load a checkpoint into ``template``'s parameters in place,
        cast to their dtypes, after checking every leaf is present with
        its shape.  Returns (params, step, base_seed, extra)."""
        d = self._dir(step)
        manifest = self.read_manifest(step)
        data = np.load(os.path.join(d, "arrays.npz"))
        leaves = flatten(template)
        arrays = {}
        for path, leaf in leaves.items():
            if path not in data.files:
                raise KeyError(f"checkpoint {d} missing leaf {path}")
            arr = data[path]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {path}: ckpt "
                                 f"{arr.shape} vs {tuple(leaf.shape)}")
            arrays[path] = arr
        with torch.no_grad():
            for path, leaf in leaves.items():
                arr = arrays[path]
                t = _from_numpy(arr, manifest["leaves"].get(path, {}).get(
                    "dtype", str(arr.dtype)))
                leaf.copy_(t.to(leaf.dtype))
        return (template, manifest["step"], manifest["base_seed"],
                manifest["extra"])

"""Swarm process driver of the port: spawn, supervise, respawn
(counterpart of ``repro/swarm/driver.py``; DESIGN.md §14).

``run_swarm(spec, device=...)`` runs the coordinator in-process and
launches ``swarm.workers`` local worker processes (``python -m
repro_torch.launch swarm --attach host:port --device <device>``, with
``PYTHONPATH`` pointing at this checkout's ``src``).  A supervisor
thread watches them: a worker that dies mid-run — injected
``chaos_crash`` or otherwise, any non-zero exit — is respawned (unless
``respawn=False``), and the replacement demonstrates the elastic-join
path: it attaches with nothing but the address, rebuilds from the
wire-shipped spec, and folds the committed ``(seed, g)`` log forward to
the live step.  A worker that exits 0 has seen the run end and is not
respawned (the reference's supervisor respawns it too when it exits
before the coordinator returns; its replacement then finds the run
over).  The coordinator's ``expected`` follows the workers that are
running, so a step waits until every one of them has attached: each
starts from step 0, and a respawned worker rejoins by the step after
the crash, however long its process takes to start.

Local workers on a card all share that one card (``device="cuda"`` is
``cuda:0`` in every worker): the card time-slices between them, so a
step's wall time here says nothing about a swarm with a card per
worker.  Each worker's standard output goes to a temporary file; the
JSON result it prints last (its device, steps applied, how it joined,
its peak memory and kernel launches) lands in the summary's
``worker_results``.

``attach`` mode is the worker half: connect to an existing coordinator
and serve until the run completes.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

_MAX_RESPAWNS_PER_SLOT = 3
_EXIT_WAIT_S = 60.0     # a worker's grace to checkpoint and exit at the end


def _src_root() -> str:
    import repro_torch
    return os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))


def _worker_cmd(host: str, port: int, device: str) -> List[str]:
    return [sys.executable, "-m", "repro_torch.launch", "swarm",
            "--attach", f"{host}:{port}", "--device", device]


def _worker_env() -> Dict[str, str]:
    env = dict(os.environ)
    src = _src_root()
    prev = env.get("PYTHONPATH", "")
    if src not in prev.split(os.pathsep):
        env["PYTHONPATH"] = src + (os.pathsep + prev if prev else "")
    return env


def spawn_worker(host: str, port: int,
                 device: Optional[str] = None) -> subprocess.Popen:
    """One local worker process attached to the coordinator at
    ``host:port``, on ``device`` (None: the card)."""
    return subprocess.Popen(_worker_cmd(host, port, device or "cuda"),
                            env=_worker_env())


class _Proc:
    """One spawned worker and the file its standard output goes to."""

    def __init__(self, host: str, port: int, device: str):
        self.out = tempfile.TemporaryFile(mode="w+")
        self.p = subprocess.Popen(_worker_cmd(host, port, device),
                                  env=_worker_env(), stdout=self.out)

    def result(self) -> Optional[dict]:
        """The JSON object the worker printed last, if any."""
        self.out.seek(0)
        lines = [ln for ln in self.out.read().splitlines()
                 if ln.startswith("{")]
        self.out.close()
        return json.loads(lines[-1]) if lines else None


def run_swarm(spec, *, respawn: bool = True,
              runs_root: Optional[str] = None,
              device=None) -> Dict[str, Any]:
    """Coordinator + ``spec.swarm.workers`` supervised local workers on
    ``device`` (None = the card, as every entry point).

    Returns the coordinator's summary dict (run_id, epochs, straggler
    steps, wire bytes/step) with the workers' exit codes, respawns and
    results.
    """
    from repro_torch import resolve_device
    from repro_torch.swarm.coordinator import Coordinator

    if spec.swarm.workers < 1:
        raise ValueError("run_swarm needs swarm.workers >= 1 "
                         "(use --attach to join an existing swarm)")
    dev = resolve_device(device)
    coord = Coordinator(spec, runs_root=runs_root, device=dev)
    procs: List[Optional[_Proc]] = []
    finished: List[_Proc] = []
    respawns = [0] * spec.swarm.workers
    lock = threading.Lock()
    done = threading.Event()

    def spawn() -> _Proc:
        return _Proc(coord.host, coord.port, str(dev))

    def supervise():
        while not done.is_set():
            with lock:
                for slot, w in enumerate(procs):
                    if w is None or w.p.poll() is None:
                        continue
                    finished.append(w)
                    procs[slot] = None
                    if (respawn and w.p.returncode != 0
                            and not done.is_set()
                            and respawns[slot] < _MAX_RESPAWNS_PER_SLOT):
                        respawns[slot] += 1
                        procs[slot] = spawn()
                coord.expected = sum(w is not None for w in procs)
            time.sleep(0.1)

    sup = threading.Thread(target=supervise, daemon=True)
    try:
        with lock:
            for _ in range(spec.swarm.workers):
                procs.append(spawn())
            coord.expected = len(procs)
        sup.start()
        summary = coord.serve()
    finally:
        done.set()
        if sup.is_alive():
            sup.join(timeout=2.0)
        for w in procs:
            if w is None:
                continue
            try:
                w.p.wait(timeout=_EXIT_WAIT_S)
            except subprocess.TimeoutExpired:
                w.p.kill()
                w.p.wait(timeout=5.0)
            finished.append(w)
    summary["worker_exits"] = [w.p.returncode for w in finished]
    summary["respawns"] = sum(respawns)
    summary["worker_results"] = [w.result() for w in finished]
    return summary


def run_attached(address: str, device=None) -> Dict[str, Any]:
    """Worker half of ``launch swarm``: join the swarm at ``address``."""
    from repro_torch.swarm import worker
    return worker.attach(address, device=device)

"""Swarm coordinator of the port: shard assignment, quorum commits,
membership epochs (counterpart of ``repro/swarm/coordinator.py``;
DESIGN.md §14).

The coordinator owns the *decision*, never the parameters: it assigns
the spec-fixed loss shards round-robin over live workers, collects
``StepContribution``s, and — when the step completes or the deadline
passes with ≥ quorum of shards — reduces the shard losses through the
same fixed-order host math as every replica
(:mod:`repro_torch.swarm.commit`) and broadcasts the ``StepCommit``.
Selection health metrics come from a parameter tree on the ``meta``
device (layer selection is a pure function of the seed and the tree's
*shapes*; ``shardstep.SelectionOracle``), so the coordinator
writes the exact same run-registry rows as a single-process sharded
trainer — which is what lets ``launch replay`` verify a swarm run
bit-for-bit.

Membership is epoch-numbered: every join, leave or death bumps
``membership_epoch``, reassigns shards, and broadcasts ``assign``;
contributions stamped with an older epoch are rejected (the worker
recomputes under its new assignment and resends).  A worker death
mid-step reassigns its shards immediately, so even a quorum=1.0 run
survives a crash; checkpoint writes are delegated per commit to the
lowest live worker id.

A step boundary waits (up to ``_JOIN_GRACE_S``) until ``expected``
workers are attached: the driver keeps that count at the worker
processes it has started and not yet seen exit, so every worker it
spawns, or respawns after a crash, joins at a known step whatever the
machine's load (at least one, as the reference's, when nobody sets it).

The coordinator holds no parameters and launches nothing on the card,
except the exact ‖z‖ of ``telemetry.health_norms`` rows, drawn on
``device`` (the card unless the caller asks for the CPU).  It publishes
the ``swarm_*`` gauges (live workers, epoch, straggler steps, bytes a
step) on its telemetry session's metrics registry.
"""
from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.core import rng
from repro_torch.swarm import commit as commit_mod
from repro_torch.swarm import proto

_JOIN_GRACE_S = 120.0   # max wait for the expected workers to attach
_POLL_S = 0.05


class _Peer:
    """One connected worker, as the coordinator sees it."""

    def __init__(self, conn: proto.Conn):
        self.conn = conn
        self.wid: Optional[int] = None
        self.alive = True

    def send(self, msg: dict) -> None:
        try:
            self.conn.send(msg)
        except OSError:
            self.alive = False


class StepLedger:
    """Pure contribution gate for one step — shard-keyed, so the commit
    literally cannot depend on arrival order.  Socket-free on purpose:
    the determinism properties are tested against this class directly.
    """

    def __init__(self, run_id: str, step: int, seed: int, epoch: int,
                 n_shards: int):
        self.run_id, self.step, self.seed = run_id, step, seed
        self.epoch = epoch
        self.n_shards = n_shards
        self.pairs: List[Optional[List[float]]] = [None] * n_shards
        self.rejected = {"stale_epoch": 0, "stale_step": 0, "run_id": 0,
                         "bad_shard": 0}

    def add(self, c: proto.StepContribution, epoch: int) -> str:
        """Admit one contribution; returns the disposition.  ``epoch``
        is the coordinator's *current* epoch (it may have advanced past
        ``self.epoch`` after a mid-step membership change)."""
        if c.run_id != self.run_id:
            self.rejected["run_id"] += 1
            return "run_id"
        if c.membership_epoch < epoch:
            self.rejected["stale_epoch"] += 1
            return "stale_epoch"
        if c.step != self.step:
            self.rejected["stale_step"] += 1
            return "stale_step"
        ok = False
        for key, pair in c.shard_losses.items():
            i = int(key)
            if not 0 <= i < self.n_shards:
                self.rejected["bad_shard"] += 1
                continue
            # duplicate shards overwrite bit-identically: every replica
            # runs the same jitted probe program on the same slice
            self.pairs[i] = [float(pair[0]), float(pair[1])]
            ok = True
        return "ok" if ok else "bad_shard"

    @property
    def n_arrived(self) -> int:
        return sum(p is not None for p in self.pairs)

    @property
    def complete(self) -> bool:
        return self.n_arrived == self.n_shards

    def missing(self) -> List[int]:
        return [i for i, p in enumerate(self.pairs) if p is None]

    def commit(self, eps: float) -> Dict[str, Any]:
        """The committed scalars (fixed-order f32 reduction)."""
        return commit_mod.commit_scalars(self.pairs, eps)


class Coordinator:
    """Run one swarm training loop; see :meth:`serve`."""

    def __init__(self, experiment, runs_root: Optional[str] = None,
                 device=None):
        from repro_torch import api
        from repro_torch.api import spec as spec_mod
        from repro_torch.api.validate import swarm_active, swarm_shards
        from repro_torch.swarm import shardstep

        api.validate(experiment)
        if not swarm_active(experiment):
            raise ValueError("spec has no active swarm node "
                             "(set swarm.workers or swarm.n_shards)")
        self.experiment = experiment
        sw, r, tel = experiment.swarm, experiment.run, experiment.telemetry
        self.n_shards = swarm_shards(experiment)
        self.n_ok = commit_mod.quorum_count(self.n_shards, sw.quorum)
        self.deadline_s = sw.step_deadline_s
        self.steps = r.steps
        self.log_every = r.log_every
        self.ckpt_every = r.ckpt_every if r.ckpt_dir else 0
        self.eps = experiment.optimizer.eps
        self.lr = experiment.optimizer.lr
        # the trainer folds TrainConfig.seed (= run.seed) — mirror that
        self.base_seed = int(np.uint32(rng.fold_py(r.seed, 0xC0FFEE)))
        self.spec_dict = spec_mod.to_dict(experiment)

        # run registry (DESIGN.md §13): the swarm's (seed, g) log is the
        # recovery substrate AND the replay evidence
        self.runlog = None
        self.run_id = None
        self.health = None
        runs_dir = runs_root or tel.runs_dir
        self.oracle = shardstep.SelectionOracle(experiment, device=device)
        if runs_dir:
            self.run_id = tel.run_id or obs_mod.make_run_id(runs_dir,
                                                            seed=r.seed)
            self.runlog = obs_mod.RunLog(runs_dir, self.run_id,
                                         spec=self.spec_dict)
            norm_fn = (self.oracle.norm_fn
                       if getattr(tel, "health_norms", False) else None)
            self.health = obs_mod.HealthAccumulator(self.oracle.num_layers,
                                                    norm_fn=norm_fn)
        self.obs = obs_mod.session(tel)
        reg = self.obs.registry
        self._g_live = reg.gauge("swarm_live_workers",
                                 "workers currently attached")
        self._g_epoch = reg.gauge("swarm_epoch", "membership epoch")
        self._g_straggler = reg.gauge("swarm_straggler_steps",
                                      "steps committed below full strength")
        self._g_bytes = reg.gauge("swarm_bytes_per_step",
                                  "mean wire bytes per committed step")

        # ---- transport
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((sw.host, sw.port))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._events: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

        # ---- state
        self.epoch = 0
        self.peers: Dict[int, _Peer] = {}
        self._joiners: List[_Peer] = []
        self._closed_peers: List[_Peer] = []
        self._next_wid = 0
        self.commit_log: List[dict] = []
        self.straggler_steps = 0
        self.stale_rejections = 0
        # worker processes started and still running (set by the driver)
        self.expected = 0

    # ----------------------------------------------------------- threads
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._sock.accept()
            except OSError:
                return
            peer = _Peer(proto.Conn(sock))
            threading.Thread(target=self._reader_loop, args=(peer,),
                             daemon=True).start()

    def _reader_loop(self, peer: _Peer):
        while not self._stop.is_set():
            try:
                msg = peer.conn.recv()
            except (OSError, proto.ProtocolError):
                msg = None
            if msg is None:
                self._events.put(("dead", peer, None))
                return
            self._events.put((msg["type"], peer, msg))

    # -------------------------------------------------------- membership
    def _live_wids(self) -> List[int]:
        return sorted(w for w, p in self.peers.items() if p.alive)

    def _shards_of(self, wid: int) -> List[int]:
        live = self._live_wids()
        if wid not in live:
            return []
        k = live.index(wid)
        return [s for s in range(self.n_shards)
                if s % len(live) == k]

    def _assignment_msg(self, wid: int, step: int) -> dict:
        return {"type": "assign", "membership_epoch": self.epoch,
                "step": step, "shards": self._shards_of(wid),
                "n_live": len(self._live_wids())}

    def _bump_epoch(self, step: int, *, welcome_new: bool = True):
        """Advance the membership epoch and rebroadcast assignments for
        ``step`` — contributions from the previous epoch are now stale."""
        self.epoch += 1
        for wid in self._live_wids():
            self.peers[wid].send(self._assignment_msg(wid, step))
        self._g_epoch.set(self.epoch)
        self._g_live.set(len(self._live_wids()))

    def _admit(self, peer: _Peer, step: int):
        wid = self._next_wid
        self._next_wid += 1
        peer.wid = wid
        self.peers[wid] = peer
        self.epoch += 1
        peer.send({"type": "welcome", "worker_id": wid,
                   "membership_epoch": self.epoch,
                   "spec": self.spec_dict, "run_id": self.run_id or "",
                   "base_seed": self.base_seed, "next_step": step,
                   "n_shards": self.n_shards,
                   "shards": []})  # real shards follow in the assign
        for w in self._live_wids():
            self.peers[w].send(self._assignment_msg(w, step))
        self._g_epoch.set(self.epoch)
        self._g_live.set(len(self._live_wids()))

    def _drop_peer(self, peer: _Peer, step: int):
        if peer.wid is not None and peer.wid in self.peers:
            del self.peers[peer.wid]
            peer.alive = False
            self._closed_peers.append(peer)
            if self._live_wids():
                self._bump_epoch(step)
        peer.alive = False

    def _process_boundary(self, step: int):
        """Admit queued joiners at a step boundary."""
        while self._joiners:
            self._admit(self._joiners.pop(0), step)

    # ------------------------------------------------------------- serve
    def _handle(self, kind: str, peer: _Peer, msg: Optional[dict],
                ledger: Optional[StepLedger], step: int) -> None:
        if kind == "hello":
            if msg is not None and peer.wid is None:
                self._joiners.append(peer)
        elif kind == "dead" or kind == "bye":
            self._drop_peer(peer, step)
        elif kind == "fetch" and msg is not None:
            start = max(0, int(msg.get("from_step", 0)))
            peer.send({"type": "commits",
                       "commits": self.commit_log[start:]})
        elif kind == "contribution" and msg is not None and ledger:
            c = proto.StepContribution.from_wire(msg)
            if ledger.add(c, self.epoch) == "stale_epoch":
                self.stale_rejections += 1

    def _await_quorum(self, ledger: StepLedger, step: int) -> None:
        """Block until the step can commit: complete, or deadline passed
        with ≥ quorum shards.  Death mid-step reassigns immediately."""
        deadline = time.monotonic() + self.deadline_s
        nudge_attempt = 0
        while True:
            # admit joiners even mid-step: they fast-forward from the
            # commit log and pick up shards at the next epoch bump
            if self._joiners:
                self._process_boundary(step)
            if ledger.complete:
                return
            now = time.monotonic()
            if now >= deadline:
                if ledger.n_arrived >= self.n_ok:
                    return
                # below quorum: nudge the workers owning missing shards
                # (resends pass a fresh chaos attempt counter) and re-arm
                for wid in self._live_wids():
                    self.peers[wid].send(self._assignment_msg(wid, step))
                nudge_attempt += 1
                deadline = time.monotonic() + self.deadline_s
            try:
                kind, peer, msg = self._events.get(
                    timeout=min(_POLL_S * 4, max(0.0, deadline - now)))
            except queue.Empty:
                continue
            self._handle(kind, peer, msg, ledger, step)

    def _wait_for_workers(self, ledger: StepLedger, step: int):
        """Admit hellos until ``expected`` workers (at least one) are
        attached; after ``_JOIN_GRACE_S`` go on with those attached, and
        raise when there are none.  Contributions that arrive meanwhile
        go to ``ledger``."""
        t0 = time.monotonic()
        while len(self._live_wids()) < max(1, self.expected):
            if self._joiners:
                self._process_boundary(step)
                continue
            if time.monotonic() - t0 > _JOIN_GRACE_S:
                if self._live_wids():
                    return
                raise TimeoutError("no worker attached within "
                                   f"{_JOIN_GRACE_S}s")
            try:
                kind, peer, msg = self._events.get(timeout=_POLL_S * 4)
            except queue.Empty:
                continue
            self._handle(kind, peer, msg, ledger, step)

    def _record_step(self, t: int, seed: int, scal: Dict[str, Any],
                     pairs) -> None:
        if self.health is None:
            return
        metrics = {
            "loss": scal["loss"],
            "projected_grad": scal["projected_grad"],
            "probe_grads": np.asarray([scal["projected_grad"]], np.float32),
            "coeffs": np.asarray([scal["projected_grad"]], np.float32),
            "eps": np.float32(self.eps),
            "lr": float(self.lr),
            "arrived": np.asarray(scal["arrived"], np.int32),
            "shard_losses": commit_mod.shard_losses_dict(pairs),
        }
        metrics.update(self.oracle.metrics(seed))
        self.health.record(t, metrics, seed=seed)
        if self.log_every and (t % self.log_every == 0
                               or t == self.steps - 1):
            self.runlog.append(self.health.drain())

    def _wire_bytes(self) -> int:
        peers = list(self.peers.values()) + self._closed_peers
        return sum(p.conn.bytes_sent + p.conn.bytes_recv for p in peers)

    def serve(self) -> Dict[str, Any]:
        """Drive the run to completion; returns (and writes, when a run
        dir is configured) the summary."""
        try:
            return self._serve()
        finally:
            self.close()

    def _serve(self) -> Dict[str, Any]:
        t0 = time.time()
        step_bytes: List[int] = []
        step_s: List[float] = []
        bytes_before = self._wire_bytes()
        for t in range(self.steps):
            ts = time.perf_counter()
            self._process_boundary(t)
            seed = int(np.uint32(rng.fold_py(self.base_seed, t)))
            ledger = StepLedger(self.run_id or "", t, seed, self.epoch,
                                self.n_shards)
            self._wait_for_workers(ledger, t)
            # drain anything already queued (e.g. eager contributions)
            while True:
                try:
                    kind, peer, msg = self._events.get_nowait()
                except queue.Empty:
                    break
                self._handle(kind, peer, msg, ledger, t)
            self._await_quorum(ledger, t)

            scal = ledger.commit(self.eps)
            if 0 in scal["arrived"]:
                self.straggler_steps += 1
                self._g_straggler.set(self.straggler_steps)
            self.stale_rejections += sum(ledger.rejected.values())
            ckpt_wid = -1
            if self.ckpt_every and (t + 1) % self.ckpt_every == 0:
                live = self._live_wids()
                ckpt_wid = live[0] if live else -1
            cm = proto.StepCommit(
                step=t, seed=seed, g=float(scal["projected_grad"]),
                loss=float(scal["loss"]),
                active_layers=int(self.oracle.metrics(seed)["active_layers"]),
                membership_epoch=self.epoch, arrived=scal["arrived"],
                ckpt_worker=ckpt_wid).to_wire()
            self.commit_log.append(cm)
            for wid in self._live_wids():
                self.peers[wid].send(cm)
            step_s.append(time.perf_counter() - ts)
            self._record_step(t, seed, scal, ledger.pairs)
            now_bytes = self._wire_bytes()
            step_bytes.append(now_bytes - bytes_before)
            bytes_before = now_bytes
            self._g_bytes.set(now_bytes / (t + 1))

        summary = {
            "run_id": self.run_id, "steps": self.steps,
            "n_shards": self.n_shards, "quorum_n": self.n_ok,
            "membership_epochs": self.epoch,
            "workers_seen": self._next_wid,
            "straggler_steps": self.straggler_steps,
            "stale_rejections": self.stale_rejections,
            "wire_bytes": self._wire_bytes(),
            "bytes_per_step": self._wire_bytes() / max(1, self.steps),
            # join handshakes ship the spec dict once; the median step
            # delta is the steady-state scalar-only figure
            "steady_bytes_per_step": float(np.median(step_bytes))
            if step_bytes else 0.0,
            # a step from its start to its commit's broadcast; the median
            # leaves out the steps that wait for workers to start
            "steady_step_s": float(np.median(step_s)) if step_s else 0.0,
            "wall_s": time.time() - t0,
        }
        done = {"type": "done", "summary": {k: v for k, v in summary.items()
                                            if k != "run_id"}}
        for wid in self._live_wids():
            self.peers[wid].send(done)
        # give workers a moment to checkpoint/exit cleanly
        t_end = time.monotonic() + 10.0
        while self._live_wids() and time.monotonic() < t_end:
            try:
                kind, peer, msg = self._events.get(timeout=_POLL_S * 4)
            except queue.Empty:
                continue
            if kind in ("dead", "bye"):
                peer.alive = False
                if peer.wid in self.peers:
                    del self.peers[peer.wid]
        if self.runlog is not None:
            self.runlog.append(self.health.drain())
            full = dict(self.health.summary())
            full.update(summary)
            self.runlog.finalize(full)
        return summary

    def close(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for p in list(self.peers.values()) + self._joiners:
            p.conn.close()
        self.obs.flush()
        self.obs.close()

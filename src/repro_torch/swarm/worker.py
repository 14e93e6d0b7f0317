"""Swarm worker of the port: probe your shards, ship two floats, apply
the commit (counterpart of ``repro/swarm/worker.py``; DESIGN.md §14).

A worker attaches to a coordinator address with nothing but the
address and a device: the ``welcome`` carries the full experiment spec,
so the worker builds the same :class:`~repro_torch.swarm.shardstep.ShardedZOStep`
a single-process trainer would (``Trainer.from_spec(spec, device=...)``,
its weights drawn from the spec's seed by a ``torch.Generator`` on that
device), regenerates the batch stream deterministically from the spec
(zero data bytes on the wire), and per step sends one
:class:`~repro_torch.swarm.proto.StepContribution` with the
``(l+, l-)`` pair of each shard it owns.

**Elastic join without weight transfer**: because probes never change
the parameters, the trajectory is a pure fold of ``commit(seed, g)``
over the committed log.  A worker joining mid-run initializes its
parameters from the spec's seed (or restores the newest checkpoint),
fetches the committed ``(seed, g)`` backlog, and folds it forward —
arriving bit-identical to workers that were present from step 0.

The fault-injection hooks (:mod:`repro_torch.swarm.chaos`) live at this
edge: contributions can be dropped/delayed, commits ignored (recovered
via ``fetch`` resync), whole step windows partitioned, and
``chaos_crash`` hard-exits the process at a scheduled step so the
coordinator's death/reassignment path is deterministically exercised.

On the card every kernel wrapper launches its kernel or raises, so a
worker whose kernels fail to build or launch exits non-zero; a worker
asked for the card on a machine without one fails at set-up.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import rng
from repro_torch.swarm import chaos as chaos_mod
from repro_torch.swarm import proto
from repro_torch.swarm import shardstep


class Worker:
    """One swarm worker process.  ``Worker(host, port, device).run()``."""

    def __init__(self, host: str, port: int, device=None):
        self.device = resolve_device(device)
        self.conn = proto.connect(host, port)
        self.wid = -1
        self.epoch = -1
        self.shards: List[int] = []
        self.run_id = ""
        self._commit_backlog: Dict[int, proto.StepCommit] = {}
        self._done: Optional[dict] = None
        self._commit_dropped: set = set()
        # per-step resend counter: bumped by a nudge/assign or a local
        # timeout, so resends pass a fresh chaos attempt and a dropped
        # contribution is not dropped identically forever
        self._attempt = 0
        self._attempt_step = -1
        # elastic-join record: where the parameters came from, how many
        # committed steps were folded to reach the live step, and the
        # seconds each took (set-up with the weights; the fold)
        self.restored_step = 0
        self.folded = 0
        self.build_s = self.fold_s = 0.0

    # ------------------------------------------------------------ set-up
    def _handshake(self) -> bool:
        from repro_torch import api
        try:
            self.conn.send({"type": "hello", "last_step": -1})
            msg = self.conn.recv(timeout=60.0)
        except ConnectionResetError:
            msg = None   # the coordinator closed before admitting us
        if msg is None or msg.get("type") == "done":
            # raced the end of the run — nothing to do
            return False
        if msg["type"] != "welcome":
            raise proto.ProtocolError(f"expected welcome, got {msg!r}")
        self.wid = int(msg["worker_id"])
        self.epoch = int(msg["membership_epoch"])
        self.run_id = msg.get("run_id", "")
        self.base_seed = int(msg["base_seed"])
        self.next_step = int(msg["next_step"])
        spec = api.from_dict(msg["spec"])
        # workers keep the ckpt config (commit messages may designate
        # this worker to write one) but never open their own run dir
        self.spec = dataclasses.replace(spec, telemetry=api.Telemetry())
        self.chaos = chaos_mod.Chaos(
            chaos_mod.ChaosConfig.from_spec(spec.swarm), self.wid)
        return True

    def _build(self):
        from repro_torch import tasks as tasks_mod
        from repro_torch.data import synthetic
        from repro_torch.train.trainer import Trainer

        self.trainer = Trainer.from_spec(self.spec, device=self.device)
        if not getattr(self.trainer._step, "sharded", False):
            raise proto.ProtocolError("the welcome's spec has no active "
                                      "swarm node")
        self.step: shardstep.ShardedZOStep = self.trainer._step
        tcfg = self.trainer.tcfg
        want = int(np.uint32(rng.fold_py(tcfg.seed, 0xC0FFEE)))
        if want != self.base_seed:
            raise proto.ProtocolError(
                f"seed lineage mismatch: spec folds to {want}, "
                f"coordinator announced {self.base_seed}")
        self.params = self.trainer.params
        self.t = 0
        # newest checkpoint <= next_step fast-forwards for free
        ck = self.trainer.ckpt
        if ck is not None and ck.latest() is not None:
            usable = [s for s in ck.all_steps() if s <= self.next_step]
            if usable:
                _, self.t, _, _ = ck.restore(self.params, step=max(usable))
                self.restored_step = self.t
        train_data = self.trainer.make_dataset(4096)
        stream_data = {k: v for k, v in train_data.items()
                       if k in tasks_mod.MODEL_BATCH_KEYS}
        self._stream = enumerate(synthetic.batches(
            stream_data, tcfg.batch_size, tcfg.steps, seed=tcfg.seed + 7))
        self._batch_t = -1
        self._batch = None

    def _batch_for(self, t: int):
        """Advance the deterministic batch stream to step ``t`` — the
        iterator stays in lockstep, so fast-forward just consumes it."""
        while self._batch_t < t:
            self._batch_t, np_batch = next(self._stream)
            self._batch = self.trainer._model_batch(np_batch)
        return self._batch

    def _fast_forward(self):
        """Fold the committed ``(seed, g)`` backlog from ``self.t`` up
        to the coordinator's ``next_step`` — elastic join, no weights
        on the wire."""
        if self.t >= self.next_step:
            return
        t0, s0 = self.t, time.perf_counter()
        self.conn.send({"type": "fetch", "from_step": self.t})
        while self.t < self.next_step:
            msg = self.conn.recv(timeout=60.0)
            if msg is None:
                raise proto.ProtocolError("coordinator hung up mid-resync")
            self._ingest(msg)
            self._apply_backlog()
        self.trainer._sync()
        self.folded = self.t - t0
        self.fold_s = time.perf_counter() - s0

    # --------------------------------------------------------- messaging
    def _ingest(self, msg: dict):
        kind = msg["type"]
        if kind == "assign":
            self.epoch = int(msg["membership_epoch"])
            self.shards = [int(s) for s in msg["shards"]]
            self._attempt += 1   # re-probe/resend for the named step
        elif kind == "commit":
            cm = proto.StepCommit.from_wire(msg)
            key = ("commit", cm.step)
            if (cm.step >= self.t and key not in self._commit_dropped
                    and self.chaos.drop("commit", cm.step)):
                # chaos eats this broadcast exactly once; the worker
                # recovers through the fetch/resync path
                self._commit_dropped.add(key)
                return
            self._commit_backlog[cm.step] = cm
        elif kind == "commits":
            for raw in msg["commits"]:
                cm = proto.StepCommit.from_wire(raw)
                self._commit_backlog[cm.step] = cm
        elif kind == "done":
            self._done = msg

    def _apply_backlog(self):
        """Apply every contiguous pending commit at ``self.t``."""
        while self.t in self._commit_backlog:
            cm = self._commit_backlog.pop(self.t)
            want = int(np.uint32(rng.fold_py(self.base_seed, self.t)))
            if cm.seed != want:
                raise proto.ProtocolError(
                    f"commit step {cm.step} carries seed {cm.seed}, "
                    f"lineage says {want}")
            self.step.apply_commit(self.params, cm.seed, cm.g)
            if cm.ckpt_worker == self.wid and self.trainer.ckpt is not None:
                self.trainer.ckpt.save(
                    self.t + 1, self.params, int(self.base_seed),
                    extra=self.trainer._ckpt_extra(), blocking=True)
            self.t += 1
            self._commit_backlog = {s: c for s, c
                                    in self._commit_backlog.items()
                                    if s >= self.t}

    def _contribute(self, t: int, seed: int, attempt: int = 0):
        """Probe my shards for step ``t`` and send the contribution —
        unless chaos drops/partitions it (the coordinator's deadline
        machinery takes over)."""
        if not self.shards:
            return
        batch = self._batch_for(t)
        shards_all = shardstep.shard_batch(batch, self.step.n_shards)
        pairs = {str(s): [float(v) for v in
                          self.step.probe_shard(self.params, shards_all[s],
                                                seed)]
                 for s in self.shards}
        c = proto.StepContribution(
            run_id=self.run_id, membership_epoch=self.epoch, step=t,
            seed=seed, shard_losses=pairs, worker_id=self.wid)
        self.chaos.sleep("contribution", t, attempt)
        if self.chaos.drop("contribution", t, attempt):
            return
        self.conn.send(c.to_wire())

    # --------------------------------------------------------------- run
    def run(self) -> dict:
        if not self._handshake():
            self.conn.close()
            return {"worker_id": -1, "steps_applied": 0, "joined": False,
                    "device": str(self.device)}
        s0 = time.perf_counter()
        self._build()
        self.trainer._sync()
        self.build_s = time.perf_counter() - s0
        self._fast_forward()
        deadline_s = self.spec.swarm.step_deadline_s
        contributed_for = None
        while self._done is None:
            self._apply_backlog()
            if self._done is not None:
                break
            t = self.t
            if t >= self.spec.run.steps:
                break
            if t != self._attempt_step:
                self._attempt_step, self._attempt = t, 0
            self.chaos.maybe_crash(t)
            seed = int(np.uint32(rng.fold_py(self.base_seed, t)))
            key = (t, self.epoch, self._attempt)
            if contributed_for != key:
                self._contribute(t, seed, self._attempt)
                contributed_for = key
            try:
                msg = self.conn.recv(timeout=deadline_s * 2)
            except TimeoutError:
                # our contribution or the commit was lost — resync the
                # committed backlog and recontribute with a fresh attempt
                self._attempt += 1
                try:
                    self.conn.send({"type": "fetch", "from_step": self.t})
                except OSError:
                    raise proto.ProtocolError("coordinator unreachable")
                continue
            if msg is None:
                raise proto.ProtocolError("coordinator hung up")
            self._ingest(msg)
        self._apply_backlog()
        try:
            self.conn.send({"type": "bye"})
        except OSError:
            pass
        self.conn.close()
        return {"worker_id": self.wid, "steps_applied": self.t,
                "epoch": self.epoch, "joined": True,
                "device": str(self.device),
                "restored_step": self.restored_step,
                "folded": self.folded, "build_s": self.build_s,
                "fold_s": self.fold_s,
                "bytes_sent": self.conn.bytes_sent,
                "bytes_recv": self.conn.bytes_recv,
                "peak_gib": (torch.cuda.max_memory_allocated(self.device)
                             / 2 ** 30 if self.device.type == "cuda"
                             else None),
                "launches": _launches(),
                "summary": (self._done or {}).get("summary")}


def _launches() -> Dict[str, int]:
    """This process's kernel launches by kernel (each wrapper's count)."""
    from repro_torch.fused import matmul as fmm
    from repro_torch.kernels import flash_attn as kfa
    from repro_torch.kernels import zo_axpy as kzo
    return {"zo_axpy_2d": kzo.counter.launches,
            "flash_attention": kfa.counter.launches,
            "pmatmul_stack": fmm.stack_counter.launches,
            "pmatmul": fmm.single_counter.launches}


def attach(address: str, device=None) -> dict:
    """``launch swarm --attach host:port`` entry point."""
    host, port = address.rsplit(":", 1)
    return Worker(host, int(port), device=device).run()

"""Swarm wire protocol: length-prefixed JSON frames (DESIGN.md §14), a
copy of ``repro/swarm/proto.py`` (stdlib): the same bytes on the wire.

A frame is a 4-byte big-endian length followed by a UTF-8 JSON object
with a ``"type"`` tag.  JSON because the payloads are a handful of
scalars — the protocol's entire point is that a ZO step commits from
``(seed, g)`` alone, so the per-step traffic is hundreds of *bytes*
against the ``4·|θ|`` of a first-order gradient all-reduce (the
reference's ``BENCH_dist.json`` tripwire pins it under 1 KB).  Floats survive the
trip exactly: ``float(np.float32(x))`` is the shortest round-tripping
repr, so ``np.float32(json.loads(...))`` restores identical bits.

Message types:

==============  ===========================================================
``hello``       worker → coordinator: join request (``last_step`` when
                reconnecting)
``welcome``     coordinator → worker: assigned ``worker_id``, the full
                experiment spec (workers need only an address), run_id,
                base_seed, membership epoch, shard ids, next step
``assign``      coordinator → worker: shard reassignment at an epoch bump
                (mid-step when a peer died, boundary on join/leave)
``contribution``worker → coordinator: :class:`StepContribution`
``commit``      coordinator → worker: :class:`StepCommit` (broadcast)
``fetch``       worker → coordinator: resync request for committed steps
                ``>= from_step`` (elastic join, partition recovery)
``commits``     coordinator → worker: the requested commit backlog
``done``        coordinator → worker: run complete, summary attached
``bye``         worker → coordinator: clean leave
==============  ===========================================================
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct
import threading
from typing import Dict, List, Optional

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 24  # 16 MiB — the spec-carrying welcome is the ceiling

MESSAGE_TYPES = ("hello", "welcome", "assign", "contribution", "commit",
                 "fetch", "commits", "done", "bye")


class ProtocolError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class StepContribution:
    """One worker's shard losses for one step.

    ``shard_losses`` maps shard index (a string — it travels as a JSON
    object key) to the ``[l+, l-]`` pair for that shard.  Contributions
    carrying a stale ``membership_epoch`` or a foreign ``run_id`` are
    rejected by the coordinator's ledger.
    """
    run_id: str
    membership_epoch: int
    step: int
    seed: int
    shard_losses: Dict[str, List[float]]
    worker_id: int = -1

    def to_wire(self) -> dict:
        return {"type": "contribution", **dataclasses.asdict(self)}

    @classmethod
    def from_wire(cls, msg: dict) -> "StepContribution":
        return cls(run_id=msg["run_id"],
                   membership_epoch=int(msg["membership_epoch"]),
                   step=int(msg["step"]), seed=int(msg["seed"]),
                   shard_losses={str(k): [float(v[0]), float(v[1])]
                                 for k, v in msg["shard_losses"].items()},
                   worker_id=int(msg.get("worker_id", -1)))


@dataclasses.dataclass(frozen=True)
class StepCommit:
    """The committed step — everything a replica needs to apply it.

    ``(seed, g)`` alone reconstructs the parameter update (z and the
    layer selection regenerate from the counter RNG); the rest is
    bookkeeping: ``arrived`` records the quorum mask the loss was
    reduced over, ``ckpt_worker`` designates at most one worker to
    write the checkpoint for ``step + 1``.
    """
    step: int
    seed: int
    g: float
    loss: float
    active_layers: int
    membership_epoch: int
    arrived: List[int]
    ckpt_worker: int = -1

    def to_wire(self) -> dict:
        return {"type": "commit", **dataclasses.asdict(self)}

    @classmethod
    def from_wire(cls, msg: dict) -> "StepCommit":
        return cls(step=int(msg["step"]), seed=int(msg["seed"]),
                   g=float(msg["g"]), loss=float(msg["loss"]),
                   active_layers=int(msg["active_layers"]),
                   membership_epoch=int(msg["membership_epoch"]),
                   arrived=[int(x) for x in msg["arrived"]],
                   ckpt_worker=int(msg.get("ckpt_worker", -1)))


def encode(msg: dict) -> bytes:
    if msg.get("type") not in MESSAGE_TYPES:
        raise ProtocolError(f"unknown message type {msg.get('type')!r}")
    body = json.dumps(msg, separators=(",", ":"), sort_keys=True).encode()
    if len(body) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(body)} bytes exceeds MAX_FRAME")
    return _LEN.pack(len(body)) + body


class Conn:
    """A framed connection with send/recv byte counters.

    ``send`` is locked (the coordinator broadcasts from its step loop
    while reader threads live elsewhere); ``recv`` assumes a single
    reader.  ``recv`` returns ``None`` on clean EOF and raises
    ``socket.timeout`` on a deadline.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._slock = threading.Lock()
        self._rbuf = b""
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.msgs_sent = 0
        self.msgs_recv = 0

    def send(self, msg: dict) -> int:
        frame = encode(msg)
        with self._slock:
            self.sock.sendall(frame)
            self.bytes_sent += len(frame)
            self.msgs_sent += 1
        return len(frame)

    def _read(self, n: int, timeout: Optional[float]) -> Optional[bytes]:
        self.sock.settimeout(timeout)
        while len(self._rbuf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                return None
            self._rbuf += chunk
            self.bytes_recv += len(chunk)
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def recv(self, timeout: Optional[float] = None) -> Optional[dict]:
        header = self._read(_LEN.size, timeout)
        if header is None:
            return None
        (n,) = _LEN.unpack(header)
        if n > MAX_FRAME:
            raise ProtocolError(f"frame of {n} bytes exceeds MAX_FRAME")
        body = self._read(n, timeout)
        if body is None:
            return None
        self.msgs_recv += 1
        msg = json.loads(body.decode())
        if msg.get("type") not in MESSAGE_TYPES:
            raise ProtocolError(f"unknown message type {msg.get('type')!r}")
        return msg

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def connect(host: str, port: int, timeout: float = 10.0) -> Conn:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    return Conn(sock)

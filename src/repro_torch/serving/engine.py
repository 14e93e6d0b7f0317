"""The continuous-batching engine: paged steps over the KV pool
(counterpart of ``repro/serving/engine.py``; DESIGN.md §12).

One engine owns one arena (``models.lm.init_paged_cache``), one pool
(:class:`~repro_torch.serving.pool.KVPool`), one scheduler, and runs
``lm.paged_step`` at exactly two shapes:

  * the *prefill bucket*:  (1, prefill_chunk) tokens, one lane's row
  * the *decode bucket*:   (max_lanes, 1) tokens, the full page table

With ``serving.prefix_cache`` on, prompts that share a full-page token
prefix attach the same physical pages through the scheduler's radix trie
and skip the chunk-aligned part of prefill; a shared page a re-run
chunk writes is first copied into the lane's private page, over every
leaf.  Greedy output is bit-identical to sharing off.  ``serving.preempt``
lets a starved higher-priority admission evict the lowest-priority
decoding lane; its regenerated tokens are the same.

Prompts are padded to the chunk bucket and streamed in chunk by chunk,
interleaved with decode steps (one chunk per engine step, to the oldest
admission), so a long admission never stalls the running lanes for more
than one chunk.  Inactive decode lanes ride along pointed at the trash
page, so the batch shape never changes.

The arena is written in place (``index_copy_``), so the reference's
"one arena-sized copy per call", where XLA cannot donate the buffer
through its layer scan, does not exist here: a difference of
implementation, not of result.  Decode state (tokens, positions, the page
table, seeds) stays on the device between steps and is rebuilt from the
host only when the lane set changes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Sequence, Set, Tuple

import torch

from repro_torch import obs as obs_mod
from repro_torch import resolve_device
from repro_torch.distributed import ctx, sharding
from repro_torch.models import lm
from repro_torch.serving import sampling
from repro_torch.serving.pool import KVPool
from repro_torch.serving.scheduler import DECODE, Lane, Request, Scheduler

I64 = torch.int64


class EngineUnsupported(NotImplementedError):
    """The model's block family is outside the paged engine's coverage
    (SSM/MLA mixers, stub frontends) — serve it with the lockstep path."""


@dataclasses.dataclass
class GenResult:
    rid: int
    tokens: List[int]                # generated ids (prompt excluded)
    prompt_len: int
    t_submit: float
    t_admit: float
    t_first: float                   # first generated token (prefill done)
    t_done: float

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit

    @property
    def ttft(self) -> float:
        """Time to first token."""
        return self.t_first - self.t_submit


class Engine:
    """Drive ``spec.serving`` over a model: submit() requests, step()
    until drained (or just run()).  ``device`` is where the arena lives
    and the steps run (None: the card); it must hold ``params``.

    ``mesh`` (a ``DeviceMesh`` with a ``model`` axis, every rank running
    the same engine): registered with ``ctx.set_mesh``; the parameters
    placed by ``sharding.params_sharding``, the arena by
    ``sharding.arena_sharding`` (pages on ``model``); logits come back
    replicated, so every rank samples the same tokens."""

    def __init__(self, cfg, params, serving, mesh=None, clock=None,
                 obs=None, device=None):
        if not lm.supports_paged(cfg):
            kinds = sorted({b.kind for s in cfg.stages for b in s.pattern})
            raise EngineUnsupported(
                f"{cfg.name}: paged serving covers attn mixers reading "
                f"tokens only, got {kinds} with frontend "
                f"{cfg.frontend!r}; use the lockstep serve path")
        self.device = resolve_device(device)
        held = params["embed"]["tok"].device
        if held.type != self.device.type:
            raise ValueError(f"params live on {held}, engine device is "
                             f"{self.device}")
        self.cfg = cfg
        self.mesh = mesh
        self.serving = serving
        self.clock = clock or time.perf_counter
        # learned position tables are finite: the engine cannot place a
        # token beyond them, whatever serving.max_seq asks for
        max_seq = serving.max_seq
        if cfg.pos_emb == "learned":
            max_seq = min(max_seq,
                          serving.page_size
                          * (cfg.max_seq // serving.page_size))
        self.pool = KVPool(serving.n_pages, serving.page_size)
        self.sched = Scheduler(self.pool, max_lanes=serving.max_lanes,
                               prefill_chunk=serving.prefill_chunk,
                               max_seq=max_seq,
                               prefix_cache=serving.prefix_cache,
                               priorities=serving.priorities,
                               preempt=serving.preempt)
        self.arena = lm.init_paged_cache(cfg, serving.n_pages,
                                         serving.page_size,
                                         device=self.device)
        if mesh is not None:
            # the reference's in/out shardings: params by their rules
            # (on a copy of the tree: the caller's stays as it was), the
            # arena's pages on `model`; tokens, page table, positions and
            # seeds stay plain tensors, counted replicated (``_spmd``)
            ctx.set_mesh(mesh)
            params = sharding.params_sharding(cfg, lm.shallow_copy(params),
                                              mesh)
            self.arena = sharding.arena_sharding(self.arena, mesh)
        self.params = params
        self._sample = sampling.make_sampler(serving.temperature,
                                             serving.top_k)
        self._shapes: Set[Tuple[int, int]] = set()
        self.n_prefill_calls = 0
        self.n_decode_steps = 0
        self._t_submit: Dict[int, float] = {}
        self._decode_dirty = True        # device lane state needs rebuild
        self._d_toks = self._d_table = self._d_pos = self._d_seeds = None
        # telemetry (DESIGN.md §13): an obs.Session, or the free
        # NULL_SESSION — the engine never branches on "is obs on"
        self.obs = obs if obs is not None else obs_mod.NULL_SESSION
        reg = self.obs.registry
        self._m_queue = reg.gauge("serving_queue_depth",
                                  "requests waiting for admission")
        self._m_lanes = reg.gauge("serving_lanes_active",
                                  "lanes prefilling or decoding")
        self._m_pages = reg.gauge("serving_pages_in_use",
                                  "KV pool pages allocated")
        self._m_util = reg.gauge("serving_page_utilization",
                                 "pages in use / usable pages")
        self._m_ttft = reg.histogram("serving_ttft_seconds",
                                     "submit -> first generated token")
        self._m_lat = reg.histogram("serving_latency_seconds",
                                    "submit -> request finished")
        self._m_toks = reg.counter("serving_tokens_generated",
                                   "generated tokens over all requests")
        self._m_reqs = reg.counter("serving_requests_completed",
                                   "requests retired")
        # prefix sharing / preemption (DESIGN.md §12)
        self._m_hit = reg.gauge("serving_page_hit_rate",
                                "shared prompt pages attached / looked up")
        self._m_preempt = reg.gauge("serving_preemptions",
                                    "decoding lanes evicted and requeued")
        self._m_cow = reg.gauge("serving_cow_copies",
                                "shared pages duplicated before a write")

    def _tensor(self, rows) -> torch.Tensor:
        return torch.tensor(rows, dtype=I64, device=self.device)

    # -------------------------------------------------------- the steps
    def _paged(self, toks, table, pos, sel):
        self._shapes.add(tuple(toks.shape))
        with self._spmd():
            logits, _ = lm.paged_step(self.cfg, self.params, self.arena,
                                      toks, table, pos, sel)
        return ctx.whole(logits)         # replicated, as the reference's

    def _spmd(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        return implicit_replication()

    def _cstep(self, src: int, dst: int):
        # copy-on-write page duplication: physical page src into dst
        # across every stage-block leaf (the page axis is 1)
        for blocks in self.arena.values():
            for leaves in blocks.values():
                for t in leaves.values():
                    ctx.copy_page(t, src, dst)

    def _sample_gauges(self):
        self._m_queue.set(len(self.sched.queue))
        self._m_lanes.set(len(self.sched.prefilling())
                          + len(self.sched.decoding()))
        in_use = self.pool.in_use
        self._m_pages.set(in_use)
        usable = self.pool.n_pages - 1        # page 0 is the trash page
        self._m_util.set(in_use / usable if usable else 0.0)
        self._m_hit.set(self.sched.page_hit_rate)
        self._m_preempt.set(self.sched.preemptions)
        self._m_cow.set(self.sched.cow_copies)

    def metrics_text(self) -> str:
        """Prometheus text exposition of the engine's metrics."""
        return self.obs.registry.to_text()

    # ----------------------------------------------------------- compiles
    def n_compiles(self) -> int:
        """Distinct (B, C) shapes the paged steps have run: at most 2 (one
        per bucket) for the engine's whole life.  Nothing is compiled
        here (the port runs eagerly); the count keeps the reference's
        "one compile per bucket" contract checkable."""
        return len(self._shapes)

    # ------------------------------------------------------------- submit
    def submit(self, req: Request):
        if req.max_new_tokens is None:   # spec default for the budget
            req = dataclasses.replace(
                req, max_new_tokens=self.serving.max_new_tokens)
        self.sched.submit(req)           # validates span vs pool/table
        self._t_submit[req.rid] = self.clock()

    # --------------------------------------------------------------- step
    def step(self) -> List[GenResult]:
        """One engine iteration: admit, one prefill chunk, one batched
        decode step.  Returns the requests that finished this iteration."""
        sched = self.sched
        pre_preempt = sched.preemptions
        while sched.try_admit(now=self.clock()) is not None:
            pass
        if sched.preemptions != pre_preempt:
            self._decode_dirty = True    # a decoding lane was evicted

        # -- chunked prefill: one chunk for the oldest prefilling lane
        # (admission order, NOT lane index — a later admission into a
        # lower lane must not overtake an in-progress prefill)
        pre = sched.prefilling()
        if pre:
            i = min(pre, key=lambda j: sched.lanes[j].admit_seq)
            lane = sched.lanes[i]
            c = sched.prefill_chunk
            start = lane.next_chunk * c
            lo = min(start + c, lane.prompt_len)
            chunk = [int(t) for t in lane.req.tokens[start:lo]]
            chunk += [0] * (c - len(chunk))
            final = start + c >= lane.padded_len
            sel = (min(lane.prompt_len - 1 - start, c - 1) if final else 0)
            # copy-on-write: shared pages this chunk writes get a
            # private duplicate before the write lands (scheduler swaps
            # the page table; the device content copy happens here)
            for src, dst in sched.cow_range(lane, start, start + c):
                self._cstep(src, dst)
            with self.obs.tracer.span(obs_mod.SERVE_PREFILL) as sp:
                # the final chunk's first token is sampled in the same call
                logits = self._paged(self._tensor([chunk]),
                                     self._tensor([sched.page_row(lane)]),
                                     self._tensor([start]),
                                     self._tensor([sel]))
                toks = self._sample(logits, self._tensor([lane.req.seed]),
                                    self._tensor([lane.prompt_len]))
                sp.fence(toks)
            self.n_prefill_calls += 1
            lane.next_chunk += 1
            lane.pos = min(start + c, lane.padded_len)
            if final:
                sched.register_prefix(lane)   # full prompt pages -> trie
                tok = int(toks[0])
                lane.t_first = self.clock()
                lane.out.append(tok)
                lane.last_token = tok
                lane.pos = lane.prompt_len
                lane.state = DECODE
                self._decode_dirty = True

        # -- batched decode over every decoding lane (fixed bucket)
        finished: List[GenResult] = []
        dec = sched.decoding()
        live = [i for i in dec if not self._done(sched.lanes[i])]
        for i in sorted(set(dec) - set(live)):
            finished.append(self._retire(i))
        if live:
            B = sched.max_lanes
            if self._decode_dirty:
                toks = [[0] for _ in range(B)]
                table = [sched.trash_row() for _ in range(B)]
                pos, seeds = [0] * B, [0] * B
                for i in live:
                    lane = sched.lanes[i]
                    toks[i] = [lane.last_token]
                    table[i] = sched.page_row(lane)
                    pos[i] = lane.pos
                    seeds[i] = lane.req.seed
                self._d_toks = self._tensor(toks)
                self._d_table = self._tensor(table)
                self._d_pos = self._tensor(pos)
                self._d_seeds = self._tensor(seeds)
                self._decode_dirty = False
            with self.obs.tracer.span(obs_mod.SERVE_DECODE) as sp:
                # the returned tokens and positions feed the next call as
                # they are, so a steady decode step uploads nothing
                logits = self._paged(self._d_toks, self._d_table,
                                     self._d_pos,
                                     torch.zeros_like(self._d_pos))
                self._d_pos = self._d_pos + 1
                self._d_toks = self._sample(logits, self._d_seeds,
                                            self._d_pos)[:, None]
                sp.fence(self._d_toks)
            self.n_decode_steps += 1
            nxt = self._d_toks[:, 0].tolist()
            for i in live:
                lane = sched.lanes[i]
                tok = int(nxt[i])
                lane.out.append(tok)
                lane.last_token = tok
                lane.pos += 1
                if self._done(lane):
                    finished.append(self._retire(i))
        self._sample_gauges()
        return finished

    def _done(self, lane: Lane) -> bool:
        eos = self.serving.eos_id
        return (len(lane.out) >= lane.req.max_new_tokens
                or (eos is not None and lane.out and lane.out[-1] == eos))

    def _retire(self, i: int) -> GenResult:
        self._decode_dirty = True        # lane composition changed
        lane = self.sched.finish(i)      # pages return to the pool now
        res = GenResult(rid=lane.req.rid, tokens=list(lane.out),
                        prompt_len=lane.prompt_len,
                        t_submit=self._t_submit.pop(lane.req.rid, 0.0),
                        t_admit=lane.t_admit, t_first=lane.t_first,
                        t_done=self.clock())
        self._m_reqs.inc()
        self._m_toks.inc(len(res.tokens))
        if res.t_submit:
            self._m_ttft.observe(res.ttft)
            self._m_lat.observe(res.latency)
        return res

    # ---------------------------------------------------------------- run
    def run(self, requests: Sequence[Request]) -> List[GenResult]:
        """Drain ``requests``: submit everything, step until idle.
        Results come back in finish order (not submit order).  Finished
        results are handed to the caller, never retained — a long-lived
        engine stays O(active lanes), not O(requests ever served)."""
        for r in requests:
            self.submit(r)
        results: List[GenResult] = []
        guard = 0
        t_run = self.clock()
        while self.sched.busy:
            before = (self.n_prefill_calls, self.n_decode_steps,
                      len(results), len(self.sched.queue),
                      self.sched.preemptions)
            results.extend(self.step())
            after = (self.n_prefill_calls, self.n_decode_steps,
                     len(results), len(self.sched.queue),
                     self.sched.preemptions)
            guard = guard + 1 if before == after else 0
            if guard > 2:    # admission blocked with nothing running
                raise RuntimeError(
                    "engine stalled: queue head needs "
                    "more pool pages than will ever free up")
        dt = self.clock() - t_run
        if dt > 0:
            self.obs.registry.gauge(
                "serving_tokens_per_second",
                "generated tokens / drain wall time, last run()").set(
                sum(len(r.tokens) for r in results) / dt)
        return results

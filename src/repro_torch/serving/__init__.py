"""Continuous-batching serving engine of the port (counterpart of
``repro/serving``; DESIGN.md §12).

``KVPool`` allocates fixed-size cache pages out of one preallocated
arena; ``Scheduler`` admits requests and tracks lanes; ``Engine`` drives
``models.lm.paged_step`` at its two bucket shapes with greedy /
temperature / top-k sampling off a per-request counter RNG.
``python -m repro_torch.launch serve`` is the CLI surface.

    from repro_torch import serving

    engine = serving.Engine(cfg, params, spec.serving, device="cuda")
    results = engine.run([serving.Request(rid=0, tokens=[5, 7, 11])])
"""
from repro_torch.serving.engine import Engine, EngineUnsupported, GenResult
from repro_torch.serving.pool import KVPool, PoolExhausted, TRASH_PAGE
from repro_torch.serving.prefix import PrefixTrie
from repro_torch.serving.sampling import make_sampler
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["Engine", "EngineUnsupported", "GenResult", "KVPool",
           "PoolExhausted", "PrefixTrie", "Request", "Scheduler",
           "TRASH_PAGE", "make_sampler"]

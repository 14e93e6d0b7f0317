"""repro_torch.swarm — seed-synchronized multi-process ZO training of the
port (counterpart of ``repro/swarm``; DESIGN.md §14).

A MeZO/LeZO step is fully reproducible from ``(seed, projected-gradient
scalar)``: the perturbation z and the LeZO layer selection regenerate
from the counter RNG.  So a data-parallel swarm needs no gradient
all-reduce — each worker probes ±εz on its shard of the global batch
and ships two floats per shard; the coordinator reduces them in fixed
shard order and broadcasts ``(seed, g)`` back.  Per-step wire traffic
is a few hundred bytes regardless of model size, against ``4·|θ|``
for a first-order gradient exchange.

Modules:

* :mod:`~repro_torch.swarm.proto`       — length-prefixed JSON wire
  protocol (a copy of the reference's)
* :mod:`~repro_torch.swarm.commit`      — fixed-order host-side commit
  math (a copy of the reference's)
* :mod:`~repro_torch.swarm.shardstep`   — the decomposed sharded ZO step
  both the swarm and the single-process trainer execute on swarm specs
* :mod:`~repro_torch.swarm.coordinator` — shard assignment, quorum
  deadline, membership epochs, run-registry rows
* :mod:`~repro_torch.swarm.worker`      — elastic worker on a device
  (join mid-run by folding the committed ``(seed, g)`` log — no weight
  transfer)
* :mod:`~repro_torch.swarm.chaos`       — deterministic delay/drop/
  crash/partition schedules for fault testing (a copy of the
  reference's)
* :mod:`~repro_torch.swarm.driver`      — ``launch swarm`` process
  supervisor
"""
from repro_torch.swarm.chaos import Chaos, ChaosConfig
from repro_torch.swarm.commit import (commit_scalars, quorum_count,
                                      reduce_losses, shard_losses_dict)
from repro_torch.swarm.proto import Conn, StepCommit, StepContribution

__all__ = ["Chaos", "ChaosConfig", "Conn", "StepCommit", "StepContribution",
           "commit_scalars", "quorum_count", "reduce_losses",
           "shard_losses_dict"]

"""Serve fleet: multi-worker pool, failover routing, fault injection.

The port of ``cap_tpu.fleet``, the layer above
:mod:`cap_tpu_torch.serve`: one ``VerifyWorker`` process per exclusive
device group (``parallel.place.single_owner_placement``; one worker
owns the card, others may run on the CPU), supervised by
:class:`WorkerPool` (health pings, crash detection, respawn with
graceful drain, key-epoch convergence, postmortem collection), fronted
by :class:`FleetClient` (balancing, per-worker deadlines, circuit
breakers, hedged retry, checksummed frames, an optional caller-given
terminal fallback). :class:`PoolAutoscaler` resizes a pool and sheds
tenants on SLO burn. ``chaos`` is the fault-injection harness the
availability contract is tested against: zero wrong verdicts, zero
lost submissions, under kill -9, stalls, black holes, and corrupt
frames. ``python -m cap_tpu_torch.fleet.worker_main`` is the worker
process. Not ported yet (ROADMAP A item 8.5): the front door
(``FrontDoor``, ``ConsistentHashRing``).
"""

from .autoscale import PoolAutoscaler
from .pool import FleetError, WorkerPool
from .router import FleetClient, FleetExhaustedError

__all__ = ["FleetClient", "FleetError", "FleetExhaustedError",
           "PoolAutoscaler", "WorkerPool"]

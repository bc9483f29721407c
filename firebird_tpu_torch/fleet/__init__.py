"""Crash-tolerant fleet scheduling, the port of the JAX package's
``fleet``: a lease/heartbeat/fence job queue (fleet.queue) in the JAX
package's sqlite schema, the worker loop that drains it on the card
(fleet.worker), the multi-tile plan builder (fleet.plan), and the
elastic control plane that sizes the fleet from queue pressure
(fleet.policy + fleet.supervisor, host only)."""

from firebird_tpu_torch.fleet.queue import (FencedStore, FleetQueue, Lease,
                                            LeaseLost, StaleFence, queue_path)
from firebird_tpu_torch.fleet.worker import (WEDGED_EXIT, FleetWorker,
                                             make_queue)
from firebird_tpu_torch.fleet.plan import enqueue_repairs, enqueue_tile_plan
from firebird_tpu_torch.fleet.policy import (Decision, QueueSnapshot,
                                             ScalePolicy)
from firebird_tpu_torch.fleet.supervisor import Supervisor

__all__ = [
    "FencedStore", "FleetQueue", "Lease", "LeaseLost", "StaleFence",
    "queue_path", "WEDGED_EXIT", "FleetWorker", "make_queue",
    "enqueue_repairs",
    "enqueue_tile_plan", "Decision", "QueueSnapshot", "ScalePolicy",
    "Supervisor",
]

"""The fleet work queue's enqueue side (``fleet.queue``) and the repair
plan (``fleet.plan``), in the JAX package's sqlite schema.  The worker,
the supervisor and the scaling policy are not ported yet."""

from firebird_tpu_torch.fleet.plan import enqueue_repairs
from firebird_tpu_torch.fleet.queue import FleetQueue, queue_path

__all__ = ["FleetQueue", "enqueue_repairs", "queue_path"]

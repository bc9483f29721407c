"""Plan builder: the cold-path repair jobs.

The port's own copy of ``enqueue_repairs`` from the JAX package's
``fleet/plan.py``: one ``repair`` job per chip with pixels flagged
``needs_batch``, at most one open job a chip.  The tile-plan, classify,
product and fanout plans wait for the port's fleet worker.
"""

from __future__ import annotations

from firebird_tpu_torch.fleet.queue import FleetQueue
from firebird_tpu_torch.obs import metrics as obs_metrics


def enqueue_repairs(queue: FleetQueue, chips: dict, *, acquired: str,
                    max_attempts: int = 3,
                    run_id: str | None = None) -> list[int]:
    """Enqueue one ``repair`` job per chip of ``chips`` ({(cx, cy):
    flagged pixel count}) that does not already have an OPEN repair job
    — the at-most-one-open-job-per-chip idempotence rule, so a stream
    run re-rolling the same debt (every update re-reports needs_batch
    until the repair lands) cannot flood the queue.  Returns the NEW job
    ids; chips skipped for an open job count in
    ``repair_jobs_skipped_open``."""
    ids: list[int] = []
    skipped = 0
    for cid in sorted(chips):
        key = (int(cid[0]), int(cid[1]))
        # Check-and-insert in one queue transaction
        # (FleetQueue.enqueue_unique_chip): two schedulers racing on the
        # same chip cannot both enqueue.
        jid = queue.enqueue_unique_chip(
            "repair",
            {"cx": key[0], "cy": key[1], "acquired": acquired,
             "pixels": int(chips[cid]), "run_id": run_id},
            max_attempts=max_attempts)
        if jid is None:
            skipped += 1
        else:
            ids.append(jid)
    if ids:
        obs_metrics.counter(
            "repair_jobs_enqueued",
            help="cold-path repair jobs enqueued on the fleet queue "
                 "for needs_batch chips").inc(len(ids))
    if skipped:
        obs_metrics.counter(
            "repair_jobs_skipped_open",
            help="repair enqueues skipped because the chip already has "
                 "an open (pending/leased) repair job").inc(skipped)
    return ids

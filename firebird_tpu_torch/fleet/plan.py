"""Plan builder: a multi-tile campaign as one dependency-ordered queue.

The port's own copy of the JAX package's ``fleet/plan.py``: the same
payloads and dependency edges, so either package's worker drains a plan
the other enqueued.  Per tile, the chip enumeration splits into
``detect`` chunk jobs, an optional ``classify`` job blocked on ALL of
that tile's detection (it unblocks the moment the last chunk acks —
cross-stage scheduling, not phase barriers across the fleet), and
optional ``product`` jobs blocked on the classify (or directly on
detection when no classification is requested); ``fleet enqueue`` is
the command-line face.  :func:`enqueue_repairs` schedules the stream's
cold-path repair jobs and :func:`enqueue_fanout` the alert fanout's
per-shard delivery jobs.
"""

from __future__ import annotations

from firebird_tpu_torch import grid
from firebird_tpu_torch.fleet.queue import FleetQueue
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.utils.fn import partition_all, take


def enqueue_tile_plan(queue: FleetQueue, tiles, *, acquired: str,
                      number: int = 2500, chunk_size: int = 500,
                      msday: int | None = None, meday: int | None = None,
                      products=(), product_dates=(),
                      max_attempts: int = 3) -> dict:
    """Enqueue a campaign over ``tiles`` (an iterable of (x, y) points,
    one per tile).  Returns a summary: job ids by stage and totals.

    ``chunk_size`` is the detect-job granularity — smaller chunks mean
    finer re-delivery (a dead worker forfeits less work) at the cost of
    more queue traffic; it is the lease-time analog of the driver's
    failure-isolation chunk."""
    if (msday is None) != (meday is None):
        raise ValueError("classification needs both msday and meday")
    if bool(products) != bool(product_dates):
        raise ValueError("product jobs need both products and "
                         "product_dates")
    summary: dict = {"tiles": 0, "detect": [], "classify": [],
                     "product": []}
    for x, y in tiles:
        t = grid.tile(x=x, y=y)
        cids = list(take(number, grid.chips(t)))
        detect_ids = []
        for chunk in partition_all(max(int(chunk_size), 1), cids):
            jid = queue.enqueue(
                "detect",
                {"x": x, "y": y, "acquired": acquired,
                 "tile": {"h": t["h"], "v": t["v"]},
                 "cids": [[int(cx), int(cy)] for cx, cy in chunk]},
                max_attempts=max_attempts)
            detect_ids.append(jid)
        summary["detect"].extend(detect_ids)
        downstream = detect_ids
        if msday is not None:
            jid = queue.enqueue(
                "classify",
                {"x": x, "y": y, "acquired": acquired,
                 "msday": int(msday), "meday": int(meday),
                 "number": int(number)},
                depends_on=detect_ids, max_attempts=max_attempts)
            summary["classify"].append(jid)
            downstream = [jid]
        if products:
            # Bounds = bbox of the chips this plan actually detects
            # (chip ids ARE in-cell upper-left projection points), so
            # products.save covers the same area as the upstream stages
            # — a single [x, y] point would cover ONE chip of a
            # 2500-chip tile.
            xs = [float(c[0]) for c in cids]
            ys = [float(c[1]) for c in cids]
            jid = queue.enqueue(
                "product",
                {"bounds": [[min(xs), max(ys)], [max(xs), min(ys)]],
                 "products": list(products),
                 "product_dates": list(product_dates),
                 "acquired": acquired},
                depends_on=downstream, max_attempts=max_attempts)
            summary["product"].append(jid)
        summary["tiles"] += 1
    summary["jobs"] = (len(summary["detect"]) + len(summary["classify"])
                       + len(summary["product"]))
    return summary


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
        # Check-and-insert in ONE queue transaction
        # (FleetQueue.enqueue_unique_chip): two schedulers racing on the
        # same chip (a zombie stream worker and its successor — the
        # overlap PR 9 designs for) cannot both enqueue.
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


def enqueue_fanout(queue: FleetQueue, shards, *, max_attempts: int = 3,
                   run_id: str | None = None,
                   rolled_at: float | None = None) -> list[int]:
    """Enqueue one ``fanout`` job per rollup shard ({shard, since,
    upto, count} dicts from AlertLog.shards_since) whose OPEN fanout
    job does
    not already cover ``upto`` — the repair-plan idempotence rule,
    shard-keyed: the rollup poll re-reporting the same alerts (its
    watermark advances only after enqueue) cannot flood the queue, and
    an uncovered duplicate is harmless anyway because delivery drains
    forward-only per-subscriber cursors.  Returns the NEW job ids."""
    open_by_shard: dict[str, int] = {}
    for _, payload in queue.open_payloads("fanout"):
        s = payload.get("shard")
        if s is not None:
            open_by_shard[s] = max(open_by_shard.get(s, 0),
                                   int(payload.get("upto", 0)))
    ids: list[int] = []
    skipped = 0
    for sh in sorted(shards, key=lambda s: s["shard"]):
        if open_by_shard.get(sh["shard"], -1) >= int(sh["upto"]):
            skipped += 1
            continue
        ids.append(queue.enqueue(
            "fanout",
            {"shard": sh["shard"], "upto": int(sh["upto"]),
             "since": int(sh.get("since", 0)),
             "count": int(sh.get("count", 0)),
             "rolled_at": float(rolled_at) if rolled_at is not None
             else None, "run_id": run_id},
            max_attempts=max_attempts))
    if ids:
        obs_metrics.counter(
            "fanout_jobs_enqueued",
            help="fanout delivery jobs enqueued on the fleet queue "
                 "(one per quadkey shard with new alerts)").inc(len(ids))
    if skipped:
        obs_metrics.counter(
            "fanout_jobs_skipped_open",
            help="fanout enqueues skipped because an open job already "
                 "covers the shard's rollup watermark").inc(skipped)
    return ids

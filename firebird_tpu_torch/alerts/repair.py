"""Automatic cold-path repair: broken pixels become fleet jobs.

The port's own copy of the JAX package's ``alerts/repair.py``.  A
stream-confirmed break freezes the pixel (``StreamState.needs_batch``)
until a batch rerun re-initializes a segment after the break.  The stream
driver rolls the flagged pixels up per chip and enqueues idempotent
``repair`` jobs on the fleet queue (:func:`schedule_repairs`, at most one
open job a chip), and :func:`repair_chip` runs one:

- batch re-detection of the chip over the job's full acquired range on
  the card, republished through the keyed-upsert save path (the rows a
  scheduled batch rerun would write, magnitudes included);
- a fresh stream checkpoint seeded from the batch result: break_day
  clears, the pixel is live again, and a second break on the repaired tail
  alerts under its new break_day.
"""

from __future__ import annotations

import torch

from firebird_tpu_torch.obs import logger

log = logger("alerts")


def schedule_repairs(cfg, needs: dict, *, acquired: str,
                     run_id: str | None = None) -> list[int]:
    """Enqueue repair jobs for ``needs`` ({(cx, cy): flagged pixels});
    returns the new job ids.  A config with no file-backed queue location
    (memory store, no FIREBIRD_FLEET_DB) schedules nothing: the stream
    summary still reports the count."""
    from firebird_tpu_torch.fleet.plan import enqueue_repairs
    from firebird_tpu_torch.fleet.queue import FleetQueue, queue_path

    chips = {c: n for c, n in needs.items() if n > 0}
    if not chips:
        return []
    try:
        path = queue_path(cfg)
    except ValueError as e:
        log.warning("repair scheduling skipped: %s", e)
        return []
    queue = FleetQueue(path)
    try:
        return enqueue_repairs(queue, chips, acquired=acquired,
                               max_attempts=cfg.fleet_max_attempts,
                               run_id=run_id)
    finally:
        queue.close()


def repair_chip(cfg, cid, acquired: str, *, source=None, store=None,
                fence_guard=None, device=None) -> dict:
    """Cold-path repair of one chip on ``device`` (CUDA unless given):
    batch re-detection and a fresh stream checkpoint.  Returns a summary
    (``still_flagged``, the pixels flagged after the rerun, is normally 0:
    a tail still breaking re-alerts on its next stream update).

    ``fence_guard``: a zero-argument callable run just before the
    checkpoint save; a fleet worker passes one that raises when its lease
    lapsed, so a zombie cannot overwrite a live checkpoint with a stale
    seed."""
    from firebird_tpu_torch import retry as retrylib
    from firebird_tpu_torch.ccd import kernel
    from firebird_tpu_torch.ccd.incremental import StreamState
    from firebird_tpu_torch.driver import core as dcore
    from firebird_tpu_torch.driver import stream as sdrv
    from firebird_tpu_torch.ingest import pack
    from firebird_tpu_torch.serve.changefeed import append_product_writes
    from firebird_tpu_torch.store import AsyncWriter, open_store
    from firebird_tpu_torch.streamops import statestore as sstore_mod

    dcore.refuse_not_ported(cfg)
    dev = kernel.resolve_device(device)
    cx, cy = int(cid[0]), int(cid[1])
    source = source or dcore.make_source(cfg)
    own_store = store is None
    if store is None:
        store = open_store(cfg.store_backend, cfg.store_path,
                           cfg.keyspace())
    writer = AsyncWriter(store, retry=retrylib.RetryPolicy.for_store(cfg))
    try:
        chip = source.chip(cx, cy, acquired)
        if not chip.dates.shape[0]:
            raise ValueError(
                f"repair of chip ({cx},{cy}): no acquisitions in "
                f"{acquired}")
        packed = pack([chip], bucket=cfg.obs_bucket, max_obs=cfg.max_obs)
        # One chip, float32, the capacity check on: the stream
        # bootstrap's contract, so the republished rows and the reseeded
        # checkpoint are what a bootstrap over the same range gives.
        seg, n_real = dcore.detect_batch(
            packed, torch.float32, "off", check_capacity=True,
            compact=cfg.compact, device=dev)
        host = sdrv.drain_to_host(seg)
        dcore.write_batch_frames(packed, host, n_real, writer=writer)
        one = kernel.chip_slice(host, 0)
        st = StreamState.from_chip(one, device="cpu")
        side = sdrv.seed_side(packed, 0, one)
        if fence_guard is not None:
            fence_guard()
        sstore = sstore_mod.open_statestore(cfg)
        try:
            sstore.save((cx, cy), st, side)
        finally:
            sstore.close()
        writer.flush()
        # A repair republishes the chip's rows but clears its break, so
        # no alert announces it: the product_writes feed tells the serve
        # replicas, after the flush (a replica applying the record reads
        # the repaired rows).
        append_product_writes(cfg, "segment", [(cx, cy)])
        summary = {"chip": [cx, cy],
                   "obs": int(packed.n_obs[0]),
                   "active": int(st.active.sum()),
                   "still_flagged": int(st.needs_batch.sum())}
        log.info("repaired chip (%d,%d): %s", cx, cy, summary)
        return summary
    finally:
        writer.close()
        if own_store:
            store.close()

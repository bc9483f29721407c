"""Sharded alert fanout: rollup -> fleet jobs -> per-subscriber drain.

The port's own copy of the JAX package's ``alerts/fanout.py``, host only.
The flat WebhookDeliverer sweeps every subscriber from one loop; this
module splits delivery along the quadkey shard key so it rides the fleet's
elastic, crash-tolerant machinery:

- **Rollup** (:func:`rollup`): group the alerts past the durable rollup
  watermark by shard (``substr(qk, 1, prefix_len)``: one SQL group-by,
  AlertLog.shards_since) and enqueue one idempotent ``fanout`` job per
  shard on the FleetQueue (plan.enqueue_fanout skips shards whose open
  job already covers the watermark).  :class:`FanoutCoordinator` runs
  this on a poll thread inside ``serve``.
- **Drain** (:class:`FanoutDeliverer`): a fleet worker executing a
  shard's job loads the job window's alerts once, resolves the window's
  audience through the quadkey cell index (plus the shard's straggler
  cursor rows), and serves each candidate from its durable
  per-(subscriber, shard) cursor (AOI post-filter, delivery policy
  immediate | digest | batch, parking), POSTing under the webhook
  contract.  Cursors are forward-only (AlertLog.advance_fanout) and exist
  only mid-catch-up (a clean completion deletes the row; a held digest or
  a failure pins it), so worker SIGKILL, lease re-delivery and
  zombie/successor overlap re-deliver from the cursor without rewinding:
  at-least-once POSTs whose record ids give the receiver exactly-once
  records.  Webhook effects cannot be fenced (an HTTP POST is not a
  conditional write), which is why idempotence lives in the cursor +
  record-id contract rather than the queue's fencing tokens.

One shard job is O(window audience + stragglers + window alerts): the
quadkey index paid the audience-resolution cost at registration, so the
drain never scans subscribers.  Nothing here touches the card.
"""

from __future__ import annotations

import datetime
import json
import threading
import time

from firebird_tpu_torch import retry as retrylib
from firebird_tpu_torch.alerts.feed import WEBHOOK_BATCH, _default_post
from firebird_tpu_torch.alerts.log import MAX_PAGE, AlertLog
from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.obs import metrics as obs_metrics

log = logger("fanout")


def _parse_ts(iso: str | None) -> float | None:
    if not iso:
        return None
    try:
        return datetime.datetime.fromisoformat(iso).timestamp()
    except ValueError:
        return None


class FanoutDeliverer:
    """Drains one shard's fanout job: the job window's cell-index
    audience plus the shard's stragglers advance from their durable
    per-shard cursors to the job's ``upto`` bound.  Synchronous and
    re-runnable — the fleet worker's ``fanout`` handler is one
    :meth:`drain_shard` call.  ``post``/``sleep``/``clock``/``rng``
    are injectable for tests."""

    def __init__(self, alog: AlertLog, cfg, *, post=None, sleep=None,
                 clock=time.time, rng=None):
        self.log = alog
        self.cfg = cfg
        self.clock = clock
        self.rng = rng
        self._post = post or _default_post
        # Same shallow transient-retry stance as the flat deliverer:
        # the shard job itself re-delivers on failure, so deep inline
        # backoff would only stall the rest of the shard.
        self.policy = retrylib.RetryPolicy(
            1, base=0.5, cap=2.0, sleep=sleep,
            counter_name="alert_webhook_retries",
            counter_help="transient webhook-delivery failures retried")

    # -- one shard ----------------------------------------------------------

    # Acknowledged-chunk cursor advances accumulate and flush every
    # this-many delivered subscribers (and at drain end): one durable
    # transaction per flush instead of one per POST.  A SIGKILL between
    # POST and flush redelivers at most this window's chunks — the
    # receiver's record-id dedup absorbs them (the documented
    # at-least-once-POST contract), and on a busy shard the per-chunk
    # transactions would otherwise dominate the drain.
    FLUSH_EVERY = 64

    def drain_shard(self, shard: str, upto: int, *, since: int = 0,
                    batch: int = WEBHOOK_BATCH) -> int:
        """Serve one fanout job: the alerts in the shard's window
        (``since`` — the rollup watermark the job rolled from — up to
        ``upto``) go to the job's CANDIDATES, the union of

        - the window's cell audience (AlertLog.audience_for_cells over
          every window alert's quadkey prefix chain), and
        - the shard's stragglers (cursor rows behind ``since`` —
          held digests, parked/failed subscribers, partial advances
          from a killed worker), caught up from their cursors.

        Cost is O(audience + stragglers + window alerts), never
        O(shard subscribers): a cursor row only exists mid-catch-up
        (clean completion deletes it), so a quiet subscriber costs
        nothing after registration.  Returns records delivered
        (counted once per subscriber).  Parked subscribers are skipped
        (their pinned row holds; a later job redelivers); one
        subscriber's failure parks it and moves on — never stalls the
        shard."""
        upto, since = int(upto), int(since)
        # The shard's drained watermark supersedes the job's stamped
        # window start: a re-rolled or duplicate job over a covered
        # window shrinks to the uncovered remainder (usually nothing).
        since = max(since, self.log.shard_drained(shard))
        stragglers = self.log.shard_straggler_rows(shard, since)
        floor = min((int(c) for _, c in stragglers), default=since)
        if floor >= upto:
            return 0
        alerts: list[dict] = []
        cur = floor
        while True:
            page = self.log.alerts_for_shard(shard, after=cur, upto=upto,
                                             limit=MAX_PAGE)
            if not page:
                break
            alerts.extend(page)
            cur = page[-1]["id"]
        strag_ids = [int(s) for s, _ in stragglers]
        if not alerts:
            # Window already covered (e.g. a duplicate job): nothing is
            # pending for the stragglers either — catch their rows up
            # cursor-only (not retire: a digest row's last_sent is its
            # window clock, and this path cannot see modes).
            self.log.advance_fanout_many(
                shard, [(s, upto) for s in strag_ids], [])
            self.log.set_shard_drained(shard, since, upto)
            return 0
        cells: set = set()
        for a in alerts:
            qk = a["qk"]
            for i in range(len(qk) + 1):
                cells.add(qk[:i])
        cand = self.log.audience_for_cells(cells)
        if strag_ids:
            cand = sorted(set(cand).union(strag_ids))
        rows = self.log.subscriber_rows_by_id(cand, shard)
        # An unsubscribe can orphan a straggler's cursor row; drop it.
        dangling = set(strag_ids) - {int(r[0]) for r in rows}
        if dangling:
            self.log.advance_fanout_many(shard, [], sorted(dangling))
        if not rows:
            # A window with no audience is drained by definition.
            self.log.set_shard_drained(shard, since, upto)
            return 0
        # Columns: (id, url, aoi_minx, aoi_miny, aoi_maxx, aoi_maxy,
        # mode, window_sec, max_n, parked_until, failures, cursor,
        # last_sent) — see AlertLog.subscriber_rows_by_id.
        # The (candidate x alert) match is one chunked boolean matrix —
        # even a per-subscriber numpy slice (let alone a Python bbox
        # test per pair) measurably dominates a busy drain.
        import numpy as np

        ids = np.array([a["id"] for a in alerts], dtype=np.int64)
        pxs = np.array([a["px"] for a in alerts], dtype=np.float64)
        pys = np.array([a["py"] for a in alerts], dtype=np.float64)
        # Each record is serialised ONCE per job; payload bodies are
        # assembled from these fragments (a regional alert lands in
        # hundreds of payloads — re-dumping it per subscriber is
        # measurable CPU across a burst).
        enc = [json.dumps(a) for a in alerts]
        sid = np.array([r[0] for r in rows], dtype=np.int64)
        # Cursor -1 means NO catch-up row: the subscriber is caught up
        # through the shard's drained watermark (retirement's
        # invariant), so its effective cursor is the window start —
        # never 0, which would re-deliver the covered past.
        curs_raw = np.array([r[11] for r in rows], dtype=np.int64)
        has_row = curs_raw >= 0
        curs = np.where(has_row, curs_raw, since)
        inf = float("inf")
        minx = np.array([-inf if r[2] is None else r[2] for r in rows])
        miny = np.array([-inf if r[3] is None else r[3] for r in rows])
        maxx = np.array([inf if r[4] is None else r[4] for r in rows])
        maxy = np.array([inf if r[5] is None else r[5] for r in rows])
        parked = np.array([0.0 if r[9] is None else float(r[9])
                           for r in rows])
        now = self.clock()
        parked_mask = parked > now
        n_parked = int(parked_mask.sum())
        if n_parked:
            obs_metrics.counter(
                "fanout_skipped_parked_total",
                help="shard-drain subscriber visits skipped because "
                     "the subscriber is parked after consecutive "
                     "failures").inc(n_parked)
        active = (curs < upto) & ~parked_mask
        # A digest subscriber's row is its window clock (last_sent says
        # when the previous digest went out): it is NEVER auto-deleted,
        # only pinned/advanced — retiring it would let the next burst
        # flush inside a still-open window.
        is_digest = np.array([r[6] == "digest" for r in rows],
                             dtype=bool)
        # Candidates already past the bound carry leftover rows (a
        # zombie's late re-insert, a crash between final ack and row
        # delete): complete them so the rows drop.
        stale = ~parked_mask & ~active & has_row & ~is_digest
        delivered = 0
        # A parked candidate with NO row must be pinned at its
        # effective cursor before the watermark covers this window —
        # otherwise its alerts vanish behind it while it backs off.
        advances: list = [(int(s), since)
                          for s in sid[parked_mask & ~has_row]]
        completes: list = list(sid[stale].tolist())  # rows to delete
        pending_subs = 0
        # Bound the boolean matrix at ~4M cells whatever the alert
        # window's size — a backlogged shard must not trade the Python
        # loop for an allocation spike.
        chunk = max(256, min(8192, 4_000_000 // len(alerts)))
        for s0 in range(0, len(rows), chunk):
            s1 = min(s0 + chunk, len(rows))
            act = active[s0:s1]
            if not act.any():
                continue
            m = ((ids[None, :] > curs[s0:s1, None])
                 & (pxs[None, :] >= minx[s0:s1, None])
                 & (pxs[None, :] <= maxx[s0:s1, None])
                 & (pys[None, :] >= miny[s0:s1, None])
                 & (pys[None, :] <= maxy[s0:s1, None])
                 & act[:, None])
            hit = m.any(axis=1)
            # Nothing in the window concerns these candidates: whatever
            # catch-up row brought them here is settled — delete it.
            completes.extend(sid[s0:s1][
                act & ~hit & has_row[s0:s1] & ~is_digest[s0:s1]
            ].tolist())
            # A no-hit digest row instead catches up cursor-only
            # (last_sent untouched) so it stops reading as a straggler.
            advances.extend(
                (int(s), upto) for s in sid[s0:s1][
                    act & ~hit & has_row[s0:s1] & is_digest[s0:s1]])
            for k in np.nonzero(hit)[0]:
                r = rows[s0 + int(k)]
                # The EFFECTIVE cursor (no-row sentinel already mapped
                # to the window start): pins written from it must never
                # rewind a subscriber to the covered past.
                sub = {"id": int(r[0]), "url": r[1], "mode": r[6],
                       "window_sec": r[7], "max_n": r[8],
                       "failures": int(r[10]),
                       "cursor": int(curs[s0 + int(k)]),
                       "last_sent": r[12]}
                mi = np.nonzero(m[k])[0]
                delivered += self._deliver_sub(
                    shard, sub, [alerts[j] for j in mi],
                    [enc[j] for j in mi], upto, batch, advances,
                    completes)
                pending_subs += 1
                if pending_subs >= self.FLUSH_EVERY:
                    self.log.advance_fanout_many(shard, advances,
                                                 completes)
                    advances, completes, pending_subs = [], [], 0
        self.log.advance_fanout_many(shard, advances, completes)
        # The whole window was offered to its whole audience (anyone
        # still behind holds a pinned row): advance the watermark so a
        # duplicate job no-ops and future no-row candidates start here.
        # (Contiguity-guarded — see set_shard_drained: a newer window
        # completing ahead of an in-flight older one must not cover it.)
        self.log.set_shard_drained(shard, since, upto)
        return delivered

    def _deliver_sub(self, shard: str, sub: dict, matched: list[dict],
                     enc: list[str], upto: int, batch: int,
                     advances: list, completes: list) -> int:
        """One subscriber's drain to ``upto``: policy-shaped POSTs with
        the cursor advanced past each acknowledged chunk, then the
        catch-up row retired via ``completes`` once everything matched
        is out — nothing else in the window concerns this subscriber,
        and with no row left only the audience probe ever visits it
        again.  A held digest or a failure instead PINS the row at the
        current cursor so the straggler probe finds it, and a FLUSHED
        digest keeps its row too (advanced to ``upto``): last_sent is
        the digest window's clock.  ``enc`` holds
        the matched records pre-serialised (one json.dumps per record
        per job, however many payloads it lands in); advances land on
        ``advances`` for the caller's batched flush (see FLUSH_EVERY),
        not as per-chunk transactions."""
        mode = sub["mode"] or "immediate"
        if mode == "digest":
            window = float(sub["window_sec"] or 0.0)
            last = sub["last_sent"]
            if last is not None and self.clock() - float(last) < window:
                # Window still open: pin the cursor row so a later
                # job's straggler probe flushes the digest once the
                # window elapses.
                advances.append((sub["id"], sub["cursor"]))
                return 0
            chunks = [list(range(len(matched)))]
            schema = "firebird-alert-digest/1"
        else:
            size = batch if mode == "immediate" \
                else max(1, min(int(sub["max_n"]), batch))
            chunks = [list(range(i, min(i + size, len(matched))))
                      for i in range(0, len(matched), size)]
            schema = "firebird-alert-webhook/1"
        sent = 0
        for i, chunk in enumerate(chunks):
            cursor = upto if i == len(chunks) - 1 \
                else matched[chunk[-1]]["id"]
            body = ('{"schema": "%s", "shard": "%s", "cursor": %d, '
                    '"count": %d, "alerts": [%s]}'
                    % (schema, shard, cursor, len(chunk),
                       ", ".join(enc[j] for j in chunk))).encode()
            try:
                status = self.policy.run(
                    log, f"fanout {sub['url']}",
                    lambda b=body, u=sub["url"]: self._post(
                        u, b, self.cfg.alert_webhook_timeout))
            except Exception as e:
                self._flush_then_fail(shard, advances, completes, sub,
                                      f"{type(e).__name__}: {e}")
                return sent
            if not 200 <= int(status) < 300:
                self._flush_then_fail(shard, advances, completes, sub,
                                      f"answered {status}")
                return sent
            now = self.clock()
            advances.append((sub["id"], cursor, now))
            sent += len(chunk)
            obs_metrics.counter(
                "fanout_delivered_total",
                help="alert records delivered by shard fanout jobs "
                     "(2xx-acknowledged)").inc(len(chunk))
            oldest = min((t for t in (_parse_ts(matched[j].get(
                "detected_at")) for j in chunk) if t is not None),
                default=None)
            if oldest is not None:
                obs_metrics.histogram(
                    "alert_delivery_lag_seconds",
                    help="alert age at fanout delivery (append to "
                         "2xx-acknowledged POST, per chunk's oldest "
                         "record)").observe(max(now - oldest, 0.0))
        if mode != "digest":
            # Fully served: retire the catch-up row.  A digest row
            # stays — its last_sent is the window clock for the next
            # burst (the final advance above left it at ``upto``).
            completes.append(sub["id"])
        return sent

    def _flush_then_fail(self, shard: str, advances: list,
                         completes: list, sub: dict, why: str) -> None:
        """Pin the failed subscriber's cursor row (so the straggler
        probe redelivers it) and flush the pending advances BEFORE
        recording the failure: the batch may heal this subscriber for
        chunks acknowledged earlier in this very drain, and healing
        must not wipe the failure that just happened."""
        advances.append((sub["id"], sub["cursor"]))
        self.log.advance_fanout_many(shard, advances, completes)
        advances.clear()
        completes.clear()
        self._failed(sub, why)

    def _failed(self, sub: dict, why: str) -> None:
        delay = self.log.record_failure(
            sub["id"], park_after=self.cfg.fanout_park_after,
            base=self.cfg.fanout_park_base_sec,
            cap=self.cfg.fanout_park_cap_sec, rng=self.rng,
            clock=self.clock)
        obs_metrics.counter(
            "fanout_failures_total",
            help="fanout POSTs abandoned after retries (cursor held; "
                 "redelivered by a later job)").inc()
        if delay is not None:
            obs_metrics.counter(
                "fanout_parked_total",
                help="subscribers parked under decorrelated backoff "
                     "after consecutive delivery failures").inc()
        log.warning(
            "fanout to %s failed (%s); cursor held%s", sub["url"], why,
            f", parked {delay:.1f}s" if delay is not None else "")


# -- rollup (alerts -> fanout jobs) -----------------------------------------


def rollup(alog: AlertLog, queue, cfg, *, run_id: str | None = None,
           clock=time.time) -> list[int]:
    """One rollup pass: turn the quadkey-stamped alerts past the
    durable watermark into per-shard ``fanout`` jobs; returns the new
    job ids.  The watermark advances only AFTER the jobs are enqueued —
    a crash between group-by and enqueue re-rolls the same alerts, and
    the open-job skip plus forward-only delivery cursors make the
    duplicate harmless (at-least-once rollup, exactly-once records)."""
    from firebird_tpu_torch.fleet import plan

    start = alog.rollup_cursor()
    shards = alog.shards_since(start, cfg.fanout_shard_prefix)
    if not shards:
        return []
    ids = plan.enqueue_fanout(queue, shards, run_id=run_id,
                              rolled_at=clock())
    alog.set_rollup_cursor(max(s["upto"] for s in shards))
    return ids


class FanoutCoordinator:
    """The standing rollup loop ``firebird serve`` runs next to the
    webhook deliverer: poll the log, enqueue shard jobs, let the fleet
    deliver.  Crash-safe by construction — all state is the durable
    watermark + queue."""

    def __init__(self, alog: AlertLog, queue, cfg, *,
                 run_id: str | None = None):
        self.log = alog
        self.queue = queue
        self.cfg = cfg
        self.run_id = run_id
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def poll_once(self) -> list[int]:
        return rollup(self.log, self.queue, self.cfg,
                      run_id=self.run_id)

    def start(self) -> "FanoutCoordinator":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="firebird-fanout-rollup",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.fanout_poll_sec):
            try:
                self.poll_once()
            except Exception as e:
                # The rollup loop must outlive transient db/queue
                # hiccups — the watermark makes the next tick resume.
                log.error("fanout rollup failed (%s: %s)",
                          type(e).__name__, e)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

"""Changefeed: N serve replicas + a live writer, coherent over cursors:
the port's own copy of the JAX package's ``serve/changefeed.py``, with its
schema, so replicas of either package share one feed db.

The in-process invalidation (serve/cache.py StoreGenerations) sees only
writes made in the serving process: a writer in another process is
invisible until restart.  That was the single-replica deployment rule; a
replica *fleet* needs the generations bumped everywhere a write happens
anywhere.  The insight: the alert log already IS a durable cursor feed
of exactly which chips changed — the streaming writer appends one
record per confirmed break before it checkpoints.  So coherence is
O(changes), not O(requests): each replica **tails two cursors** —

- the **alert log** (alerts/log.py): every record names the chip whose
  segment rows the stream rewrote;
- a small **product_writes feed** (this module): appended by
  ``products.save`` and the repair path for the mutations that emit no
  alert (product-raster rewrites, repair re-detections).

and per applied record bumps exactly the touched chip's generations
(stale cache keys stop matching) and stale-marks the chip's ancestor
pyramid tiles (serve/pyramid.py).  Durability rule: the consumer
**invalidates first, checkpoints after** — a replica that dies
mid-apply re-applies the tail (idempotent stamps), never skips it.
And because in-memory generations die with the process while a
disk-spill cache does not, a consumer that RESUMES a durable cursor
folds the resumed cursor sum into the generations as an epoch
(StoreGenerations.epoch): pre-restart cache keys can only match again
if the feed did not move at all.

The feed db (``changefeed.db`` next to the store) also carries the
**replica registry**: each consumer checkpoints its cursors + lag under
its replica id every poll, so ``firebird status`` can show the fleet
(replica count, per-replica cursor lag) from one file.  A replica id
never seen before starts at cursor 0 and replays the whole feed — the
safe default for a cache dir of unknown freshness; stable ids (pass
``--replica-id`` / FIREBIRD_SERVE_REPLICA with a persistent cache dir)
skip the replay.

Lag is observable (``serve_changefeed_lag_seconds`` gauge = age of the
newest record applied in the last poll, 0 when caught up) and judged
(the ``changefeed_lag`` SLO leg, obs/slo.py): the staleness bound a
replica serves under is one poll interval + one apply, and the gauge is
the measured half of that promise.
"""

from __future__ import annotations

import datetime
import os
import socket
import sqlite3
import threading
import time

from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.obs import metrics as obs_metrics

log = logger("serve")

FEED_SCHEMA = "firebird-changefeed/1"

# One apply pass's page bound per feed — bounded memory, any depth
# reachable across polls (the alert log's MAX_PAGE discipline).
PAGE = 1000


def changefeed_db_path(cfg) -> str | None:
    """``cfg.changefeed_db`` when set, else ``changefeed.db`` next to
    the results store (the fleet.db placement rule); None — feed
    disabled — for the memory backend without an explicit path.

    The derived default requires the store to actually EXIST on disk:
    every legitimate producer/consumer (serve, products.save, repair)
    opens the store first, while a default-constructed Config in a
    stray cwd must not scatter ``changefeed.db`` files into
    directories that have no store at all (the repo-root litter bug)."""
    if getattr(cfg, "changefeed_db", ""):
        return cfg.changefeed_db
    from firebird_tpu_torch.driver import quarantine as qlib

    d = qlib._artifact_dir(cfg)
    if d is None or not os.path.exists(cfg.store_path):
        return None
    return os.path.join(d, "changefeed.db")


def default_replica_id(cfg=None) -> str:
    rid = getattr(cfg, "serve_replica", "") if cfg is not None else ""
    return rid or f"{socket.gethostname()}:{os.getpid()}"


def _now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


def _age_sec(iso: str | None, now: float) -> float | None:
    if not iso:
        return None
    try:
        t = datetime.datetime.fromisoformat(iso)
    except ValueError:
        return None
    return max(now - t.timestamp(), 0.0)


class ProductWrites:
    """The durable product_writes feed + replica registry (one WAL
    sqlite next to the store; writers and N replica readers coexist).

    Producer: :meth:`append` — one row per (table, chip) mutation, the
    rowid is the cursor.  Consumer: :meth:`since` pages past a cursor.
    Registry: :meth:`checkpoint` upserts a replica's applied cursors
    (monotonic forward — a restarted replica with stale state cannot
    rewind its own durable progress), :meth:`replicas` reads the fleet.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._con = sqlite3.connect(  # guarded-by: _lock
            path, timeout=60, isolation_level=None,
            check_same_thread=False)
        self._create()

    def _create(self) -> None:
        from firebird_tpu_torch.store.backends import _retry_locked

        with self._lock:
            con = self._con
            # N replicas open one fresh feed db simultaneously at fleet
            # bring-up: the WAL conversion and DDL need exclusive access
            # for an instant and the losers get 'database is locked'
            # immediately (not via the busy handler) — the exact race
            # store/backends.py retries, so retry it the same way here
            # rather than killing a replica's coherence loop at birth.
            _retry_locked(lambda: con.execute("PRAGMA journal_mode=WAL"))
            con.execute("PRAGMA synchronous=NORMAL")
            _retry_locked(lambda: con.execute("BEGIN IMMEDIATE"))
            try:
                con.execute(
                    "CREATE TABLE IF NOT EXISTS writes ("
                    " id INTEGER PRIMARY KEY AUTOINCREMENT,"
                    " tbl TEXT NOT NULL,"
                    " cx INTEGER NOT NULL, cy INTEGER NOT NULL,"
                    " written_at TEXT)")
                con.execute(
                    "CREATE TABLE IF NOT EXISTS replicas ("
                    " replica TEXT PRIMARY KEY,"
                    " host TEXT,"
                    " alert_cursor INTEGER NOT NULL DEFAULT 0,"
                    " writes_cursor INTEGER NOT NULL DEFAULT 0,"
                    " lag_sec REAL,"
                    " updated TEXT)")
                con.execute(
                    "CREATE TABLE IF NOT EXISTS meta ("
                    " key TEXT PRIMARY KEY, value TEXT)")
                con.execute(
                    "INSERT OR IGNORE INTO meta (key, value) "
                    "VALUES ('schema', ?)", (FEED_SCHEMA,))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise

    # -- producer -----------------------------------------------------------

    def append(self, table: str, chips) -> int:
        """One feed record per chip in ONE transaction; returns records
        appended.  ``chips`` is an iterable of (cx, cy)."""
        chips = [(int(c[0]), int(c[1])) for c in chips]
        if not chips:
            return 0
        now = _now_iso()
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                con.executemany(
                    "INSERT INTO writes (tbl, cx, cy, written_at) "
                    "VALUES (?, ?, ?, ?)",
                    [(table, cx, cy, now) for cx, cy in chips])
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        obs_metrics.counter(
            "changefeed_writes_appended",
            help="product_writes feed records appended (non-alert "
                 "mutations: products.save rasters, repair "
                 "re-detections)").inc(len(chips))
        return len(chips)

    # -- consumer -----------------------------------------------------------

    def since(self, cursor: int = 0, *, limit: int = PAGE) -> list[dict]:
        limit = max(1, min(int(limit), PAGE))
        with self._lock:
            rows = self._con.execute(
                "SELECT id, tbl, cx, cy, written_at FROM writes "
                "WHERE id > ? ORDER BY id LIMIT ?",
                (int(cursor), limit)).fetchall()
        return [{"id": int(i), "table": t, "cx": int(cx), "cy": int(cy),
                 "written_at": at} for i, t, cx, cy, at in rows]

    def latest_cursor(self) -> int:
        with self._lock:
            row = self._con.execute("SELECT MAX(id) FROM writes").fetchone()
        return int(row[0]) if row and row[0] is not None else 0

    # -- replica registry ---------------------------------------------------

    def checkpoint(self, replica: str, *, alert_cursor: int,
                   writes_cursor: int, lag_sec: float | None = None) -> None:
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                con.execute(
                    "INSERT INTO replicas (replica, host, alert_cursor, "
                    "writes_cursor, lag_sec, updated) VALUES "
                    "(?, ?, ?, ?, ?, ?) ON CONFLICT(replica) DO UPDATE "
                    "SET host = excluded.host,"
                    " alert_cursor = MAX(alert_cursor, "
                    "   excluded.alert_cursor),"
                    " writes_cursor = MAX(writes_cursor, "
                    "   excluded.writes_cursor),"
                    " lag_sec = excluded.lag_sec,"
                    " updated = excluded.updated",
                    (replica, socket.gethostname(), int(alert_cursor),
                     int(writes_cursor),
                     None if lag_sec is None else float(lag_sec),
                     _now_iso()))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise

    def replica_cursors(self, replica: str) -> tuple[int, int]:
        """(alert_cursor, writes_cursor) of a replica; (0, 0) for an
        unknown id — full-replay resume, the safe default."""
        with self._lock:
            row = self._con.execute(
                "SELECT alert_cursor, writes_cursor FROM replicas "
                "WHERE replica = ?", (replica,)).fetchone()
        return (int(row[0]), int(row[1])) if row else (0, 0)

    def replicas(self) -> list[dict]:
        latest = self.latest_cursor()
        now = time.time()
        with self._lock:
            rows = self._con.execute(
                "SELECT replica, host, alert_cursor, writes_cursor, "
                "lag_sec, updated FROM replicas ORDER BY replica"
            ).fetchall()
        return [{"replica": r, "host": h,
                 "alert_cursor": int(ac), "writes_cursor": int(wc),
                 "writes_behind": max(latest - int(wc), 0),
                 "lag_sec": lag, "updated": up,
                 "updated_age_sec": _age_sec(up, now)}
                for r, h, ac, wc, lag, up in rows]

    def status(self) -> dict:
        return {"path": self.path,
                "latest_cursor": self.latest_cursor(),
                "replicas": self.replicas()}

    def close(self) -> None:
        with self._lock:
            self._con.close()


class ChangefeedConsumer:
    """One replica's coherence loop: tail alert + product_writes
    cursors, bump generations, stale-stamp pyramid ancestors,
    checkpoint.  ``alerts`` is an alerts/log.AlertLog (or None),
    ``feed`` a :class:`ProductWrites` (or None — then cursors are
    process-local and the replica registry is dark), ``gens`` the
    replica's StoreGenerations, ``pyramid`` its TilePyramid (or None).
    """

    def __init__(self, gens, *, feed: ProductWrites | None = None,
                 alerts=None, pyramid=None, replica: str | None = None,
                 poll_sec: float = 2.0, clock=time.time):
        self.gens = gens
        self.feed = feed
        self.alerts = alerts
        self.pyramid = pyramid
        self.replica = replica or default_replica_id()
        self.poll_sec = float(poll_sec)
        self._clock = clock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if feed is not None:
            self._alert_cursor, self._writes_cursor = \
                feed.replica_cursors(self.replica)
        else:
            self._alert_cursor = self._writes_cursor = 0
        # Resuming past records whose generation bumps died with the
        # previous process: fold the resumed cursor sum into the gens
        # as an epoch, so cache keys (including persistent disk-spill
        # filenames) from before the restart can never match unless the
        # feed did not move at all (see StoreGenerations.epoch).
        if hasattr(gens, "epoch"):
            gens.epoch = self._alert_cursor + self._writes_cursor
        self._last_lag: float = 0.0      # consumer thread only
        self._applied_total = 0          # consumer thread only

    # -- one pass -----------------------------------------------------------

    def _apply(self, chips, table: str) -> None:
        # When the gens carry an on_bump hook (ServeService wires it to
        # pyramid.invalidate_chip), bump() already dirties the pyramid —
        # invalidating here too would double the meta-stamp walk.
        hook_covers = getattr(self.gens, "on_bump", None) is not None
        for cx, cy in chips:
            self.gens.bump(table, cx, cy)
            if self.pyramid is not None and not hook_covers:
                self.pyramid.invalidate_chip(cx, cy)

    def poll_once(self) -> dict:
        """Apply everything past both cursors (paged), then checkpoint.
        Returns {"applied", "lag_sec", ...} for tests and status."""
        applied = 0
        newest_iso: str | None = None
        if self.alerts is not None:
            while True:
                recs = self.alerts.since(self._alert_cursor, limit=PAGE)
                if not recs:
                    break
                # An alert is the stream writer republishing the chip's
                # segment rows: the segment generation is what every
                # cached frame/raster key embeds.
                self._apply({(r["cx"], r["cy"]) for r in recs}, "segment")
                self._alert_cursor = recs[-1]["id"]
                newest_iso = recs[-1].get("detected_at") or newest_iso
                applied += len(recs)
                if len(recs) < PAGE:
                    break
        if self.feed is not None:
            while True:
                recs = self.feed.since(self._writes_cursor, limit=PAGE)
                if not recs:
                    break
                for table in {r["table"] for r in recs}:
                    self._apply({(r["cx"], r["cy"]) for r in recs
                                 if r["table"] == table}, table)
                self._writes_cursor = recs[-1]["id"]
                newest_iso = recs[-1].get("written_at") or newest_iso
                applied += len(recs)
                if len(recs) < PAGE:
                    break
        # Lag: age of the newest record this pass applied — the time the
        # fleet served stale answers for it; caught-up polls read 0.
        lag = _age_sec(newest_iso, self._clock()) or 0.0 if applied else 0.0
        obs_metrics.gauge(
            "serve_changefeed_lag_seconds",
            help="age of the newest changefeed record applied by this "
                 "replica's last poll (0 = caught up at poll time)"
        ).set(lag)
        if applied:
            obs_metrics.counter(
                "changefeed_records_applied",
                help="changefeed records (alert log + product_writes) "
                     "applied to this replica's generations/pyramid"
            ).inc(applied)
        self._last_lag = lag
        self._applied_total += applied
        # Checkpoint AFTER the invalidations above are durable (pyramid
        # meta stamps hit disk in _apply): a crash between apply and
        # checkpoint re-applies — stamps are idempotent — never skips.
        if self.feed is not None:
            self.feed.checkpoint(self.replica,
                                 alert_cursor=self._alert_cursor,
                                 writes_cursor=self._writes_cursor,
                                 lag_sec=lag)
        return {"replica": self.replica, "applied": applied,
                "alert_cursor": self._alert_cursor,
                "writes_cursor": self._writes_cursor, "lag_sec": lag}

    # -- the loop -----------------------------------------------------------

    def start(self) -> "ChangefeedConsumer":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="firebird-changefeed", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_sec):
            try:
                self.poll_once()
            except Exception as e:
                # A transient db error must not kill coherence for the
                # replica's lifetime — the next tick retries from the
                # same cursors.
                log.error("changefeed poll failed (%s: %s)",
                          type(e).__name__, e)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def status(self) -> dict:
        return {"replica": self.replica,
                "alert_cursor": self._alert_cursor,
                "writes_cursor": self._writes_cursor,
                "applied_total": self._applied_total,
                "lag_sec": self._last_lag,
                "poll_sec": self.poll_sec}


def append_product_writes(cfg, table: str, chips) -> int:
    """Best-effort producer hook for batch writers (products.save, the
    repair path): append (table, chip) records to the config's feed.
    Returns records appended; 0 when the config has no feed location.
    Failures log — a mutation must land even when the coherence side
    channel is sick (replicas then catch up via restart/replay)."""
    chips = list(chips)
    if not chips:
        return 0
    path = changefeed_db_path(cfg)
    if path is None:
        return 0
    try:
        feed = ProductWrites(path)
        try:
            return feed.append(table, chips)
        finally:
            feed.close()
    except Exception as e:
        log.warning("product_writes append to %s failed (%s: %s); "
                    "replica caches will lag until restart/replay",
                    path, type(e).__name__, e)
        return 0

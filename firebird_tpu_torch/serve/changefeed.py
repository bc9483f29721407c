"""The product_writes feed's producer side.

The port's own copy of what the repair path needs from the JAX package's
``serve/changefeed.py``: :func:`changefeed_db_path`, the feed's writer
(:class:`ProductWrites`, with the JAX package's schema: the writes,
replicas and meta tables) and :func:`append_product_writes`.  A repair
republishes a chip's segment rows and clears its break, so no alert
announces it: one record here tells the serve replicas to drop what they
cached for the chip.  The serve side (the consumer, its cursors and the
replica registry's readers) is not ported yet.
"""

from __future__ import annotations

import datetime
import os
import sqlite3
import threading

from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.obs import metrics as obs_metrics

log = logger("serve")

FEED_SCHEMA = "firebird-changefeed/1"


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


def _now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


class ProductWrites:
    """The durable product_writes feed (one WAL sqlite next to the
    store): :meth:`append` writes one row per (table, chip) mutation, the
    rowid the cursor."""

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

    def close(self) -> None:
        with self._lock:
            self._con.close()


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

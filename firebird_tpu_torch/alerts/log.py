"""Durable, append-only alert log: one record per confirmed break.

The port's own copy of the producer half of the JAX package's
``alerts/log.py``: the stream driver appends one durable record the
moment a tail break confirms (``StreamState.break_day`` 0 -> > 0).  The
database is the JAX package's, table for table (the alert records, the
subscriber registry, the quadkey subscription cells and the fanout
cursors), so the JAX package's feed and fanout read what this log wrote.

- **sqlite next to the store.**  ``alerts.db`` via :func:`alert_db_path`
  (the fleet.db placement rule); WAL so readers and the stream's writer
  coexist.
- **Monotonic cursor.**  The rowid is the cursor: ``since(cursor)``
  returns records with ``id > cursor`` in id order.
- **Exactly-once emission.**  Records are UNIQUE on
  ``(px, py, break_day)``: a stream resume re-applying the same
  acquisitions re-emits the same logical alert and the log ignores it
  (``alert_deduped_total``).  A pixel whose repair lands and whose tail
  breaks again carries a new ``break_day``: a new alert.

Subscriber registration, audience resolution and the fanout shard plane
(the JAX package's ``alerts/feed.py`` and ``alerts/fanout.py`` and their
methods here) are not ported yet.
"""

from __future__ import annotations

import datetime
import os
import sqlite3
import threading
import time

from firebird_tpu_torch.alerts import subindex
from firebird_tpu_torch.obs import metrics as obs_metrics

ALERT_SCHEMA = "firebird-alert-log/1"

# A since() page bound: cursor pagination makes any depth reachable,
# one page must not balloon a response.
MAX_PAGE = 10_000


def alert_db_path(cfg) -> str | None:
    """The alert log for a config: ``cfg.alert_db`` when set, else
    ``alerts.db`` next to the results store (the fleet.db placement
    rule).  None (alerting disabled) for the memory backend without an
    explicit path: the log is an optional side product, so no location
    degrades to off rather than raising."""
    if cfg.alert_db:
        return cfg.alert_db
    from firebird_tpu_torch.driver import quarantine as qlib

    d = qlib._artifact_dir(cfg)
    return None if d is None else os.path.join(d, "alerts.db")


def _now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


class AlertLog:
    """The durable alert log.  Thread-safe within a process (one guarded
    connection) and process-safe across writers and readers (WAL + short
    transactions)."""

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
        # Depth tracked incrementally: one COUNT(*) at open, then +=
        # per append — a per-append full-table count would make hot-path
        # emission O(total log size).  Other writers' appends are
        # invisible to this tally; status()/count() stay exact.
        self._depth = self.count()  # guarded-by: _lock (int += only)
        # Chip -> base quadkey memo: records arrive chip-batched, the
        # projection math need not re-run per record.
        self._qk_cache: dict[tuple[int, int], str | None] = {}

    def _create(self) -> None:
        with self._lock:
            con = self._con
            con.execute("PRAGMA journal_mode=WAL")
            con.execute("PRAGMA synchronous=NORMAL")
            con.execute("BEGIN IMMEDIATE")
            try:
                con.execute(
                    "CREATE TABLE IF NOT EXISTS alerts ("
                    " id INTEGER PRIMARY KEY AUTOINCREMENT,"
                    " cx INTEGER NOT NULL, cy INTEGER NOT NULL,"
                    " px INTEGER NOT NULL, py INTEGER NOT NULL,"
                    " break_day REAL NOT NULL,"
                    " score REAL, magnitude REAL,"
                    " run_id TEXT, detected_at TEXT, trace TEXT,"
                    " UNIQUE (px, py, break_day))")
                # Guarded ALTERs, the trace-column precedent: pre-fanout
                # logs also lack qk (the chip's base quadkey stamped at
                # append; NULL for off-domain chips and for rows older
                # than the migration — both fan out through the legacy
                # whole-log deliverer only).
                cols = {row[1] for row in con.execute(
                    "PRAGMA table_info(alerts)")}
                if "trace" not in cols:
                    con.execute("ALTER TABLE alerts ADD COLUMN trace TEXT")
                if "qk" not in cols:
                    con.execute("ALTER TABLE alerts ADD COLUMN qk TEXT")
                con.execute(
                    "CREATE INDEX IF NOT EXISTS idx_alerts_chip "
                    "ON alerts (cx, cy)")
                con.execute(
                    "CREATE TABLE IF NOT EXISTS subscribers ("
                    " id INTEGER PRIMARY KEY AUTOINCREMENT,"
                    " url TEXT NOT NULL UNIQUE,"
                    " cursor INTEGER NOT NULL DEFAULT 0,"
                    " created TEXT, last_ok TEXT,"
                    " failures INTEGER NOT NULL DEFAULT 0)")
                # Fanout-plane subscriber columns: exact AOI (NULL =
                # global) for the post-filter behind the cell index,
                # delivery policy, and failure-parking state.
                scols = {row[1] for row in con.execute(
                    "PRAGMA table_info(subscribers)")}
                for col, typ in (
                        ("aoi_minx", "REAL"), ("aoi_miny", "REAL"),
                        ("aoi_maxx", "REAL"), ("aoi_maxy", "REAL"),
                        ("mode", "TEXT NOT NULL DEFAULT 'immediate'"),
                        ("window_sec", "REAL"), ("max_n", "INTEGER"),
                        ("parked_until", "REAL"), ("park_delay", "REAL")):
                    if col not in scols:
                        con.execute(f"ALTER TABLE subscribers "
                                    f"ADD COLUMN {col} {typ}")
                con.execute(
                    "CREATE TABLE IF NOT EXISTS subscription_cells ("
                    " cell TEXT NOT NULL, sub_id INTEGER NOT NULL,"
                    " PRIMARY KEY (cell, sub_id)) WITHOUT ROWID")
                con.execute(
                    "CREATE INDEX IF NOT EXISTS idx_cells_sub "
                    "ON subscription_cells (sub_id)")
                # Subscribers from before the cell index registered no
                # AOI — give them the root cell so they stay global
                # audience, exactly as they behaved pre-migration.
                con.execute(
                    "INSERT OR IGNORE INTO subscription_cells (cell, "
                    "sub_id) SELECT '', id FROM subscribers WHERE id "
                    "NOT IN (SELECT sub_id FROM subscription_cells)")
                con.execute(
                    "CREATE TABLE IF NOT EXISTS fanout_cursors ("
                    " sub_id INTEGER NOT NULL, shard TEXT NOT NULL,"
                    " cursor INTEGER NOT NULL DEFAULT 0, last_sent REAL,"
                    " PRIMARY KEY (sub_id, shard)) WITHOUT ROWID")
                # The shard drain's straggler probe (rows behind a job's
                # window start) walks this instead of the PK.
                con.execute(
                    "CREATE INDEX IF NOT EXISTS idx_fanout_shard "
                    "ON fanout_cursors (shard, cursor)")
                # Forward-only per-shard drained watermark: everything
                # at or below it was ATTEMPTED for the whole audience
                # (pinned cursor rows track who is still behind), so a
                # duplicate job over a covered window is a no-op and a
                # row-less subscriber reads as caught-up-through-it.
                con.execute(
                    "CREATE TABLE IF NOT EXISTS fanout_shards ("
                    " shard TEXT PRIMARY KEY,"
                    " drained INTEGER NOT NULL DEFAULT 0) WITHOUT ROWID")
                con.execute(
                    "CREATE TABLE IF NOT EXISTS meta ("
                    " key TEXT PRIMARY KEY, value TEXT)")
                con.execute(
                    "INSERT OR IGNORE INTO meta (key, value) "
                    "VALUES ('schema', ?)", (ALERT_SCHEMA,))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise

    # -- producer side ------------------------------------------------------

    def append(self, records, *, run_id: str | None = None,
               trace: str | None = None) -> tuple[int, int]:
        """Append alert records in ONE transaction; returns (inserted,
        deduped).  Each record: dict with cx, cy, px, py, break_day and
        optional score / magnitude.  Records whose (px, py, break_day)
        key already exists are ignored — stream resume and fleet
        re-delivery are exactly-once.  ``trace`` stamps the causal trace
        id (obs/tracing.py wire format) on every record that doesn't
        carry its own, so the alert row joins the fleet's cross-process
        telemetry chain all the way out to webhook delivery."""
        records = list(records)
        if not records:
            return 0, 0
        now = _now_iso()
        inserted = 0
        for r in records:
            key = (int(r["cx"]), int(r["cy"]))
            if key not in self._qk_cache:
                self._qk_cache[key] = subindex.base_quadkey(*key)
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                for r in records:
                    cur = con.execute(
                        "INSERT OR IGNORE INTO alerts (cx, cy, px, py, "
                        "break_day, score, magnitude, run_id, detected_at,"
                        " trace, qk) VALUES "
                        "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                        (int(r["cx"]), int(r["cy"]), int(r["px"]),
                         int(r["py"]), float(r["break_day"]),
                         float(r.get("score", 1.0)),
                         float(r.get("magnitude", 0.0)), run_id, now,
                         r.get("trace", trace),
                         self._qk_cache[(int(r["cx"]), int(r["cy"]))]))
                    inserted += cur.rowcount
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
            self._depth += inserted
            depth = self._depth
        deduped = len(records) - inserted
        if inserted:
            obs_metrics.counter(
                "alert_emitted_total",
                help="confirmed-break alerts appended to the durable "
                     "log").inc(inserted)
        if deduped:
            obs_metrics.counter(
                "alert_deduped_total",
                help="alert re-emissions ignored by the (pixel, "
                     "break_day) unique key (resume / re-delivery)").inc(
                deduped)
        obs_metrics.gauge(
            "alert_log_depth",
            help="total records in the durable alert log (as this "
                 "writer has seen it)").set(depth)
        return inserted, deduped

    # -- consumer side ------------------------------------------------------

    def since(self, cursor: int = 0, *, limit: int = 1000,
              bbox=None, t0=None, t1=None) -> list[dict]:
        """Records with ``id > cursor`` in id order (the resume
        contract).  ``bbox`` is (minx, miny, maxx, maxy) over the pixel
        projection coords; ``t0``/``t1`` are ISO dates bounding
        ``break_day``."""
        from firebird_tpu_torch.utils import dates as dt

        limit = max(1, min(int(limit), MAX_PAGE))
        sql = ("SELECT id, cx, cy, px, py, break_day, score, magnitude, "
               "run_id, detected_at, trace FROM alerts WHERE id > ?")
        args: list = [int(cursor)]
        if bbox is not None:
            minx, miny, maxx, maxy = (float(v) for v in bbox)
            sql += " AND px >= ? AND px <= ? AND py >= ? AND py <= ?"
            args += [minx, maxx, miny, maxy]
        if t0 is not None:
            sql += " AND break_day >= ?"
            args.append(float(dt.to_ordinal(t0)))
        if t1 is not None:
            sql += " AND break_day <= ?"
            args.append(float(dt.to_ordinal(t1)))
        sql += " ORDER BY id LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self._con.execute(sql, args).fetchall()
        out = []
        for (rid, cx, cy, px, py, bday, score, mag, run_id,
             detected_at, trace) in rows:
            out.append({
                "id": int(rid), "cx": int(cx), "cy": int(cy),
                "px": int(px), "py": int(py),
                "break_day": float(bday),
                "break_date": dt.to_iso(int(bday)),
                "score": score, "magnitude": mag,
                "run_id": run_id, "detected_at": detected_at,
                "trace": trace})
        return out

    def latest_cursor(self) -> int:
        with self._lock:
            row = self._con.execute("SELECT MAX(id) FROM alerts").fetchone()
        return int(row[0]) if row and row[0] is not None else 0

    def count(self) -> int:
        with self._lock:
            return int(self._con.execute(
                "SELECT COUNT(*) FROM alerts").fetchone()[0])

    def subscribers(self) -> list[dict]:
        latest = self.latest_cursor()
        with self._lock:
            rows = self._con.execute(
                "SELECT id, url, cursor, created, last_ok, failures, "
                "aoi_minx, aoi_miny, aoi_maxx, aoi_maxy, mode, "
                "window_sec, max_n, parked_until "
                "FROM subscribers ORDER BY id").fetchall()
        return [{"id": int(i), "url": u, "cursor": int(c),
                 "lag": max(latest - int(c), 0), "created": cr,
                 "last_ok": ok, "failures": int(f),
                 "aoi": None if x0 is None else (x0, y0, x1, y1),
                 "mode": m, "window_sec": w, "max_n": n,
                 "parked_until": p}
                for i, u, c, cr, ok, f, x0, y0, x1, y1, m, w, n, p
                in rows]

    def rollup_cursor(self) -> int:
        """The global rollup watermark: every quadkey-stamped alert at
        or below it has been covered by an enqueued fanout job."""
        with self._lock:
            row = self._con.execute(
                "SELECT value FROM meta WHERE key = "
                "'fanout_rollup_cursor'").fetchone()
        return int(row[0]) if row else 0

    # -- operator surface ---------------------------------------------------

    def status(self) -> dict:
        """The alerts view: log depth, latest cursor, per-subscriber
        delivery lag — rendered by ``firebird status`` and the
        ``/progress`` alerts block."""
        now = time.time()
        with self._lock:
            cells = int(self._con.execute(
                "SELECT COUNT(*) FROM subscription_cells").fetchone()[0])
            by_mode = {m: int(n) for m, n in self._con.execute(
                "SELECT mode, COUNT(*) FROM subscribers GROUP BY mode")}
            parked = int(self._con.execute(
                "SELECT COUNT(*) FROM subscribers WHERE parked_until "
                "IS NOT NULL AND parked_until > ?", (now,)).fetchone()[0])
        return {
            "path": self.path,
            "depth": self.count(),
            "latest_cursor": self.latest_cursor(),
            "subscribers": self.subscribers(),
            "fanout": {
                "cells": cells,
                "by_mode": by_mode,
                "parked": parked,
                "rollup_cursor": self.rollup_cursor(),
            },
        }

    def close(self) -> None:
        with self._lock:
            self._con.close()

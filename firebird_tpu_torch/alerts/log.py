"""Durable, append-only alert log: one record per confirmed break.

The port's own copy of the JAX package's ``alerts/log.py``: the stream
driver appends one durable record the moment a tail break confirms
(``StreamState.break_day`` 0 -> > 0), and the feed (alerts/feed.py) and
the fanout plane (alerts/fanout.py) deliver it to subscribers.  The
database is the JAX package's, table for table (the alert records, the
subscriber registry, the quadkey subscription cells and the fanout
cursors), so either package's feed and fanout read what the other's log
wrote.

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

- **Durable subscriber cursors.**  Webhook subscribers live in the same
  database with their delivery cursor; delivery crash-resumes from the
  cursor, never from "the beginning" or "now".

The fanout plane (alerts/fanout.py) adds three sharded structures on top,
all migrated in with the same guarded-ALTER discipline as the ``trace``
column:

- alerts carry their chip's base **quadkey** (``qk``) so shard rollup is
  a ``substr()`` group-by: the shard key is a quadkey prefix and can
  change width without restamping the log.
- ``subscription_cells`` maps covering quadkey cells -> subscriber ids
  (alerts/subindex.py), turning audience resolution into an O(levels)
  cell lookup; subscribers gain an exact AOI for the post-filter plus a
  delivery policy (immediate | digest | batch) and parking state.
- ``fanout_cursors`` holds per-(subscriber, shard) forward-only delivery
  cursors: every alert belongs to exactly one shard, so the per-shard
  cursors compose to the same exactly-once contract the flat cursor
  gives, while letting shard jobs drain independently.
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
# one page must not balloon a response or an SSE write burst.
MAX_PAGE = 10_000

# Per-subscriber delivery policies: immediate POSTs every page as it
# lands, digest coalesces a window into one summary POST, batch bounds each
# POST to max_n records.
MODES = ("immediate", "digest", "batch")


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


def _validate_policy(mode: str, window_sec, max_n) -> None:
    if mode not in MODES:
        raise ValueError(
            f"delivery mode must be one of {MODES}, got {mode!r}")
    if mode == "digest" and (window_sec is None or float(window_sec) <= 0):
        raise ValueError(
            f"digest mode needs window_sec > 0, got {window_sec!r}")
    if mode == "batch" and (max_n is None or int(max_n) < 1):
        raise ValueError(f"batch mode needs max_n >= 1, got {max_n!r}")


class AlertLog:
    """The durable alert log and subscriber registry.  Thread-safe within
    a process (one guarded connection) and process-safe across the stream
    writer and serve readers (WAL + short transactions)."""

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

    # -- subscribers --------------------------------------------------------

    def subscribe(self, url: str, *, cursor: int | None = None,
                  aoi=None, mode: str = "immediate",
                  window_sec: float | None = None,
                  max_n: int | None = None,
                  max_cells: int | None = None) -> int:
        """Register a webhook subscriber; returns its id.  Idempotent on
        url (re-registering keeps the existing durable cursor but
        REPLACES the AOI, covering cells, and delivery policy).  A new
        subscriber's cursor defaults to 0 — full catch-up from the log's
        beginning; pass ``cursor`` to start elsewhere (e.g.
        ``latest_cursor()`` for new-alerts-only).  ``aoi`` is an exact
        (minx, miny, maxx, maxy) projection bbox (None = global),
        decomposed into at most ``max_cells`` covering quadkey cells in
        the subscription index; ``mode``/``window_sec``/``max_n`` pick
        the delivery policy (docs/ALERTS.md "Fanout plane")."""
        return self.subscribe_many(
            [{"url": url, "cursor": cursor, "aoi": aoi, "mode": mode,
              "window_sec": window_sec, "max_n": max_n}],
            max_cells=max_cells)[0]

    def subscribe_many(self, entries, *,
                       max_cells: int | None = None) -> list[int]:
        """Bulk :meth:`subscribe` — one transaction for the whole list
        (the 1M-subscriber loadtest's registration path).  Each entry is
        a dict with ``url`` and optional ``cursor`` / ``aoi`` / ``mode``
        / ``window_sec`` / ``max_n``.  Returns ids in entry order."""
        budget = subindex.MAX_CELLS if max_cells is None else int(max_cells)
        prepared = []
        for e in entries:
            url = e.get("url")
            if not url or "://" not in url:
                raise ValueError(
                    f"subscriber url must be absolute, got {url!r}")
            mode = e.get("mode") or "immediate"
            window_sec, max_n = e.get("window_sec"), e.get("max_n")
            _validate_policy(mode, window_sec, max_n)
            aoi = e.get("aoi")
            if aoi is not None:
                aoi = tuple(float(v) for v in aoi)
            cells = [""] if aoi is None else subindex.cover_bbox(aoi, budget)
            prepared.append((url, int(e.get("cursor") or 0), aoi, mode,
                             window_sec, max_n, cells))
        ids: list[int] = []
        now = _now_iso()
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                for url, cur0, aoi, mode, window_sec, max_n, cells \
                        in prepared:
                    minx, miny, maxx, maxy = aoi or (None,) * 4
                    con.execute(
                        "INSERT INTO subscribers (url, cursor, created, "
                        "aoi_minx, aoi_miny, aoi_maxx, aoi_maxy, mode, "
                        "window_sec, max_n) "
                        "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?) "
                        "ON CONFLICT (url) DO UPDATE SET "
                        "aoi_minx = excluded.aoi_minx, "
                        "aoi_miny = excluded.aoi_miny, "
                        "aoi_maxx = excluded.aoi_maxx, "
                        "aoi_maxy = excluded.aoi_maxy, "
                        "mode = excluded.mode, "
                        "window_sec = excluded.window_sec, "
                        "max_n = excluded.max_n",
                        (url, cur0, now, minx, miny, maxx, maxy, mode,
                         window_sec, max_n))
                    sid = int(con.execute(
                        "SELECT id FROM subscribers WHERE url = ?",
                        (url,)).fetchone()[0])
                    con.execute("DELETE FROM subscription_cells "
                                "WHERE sub_id = ?", (sid,))
                    con.executemany(
                        "INSERT OR IGNORE INTO subscription_cells "
                        "(cell, sub_id) VALUES (?, ?)",
                        [(c, sid) for c in cells])
                    ids.append(sid)
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        return ids

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

    # -- audience resolution (the quadkey subscription index) ---------------

    def audience(self, px: float, py: float) -> list[int]:
        """Subscriber ids whose AOI contains projection point
        (px, py), resolved through the subscription-cell index: one
        ``cell IN (O(levels) quadkeys)`` probe plus the exact-AOI
        post-filter — cost independent of subscriber count (the
        sublinearity the fanout loadtest measures).  Defined for
        in-domain points; off-domain points see global subscribers
        only (their alerts carry no quadkey)."""
        cells = subindex.point_cells(px, py)
        t0 = time.perf_counter()
        marks = ",".join("?" * len(cells))
        with self._lock:
            rows = self._con.execute(
                f"SELECT DISTINCT s.id FROM subscription_cells c "
                f"JOIN subscribers s ON s.id = c.sub_id "
                f"WHERE c.cell IN ({marks}) AND (s.aoi_minx IS NULL OR "
                f"(s.aoi_minx <= ? AND ? <= s.aoi_maxx AND "
                f"s.aoi_miny <= ? AND ? <= s.aoi_maxy)) ORDER BY s.id",
                (*cells, float(px), float(px), float(py),
                 float(py))).fetchall()
        obs_metrics.histogram(
            "audience_resolve_seconds",
            help="alert audience resolution through the quadkey "
                 "subscription index (per alert point)").observe(
            time.perf_counter() - t0)
        return [int(r[0]) for r in rows]

    def audience_brute(self, px: float, py: float) -> list[int]:
        """The pre-index audience answer: a full bbox scan of every
        subscriber.  The property test pins audience() == this; the
        loadtest times it as the O(subscribers) contrast."""
        with self._lock:
            rows = self._con.execute(
                "SELECT id FROM subscribers WHERE aoi_minx IS NULL OR "
                "(aoi_minx <= ? AND ? <= aoi_maxx AND aoi_miny <= ? "
                "AND ? <= aoi_maxy) ORDER BY id",
                (float(px), float(px), float(py),
                 float(py))).fetchall()
        return [int(r[0]) for r in rows]

    # -- shard plane (fanout rollup + drain queries) ------------------------

    def shards_since(self, cursor: int, prefix_len: int) -> list[dict]:
        """The shards with quadkey-stamped alerts past ``cursor``:
        ``[{shard, since, upto, count}]`` where ``upto`` is the shard's
        max alert id and ``since`` echoes the watermark the group-by
        started from — one rollup group-by, the unit the coordinator
        turns into ``fanout`` fleet jobs (the drain needs ``since`` to
        tell stragglers from caught-up subscribers)."""
        with self._lock:
            rows = self._con.execute(
                "SELECT substr(qk, 1, ?) AS s, MAX(id), COUNT(*) "
                "FROM alerts WHERE id > ? AND qk IS NOT NULL "
                "GROUP BY s ORDER BY s",
                (int(prefix_len), int(cursor))).fetchall()
        return [{"shard": s, "since": int(cursor), "upto": int(mx),
                 "count": int(n)}
                for s, mx, n in rows]

    def alerts_for_shard(self, shard: str, *, after: int = 0,
                         upto: int, limit: int = 1000) -> list[dict]:
        """The shard's alert records with ``after < id <= upto`` in id
        order — the drain page of one fanout job (same record shape as
        :meth:`since`, plus ``qk``)."""
        from firebird_tpu_torch.utils import dates as dt

        limit = max(1, min(int(limit), MAX_PAGE))
        with self._lock:
            rows = self._con.execute(
                "SELECT id, cx, cy, px, py, break_day, score, magnitude,"
                " run_id, detected_at, trace, qk FROM alerts "
                "WHERE id > ? AND id <= ? AND qk IS NOT NULL "
                "AND substr(qk, 1, ?) = ? ORDER BY id LIMIT ?",
                (int(after), int(upto), len(shard), shard,
                 limit)).fetchall()
        return [{"id": int(rid), "cx": int(cx), "cy": int(cy),
                 "px": int(px), "py": int(py), "break_day": float(bday),
                 "break_date": dt.to_iso(int(bday)), "score": score,
                 "magnitude": mag, "run_id": run_id,
                 "detected_at": detected_at, "trace": trace, "qk": qk}
                for (rid, cx, cy, px, py, bday, score, mag, run_id,
                     detected_at, trace, qk) in rows]

    def shard_subscribers(self, shard: str) -> list[dict]:
        """The subscribers a shard's fanout job must serve — any
        subscriber with a covering cell inside the shard's subtree
        (``LIKE shard%``) or on its ancestor chain (coarse and global
        cells), each joined with its durable per-shard fanout cursor."""
        rows = self.shard_subscriber_rows(shard)
        return [{"id": int(i), "url": u,
                 "aoi": None if x0 is None else (x0, y0, x1, y1),
                 "mode": m, "window_sec": w, "max_n": n,
                 "parked_until": p, "failures": int(f),
                 "cursor": int(c), "last_sent": ls}
                for i, u, x0, y0, x1, y1, m, w, n, p, f, c, ls in rows]

    def shard_subscriber_rows(self, shard: str) -> list[tuple]:
        """:meth:`shard_subscribers` as raw ``(id, url, aoi_minx,
        aoi_miny, aoi_maxx, aoi_maxy, mode, window_sec, max_n,
        parked_until, failures, cursor, last_sent)`` tuples — the shard
        drain turns tens of thousands of these into numpy columns, and
        building a dict per subscriber first is measurable CPU at that
        scale.

        The subtree arm is an explicit ``[shard, shard+1)`` range on
        the ``(cell, sub_id)`` primary key, UNIONed with equality
        probes for the ancestor cells: a single ``LIKE-or-IN``
        predicate makes sqlite abandon the index for a full scan of
        the cell table — the difference between O(shard) and O(every
        cell of every subscriber) per fanout job."""
        prefixes = subindex.shard_prefixes(shard)
        # Quadkey digits are 0-3, so bumping the last digit bounds the
        # subtree ("01" -> ["01", "02")) without overflow.
        hi = shard[:-1] + chr(ord(shard[-1]) + 1)
        sub = ("SELECT sub_id FROM subscription_cells "
               "WHERE cell >= ? AND cell < ?")
        args: list = [shard, shard, hi]
        if prefixes:
            sub += (" UNION SELECT sub_id FROM subscription_cells "
                    f"WHERE cell IN ({','.join('?' * len(prefixes))})")
            args += prefixes
        with self._lock:
            return self._con.execute(
                self._SUB_ROW_SELECT
                + f"WHERE s.id IN ({sub}) ORDER BY s.id",
                args).fetchall()

    # One fanout job's candidate set: the window alerts' cell audience
    # plus the shard's stragglers.  Cost is O(audience + stragglers) —
    # never O(shard subscribers), which is the point of the cell index.
    _SUB_ROW_SELECT = (
        "SELECT s.id, s.url, s.aoi_minx, s.aoi_miny, "
        "s.aoi_maxx, s.aoi_maxy, s.mode, s.window_sec, s.max_n, "
        "s.parked_until, s.failures, "
        "COALESCE(fc.cursor, 0), fc.last_sent "
        "FROM subscribers s "
        "LEFT JOIN fanout_cursors fc "
        "ON fc.sub_id = s.id AND fc.shard = ? ")

    def audience_for_cells(self, cells) -> list[int]:
        """DISTINCT subscriber ids holding any of ``cells`` — the
        batched audience probe of one fanout job's alert window (the
        union of every window alert's prefix chain, deduplicated by the
        caller).  Covering cells over-approximate AOIs, so the drain
        still applies the exact vectorised bbox filter; this only
        bounds WHOM it looks at."""
        out: set = set()
        cells = list(cells)
        with self._lock:
            for i in range(0, len(cells), 500):
                chunk = cells[i:i + 500]
                rows = self._con.execute(
                    "SELECT DISTINCT sub_id FROM subscription_cells "
                    f"WHERE cell IN ({','.join('?' * len(chunk))})",
                    chunk).fetchall()
                out.update(int(r[0]) for r in rows)
        return sorted(out)

    def shard_straggler_rows(self, shard: str, since: int) -> list[tuple]:
        """``(sub_id, cursor)`` for the shard's cursor rows still behind
        ``since`` (a job's window start): held digests, parked/failed
        subscribers, and partial advances from a killed worker.  A
        cursor row only EXISTS while its subscriber is mid-catch-up
        (clean completion deletes it — see advance_fanout_many), so
        this stays small however many subscribers the shard has."""
        with self._lock:
            return self._con.execute(
                "SELECT sub_id, cursor FROM fanout_cursors "
                "WHERE shard = ? AND cursor < ?",
                (shard, int(since))).fetchall()

    def subscriber_rows_by_id(self, ids, shard: str) -> list[tuple]:
        """The :meth:`shard_subscriber_rows` tuple shape for an explicit
        id set (a drain's audience-union-stragglers candidates), joined
        with the per-``shard`` fanout cursor — except the cursor column
        is ``-1`` when NO row exists (the drain must tell "caught up
        through the shard watermark, no row" from "pinned at 0").
        ``ids`` must be sorted for the result to be id-ordered."""
        ids = [int(i) for i in ids]
        out: list[tuple] = []
        sel = self._SUB_ROW_SELECT.replace("COALESCE(fc.cursor, 0)",
                                           "COALESCE(fc.cursor, -1)")
        with self._lock:
            for i in range(0, len(ids), 500):
                chunk = ids[i:i + 500]
                out.extend(self._con.execute(
                    sel
                    + f"WHERE s.id IN ({','.join('?' * len(chunk))}) "
                      "ORDER BY s.id",
                    [shard, *chunk]).fetchall())
        return out

    def shard_drained(self, shard: str) -> int:
        """The shard's forward-only drained watermark (0 if never
        drained): alert ids at or below it have been offered to their
        whole audience — whoever is still behind has a pinned cursor
        row saying so."""
        with self._lock:
            row = self._con.execute(
                "SELECT drained FROM fanout_shards WHERE shard = ?",
                (shard,)).fetchone()
        return int(row[0]) if row else 0

    def set_shard_drained(self, shard: str, since: int,
                          upto: int) -> None:
        """Advance the shard's drained watermark — forward-only (a
        zombie worker finishing a stale job cannot undo its successor)
        AND contiguous: the covered window must START at or below the
        current watermark.  Jobs over successive windows of one shard
        can run concurrently; if the newer window completes first, its
        ``upto`` must not mark the older, still-in-flight window
        covered — a SIGKILL there would silently lose it."""
        since, upto = int(since), int(upto)
        with self._lock:
            if since <= 0:
                # Contiguity is trivially satisfied from the log's
                # start; this is also the only path that may CREATE
                # the shard's row.
                self._con.execute(
                    "INSERT INTO fanout_shards (shard, drained) "
                    "VALUES (?, ?) ON CONFLICT (shard) DO UPDATE SET "
                    "drained = excluded.drained "
                    "WHERE excluded.drained > fanout_shards.drained",
                    (shard, upto))
            else:
                self._con.execute(
                    "UPDATE fanout_shards SET drained = ? "
                    "WHERE shard = ? AND drained < ? AND drained >= ?",
                    (upto, shard, upto, since))

    def fanout_cursor(self, sub_id: int, shard: str) -> int:
        with self._lock:
            row = self._con.execute(
                "SELECT cursor FROM fanout_cursors WHERE sub_id = ? "
                "AND shard = ?", (int(sub_id), shard)).fetchone()
        return int(row[0]) if row else 0

    def advance_fanout(self, sub_id: int, shard: str, cursor: int, *,
                       sent_at: float | None = None) -> None:
        """Move a (subscriber, shard) fanout cursor FORWARD — same
        no-rewind rule as :meth:`advance`, so a zombie fanout worker
        finishing a stale job cannot undo its successor.  ``sent_at``
        marks an actual 2xx POST: it stamps the digest window's
        last-sent time and unparks/heals the subscriber (a cursor-only
        advance — e.g. a page the AOI filtered to nothing — touches
        neither)."""
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                con.execute(
                    "INSERT INTO fanout_cursors (sub_id, shard, cursor, "
                    "last_sent) VALUES (?, ?, ?, ?) "
                    "ON CONFLICT (sub_id, shard) DO UPDATE SET "
                    "cursor = excluded.cursor, last_sent = "
                    "COALESCE(excluded.last_sent, fanout_cursors."
                    "last_sent) WHERE excluded.cursor > "
                    "fanout_cursors.cursor",
                    (int(sub_id), shard, int(cursor), sent_at))
                if sent_at is not None:
                    con.execute(
                        "UPDATE subscribers SET failures = 0, "
                        "parked_until = NULL, park_delay = NULL, "
                        "last_ok = ? WHERE id = ?",
                        (_now_iso(), int(sub_id)))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise

    def advance_fanout_many(self, shard: str, advances,
                            completes=()) -> None:
        """Batch fanout-cursor advance in ONE transaction: ``advances``
        holds ``(sub_id, cursor)`` pairs (cursor-only — pins a held
        digest or a failed subscriber so the straggler probe can find
        it) and/or ``(sub_id, cursor, sent_at)`` triples
        (2xx-acknowledged deliveries — stamps the digest window's
        last-sent time and heals failures/parking, exactly like
        :meth:`advance_fanout`).  Same forward-only rule throughout; a
        per-subscriber transaction each would dominate the drain.

        ``completes`` lists subscribers whose drain finished CLEAN to
        the job's bound: their cursor rows are DELETED — no row means
        "caught up; only the audience probe need ever visit me again".
        A zombie's late advance can re-insert a stale row, which the
        next job re-drains into receiver-deduplicated re-POSTs and
        deletes again — at-least-once POSTs, exactly-once records."""
        rows = []
        healed = []
        for adv in advances:
            sub_id, cursor = int(adv[0]), int(adv[1])
            sent_at = adv[2] if len(adv) > 2 else None
            rows.append((sub_id, shard, cursor, sent_at))
            if sent_at is not None:
                healed.append(sub_id)
        if not rows and not completes:
            return
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                if rows:
                    con.executemany(
                        "INSERT INTO fanout_cursors (sub_id, shard, "
                        "cursor, last_sent) VALUES (?, ?, ?, ?) "
                        "ON CONFLICT (sub_id, shard) DO UPDATE SET "
                        "cursor = excluded.cursor, last_sent = "
                        "COALESCE(excluded.last_sent, fanout_cursors."
                        "last_sent) WHERE excluded.cursor > "
                        "fanout_cursors.cursor", rows)
                if healed:
                    now = _now_iso()
                    con.executemany(
                        "UPDATE subscribers SET failures = 0, "
                        "parked_until = NULL, park_delay = NULL, "
                        "last_ok = ? WHERE id = ?",
                        [(now, s) for s in healed])
                if completes:
                    con.executemany(
                        "DELETE FROM fanout_cursors WHERE sub_id = ? "
                        "AND shard = ?",
                        [(int(s), shard) for s in completes])
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise

    def rollup_cursor(self) -> int:
        """The global rollup watermark: every quadkey-stamped alert at
        or below it has been covered by an enqueued fanout job."""
        with self._lock:
            row = self._con.execute(
                "SELECT value FROM meta WHERE key = "
                "'fanout_rollup_cursor'").fetchone()
        return int(row[0]) if row else 0

    def set_rollup_cursor(self, cursor: int) -> None:
        with self._lock:
            self._con.execute(
                "INSERT INTO meta (key, value) VALUES "
                "('fanout_rollup_cursor', ?) ON CONFLICT (key) DO "
                "UPDATE SET value = excluded.value WHERE "
                "CAST(excluded.value AS INTEGER) > "
                "CAST(meta.value AS INTEGER)", (int(cursor),))

    def advance(self, sub_id: int, cursor: int) -> None:
        """Move a subscriber's durable delivery cursor FORWARD (a crashed
        deliverer restarting with stale state cannot rewind a successor's
        progress — the fencing discipline, cursor-shaped)."""
        with self._lock:
            self._con.execute(
                "UPDATE subscribers SET cursor = ?, last_ok = ?, "
                "failures = 0 WHERE id = ? AND cursor < ?",
                (int(cursor), _now_iso(), int(sub_id), int(cursor)))

    def record_failure(self, sub_id: int, *,
                       park_after: int | None = None,
                       base: float = 5.0, cap: float = 300.0,
                       rng=None, clock=time.time) -> float | None:
        """Count a delivery failure; with ``park_after`` set, park the
        subscriber under decorrelated backoff once it hits that many
        CONSECUTIVE failures (``retry.decorrelated_delay`` — the
        drivers' jitter, subscriber-shaped), so one dead endpoint never
        stalls its shard.  Returns the park delay when parking happened,
        else None.  Any delivery success (``advance`` /
        ``advance_fanout(sent_at=...)``) heals: failures reset, park
        cleared."""
        from firebird_tpu_torch import retry as retrylib

        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                con.execute(
                    "UPDATE subscribers SET failures = failures + 1 "
                    "WHERE id = ?", (int(sub_id),))
                delay = None
                if park_after is not None:
                    row = con.execute(
                        "SELECT failures, park_delay FROM subscribers "
                        "WHERE id = ?", (int(sub_id),)).fetchone()
                    if row and int(row[0]) >= int(park_after):
                        delay = retrylib.decorrelated_delay(
                            float(row[1] or 0.0), base=base, cap=cap,
                            rng=rng)
                        con.execute(
                            "UPDATE subscribers SET parked_until = ?, "
                            "park_delay = ? WHERE id = ?",
                            (clock() + delay, delay, int(sub_id)))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        return delay

    def unsubscribe(self, sub_id: int) -> bool:
        with self._lock:
            cur = self._con.execute(
                "DELETE FROM subscribers WHERE id = ?", (int(sub_id),))
        return cur.rowcount > 0

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

"""The fleet work queue's enqueue side: the jobs table, enqueue and the
at-most-one-open-job-per-chip rule.

The port's own copy of what repair scheduling needs from the JAX
package's ``fleet/queue.py``, with the same sqlite schema (the jobs,
deps, meta and workers tables and their seeds), so a JAX fleet worker can
lease a job this package enqueued.  Claims, leases, heartbeats, fencing,
the worker registry and the supervisor's state wait for the port's fleet
worker.
"""

from __future__ import annotations

import datetime
import json
import os
import sqlite3
import threading
import time

QUEUE_SCHEMA = "firebird-fleet-queue/1"

PENDING, LEASED, DONE, DEAD = "pending", "leased", "done", "dead"
STATES = (PENDING, LEASED, DONE, DEAD)

JOB_TYPES = ("detect", "stream", "classify", "product", "repair",
             "pyramid", "fanout")


def _now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


def queue_path(cfg) -> str:
    """The fleet queue database for a config: ``cfg.fleet_db`` when set,
    else ``fleet.db`` next to the results store (the quarantine.json
    placement rule).  The memory store backend has no 'next to' and no
    cross-process story: it requires an explicit FIREBIRD_FLEET_DB."""
    if cfg.fleet_db:
        return cfg.fleet_db
    from firebird_tpu_torch.driver import quarantine as qlib

    d = qlib._artifact_dir(cfg)
    if d is None:
        raise ValueError(
            "the fleet queue needs a file-backed location: set "
            "FIREBIRD_FLEET_DB explicitly when FIREBIRD_STORE_BACKEND="
            "memory")
    return os.path.join(d, "fleet.db")


class FleetQueue:
    """The shared job queue (its enqueue side).  Thread-safe within a
    process (one guarded connection) and process-safe across processes
    (every mutation is one sqlite transaction over the shared WAL
    database)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # isolation_level=None: autocommit, with explicit BEGIN IMMEDIATE
        # around every read-modify-write so enqueues are atomic across
        # processes; all uses serialize under _lock.
        self._con = sqlite3.connect(  # guarded-by: _lock
            path, timeout=60, isolation_level=None,
            check_same_thread=False)
        self._create()

    # -- schema ------------------------------------------------------------

    def _create(self) -> None:
        with self._lock:
            con = self._con
            con.execute("PRAGMA journal_mode=WAL")
            con.execute("PRAGMA synchronous=NORMAL")
            con.execute("BEGIN IMMEDIATE")
            try:
                con.execute(
                    "CREATE TABLE IF NOT EXISTS jobs ("
                    " id INTEGER PRIMARY KEY AUTOINCREMENT,"
                    " job_type TEXT NOT NULL,"
                    " payload TEXT NOT NULL,"
                    " state TEXT NOT NULL DEFAULT 'pending',"
                    " attempts INTEGER NOT NULL DEFAULT 0,"
                    " max_attempts INTEGER NOT NULL,"
                    " fence INTEGER,"
                    " owner TEXT,"
                    " claimed REAL,"
                    " lease_expires REAL,"
                    " history TEXT NOT NULL DEFAULT '[]',"
                    " created REAL, updated REAL)")
                con.execute(
                    "CREATE TABLE IF NOT EXISTS deps ("
                    " job_id INTEGER NOT NULL,"
                    " needs INTEGER NOT NULL,"
                    " PRIMARY KEY (job_id, needs))")
                con.execute(
                    "CREATE TABLE IF NOT EXISTS meta ("
                    " key TEXT PRIMARY KEY, value TEXT)")
                # Worker registry: every `fleet work` process registers
                # itself here and beats alongside its lease heartbeats —
                # the table the supervisor adopts orphans from after its
                # own death, and the per-worker rows behind
                # `firebird fleet status`.  Clean exits DELETE the row;
                # a row whose pid is gone is an abnormal exit (the
                # supervisor prunes it and feeds the crash-loop circuit).
                con.execute(
                    "CREATE TABLE IF NOT EXISTS workers ("
                    " worker_id TEXT PRIMARY KEY,"
                    " pid INTEGER NOT NULL,"
                    " kind TEXT NOT NULL DEFAULT 'batch',"
                    " host TEXT,"
                    " started REAL, beat REAL,"
                    " acked INTEGER NOT NULL DEFAULT 0)")
                con.execute(
                    "INSERT OR IGNORE INTO meta (key, value) VALUES "
                    "('schema', ?), ('fence_seq', '0'), "
                    "('fence_rejects', '0')", (QUEUE_SCHEMA,))
                con.execute(
                    "CREATE INDEX IF NOT EXISTS idx_jobs_state "
                    "ON jobs (state, id)")
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise

    def counts(self) -> dict:
        """Job counts by state (all states present, zeros included)."""
        with self._lock:
            rows = self._con.execute(
                "SELECT state, COUNT(*) FROM jobs GROUP BY state"
            ).fetchall()
        out = {s: 0 for s in STATES}
        out.update({s: int(n) for s, n in rows})
        return out

    def enqueue_unique_chip(self, job_type: str, payload: dict, *,
                            depends_on=(),
                            max_attempts: int = 3) -> int | None:
        """Enqueue a chip-keyed job ONLY if no open (pending/leased) job
        of ``job_type`` already names the same (cx, cy) — the check and
        the insert in ONE transaction, so two schedulers racing (a
        zombie stream worker and its successor both reaching end-of-run
        repair scheduling) cannot both slip past a read-then-insert
        window.  ``depends_on`` lists job ids that must be ``done``
        before this one becomes claimable.  Returns the new job id, or
        None when an open job already covers the chip."""
        if job_type not in JOB_TYPES:
            raise ValueError(
                f"job_type must be one of {JOB_TYPES}, got {job_type!r}")
        if max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {max_attempts}")
        chip = (int(payload["cx"]), int(payload["cy"]))
        deps = [int(d) for d in depends_on]
        now = time.time()
        jid = None
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                known = {r[0] for r in con.execute(
                    "SELECT id FROM jobs WHERE id IN (%s)"
                    % ",".join("?" * len(deps)), deps)} if deps else set()
                missing = [d for d in deps if d not in known]
                if missing:
                    raise ValueError(
                        f"depends_on names unknown job ids {missing}")
                rows = con.execute(
                    "SELECT payload FROM jobs WHERE job_type = ? AND "
                    "state IN ('pending', 'leased')",
                    (job_type,)).fetchall()
                taken = any(
                    (int(p.get("cx", 1 << 62)), int(p.get("cy", 1 << 62)))
                    == chip for (p,) in
                    ((json.loads(r[0]),) for r in rows))
                if not taken:
                    cur = con.execute(
                        "INSERT INTO jobs (job_type, payload, state, "
                        "max_attempts, history, created, updated) VALUES "
                        "(?, ?, 'pending', ?, ?, ?, ?)",
                        (job_type, json.dumps(payload), int(max_attempts),
                         json.dumps([{"event": "enqueued",
                                      "at": _now_iso()}]), now, now))
                    jid = int(cur.lastrowid)
                    for d in deps:
                        con.execute(
                            "INSERT OR IGNORE INTO deps (job_id, needs) "
                            "VALUES (?, ?)", (jid, d))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        return jid

    def open_jobs(self, job_type: str) -> dict:
        """{(cx, cy): job_id} of OPEN (pending or leased) jobs of
        ``job_type`` whose payload names a chip — the idempotence index
        behind repair scheduling: a chip with an open repair job is not
        re-enqueued, while a done/dead one may be (a re-broken pixel is
        a new debt, not a duplicate)."""
        with self._lock:
            rows = self._con.execute(
                "SELECT id, payload FROM jobs WHERE job_type = ? AND "
                "state IN ('pending', 'leased')", (job_type,)).fetchall()
        out: dict = {}
        for jid, payload in rows:
            p = json.loads(payload)
            if "cx" in p and "cy" in p:
                out[(int(p["cx"]), int(p["cy"]))] = int(jid)
        return out

    def job(self, job_id: int) -> dict | None:
        """One job's full record (payload + history), for inspection."""
        with self._lock:
            row = self._con.execute(
                "SELECT id, job_type, payload, state, attempts, "
                "max_attempts, fence, owner, claimed, lease_expires, "
                "history FROM jobs WHERE id = ?", (int(job_id),)).fetchone()
            deps = [r[0] for r in self._con.execute(
                "SELECT needs FROM deps WHERE job_id = ? ORDER BY needs",
                (int(job_id),))]
        if row is None:
            return None
        (jid, jtype, payload, state, attempts, max_attempts, fence, owner,
         claimed, expires, history) = row
        return {"id": int(jid), "job_type": jtype,
                "payload": json.loads(payload), "state": state,
                "attempts": int(attempts),
                "max_attempts": int(max_attempts), "fence": fence,
                "owner": owner, "claimed": claimed,
                "lease_expires": expires, "depends_on": deps,
                "history": json.loads(history)}

    def close(self) -> None:
        with self._lock:
            self._con.close()


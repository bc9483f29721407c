"""Crash-tolerant fleet work queue: claim -> lease -> heartbeat -> ack.

The port's own copy of the JAX package's ``fleet/queue.py``, whole, with
its sqlite schema: a job either package enqueues is claimed,
heartbeated, acked or failed by the other.  It is sqlite-backed (one
``fleet.db`` file next to the results store — no external services, same
deployment weight as the store itself) and treats worker failure as the
normal case:

- **Leases, not locks.**  ``claim`` atomically leases the oldest ready
  job (one ``BEGIN IMMEDIATE`` transaction); the worker must
  ``heartbeat`` to keep the lease alive.  When heartbeats stop — the
  worker died, was SIGKILLed, or is partitioned from the queue — the
  lease expires and the next ``claim`` re-delivers the job with its
  attempt history intact.  Re-delivery is safe because every job's
  output path is keyed-upsert idempotent.
- **Fencing tokens.**  Every claim draws a queue-global monotonic token
  stamped into the lease.  ``ack``/``fail``/``heartbeat`` and — through
  :class:`FencedStore` — every results-store write validate the token
  against the CURRENT lease, so a zombie worker resuming after a GC
  pause or network partition cannot clobber (or double-ack past) a
  successor that re-claimed its job: stale operations raise
  :class:`StaleFence` and are counted (``fleet_fence_rejected``,
  persisted in the queue's meta table so the tally survives worker
  restarts and registry resets).
- **Cross-stage dependencies.**  A job only becomes claimable when
  every job it ``depends_on`` is ``done`` — a tile's classify job
  unblocks the moment its detection chunks ack (fleet/plan.py builds
  those edges).
- **Dead letters.**  A job that exhausts ``max_attempts`` (failed OR
  repeatedly lease-expired — a crash-looping payload must not wedge the
  fleet) moves to ``dead``: the queue-level analog of quarantine.json,
  inspectable via ``firebird fleet status`` and revivable via
  ``firebird fleet requeue``.

The clock is injectable, so lease expiry, zombie fencing, and
dead-lettering are covered by deterministic unit tests with no sleeps
(tests/test_torch_fleet.py); across real processes the shared wall clock
of one host/fleet does the same job.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import sqlite3
import threading
import time

from firebird_tpu_torch import retry as retrylib
from firebird_tpu_torch.obs import metrics as obs_metrics

QUEUE_SCHEMA = "firebird-fleet-queue/1"

PENDING, LEASED, DONE, DEAD = "pending", "leased", "done", "dead"
STATES = (PENDING, LEASED, DONE, DEAD)

JOB_TYPES = ("detect", "stream", "classify", "product", "repair",
             "pyramid", "fanout")

# Exception text kept in job history is for diagnosis, not a log archive
# (the quarantine.py discipline).
_MSG_LIMIT = 500


class LeaseLost(RuntimeError):
    """A heartbeat found its lease gone: expired and re-claimed (or
    acked/dead-lettered) by someone else.  The worker must abandon the
    job — its fencing token is stale and every further write rejects."""


class StaleFence(retrylib.NonRetryable):
    """An operation carried a fencing token that is no longer the job's
    current lease.  NonRetryable on purpose: retrying cannot help (the
    token only ever goes forward), and the rejection says nothing about
    the health of the store behind the retry policy's breaker."""


def _now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


@dataclasses.dataclass(frozen=True)
class Lease:
    """One claimed job: the payload to execute plus the fencing token
    every output write and queue operation must present."""

    job_id: int
    job_type: str
    payload: dict
    fence: int
    owner: str
    attempts: int
    max_attempts: int
    claimed_at: float
    lease_sec: float


def queue_path(cfg) -> str:
    """The fleet queue database for a config: ``cfg.fleet_db`` when set,
    else ``fleet.db`` next to the results store (the quarantine.json
    placement rule).  The memory store backend has no 'next to' and no
    cross-process story — it requires an explicit FIREBIRD_FLEET_DB."""
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
    """The shared job queue.  Thread-safe within a process (one guarded
    connection) and process-safe across workers (every mutation is one
    sqlite transaction over the shared WAL database)."""

    def __init__(self, path: str, *, lease_sec: float = 30.0,
                 clock=time.time):
        if lease_sec <= 0:
            raise ValueError(f"lease_sec must be > 0, got {lease_sec}")
        self.path = path
        self.lease_sec = float(lease_sec)
        self._clock = clock
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # isolation_level=None: autocommit, with explicit BEGIN IMMEDIATE
        # around every read-modify-write so claims/acks are atomic across
        # processes.  check_same_thread=False because the worker's
        # heartbeat thread and the writer pool's fence checks share it —
        # all uses serialize under _lock.
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

    # -- enqueue -----------------------------------------------------------

    def enqueue(self, job_type: str, payload: dict, *,
                depends_on=(), max_attempts: int = 3) -> int:
        """Add a job; returns its id.  ``depends_on`` lists job ids that
        must be ``done`` before this one becomes claimable."""
        if job_type not in JOB_TYPES:
            raise ValueError(
                f"job_type must be one of {JOB_TYPES}, got {job_type!r}")
        if max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {max_attempts}")
        now = self._clock()
        deps = [int(d) for d in depends_on]
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
                cur = con.execute(
                    "INSERT INTO jobs (job_type, payload, state, "
                    "max_attempts, history, created, updated) VALUES "
                    "(?, ?, 'pending', ?, ?, ?, ?)",
                    (job_type, json.dumps(payload), int(max_attempts),
                     json.dumps([{"event": "enqueued", "at": _now_iso()}]),
                     now, now))
                jid = cur.lastrowid
                for d in deps:
                    con.execute(
                        "INSERT OR IGNORE INTO deps (job_id, needs) "
                        "VALUES (?, ?)", (jid, d))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        return int(jid)

    # -- claim / heartbeat / ack / fail ------------------------------------

    _READY_SQL = (
        "SELECT id, job_type, payload, state, attempts, max_attempts, "
        "owner, history FROM jobs j WHERE "
        "(state = 'pending' OR (state = 'leased' AND lease_expires < ?)) "
        "AND NOT EXISTS (SELECT 1 FROM deps d JOIN jobs b "
        "ON b.id = d.needs WHERE d.job_id = j.id AND b.state != 'done') "
        "ORDER BY id LIMIT 1")

    def claim(self, owner: str) -> Lease | None:
        """Atomically lease the oldest ready job for ``owner``; None when
        nothing is claimable (empty, all leased, or all blocked).

        An expired lease found here is the crash/partition recovery
        path: the expiry is appended to the job's history and the job is
        re-delivered under a FRESH fencing token (``fleet_jobs_requeued``)
        — unless its attempt budget is already spent, in which case it
        dead-letters instead of crash-looping the fleet."""
        now = self._clock()
        dead: list[int] = []
        lease = None
        requeued = False
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                while True:
                    row = con.execute(self._READY_SQL, (now,)).fetchone()
                    if row is None:
                        break
                    (jid, jtype, payload, state, attempts, max_attempts,
                     prev_owner, history) = row
                    hist = json.loads(history)
                    if state == LEASED:
                        # The previous holder went dark mid-lease.
                        hist.append({"event": "lease_expired",
                                     "owner": prev_owner, "at": _now_iso(),
                                     "attempt": attempts})
                        if attempts >= max_attempts:
                            hist.append({"event": "dead_lettered",
                                         "at": _now_iso(),
                                         "error": "LeaseExpired",
                                         "message": "attempt budget spent "
                                         "on expired leases"})
                            con.execute(
                                "UPDATE jobs SET state = 'dead', "
                                "owner = NULL, lease_expires = NULL, "
                                "history = ?, updated = ? WHERE id = ?",
                                (json.dumps(hist), now, jid))
                            dead.append(jid)
                            continue
                        # Expired-but-rescuable: this claim re-delivers
                        # it (the dead branch above is an expiry that was
                        # NEVER requeued — only the re-delivery counts).
                        requeued = True
                    fence = int(con.execute(
                        "SELECT value FROM meta WHERE key = 'fence_seq'"
                    ).fetchone()[0]) + 1
                    con.execute(
                        "UPDATE meta SET value = ? WHERE key = 'fence_seq'",
                        (str(fence),))
                    hist.append({"event": "claimed", "owner": owner,
                                 "fence": fence, "at": _now_iso(),
                                 "attempt": attempts + 1})
                    con.execute(
                        "UPDATE jobs SET state = 'leased', owner = ?, "
                        "fence = ?, attempts = attempts + 1, claimed = ?, "
                        "lease_expires = ?, history = ?, updated = ? "
                        "WHERE id = ?",
                        (owner, fence, now, now + self.lease_sec,
                         json.dumps(hist), now, jid))
                    lease = Lease(job_id=int(jid), job_type=jtype,
                                  payload=json.loads(payload), fence=fence,
                                  owner=owner, attempts=int(attempts) + 1,
                                  max_attempts=int(max_attempts),
                                  claimed_at=now, lease_sec=self.lease_sec)
                    break
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        if requeued:
            obs_metrics.counter(
                "fleet_jobs_requeued",
                help="fleet jobs returned to the queue (lease expiry or "
                     "retryable failure)").inc()
        for jid in dead:
            obs_metrics.counter("fleet_jobs_dead").inc()
        if lease is not None:
            obs_metrics.counter("fleet_jobs_claimed").inc()
        return lease

    def heartbeat(self, lease: Lease) -> None:
        """Extend the lease; raises :class:`LeaseLost` when it is no
        longer held under this fencing token (expired + re-claimed, or
        already resolved)."""
        now = self._clock()
        with self._lock:
            cur = self._con.execute(
                "UPDATE jobs SET lease_expires = ?, updated = ? "
                "WHERE id = ? AND fence = ? AND state = 'leased' "
                "AND lease_expires >= ?",
                (now + self.lease_sec, now, lease.job_id, lease.fence, now))
        if cur.rowcount != 1:
            self.record_fence_reject(lease, op="heartbeat")
            raise LeaseLost(
                f"job {lease.job_id} lease (fence {lease.fence}) is gone")
        obs_metrics.gauge(
            "fleet_lease_age_seconds",
            help="age of this worker's current fleet lease").set(
            max(now - lease.claimed_at, 0.0))

    def ack(self, lease: Lease) -> None:
        """Mark the job done — only under a live lease with the current
        fencing token.  A zombie acking after its lease lapsed raises
        :class:`StaleFence`: the job either already completed under a
        successor or will be re-delivered, and a half-written zombie
        output must not be recorded as success."""
        now = self._clock()
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                row = con.execute(
                    "SELECT history FROM jobs WHERE id = ? AND fence = ? "
                    "AND state = 'leased' AND lease_expires >= ?",
                    (lease.job_id, lease.fence, now)).fetchone()
                if row is not None:
                    hist = json.loads(row[0])
                    hist.append({"event": "acked", "owner": lease.owner,
                                 "fence": lease.fence, "at": _now_iso()})
                    con.execute(
                        "UPDATE jobs SET state = 'done', owner = NULL, "
                        "lease_expires = NULL, history = ?, updated = ? "
                        "WHERE id = ?",
                        (json.dumps(hist), now, lease.job_id))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        if row is None:
            self.record_fence_reject(lease, op="ack")
            raise StaleFence(
                f"ack of job {lease.job_id} rejected: fence {lease.fence} "
                "is stale (lease expired or re-claimed)")
        obs_metrics.counter(
            "fleet_jobs_acked", help="fleet jobs completed and acked").inc()

    def fail(self, lease: Lease, error: BaseException) -> str:
        """Record a failed attempt under a live lease: the job returns to
        ``pending`` with its error appended to the attempt history, or
        dead-letters once ``max_attempts`` is spent.  Returns the new
        state.  Raises :class:`StaleFence` under a stale token — the
        failure belongs to a lease that no longer exists."""
        now = self._clock()
        new_state = None
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                row = con.execute(
                    "SELECT attempts, max_attempts, history FROM jobs "
                    "WHERE id = ? AND fence = ? AND state = 'leased' "
                    "AND lease_expires >= ?",
                    (lease.job_id, lease.fence, now)).fetchone()
                if row is not None:
                    attempts, max_attempts, history = row
                    hist = json.loads(history)
                    hist.append({"event": "failed", "owner": lease.owner,
                                 "at": _now_iso(), "attempt": attempts,
                                 "error": type(error).__name__,
                                 "message": str(error)[:_MSG_LIMIT]})
                    new_state = DEAD if attempts >= max_attempts \
                        else PENDING
                    if new_state == DEAD:
                        hist.append({"event": "dead_lettered",
                                     "at": _now_iso(),
                                     "error": type(error).__name__,
                                     "message":
                                         str(error)[:_MSG_LIMIT]})
                    con.execute(
                        "UPDATE jobs SET state = ?, owner = NULL, "
                        "lease_expires = NULL, history = ?, updated = ? "
                        "WHERE id = ?",
                        (new_state, json.dumps(hist), now, lease.job_id))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        if new_state is None:
            self.record_fence_reject(lease, op="fail")
            raise StaleFence(
                f"failure report for job {lease.job_id} rejected: fence "
                f"{lease.fence} is stale")
        obs_metrics.counter(
            "fleet_jobs_requeued" if new_state == PENDING
            else "fleet_jobs_dead",
            help="fleet jobs dead-lettered after their attempt budget"
            if new_state == DEAD else None).inc()
        return new_state

    # -- fencing -----------------------------------------------------------

    def fence_valid(self, job_id: int, fence: int) -> bool:
        """True while ``fence`` is the job's CURRENT live lease: state
        ``leased``, same token, lease not expired.  The write-side gate
        :class:`FencedStore` consults before every store write."""
        now = self._clock()
        with self._lock:
            row = self._con.execute(
                "SELECT 1 FROM jobs WHERE id = ? AND fence = ? AND "
                "state = 'leased' AND lease_expires >= ?",
                (job_id, fence, now)).fetchone()
        return row is not None

    def record_fence_reject(self, lease: Lease | None = None, *,
                            op: str = "write") -> None:
        """Count one stale-fence rejection — in the obs registry for
        live scraping AND in the queue's meta table, so the tally
        survives worker deaths and per-run registry resets (the chaos
        smoke asserts on the durable count)."""
        with self._lock:
            con = self._con
            con.execute(
                "UPDATE meta SET value = CAST(value AS INTEGER) + 1 "
                "WHERE key = 'fence_rejects'")
            # Per-op breakdown (write/ack/fail/heartbeat): the chaos
            # smoke asserts specifically that stale WRITES were caught.
            con.execute(
                "INSERT INTO meta (key, value) VALUES (?, '1') "
                "ON CONFLICT(key) DO UPDATE SET "
                "value = CAST(value AS INTEGER) + 1",
                (f"fence_rejects_{op}",))
        obs_metrics.counter(
            "fleet_fence_rejected",
            help="operations rejected for a stale fencing token "
                 "(zombie worker writes/acks)").inc()
        from firebird_tpu_torch.obs import flightrec
        flightrec.mark("fleet_fence_rejected", op=op,
                       job=lease.job_id if lease else None,
                       fence=lease.fence if lease else None)

    def fence_rejects(self, op: str | None = None) -> int:
        """Durable stale-fence rejection count — total, or one op's
        (``write``/``ack``/``fail``/``heartbeat``) when ``op`` given."""
        key = "fence_rejects" if op is None else f"fence_rejects_{op}"
        with self._lock:
            row = self._con.execute(
                "SELECT value FROM meta WHERE key = ?", (key,)).fetchone()
        return int(row[0]) if row is not None else 0

    # -- operator surface --------------------------------------------------

    def requeue(self, job_id: int | None = None) -> int:
        """Return dead-lettered jobs to ``pending`` with a fresh attempt
        budget (one job, or every dead job when ``job_id`` is None).
        Returns the number revived."""
        now = self._clock()
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                where = "state = 'dead'" + \
                    ("" if job_id is None else " AND id = ?")
                args = () if job_id is None else (int(job_id),)
                rows = con.execute(
                    f"SELECT id, history FROM jobs WHERE {where}",
                    args).fetchall()
                for jid, history in rows:
                    hist = json.loads(history)
                    hist.append({"event": "requeued", "at": _now_iso()})
                    con.execute(
                        "UPDATE jobs SET state = 'pending', attempts = 0, "
                        "owner = NULL, lease_expires = NULL, history = ?, "
                        "updated = ? WHERE id = ?",
                        (json.dumps(hist), now, jid))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        return len(rows)

    def counts(self) -> dict:
        """Job counts by state (all states present, zeros included)."""
        with self._lock:
            rows = self._con.execute(
                "SELECT state, COUNT(*) FROM jobs GROUP BY state"
            ).fetchall()
        out = {s: 0 for s in STATES}
        out.update({s: int(n) for s, n in rows})
        return out

    def drained(self, *, batch_only: bool = False) -> bool:
        """True when no job is pending or leased (everything is either
        done or dead-lettered — the fleet has nothing left to run).
        ``batch_only`` ignores ``stream`` jobs: the supervisor's
        drain-exit gate — stream lifecycle belongs to the standing
        streaming fleet, and a watcher continuously enqueuing stream
        jobs must not pin ``supervise --until-drained`` open forever
        after the batch backlog is gone."""
        if batch_only:
            with self._lock:
                n = self._con.execute(
                    "SELECT COUNT(*) FROM jobs WHERE state IN (?, ?) "
                    "AND job_type != 'stream'",
                    (PENDING, LEASED)).fetchone()[0]
            return int(n) == 0
        c = self.counts()
        return c[PENDING] == 0 and c[LEASED] == 0

    def wedged(self) -> bool:
        """True when polling can never make progress: pending jobs
        remain, nothing is leased, and nothing is claimable — which in a
        dependency DAG means every pending job is blocked behind a DEAD
        job.  Evaluated in ONE transaction so the verdict cannot race a
        concurrent worker's ack the way a claim()-then-counts() pair
        would (an ack landing before this snapshot makes the job
        claimable and the verdict 'not wedged')."""
        now = self._clock()
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                ready = con.execute(self._READY_SQL, (now,)).fetchone()
                rows = dict(con.execute(
                    "SELECT state, COUNT(*) FROM jobs GROUP BY state"))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        return (ready is None and int(rows.get(LEASED, 0)) == 0
                and int(rows.get(PENDING, 0)) > 0)

    def enqueue_unique_chip(self, job_type: str, payload: dict, *,
                            depends_on=(),
                            max_attempts: int = 3) -> int | None:
        """Enqueue a chip-keyed job ONLY if no open (pending/leased) job
        of ``job_type`` already names the same (cx, cy) — the check and
        the insert in ONE transaction, so two schedulers racing (a
        zombie stream worker and its successor both reaching end-of-run
        repair scheduling) cannot both slip past a read-then-insert
        window.  ``depends_on`` works as in :meth:`enqueue` — the
        acquisition watcher deps a chip's first stream job behind its
        bootstrap detect job this way.  Returns the new job id, or None
        when an open job already covers the chip."""
        if job_type not in JOB_TYPES:
            raise ValueError(
                f"job_type must be one of {JOB_TYPES}, got {job_type!r}")
        if max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {max_attempts}")
        chip = (int(payload["cx"]), int(payload["cy"]))
        deps = [int(d) for d in depends_on]
        now = self._clock()
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

    def open_payloads(self, job_type: str) -> list[tuple[int, dict]]:
        """``[(job_id, payload)]`` of OPEN (pending or leased) jobs of
        ``job_type``, id order — the non-chip-keyed analog of
        :meth:`open_jobs` (fanout jobs are keyed by quadkey shard, not
        chip; plan.enqueue_fanout consults this to skip shards whose
        open job already covers the rollup watermark)."""
        with self._lock:
            rows = self._con.execute(
                "SELECT id, payload FROM jobs WHERE job_type = ? AND "
                "state IN ('pending', 'leased') ORDER BY id",
                (job_type,)).fetchall()
        return [(int(jid), json.loads(payload)) for jid, payload in rows]

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

    def status(self) -> dict:
        """The fleet view: queue depth by job type and state, active
        leases with age/holder, dead letters with error classes, blocked
        jobs, and the durable stale-fence rejection count — rendered by
        ``firebird fleet status`` and the ``/progress`` fleet block."""
        now = self._clock()
        with self._lock:
            con = self._con
            by = con.execute(
                "SELECT job_type, state, COUNT(*) FROM jobs "
                "GROUP BY job_type, state").fetchall()
            leases = con.execute(
                "SELECT id, job_type, owner, claimed, lease_expires, "
                "attempts FROM jobs WHERE state = 'leased' "
                "ORDER BY id").fetchall()
            dead = con.execute(
                "SELECT id, job_type, attempts, history FROM jobs "
                "WHERE state = 'dead' ORDER BY id").fetchall()
            blocked = con.execute(
                "SELECT COUNT(*) FROM jobs j WHERE state = 'pending' AND "
                "EXISTS (SELECT 1 FROM deps d JOIN jobs b "
                "ON b.id = d.needs WHERE d.job_id = j.id "
                "AND b.state != 'done')").fetchone()[0]
            rejects = int(con.execute(
                "SELECT value FROM meta WHERE key = 'fence_rejects'"
            ).fetchone()[0])
            reject_ops = {
                k[len("fence_rejects_"):]: int(v) for k, v in con.execute(
                    "SELECT key, value FROM meta WHERE key LIKE "
                    "'fence_rejects_%'")}
        by_type: dict[str, dict] = {}
        totals = {s: 0 for s in STATES}
        for jtype, state, n in by:
            by_type.setdefault(jtype, {s: 0 for s in STATES})[state] = int(n)
            totals[state] += int(n)
        dead_rows = []
        dead_errors: dict[str, int] = {}
        for jid, jtype, attempts, history in dead:
            hist = json.loads(history)
            err = next((h.get("error", "unknown")
                        for h in reversed(hist)
                        if h.get("event") == "dead_lettered"), "unknown")
            dead_errors[err] = dead_errors.get(err, 0) + 1
            dead_rows.append({"job": int(jid), "type": jtype,
                              "attempts": int(attempts), "error": err})
        return {
            "path": self.path,
            "jobs": totals,
            "by_type": by_type,
            "blocked": int(blocked),
            # Elastic-fleet view (docs/ROBUSTNESS.md "Elastic
            # operation"): the registered worker rows and the
            # supervisor's last persisted heartbeat/decision.
            "workers": self.workers(),
            "supervisor": self.supervisor_state(),
            "leases": [{"job": int(j), "type": t, "owner": o,
                        "age_sec": round(max(now - (c or now), 0.0), 3),
                        "expires_in_sec": round((e or now) - now, 3),
                        "attempts": int(a)}
                       for j, t, o, c, e, a in leases],
            "dead": dead_rows,
            "dead_errors": dict(sorted(dead_errors.items())),
            "fence_rejects": rejects,
            "fence_rejects_by_op": dict(sorted(reject_ops.items())),
        }

    # -- worker registry (the supervisor's adoption/heartbeat table) -------

    def worker_register(self, worker_id: str, pid: int, *,
                        kind: str = "batch",
                        host: str | None = None) -> None:
        """Register a live worker process.  Idempotent upsert: a worker
        re-registering (ops re-arm after a stream job) refreshes its
        beat without losing its ack tally.  ``started`` refreshes too —
        worker_id is host:pid, so after a host reboot a recycled pid
        collides with a crashed worker's durable row, and a stale stamp
        would make the supervisor's recycled-pid guard prune the LIVE
        worker (its process 'started after the row was written')."""
        now = self._clock()
        with self._lock:
            self._con.execute(
                "INSERT INTO workers (worker_id, pid, kind, host, "
                "started, beat) VALUES (?, ?, ?, ?, ?, ?) "
                "ON CONFLICT(worker_id) DO UPDATE SET pid = excluded.pid, "
                "kind = excluded.kind, host = excluded.host, "
                "started = excluded.started, beat = excluded.beat",
                (worker_id, int(pid), kind, host, now, now))

    def worker_beat(self, worker_id: str, *,
                    acked: int | None = None) -> bool:
        """Refresh a worker's liveness beat (and its ack tally when
        given).  Returns False when no row matched — the worker may
        have been pruned by a supervisor that misread its pid as dead;
        the caller (FleetWorker._worker_beat) re-registers on False so
        a pruned-but-live worker does not stay invisible (and
        double-spawned over) forever."""
        now = self._clock()
        with self._lock:
            if acked is None:
                cur = self._con.execute(
                    "UPDATE workers SET beat = ? WHERE worker_id = ?",
                    (now, worker_id))
            else:
                cur = self._con.execute(
                    "UPDATE workers SET beat = ?, acked = ? "
                    "WHERE worker_id = ?", (now, int(acked), worker_id))
        return cur.rowcount > 0

    def worker_deregister(self, worker_id: str) -> None:
        """Clean-exit removal.  A worker that dies without reaching this
        leaves its row behind — the supervisor reads that as an
        abnormal exit (crash-loop circuit food)."""
        with self._lock:
            self._con.execute("DELETE FROM workers WHERE worker_id = ?",
                              (worker_id,))

    def workers(self, kind: str | None = None) -> list[dict]:
        """Registered worker rows, oldest first, with beat age and each
        worker's current lease (if any) joined in — the per-worker view
        `firebird fleet status` renders."""
        now = self._clock()
        with self._lock:
            where = "" if kind is None else " WHERE kind = ?"
            args = () if kind is None else (kind,)
            rows = self._con.execute(
                "SELECT worker_id, pid, kind, host, started, beat, acked "
                f"FROM workers{where} ORDER BY started, worker_id",
                args).fetchall()
            leases = {o: (int(j), t, c) for j, t, o, c in self._con.execute(
                "SELECT id, job_type, owner, claimed FROM jobs "
                "WHERE state = 'leased'")}
        out = []
        for wid, pid, k, host, started, beat, acked in rows:
            lease = leases.get(wid)
            out.append({
                "worker_id": wid, "pid": int(pid), "kind": k, "host": host,
                "started": started,
                "up_sec": round(max(now - (started or now), 0.0), 3),
                "beat_age_sec": round(max(now - (beat or now), 0.0), 3),
                "acked": int(acked),
                "lease": None if lease is None else {
                    "job": lease[0], "type": lease[1],
                    "age_sec": round(max(now - (lease[2] or now), 0.0), 3)},
            })
        return out

    def supervisor_heartbeat(self, state: dict) -> None:
        """Persist the supervisor's liveness + last decision into the
        queue's meta table (key ``supervisor``), so `firebird status`,
        `fleet status`, and /progress can show the control plane from
        the one shared file — and so a RESTARTED supervisor can tell it
        is succeeding a dead one rather than racing a live one."""
        doc = dict(state)
        doc["beat"] = self._clock()
        with self._lock:
            self._con.execute(
                "INSERT INTO meta (key, value) VALUES ('supervisor', ?) "
                "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
                (json.dumps(doc),))

    def supervisor_state(self) -> dict | None:
        """The last persisted supervisor heartbeat (with ``beat_age_sec``
        computed against the queue clock), or None when no supervisor
        ever ran against this queue."""
        with self._lock:
            row = self._con.execute(
                "SELECT value FROM meta WHERE key = 'supervisor'"
            ).fetchone()
        if row is None:
            return None
        doc = json.loads(row[0])
        beat = doc.get("beat")
        if beat is not None:
            doc["beat_age_sec"] = round(max(self._clock() - beat, 0.0), 3)
        return doc

    # -- scale snapshot (the policy's one atomic input) --------------------

    def scale_snapshot(self, *, window_sec: float = 60.0):
        """One atomic :class:`~firebird_tpu_torch.fleet.policy.QueueSnapshot`
        of queue pressure: depth by type/state, claimable count, oldest
        lease age, dead letters, and the trailing-window drain rate
        (acks/sec derived from done-job ``updated`` stamps) — all read
        in a single transaction so the policy never mixes readings from
        different moments.  ``stream`` jobs are split out: standing
        stream capacity is provisioned separately from batch drain
        capacity (fleet/policy.py)."""
        from firebird_tpu_torch.fleet.policy import QueueSnapshot

        now = self._clock()
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                by = con.execute(
                    "SELECT job_type, state, COUNT(*) FROM jobs "
                    "GROUP BY job_type, state").fetchall()
                claimable = con.execute(
                    "SELECT COUNT(*) FROM jobs j WHERE "
                    "(state = 'pending' OR (state = 'leased' AND "
                    "lease_expires < ?)) AND job_type != 'stream' "
                    "AND NOT EXISTS (SELECT 1 FROM deps d JOIN jobs b "
                    "ON b.id = d.needs WHERE d.job_id = j.id "
                    "AND b.state != 'done')", (now,)).fetchone()[0]
                blocked = con.execute(
                    "SELECT COUNT(*) FROM jobs j WHERE state = 'pending' "
                    "AND EXISTS (SELECT 1 FROM deps d JOIN jobs b "
                    "ON b.id = d.needs WHERE d.job_id = j.id "
                    "AND b.state != 'done')").fetchone()[0]
                # LIVE leases only: an expired lease is claimable work
                # (counted above) — counting it here too would double
                # it in the policy's backlog after a mass worker kill.
                live_leased = con.execute(
                    "SELECT COUNT(*) FROM jobs WHERE state = 'leased' "
                    "AND lease_expires >= ? AND job_type != 'stream'",
                    (now,)).fetchone()[0]
                oldest = con.execute(
                    "SELECT MIN(claimed) FROM jobs WHERE state = 'leased'"
                ).fetchone()[0]
                acked = con.execute(
                    "SELECT COUNT(*) FROM jobs WHERE state = 'done' "
                    "AND updated >= ?", (now - window_sec,)).fetchone()[0]
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        by_type: dict[str, dict] = {}
        for jtype, state, n in by:
            by_type.setdefault(jtype, {s: 0 for s in STATES})[state] = int(n)
        def total(state: str, *, stream: bool) -> int:
            return sum(int(c.get(state, 0)) for t, c in by_type.items()
                       if (t == "stream") == stream)
        return QueueSnapshot(
            at=now,
            by_type=by_type,
            claimable=int(claimable),
            pending=total(PENDING, stream=False),
            leased=int(live_leased),
            dead=total(DEAD, stream=False) + total(DEAD, stream=True),
            blocked=int(blocked),
            oldest_lease_age_sec=round(max(now - oldest, 0.0), 3)
            if oldest is not None else 0.0,
            drain_rate_per_sec=int(acked) / window_sec
            if window_sec > 0 else 0.0,
            drain_window_sec=float(window_sec),
            stream_open=total(PENDING, stream=True)
            + total(LEASED, stream=True),
        )

    def close(self) -> None:
        with self._lock:
            self._con.close()


class FencedStore:
    """Results-store proxy that stamps the lease's fencing token onto
    every write: the write only proceeds while the token is still the
    job's CURRENT live lease.  A zombie worker whose lease expired and
    was re-claimed gets :class:`StaleFence` (counted durably) instead of
    clobbering its successor's output.

    The validate-then-write window is one frame write wide; a write that
    races a reclaim inside it lands keyed-upsert rows byte-identical to
    what the successor (same deterministic job) writes — fencing plus
    idempotence together make re-delivery safe, not fencing alone.
    Reads pass through untouched (fencing is a write-side protocol)."""

    def __init__(self, inner, queue: FleetQueue, lease: Lease):
        self._inner = inner
        self._queue = queue
        self._lease = lease
        # Object-backed (and mirrored) stores also reject stale fences
        # durably at the object layer via conditional-put generation
        # preconditions — stamp the lease's token on them so a zombie's
        # write is refused even if this process dies before the queue's
        # own fence_valid check can run.
        bind = getattr(inner, "bind_fence", None)
        if bind is not None:
            bind(lease.fence)

    def write(self, table: str, frame: dict) -> int:
        if not self._queue.fence_valid(self._lease.job_id,
                                       self._lease.fence):
            self._queue.record_fence_reject(self._lease, op="write")
            raise StaleFence(
                f"store write to {table!r} rejected: job "
                f"{self._lease.job_id} fence {self._lease.fence} is stale "
                "(lease expired or re-claimed by a successor)")
        return self._inner.write(table, frame)

    def __getattr__(self, name):
        return getattr(self._inner, name)

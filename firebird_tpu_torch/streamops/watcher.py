"""Acquisition watcher: new scenes become fleet stream jobs in minutes.

The port's own copy of the JAX package's ``streamops/watcher.py``, with
its ``watcher.db`` schema (``firebird-watcher/1``) and the jobs and
payloads it enqueues, so a cursor or a queue either package wrote is the
other's:

- **manifest poll.**  Sources have a ``list_acquisitions(since)`` API
  (ingest/sources.py: the synthetic and dir-backed sources implement
  it) returning scene records ``{scene_id, published, date, bbox}``.
  The watcher polls it with a small LOOKBACK overlap so a scene whose
  publish timestamp ties the cursor is never skipped; re-delivered
  scenes are absorbed by the durable dedup below.
- **durable scene cursor.**  Scene ids land in a sqlite table
  (``watcher.db`` next to the store, the fleet.db placement rule)
  BEFORE the cursor advances: a watcher SIGKILLed mid-poll re-examines
  the window and the primary-key dedup makes the re-enqueue a no-op —
  scenes are processed exactly once across watcher incarnations.
- **footprint -> chips.**  A scene's bbox intersects the watched
  tile's chip grid (grid.py math, no HTTP); a bbox-less scene covers
  the whole tile.
- **idempotent jobs.**  Each affected chip gets at most ONE open
  ``stream`` job (``FleetQueue.enqueue_unique_chip``), so a burst of
  scenes coalesces instead of flooding the queue.  A chip with no stream
  checkpoint first gets a ``detect`` bootstrap job (run by the worker
  as a batch detect and checkpoint seed) with the stream job dep'd
  behind it through the queue's dependency machinery.
- **freshness.**  Jobs carry the scene's publish timestamp; the stream
  driver measures publish -> durable alert append into the
  ``acquisition_to_alert_seconds`` histogram, which the
  ``alert_freshness`` budget judges (obs/slo.py).

The watcher runs on the host: it imports neither torch nor the detector
(``python -m firebird_tpu_torch watch``); the jobs it enqueues run on the
card of the fleet worker that claims them.
"""

from __future__ import annotations

import datetime
import os
import sqlite3
import threading
import time

import uuid

from firebird_tpu_torch import grid
from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import spool as obs_spool
from firebird_tpu_torch.obs import tracing
from firebird_tpu_torch.utils import dates as dt
from firebird_tpu_torch.utils.fn import take

log = logger("watcher")

WATCH_SCHEMA = "firebird-watcher/1"

# Manifest re-read overlap: scenes published within this many seconds
# of the cursor are re-listed on the next poll (and deduped durably),
# so a publish-timestamp tie at the cursor boundary can delay a scene
# by one poll but never lose it.
LOOKBACK_SEC = 2.0


def watch_db_path(cfg) -> str:
    """The watcher's durable cursor database: ``cfg.watch_db`` when
    set, else ``watcher.db`` next to the results store (the fleet.db
    placement rule — and like the queue, the memory backend has no
    'next to' and needs an explicit FIREBIRD_WATCH_DB)."""
    if cfg.watch_db:
        return cfg.watch_db
    from firebird_tpu_torch.driver import quarantine as qlib

    d = qlib._artifact_dir(cfg)
    if d is None:
        raise ValueError(
            "the acquisition watcher needs a file-backed cursor: set "
            "FIREBIRD_WATCH_DB explicitly when FIREBIRD_STORE_BACKEND="
            "memory")
    return os.path.join(d, "watcher.db")


def _now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


class SceneCursor:
    """Durable watcher state: the publish-time cursor plus the
    scene-id dedup table.  Process-safe (WAL + short transactions) so
    a replacement watcher resumes exactly where its dead predecessor
    stopped."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._con = sqlite3.connect(  # guarded-by: _lock
            path, timeout=60, isolation_level=None,
            check_same_thread=False)
        with self._lock:
            con = self._con
            con.execute("PRAGMA journal_mode=WAL")
            con.execute("PRAGMA synchronous=NORMAL")
            con.execute("BEGIN IMMEDIATE")
            try:
                con.execute(
                    "CREATE TABLE IF NOT EXISTS scenes ("
                    " scene_id TEXT PRIMARY KEY,"
                    " published REAL NOT NULL,"
                    " date TEXT, bbox TEXT, chips INTEGER,"
                    " jobs INTEGER, enqueued_at TEXT)")
                con.execute(
                    "CREATE TABLE IF NOT EXISTS meta ("
                    " key TEXT PRIMARY KEY, value TEXT)")
                con.execute(
                    "INSERT OR IGNORE INTO meta (key, value) VALUES "
                    "('schema', ?), ('cursor', '0')", (WATCH_SCHEMA,))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise

    def cursor(self) -> float:
        with self._lock:
            row = self._con.execute(
                "SELECT value FROM meta WHERE key = 'cursor'").fetchone()
        return float(row[0]) if row else 0.0

    def record(self, scene: dict, *, chips: int, jobs: int) -> bool:
        """Record one processed scene and advance the cursor in ONE
        transaction; False when the scene id was already recorded (a
        re-listed or re-delivered scene — the exactly-once gate)."""
        with self._lock:
            con = self._con
            con.execute("BEGIN IMMEDIATE")
            try:
                import json as _json

                bbox = scene.get("bbox")
                cur = con.execute(
                    "INSERT OR IGNORE INTO scenes (scene_id, published, "
                    "date, bbox, chips, jobs, enqueued_at) VALUES "
                    "(?, ?, ?, ?, ?, ?, ?)",
                    (str(scene["scene_id"]), float(scene["published"]),
                     scene.get("date"),
                     None if bbox is None else _json.dumps(
                         [float(v) for v in bbox]),
                     int(chips), int(jobs), _now_iso()))
                if cur.rowcount:
                    con.execute(
                        "UPDATE meta SET value = ? WHERE key = 'cursor' "
                        "AND CAST(value AS REAL) < ?",
                        (repr(float(scene["published"])),
                         float(scene["published"])))
                con.execute("COMMIT")
            except BaseException:
                con.execute("ROLLBACK")
                raise
        return bool(cur.rowcount)

    def recent_scenes(self, limit: int = 200) -> list[dict]:
        """The newest recorded scenes (date-descending) — the coverage
        sweep's bounded working set."""
        import json as _json

        with self._lock:
            rows = self._con.execute(
                "SELECT scene_id, published, date, bbox FROM scenes "
                "ORDER BY date DESC, scene_id DESC LIMIT ?",
                (int(limit),)).fetchall()
        return [{"scene_id": sid, "published": pub, "date": date,
                 "bbox": None if bbox is None else _json.loads(bbox)}
                for sid, pub, date, bbox in rows]

    def seen(self, scene_id: str) -> bool:
        with self._lock:
            row = self._con.execute(
                "SELECT 1 FROM scenes WHERE scene_id = ?",
                (str(scene_id),)).fetchone()
        return row is not None

    def status(self) -> dict:
        with self._lock:
            n, jobs = self._con.execute(
                "SELECT COUNT(*), COALESCE(SUM(jobs), 0) FROM scenes"
            ).fetchone()
            last = self._con.execute(
                "SELECT scene_id, enqueued_at FROM scenes "
                "ORDER BY published DESC, scene_id DESC LIMIT 1"
            ).fetchone()
        return {"path": self.path, "cursor": self.cursor(),
                "scenes": int(n), "jobs": int(jobs),
                "last_scene": (None if last is None else
                               {"scene_id": last[0],
                                "enqueued_at": last[1]})}

    def close(self) -> None:
        with self._lock:
            self._con.close()


class AcquisitionWatcher:
    """Poll a source's acquisition manifest and keep the fleet queue
    fed with idempotent per-chip stream jobs for one tile."""

    def __init__(self, cfg, x: float, y: float, *, number: int = 2500,
                 acquired_start: str = "1982-01-01", source=None,
                 queue=None, statestore=None, cursor=None,
                 clock=time.time):
        from firebird_tpu_torch.driver import fetch as dfetch
        from firebird_tpu_torch.fleet.worker import make_queue
        from firebird_tpu_torch.streamops import statestore as sstore_mod

        self.cfg = cfg
        self.tile = grid.tile(x=x, y=y)
        self.x, self.y = float(x), float(y)
        self.cids = [tuple(int(v) for v in c)
                     for c in take(number, grid.chips(self.tile))]
        self.acquired_start = acquired_start
        self.source = source if source is not None else \
            dfetch.make_source(cfg)
        if not hasattr(self.source, "list_acquisitions"):
            raise ValueError(
                f"source {type(self.source).__name__} has no "
                "list_acquisitions manifest — the watcher needs a "
                "manifest-capable source (synthetic or file)")
        self._own_queue = queue is None
        self.queue = queue if queue is not None else make_queue(cfg)
        self.sstore = statestore if statestore is not None else \
            sstore_mod.open_statestore(cfg)
        self.cursor = cursor if cursor is not None else \
            SceneCursor(watch_db_path(cfg))
        # Fault seam (faults.py ``watch`` scope): an injected failure
        # aborts the poll before any scene is mapped — run() logs and
        # retries, so a brownout window models a stalled watcher.
        from firebird_tpu_torch import faults
        plan = faults.FaultPlan.from_config(cfg)
        self.fault_injector = plan.injector("watch") \
            if plan is not None else None
        self._clock = clock
        self.tallies = {k: 0 for k in
                        ("polls", "scenes_seen", "scenes_enqueued",
                         "jobs_stream", "jobs_bootstrap", "jobs_sweep")}
        # Coverage-sweep memo: (chip, target ordinal) pairs already
        # re-enqueued by THIS incarnation, so a chip a job cannot
        # advance (source gap at the scene date) costs one retry per
        # new scene, not one per poll.  In-memory on purpose — a
        # replacement watcher retries once more, which is idempotent.
        self._swept: set = set()

    # -- scene -> chips -----------------------------------------------------

    def _affected_chips(self, scene: dict) -> list:
        """The watched tile's chips whose 3 km cell intersects the
        scene footprint; a bbox-less scene covers the whole tile."""
        bbox = scene.get("bbox")
        if not bbox:
            return list(self.cids)
        minx, miny, maxx, maxy = (float(v) for v in bbox)
        sx, sy = self.cfg_chip_span()
        return [(cx, cy) for cx, cy in self.cids
                if cx < maxx and cx + sx > minx
                and cy > miny and cy - sy < maxy]

    @staticmethod
    def cfg_chip_span() -> tuple[float, float]:
        return grid.CONUS.chip.sx, grid.CONUS.chip.sy

    # -- one poll -----------------------------------------------------------

    def _revive_dead_deps(self, job_id: int) -> None:
        """Unwedge a stream job blocked behind a DEAD dependency: a
        bootstrap that spent its attempt budget (transient source
        outage) would otherwise block the chip's open stream job
        forever — and the at-most-one-open rule would then absorb
        every future enqueue for the chip.  A new scene arriving is
        the retry trigger: requeue the dead upstream with a fresh
        budget (bounded — at most once per scene per chip)."""
        job = self.queue.job(job_id)
        for d in (job or {}).get("depends_on", ()):
            dep = self.queue.job(d)
            if dep is not None and dep["state"] == "dead":
                self.queue.requeue(d)
                log.warning(
                    "requeued dead bootstrap job %d: stream job %d was "
                    "blocked behind it", d, job_id)

    def _enqueue_scene(self, scene: dict) -> int:
        """Jobs for one new scene: per affected chip, one open stream
        job at most; checkpoint-less chips get the bootstrap detect
        job first with the stream job dep'd behind it."""
        chips = self._affected_chips(scene)
        end = dt.to_iso(dt.to_ordinal(str(scene["date"])) + 1)
        acquired = f"{self.acquired_start}/{end}"     # half-open end
        # ONE open-jobs snapshot per scene (open_jobs is a full table
        # scan — per-chip calls would make a whole-tile scene O(chips)
        # scans), kept current with this loop's own enqueues.
        open_boot = self.queue.open_jobs("detect")
        open_stream = self.queue.open_jobs("stream")
        # One trace id per SCENE, minted here and carried in every job
        # payload the scene produces: the fleet queue round-trips the
        # payload through claim/re-delivery, the worker adopts the id
        # (fleet/worker.py) and the stream driver stamps it on the alert
        # row — one causal chain from manifest to alert.
        trace_id = f"scene/{scene['scene_id']}/{uuid.uuid4().hex[:8]}"
        jobs = 0
        for cx, cy in chips:
            base = {"cx": cx, "cy": cy, "x": self.x, "y": self.y,
                    "acquired": acquired,
                    "scene_id": str(scene["scene_id"]),
                    "published": float(scene["published"]),
                    tracing.TRACE_KEY: trace_id}
            deps = ()
            if not self.sstore.exists((cx, cy)):
                if (cx, cy) in open_stream \
                        and (cx, cy) not in open_boot:
                    # No checkpoint, no open bootstrap, yet an open
                    # stream job: it is blocked behind a dead
                    # bootstrap — revive that before enqueueing, so
                    # the revived job (now open) becomes the dep
                    # instead of a stranded duplicate.
                    self._revive_dead_deps(open_stream[(cx, cy)])
                    open_boot = self.queue.open_jobs("detect")
                bjid = self.queue.enqueue_unique_chip(
                    "detect", dict(base, bootstrap=True),
                    max_attempts=self.cfg.fleet_max_attempts)
                if bjid is None:   # an open bootstrap already covers it
                    bjid = open_boot.get((cx, cy))
                else:
                    open_boot[(cx, cy)] = bjid
                    self.tallies["jobs_bootstrap"] += 1
                    jobs += 1
                if bjid is not None:
                    deps = (bjid,)
            jid = self.queue.enqueue_unique_chip(
                "stream", dict(base, cids=[[cx, cy]]),
                depends_on=deps,
                max_attempts=self.cfg.fleet_max_attempts)
            if jid is not None:
                open_stream[(cx, cy)] = jid
                self.tallies["jobs_stream"] += 1
                jobs += 1
        if jobs:
            # The causal chain's first cross-process joint: the
            # critical-path breakdown reads watch lag (publish ->
            # enqueue) and queue wait (enqueue -> claim) off this mark.
            obs_spool.mark("scene_enqueued", trace=trace_id,
                           scene=str(scene["scene_id"]), jobs=jobs,
                           published=float(scene["published"]))
        return jobs

    def _coverage_sweep(self) -> int:
        """Close the coalescing window: a scene that lands while a
        chip's stream job is already OPEN is absorbed by the at-most-
        one-open-job rule — and if that job had already fetched its
        delta, the scene's observations would strand.  The sweep
        compares each chip's checkpoint horizon against the newest
        recorded scene covering it and re-enqueues a stream job for any
        chip left behind (idempotent: an open job absorbs it, a covered
        chip skips it)."""
        recent = self.cursor.recent_scenes()
        if not recent:
            return 0
        # One pass newest-first: each chip's target is the newest scene
        # covering it.  (Per-chip scans of the scene list would be
        # O(chips x scenes x chips) with bbox'd scenes — this is
        # O(scenes x chips) worst case and one iteration for the
        # common tile-wide scene.)
        targets: dict = {}
        for s in recent:                       # already date-descending
            for cid in self._affected_chips(s):
                targets.setdefault(cid, s)
            if len(targets) == len(self.cids):
                break
        jobs = 0
        for cid, newest in targets.items():
            target = dt.to_ordinal(str(newest["date"]))
            if (cid, target) in self._swept:
                continue
            horizon = self.sstore.peek_horizon(cid)
            if horizon is None or horizon >= target:
                continue        # bootstrap pending, or already covered
            end = dt.to_iso(target + 1)
            trace_id = (f"scene/{newest['scene_id']}/"
                        f"sweep-{uuid.uuid4().hex[:8]}")
            jid = self.queue.enqueue_unique_chip(
                "stream",
                {"cx": cid[0], "cy": cid[1], "x": self.x, "y": self.y,
                 "acquired": f"{self.acquired_start}/{end}",
                 "scene_id": str(newest["scene_id"]),
                 "published": float(newest["published"]),
                 "cids": [[cid[0], cid[1]]], "sweep": True,
                 tracing.TRACE_KEY: trace_id},
                max_attempts=self.cfg.fleet_max_attempts)
            if jid is not None:
                obs_spool.mark("scene_enqueued", trace=trace_id,
                               scene=str(newest["scene_id"]), jobs=1,
                               sweep=True,
                               published=float(newest["published"]))
                # Memo ONLY on a real enqueue: an absorbed sweep (open
                # job) must keep retrying each poll, because the open
                # job may cover a shorter window than this target.
                self._swept.add((cid, target))
                jobs += 1
        if jobs:
            self.tallies["jobs_sweep"] += jobs
            log.info("coverage sweep re-enqueued %d lagging chips", jobs)
        return jobs

    def poll_once(self) -> dict:
        """One manifest poll: list, dedupe, map, enqueue, record.
        Returns a summary dict."""
        self.tallies["polls"] += 1
        if self.fault_injector is not None:
            self.fault_injector.fire()
        since = max(self.cursor.cursor() - LOOKBACK_SEC, 0.0)
        with tracing.span("watch_poll", since=round(since, 3)):
            scenes = sorted(self.source.list_acquisitions(since=since),
                            key=lambda s: (float(s["published"]),
                                           str(s["scene_id"])))
            new = enqueued = jobs_total = 0
            for scene in scenes:
                if self.cursor.seen(scene["scene_id"]):
                    continue
                new += 1
                jobs = self._enqueue_scene(scene)
                chips = len(self._affected_chips(scene))
                # Record AFTER the enqueues: a crash between them
                # re-enqueues on restart and enqueue_unique_chip's
                # at-most-one-open rule absorbs the duplicates.
                if self.cursor.record(scene, chips=chips, jobs=jobs):
                    enqueued += 1 if jobs else 0
                    jobs_total += jobs
            swept = self._coverage_sweep()
            jobs_total += swept
        if new:
            self.tallies["scenes_seen"] += new
            obs_metrics.counter(
                "watcher_scenes_seen",
                help="new scene ids first witnessed on the acquisition "
                     "manifest").inc(new)
        if jobs_total:
            self.tallies["scenes_enqueued"] += enqueued
            obs_metrics.counter(
                "watcher_scenes_enqueued",
                help="scenes that enqueued at least one fleet job").inc(
                enqueued)
            obs_metrics.counter(
                "watcher_jobs_enqueued",
                help="stream/bootstrap jobs the watcher enqueued").inc(
                jobs_total)
            log.info("scene poll: %d new scenes -> %d jobs (queue %s)",
                     new, jobs_total, self.queue.path)
        obs_metrics.gauge(
            "watcher_cursor",
            help="the watcher's durable publish-time cursor").set(
            self.cursor.cursor())
        return {"scenes_listed": len(scenes), "scenes_new": new,
                "scenes_enqueued": enqueued, "jobs": jobs_total,
                "cursor": self.cursor.cursor()}

    # -- the loop -----------------------------------------------------------

    def run(self, *, interval: float | None = None, once: bool = False,
            stop: threading.Event | None = None,
            sleep=time.sleep) -> dict:
        """Poll until stopped (or once).  Returns the cumulative
        summary; a poll failure is logged and retried next interval —
        the watcher is a supervisor loop, not a one-shot job."""
        interval = self.cfg.watch_interval if interval is None \
            else float(interval)
        stop = stop or threading.Event()
        while True:
            try:
                self.poll_once()
            except Exception as e:
                log.error("scene poll failed (%s: %s); retrying in %.1fs",
                          type(e).__name__, e, interval)
            if once or stop.wait(interval):
                break
        return self.status()

    def status(self) -> dict:
        """The streamops watcher block (``status`` / ``/progress``):
        durable cursor state + this incarnation's
        tallies + queue depth for the job types it feeds."""
        out = {"tile": {"h": self.tile["h"], "v": self.tile["v"]},
               "chips": len(self.cids), "cursor": self.cursor.status(),
               "tallies": dict(self.tallies)}
        try:
            by = self.queue.status()["by_type"]
            out["queue"] = {t: by.get(t, {}) for t in ("stream", "detect")}
        except Exception as e:
            out["queue"] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def close(self) -> None:
        self.cursor.close()
        if self._own_queue:
            self.queue.close()

"""Embedded HTTP ops endpoint: the live ops surface for in-flight runs.

The port's own copy of the JAX package's ``obs/server.py``.  It embeds a
stdlib ``http.server`` on a daemon thread — off by default, enabled with
``FIREBIRD_OPS_PORT`` / ``--ops-port``, one port per process (two
processes on one host need two ports) — serving:

``/healthz``
    Liveness.  200 ``ok`` while the run progresses; 200 ``degraded``
    when it is alive but routing around failures (chips in quarantine,
    ingest breaker not closed — docs/ROBUSTNESS.md); 503 once the stall
    watchdog (obs/watchdog.py) sees no batch complete within its
    deadline.  The handler evaluates the deadline live, so no background
    thread is needed when something scrapes.
``/readyz``
    Readiness: the device mesh is up AND the first batch has been
    dispatched — i.e. the kernel build and bring-up are behind us and the
    run is in its steady state.  503 before that.
``/metrics``
    The process metrics registry in Prometheus text exposition 0.0.4
    (``MetricsRegistry.prometheus()``) — point a scraper at it.
``/progress``
    JSON: run_id, chips done/total, batches dispatched/drained, current
    stage, the run counters with ``*_per_sec`` rates, and the watchdog
    state.
``/report``
    The live ``build_report`` dict — the same document obs_report.json
    will contain, available at any moment mid-run.
``/slo``
    The live SLO evaluation (obs/slo.py), with the durable error-budget
    block over the series store (obs/series.py) when one exists for the
    ambient config (``?budgets=0`` leaves it out).
``/metrics/history``
    Windowed points from the series rings (``?res=&window=&metric=``),
    the spools re-ingested first; 503 with no series store.
``POST /profile``
    A device-profile window (obs/profiling.py); 503 without a profiler.

The drivers register a :class:`RunStatus` (run identity, totals, the
shared ``Counters``, the watchdog) in a process-global slot; the
module-level hooks (:func:`set_stage`, :func:`batch_dispatched`,
:func:`batch_done`) are no-ops when no run is registered, so
instrumentation call sites cost one global read when the surface is off —
the same discipline as obs/tracing.py.
"""

from __future__ import annotations

import threading

from firebird_tpu_torch.obs import httpd


class RunStatus:
    """Shared mutable view of one driver run, read by the HTTP handlers.

    ``counters`` is the driver's live ``obs.Counters`` (chips/pixels/
    segments accumulate as batches drain); ``watchdog`` is optional;
    ``run`` is the report run block (kind, tile, run_id, ...).
    """

    def __init__(self, run_id: str, kind: str, *, chips_total: int = 0,
                 counters=None, watchdog=None, run: dict | None = None,
                 mesh_up: bool = True, pipeline_depth: int = 2,
                 quarantine=None, breaker=None, profiler=None,
                 slo_spec: str | None = None, fleet=None, alerts=None,
                 streamops=None):
        self.run_id = run_id
        self.kind = kind
        self.chips_total = int(chips_total)
        self.counters = counters
        self.watchdog = watchdog
        # Degradation sources: the dead-letter quarantine
        # (driver.quarantine.Quarantine) and the ingest circuit breaker
        # (retry.CircuitBreaker) — both optional, both only *read* here.
        self.quarantine = quarantine
        self.breaker = breaker
        # Deep-dive hooks: the run's device profiler (POST /profile,
        # obs/profiling.py) and its SLO spec (/slo, obs/slo.py).
        self.profiler = profiler
        self.slo_spec = slo_spec
        # Fleet view provider (fleet workers pass FleetWorker.fleet_block):
        # a zero-arg callable returning the queue/worker snapshot dict
        # rendered as /progress's "fleet" block; None for non-fleet runs.
        self.fleet = fleet
        # Alerts view provider (the stream driver passes a zero-arg
        # callable over its AlertLog.status): /progress's "alerts"
        # block; None for runs without an alert log.
        self.alerts = alerts
        # Streamops view provider (the stream driver passes its
        # checkpoint store's status; `firebird watch` passes the
        # watcher's): /progress's "streamops" block; None elsewhere.
        self.streamops = streamops
        self.run = dict(run or {})
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self._lock = threading.Lock()
        self._stage = "init"  # guarded-by: _lock
        self._mesh_up = bool(mesh_up)  # guarded-by: _lock
        self._first_batch = False  # guarded-by: _lock
        self._batches_dispatched = 0  # guarded-by: _lock
        self._batches_done = 0  # guarded-by: _lock

    # -- driver-side updates ----------------------------------------------

    def set_stage(self, name: str) -> None:
        with self._lock:
            self._stage = name
        from firebird_tpu_torch.obs import flightrec
        flightrec.mark("stage", stage=name)

    def mark_mesh_up(self) -> None:
        with self._lock:
            self._mesh_up = True

    def dispatch_starting(self) -> None:
        """A dispatch is about to start: FIREBIRD_PROFILE's auto window
        opens here, before the first one, and the dispatch waits until
        its capture runs (obs/profiling.py: the port's dispatch launches
        most of a batch's kernels before it returns)."""
        if self.profiler is not None:
            self.profiler.maybe_start_auto()

    def batch_dispatched(self) -> None:
        """First dispatch flips readiness: bring-up is done."""
        with self._lock:
            self._first_batch = True
            self._batches_dispatched += 1
            n = self._batches_dispatched
            self._record_inflight()
        from firebird_tpu_torch.obs import flightrec
        flightrec.mark("batch_dispatched", n=n)

    def batch_done(self, units: int = 1) -> None:
        """A batch finished draining — forward progress; beats the
        watchdog."""
        with self._lock:
            self._batches_done += 1
            n = self._batches_done
            self._record_inflight()
        from firebird_tpu_torch.obs import flightrec
        flightrec.mark("batch_done", n=n, units=units)
        if self.watchdog is not None:
            self.watchdog.beat(units)

    def _record_inflight(self) -> None:  # guarded-by: _lock
        # Called under self._lock: compute-and-set must be atomic or a
        # dispatch/done race could strand the gauge at a stale value.
        from firebird_tpu_torch.obs import metrics as obs_metrics

        n = self._batches_dispatched - self._batches_done
        obs_metrics.gauge(
            "pipeline_inflight",
            help="batches dispatched but not yet drained").set(max(n, 0))

    # -- endpoint reads ----------------------------------------------------

    def healthy(self) -> bool:
        return self.watchdog is None or not self.watchdog.check()

    def degraded(self) -> bool:
        """Alive but bleeding: chips in quarantine, or the ingest breaker
        not closed.  ``/healthz`` stays 200 (a supervisor must NOT
        restart a run that is making progress around failures) but the
        body says 'degraded' and ``/progress`` carries the detail."""
        if self.quarantine is not None and len(self.quarantine) > 0:
            return True
        if self.breaker is not None and self.breaker.state != 0:
            return True
        return False

    def degraded_block(self) -> dict:
        """The /progress 'degraded' sub-document (docs/ROBUSTNESS.md)."""
        from firebird_tpu_torch.obs import metrics as obs_metrics

        # Recent rolling-window throughput-drop events (timestamp, the
        # window rate, the threshold it crossed): the slow-leak signal
        # was only COUNTED before — the events themselves belong in the
        # degraded view an operator actually reads.
        drops: list = []
        if self.watchdog is not None:
            drops = self.watchdog.snapshot().get("throughput_drops", [])
        return {
            "active": self.degraded(),
            "chips_quarantined": (len(self.quarantine)
                                  if self.quarantine is not None else 0),
            "breaker": (self.breaker.snapshot()
                        if self.breaker is not None else None),
            "faults_injected": obs_metrics.counter("faults_injected").value,
            "retries": obs_metrics.counter("fetch_retries").value
            + obs_metrics.counter("store_write_retries").value,
            "throughput_drops": drops,
        }

    @staticmethod
    def _kernel_block() -> dict:
        """Event-loop lane occupancy for /progress (kernel.record_occupancy
        feeds the counters as batches drain): active vs wasted lane-rounds
        and the compaction count — a wasted share near zero means the
        compacted loop pays only for working pixels
        (ChipSegments.occupancy)."""
        from firebird_tpu_torch.obs import metrics as obs_metrics

        active = obs_metrics.counter("kernel_active_lane_rounds").value
        wasted = obs_metrics.counter("kernel_wasted_lane_rounds").value
        return {
            "active_lane_rounds": active,
            "wasted_lane_rounds": wasted,
            "wasted_share": round(wasted / max(active + wasted, 1), 4),
            "compactions": obs_metrics.counter(
                "kernel_compactions").value,
        }

    def ready(self) -> bool:
        with self._lock:
            return self._mesh_up and self._first_batch

    def progress(self) -> dict:
        with self._lock:
            stage = self._stage
            dispatched, done = self._batches_dispatched, self._batches_done
            mesh_up, first = self._mesh_up, self._first_batch
        counters = self.counters.snapshot() if self.counters is not None \
            else {}
        inflight = max(dispatched - done, 0)
        return {
            "run_id": self.run_id,
            "kind": self.kind,
            "stage": stage,
            "ready": mesh_up and first,
            "healthy": self.healthy(),
            "chips_done": int(counters.get("chips", 0)),
            "chips_total": self.chips_total,
            "batches_dispatched": dispatched,
            "batches_done": done,
            # Occupancy ~1 while dispatching: the device stays fed and the
            # drain bound (pipeline_depth) is the limiter; ~0 means the
            # host (fetch/pack/stage) is starving the device.
            "pipeline": {
                "depth": self.pipeline_depth,
                "in_flight": inflight,
                "occupancy": round(inflight / self.pipeline_depth, 3),
                "kernel": self._kernel_block(),
            },
            "counters": counters,
            "degraded": self.degraded_block(),
            "fleet": self._fleet_block(),
            "alerts": self._alerts_block(),
            "streamops": self._streamops_block(),
            "watchdog": (self.watchdog.snapshot()
                         if self.watchdog is not None else None),
        }

    def _alerts_block(self) -> dict | None:
        """The /progress 'alerts' sub-document: alert-log depth, latest
        cursor, per-subscriber delivery lag, plus this run's emission
        tallies (docs/ALERTS.md).  None for runs without an alert log; a
        snapshot failure degrades this block, never /progress itself."""
        if self.alerts is None:
            return None
        try:
            return self.alerts()
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def _streamops_block(self) -> dict | None:
        """The /progress 'streamops' sub-document: the packed
        checkpoint store's activity (or the watcher's cursor view, for
        ``firebird watch``; docs/STREAMING.md).  None for runs without
        streamops; a snapshot failure degrades this block only."""
        if self.streamops is None:
            return None
        try:
            return self.streamops()
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}

    def _fleet_block(self) -> dict | None:
        """The /progress 'fleet' sub-document: queue depths by type and
        state, active leases with age/holder, dead-letter classes, and
        this worker's tallies (docs/ROBUSTNESS.md "Fleet scheduling").
        None for non-fleet runs; a snapshot failure must not take the
        whole progress endpoint down with it."""
        if self.fleet is None:
            return None
        try:
            return self.fleet()
        except Exception as e:
            return {"error": f"{type(e).__name__}: {e}"}


# Mutation under _status_lock; the per-batch hook reads (set_stage,
# current, ...) grab the one reference lock-free on purpose.
_status: RunStatus | None = None  # guarded-by: _status_lock
_status_lock = threading.Lock()


def set_status(status: RunStatus) -> RunStatus:
    global _status
    with _status_lock:
        _status = status
    return status


def clear_status() -> None:
    global _status
    with _status_lock:
        _status = None


def current() -> RunStatus | None:
    return _status


# Module-level hooks for instrumentation sites (driver/core.py,
# driver/stream.py): one global read + None check when no run registered.

def set_stage(name: str) -> None:
    st = _status
    if st is not None:
        st.set_stage(name)


def dispatch_starting() -> None:
    st = _status
    if st is not None:
        st.dispatch_starting()


def batch_dispatched() -> None:
    st = _status
    if st is not None:
        st.batch_dispatched()


def batch_done(units: int = 1) -> None:
    st = _status
    if st is not None:
        st.batch_done(units)


def mark_mesh_up() -> None:
    st = _status
    if st is not None:
        st.mark_mesh_up()


# One process-wide SeriesStore for the threaded handlers: per-request
# instances share this pid, so two concurrent /slo or /metrics/history
# requests would append to (or resume over) the same segment files from
# two uncoordinated writers — SeriesStore is thread-safe only within
# one instance.  Re-keyed when the ambient config changes (knob flips,
# tests); _budget_lock additionally serializes evaluate+record so two
# requests cannot race the durable event log's read-then-append.
_series_lock = threading.Lock()
_series_cache: dict = {"key": None, "store": None}
_budget_lock = threading.Lock()


def _shared_store(cfg):
    from firebird_tpu_torch.obs import series as series_mod

    key = (series_mod.series_dir(cfg), getattr(cfg, "series", 0),
           getattr(cfg, "series_segments", 0), cfg.telemetry)
    with _series_lock:
        if _series_cache["key"] != key:
            if _series_cache["store"] is not None:
                _series_cache["store"].close()
            _series_cache["store"] = series_mod.open_store(cfg)
            _series_cache["key"] = key
        return _series_cache["store"]


def _budget_block() -> dict:
    """The /slo budgets block: ingest fresh spool snapshots into the
    series rings, then evaluate + durably record the error budgets for
    the ambient config.  Raises when the store cannot open — the /slo
    route degrades that to an error string."""
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.obs import slo as slomod

    cfg = Config.from_env()
    store = _shared_store(cfg)
    if store is None:
        return {"disabled": True,
                "reason": "no series store (FIREBIRD_SERIES=0 / "
                          "FIREBIRD_TELEMETRY=0 / memory backend)"}
    with _budget_lock:
        store.ingest_spools()
        return slomod.evaluate_and_record(
            store.dir, cfg.slo_budget or None,
            fast_sec=cfg.slo_fast_sec, slow_sec=cfg.slo_slow_sec,
            burn_threshold=cfg.slo_burn)


class _OpsHandler(httpd.JsonHandler):
    server_version = "firebird-ops/1"

    def _route(self, path: str, query: dict) -> None:
        from firebird_tpu_torch.obs import metrics as obs_metrics

        st = self.server.status if self.server.status is not None \
            else current()
        if path == "/healthz":
            if st is not None and not st.healthy():
                self._send(503, b"stalled\n", "text/plain")
            elif st is not None and st.degraded():
                # Degraded is a 200: the run is alive and routing around
                # failures (quarantined chips, open breaker) — restarting
                # it would lose the progress it is still making.
                self._send(200, b"degraded\n", "text/plain")
            else:
                self._send(200, b"ok\n", "text/plain")
        elif path == "/readyz":
            if st is not None and st.ready():
                self._send(200, b"ready\n", "text/plain")
            else:
                self._send(503, b"not ready\n", "text/plain")
        elif path == "/metrics":
            self._send(200, obs_metrics.get_registry().prometheus().encode(),
                       "text/plain; version=0.0.4")
        elif path == "/progress":
            if st is None:
                self._send_json(503, {"error": "no run registered"})
            else:
                self._send_json(200, st.progress())
        elif path == "/report":
            from firebird_tpu_torch.obs import report as obs_report
            from firebird_tpu_torch.obs import tracing
            self._send_json(200, obs_report.build_report(
                tracer=tracing.active(),
                run=st.run if st is not None else {},
                run_counters=(st.counters.snapshot()
                              if st is not None and st.counters is not None
                              else None)))
        elif path == "/slo":
            from firebird_tpu_torch.obs import slo as slomod
            doc = slomod.evaluate_snapshot(
                obs_metrics.get_registry().snapshot(),
                watchdog=(st.watchdog.snapshot()
                          if st is not None and st.watchdog is not None
                          else None),
                spec=st.slo_spec if st is not None else None)
            # Durable error budgets ride along whenever a series store
            # exists for this config; a broken store degrades to an
            # error string, never a dead endpoint (the status-section
            # rule).  ?budgets=0 skips the disk walk.
            if (query.get("budgets") or ["1"])[0] not in ("0", "false"):
                try:
                    doc["budgets"] = _budget_block()
                except Exception as e:
                    doc["budgets"] = {"error": f"{type(e).__name__}: {e}"}
            self._send_json(200, doc)
        elif path == "/metrics/history":
            self._history(query)
        elif path == "/profile":
            # GET reports the windows captured so far (POST starts one).
            from firebird_tpu_torch.obs import profiling
            prof = st.profiler if st is not None else None
            if prof is None:
                prof_active = profiling.active()
                if prof_active is None:
                    self._send_json(503, {"error": "no profiler for this "
                                                   "run (memory backend?)"})
                    return
                prof = prof_active
            self._send_json(200, prof.summary())
        else:
            self._send_json(404, {"error": f"unknown path {path!r}",
                                  "paths": ["/healthz", "/readyz", "/metrics",
                                            "/metrics/history", "/progress",
                                            "/report", "/slo", "/profile"]})

    def _history(self, query: dict) -> None:
        """``/metrics/history?res=&window=&metric=``: windowed points
        from the durable series rings (obs/series.py) — spools are
        re-ingested first, so the answer includes snapshots from
        processes that died since the last read."""
        import time as _time

        from firebird_tpu_torch.config import Config
        from firebird_tpu_torch.obs import series as series_mod

        try:
            res = int((query.get("res") or ["10"])[0])
            window = float((query.get("window") or ["600"])[0])
        except ValueError:
            self._send_json(400, {"error": "res/window must be numbers"})
            return
        metric = (query.get("metric") or [None])[0]
        store = _shared_store(Config.from_env())
        if store is None:
            self._send_json(503, {
                "error": "metric history disabled (FIREBIRD_SERIES=0 / "
                         "FIREBIRD_TELEMETRY=0) or homeless (memory "
                         "backend, no FIREBIRD_SERIES_DIR)"})
            return
        if res not in store.resolutions:
            self._send_json(400, {
                "error": f"unknown resolution {res}s",
                "resolutions": list(store.resolutions)})
            return
        store.ingest_spools()
        now = _time.time()
        pts = store.points(res, now - window, now)
        if metric:
            pts = [dict(p, m={k: {metric: (p.get("m") or {})[k][metric]}
                              if metric in ((p.get("m") or {}).get(k) or {})
                              else {}
                              for k in ("counters", "gauges",
                                        "histograms")})
                   for p in pts]
        self._send_json(200, {
            "schema": "firebird-metric-history/1", "res_sec": res,
            "window_sec": window, "t1": now, "metric": metric,
            "sources": series_mod.sources(pts), "points": pts})

    def _route_post(self, path: str, query: dict) -> None:
        from firebird_tpu_torch.obs import profiling

        st = self.server.status if self.server.status is not None \
            else current()
        if path != "/profile":
            super()._route_post(path, query)
            return
        prof = st.profiler if st is not None else None
        if prof is None:
            prof = profiling.active()
        if prof is None:
            self._send_json(503, {"error": "no profiler for this run "
                                           "(memory backend?)"})
            return
        import math

        try:
            seconds = float((query.get("seconds") or ["3"])[0])
        except ValueError:
            self._send_json(400, {"error": "seconds must be a number"})
            return
        if not math.isfinite(seconds):
            # nan slips through min/max clamping (Event.wait(nan) raises
            # after a real trace started) and inf isn't a window.
            self._send_json(400, {"error": "seconds must be finite"})
            return
        try:
            info = prof.window(seconds)
        except profiling.ProfilerBusy as e:
            self._send_json(409, {"error": str(e)})
            return
        self._send_json(202, dict(info, started=True))


class OpsServer(httpd.Httpd):
    """The ops endpoint server (shared lifecycle: obs/httpd.py)."""

    thread_name = "firebird-ops"

    def __init__(self, addr, status: RunStatus | None = None):
        super().__init__(addr, _OpsHandler)
        self.status = status


def start_ops_server(port: int, status: RunStatus | None = None,
                     host: str | None = None) -> OpsServer:
    """Bind and start the ops endpoint.

    ``port`` 0 binds an OS-assigned ephemeral port (tests, obs-smoke);
    callers gating on config must only call this when the operator set
    ``FIREBIRD_OPS_PORT``/``--ops-port`` — the surface is off by default
    and no port is ever bound otherwise (driver/core.py guards on
    ``cfg.ops_port > 0``).  Bind host comes from ``Config.ops_host`` /
    FIREBIRD_OPS_HOST (default all interfaces — the endpoint exists to
    be scraped); cfg-carrying callers pass it explicitly.
    """
    if host is None:
        from firebird_tpu_torch.config import env_knob

        host = env_knob("FIREBIRD_OPS_HOST")
    srv = OpsServer((host, int(port)), status=status).start()
    from firebird_tpu_torch.obs import logger
    logger("change-detection").info(
        "ops endpoint up on %s:%d (/healthz /readyz /metrics /progress "
        "/report /slo; POST /profile)", host, srv.port)
    return srv

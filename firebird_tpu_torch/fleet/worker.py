"""Fleet worker: drain the shared queue, one leased job at a time, on the card.

The port's own copy of the JAX package's ``fleet/worker.py``.  One
``python -m firebird_tpu_torch fleet work`` process per card: claim ->
execute -> heartbeat (background thread) -> ack, forever.  The worker
resolves its device once (``driver.core.run_device``: CUDA, or the CPU
only when its caller names it, as the tests do) and builds the kernels
before its ops surface comes up; every handler runs the port's card path
on that device:

- **detect** jobs run the chunk loop (:func:`driver.core.run_chunk`):
  per-chip quarantine, shared retry budget, ingest breaker, staged
  batches — against a :class:`~firebird_tpu_torch.fleet.queue.FencedStore`
  so a zombie's writes reject.
- **stream** jobs run the streaming driver; **classify** jobs run the
  random-forest pipeline; **product** jobs run ``products.save``;
  **repair** jobs run the stream's cold-path repair — one queue, with
  fleet/plan.py's dependency edges sequencing them per tile.
- **pyramid** jobs build the serving pyramid's tiles over their bounds
  (serve/pyramid.py ``build_area``) on the host, from the rows the card
  wrote; **fanout** jobs drain one quadkey shard's alert delivery
  (alerts/fanout.py) on the host: the process holds its card, the
  handler never touches it.
- Re-delivery fast path: a detect job claims chips already stored and
  skips them (the ``--resume`` presence rule at job granularity), so a
  re-delivered job pays only for the work its dead predecessor did not
  land.
- Observability: ``fleet_jobs_{claimed,acked,requeued,dead,lost}``
  counters, the ``fleet_lease_age_seconds`` gauge (updated by each
  heartbeat), per-job-type ``fleet_job_seconds_<type>`` latency
  histograms whose exemplars carry the job's trace id, flight-recorder
  marks on claim/ack/lease-loss, ``job_claimed``/``job_acked`` marks on
  the telemetry spool (obs/spool.py), and a ``fleet`` block on
  ``/progress`` (queue depths, this worker's tallies, the current job).

A heartbeat that finds the lease gone (:class:`LeaseLost`) or a store
write that hits a stale fence (:class:`StaleFence`) makes the worker
ABANDON the job — no quarantine records, no failure report: the job
already belongs to a successor, and this worker's only correct move is
to stop touching its output.  ``FIREBIRD_FAULTS="lease:p=1"`` turns a
worker into exactly that zombie for chaos drills.
"""

from __future__ import annotations

import os
import socket
import threading
import time

from firebird_tpu_torch import faults as faultlib
from firebird_tpu_torch import retry as retrylib
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.fleet.queue import (FencedStore, FleetQueue, Lease,
                                      LeaseLost, StaleFence, queue_path)
from firebird_tpu_torch.obs import Counters, jsonlog, logger
from firebird_tpu_torch.obs import flightrec
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import server as obs_server
from firebird_tpu_torch.obs import spool as obs_spool
from firebird_tpu_torch.obs import tracing
from firebird_tpu_torch.store.objectstore import StaleObjectFence


# `fleet work`/`fleet supervise` exit status for a WEDGED queue
# (pending jobs all blocked behind dead deps — an operator must
# requeue).  The supervisor's reaper treats it as a deliberate
# self-report, never crash-loop-circuit food.
WEDGED_EXIT = 4


def make_queue(cfg: Config, clock=time.time) -> FleetQueue:
    """The config's queue: FIREBIRD_FLEET_DB (or next to the store),
    with the config's lease length."""
    return FleetQueue(queue_path(cfg), lease_sec=cfg.fleet_lease_sec,
                      clock=clock)


class FleetWorker:
    """One queue-draining worker process (or thread, in tests).

    ``handlers`` maps job_type -> callable(job_payload, lease); the
    default table runs the real pipeline stages.  ``clock``/``sleep``
    are injectable so the claim/poll loop and heartbeat cadence are
    testable without wall-clock waits.  ``device`` is the card every
    handler runs on, resolved once here (default CUDA; without a card
    this raises unless the caller names the CPU).
    """

    def __init__(self, cfg: Config, queue: FleetQueue, *,
                 worker_id: str | None = None, handlers: dict | None = None,
                 poll_sec: float = 1.0, kind: str = "batch",
                 clock=time.time, sleep=time.sleep, device=None):
        from firebird_tpu_torch.driver import core as dcore

        self.cfg = cfg
        self.device = dcore.run_device(device)
        self.queue = queue
        self.kind = kind
        self.worker_id = worker_id or \
            f"{socket.gethostname()}:{os.getpid()}"
        self.poll_sec = float(poll_sec)
        self._clock = clock
        self._sleep = sleep
        self.log = logger("fleet")
        self.run_id = jsonlog.new_run_id()
        # lease/4 keeps three missable beats of margin before expiry.
        self.heartbeat_sec = cfg.fleet_heartbeat_sec or \
            max(queue.lease_sec / 4.0, 0.05)
        plan = faultlib.FaultPlan.from_config(cfg)
        self._lease_inj = plan.injector("lease") if plan is not None \
            else None
        self.handlers = handlers if handlers is not None else {
            "detect": self._run_detect,
            "stream": self._run_stream,
            "classify": self._run_classify,
            "product": self._run_product,
            "repair": self._run_repair,
            "pyramid": self._run_pyramid,
            "fanout": self._run_fanout,
        }
        self.counters = Counters()
        # Worker-local tallies: the obs registry resets when a job runs
        # a full driver (stream), so /progress and the exit summary read
        # these instead.  Mutation on the worker loop thread only.
        self.tallies = {k: 0 for k in
                        ("claimed", "acked", "lost", "requeued", "dead")}
        self._current: dict | None = None   # worker loop thread only

    # -- progress surface --------------------------------------------------

    def fleet_block(self) -> dict:
        """The /progress ``fleet`` sub-document: the shared queue's
        status plus this worker's identity and tallies."""
        s = self.queue.status()
        s["worker"] = {"id": self.worker_id, "run_id": self.run_id,
                       "tallies": dict(self.tallies),
                       "current_job": self._current}
        return s

    # -- the loop ----------------------------------------------------------

    def run(self, *, max_jobs: int | None = None,
            until_drained: bool = False, forever: bool = False,
            stop=None) -> dict:
        """Drain the queue.  Default: exit when nothing is claimable.
        ``until_drained``: poll until every job is done or dead (exits
        early — wedged — when the only remaining jobs are blocked behind
        dead dependencies, which polling can never fix).  ``forever``:
        a STANDING worker — keep polling through an empty queue (the
        steady-state streaming fleet: the acquisition watcher feeds
        jobs as scenes land) until ``stop`` (a threading.Event) is set
        or the process is signalled."""
        executed = 0
        wedged = False
        # Register in the queue's worker table (docs/ROBUSTNESS.md
        # "Elastic operation"): the supervisor's adoption source and
        # `fleet status`'s per-worker rows.  Registration failure must
        # not stop a worker from draining — it just becomes invisible
        # to the elastic layer.
        try:
            self.queue.worker_register(self.worker_id, os.getpid(),
                                       kind=self.kind, host=jsonlog.HOST)
        except Exception as e:
            self.log.warning("worker registration failed (%s: %s)",
                             type(e).__name__, e)
        while (max_jobs is None or executed < max_jobs) \
                and not (stop is not None and stop.is_set()):
            lease = self.queue.claim(self.worker_id)
            if lease is None:
                # Beat on the idle branches too: an idle --hold-idle /
                # --forever worker would otherwise read as dead in
                # `fleet status` (beat_age growing for hours) and could
                # never run the re-register-on-pruned recovery below.
                self._worker_beat()
                if forever:
                    self._sleep(self.poll_sec)
                    continue
                if not until_drained or self.queue.drained():
                    break
                if self.queue.wedged():
                    # Every pending job is blocked behind a DEAD
                    # dependency and nobody holds a lease: polling can
                    # never unwedge this — an operator must requeue the
                    # dead upstream jobs.  (wedged() re-evaluates
                    # claimability in one queue snapshot, so an ack
                    # racing this worker's failed claim reads as
                    # claimable, not wedged.)
                    self.log.error(
                        "fleet wedged: pending jobs all blocked behind "
                        "dead/unmet dependencies (%s)",
                        self.queue.counts())
                    wedged = True
                    break
                self._sleep(self.poll_sec)
                continue
            self.execute(lease)
            executed += 1
            self._worker_beat()
        summary = {"worker": self.worker_id, "executed": executed,
                   "wedged": wedged, **self.tallies,
                   "queue": self.queue.counts(),
                   "fence_rejects": self.queue.fence_rejects()}
        # Clean exit: the registry row goes away.  A worker that dies
        # before reaching this leaves its row behind — that is the
        # supervisor's abnormal-exit signal (crash-loop circuit).
        try:
            self.queue.worker_deregister(self.worker_id)
        except Exception:
            pass
        self.log.info("fleet worker done: %s", summary)
        return summary

    def _worker_beat(self) -> None:
        """Refresh this worker's registry row (liveness + ack tally);
        best-effort — a locked queue just ages the beat.  A beat that
        matches no row means a supervisor pruned us (a recycled-pid or
        EPERM misread): re-register, or this live worker stays
        invisible to adoption and gets double-spawned over."""
        try:
            if not self.queue.worker_beat(self.worker_id,
                                          acked=self.tallies["acked"]):
                self.queue.worker_register(self.worker_id, os.getpid(),
                                           kind=self.kind,
                                           host=jsonlog.HOST)
        except Exception:
            pass

    def execute(self, lease: Lease) -> None:
        """One leased job end-to-end: heartbeat thread up, handler run
        under its own trace context, then ack / fail / abandon."""
        self.tallies["claimed"] += 1
        self._current = {"job": lease.job_id, "type": lease.job_type,
                         "fence": lease.fence}
        flightrec.mark("fleet_claim", job=lease.job_id,
                       type=lease.job_type, fence=lease.fence,
                       attempt=lease.attempts)
        self.log.info("claimed job %d (%s, fence %d, attempt %d/%d)",
                      lease.job_id, lease.job_type, lease.fence,
                      lease.attempts, lease.max_attempts)
        stop = threading.Event()
        hb = threading.Thread(target=self._heartbeat_loop,
                              args=(lease, stop),
                              name=f"fleet-heartbeat-{lease.job_id}",
                              daemon=True)
        hb.start()
        # Adopt the ENQUEUER's trace context when the payload carries
        # one (the watcher stamps a per-scene id; queue re-delivery
        # preserves the payload verbatim) — the job's spans, alert rows,
        # and log lines then join the scene's cross-process causal
        # chain.  Payloads without one (operator enqueues, repair jobs)
        # keep the minted per-job id.
        wire = lease.payload.get(tracing.TRACE_KEY) \
            if isinstance(lease.payload, dict) else None
        ctx = tracing.from_wire(wire, run_id=self.run_id) \
            or tracing.TraceContext(tracing.new_batch_id(self.run_id),
                                    run_id=self.run_id)
        obs_spool.mark("job_claimed", trace=ctx.batch_id,
                       job=lease.job_id, type=lease.job_type,
                       fence=lease.fence, attempt=lease.attempts)
        def stop_heartbeat() -> None:
            # BEFORE ack/fail, not just in the finally: a beat racing
            # the resolution finds the lease already cleared and would
            # record a phantom durable fence-rejection + 'lease lost'
            # flightrec mark on a perfectly healthy job.  The lease has
            # multiple beats of margin, so stopping early is safe.
            stop.set()
            hb.join(timeout=max(self.heartbeat_sec * 4, 1.0))

        try:
            handler = self.handlers.get(lease.job_type)
            if handler is None:
                raise ValueError(
                    f"no handler for job type {lease.job_type!r}")
            with tracing.activate(ctx):
                with tracing.span("fleet_job", job=lease.job_id,
                                  type=lease.job_type), \
                        obs_metrics.timer() as tm:
                    handler(lease.payload, lease)
                # Inside the activation on purpose: the histogram's
                # slowest-N exemplars carry this job's trace id.
                obs_metrics.histogram(
                    f"fleet_job_seconds_{lease.job_type}").observe(
                    tm.elapsed)
            stop_heartbeat()
            self.queue.ack(lease)
            self.tallies["acked"] += 1
            flightrec.mark("fleet_ack", job=lease.job_id,
                           fence=lease.fence)
            obs_spool.mark("job_acked", trace=ctx.batch_id,
                           job=lease.job_id, type=lease.job_type)
            self.log.info("acked job %d (%.2fs)", lease.job_id, tm.elapsed)
        except (StaleFence, StaleObjectFence, LeaseLost) as e:
            # The job is a successor's now: abandon it quietly — no
            # fail() (our token could not record one anyway), no
            # quarantine records, just the loss accounting.
            self.tallies["lost"] += 1
            obs_metrics.counter(
                "fleet_jobs_lost",
                help="jobs abandoned after lease loss (zombie fenced "
                     "off its output)").inc()
            flightrec.mark("fleet_lease_lost", job=lease.job_id,
                           fence=lease.fence, error=type(e).__name__)
            self.log.warning(
                "job %d abandoned, lease lost mid-flight (%s: %s) — a "
                "successor owns it now", lease.job_id,
                type(e).__name__, e)
        except Exception as e:
            stop_heartbeat()
            try:
                state = self.queue.fail(lease, e)
            except (StaleFence, StaleObjectFence):
                self.tallies["lost"] += 1
                flightrec.mark("fleet_lease_lost", job=lease.job_id,
                               fence=lease.fence, error=type(e).__name__)
                self.log.warning(
                    "job %d failed (%s: %s) AND its lease lapsed — "
                    "abandoned", lease.job_id, type(e).__name__, e)
            else:
                self.tallies["requeued" if state == "pending"
                             else "dead"] += 1
                flightrec.mark("fleet_job_failed", job=lease.job_id,
                               state=state, error=type(e).__name__)
                self.log.error(
                    "job %d failed (%s: %s) -> %s (attempt %d/%d)",
                    lease.job_id, type(e).__name__, e, state,
                    lease.attempts, lease.max_attempts)
        finally:
            stop_heartbeat()                  # idempotent backstop
            self._current = None

    # -- heartbeats --------------------------------------------------------

    def _beat(self, lease: Lease) -> bool | None:
        """One heartbeat attempt: True extended, False skipped (injected
        fault or queue I/O blip — the lease just ages), None lost."""
        try:
            if self._lease_inj is not None:
                self._lease_inj.fire()
            self.queue.heartbeat(lease)
            # Piggyback the worker-registry beat on the lease beat so a
            # long job's row stays fresh in `fleet status`.
            self._worker_beat()
            return True
        except LeaseLost:
            return None
        except Exception as e:
            self.log.warning("heartbeat for job %d failed (%s: %s); "
                             "lease ages on", lease.job_id,
                             type(e).__name__, e)
            return False

    def _heartbeat_loop(self, lease: Lease, stop: threading.Event) -> None:
        # No side-channel to the job thread on loss: the job discovers
        # it through the fence — its next store write raises StaleFence
        # and the chunk loop's peek_error poll aborts the rest.
        while not stop.wait(self.heartbeat_sec):
            ok = self._beat(lease)
            if ok is None:
                flightrec.mark("fleet_lease_lost", job=lease.job_id,
                               fence=lease.fence, error="LeaseLost")
                self.log.warning(
                    "job %d: heartbeat found the lease gone (expired and "
                    "re-claimed); writes will fence off", lease.job_id)
                return

    # -- job handlers ------------------------------------------------------

    def _fenced_store(self, lease: Lease):
        # The store (its schema names the detector's table frames) and the
        # drivers import torch: the handlers import them, so the queue
        # commands that import this module start without it.
        from firebird_tpu_torch.store import open_store

        raw = open_store(self.cfg.store_backend, self.cfg.store_path,
                         self.cfg.keyspace())
        return raw, FencedStore(raw, self.queue, lease)

    def _run_detect(self, payload: dict, lease: Lease) -> None:
        """One changedetection chunk: the promoted driver loop
        (core.run_chunk) against a fenced store, with the re-delivery
        fast path (already-stored chips skip, quarantine entries for
        landed chips drain).

        A ``bootstrap: true`` payload is the acquisition watcher's
        stream-bootstrap flavor (streamops/watcher.py): ONE chip that
        needs batch detection AND a seeded stream checkpoint before its
        dep'd stream job can run — exactly what the repair path does
        (alerts/repair.repair_chip: fenced batch re-detection + fresh
        checkpoint), so it routes there instead of run_chunk."""
        from firebird_tpu_torch.driver import core as dcore
        from firebird_tpu_torch.driver import quarantine as qlib

        if payload.get("bootstrap"):
            return self._run_repair(payload, lease)

        # Stamp the lease's fencing token into run_manifest.json: the
        # store-adjacent record of which lease last owned this output
        # (monotonic — a zombie's re-stamp cannot roll it back).
        qlib.stamp_manifest_fence(self.cfg, lease.fence,
                                  run_id=self.run_id,
                                  acquired=payload.get("acquired"))
        raw, fenced = self._fenced_store(lease)
        source, store, writer, policy, breaker, quarantine = \
            dcore.robustness_setup(self.cfg, self.run_id, store=fenced)
        try:
            cids = [tuple(int(v) for v in c) for c in payload["cids"]]
            have = store.chip_ids("segment")
            todo = [c for c in cids if c not in have]
            if len(todo) < len(cids):
                self.log.info(
                    "job %d re-delivery: %d of %d chips already stored",
                    lease.job_id, len(cids) - len(todo), len(cids))
            if todo:
                dcore.run_chunk(
                    todo, source=source, writer=writer,
                    acquired=payload["acquired"], cfg=self.cfg,
                    counters=self.counters, log=self.log, policy=policy,
                    quarantine=quarantine, reraise=True, device=self.device)
            # Redeem dead letters for the chips that are STORED — the
            # skipped fast-path ones here; run_chunk discards the ones
            # it just processed itself.  Chips quarantined THIS run
            # (fetch failures) must keep their entries: the job acks
            # minus its dead letters, and the ledger is the record of
            # what a re-enqueued plan still owes.
            quarantine.discard_many([c for c in cids if c not in todo])
        finally:
            writer.close()
            raw.close()

    def _run_stream(self, payload: dict, lease: Lease) -> None:
        """A streaming-update pass over one tile through the stream
        driver (its own checkpoints + publish path), fenced.  The job
        runs with ``ops_port=0``: the WORKER owns this process's ops
        surface, and a nested driver bring-up binding the same port
        would EADDRINUSE-fail the job on every delivery."""
        import dataclasses

        from firebird_tpu_torch.driver import stream as sdrv

        raw, fenced = self._fenced_store(lease)
        try:
            sdrv.stream(x=payload["x"], y=payload["y"],
                        acquired=payload.get("acquired"),
                        number=int(payload.get("number", 2500)),
                        # Watcher-shaped jobs scope the pass to the
                        # scene's affected chips and carry its publish
                        # timestamp for the acquisition_to_alert_seconds
                        # freshness histogram.
                        cids=payload.get("cids"),
                        published=payload.get("published"),
                        cfg=dataclasses.replace(self.cfg, ops_port=0),
                        store=fenced, reset_metrics=False,
                        device=self.device)
        finally:
            raw.close()
            self._restore_status()

    def _run_classify(self, payload: dict, lease: Lease) -> None:
        """Train + classify one tile (rf/pipeline.classify_tile) — the
        job fleet/plan.py unblocks when the tile's detection acks."""
        from firebird_tpu_torch.driver import core as dcore
        from firebird_tpu_torch.rf import pipeline as rf_pipeline
        from firebird_tpu_torch.store import AsyncWriter

        raw, fenced = self._fenced_store(lease)
        writer = AsyncWriter(
            fenced, retry=retrylib.RetryPolicy.for_store(self.cfg))
        try:
            rf_pipeline.classify_tile(
                x=payload["x"], y=payload["y"],
                msday=int(payload["msday"]), meday=int(payload["meday"]),
                acquired=payload["acquired"],
                aux_source=dcore.make_aux_source(self.cfg),
                store=fenced, writer=writer,
                number=payload.get("number"), device=self.device)
        finally:
            writer.close()
            raw.close()

    def _run_repair(self, payload: dict, lease: Lease) -> None:
        """Cold-path repair of one needs_batch chip (alerts/repair.py):
        batch re-detection + a fresh stream checkpoint, BOTH outputs
        fenced — store rows through FencedStore, the checkpoint .npz
        through a fence check right before its atomic save, so a zombie
        whose lease lapsed cannot rewind a successor's (or a live
        stream's) checkpoint.  Idempotent by construction — a
        re-delivered repair recomputes the same deterministic result
        over the same acquired range."""
        from firebird_tpu_torch.alerts import repair as repairlib

        def fence_guard() -> None:
            if not self.queue.fence_valid(lease.job_id, lease.fence):
                self.queue.record_fence_reject(lease, op="write")
                raise StaleFence(
                    f"repair checkpoint save rejected: job "
                    f"{lease.job_id} fence {lease.fence} is stale")

        raw, fenced = self._fenced_store(lease)
        try:
            repairlib.repair_chip(
                self.cfg, (payload["cx"], payload["cy"]),
                payload["acquired"], store=fenced,
                fence_guard=fence_guard, device=self.device)
        finally:
            raw.close()

    def _run_product(self, payload: dict, lease: Lease) -> None:
        """Product rasters over the job's bounds (products.save)."""
        from firebird_tpu_torch import products

        raw, fenced = self._fenced_store(lease)
        try:
            products.save(
                bounds=[tuple(b) for b in payload["bounds"]],
                products=list(payload["products"]),
                product_dates=list(payload["product_dates"]),
                acquired=payload.get("acquired"), cfg=self.cfg,
                store=fenced, device=self.device)
        finally:
            raw.close()

    def _run_pyramid(self, payload: dict, lease: Lease) -> None:
        """Precompute pyramid tiles over the job's bounds
        (serve/pyramid.py build_area) — the hot-region materializer the
        serving fleet's cold-miss depth floor points at.  Product rows
        computed along the way persist through the FENCED store (a
        zombie's store writes reject); the tile files themselves are
        idempotent atomic replaces, safe under re-delivery.  Host work:
        the rows it reads are the ones the detector wrote on the card."""
        from firebird_tpu_torch.serve import pyramid as pyrlib

        root = payload.get("root") or pyrlib.pyramid_root(self.cfg)
        if root is None:
            raise ValueError(
                "pyramid job has no root: set FIREBIRD_SERVE_PYRAMID_DIR "
                "(or a file-backed store) or put 'root' in the payload")
        raw, fenced = self._fenced_store(lease)
        try:
            pyr = pyrlib.TilePyramid(
                root, pyrlib.store_read_chip(
                    fenced, compute=bool(payload.get("compute", True))),
                storage=pyrlib.pyramid_storage(self.cfg, root))
            summary = pyr.build_area(
                list(payload["products"]),
                list(payload["product_dates"]),
                [tuple(b) for b in payload["bounds"]],
                levels=int(payload.get("levels", 2)),
                refresh=bool(payload.get("refresh", False)))
            self.log.info("pyramid job %d built: %s", lease.job_id,
                          summary)
        finally:
            raw.close()

    def _run_fanout(self, payload: dict, lease: Lease) -> None:
        """Drain one quadkey shard's alert fanout (alerts/fanout.py):
        the job's audience (cell-index probe of its alert window) plus
        the shard's stragglers advance from their durable per-shard
        cursors to the job's ``upto`` bound.  No FencedStore — webhook
        POSTs are not fenceable writes; re-delivery safety is the
        forward-only cursor + record-id contract, so a SIGKILLed
        worker's successor (or an overlapping zombie) resumes delivery
        without duplicating records at the receiver.  Host only: the
        worker's card is not touched."""
        from firebird_tpu_torch.alerts import fanout as fanoutlib
        from firebird_tpu_torch.alerts.log import AlertLog, alert_db_path

        path = alert_db_path(self.cfg)
        if path is None:
            raise ValueError(
                "fanout job has no alert log: set FIREBIRD_ALERT_DB "
                "(or a file-backed store)")
        alog = AlertLog(path)
        try:
            deliverer = fanoutlib.FanoutDeliverer(alog, self.cfg)
            delivered = deliverer.drain_shard(
                payload["shard"], int(payload["upto"]),
                since=int(payload.get("since", 0)))
        finally:
            alog.close()
        rolled = payload.get("rolled_at")
        if rolled is not None:
            obs_metrics.histogram(
                "fanout_completion_seconds",
                help="rollup-to-drained latency of one shard fanout "
                     "job (the fanout_p99 SLO's metric)").observe(
                max(time.time() - float(rolled), 0.0))
        self.log.info("fanout job %d drained shard %r to %d "
                      "(%d records delivered)", lease.job_id,
                      payload["shard"], int(payload["upto"]), delivered)

    def _restore_status(self) -> None:
        """Re-register the worker's process-global obs state after a
        full-driver job (stream): its stop_ops tears down the RunStatus,
        DISARMS the flight recorder, and clears the jsonlog run context
        — all of which belong to the worker for the rest of its life (a
        later worker crash must still leave a postmortem, and later log
        lines must still carry the worker's run id)."""
        from firebird_tpu_torch.driver import quarantine as qlib

        st = getattr(self, "_status", None)
        if st is not None and obs_server.current() is None:
            obs_server.set_status(st)
        jsonlog.set_run_context(run_id=self.run_id)
        if st is not None and self.cfg.flightrec > 0 \
                and flightrec.active() is None:
            try:
                flightrec.arm(flightrec.postmortem_path(self.cfg),
                              ring=self.cfg.flightrec, run_id=self.run_id,
                              fingerprint=qlib.config_fingerprint(self.cfg))
            except Exception as e:
                self.log.warning("flight recorder re-arm failed: %s", e)

    # -- ops surface -------------------------------------------------------

    def start_ops(self):
        """Bring up the worker's live ops surface (the driver bring-up,
        fleet-flavored), after building the kernels its device runs (a
        short FIREBIRD_STALL_SEC must not be tripped by ``nvcc``):
        /progress gains the fleet block, the flight recorder arms, and
        FIREBIRD_OPS_PORT binds the endpoint.  Returns (status, server,
        watchdog) for stop_ops."""
        from firebird_tpu_torch.driver import core as dcore

        dcore.build_kernels(self.device, self.cfg, self.log)
        run_block = {"kind": "fleet-worker", "run_id": self.run_id,
                     "host": jsonlog.HOST, "worker_id": self.worker_id,
                     "queue": self.queue.path, "device": str(self.device)}
        status, server, watchdog = dcore.start_ops(
            self.cfg, self.run_id, "fleet-worker", chips_total=0,
            counters=self.counters, run_block=run_block,
            fleet=self.fleet_block)
        self._status = status
        return status, server, watchdog

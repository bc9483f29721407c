"""Crash flight recorder: per-thread event rings + postmortem.json.

The port's own copy of the JAX package's ``obs/flightrec.py``: the same
rings, hooks and bundle schema, the bundle's ``device`` section naming
the card (``torch.cuda.get_device_name``) or the CPU.

A dead soak is today diagnosable only by rerunning it: the obs report
and trace are written at run *end*, so a run killed by SIGTERM, wedged
into a watchdog stall, or felled by an unhandled exception leaves
nothing but whatever stderr survived.  This module is the black box the
crash leaves behind: while armed (driver bring-up, ``FIREBIRD_FLIGHTREC``
ring size, default on) every thread keeps a bounded ring of its recent
events — spans (obs/tracing.py feeds them even when no tracer runs),
log lines (a handler on the ``firebird`` root logger), and driver
progress marks (stage changes, batch dispatch/done) — and on

- an **unhandled exception** (``sys.excepthook`` + ``threading.excepthook``,
  plus the drivers' own ``stop_ops`` exception check),
- a **watchdog stall** (obs/watchdog.py calls :func:`on_stall` when it
  declares one), or
- **SIGTERM** (handler installed while armed, main thread only)

a single ``postmortem.json`` bundle is written next to the results
store: the last N events per thread, the run's progress/degraded state
(breaker, quarantine, watchdog incl. throughput-drop events), the full
metrics snapshot (queue depths ride along as gauges), and the config
fingerprint — enough to say *where every thread was* without rerunning.

Cost while armed: one deque append per span/log/mark (deque appends are
GIL-atomic; no lock on the hot path), zero when disarmed (one global
read at each feed site).
"""

from __future__ import annotations

import collections
import datetime
import json
import logging
import os
import signal
import sys
import threading
import time
import traceback

from firebird_tpu_torch.obs import tracing

SCHEMA = "firebird-postmortem/1"


def _now_iso() -> str:
    return datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")


class _RingHandler(logging.Handler):
    """Feeds formatted-enough log records into the recorder's rings."""

    def __init__(self, rec: "FlightRecorder"):
        super().__init__(level=logging.DEBUG)
        self._rec = rec

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._rec.log_event(record.levelname, record.name,
                                record.getMessage())
        except Exception:
            pass                     # the black box must never crash a run


class FlightRecorder:
    """Bounded per-thread event rings + the postmortem dump.

    ``path`` is where ``postmortem.json`` lands (None keeps the rings
    in memory only — memory-backend runs, unit tests poking ``bundle``).
    """

    def __init__(self, path: str | None, ring: int = 128, *,
                 run_id: str = "", fingerprint: str = ""):
        self.path = path
        self.ring = max(int(ring), 1)
        self.run_id = run_id
        self.fingerprint = fingerprint
        self._lock = threading.Lock()
        self._rings: dict[str, collections.deque] = {}  # guarded-by: _lock
        self._local = threading.local()
        self._dumps = 0  # guarded-by: _lock
        self._reasons: list[str] = []  # guarded-by: _lock

    def _ring(self) -> collections.deque:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            name = threading.current_thread().name
            with self._lock:
                ring = self._rings.get(name)
                if ring is None:
                    ring = self._rings[name] = collections.deque(
                        maxlen=self.ring)
            self._local.ring = ring
        return ring

    def _append(self, ev: dict) -> None:
        ctx = tracing.current_context()
        if ctx is not None:
            ev["batch"] = ctx.batch_id
        ev["t"] = time.time()
        self._ring().append(ev)        # deque append: GIL-atomic

    # -- feeds (span hook installed via tracing.set_recorder) ---------------

    def span_event(self, name: str, dur_ms: float,
                   batch: str | None) -> None:
        ev = {"kind": "span", "name": name, "ms": round(dur_ms, 3)}
        if batch is not None:
            ev["batch"] = batch
        ev["t"] = time.time()
        self._ring().append(ev)

    def log_event(self, level: str, logger_name: str, message: str) -> None:
        self._append({"kind": "log", "level": level, "logger": logger_name,
                      "message": message[:500]})

    def mark(self, name: str, **fields) -> None:
        """A driver progress mark (stage change, batch dispatched/done)."""
        self._append({"kind": "mark", "name": name, **fields})

    # -- the bundle ----------------------------------------------------------

    def bundle(self, reason: str, exc: BaseException | None = None) -> dict:
        from firebird_tpu_torch.obs import metrics as obs_metrics
        from firebird_tpu_torch.obs import server as obs_server

        with self._lock:
            threads = {name: list(ring)
                       for name, ring in self._rings.items()}
            self._reasons.append(reason)
            reasons = list(self._reasons)
        out = {
            "schema": SCHEMA,
            "written_at": _now_iso(),
            "reason": reason,
            "reasons": reasons,
            "run_id": self.run_id,
            "config_fingerprint": self.fingerprint,
            "threads": threads,
            "live_threads": sorted(t.name for t in threading.enumerate()),
        }
        if exc is not None:
            out["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc)[:1200],
                "traceback": traceback.format_exception(
                    type(exc), exc, exc.__traceback__)[-20:],
            }
        # Best-effort context: a half-dead process must still dump what
        # it can — each block degrades independently.
        try:
            from firebird_tpu_torch.obs import report as obs_report
            out["device"] = obs_report.device_block()
        except Exception:
            out["device"] = None
        try:
            out["metrics"] = obs_metrics.get_registry().snapshot()
        except Exception:
            out["metrics"] = None
        try:
            st = obs_server.current()
            out["progress"] = st.progress() if st is not None else None
        except Exception:
            out["progress"] = None
        return out

    def dump(self, reason: str, exc: BaseException | None = None) -> dict:
        """Write the postmortem bundle (atomic tmp+rename) and return it.
        Multiple dumps in one run overwrite — the last state wins, with
        every trigger recorded under ``reasons``.  Never raises."""
        doc = self.bundle(reason, exc)
        with self._lock:
            self._dumps += 1
        if self.path is None:
            return doc
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=str)
            os.replace(tmp, self.path)
            from firebird_tpu_torch.obs import metrics as obs_metrics
            obs_metrics.counter(
                "postmortems_written",
                help="postmortem.json bundles written by the flight "
                     "recorder").inc()
            from firebird_tpu_torch.obs import logger
            logger("change-detection").error(
                "flight recorder: postmortem (%s) written to %s",
                reason, self.path)
        except Exception:
            pass                     # the black box must never crash a run
        return doc


# ---------------------------------------------------------------------------
# Process-global arming (driver bring-up; one recorder per run)
# ---------------------------------------------------------------------------

# Mutated only by arm()/disarm() from the run-owning thread; the feed
# sites read the one reference lock-free (same discipline as
# obs/server.py's _status).
_recorder: FlightRecorder | None = None
_prev_hooks: dict = {}


def active() -> FlightRecorder | None:
    return _recorder


def postmortem_path(cfg) -> str | None:
    """Where a run's postmortem.json lands: next to the results store
    (the quarantine/manifest rule), None for the memory backend."""
    from firebird_tpu_torch.driver import quarantine as qlib

    d = qlib._artifact_dir(cfg)
    return None if d is None else os.path.join(d, "postmortem.json")


def arm(path: str | None, ring: int = 128, *, run_id: str = "",
        fingerprint: str = "") -> FlightRecorder:
    """Install a fresh recorder as the process flight recorder: span and
    log feeds attach, and the crash hooks (excepthook, threading
    excepthook, SIGTERM when on the main thread) chain to the previous
    handlers.  Re-arming replaces the previous recorder."""
    global _recorder
    if _recorder is not None:
        disarm()
    rec = FlightRecorder(path, ring, run_id=run_id, fingerprint=fingerprint)
    _recorder = rec  # firebird-lint: disable=ownership-global-mutation
    tracing.set_recorder(rec)

    handler = _RingHandler(rec)
    logging.getLogger("firebird").addHandler(handler)
    _prev_hooks["log_handler"] = handler

    prev_except = sys.excepthook

    def _excepthook(etype, value, tb):
        rec.dump("unhandled_exception", value)
        prev_except(etype, value, tb)

    sys.excepthook = _excepthook
    _prev_hooks["excepthook"] = prev_except

    prev_thread = threading.excepthook

    def _thread_excepthook(args):
        # SystemExit from a cleanly-stopped thread is not a crash.
        if args.exc_type is not SystemExit:
            rec.dump("unhandled_exception", args.exc_value)
        prev_thread(args)

    threading.excepthook = _thread_excepthook
    _prev_hooks["thread_excepthook"] = prev_thread

    if threading.current_thread() is threading.main_thread():
        try:
            prev_sig = signal.getsignal(signal.SIGTERM)

            def _on_sigterm(signum, frame):
                # The handler runs ON the main thread between bytecodes,
                # possibly while that thread holds a metrics/status lock
                # (Histogram.observe, RunStatus.batch_dispatched) that
                # bundle() needs — dumping inline could deadlock on a
                # non-reentrant lock our own paused frame owns.  Dump on
                # a helper thread with a bounded wait instead: the
                # common case (no lock held) completes in milliseconds;
                # the pathological case forfeits the bundle (the atomic
                # tmp+rename never lands a partial one) but the process
                # STILL dies with real SIGTERM semantics below.
                t = threading.Thread(target=rec.dump, args=("sigterm",),
                                     name="firebird-postmortem",
                                     daemon=True)
                t.start()
                t.join(timeout=10.0)
                # Restore and re-raise so the process dies with real
                # SIGTERM semantics (exit code 143, supervisors see it).
                signal.signal(signal.SIGTERM, prev_sig or signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_sigterm)
            _prev_hooks["sigterm"] = prev_sig
        except (ValueError, OSError):
            pass            # non-main thread / exotic platform: no signal
    return rec


def disarm() -> FlightRecorder | None:
    """Detach the recorder and restore every hook; returns it (rings
    intact) so a caller can still dump after disarming."""
    global _recorder
    rec = _recorder
    _recorder = None  # firebird-lint: disable=ownership-global-mutation
    tracing.set_recorder(None)
    handler = _prev_hooks.pop("log_handler", None)
    if handler is not None:
        logging.getLogger("firebird").removeHandler(handler)
    prev = _prev_hooks.pop("excepthook", None)
    if prev is not None:
        sys.excepthook = prev
    prev = _prev_hooks.pop("thread_excepthook", None)
    if prev is not None:
        threading.excepthook = prev
    if "sigterm" in _prev_hooks:
        prev = _prev_hooks.pop("sigterm")
        try:
            signal.signal(signal.SIGTERM, prev or signal.SIG_DFL)
        except (ValueError, OSError):
            pass
    return rec


# Module-level feed hooks: one global read + None check when disarmed —
# the obs/server progress hooks and watchdog call these unconditionally.

def mark(name: str, **fields) -> None:
    rec = _recorder
    if rec is not None:
        rec.mark(name, **fields)


def on_stall(age_sec: float, deadline_sec: float) -> None:
    """The watchdog's stall trigger: dump once per declared episode."""
    rec = _recorder
    if rec is not None:
        rec.dump("watchdog_stall")
        rec.mark("stall", age_sec=round(age_sec, 3),
                 deadline_sec=deadline_sec)


def dump_if_armed(reason: str, exc: BaseException | None = None) -> None:
    """The drivers' teardown check (stop_ops): when a run is unwinding on
    an exception, the bundle must be written BEFORE disarming."""
    rec = _recorder
    if rec is not None:
        rec.dump(reason, exc)

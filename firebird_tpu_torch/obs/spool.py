"""Durable per-process telemetry spool: the fleet telemetry plane's disk leg.

The port's own copy of the JAX package's ``obs/spool.py``, whole: it
writes the JAX segment format line for line (file names, header, event
keys in the same order, snapshot lines), so either package's collector
reads the other's spool.  The span tracer exports at run end, the metrics
registry dies with its process, and the flight recorder dumps only on
signals it can catch — a SIGKILLed fleet worker takes its telemetry with
it.  The spool closes that gap: every fleet-role process (``fleet work``,
``fleet supervise``) appends its span/mark events and periodic
metric-registry snapshots to a bounded ring of JSONL segment files next
to the store, flushed per line, so whatever survives the process is
already on disk for ``trace collect`` (obs/collect.py).

Design points:

- **Bounded.**  ``FIREBIRD_TELEMETRY`` events per segment times
  ``FIREBIRD_TELEMETRY_SEGMENTS`` segment files per process; a full
  segment seals and the ring truncate-reopens the oldest.  A standing
  watcher cannot grow telemetry without bound.
- **Crash-safe.**  Append-only JSON lines, ``flush()`` per event: the
  data reaches the OS before the next span runs, so SIGKILL loses at
  most the line being formatted.  No fsync — a host power loss may drop
  the tail, which is telemetry-grade acceptable (the flight recorder +
  postmortem path owns crash forensics).
- **Self-describing.**  Every segment opens with a header line stamping
  pid/role/run_id/host, so the collector needs no side index and a
  stray segment from a dead pid still attributes correctly.
- **Zero-cost disarmed.**  Arming installs the spool as a tracing span
  sink (tracing.set_spool); disarmed, ``tracing.span()`` keeps its
  one-global-read no-op gate and :func:`mark` is one module read + None
  check — the FIREBIRD_TELEMETRY=0 hot path is byte-identical to the
  pre-spool one.
"""

from __future__ import annotations

import json
import os
import threading
import time

from firebird_tpu_torch.obs import jsonlog
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import tracing

SPOOL_SCHEMA = "firebird-telemetry-spool/1"

# Segment file name: spool.<role>.<pid>.<segment>.jsonl — the glob the
# collector scans.  role/pid in the NAME (not only the header) lets a
# reader group files without parsing every segment.
SPOOL_GLOB = "spool.*.jsonl"

# Fleet roles that arm by default (the JAX package's; this package's
# command line arms "worker" and "supervisor"): the standing
# multi-process fleet whose telemetry would otherwise die with each
# process.
FLEET_ROLES = ("watcher", "worker", "supervisor", "deliverer", "serve",
               "prober")


def spool_dir(cfg) -> str | None:
    """The spool directory for a config: ``cfg.telemetry_dir`` when
    set, else ``telemetry/`` next to the results store (the
    quarantine.json placement rule — None for the memory backend, which
    has no cross-process 'next to')."""
    if cfg.telemetry_dir:
        return cfg.telemetry_dir
    from firebird_tpu_torch.driver import quarantine as qlib

    d = qlib._artifact_dir(cfg)
    return None if d is None else os.path.join(d, "telemetry")


class TelemetrySpool:
    """One process's append-only telemetry spool (a bounded segment
    ring).  Thread-safe: span exits arrive from every pipeline thread."""

    def __init__(self, directory: str, role: str, run_id: str | None = None,
                 *, events_per_segment: int = 4096, segments: int = 4,
                 snapshot_sec: float = 5.0):
        if events_per_segment < 1:
            raise ValueError("events_per_segment must be >= 1, got "
                             f"{events_per_segment}")
        if segments < 2:
            raise ValueError(f"segments must be >= 2, got {segments}")
        self.dir = directory
        self.role = role
        self.run_id = run_id
        self.pid = os.getpid()
        self.events_per_segment = int(events_per_segment)
        self.segments = int(segments)
        self.snapshot_sec = float(snapshot_sec)
        self._lock = threading.Lock()
        self._seg = 0          # guarded-by: _lock
        self._n = 0            # guarded-by: _lock
        self._f = None         # guarded-by: _lock
        self._last_snap = 0.0  # guarded-by: _lock
        self._dropped = 0      # guarded-by: _lock (I/O errors, not ring)
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self._open_segment(0)

    # -- segment ring ------------------------------------------------------

    def segment_path(self, seg: int) -> str:
        return os.path.join(
            self.dir, f"spool.{self.role}.{self.pid}.{seg}.jsonl")

    def _open_segment(self, seg: int) -> None:
        # guarded-by: _lock (callers hold it)
        if self._f is not None:
            self._f.close()
        self._seg = seg
        self._n = 0
        self._f = open(self.segment_path(seg), "w")
        header = {"kind": "header", "schema": SPOOL_SCHEMA,
                  "pid": self.pid, "role": self.role,
                  "run_id": self.run_id, "host": jsonlog.HOST,
                  "segment": seg, "t": time.time()}
        self._f.write(json.dumps(header, separators=(",", ":")) + "\n")
        self._f.flush()

    def _write(self, doc: dict) -> None:
        line = json.dumps(doc, separators=(",", ":"), default=str)
        with self._lock:
            if self._f is None:      # closed: late span from a worker
                return               # thread during teardown
            try:
                if self._n >= self.events_per_segment:
                    self._open_segment((self._seg + 1) % self.segments)
                self._f.write(line + "\n")
                self._f.flush()
                self._n += 1
            except OSError:
                # Disk trouble must degrade telemetry, never the
                # pipeline writing it (the alert-log unavailable rule).
                self._dropped += 1

    # -- event feeds -------------------------------------------------------

    def span_event(self, name: str, dur_s: float,
                   trace: str | None) -> None:
        """The tracing span sink (tracing.set_spool): one closed span.
        Wall-clock start is derived (now - dur) so the collector can
        place spans from different processes on one absolute axis."""
        t1 = time.time()
        self._write({"kind": "span", "name": name,
                     "t0": t1 - dur_s, "dur": dur_s, "trace": trace,
                     "tid": threading.get_ident(),
                     "thread": threading.current_thread().name})
        self._maybe_snapshot(t1)

    def mark(self, name: str, *, trace: str | None = None,
             t: float | None = None, **attrs) -> None:
        """An instant event — the cross-process causal-chain joints
        (scene_enqueued, job_claimed, alert_appended, alert_delivered)
        the critical-path breakdown is computed from."""
        doc = {"kind": "mark", "name": name, "t": time.time()
               if t is None else float(t), "trace": trace,
               "tid": threading.get_ident()}
        if attrs:
            doc["attrs"] = attrs
        self._write(doc)

    def _maybe_snapshot(self, now: float) -> None:
        with self._lock:
            due = now - self._last_snap >= self.snapshot_sec
            if due:
                self._last_snap = now
        if due:
            self.snapshot()

    def snapshot(self) -> None:
        """Write one metric-registry snapshot line (counters, gauges,
        histogram bucket counts — the mergeable form, so the collector re-derive fleet percentiles exactly as the
        obs_report merge policy does)."""
        self._write({"kind": "snap", "t": time.time(),
                     "metrics": obs_metrics.get_registry().snapshot()})

    def status(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "role": self.role, "pid": self.pid,
                    "segment": self._seg, "events": self._n,
                    "dropped": self._dropped}

    def close(self) -> None:
        try:
            self.snapshot()   # final registry state for the collector
        finally:
            with self._lock:
                if self._f is not None:
                    self._f.close()
                    self._f = None


# ---------------------------------------------------------------------------
# Module-level arm/disarm (the flightrec pattern): one spool per process
# ---------------------------------------------------------------------------

_spool: TelemetrySpool | None = None


def arm(cfg, role: str, run_id: str | None = None) -> TelemetrySpool | None:
    """Arm the process spool for ``role`` and install it as the tracing
    span sink.  No-ops (returns the existing spool) when already armed;
    returns None when disabled (FIREBIRD_TELEMETRY=0) or the store has
    no file-backed 'next to'."""
    global _spool
    if _spool is not None:
        return _spool
    if cfg.telemetry <= 0:
        return None
    d = spool_dir(cfg)
    if d is None:
        return None
    sp = TelemetrySpool(
        d, role, run_id, events_per_segment=cfg.telemetry,
        segments=cfg.telemetry_segments,
        snapshot_sec=cfg.telemetry_snapshot_sec)
    # Single-reference swap from the process-owning thread (cli
    # bring-up); mark() reads the reference once.
    _spool = sp  # firebird-lint: disable=ownership-global-mutation
    tracing.set_spool(sp)
    return sp


def disarm() -> None:
    """Close the process spool and uninstall the span sink."""
    global _spool
    sp = _spool
    # See arm(): single-reference swap, process-owning thread only.
    _spool = None  # firebird-lint: disable=ownership-global-mutation
    tracing.set_spool(None)
    if sp is not None:
        sp.close()


def active() -> TelemetrySpool | None:
    return _spool


def mark(name: str, *, trace: str | None = None, t: float | None = None,
         **attrs) -> None:
    """Record an instant event on the armed spool; one module read +
    None check when disarmed (safe on any hot path)."""
    sp = _spool
    if sp is not None:
        sp.mark(name, trace=trace, t=t, **attrs)

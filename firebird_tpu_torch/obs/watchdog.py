"""Stall watchdog: the pipeline's first automatic failure signal.

The port's own copy of the JAX package's ``obs/watchdog.py``, whole.  The
driver calls :meth:`Watchdog.beat` whenever a batch finishes draining,
and if no beat arrives within the configured deadline
(``FIREBIRD_STALL_SEC`` / ``Config.stall_sec``) the run is declared
stalled — ``/healthz`` flips to 503 (obs/server.py asks :attr:`stalled`)
and ``watchdog_stall_total`` increments, so a supervisor can restart the
process instead of letting a multi-hour tile run hang silently.  The
drivers build the CUDA kernels (``cuda_ops.build``, about a minute of
``nvcc`` on a fresh checkout) BEFORE the watchdog starts, so a short
deadline is not tripped by the build.

A later beat clears the stall (``watchdog_recovered_total``): transient
wedges — a slow capacity retry, a raster-service brownout that
the fetch retries eventually absorb — self-heal without operator action.

Beyond the binary stall, beats feed a rolling throughput window: when the
recent batch rate drops below ``drop_frac`` of the window's baseline rate,
a throughput-drop event is recorded (``watchdog_throughput_drop_total`` +
a bounded event list in :meth:`snapshot`), catching the slow-leak failure
mode (one host degrading, store backpressure) that never quite stalls.

The clock is injectable so every threshold is unit-testable without
sleeping; the optional background thread (:meth:`start`) only matters for
unpolled runs — ``/healthz`` calls :meth:`check` live, so a scraped
process needs no thread at all.
"""

from __future__ import annotations

import collections
import threading
import time

from firebird_tpu_torch.obs import metrics as obs_metrics


class Watchdog:
    """Deadline + rolling-throughput monitor over driver batch beats.

    Parameters
    ----------
    stall_sec:
        No beat for this long => stalled.  Must be > 0.
    grace_factor:
        Until the FIRST beat the effective deadline is ``stall_sec *
        grace_factor``: bring-up (first fetch + the first batch, which
        only a completed drain can ack) legitimately exceeds the
        steady-state cadence, and a liveness supervisor restarting on a
        false bring-up stall would loop restart -> rebuild -> restart
        forever.  A hung bring-up still stalls — just on the longer
        deadline.
    window:
        Number of recent beats kept for the throughput baseline.
    drop_frac:
        Recent rate below ``drop_frac * baseline`` records a drop event.
    clock:
        Monotonic time source (injectable for tests).
    """

    def __init__(self, stall_sec: float, *, grace_factor: float = 3.0,
                 window: int = 32, drop_frac: float = 0.5,
                 clock=time.monotonic):
        if stall_sec <= 0:
            raise ValueError(f"stall_sec must be > 0, got {stall_sec}")
        self.stall_sec = float(stall_sec)
        self.grace_factor = max(float(grace_factor), 1.0)
        self.drop_frac = float(drop_frac)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_beat = clock()  # guarded-by: _lock
        self._stalled = False  # guarded-by: _lock
        self._beats: collections.deque = \
            collections.deque(maxlen=window)  # guarded-by: _lock
        self._beat_count = 0  # guarded-by: _lock
        self._in_drop = False  # guarded-by: _lock
        self._drop_events: collections.deque = \
            collections.deque(maxlen=16)  # guarded-by: _lock
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- signal ingest -----------------------------------------------------

    def beat(self, units: int = 1) -> None:
        """Record a unit of forward progress (a drained batch)."""
        now = self._clock()
        with self._lock:
            self._last_beat = now
            self._beats.append((now, max(int(units), 0)))
            self._beat_count += 1
            if self._stalled:
                self._stalled = False
                obs_metrics.counter("watchdog_recovered_total").inc()
                from firebird_tpu_torch.obs import logger
                logger("change-detection").warning(
                    "watchdog: run recovered after stall")
            self._check_throughput_locked(now)

    def _check_throughput_locked(self, now: float) -> None:
        # Baseline over the whole rolling window vs. the most recent
        # quarter of it; both need enough beats to be rates, not noise.
        beats = list(self._beats)
        if len(beats) < 8:
            return
        span = now - beats[0][0]
        if span <= 0:
            return
        baseline = sum(n for _, n in beats) / span
        recent = beats[-max(len(beats) // 4, 2):]
        rspan = now - recent[0][0]
        if rspan <= 0:
            return
        recent_rate = sum(n for _, n in recent) / rspan
        if recent_rate < self.drop_frac * baseline:
            if not self._in_drop:
                self._in_drop = True
                obs_metrics.counter("watchdog_throughput_drop_total").inc()
                # Wall-clock timestamp + the threshold that was crossed:
                # the event is read post-hoc from /progress's degraded
                # block and the flight-recorder bundle, where a bare
                # monotonic offset is meaningless.  UTC with designator
                # — the written_at/generated_at artifact convention.
                self._drop_events.append({
                    "at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime()),
                    "at_sec": now, "recent_per_sec": recent_rate,
                    "baseline_per_sec": baseline,
                    "threshold_per_sec": self.drop_frac * baseline})
        else:
            self._in_drop = False

    # -- state reads -------------------------------------------------------

    def check(self, now: float | None = None) -> bool:
        """Evaluate the deadline; returns the (possibly new) stalled state.

        Called live by the ops server's ``/healthz`` handler and by the
        optional background thread — the stall counter increments exactly
        once per stall episode regardless of how often either polls."""
        now = self._clock() if now is None else now
        declared = None
        with self._lock:
            deadline = self.stall_sec if self._beat_count \
                else self.stall_sec * self.grace_factor
            if not self._stalled and now - self._last_beat > deadline:
                self._stalled = True
                declared = now - self._last_beat
                obs_metrics.counter("watchdog_stall_total").inc()
                from firebird_tpu_torch.obs import logger
                logger("change-detection").error(
                    "watchdog: no batch completed in %.1fs (deadline %.1fs%s)"
                    " — run stalled", declared, deadline,
                    "" if self._beat_count else ", bring-up grace")
            stalled = self._stalled
        if declared is not None:
            # Flight-recorder trigger OUTSIDE the lock: the postmortem
            # bundle reads this watchdog's own snapshot(), which takes
            # the lock again.  Dumps the rings while every wedged
            # thread's recent events are still in them (no-op disarmed).
            from firebird_tpu_torch.obs import flightrec
            flightrec.on_stall(declared, deadline)
        return stalled

    @property
    def stalled(self) -> bool:
        return self.check()

    def snapshot(self) -> dict:
        """JSON-ready state for /progress and the report run block."""
        now = self._clock()
        with self._lock:
            return {
                "stalled": self._stalled,
                "stall_sec": self.stall_sec,
                "last_beat_age_sec": now - self._last_beat,
                "beats": self._beat_count,
                "in_throughput_drop": self._in_drop,
                "throughput_drops": list(self._drop_events),
            }

    # -- background polling ------------------------------------------------

    def start(self, interval: float | None = None) -> "Watchdog":
        """Poll :meth:`check` on a daemon thread (for unscraped runs)."""
        if self._thread is not None:
            return self
        interval = interval or max(min(self.stall_sec / 4.0, 5.0), 0.05)
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval):
                self.check()

        self._thread = threading.Thread(
            target=loop, name="firebird-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

"""Unified transient-failure policy: jittered retries, a per-run budget,
and a circuit breaker on the ingest source.

The port's own copy of the JAX package's ``retry.py``, shared by the
batch driver (driver/core.py ``_with_retries``) and the async writer
(store/writer.py):

- **Decorrelated jitter** (the AWS backoff result): each delay is drawn
  uniformly from ``[base, 3 * previous_delay]``, capped — retries from
  concurrent threads spread out instead of synchronizing.
- **Injectable sleep/clock**: tests drive every threshold without
  wall-clock sleeping.
- **Per-run retry budget** (:class:`RetryBudget`): one shared spend
  ceiling across every retry site of a run — a systemic outage fails
  fast into the quarantine instead of multiplying per-chip retries into
  hours of futile backoff.
- **Circuit breaker** (:class:`CircuitBreaker`): after N *consecutive*
  failures the breaker opens and callers pause at
  :meth:`CircuitBreaker.acquire` until the cooldown elapses; the first
  caller through becomes the half-open probe, and its outcome closes or
  re-opens the circuit.  Surfaced as the ``breaker_state`` gauge
  (0 closed / 1 half-open / 2 open) and ``breaker_open_total``.
"""

from __future__ import annotations

import random
import threading
import time

from firebird_tpu_torch.obs import metrics as obs_metrics

class NonRetryable(Exception):
    """Base for errors the retry loop must re-raise IMMEDIATELY: another
    attempt cannot help, and the failure says nothing about the health
    of the service behind the breaker.  The canonical case is a fencing
    rejection (fleet.queue.StaleFence) — a lease that expired stays
    expired, and retrying a zombie's write would just hammer the store
    with more rejections while delaying the worker's abandon path."""


# Gauge encoding for breaker_state (docs/ROBUSTNESS.md).
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half_open", OPEN: "open"}


def decorrelated_delay(prev: float, *, base: float, cap: float,
                       rng: random.Random | None = None) -> float:
    """One decorrelated-jitter backoff step (the AWS result): uniform
    over ``[base, 3 * prev]``, capped.  THE repo's backoff primitive —
    :class:`RetryPolicy` draws every retry delay through it, and the
    fleet supervisor's crash-loop circuit (fleet/policy.py) draws its
    park backoff the same way, so concurrent retriers / respawned
    worker slots decohere instead of thundering in lockstep."""
    r = rng if rng is not None else random
    return min(float(cap), r.uniform(float(base), max(prev * 3, base)))


class RetryBudget:
    """A run-wide ceiling on total retries, shared across threads and
    retry sites (ingest fetches, store writes).  ``limit <= 0`` means
    unlimited — the default, preserving pre-budget behavior."""

    def __init__(self, limit: int = 0):
        self.limit = int(limit)
        self._lock = threading.Lock()
        self._spent = 0  # guarded-by: _lock

    def take(self) -> bool:
        """Consume one retry; False when the budget is exhausted."""
        if self.limit <= 0:
            return True
        with self._lock:
            if self._spent >= self.limit:
                return False
            self._spent += 1
            return True

    @property
    def spent(self) -> int:
        with self._lock:
            return self._spent

    def remaining(self) -> int | None:
        """Retries left, or None when unlimited."""
        if self.limit <= 0:
            return None
        with self._lock:
            return max(self.limit - self._spent, 0)


class CircuitBreaker:
    """Consecutive-failure circuit breaker with half-open probing.

    closed -> (threshold consecutive failures) -> open -> (cooldown)
    -> half-open (ONE probe allowed through) -> success: closed /
    failure: open again.  ``acquire`` blocks (via the injectable sleep)
    while open — the driver pauses fetching instead of burning the retry
    budget against a service that is down.
    """

    def __init__(self, threshold: int, cooldown_sec: float = 30.0, *,
                 clock=time.monotonic, name: str = "ingest"):
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got "
                             f"{threshold}")
        self.threshold = int(threshold)
        self.cooldown_sec = float(cooldown_sec)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED  # guarded-by: _lock
        self._consecutive = 0  # guarded-by: _lock
        self._opened_at = 0.0  # guarded-by: _lock
        # Thread id of the half-open probe, or None.  Probe ownership is
        # by thread: only the probe's own outcome may transition a
        # non-closed circuit — a straggler request admitted back when the
        # circuit was still closed must neither close an open breaker on
        # success nor free the probe slot on failure.
        self._probe_thread: int | None = None  # guarded-by: _lock

    def _set_state_locked(self, state: int) -> None:
        if state == OPEN and self._state != OPEN:
            obs_metrics.counter(
                "breaker_open_total",
                help="circuit-breaker open transitions").inc()
        self._state = state
        obs_metrics.gauge(
            "breaker_state",
            help="0 closed, 1 half-open, 2 open").set(state)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def state_name(self) -> str:
        return _STATE_NAMES[self.state]

    def _try_enter(self) -> tuple[bool, float]:
        """(allowed, suggested wait).  Half-open admits one probe."""
        now = self._clock()
        with self._lock:
            if self._state == CLOSED:
                return True, 0.0
            if self._state == OPEN:
                remaining = self._opened_at + self.cooldown_sec - now
                if remaining > 0:
                    return False, remaining
                self._set_state_locked(HALF_OPEN)
            # HALF_OPEN: exactly one probe in flight at a time.
            if self._probe_thread is None:
                self._probe_thread = threading.get_ident()
                return True, 0.0
            return False, min(self.cooldown_sec, 0.25)

    def acquire(self, sleep=time.sleep) -> None:
        """Block until the circuit admits this caller (no-op when
        closed).  ``sleep`` is injectable for tests."""
        while True:
            ok, wait = self._try_enter()
            if ok:
                return
            sleep(max(wait, 0.01))

    def try_acquire(self) -> tuple[bool, float]:
        """Non-blocking admission: ``(admitted, suggested_wait_sec)``.

        The serving layer (serve/flight.py) cannot park a request thread
        on the breaker cooldown the way the batch drivers do — it answers
        503 + Retry-After instead.  An admitted caller in the half-open
        state owns the probe slot and MUST report its outcome via
        ``record_success``/``record_failure``, same contract as
        ``acquire``."""
        return self._try_enter()

    def _is_probe_locked(self) -> bool:
        return self._probe_thread == threading.get_ident()

    def record_success(self) -> None:
        with self._lock:
            if self._state == CLOSED:
                self._consecutive = 0
                return
            # Non-closed circuit: only the probe's own success may close
            # it — a straggler admitted pre-open proves nothing about the
            # service NOW.
            if not self._is_probe_locked():
                return
            self._probe_thread = None
            self._consecutive = 0
            self._set_state_locked(CLOSED)
            from firebird_tpu_torch.obs import logger
            logger("change-detection").warning(
                "breaker %s: probe succeeded, circuit closed", self.name)

    def record_failure(self) -> None:
        with self._lock:
            was = self._state
            if was == CLOSED:
                self._consecutive += 1
                if self._consecutive >= self.threshold:
                    self._opened_at = self._clock()
                    self._set_state_locked(OPEN)
                    from firebird_tpu_torch.obs import logger
                    logger("change-detection").error(
                        "breaker %s: %d consecutive failures, circuit OPEN "
                        "for %.0fs (half-open probes follow)", self.name,
                        self._consecutive, self.cooldown_sec)
                return
            # OPEN/HALF_OPEN: stragglers neither restart the cooldown nor
            # free the probe slot; a FAILED probe re-opens for a fresh
            # cooldown.
            self._consecutive += 1
            if self._is_probe_locked():
                self._probe_thread = None
                self._opened_at = self._clock()
                self._set_state_locked(OPEN)

    def snapshot(self) -> dict:
        with self._lock:
            return {"name": self.name, "state": _STATE_NAMES[self._state],
                    "consecutive_failures": self._consecutive,
                    "threshold": self.threshold,
                    "cooldown_sec": self.cooldown_sec}


class RetryPolicy:
    """The one retry loop: bounded attempts, decorrelated-jitter backoff,
    optional shared budget and breaker, injectable sleep/rng.

    ``counter_name`` is the metrics counter each retry increments, so the
    ingest policy keeps the historical ``fetch_retries`` series while the
    store policy records ``store_write_retries``.
    """

    def __init__(self, retries: int, *, base: float = 1.0, cap: float = 30.0,
                 budget: RetryBudget | None = None,
                 breaker: CircuitBreaker | None = None,
                 sleep=None, rng: random.Random | None = None,
                 counter_name: str = "fetch_retries",
                 counter_help: str = ("transient-failure retries absorbed "
                                      "by the driver's retry policy")):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.retries = int(retries)
        self.base = float(base)
        self.cap = float(cap)
        self.budget = budget
        self.breaker = breaker
        self._sleep = sleep
        self._rng = rng or random.Random()  # guarded-by: _rng_lock
        self._rng_lock = threading.Lock()
        self.counter_name = counter_name
        self.counter_help = counter_help

    def _do_sleep(self, delay: float) -> None:
        # Resolved at call time so tests that monkeypatch time.sleep
        # (the historical seam) still take effect without injecting.
        (self._sleep or time.sleep)(delay)

    def _next_delay(self, prev: float) -> float:
        # Decorrelated jitter so concurrent threads' retries decohere
        # instead of synchronizing into repeated thundering herds
        # against a browned-out service.
        with self._rng_lock:
            return decorrelated_delay(prev, base=self.base, cap=self.cap,
                                      rng=self._rng)

    def run(self, log, what: str, fn):
        """fn() under the policy; raises the last error when attempts,
        budget, or breaker-probe admission run out."""
        delay = self.base
        for attempt in range(self.retries + 1):
            if self.breaker is not None:
                self.breaker.acquire(self._sleep or time.sleep)
            try:
                result = fn()
            except NonRetryable:
                # Not a transient failure and not a service-health signal:
                # no retry, no budget spend, no breaker strike.
                raise
            except Exception as e:
                if self.breaker is not None:
                    self.breaker.record_failure()
                if attempt == self.retries:
                    raise
                if self.budget is not None and not self.budget.take():
                    log.warning(
                        "%s failed (%s: %s) and the run's retry budget is "
                        "exhausted (%d spent) — failing fast", what,
                        type(e).__name__, e, self.budget.spent)
                    raise
                obs_metrics.counter(self.counter_name,
                                    help=self.counter_help).inc()
                delay = self._next_delay(delay)
                log.warning(
                    "%s failed (attempt %d: %s: %s), retrying in %.1fs",
                    what, attempt + 1, type(e).__name__, e, delay)
                self._do_sleep(delay)
            else:
                if self.breaker is not None:
                    self.breaker.record_success()
                return result

    @classmethod
    def for_ingest(cls, cfg, *, budget: RetryBudget | None = None,
                   breaker: CircuitBreaker | None = None,
                   sleep=None) -> "RetryPolicy":
        return cls(cfg.fetch_retries, budget=budget, breaker=breaker,
                   sleep=sleep)

    @classmethod
    def for_store(cls, cfg, *, budget: RetryBudget | None = None,
                  sleep=None) -> "RetryPolicy":
        return cls(cfg.fetch_retries, budget=budget, sleep=sleep,
                   counter_name="store_write_retries",
                   counter_help=("transient store-write failures retried "
                                 "by the async writer"))


def make_breaker(cfg) -> CircuitBreaker | None:
    """The run's ingest breaker per config; None when disabled
    (breaker_threshold <= 0)."""
    if cfg.breaker_threshold <= 0:
        return None
    return CircuitBreaker(cfg.breaker_threshold, cfg.breaker_cooldown_sec)

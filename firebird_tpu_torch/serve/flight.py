"""Request coalescing and admission control for the serving layer: the
port's own copy of the JAX package's ``serve/flight.py`` (host only).

The serving layer's expensive unit is a cold product-raster computation
(a products.save-path compute over ~12k stored segment rows).  Under
load, the failure modes of a naive read path are well known:

- **Thundering miss**: N identical requests arrive while the value is
  cold; a naive layer computes it N times.  :class:`SingleFlight`
  coalesces them — the first caller computes, the rest wait on its
  result (or its exception).  This is the classic single-flight pattern;
  the obs counter ``serve_coalesced_waits`` proves it fires.
- **Overload collapse**: unbounded concurrency drives tail latency to
  infinity for everyone.  :class:`AdmissionControl` bounds in-flight
  work and the waiting line; past the line it sheds load with
  :class:`Overload` (HTTP 429 + Retry-After), and a request that waited
  past its deadline fails with :class:`DeadlineExceeded` (HTTP 504)
  instead of computing an answer nobody is waiting for.
- **Store brownout**: the breaker (retry.CircuitBreaker, shared
  machinery with the batch drivers) opens after consecutive store
  failures; the API then serves cache hits only and answers misses 503
  "degraded" until a half-open probe heals it — a broken store degrades
  the serving layer, it does not kill it (``/healthz`` says so).

Everything here is transport-agnostic: serve/api.py maps the exceptions
to status codes.
"""

from __future__ import annotations

import contextlib
import threading
import time

from firebird_tpu_torch.obs import metrics as obs_metrics


class Overload(Exception):
    """The admission queue is full — shed load (429)."""

    def __init__(self, retry_after_sec: float):
        self.retry_after_sec = max(float(retry_after_sec), 0.1)
        super().__init__(
            f"serving at capacity; retry after {self.retry_after_sec:.1f}s")


class DeadlineExceeded(Exception):
    """The request waited past its deadline before compute began (504)."""


class StoreDegraded(Exception):
    """The store breaker is open — only cache hits are servable (503)."""

    def __init__(self, retry_after_sec: float, detail: str = ""):
        self.retry_after_sec = max(float(retry_after_sec), 0.1)
        super().__init__(detail or "store degraded; serving cache only")


class _Flight:
    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.error: BaseException | None = None


class SingleFlight:
    """Coalesce concurrent identical computations.

    ``do(key, fn)``: the first caller for a live ``key`` runs ``fn`` and
    publishes its result; concurrent callers with the same key block on
    the same flight and share the result (or the raised exception).  The
    flight is deregistered when it completes, so *later* callers compute
    fresh — coalescing is about concurrency, caching is the cache's job.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: dict = {}  # guarded-by: _lock

    def do(self, key, fn, deadline: "Deadline | None" = None):
        with self._lock:
            fl = self._flights.get(key)
            if fl is None:
                fl = self._flights[key] = _Flight()
                leader = True
            else:
                leader = False
        if not leader:
            obs_metrics.counter(
                "serve_coalesced_waits",
                help="requests that waited on another identical "
                     "in-flight computation instead of recomputing").inc()
            # A follower's wait honors ITS deadline: if the leader's
            # store op hangs, the coalesced requests must 504 and free
            # their admission slots rather than pin the whole server.
            if not fl.done.wait(
                    None if deadline is None
                    else max(deadline.remaining(), 0.001)):
                obs_metrics.counter("serve_deadline_exceeded_total").inc()
                raise DeadlineExceeded(
                    "coalesced computation did not finish within the "
                    "request deadline")
            if fl.error is not None:
                raise fl.error
            return fl.value
        try:
            fl.value = fn()
            return fl.value
        except BaseException as e:
            fl.error = e
            raise
        finally:
            with self._lock:
                self._flights.pop(key, None)
            fl.done.set()


class AdmissionControl:
    """Bounded concurrency + bounded waiting line + per-request deadline.

    ``max_inflight`` requests run concurrently; up to ``max_queue`` more
    wait.  A request arriving past the line raises :class:`Overload`
    immediately (fail fast beats queueing forever), and a queued request
    that cannot start within ``deadline_sec`` raises
    :class:`DeadlineExceeded`.  Use as a context manager around the
    whole request body.
    """

    def __init__(self, max_inflight: int = 16, max_queue: int = 64,
                 deadline_sec: float = 30.0):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_inflight = int(max_inflight)
        self.max_queue = int(max_queue)
        self.deadline_sec = float(deadline_sec)
        self._sem = threading.BoundedSemaphore(self.max_inflight)
        self._lock = threading.Lock()
        self._waiting = 0  # guarded-by: _lock

    def _inflight_gauge(self, delta: int) -> None:
        obs_metrics.gauge(
            "serve_inflight",
            help="serve requests currently executing").inc(delta)

    def _acquire(self, deadline: "Deadline | None") -> None:
        # Fast path first: a free execution slot admits immediately, so
        # the waiting-line bound only ever judges requests that actually
        # have to wait — with max_queue=0 ("no waiting line") an idle
        # server still serves, and a burst onto free slots never sheds.
        if self._sem.acquire(blocking=False):
            self._inflight_gauge(+1)
            return
        with self._lock:
            if self._waiting >= self.max_queue:
                obs_metrics.counter(
                    "serve_rejected_total",
                    help="requests shed with 429 (admission queue "
                         "full)").inc()
                # Retry-After heuristic: one deadline's worth of drain.
                raise Overload(self.deadline_sec / 2)
            self._waiting += 1
        # The slot wait spends the REQUEST's deadline (started at
        # arrival), not a fresh budget — otherwise a request could wait
        # deadline_sec in the queue and then compute for deadline_sec
        # more, doubling the documented worst case.
        timeout = self.deadline_sec if deadline is None \
            else max(deadline.remaining(), 0.001)
        try:
            ok = self._sem.acquire(timeout=timeout)
        finally:
            with self._lock:
                self._waiting -= 1
        if not ok:
            obs_metrics.counter(
                "serve_deadline_exceeded_total",
                help="requests that timed out waiting for an execution "
                     "slot (504)").inc()
            raise DeadlineExceeded(
                f"no execution slot within {timeout:.1f}s")
        self._inflight_gauge(+1)

    def _release(self) -> None:
        self._sem.release()
        self._inflight_gauge(-1)

    def __enter__(self):
        self._acquire(None)
        return self

    def __exit__(self, *exc):
        self._release()
        return False

    @contextlib.contextmanager
    def admit(self, deadline: "Deadline | None"):
        """Admission charged against an externally-started deadline (the
        handler starts it at request arrival, before the queue wait)."""
        self._acquire(deadline)
        try:
            yield self
        finally:
            self._release()


class Deadline:
    """A request's time budget, threaded through compute-on-miss so a
    doomed request stops before the expensive part."""

    def __init__(self, seconds: float, clock=time.monotonic):
        self._clock = clock
        self.at = clock() + float(seconds)

    def remaining(self) -> float:
        return self.at - self._clock()

    def check(self, what: str = "request") -> None:
        if self.remaining() <= 0:
            obs_metrics.counter("serve_deadline_exceeded_total").inc()
            raise DeadlineExceeded(f"{what} exceeded its deadline")

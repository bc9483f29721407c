"""Scale policy: queue pressure in, target worker count out — purely.

The port's own copy of the JAX package's ``fleet/policy.py``, whole: the
same snapshot gives the same decision in either package.

The supervisor (fleet/supervisor.py) separates *deciding* how many
workers the queue deserves from *making* that many exist.  This module
is the deciding half, and it is deliberately free of processes, sqlite,
and wall clocks: one :class:`QueueSnapshot` (taken atomically by
``FleetQueue.scale_snapshot``) plus the live worker count go in, a
:class:`Decision` comes out, and every threshold is exact arithmetic on
an injectable clock (tests/test_torch_supervisor.py).

Rules, in the order they apply:

- **Demand.**  Batch backlog = claimable + leased jobs (``stream`` jobs
  are excluded: standing ``--forever`` stream workers are provisioned
  by the operator/watcher, not by batch drain pressure — they are a
  different capacity pool).  Dead letters and dep-blocked jobs are NOT
  backlog: no worker can claim them, so a dead-letter-dominated queue
  must not pin the fleet at max burning CPU on nothing (the clamping
  case).  Want = ceil(backlog / jobs_per_worker), and a sustained old
  lease (oldest_lease_age past the lease length) adds no demand —
  re-delivery does.
- **Hysteresis.**  Scale UP only after the raised demand persists for
  ``up_after_sec``; scale DOWN only after the lowered demand persists
  for ``idle_after_sec``.  A flapping queue (enqueue burst, drain,
  burst) inside those windows holds the fleet steady instead of
  thrashing spawn/retire cycles.
- **Scale-to-zero.**  Target 0 only when the queue is truly empty of
  open work (zero claimable AND zero pending AND zero open leases) —
  or WEDGED: pending jobs remain but nothing is claimable or leased,
  so no ack can ever unblock them (``FleetQueue.wedged()``'s verdict)
  and workers would spawn/exit churn until an operator requeues.  A
  blocked-but-pending DAG with a mid-flight lease keeps at least one
  worker alive (the ack may unblock it any moment).
- **Crash-loop circuit.**  ``record_exit`` feeds worker exits back in;
  ``crash_limit`` abnormal exits inside ``crash_window_sec`` park one
  slot (capacity shrinks by one) for a decorrelated-jitter backoff
  (retry.decorrelated_delay — the repo's one backoff primitive), and
  each further burst parks another slot with a longer delay.  Parks
  expire on their deadline; a clean exit resets the burst counter.
- **Clamp.**  min_workers <= target <= max_workers - parked slots;
  ``min == max`` pins the fleet (the fixed-size escape hatch).
"""

from __future__ import annotations

import dataclasses
import math
import random
import time

from firebird_tpu_torch import retry as retrylib


@dataclasses.dataclass(frozen=True)
class QueueSnapshot:
    """One atomic reading of queue pressure (FleetQueue.scale_snapshot):
    every field comes from the SAME sqlite transaction, so the policy
    never reasons over a depth and a lease count from different
    moments."""

    at: float                  # queue clock at snapshot time
    by_type: dict              # {job_type: {state: count}}
    claimable: int             # dep-met pending + expired leases
    pending: int               # non-stream pending (claimable + blocked)
    leased: int                # non-stream LIVE leases (expired ones
                               # are claimable, never counted twice)
    dead: int
    blocked: int               # pending behind unmet/dead deps
    oldest_lease_age_sec: float
    drain_rate_per_sec: float  # acks/sec over the trailing window
    drain_window_sec: float
    stream_open: int           # open (pending+leased) stream jobs

    @property
    def backlog(self) -> int:
        """Open batch work a worker could be holding or claiming."""
        return self.claimable + self.leased

    def drain_eta_sec(self) -> float | None:
        """Seconds to drain the open batch work at the observed ack
        rate; None when the rate is 0 (no evidence yet — distinct from
        an eta of 0, which means 'already drained')."""
        if self.backlog == 0:
            return 0.0
        if self.drain_rate_per_sec <= 0:
            return None
        return self.backlog / self.drain_rate_per_sec


@dataclasses.dataclass(frozen=True)
class Decision:
    """One scaling verdict: the target plus the reason an operator (or
    the soak's decision log) reads back."""

    target: int
    reason: str
    want: int                  # pre-hysteresis demand, for the log
    parked: int                # slots currently parked by the circuit


class ScalePolicy:
    """The injectable-clock scaling brain.  One instance per supervisor;
    ``decide`` is called once per tick and mutates only hysteresis/park
    bookkeeping (single-threaded by construction — the supervisor loop
    owns it)."""

    def __init__(self, min_workers: int = 0, max_workers: int = 8, *,
                 jobs_per_worker: float = 4.0,
                 up_after_sec: float = 3.0,
                 idle_after_sec: float = 15.0,
                 crash_limit: int = 3,
                 crash_window_sec: float = 60.0,
                 park_base_sec: float = 5.0,
                 park_cap_sec: float = 300.0,
                 clock=time.monotonic,
                 rng: random.Random | None = None):
        if min_workers < 0:
            raise ValueError(
                f"min_workers must be >= 0, got {min_workers}")
        if max_workers < max(min_workers, 1):
            raise ValueError(
                f"max_workers must be >= max(min_workers, 1), got "
                f"{max_workers} (min {min_workers})")
        if jobs_per_worker <= 0:
            raise ValueError(
                f"jobs_per_worker must be > 0, got {jobs_per_worker}")
        if crash_limit < 1:
            raise ValueError(f"crash_limit must be >= 1, got {crash_limit}")
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.jobs_per_worker = float(jobs_per_worker)
        self.up_after_sec = float(up_after_sec)
        self.idle_after_sec = float(idle_after_sec)
        self.crash_limit = int(crash_limit)
        self.crash_window_sec = float(crash_window_sec)
        self.park_base_sec = float(park_base_sec)
        self.park_cap_sec = float(park_cap_sec)
        self._clock = clock
        self._rng = rng or random.Random()
        self._up_since: float | None = None    # raised demand first seen
        self._down_since: float | None = None  # lowered demand first seen
        self._crash_times: list[float] = []    # abnormal exits in window
        self._parks: list[dict] = []           # [{"until", "delay_sec"}]
        self._last_park_delay = 0.0

    # -- crash-loop circuit -------------------------------------------------

    def record_exit(self, code: int | None, *,
                    now: float | None = None) -> bool:
        """Feed one worker exit back in.  ``code`` 0 is a clean exit
        (resets the burst counter); nonzero or None (SIGKILLed /
        vanished without deregistering) is abnormal.  Returns True when
        this exit tripped the circuit and parked a slot."""
        now = self._clock() if now is None else now
        if code == 0:
            self._crash_times.clear()
            return False
        self._crash_times = [t for t in self._crash_times
                             if now - t < self.crash_window_sec]
        self._crash_times.append(now)
        if len(self._crash_times) < self.crash_limit:
            return False
        # Circuit trips: park one slot with decorrelated backoff — a
        # crash-looping payload/host must not be respawned hot.  The
        # burst counter resets so the NEXT park needs a fresh burst.
        self._crash_times.clear()
        self._last_park_delay = retrylib.decorrelated_delay(
            max(self._last_park_delay, self.park_base_sec),
            base=self.park_base_sec, cap=self.park_cap_sec, rng=self._rng)
        self._parks.append({"until": now + self._last_park_delay,
                            "delay_sec": round(self._last_park_delay, 3)})
        return True

    def _sweep_parks(self, now: float) -> None:
        self._parks = [p for p in self._parks if p["until"] > now]
        if not self._parks:
            self._last_park_delay = 0.0

    def parks(self, now: float | None = None) -> list[dict]:
        """Unexpired parks (for the supervisor's status block).
        Strictly read-only: the ops HTTP thread calls this through
        status_block concurrently with the tick thread's
        record_exit/decide, and a sweep here (rebinding ``_parks``)
        could silently drop a park appended between the read and the
        rebind.  Expired parks are swept on the tick thread (decide)."""
        now = self._clock() if now is None else now
        return [dict(p) for p in self._parks if p["until"] > now]

    # -- the verdict --------------------------------------------------------

    def _demand(self, snap: QueueSnapshot) -> int:
        """Pre-hysteresis want, before clamping."""
        if snap.claimable == 0 and snap.pending == 0 and snap.leased == 0:
            return 0                      # scale-to-zero eligible
        if snap.claimable == 0 and snap.leased == 0:
            # WEDGED — the same verdict FleetQueue.wedged() reads:
            # every pending job is blocked behind an unmet dep, and
            # with no lease in flight no ack can ever arrive to unblock
            # one.  Workers would claim nothing, exit, and spawn/exit
            # churn forever; only an operator requeue makes progress.
            return 0
        want = math.ceil(snap.backlog / self.jobs_per_worker)
        # Open work exists (a lease in flight, or pending blocked work
        # that an ack may unblock any moment): keep at least one worker
        # even when nothing is claimable RIGHT NOW.
        return max(want, 1)

    def decide(self, snap: QueueSnapshot, live: int) -> Decision:
        """Target worker count for this tick, given ``live`` current
        (non-retiring) batch workers.

        Every duration here (hysteresis windows, park expiry) is
        measured on the POLICY's own clock, never ``snap.at`` — the
        snapshot rides the queue's wall clock (time.time) while
        record_exit stamps parks on this clock (time.monotonic in
        production), and mixing the two would expire every park on the
        next tick."""
        now = self._clock()
        self._sweep_parks(now)
        cap = max(self.max_workers - len(self._parks), self.min_workers)
        want = self._demand(snap)
        clamped = min(max(want, self.min_workers), cap)
        if self.min_workers == self.max_workers:
            self._up_since = self._down_since = None
            return self._emit(self.min_workers, want,
                              f"pinned min==max=={self.min_workers}")

        if clamped > live:
            self._down_since = None
            if self._up_since is None:
                self._up_since = now
            held = now - self._up_since
            if held < self.up_after_sec:
                return self._emit(
                    live, want,
                    f"backlog {snap.backlog} wants {clamped}, holding "
                    f"{live} until sustained {self.up_after_sec:.0f}s "
                    f"(held {held:.1f}s)")
            return self._emit(
                clamped, want,
                f"backlog {snap.backlog} sustained {held:.1f}s -> "
                f"scale up {live} -> {clamped} (cap {cap})")

        if clamped < live:
            self._up_since = None
            if self._down_since is None:
                self._down_since = now
            held = now - self._down_since
            if held < self.idle_after_sec:
                return self._emit(
                    live, want,
                    f"demand {clamped} below live {live}, holding until "
                    f"idle {self.idle_after_sec:.0f}s (held {held:.1f}s)")
            if clamped == 0:
                why = ("queue empty (no pending, no leases)"
                       if snap.pending == 0 else
                       f"wedged ({snap.pending} pending all blocked, "
                       "nothing claimable or leased)")
                return self._emit(
                    0, want, f"{why} for {held:.1f}s -> scale to zero")
            return self._emit(
                clamped, want,
                f"idle {held:.1f}s -> scale down {live} -> {clamped}")

        self._up_since = self._down_since = None
        return self._emit(clamped, want,
                          f"steady at {clamped} (backlog {snap.backlog})")

    def _emit(self, target: int, want: int, reason: str) -> Decision:
        return Decision(target=int(target), reason=reason, want=int(want),
                        parked=len(self._parks))

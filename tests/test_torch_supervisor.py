"""The port's elastic fleet against the JAX package's: the scale policy,
the supervisor's mechanics and its command, deterministically.

The JAX package's tests/test_supervisor.py cases on the port's
``fleet.policy``, ``fleet.queue``, ``fleet.supervisor`` and
``fleet.worker``: every hysteresis window, park backoff, adoption pass
and retire deadline is exact arithmetic on an injectable clock — no
subprocesses, no sleeps.  Every ``ScalePolicy`` in the policy cases is a
twin: the port's policy and the JAX package's, fed the same snapshots,
exits and clock, whose decisions, parks and circuit verdicts must be
equal at every step.  Plus: ``_worker_cmd`` spawns the port's command,
and ``fleet supervise`` never initialises CUDA.
"""

import dataclasses
import os
import random

import pytest
import torch

from firebird_tpu_torch.fleet import policy as jpolicy
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.fleet import (FleetQueue, FleetWorker, QueueSnapshot,
                                      ScalePolicy, Supervisor)
from firebird_tpu_torch.fleet import policy as tpolicy
from firebird_tpu_torch.obs import metrics as obs_metrics


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def clock():
    return Clock()


@pytest.fixture
def queue(tmp_path, clock):
    q = FleetQueue(str(tmp_path / "fleet.db"), lease_sec=30.0, clock=clock)
    yield q
    q.close()


@pytest.fixture(autouse=True)
def _fresh_registry():
    obs_metrics.reset_registry()
    yield
    obs_metrics.reset_registry()


def snap(clock, *, claimable=0, pending=None, leased=0, dead=0, blocked=0,
         oldest=0.0, rate=0.0, stream_open=0) -> QueueSnapshot:
    """Hand-built snapshot: pending defaults to claimable + blocked."""
    return QueueSnapshot(
        at=clock(), by_type={},
        claimable=claimable,
        pending=claimable + blocked if pending is None else pending,
        leased=leased, dead=dead, blocked=blocked,
        oldest_lease_age_sec=oldest, drain_rate_per_sec=rate,
        drain_window_sec=60.0, stream_open=stream_open)


class TwinPolicy:
    """The port's ScalePolicy and the JAX package's side by side: every
    call goes to both (the JAX one gets the same snapshot as its own
    QueueSnapshot, and an equally seeded RNG) and the answers must be
    equal; the port's answer is returned."""

    def __init__(self, min_w, max_w, **kw):
        seed = kw.pop("rng", None)
        mk = (lambda: None) if seed is None else (
            lambda: random.Random(seed))
        self.port = tpolicy.ScalePolicy(min_w, max_w, rng=mk(), **kw)
        self.jax = jpolicy.ScalePolicy(min_w, max_w, rng=mk(), **kw)

    def decide(self, snapshot, live):
        got = self.port.decide(snapshot, live)
        want = self.jax.decide(
            jpolicy.QueueSnapshot(**dataclasses.asdict(snapshot)), live)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        return got

    def record_exit(self, code, *, now=None):
        got = self.port.record_exit(code, now=now)
        assert got == self.jax.record_exit(code, now=now)
        return got

    def parks(self, now=None):
        got = self.port.parks(now)
        assert got == self.jax.parks(now)
        return got

    def __getattr__(self, name):
        return getattr(self.port, name)


def policy(clock, min_w=0, max_w=10, **kw) -> TwinPolicy:
    kw.setdefault("jobs_per_worker", 2.0)
    kw.setdefault("up_after_sec", 3.0)
    kw.setdefault("idle_after_sec", 10.0)
    kw.setdefault("rng", 7)
    return TwinPolicy(min_w, max_w, clock=clock, **kw)


# ---------------------------------------------------------------------------
# ScalePolicy boundary cases
# ---------------------------------------------------------------------------

def test_scale_up_needs_sustained_backlog(clock):
    p = policy(clock)
    d = p.decide(snap(clock, claimable=20), live=0)
    assert d.target == 0 and d.want == 10       # demand seen, held
    clock.advance(2.0)
    assert p.decide(snap(clock, claimable=20), live=0).target == 0
    clock.advance(1.5)                          # 3.5s > up_after_sec
    d = p.decide(snap(clock, claimable=20), live=0)
    assert d.target == 10
    assert "scale up" in d.reason


def test_hysteresis_suppresses_flapping(clock):
    """Backlog that appears and vanishes inside the windows never moves
    the target: the up-timer resets on every idle reading and the
    down-timer resets on every busy reading."""
    p = policy(clock)
    live = 2
    for _ in range(20):
        d = p.decide(snap(clock, claimable=20), live=live)
        assert d.target == live                 # up-window never elapses
        clock.advance(2.0)
        d = p.decide(snap(clock), live=live)    # empty inside idle window
        assert d.target == live                 # down-window never elapses
        clock.advance(2.0)


def test_min_equals_max_pins_fleet(clock):
    p = policy(clock, min_w=4, max_w=4)
    for s in (snap(clock), snap(clock, claimable=1000),
              snap(clock, dead=50)):
        d = p.decide(s, live=4)
        assert d.target == 4 and "pinned" in d.reason
    # Pinning holds across time too — no window ever scales it.
    clock.advance(100.0)
    assert p.decide(snap(clock), live=4).target == 4


def test_scale_to_zero_needs_empty_depth_and_no_leases(clock):
    p = policy(clock, idle_after_sec=5.0)
    # An open lease blocks scale-to-zero even with nothing claimable.
    d = p.decide(snap(clock, claimable=0, leased=1), live=1)
    assert d.target == 1 and d.want == 1
    clock.advance(60.0)
    assert p.decide(snap(clock, claimable=0, leased=1), live=1).target == 1
    # Pending-but-blocked work with NO lease in flight is wedged (no
    # ack can unblock it): held through the idle window, then zero.
    assert p.decide(snap(clock, claimable=0, blocked=3),
                    live=1).target == 1
    # Truly empty: zero only after the idle window.
    d = p.decide(snap(clock), live=1)
    assert d.target == 1                        # idle timer just started
    clock.advance(6.0)
    d = p.decide(snap(clock), live=1)
    assert d.target == 0 and "zero" in d.reason


def test_dead_letters_do_not_inflate_target(clock):
    """A dead-letter-dominated queue must not pin the fleet at max:
    demand counts only claimable + leased work."""
    p = policy(clock, up_after_sec=0.0)
    d = p.decide(snap(clock, claimable=2, dead=5000), live=0)
    assert d.target == 1 and d.want == 1        # ceil(2/2), not max
    # All-dead queue with blocked pending jobs and no lease: wedged —
    # zero demand (held through the idle window), never a fleet.
    d = p.decide(snap(clock, claimable=0, blocked=4, dead=5000), live=1)
    assert d.target == 1 and d.want == 0


def test_wedged_queue_demands_zero_workers(clock):
    """claimable==0, leased==0, pending>0 is FleetQueue.wedged()'s
    verdict: no ack can ever unblock the pending work, so demand is 0
    and the fleet scales to zero after the idle window instead of
    spawning workers that exit wedged forever."""
    p = policy(clock, idle_after_sec=5.0)
    d = p.decide(snap(clock, claimable=0, blocked=7, dead=3), live=2)
    assert d.want == 0 and d.target == 2        # idle window holds
    clock.advance(6.0)
    d = p.decide(snap(clock, claimable=0, blocked=7, dead=3), live=2)
    assert d.target == 0 and "wedged" in d.reason
    # A lease in flight is NOT wedged: its ack may unblock the DAG.
    assert p.decide(snap(clock, claimable=0, blocked=7, leased=1),
                    live=1).want == 1


def test_crash_loop_parks_slot_with_backoff_and_expires(clock):
    p = policy(clock, max_w=5, crash_limit=3, crash_window_sec=60.0,
               park_base_sec=10.0, park_cap_sec=100.0, up_after_sec=0.0)
    assert not p.record_exit(1)
    assert not p.record_exit(None)              # vanished = abnormal
    assert p.record_exit(1)                     # third in window: trips
    assert len(p.parks()) == 1
    d = p.decide(snap(clock, claimable=100), live=0)
    assert d.target == 4 and d.parked == 1      # cap shrank by one
    # Park expires after its backoff delay: capacity returns.
    delay = p.parks()[0]["delay_sec"]
    clock.advance(delay + 0.1)
    d = p.decide(snap(clock, claimable=100), live=4)
    assert d.parked == 0 and d.target == 5
    # A second burst parks again, with a (jittered) longer-or-equal
    # delay drawn through retry.decorrelated_delay.
    for _ in range(3):
        p.record_exit(9)
    assert len(p.parks()) == 1
    assert p.parks()[0]["delay_sec"] >= 10.0


def test_parks_survive_queue_wall_clock_snapshots(clock):
    """Regression: parks are stamped on the POLICY clock (monotonic in
    production) while snapshots ride the queue's wall clock — a decide()
    sweeping parks against snap.at would expire every park instantly
    (monotonic seconds are tiny next to epoch seconds)."""
    p = policy(clock, max_w=5, crash_limit=1, park_base_sec=50.0,
               up_after_sec=0.0)
    p.record_exit(1)                            # trips immediately
    assert len(p.parks()) == 1
    wall = QueueSnapshot(
        at=1.75e9, by_type={}, claimable=100, pending=100, leased=0,
        dead=0, blocked=0, oldest_lease_age_sec=0.0,
        drain_rate_per_sec=0.0, drain_window_sec=60.0, stream_open=0)
    d = p.decide(wall, live=0)
    assert d.parked == 1 and d.target == 4      # park still in force


def test_clean_exit_resets_crash_burst(clock):
    p = policy(clock, crash_limit=3)
    p.record_exit(1)
    p.record_exit(1)
    p.record_exit(0)                            # clean exit resets
    assert not p.record_exit(1)                 # burst starts over
    assert p.parks() == []


def test_crash_window_expires_old_exits(clock):
    p = policy(clock, crash_limit=3, crash_window_sec=60.0)
    p.record_exit(1)
    p.record_exit(1)
    clock.advance(61.0)                         # both age out
    assert not p.record_exit(1)
    assert p.parks() == []


@pytest.mark.parametrize("mod", [tpolicy, jpolicy], ids=["port", "jax"])
def test_policy_validation(mod):
    with pytest.raises(ValueError, match="min_workers"):
        mod.ScalePolicy(-1, 5)
    with pytest.raises(ValueError, match="max_workers"):
        mod.ScalePolicy(4, 2)
    with pytest.raises(ValueError, match="max_workers"):
        mod.ScalePolicy(0, 0)
    with pytest.raises(ValueError, match="jobs_per_worker"):
        mod.ScalePolicy(0, 5, jobs_per_worker=0)


def test_config_fleet_worker_bounds():
    with pytest.raises(ValueError, match="MIN_WORKERS"):
        Config(fleet_min_workers=-1)
    with pytest.raises(ValueError, match="MAX_WORKERS"):
        Config(fleet_min_workers=5, fleet_max_workers=3)
    with pytest.raises(ValueError, match="GRACE"):
        Config(fleet_grace_sec=0)
    cfg = Config.from_env(env={"FIREBIRD_FLEET_MIN_WORKERS": "2",
                               "FIREBIRD_FLEET_MAX_WORKERS": "12",
                               "FIREBIRD_FLEET_GRACE_SEC": "9"})
    assert (cfg.fleet_min_workers, cfg.fleet_max_workers,
            cfg.fleet_grace_sec) == (2, 12, 9.0)


# ---------------------------------------------------------------------------
# Queue: scale snapshot + worker registry + supervisor heartbeat
# ---------------------------------------------------------------------------

def test_scale_snapshot_is_pressure_reading(queue, clock):
    d1 = queue.enqueue("detect", {"n": 1})
    queue.enqueue("detect", {"n": 2})
    queue.enqueue("classify", {}, depends_on=[d1])   # blocked
    queue.enqueue("stream", {"cx": 1, "cy": 2})      # separate pool
    lease = queue.claim("w")                         # leases d1
    clock.advance(10.0)
    s = queue.scale_snapshot(window_sec=60.0)
    assert s.claimable == 1                          # d2 only
    assert s.leased == 1 and s.blocked == 1
    assert s.stream_open == 1
    assert s.backlog == 2
    assert s.oldest_lease_age_sec == 10.0
    assert s.drain_rate_per_sec == 0.0
    assert s.drain_eta_sec() is None                 # no rate evidence
    queue.ack(lease)                                 # unblocks classify
    s = queue.scale_snapshot(window_sec=60.0)
    assert s.claimable == 2 and s.blocked == 0
    assert s.drain_rate_per_sec == pytest.approx(1 / 60.0)
    assert s.drain_eta_sec() == pytest.approx(120.0)  # 2 open / rate
    # Acks age out of the trailing window.
    clock.advance(61.0)
    assert queue.scale_snapshot(window_sec=60.0).drain_rate_per_sec == 0.0


def test_scale_snapshot_counts_expired_lease_once(queue, clock):
    """Regression: a mass-killed fleet leaves jobs 'leased' with
    expired leases — re-claimable work that must count ONCE in backlog
    (as claimable), not twice (claimable AND leased)."""
    for i in range(4):
        queue.enqueue("detect", {"n": i})
    for _ in range(4):
        queue.claim("doomed")
    clock.advance(31.0)                          # all 4 leases expire
    s = queue.scale_snapshot(window_sec=60.0)
    assert s.claimable == 4 and s.leased == 0
    assert s.backlog == 4                        # not 8


def test_worker_registry_roundtrip(queue, clock):
    queue.worker_register("h:11", 11, kind="batch", host="h")
    queue.enqueue("detect", {})
    queue.claim("h:11")
    clock.advance(5.0)
    queue.worker_beat("h:11", acked=7)
    (row,) = queue.workers()
    assert row["pid"] == 11 and row["acked"] == 7
    assert row["up_sec"] == 5.0 and row["beat_age_sec"] == 0.0
    assert row["lease"]["type"] == "detect"
    assert row["lease"]["age_sec"] == 5.0
    assert queue.workers(kind="stream") == []
    # Re-registration refreshes, never duplicates or zeroes the tally.
    queue.worker_register("h:11", 11, kind="batch", host="h")
    (row,) = queue.workers()
    assert row["acked"] == 7
    queue.worker_deregister("h:11")
    assert queue.workers() == []
    # Beat on a pruned row is a no-op, not a resurrection.
    queue.worker_beat("h:11", acked=9)
    assert queue.workers() == []


def test_supervisor_heartbeat_persists(queue, clock):
    assert queue.supervisor_state() is None
    queue.supervisor_heartbeat({"target": 3, "live": 2, "pid": 42})
    clock.advance(4.0)
    st = queue.supervisor_state()
    assert st["target"] == 3 and st["pid"] == 42
    assert st["beat_age_sec"] == 4.0
    assert queue.status()["supervisor"]["target"] == 3


def test_worker_run_registers_and_deregisters(queue, clock):
    cfg = Config(store_backend="sqlite", store_path="unused.db",
                 fleet_db=queue.path)
    seen = {}

    def handler(payload, lease):
        seen["workers"] = queue.workers()

    queue.enqueue("detect", {"cids": []})
    w = FleetWorker(cfg, queue, device="cpu", handlers={"detect": handler},
                    clock=clock, sleep=lambda s: None)
    w.run()
    # Registered while running (the handler saw its own row), clean
    # exit removed the row.
    (row,) = seen["workers"]
    assert row["pid"] == os.getpid() and row["kind"] == "batch"
    assert queue.workers() == []


# ---------------------------------------------------------------------------
# Supervisor mechanics (fake spawner, injectable clock)
# ---------------------------------------------------------------------------

class FakeProc:
    """Popen-shaped: pid, poll, send_signal — plus test hooks."""

    _pids = iter(range(50000, 60000))

    def __init__(self):
        self.pid = next(FakeProc._pids)
        self.returncode = None
        self.signals = []

    def poll(self):
        return self.returncode

    def send_signal(self, sig):
        self.signals.append(int(sig))


@pytest.fixture
def harness(tmp_path, queue, clock):
    spawned = []

    def spawn():
        p = FakeProc()
        spawned.append(p)
        return p

    cfg = Config(store_backend="sqlite",
                 store_path=str(tmp_path / "s.db"), fleet_db=queue.path)
    sup = Supervisor(
        cfg, queue,
        policy=ScalePolicy(0, 5, jobs_per_worker=2.0, up_after_sec=0.0,
                           idle_after_sec=10.0, clock=clock,
                           rng=random.Random(3)),
        spawn=spawn, grace_sec=20.0, clock=clock, sleep=lambda s: None,
        # The fake queue clock's registration stamps are not wall
        # times, so real /proc start times would misread every row as
        # recycled; "unknown" takes the age guard out of these tests
        # (test_supervisor_refuses_recycled_pid injects real values).
        proc_start=lambda pid: None)
    return sup, spawned


def test_supervisor_spawns_to_target(harness, queue, clock):
    sup, spawned = harness
    for i in range(6):
        queue.enqueue("detect", {"n": i})
    st = sup.tick()
    assert len(spawned) == 3                     # ceil(6/2)
    assert st["target"] == 3 and st["live"] == 3
    assert obs_metrics.gauge("fleet_workers_target").value == 3
    assert obs_metrics.gauge("fleet_workers_live").value == 3
    assert obs_metrics.counter("fleet_scale_up_total").value == 1
    # Steady state: no double-spawn on the next tick.
    clock.advance(1.0)
    sup.tick()
    assert len(spawned) == 3


def test_supervisor_retires_gracefully_then_kills(harness, queue, clock):
    import signal as sig

    sup, spawned = harness
    for i in range(6):
        queue.enqueue("detect", {"n": i})
    sup.tick()
    # Drain everything; idle window elapses -> scale to zero.
    while True:
        lease = queue.claim("w")
        if lease is None:
            break
        queue.ack(lease)
    clock.advance(1.0)
    sup.tick()                                   # idle timer starts
    clock.advance(11.0)
    st = sup.tick()
    assert st["target"] == 0 and st["retiring"] == 3
    assert all(p.signals == [sig.SIGTERM] for p in spawned)
    assert obs_metrics.counter("fleet_scale_down_total").value == 1
    # Within grace: no SIGKILL yet.
    clock.advance(5.0)
    sup.tick()
    assert all(sig.SIGKILL not in p.signals for p in spawned)
    # Past grace: escalation.
    clock.advance(16.0)
    sup.tick()
    assert all(p.signals == [sig.SIGTERM, sig.SIGKILL] for p in spawned)
    # They die; the registry of workers empties and run() would exit.
    for p in spawned:
        p.returncode = -9
    sup.tick()
    assert sup.workers == {}


def test_supervisor_adopts_orphans_not_double_spawns(harness, queue, clock):
    """A restarted supervisor must adopt live registered workers (by
    pid) instead of spawning a second fleet over them."""
    from firebird_tpu_torch.obs import jsonlog

    sup, spawned = harness
    queue.worker_register("h:live", os.getpid(), kind="batch",
                          host=jsonlog.HOST)
    for i in range(4):
        queue.enqueue("detect", {"n": i})
    st = sup.tick()
    # Target 2 = ceil(4/2); one slot is the adopted orphan (our own live
    # pid), so only ONE new worker spawns.
    assert st["adopted_total"] == 1
    assert len(spawned) == 1
    assert st["live"] == 2
    # Stream workers are a separate pool: never adopted as batch.
    queue.worker_register("h:stream", os.getpid() + 1, kind="stream")
    clock.advance(1.0)
    st = sup.tick()
    assert st["adopted_total"] == 1


def test_supervisor_refuses_recycled_pid(harness, queue, clock):
    """A registry row whose pid names a process that started AFTER the
    row was written is a recycled pid (an unrelated process wearing a
    dead worker's number): pruned, never adopted or signalled."""
    from firebird_tpu_torch.obs import jsonlog

    sup, spawned = harness
    queue.worker_register("h:old", os.getpid(), kind="batch",
                          host=jsonlog.HOST)
    (row,) = queue.workers()
    sup._proc_start = lambda pid: row["started"] + 100.0
    sup.tick()
    assert sup.workers == {}                     # never adopted
    assert queue.workers() == []                 # row pruned
    # A start time BEFORE registration is the legitimate case: adopt.
    queue.worker_register("h:new", os.getpid(), kind="batch",
                          host=jsonlog.HOST)
    (row,) = queue.workers()
    sup._proc_start = lambda pid: row["started"] - 1.0
    clock.advance(1.0)
    st = sup.tick()
    assert st["adopted_total"] == 1


def test_retired_worker_exit_is_not_circuit_food(harness, queue, clock):
    """A worker the supervisor itself retired — even one it SIGKILLed
    past grace — must not feed the crash-loop circuit: deliberate
    escalation is not a crash-looping payload."""
    import signal as sig

    sup, spawned = harness
    for i in range(10):
        queue.enqueue("detect", {"n": i})
    sup.tick()
    assert len(spawned) == 5
    # Drain; idle window elapses; all 5 retire.
    while True:
        lease = queue.claim("w")
        if lease is None:
            break
        queue.ack(lease)
    sup.tick()
    clock.advance(11.0)
    sup.tick()
    # All ignore SIGTERM past grace: the supervisor SIGKILLs all 5
    # inside one crash window — and the circuit must NOT trip.
    clock.advance(21.0)
    sup.tick()
    for p in spawned:
        assert sig.SIGKILL in p.signals
        p.returncode = -9
    clock.advance(1.0)
    st = sup.tick()
    assert st["tallies"]["crashed"] == 0
    assert st["tallies"]["parked"] == 0 and st["parks"] == []


def test_supervisor_ignores_foreign_host_rows(harness, queue, clock):
    """Rows registered from OTHER hosts (shared queue db) are another
    supervisor's: their pid numbers mean nothing locally — never
    adopted, never signalled, never pruned."""
    sup, spawned = harness
    queue.worker_register("far:123", os.getpid(), kind="batch",
                          host="some-other-host")
    st = sup.tick()
    assert st["adopted_total"] == 0 and sup.workers == {}
    (row,) = queue.workers()                     # row untouched
    assert row["host"] == "some-other-host"


def test_supervisor_prunes_dead_rows_and_counts_crash(harness, queue,
                                                     clock):
    """A registry row whose pid is gone is an abnormal exit: the row is
    pruned so re-delivery accounting stays clean."""
    sup, spawned = harness
    queue.worker_register("h:dead", 2 ** 22 + 12345, kind="batch")
    sup.tick()
    assert queue.workers() == []                 # pruned
    assert sup.workers == {}                     # never adopted


def test_supervisor_crash_loop_parks(harness, queue, clock):
    import signal as sig

    sup, spawned = harness
    for i in range(50):
        queue.enqueue("detect", {"n": i})
    sup.tick()
    assert len(spawned) == 5
    # Kill the whole fleet abnormally, three bursts: the circuit trips
    # (crash_limit=3) and capacity shrinks below max on the respawn.
    for p in spawned[:3]:
        p.returncode = 1
    clock.advance(1.0)
    st = sup.tick()
    assert st["tallies"]["crashed"] == 3
    assert st["tallies"]["parked"] >= 1
    assert len(st["parks"]) >= 1
    assert obs_metrics.counter("fleet_scale_park_total").value >= 1
    # Live + newly spawned stays under the parked cap.
    assert st["live"] <= 5 - len(st["parks"])


def test_supervisor_run_until_drained_scales_to_zero(harness, queue,
                                                     clock):
    """run(until_drained=True) exits only after the queue drained AND
    every worker retired/exited — the scale-to-zero proof shape."""
    sup, spawned = harness
    queue.enqueue("detect", {"n": 0})

    def sleep(sec):
        # The world advances between ticks: workers drain the queue,
        # then exit cleanly once it is empty (the --until-drained
        # worker behavior), while the clock moves past every window.
        lease = queue.claim("w")
        if lease is not None:
            queue.ack(lease)
        elif queue.drained():
            for p in spawned:
                if p.returncode is None and sig_count(p):
                    p.returncode = 0
        clock.advance(4.0)

    def sig_count(p):
        import signal as sig
        return sig.SIGTERM in p.signals

    sup._sleep = sleep
    summary = sup.run(until_drained=True)
    assert summary["queue"]["done"] == 1
    assert sup.workers == {}
    assert not summary["wedged"]
    st = queue.supervisor_state()
    assert st["target"] == 0 and st["live"] == 0
    assert obs_metrics.gauge("fleet_workers_live").value == 0
    assert any("scale to zero" in d["reason"] for d in summary["decisions"])


def test_supervisor_run_wedged_exits(harness, queue, clock):
    """Pending work blocked behind a dead letter with nothing live:
    spawning more workers cannot help — run() exits wedged."""
    sup, spawned = harness
    d = queue.enqueue("detect", {}, max_attempts=1)
    queue.enqueue("classify", {}, depends_on=[d])
    lease = queue.claim("w")
    queue.fail(lease, RuntimeError("boom"))      # dead-letters d

    def sleep(sec):
        for p in spawned:
            if p.returncode is None:
                p.returncode = 4                 # workers exit wedged
        clock.advance(2.0)

    sup._sleep = sleep
    summary = sup.run(until_drained=True)
    assert summary["wedged"]


def test_drain_eta_gauge_feeds_slo(harness, queue, clock):
    from firebird_tpu_torch.obs import slo as slomod

    sup, spawned = harness
    for i in range(4):
        queue.enqueue("detect", {"n": i})
    lease = queue.claim("w")
    queue.ack(lease)                             # rate evidence
    sup.tick()
    g = obs_metrics.gauge("queue_drain_eta_seconds").value
    assert g == pytest.approx(3 / (1 / 60.0))    # 3 open / (1 ack/60s)
    verdict = slomod.evaluate_snapshot(
        obs_metrics.get_registry().snapshot(), spec="drain_eta=10000")
    (obj,) = verdict["objectives"]
    assert obj["name"] == "drain_eta" and obj["ok"] is True
    verdict = slomod.evaluate_snapshot(
        obs_metrics.get_registry().snapshot(), spec="drain_eta=10")
    assert verdict["ok"] is False


def test_worker_cmd_floor_workers_do_not_self_exit(harness, tmp_path,
                                                   queue, clock):
    """A min_workers floor must be held by workers that poll idle:
    --until-drained floor workers would exit the moment the queue
    empties and the supervisor would respawn them forever (spawn/exit
    churn on an idle queue) — floored fleets spawn --hold-idle."""
    sup, _ = harness                             # min 0
    assert "--until-drained" in sup._worker_cmd()
    assert "--hold-idle" not in sup._worker_cmd()
    assert "--drain-on-term" in sup._worker_cmd()
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_db=queue.path)
    floored = Supervisor(
        cfg, queue, policy=ScalePolicy(1, 5, clock=clock),
        spawn=lambda: None, clock=clock, sleep=lambda s: None)
    assert "--until-drained" not in floored._worker_cmd()
    assert "--hold-idle" in floored._worker_cmd()
    assert "--drain-on-term" in floored._worker_cmd()


def test_hold_idle_worker_polls_empty_queue_as_batch(tmp_path, queue):
    """`fleet work --hold-idle` must NOT exit on an empty queue (the
    floor-churn bug: a plain batch worker breaks on its first failed
    claim) and must register kind=batch so the policy counts it as
    drain capacity, unlike --forever's kind=stream."""
    import threading

    from firebird_tpu_torch.fleet.worker import FleetWorker

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_db=queue.path)
    polls = []

    def nap(sec):
        polls.append(sec)
        if len(polls) >= 3:          # held through 3 empty claims
            stop.set()

    worker = FleetWorker(cfg, queue, device="cpu", kind="batch", sleep=nap)
    stop = threading.Event()
    # The CLI maps --hold-idle to run(forever=True) with kind="batch"
    # (cli.fleet_work); an empty queue must poll, not break.
    summary = worker.run(forever=True, stop=stop)
    assert len(polls) >= 3 and summary["executed"] == 0
    assert not summary["wedged"]


def test_spawn_capped_by_retiring_processes(harness, queue, clock):
    """Retiring workers are still processes: a retire-then-burst cycle
    must not transiently run ~2x max_workers on the host."""
    sup, spawned = harness                       # max 5
    for i in range(10):
        queue.enqueue("detect", {"n": i})
    sup.tick()
    assert len(spawned) == 5                     # ceil(10/2), at max
    sup._retire(5)                               # all draining, all alive
    clock.advance(1.0)
    sup.tick()
    # Demand still wants 5 and live is 0, but 5 processes are draining:
    # no headroom, no spawn.
    assert len(spawned) == 5
    for p in spawned:                            # drains finish
        p.returncode = 0
    clock.advance(1.0)
    sup.tick()
    assert len(spawned) == 10                    # headroom restored
    assert len(sup.workers) == 5


def test_policy_parks_is_read_only(clock):
    """parks() runs on the ops HTTP thread concurrently with the tick
    thread's record_exit: it must never rebind/sweep _parks (a racing
    sweep could drop a just-appended park).  decide() sweeps."""
    p = policy(clock)
    now = clock()
    for _ in range(3):
        assert not p.record_exit(1, now=now) or True
    assert len(p._parks) == 1                    # circuit tripped
    inner = p._parks
    clock.advance(10_000.0)                      # way past any park cap
    assert p.parks() == []                       # expired: filtered out
    assert p._parks is inner and len(inner) == 1  # ...but NOT swept
    p.decide(snap(clock), live=0)                # tick thread sweeps
    assert p._parks == []


def test_drain_out_escalates_before_exit(harness, queue, clock):
    """Operator stop: drain_out must wait out the SIGTERM grace and
    actually SIGKILL a wedged worker before the supervisor exits —
    otherwise the worker outlives its supervisor as an orphan."""
    import signal as sig

    sup, spawned = harness                       # grace 20
    for i in range(4):
        queue.enqueue("detect", {"n": i})
    sup.tick()
    assert len(spawned) == 2
    sup._sleep = clock.advance                   # drain_out's clock
    assert sup.drain_out(timeout=60.0) is False  # they never die
    for p in spawned:
        assert p.signals[0] == sig.SIGTERM
        assert sig.SIGKILL in p.signals          # escalation ran
    assert sup.tallies["killed"] == 2
    for p in spawned:
        p.returncode = -9
    assert sup.drain_out(timeout=5.0) is True
    assert sup.workers == {}
    # Supervisor-initiated retirement, however it ended: not circuit food.
    assert sup.tallies["crashed"] == 0


def test_until_drained_exits_through_min_floor(tmp_path, queue, clock):
    """--until-drained with min_workers > 0: the floor does not hold
    past a full drain — run() retires the floor worker ONCE (no
    spawn/retire churn) and exits recording scale-to-zero."""
    import signal as sig

    spawned = []

    def spawn():
        p = FakeProc()
        spawned.append(p)
        return p

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_db=queue.path)
    sup = Supervisor(
        cfg, queue,
        policy=ScalePolicy(1, 5, up_after_sec=0.0, idle_after_sec=10.0,
                           clock=clock, rng=random.Random(3)),
        spawn=spawn, grace_sec=20.0, clock=clock,
        proc_start=lambda pid: None)

    def sleep(sec):
        for p in spawned:                        # drain-on-term exit
            if p.returncode is None and sig.SIGTERM in p.signals:
                p.returncode = 0
        clock.advance(2.0)

    sup._sleep = sleep
    summary = sup.run(until_drained=True)
    assert len(spawned) == 1                     # the floor, exactly once
    assert summary["retired"] == 1 and not summary["wedged"]
    assert sup.workers == {}
    st = queue.supervisor_state()
    assert st["target"] == 0 and st["live"] == 0
    assert any("scale to zero" in d["reason"] for d in summary["decisions"])


def test_wedged_exit_is_not_crash_circuit_food(harness, queue, clock):
    """A worker exiting WEDGED_EXIT made a deliberate self-report
    (pending work all blocked behind dead deps): counting it as a
    crash would trip the circuit and park slots for a condition
    backoff cannot fix."""
    from firebird_tpu_torch.fleet import WEDGED_EXIT

    sup, spawned = harness
    for _ in range(4):                           # 4 wedged exits > limit
        queue.enqueue("detect", {"n": 1})
        sup.tick()
        for p in spawned:
            if p.returncode is None:
                p.returncode = WEDGED_EXIT
        # Drain the queue so the next tick's spawn has fresh demand.
        lease = queue.claim("w")
        if lease is not None:
            queue.ack(lease)
        clock.advance(1.0)
    sup._reap_and_adopt()
    assert sup.tallies["crashed"] == 0
    assert sup.tallies["parked"] == 0
    assert sup.policy.parks() == []
    assert sup.tallies["clean_exits"] >= 1


def test_retire_picks_newest_by_supervision_order(harness, queue, clock):
    """Scale-down retires the most recently spawned worker, by seq —
    not by pid, which wraps and misorders adopted orphans."""
    sup, spawned = harness
    for i in range(8):
        queue.enqueue("detect", {"n": i})
    sup.tick()                                   # spawns 4 (ceil 8/2)
    assert len(spawned) == 4
    # Oldest worker wears the numerically HIGHEST pid (wraparound).
    oldest, newest = spawned[0], spawned[-1]
    old_pid, new_pid = oldest.pid, newest.pid
    del sup.workers[old_pid], sup.workers[new_pid]
    oldest.pid, newest.pid = new_pid, old_pid
    from firebird_tpu_torch.fleet.supervisor import _Spawned
    sup.workers[oldest.pid] = _Spawned(oldest.pid, oldest, seq=1)
    sup.workers[newest.pid] = _Spawned(newest.pid, newest, seq=4)
    sup._retire(1)
    assert newest.signals and not oldest.signals


def test_scale_up_counter_requires_a_successful_spawn(tmp_path, queue,
                                                      clock):
    """fleet_scale_up_total counts scale-ups ACTED ON: a tick whose
    every spawn attempt fails must not increment it."""
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_db=queue.path)

    def failing_spawn():
        raise OSError("fork: ENOMEM")

    sup = Supervisor(
        cfg, queue,
        policy=ScalePolicy(0, 5, jobs_per_worker=2.0, up_after_sec=0.0,
                           idle_after_sec=10.0, clock=clock,
                           rng=random.Random(3)),
        spawn=failing_spawn, grace_sec=20.0, clock=clock,
        sleep=lambda s: None, proc_start=lambda pid: None)
    queue.enqueue("detect", {"n": 1})
    st = sup.tick()
    assert st["tallies"]["spawned"] == 0
    assert obs_metrics.counter("fleet_scale_up_total").value == 0


def test_pid_alive_treats_eperm_as_alive(monkeypatch):
    """os.kill(pid, 0) raising EPERM means the process EXISTS (another
    user owns it): pruning its registry row would orphan a live worker
    forever."""
    from firebird_tpu_torch.fleet import supervisor as supmod

    def eperm_kill(pid, sig):
        raise PermissionError(1, "Operation not permitted")

    monkeypatch.setattr(supmod.os, "kill", eperm_kill)
    # /proc read of a foreign pid may also fail — still alive.
    assert supmod.pid_alive(999999) is True


def test_supervisor_run_survives_transient_queue_errors(harness, queue,
                                                        clock):
    """One sqlite 'database is locked' burst mid-run must not kill the
    control plane and orphan the fleet: the loop logs, skips the tick,
    and recovers on the next one."""
    import sqlite3
    import threading

    sup, spawned = harness
    queue.enqueue("detect", {"n": 1})
    real_snapshot = queue.scale_snapshot
    fails = {"n": 2}

    def flaky_snapshot(**kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise sqlite3.OperationalError("database is locked")
        return real_snapshot(**kw)

    queue.scale_snapshot = flaky_snapshot
    stop = threading.Event()
    ticks = {"n": 0}

    def sleep(sec):
        ticks["n"] += 1
        clock.advance(2.0)
        for p in spawned:                        # workers drain the job
            if p.returncode is None:
                lease = queue.claim("w")
                if lease is not None:
                    queue.ack(lease)
                p.returncode = 0
        if ticks["n"] > 20:
            stop.set()
    sup._sleep = sleep
    summary = sup.run(until_drained=True, stop=stop)
    assert fails["n"] == 0                       # both failures consumed
    assert len(spawned) >= 1                     # fleet still scaled up
    assert summary["queue"]["done"] == 1


def test_until_drained_exits_past_open_stream_jobs(harness, queue, clock):
    """Stream jobs must not gate the supervisor's drain exit: the
    policy provisions no batch capacity for them, so a watcher feeding
    stream jobs would pin `supervise --until-drained` open forever at
    target 0."""
    import signal as sig
    import threading

    sup, spawned = harness
    queue.enqueue("detect", {"n": 1})
    queue.enqueue("stream", {"cx": 0, "cy": 0})  # standing fleet's job
    assert not queue.drained()
    assert not queue.drained(batch_only=True)    # batch work open

    stop = threading.Event()
    ticks = {"n": 0}

    def sleep(sec):
        ticks["n"] += 1
        clock.advance(2.0)
        for p in spawned:                        # drain the BATCH job
            if p.returncode is None:
                lease = queue.claim("w")
                if lease is not None and lease.job_type == "detect":
                    queue.ack(lease)
                if sig.SIGTERM in p.signals:
                    p.returncode = 0
        if ticks["n"] > 30:
            stop.set()                           # would mean: hung
    sup._sleep = sleep
    summary = sup.run(until_drained=True, stop=stop)
    assert not stop.is_set()                     # exited by itself
    assert not summary["wedged"]
    assert queue.drained(batch_only=True)
    assert not queue.drained()                   # stream job still open


def test_pruned_live_worker_reregisters_on_next_beat(tmp_path, queue,
                                                     clock):
    """A supervisor that misreads a live worker's pid as dead prunes
    its row; the worker's next beat must resurrect it (worker_beat
    returns False -> re-register), or it stays invisible to adoption
    and gets double-spawned over forever."""
    from firebird_tpu_torch.fleet.worker import FleetWorker

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_db=queue.path)
    worker = FleetWorker(cfg, queue, device="cpu", kind="batch")
    queue.worker_register(worker.worker_id, os.getpid(), kind="batch",
                          host="h")
    assert queue.worker_beat(worker.worker_id, acked=1) is True
    queue.worker_deregister(worker.worker_id)    # the misread prune
    assert queue.worker_beat(worker.worker_id) is False
    worker._worker_beat()                        # worker's next beat
    (row,) = queue.workers()
    assert row["pid"] == os.getpid()


def test_reregistration_refreshes_started_stamp(queue, clock):
    """worker_id is host:pid — after a reboot a recycled pid collides
    with a crashed worker's durable row, and a stale `started` stamp
    would make the recycled-pid guard prune the LIVE worker."""
    queue.worker_register("h:77", 77, kind="batch", host="h")
    clock.advance(1000.0)                        # host reboots, pid reused
    queue.worker_register("h:77", 77, kind="batch", host="h")
    (row,) = queue.workers()
    assert row["started"] == clock.t             # refreshed, not stale
    assert row["up_sec"] == 0.0


def test_idle_worker_beats_and_recovers_pruned_row(tmp_path, queue):
    """An idle --hold-idle floor worker must keep beating (or it reads
    as dead in `fleet status`) and must re-register if its row was
    pruned while it idled — the prune-recovery path only runs from
    _worker_beat, which the idle loop must therefore reach."""
    import threading

    from firebird_tpu_torch.fleet.worker import FleetWorker

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_db=queue.path)
    rows = {"n": None}
    polls = []

    def nap(sec):
        polls.append(sec)
        if len(polls) == 1:
            # A supervisor misread prunes the idle worker's row.
            queue.worker_deregister(worker.worker_id)
        if len(polls) == 2:
            # The idle branch's beat between poll 1 and 2 must have
            # re-registered the pruned row (run() deregisters on clean
            # exit, so observe mid-flight).
            rows["n"] = len(queue.workers())
            stop.set()

    worker = FleetWorker(cfg, queue, device="cpu", kind="batch", sleep=nap)
    stop = threading.Event()
    worker.run(forever=True, stop=stop)
    assert rows["n"] == 1


def test_supervise_never_initialises_cuda(tmp_path, queue, monkeypatch,
                                         capsys):
    """The supervisor runs no kernels: ``fleet supervise`` (its ops
    surface up, its spool armed) must not ask CUDA anything, or it would
    hold the card its spawned workers need.  Every torch.cuda entry the
    port's ops surface could reach is replaced by a recorder."""
    from firebird_tpu_torch import __main__ as tmain

    touched = []
    for name in ("is_available", "device_count", "init", "_lazy_init",
                 "current_device", "get_device_name", "mem_get_info",
                 "max_memory_allocated", "synchronize"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **k: touched.append(_n))
    monkeypatch.setenv("FIREBIRD_STORE_PATH", str(tmp_path / "s.db"))
    monkeypatch.setenv("FIREBIRD_FLEET_DB", queue.path)
    monkeypatch.setenv("FIREBIRD_OPS_PORT", "0")
    tmain.main(["fleet", "supervise", "--until-drained", "--tick", "0.01"])
    out = capsys.readouterr().out
    assert '"wedged": false' in out
    assert touched == []
    assert not torch.cuda.is_initialized()
    # the spool is armed with the supervisor's role
    assert any(f.startswith("spool.supervisor.")
               for f in os.listdir(tmp_path / "telemetry"))


def test_worker_cmd_spawns_the_port(harness):
    """The spawned worker is the port's command, never the JAX
    package's."""
    import sys

    sup, _ = harness
    cmd = sup._worker_cmd()
    assert cmd[:5] == [sys.executable, "-m", "firebird_tpu_torch", "fleet",
                       "work"]
    assert not any("firebird_tpu.cli" in c for c in cmd)


def test_until_drained_exits_wedged_through_min_floor(tmp_path, queue,
                                                      clock):
    """A wedged queue under a min_workers floor: the --hold-idle floor
    never self-exits and can claim nothing, so run() must retire it
    and exit wedged instead of spinning forever."""
    import signal as sig
    import threading

    spawned = []

    def spawn():
        p = FakeProc()
        spawned.append(p)
        return p

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_db=queue.path)
    sup = Supervisor(
        cfg, queue,
        policy=ScalePolicy(1, 5, up_after_sec=0.0, idle_after_sec=10.0,
                           clock=clock, rng=random.Random(3)),
        spawn=spawn, grace_sec=20.0, clock=clock,
        proc_start=lambda pid: None)
    # Wedge: a dead upstream with a blocked downstream.
    up = queue.enqueue("detect", {"poison": 1}, max_attempts=1)
    queue.enqueue("product", {"n": 1}, depends_on=[up])
    lease = queue.claim("w0")
    queue.fail(lease, "poison")
    assert queue.wedged()

    stop = threading.Event()
    ticks = {"n": 0}

    def sleep(sec):
        ticks["n"] += 1
        clock.advance(2.0)
        for p in spawned:                        # drain-on-term exit
            if p.returncode is None and sig.SIGTERM in p.signals:
                p.returncode = 0
        if ticks["n"] > 30:
            stop.set()                           # would mean: hung
    sup._sleep = sleep
    summary = sup.run(until_drained=True, stop=stop)
    assert not stop.is_set()                     # exited by itself
    assert summary["wedged"] is True
    assert sup.workers == {}


def test_second_live_supervisor_is_refused(tmp_path, queue, clock,
                                           monkeypatch):
    """Two live supervisors on one queue would adopt each other's
    workers and jointly run ~2x max_workers: a fresh same-host
    heartbeat with a live pid refuses startup; a dead predecessor's
    (SIGKILL) passes."""
    from firebird_tpu_torch.fleet import supervisor as supmod
    from firebird_tpu_torch.obs import jsonlog

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_db=queue.path)
    sup = Supervisor(cfg, queue,
                     policy=ScalePolicy(0, 5, clock=clock),
                     spawn=lambda: None, clock=clock,
                     sleep=lambda s: None, proc_start=lambda pid: None)
    # A LIVE predecessor: fresh beat, live pid (this test process).
    queue.supervisor_heartbeat({"pid": os.getpid() + 0, "host":
                                jsonlog.HOST, "target": 1})
    monkeypatch.setattr(supmod.os, "getpid", lambda: 99999)
    with pytest.raises(RuntimeError, match="another supervisor"):
        sup._refuse_live_predecessor()
    # A DEAD predecessor (SIGKILLed): fresh beat but dead pid — adopts.
    queue.supervisor_heartbeat({"pid": 4194000, "host": jsonlog.HOST,
                                "target": 1})
    sup._refuse_live_predecessor()               # no raise
    # A STALE same-pid-recycling case: beat far in the past — passes.
    queue.supervisor_heartbeat({"pid": os.getpid(), "host": jsonlog.HOST,
                                "target": 1})
    clock.advance(1000.0)
    sup._refuse_live_predecessor()               # no raise


def test_recent_dead_rows_feed_circuit_stale_rows_do_not(tmp_path, queue,
                                                         clock):
    """Registry rows of never-supervised dead workers: a RECENT beat is
    a crash-storm continuation across a supervisor restart (circuit
    food); an hours-stale row (host reboot) prunes silently."""
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_db=queue.path)
    sup = Supervisor(
        cfg, queue,
        policy=ScalePolicy(0, 5, crash_limit=3, crash_window_sec=60.0,
                           clock=clock, rng=random.Random(3)),
        spawn=lambda: None, clock=clock, sleep=lambda s: None,
        proc_start=lambda pid: None)
    # Three dead rows with fresh beats (a predecessor's crash storm) —
    # pids that cannot be alive.
    for i in range(3):
        queue.worker_register(f"h:{4194100 + i}", 4194100 + i,
                              kind="batch", host=None)
    sup._reap_and_adopt()
    assert sup.tallies["crashed"] == 3
    assert sup.tallies["parked"] == 1            # limit 3 in window
    assert queue.workers() == []                 # rows pruned
    # A stale row: beat far outside the crash window — silent prune.
    queue.worker_register("h:4194200", 4194200, kind="batch", host=None)
    clock.advance(3600.0)
    before = sup.tallies["crashed"]
    sup._reap_and_adopt()
    assert sup.tallies["crashed"] == before
    assert queue.workers() == []


def test_fleet_work_retires_on_sigterm_without_a_postmortem(
        tmp_path, queue, monkeypatch, capsys):
    """``fleet work --hold-idle --drain-on-term``, the supervisor's floor
    worker, polls an empty queue until SIGTERM, then exits cleanly: the
    retirement is its graceful drain, so the flight recorder (armed by
    its ops surface) writes no postmortem, and its registry row goes."""
    import signal
    import threading
    import time

    from firebird_tpu_torch import __main__ as tmain
    from firebird_tpu_torch.driver import core

    monkeypatch.setattr(core, "run_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setenv("FIREBIRD_STORE_PATH", str(tmp_path / "s.db"))
    monkeypatch.setenv("FIREBIRD_FLEET_DB", queue.path)
    monkeypatch.setenv("FIREBIRD_OPS_PORT", "0")
    before = signal.getsignal(signal.SIGTERM)

    def retire():
        deadline = time.monotonic() + 30.0
        while signal.getsignal(signal.SIGTERM) is before or \
                not queue.workers():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=retire, daemon=True)
    t.start()
    tmain.main(["fleet", "work", "--hold-idle", "--drain-on-term",
                "--poll", "0.05"])
    t.join(timeout=5)
    out = capsys.readouterr().out
    assert '"executed": 0' in out and '"wedged": false' in out
    assert not (tmp_path / "postmortem.json").exists()
    assert queue.workers() == []
    assert signal.getsignal(signal.SIGTERM) is before

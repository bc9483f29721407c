"""The port's fleet against the JAX package's, on the CPU: the lease
queue, the plan builder and the worker (firebird_tpu_torch/fleet/).

The JAX package's tests/test_fleet.py cases on the port's modules, on the
same injected clock: lease expiry, zombie fencing, dead-lettering and
dependency gating are exact clock arithmetic, no sleeps.  Then the
formats carried across: the queue file (a job either package enqueues is
claimed, heartbeated, acked or failed by the other), ``status()`` and
``counts()`` equal to the JAX package's after the same operations, and
the run manifest's fence stamp.  Then the worker's real handlers on the
CPU (``FleetWorker(..., device="cpu")``): detect jobs drained by the
port's worker store the rows of the port's direct ``changedetection`` run
and of the JAX package's worker draining the same plan (whole chips of
the tiny sensor), a re-delivered plan skips stored chips, a ``lease:p=1``
zombie's writes are rejected and counted, and a classify job and a
product job leave the rows of the direct classification and product run.
"""

import dataclasses
import functools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from firebird_tpu import fleet as jfleet
from firebird_tpu.config import Config as JConfig
from firebird_tpu.fleet import plan as jplan
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch import grid
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import core
from firebird_tpu_torch.fleet import (FencedStore, FleetQueue, FleetWorker,
                                      LeaseLost, StaleFence,
                                      enqueue_tile_plan, queue_path)
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.store import MemoryStore, SqliteStore

ACQ = "1995-01-01/1997-06-01"


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
    jmetrics.reset_registry()
    yield
    obs_metrics.reset_registry()
    jmetrics.reset_registry()


# ---------------------------------------------------------------------------
# Queue protocol
# ---------------------------------------------------------------------------

def test_enqueue_claim_ack_roundtrip(queue):
    a = queue.enqueue("detect", {"cids": [[1, 2]]})
    b = queue.enqueue("detect", {"cids": [[3, 4]]})
    lease = queue.claim("w1")
    assert lease.job_id == a and lease.payload == {"cids": [[1, 2]]}
    assert lease.fence == 1 and lease.attempts == 1
    lease2 = queue.claim("w2")
    assert lease2.job_id == b and lease2.fence == 2   # monotonic tokens
    queue.ack(lease)
    queue.ack(lease2)
    assert queue.claim("w1") is None
    assert queue.counts() == {"pending": 0, "leased": 0, "done": 2,
                              "dead": 0}
    assert queue.drained()
    hist = [h["event"] for h in queue.job(a)["history"]]
    assert hist == ["enqueued", "claimed", "acked"]


def test_enqueue_validates(queue):
    with pytest.raises(ValueError, match="job_type"):
        queue.enqueue("mine-bitcoin", {})
    with pytest.raises(ValueError, match="max_attempts"):
        queue.enqueue("detect", {}, max_attempts=0)
    with pytest.raises(ValueError, match="unknown job ids"):
        queue.enqueue("detect", {}, depends_on=[999])


def test_dependencies_gate_claims(queue):
    d1 = queue.enqueue("detect", {"n": 1})
    d2 = queue.enqueue("detect", {"n": 2})
    c = queue.enqueue("classify", {}, depends_on=[d1, d2])
    assert queue.job(c)["depends_on"] == [d1, d2]
    l1 = queue.claim("w")
    l2 = queue.claim("w")
    assert {l1.job_id, l2.job_id} == {d1, d2}
    assert queue.claim("w") is None          # classify still blocked
    assert queue.status()["blocked"] == 1
    queue.ack(l1)
    assert queue.claim("w") is None          # one dep is not all deps
    queue.ack(l2)
    lc = queue.claim("w")                    # unblocks on the LAST ack
    assert lc is not None and lc.job_id == c


def test_lease_expiry_requeues_with_history(queue, clock):
    jid = queue.enqueue("detect", {"n": 1}, max_attempts=5)
    stale = queue.claim("w1")
    clock.advance(31.0)                       # past lease_sec=30
    fresh = queue.claim("w2")                 # re-delivery
    assert fresh.job_id == jid
    assert fresh.fence == stale.fence + 1 and fresh.attempts == 2
    events = [h["event"] for h in queue.job(jid)["history"]]
    assert events == ["enqueued", "claimed", "lease_expired", "claimed"]
    # the zombie's protocol ops all reject
    with pytest.raises(LeaseLost):
        queue.heartbeat(stale)
    with pytest.raises(StaleFence):
        queue.ack(stale)
    with pytest.raises(StaleFence):
        queue.fail(stale, RuntimeError("late report"))
    assert queue.fence_rejects() == 3
    # the successor is untouched by the zombie's noise
    queue.heartbeat(fresh)
    queue.ack(fresh)
    assert queue.job(jid)["state"] == "done"
    assert obs_metrics.counter("fleet_jobs_requeued").value == 1


def test_heartbeat_extends_lease(queue, clock):
    queue.enqueue("detect", {})
    lease = queue.claim("w")
    clock.advance(20.0)
    queue.heartbeat(lease)                    # extends to t+20+30
    clock.advance(20.0)                       # t+40 < t+50: still live
    assert queue.fence_valid(lease.job_id, lease.fence)
    queue.ack(lease)
    assert queue.job(lease.job_id)["state"] == "done"


def test_expired_unreclaimed_lease_is_invalid(queue, clock):
    """Fencing is symmetric: once the lease lapses, writes AND ack both
    reject even before anyone re-claims — a zombie can never slip output
    in during the gap between expiry and re-delivery."""
    queue.enqueue("detect", {})
    lease = queue.claim("w")
    clock.advance(31.0)
    assert not queue.fence_valid(lease.job_id, lease.fence)
    with pytest.raises(StaleFence):
        queue.ack(lease)


class _RecordingStore:
    def __init__(self):
        self.writes = []

    def write(self, table, frame):
        self.writes.append((table, frame))
        return 1

    def chip_ids(self, table="segment"):
        return set()


def test_zombie_write_fencing(queue, clock):
    jid = queue.enqueue("detect", {})
    stale = queue.claim("w1")
    inner = _RecordingStore()
    fenced = FencedStore(inner, queue, stale)
    fenced.write("chip", {"cx": [1]})         # live lease: passes through
    assert len(inner.writes) == 1
    clock.advance(31.0)
    fresh = queue.claim("w2")                 # successor owns the job now
    with pytest.raises(StaleFence):
        fenced.write("chip", {"cx": [1]})
    assert len(inner.writes) == 1             # zero stale writes accepted
    assert queue.fence_rejects("write") == 1
    assert queue.fence_rejects() == 1
    # reads pass through untouched (fencing is write-side only)
    assert fenced.chip_ids() == set()
    succ = FencedStore(inner, queue, fresh)
    succ.write("chip", {"cx": [1]})
    assert len(inner.writes) == 2
    queue.ack(fresh)
    assert queue.job(jid)["state"] == "done"


def test_fail_requeues_then_dead_letters(queue, clock):
    jid = queue.enqueue("detect", {}, max_attempts=2)
    lease = queue.claim("w")
    assert queue.fail(lease, RuntimeError("boom")) == "pending"
    lease = queue.claim("w")
    assert lease.attempts == 2
    assert queue.fail(lease, ValueError("worse")) == "dead"
    assert queue.claim("w") is None
    st = queue.status()
    assert st["jobs"]["dead"] == 1
    assert st["dead_errors"] == {"ValueError": 1}
    assert st["dead"][0]["job"] == jid and st["dead"][0]["attempts"] == 2
    # operator revival: fresh attempt budget, claimable again
    assert queue.requeue(jid) == 1
    lease = queue.claim("w")
    assert lease is not None and lease.attempts == 1
    queue.ack(lease)


def test_expired_lease_crashloop_dead_letters(queue, clock):
    """A payload that kills its worker every time must not wedge the
    fleet: the attempt budget counts expired leases too."""
    queue.enqueue("detect", {}, max_attempts=1)
    queue.claim("w1")
    clock.advance(31.0)
    assert queue.claim("w2") is None          # dead-lettered, not re-leased
    st = queue.status()
    assert st["jobs"]["dead"] == 1
    assert st["dead_errors"] == {"LeaseExpired": 1}
    # an expiry that dead-letters was never RE-delivered: the requeue
    # counter must not move (only the dead counter does)
    assert obs_metrics.counter("fleet_jobs_requeued").value == 0
    assert obs_metrics.counter("fleet_jobs_dead").value == 1


def test_wedged_is_one_atomic_snapshot(queue, clock):
    """wedged() verdicts: blocked-behind-dead with nothing leased is
    wedged; blocked behind a LIVE lease or claimable work is not."""
    assert not queue.wedged()                 # empty queue: just drained
    d = queue.enqueue("detect", {}, max_attempts=1)
    c = queue.enqueue("classify", {}, depends_on=[d])
    assert not queue.wedged()                 # d is claimable
    lease = queue.claim("w")
    assert not queue.wedged()                 # d leased: progress possible
    queue.fail(lease, RuntimeError("boom"))   # max_attempts=1 -> dead
    assert queue.wedged()                     # c blocked behind dead d
    queue.requeue(d)
    assert not queue.wedged()                 # revived: claimable again
    assert c


def test_status_lease_view(queue, clock):
    queue.enqueue("detect", {})
    queue.claim("host-a:123")
    clock.advance(10.0)
    st = queue.status()
    (lease,) = st["leases"]
    assert lease["owner"] == "host-a:123"
    assert lease["age_sec"] == 10.0
    assert lease["expires_in_sec"] == 20.0
    assert st["by_type"]["detect"]["leased"] == 1
    assert st["fence_rejects"] == 0 and st["fence_rejects_by_op"] == {}


def test_queue_survives_reopen(tmp_path, clock):
    """The queue IS the durable state: a second FleetQueue over the same
    file (a restarted worker) sees jobs, leases, and the fence seq."""
    path = str(tmp_path / "fleet.db")
    q1 = FleetQueue(path, lease_sec=30.0, clock=clock)
    jid = q1.enqueue("detect", {"n": 1})
    lease = q1.claim("w1")
    q2 = FleetQueue(path, lease_sec=30.0, clock=clock)
    assert q2.job(jid)["state"] == "leased"
    clock.advance(31.0)
    fresh = q2.claim("w2")
    assert fresh.fence == lease.fence + 1     # seq continues across opens
    q2.ack(fresh)
    assert q1.job(jid)["state"] == "done"
    q1.close()
    q2.close()


def test_queue_path_rules(tmp_path):
    cfg = Config(store_backend="sqlite",
                 store_path=str(tmp_path / "fb.db"))
    assert queue_path(cfg) == str(tmp_path / "fleet.db")
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"),
                 fleet_db=str(tmp_path / "q" / "explicit.db"))
    assert queue_path(cfg) == str(tmp_path / "q" / "explicit.db")
    with pytest.raises(ValueError, match="FIREBIRD_FLEET_DB"):
        queue_path(Config(store_backend="memory"))


def test_fleet_config_validation():
    with pytest.raises(ValueError, match="FLEET_LEASE"):
        Config(fleet_lease_sec=0)
    with pytest.raises(ValueError, match="FLEET_HEARTBEAT"):
        Config(fleet_heartbeat_sec=-1)
    with pytest.raises(ValueError, match="shorter than the lease"):
        Config(fleet_lease_sec=5.0, fleet_heartbeat_sec=5.0)
    with pytest.raises(ValueError, match="FLEET_MAX_ATTEMPTS"):
        Config(fleet_max_attempts=0)
    cfg = Config.from_env(env={"FIREBIRD_FLEET_DB": "/x/q.db",
                               "FIREBIRD_FLEET_LEASE_SEC": "7",
                               "FIREBIRD_FLEET_HEARTBEAT_SEC": "2",
                               "FIREBIRD_FLEET_MAX_ATTEMPTS": "9"})
    assert (cfg.fleet_db, cfg.fleet_lease_sec, cfg.fleet_heartbeat_sec,
            cfg.fleet_max_attempts) == ("/x/q.db", 7.0, 2.0, 9)


def test_stale_fence_is_nonretryable():
    """A fencing rejection must short-circuit the retry policy: no
    backoff sleeps, no budget spend, no breaker strike."""
    from firebird_tpu_torch import retry as retrylib

    sleeps = []
    budget = retrylib.RetryBudget(10)
    breaker = retrylib.CircuitBreaker(1, cooldown_sec=30.0,
                                      clock=lambda: 0.0)
    policy = retrylib.RetryPolicy(3, budget=budget, breaker=breaker,
                                  sleep=sleeps.append)
    calls = []

    def fn():
        calls.append(1)
        raise StaleFence("fenced")

    class _Log:
        def warning(self, *a):
            pass

    with pytest.raises(StaleFence):
        policy.run(_Log(), "op", fn)
    assert len(calls) == 1 and sleeps == []
    assert budget.spent == 0
    assert breaker.state == retrylib.CLOSED


# ---------------------------------------------------------------------------
# Plan builder
# ---------------------------------------------------------------------------

def test_plan_builder_dependencies(queue):
    plan = enqueue_tile_plan(
        queue, [(100.0, 200.0), (150100.0, 200.0)], acquired=ACQ,
        number=4, chunk_size=2, msday=724204, meday=735598,
        products=["seglength"], product_dates=["1996-01-01"])
    assert plan["tiles"] == 2
    assert len(plan["detect"]) == 4           # 2 chunks x 2 tiles
    assert len(plan["classify"]) == 2 and len(plan["product"]) == 2
    assert plan["jobs"] == 8
    # per tile: classify depends on its 2 detect chunks, product on the
    # classify — cross-stage edges, not a fleet-wide phase barrier
    c0 = queue.job(plan["classify"][0])
    assert c0["depends_on"] == plan["detect"][:2]
    p0 = queue.job(plan["product"][0])
    assert p0["depends_on"] == [plan["classify"][0]]
    # every detect payload carries its chunk's chip ids + the acquired
    d0 = queue.job(plan["detect"][0])
    assert d0["payload"]["acquired"] == ACQ
    assert len(d0["payload"]["cids"]) == 2
    # the product job's bounds cover the SAME chips the detect stage
    # enqueued (a single tile point would cover one chip of the area)
    from firebird_tpu_torch.products import covering_chips
    detected = {tuple(c) for j in plan["detect"][:2]
                for c in map(tuple, queue.job(j)["payload"]["cids"])}
    covered = set(covering_chips(
        [tuple(b) for b in p0["payload"]["bounds"]]))
    assert detected <= covered


def test_plan_builder_validates(queue):
    with pytest.raises(ValueError, match="msday"):
        enqueue_tile_plan(queue, [(0, 0)], acquired=ACQ, msday=1)
    with pytest.raises(ValueError, match="product_dates"):
        enqueue_tile_plan(queue, [(0, 0)], acquired=ACQ,
                          products=["seglength"])


# ---------------------------------------------------------------------------
# Worker loop (toy handlers; injectable sleep — no waits)
# ---------------------------------------------------------------------------

def _worker(cfg, queue, handlers, **kw):
    return FleetWorker(cfg, queue, worker_id="t:1", handlers=handlers,
                       sleep=lambda s: None, device="cpu", **kw)


def test_worker_drains_toy_jobs(tmp_path, queue):
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"))
    ran = []
    w = _worker(cfg, queue, {"detect": lambda p, lease: ran.append(p["n"])})
    queue.enqueue("detect", {"n": 1})
    queue.enqueue("detect", {"n": 2})
    summary = w.run(until_drained=True)
    assert ran == [1, 2]
    assert summary["executed"] == 2 and summary["acked"] == 2
    assert summary["queue"]["done"] == 2 and not summary["wedged"]
    assert obs_metrics.counter("fleet_jobs_claimed").value == 2
    assert obs_metrics.counter("fleet_jobs_acked").value == 2
    # per-job-type latency histogram recorded under the dynamic name
    assert obs_metrics.histogram(
        "fleet_job_seconds_detect").snapshot()["count"] == 2


def test_worker_failure_requeues_then_dead_letters(tmp_path, queue):
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"))

    def boom(p, lease):
        raise RuntimeError("handler exploded")

    queue.enqueue("detect", {}, max_attempts=2)
    w = _worker(cfg, queue, {"detect": boom})
    summary = w.run(until_drained=True)
    assert summary["requeued"] == 1 and summary["dead"] == 1
    assert summary["queue"]["dead"] == 1 and not summary["wedged"]


def test_worker_abandons_on_stale_fence(tmp_path, queue, clock):
    """A StaleFence out of the handler (a fenced write rejecting) is an
    abandon, not a failure: no fail() report, the successor's queue
    state is untouched, and the loss is counted."""
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"))
    jid = queue.enqueue("detect", {})

    def zombie(p, lease):
        clock.advance(31.0)                   # lease lapses mid-job
        queue.claim("successor")              # and a successor re-claims
        raise StaleFence("write rejected")

    w = _worker(cfg, queue, {"detect": zombie})
    summary = w.run(max_jobs=1)
    assert summary["lost"] == 1 and summary["acked"] == 0
    job = queue.job(jid)
    assert job["state"] == "leased" and job["owner"] == "successor"
    assert obs_metrics.counter("fleet_jobs_lost").value == 1


def test_worker_unknown_job_type_dead_letters(tmp_path, queue):
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"))
    queue.enqueue("product", {}, max_attempts=1)
    w = _worker(cfg, queue, {"detect": lambda p, lease: None})
    summary = w.run(until_drained=True)
    assert summary["dead"] == 1
    assert queue.status()["dead_errors"] == {"ValueError": 1}


def test_worker_wedge_detection(tmp_path, queue):
    """pending jobs blocked behind a dead dependency + nothing leased =
    polling can never finish; until_drained exits wedged instead of
    spinning forever."""
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"))
    d = queue.enqueue("detect", {}, max_attempts=1)
    queue.enqueue("classify", {}, depends_on=[d])

    def boom(p, lease):
        raise RuntimeError("dead upstream")

    w = _worker(cfg, queue, {"detect": boom})
    summary = w.run(until_drained=True)
    assert summary["wedged"]
    assert summary["queue"] == {"pending": 1, "leased": 0, "done": 0,
                                "dead": 1}


def test_worker_beat_paths(tmp_path, queue, clock):
    """One heartbeat attempt: True extends, False (injected lease fault
    — the partition model) skips so the lease just ages, None on loss."""
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 faults="lease:p=1")
    queue.enqueue("detect", {})
    w = _worker(cfg, queue, {})
    lease = queue.claim(w.worker_id)
    expires0 = queue.job(lease.job_id)["lease_expires"]
    assert w._beat(lease) is False            # injected: beat dropped
    assert queue.job(lease.job_id)["lease_expires"] == expires0
    w2 = _worker(Config(store_backend="sqlite",
                        store_path=str(tmp_path / "s.db")), queue, {})
    clock.advance(5.0)
    assert w2._beat(lease) is True            # healthy: lease extended
    assert queue.job(lease.job_id)["lease_expires"] == expires0 + 5.0
    assert obs_metrics.gauge("fleet_lease_age_seconds").value == 5.0
    clock.advance(31.0)
    assert w2._beat(lease) is None            # lapsed: lost


def test_worker_heartbeat_thread_stops_cleanly(tmp_path, queue):
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_heartbeat_sec=0.01)
    queue.enqueue("detect", {"n": 1})
    w = FleetWorker(cfg, queue, worker_id="t:1",
                    handlers={"detect": lambda p, lease: None}, device="cpu")
    w.run(max_jobs=1)
    assert not any(t.name.startswith("fleet-heartbeat")
                   for t in threading.enumerate())


def test_lease_fault_plan_grammar():
    from firebird_tpu_torch import faults as faultlib

    plan = faultlib.FaultPlan.parse("lease:p=1")
    inj = plan.injector("lease")
    with pytest.raises(faultlib.InjectedFault):
        inj.fire()
    with pytest.raises(ValueError, match="chip="):
        faultlib.FaultPlan.parse("lease:chip=1:2")


def test_runstatus_fleet_block():
    from firebird_tpu_torch.obs import server as obs_server

    st = obs_server.RunStatus("r", "fleet-worker",
                              fleet=lambda: {"jobs": {"pending": 3}})
    assert st.progress()["fleet"] == {"jobs": {"pending": 3}}
    assert obs_server.RunStatus("r", "x").progress()["fleet"] is None
    boom = obs_server.RunStatus(
        "r", "x", fleet=lambda: (_ for _ in ()).throw(RuntimeError("db")))
    assert "RuntimeError" in boom.progress()["fleet"]["error"]


def test_worker_fleet_block_shape(tmp_path, queue):
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"))
    queue.enqueue("detect", {"n": 1})
    w = _worker(cfg, queue, {"detect": lambda p, lease: None})
    w.run(max_jobs=1)
    block = w.fleet_block()
    assert block["jobs"]["done"] == 1
    assert block["worker"]["id"] == "t:1"
    assert block["worker"]["tallies"]["acked"] == 1
    assert block["worker"]["current_job"] is None


def test_manifest_fence_stamp_is_monotonic(tmp_path):
    from firebird_tpu_torch.driver import quarantine as qlib

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"))
    # no manifest + no acquired: nothing to create
    assert qlib.stamp_manifest_fence(cfg, 1, run_id="r") is None
    path = qlib.stamp_manifest_fence(cfg, 5, run_id="r", acquired=ACQ)
    doc = json.load(open(path))
    assert doc["fence"] == 5 and doc["acquired"] == ACQ
    qlib.stamp_manifest_fence(cfg, 3, run_id="r")      # stale: no-op
    assert json.load(open(path))["fence"] == 5
    qlib.stamp_manifest_fence(cfg, 9, run_id="r")      # newer: climbs
    assert json.load(open(path))["fence"] == 9


# ---------------------------------------------------------------------------
# The queue file across the packages
# ---------------------------------------------------------------------------

PKG = {"port": FleetQueue, "jax": jfleet.FleetQueue}


@pytest.mark.parametrize("enq, work", [("jax", "port"), ("port", "jax")])
def test_queue_file_crosses_between_the_packages(tmp_path, clock, enq,
                                                 work):
    """A plan one package enqueues is claimed, heartbeated, acked and
    failed by the other, and each reads the other's outcome; a zombie's
    stale fence is rejected whichever package presents it."""
    path = str(tmp_path / "fleet.db")
    a = PKG[enq](path, lease_sec=30.0, clock=clock)
    b = PKG[work](path, lease_sec=30.0, clock=clock)
    plan = (enqueue_tile_plan if enq == "port" else jplan.enqueue_tile_plan)(
        a, [(100.0, 200.0)], acquired=ACQ, number=4, chunk_size=2,
        msday=724204, meday=735598, max_attempts=2)
    l1 = b.claim("w1")
    assert l1.job_id == plan["detect"][0] and l1.fence == 1
    assert l1.payload == a.job(l1.job_id)["payload"]
    clock.advance(10.0)
    b.heartbeat(l1)
    assert a.job(l1.job_id)["lease_expires"] == clock() + 30.0
    b.ack(l1)
    l2 = b.claim("w2")
    assert b.fail(l2, RuntimeError("boom")) == "pending"
    clock.advance(1.0)
    stale = a.claim("w3")                     # the other package re-claims
    assert stale.job_id == l2.job_id and stale.attempts == 2
    clock.advance(31.0)                       # its lease lapses
    fresh = b.claim("w4")                     # dead: attempts spent
    assert fresh is None or fresh.job_id != stale.job_id
    assert a.job(stale.job_id)["state"] == "dead"
    with pytest.raises(Exception, match="fence|lease"):
        a.ack(stale)
    assert b.fence_rejects() == 1
    assert a.requeue(stale.job_id) == 1
    l3 = b.claim("w5")
    b.ack(l3)
    lc = a.claim("w6")                        # classify unblocked
    assert lc.job_id == plan["classify"][0]
    a.ack(lc)
    assert a.counts() == b.counts() == {"pending": 0, "leased": 0,
                                        "done": 3, "dead": 0}
    assert a.drained() and b.drained()
    a.close()
    b.close()


def _ops(q, clock):
    """One scripted sequence of queue operations (enqueue with deps,
    claim, heartbeat, ack, fail to dead, lease expiry, a zombie's
    rejected ack, requeue, workers and the supervisor's heartbeat)."""
    d1 = q.enqueue("detect", {"n": 1}, max_attempts=1)
    d2 = q.enqueue("detect", {"n": 2}, max_attempts=2)
    q.enqueue("classify", {"n": 3}, depends_on=[d1, d2])
    q.enqueue("stream", {"cx": 1, "cy": 2})
    q.worker_register("h:1", 1, kind="batch", host="h")
    l1 = q.claim("h:1")
    clock.advance(5.0)
    q.heartbeat(l1)
    q.worker_beat("h:1", acked=0)
    q.fail(l1, ValueError("poison"))
    l2 = q.claim("h:2")
    clock.advance(31.0)
    l3 = q.claim("h:3")
    try:
        q.ack(l2)
    except Exception:
        pass
    clock.advance(3.0)
    q.supervisor_heartbeat({"target": 2, "live": 1, "pid": 7})
    q.requeue(d1)
    return l3


def test_status_and_counts_equal_jax(tmp_path):
    cp, cj = Clock(), Clock()
    tq = FleetQueue(str(tmp_path / "t.db"), lease_sec=30.0, clock=cp)
    jq = jfleet.FleetQueue(str(tmp_path / "j.db"), lease_sec=30.0, clock=cj)
    lt, lj = _ops(tq, cp), _ops(jq, cj)
    assert dataclasses.asdict(lt) == dataclasses.asdict(lj)
    assert tq.counts() == jq.counts()
    st, sj = tq.status(), jq.status()
    assert st.pop("path") != sj.pop("path")
    assert st == sj
    assert dataclasses.asdict(tq.scale_snapshot()) == \
        dataclasses.asdict(jq.scale_snapshot())
    assert tq.wedged() == jq.wedged() and tq.drained() == jq.drained()
    tq.close()
    jq.close()


def test_manifest_fence_stamp_crosses_between_the_packages(tmp_path):
    from firebird_tpu.driver import quarantine as jq
    from firebird_tpu_torch.driver import quarantine as tq

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"))
    jcfg = JConfig(store_backend="sqlite", store_path=str(tmp_path / "s.db"))
    path = tq.stamp_manifest_fence(cfg, 4, run_id="r", acquired=ACQ)
    assert jq.stamp_manifest_fence(jcfg, 3, run_id="j") == path  # stale
    assert json.load(open(path))["fence"] == 4
    jq.stamp_manifest_fence(jcfg, 7, run_id="j")
    tq.stamp_manifest_fence(cfg, 6, run_id="r")                  # stale
    doc = json.load(open(path))
    assert doc["fence"] == 7 and doc["acquired"] == ACQ


# ---------------------------------------------------------------------------
# The zombie: a lease:p=1 worker is fenced off its output
# ---------------------------------------------------------------------------

def test_zombie_worker_writes_are_rejected_and_counted(tmp_path, queue,
                                                       clock):
    """``lease:p=1`` drops every heartbeat, so the lease ages out; a
    successor re-claims the job, and the zombie's next store write is
    rejected through the port's writer path (StaleFence, never retried),
    counted, and lands no row; the zombie abandons the job."""
    from firebird_tpu_torch import retry as retrylib
    from firebird_tpu_torch.store import AsyncWriter

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 fleet_heartbeat_sec=0.01, faults="lease:p=1")
    jid = queue.enqueue("detect", {})
    inner = MemoryStore("zombie")
    seen = {}

    def handler(payload, lease):
        writer = AsyncWriter(FencedStore(inner, queue, lease),
                             retry=retrylib.RetryPolicy.for_store(cfg))
        writer.write("chip", {"cx": [1], "cy": [2], "dates": [[]]})
        writer.flush()                        # live lease: lands
        deadline = time.monotonic() + 10.0
        while obs_metrics.counter("faults_injected_lease").value < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)                  # beats dropped, not extended
        clock.advance(31.0)
        seen["succ"] = queue.claim("successor")
        writer.write("chip", {"cx": [3], "cy": [4], "dates": [[]]})
        try:
            writer.flush()
        finally:
            writer.close()

    w = FleetWorker(cfg, queue, worker_id="zombie", handlers={
        "detect": handler}, sleep=lambda s: None, device="cpu")
    summary = w.run(max_jobs=1)
    assert summary["lost"] == 1 and summary["acked"] == 0
    assert queue.fence_rejects("write") == 1
    assert inner.chip_ids("chip") == {(1, 2)}       # no foreign row
    assert obs_metrics.counter("fleet_jobs_lost").value == 1
    assert obs_metrics.counter("store_write_retries").value == 0
    queue.ack(seen["succ"])
    assert queue.job(jid)["state"] == "done"


@pytest.mark.parametrize("job", ["fanout", "pyramid"])
def test_unported_job_types_fail_naming_what_is_missing(tmp_path, queue,
                                                        job):
    """A ``fanout`` job drains its quadkey shard on the host (the POSTs,
    the cursors and the drained watermark equal to the JAX package's
    worker over a copy of the same alert log, as tests/test_fanout.py's
    ``test_worker_runs_fanout_job``); a ``pyramid`` job builds
    ``build_area``'s tiles through the fenced store, equal file for file
    to the JAX package's build over the same rows.  Both job types were
    the ones the port's worker refused before they were ported."""
    from firebird_tpu.serve import pyramid as jpyr
    from firebird_tpu.store import open_store as jopen_store
    from firebird_tpu_torch.serve import pyramid as tpyr

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"),
                 serve_pyramid_dir=str(tmp_path / "pyr"))
    cx, cy = (int(v) for v in grid.snap(100, 200)["chip"]["proj-pt"])
    rng = np.random.default_rng(17)
    seg = {"cx": [cx] * 5, "cy": [cy] * 5,
           "px": [cx + 30 * int(i) for i in rng.permutation(5)],
           "py": [cy - 30] * 5, "sday": ["1995-01-01"] * 5,
           "eday": ["1999-01-01"] * 5, "bday": ["1997-06-01"] * 5,
           "chprob": [1.0] * 5,
           "curqa": [int(v) for v in rng.integers(1, 16, 5)],
           "rfrawp": [None] * 5}
    payload = {"bounds": [[cx + 1.0, cy - 1.0]], "products": ["curveqa"],
               "product_dates": ["1996-01-01"], "levels": 2}
    if job == "fanout":
        return _fanout_job_drains_its_shard(tmp_path, queue, rng)
    else:
        store = SqliteStore(cfg.store_path, cfg.keyspace())
        store.write("segment", seg)
        store.close()
        jid = queue.enqueue("pyramid", payload, max_attempts=1)
    w = FleetWorker(cfg, queue, worker_id="t:1", sleep=lambda s: None,
                    device="cpu")
    summary = w.run(until_drained=True)
    assert summary["acked"] == 1 and summary["dead"] == 0
    assert queue.job(jid)["state"] == "done"
    jstore = jopen_store("memory", "", "t")
    jstore.write("segment", seg)
    jpyr.TilePyramid(str(tmp_path / "jpyr"), jpyr.store_read_chip(
        jstore)).build_area(payload["products"], payload["product_dates"],
                            [tuple(b) for b in payload["bounds"]], levels=2)
    bx, by = tpyr.tile_of_chip(cx, cy)
    tiles = [(tpyr.Z_BASE, bx, by), tpyr.parent(tpyr.Z_BASE, bx, by)]
    port, jax = (tpyr.TilePyramid(str(tmp_path / d))
                 for d in ("pyr", "jpyr"))
    for t in tiles:
        assert port.peek_meta("curveqa", "1996-01-01", *t)["version"] == 1
        for mine, theirs in zip(port.tile_paths("curveqa", "1996-01-01", *t),
                                jax.tile_paths("curveqa", "1996-01-01", *t)):
            assert open(mine, "rb").read() == open(theirs, "rb").read(), t



def _fanout_job_drains_its_shard(tmp_path, queue, rng):
    """Five alerts in one shard rolled into one ``fanout`` job, drained by
    the port's worker and, over a copy of the log, by the JAX package's."""
    import shutil

    from firebird_tpu.alerts import fanout as jfanout
    from firebird_tpu.alerts.log import AlertLog as JAlertLog
    from firebird_tpu.fleet.queue import FleetQueue as JQueue
    from firebird_tpu.fleet.worker import FleetWorker as JWorker
    from firebird_tpu_torch.alerts import fanout as tfanout
    from firebird_tpu_torch.alerts.log import AlertLog

    cx, cy = (int(v) for v in grid.snap(100, 200)["chip"]["proj-pt"])
    src = str(tmp_path / "src.db")
    al = AlertLog(src)
    sid = al.subscribe("http://sink/hook")
    al.append([{"cx": cx, "cy": cy,
                "px": cx + 30 * int(rng.integers(0, 100)),
                "py": cy - 30 * int(rng.integers(0, 100)),
                "break_day": float(1000 + i)} for i in range(5)])
    al.close()
    got = {}
    for name, Log, fan, Q, W in (
            ("jax", JAlertLog, jfanout, JQueue, JWorker),
            ("torch", AlertLog, tfanout, None, FleetWorker)):
        db = str(tmp_path / f"{name}.alerts.db")
        shutil.copy(src, db)
        C = JConfig if name == "jax" else Config
        cfg = C(store_backend="memory", fetch_retries=1, alert_db=db)
        q = queue if Q is None else Q(str(tmp_path / "jfleet.db"),
                                     lease_sec=300.0)
        alog = Log(db)
        posts = []
        orig = fan._default_post
        fan._default_post = (lambda url, body, timeout:
                             posts.append(json.loads(body)) or 200)
        try:
            assert len(fan.rollup(alog, q, cfg)) == 1
            kw = dict(device="cpu") if Q is None else {}
            summary = W(cfg, q, worker_id="t:1", sleep=lambda s: None,
                        **kw).run(until_drained=True)
            shard = posts[0]["shard"]
            got[name] = (summary["acked"], summary["dead"],
                         summary["queue"]["done"],
                         [[{k: v for k, v in a.items() if k != "detected_at"}
                           for a in doc["alerts"]] for doc in posts],
                         alog.fanout_cursor(sid, shard),
                         alog.shard_drained(shard), alog.rollup_cursor())
        finally:
            fan._default_post = orig
            alog.close()
            if Q is not None:
                q.close()
    assert got["torch"] == got["jax"]
    acked, dead, done, posts, cursor, drained, rolled = got["torch"]
    assert (acked, dead, done, cursor, drained, rolled) == (1, 0, 1, 0, 5, 5)
    assert sum(len(doc) for doc in posts) == 5
    assert not torch.cuda.is_initialized()

def test_worker_without_a_card_raises_unless_told(monkeypatch, tmp_path,
                                                  queue):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "s.db"))
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetWorker(cfg, queue)
    assert FleetWorker(cfg, queue, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------------
# Detect jobs on the CPU: the direct run's rows and the JAX worker's rows
# ---------------------------------------------------------------------------

DETECT_ACQ = "1995-01-01/1998-01-01"


def _detect_cfgs(tmp_path, sub, dtype):
    kw = dict(store_backend="sqlite",
              store_path=str(tmp_path / sub / "fb.db"),
              source_backend="synthetic", synth_sensor="landsat-ard-tiny",
              chips_per_batch=2, dtype=dtype, device_sharding="off",
              fetch_retries=0, fleet_db=str(tmp_path / sub / "fleet.db"))
    os.makedirs(tmp_path / sub, exist_ok=True)
    return Config(**kw), JConfig(**dict(kw, compact=False))


def _drain(pkg, cfg):
    mod = {"port": (FleetQueue, FleetWorker, enqueue_tile_plan),
           "jax": (jfleet.FleetQueue, jfleet.FleetWorker,
                   jplan.enqueue_tile_plan)}[pkg]
    q = mod[0](cfg.fleet_db, lease_sec=300.0)
    plan = mod[2](q, [(100.0, 200.0)], acquired=DETECT_ACQ, number=2,
                  chunk_size=1)
    kw = {"device": "cpu"} if pkg == "port" else {}
    summary = mod[1](cfg, q, worker_id=f"{pkg}:1", sleep=lambda s: None,
                     **kw).run(until_drained=True)
    q.close()
    assert len(plan["detect"]) == 2
    assert summary["acked"] == 2
    assert summary["queue"]["pending"] == summary["queue"]["dead"] == 0
    return summary


def _store(cfg):
    return SqliteStore(cfg.store_path, cfg.keyspace())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fleet_detect_jobs_store_the_direct_and_jax_rows(tmp_path, dtype):
    from test_torch_driver import _compare_segments, _table

    fleet, _ = _detect_cfgs(tmp_path, "fleet", dtype)
    direct, _ = _detect_cfgs(tmp_path, "direct", dtype)
    _, jcfg = _detect_cfgs(tmp_path, "jax", dtype)
    _drain("port", fleet)
    done = core.changedetection(x=100, y=200, acquired=DETECT_ACQ, number=2,
                                chunk_size=1, cfg=direct, device="cpu")
    assert len(done) == 2
    _drain("jax", jcfg)
    got, want, jax = _store(fleet), _store(direct), _store(jcfg)
    for table in ("chip", "pixel", "segment"):
        assert _table(got, table) == _table(want, table), table
    for table in ("chip", "pixel"):
        assert _table(got, table) == _table(jax, table), table
    if dtype == "float64":
        def close(a, b, what):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9,
                                       err_msg=what)

        _compare_segments(jax, got, 1e-9, close)
    else:
        env = {"rmse": (1e-4, 1e-3), "mag": (5e-3, 1e-2),
               "int": (5e-3, 1e-1)}

        def close(a, b, what):
            rtol, atol = env[what]
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=what)

        _compare_segments(jax, got, 1e-4, close)
    # the manifest carries the last owning lease's fencing token
    from firebird_tpu_torch.driver import quarantine as qlib

    doc = json.load(open(qlib.manifest_path(fleet)))
    assert doc["fence"] >= 1 and doc["acquired"] == DETECT_ACQ
    for s in (got, want, jax):
        s.close()


def test_redelivered_plan_skips_stored_chips(tmp_path, monkeypatch):
    """The re-delivery fast path: draining the same plan again skips the
    stored chips (no chip is fetched) and leaves the rows unchanged."""
    from test_torch_driver import _table

    cfg, _ = _detect_cfgs(tmp_path, "fleet", "float64")
    _drain("port", cfg)
    store = _store(cfg)
    before = {t: _table(store, t) for t in ("chip", "pixel", "segment")}
    fetched = []
    real = core.make_source

    def counting(c, kind=None):
        src = real(c, kind)
        inner = src.chip
        src.chip = lambda *a, **k: fetched.append(a) or inner(*a, **k)
        return src

    monkeypatch.setattr(core, "make_source", counting)
    summary = _drain("port", cfg)
    assert summary["acked"] == 2 and fetched == []
    assert {t: _table(store, t) for t in before} == before
    store.close()


# ---------------------------------------------------------------------------
# Classify and product jobs on the CPU
# ---------------------------------------------------------------------------

def test_classify_and_product_jobs_equal_the_direct_run(tmp_path,
                                                         monkeypatch):
    """A classify job and the product job that depends on it, drained by
    the port's worker over a store of seeded segment rows, leave the
    model, the rfrawp votes and the product rasters of the direct
    ``classification`` + ``products.save`` run on the same rows."""
    from test_torch_driver import _table
    from test_torch_rf_pipeline import (MEDAY, MSDAY, POINT, TRAIN_KW,
                                        narrow_forest, segment_frames,
                                        tile_chips)

    from firebird_tpu_torch import products
    from firebird_tpu_torch.ingest import SyntheticSource
    from firebird_tpu_torch.rf import pipeline

    narrow_forest(monkeypatch, **TRAIN_KW)
    frames = segment_frames(7, tile_chips(2), pixels=60)
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"),
                 source_backend="synthetic")
    store, direct = _store(cfg), MemoryStore("direct")
    for f in frames:
        store.write("segment", f)
        direct.write("segment", f)
    xs = [c[0] for c in tile_chips(2)]
    ys = [c[1] for c in tile_chips(2)]
    bounds = [[min(xs), max(ys)], [max(xs), min(ys)]]
    names, dates = ["seglength", "cover"], ["2000-06-01"]
    queue = FleetQueue(str(tmp_path / "fleet.db"))
    c = queue.enqueue("classify", {"x": POINT[0], "y": POINT[1],
                                   "acquired": ACQ, "msday": MSDAY,
                                   "meday": MEDAY})
    queue.enqueue("product", {"bounds": bounds, "products": names,
                              "product_dates": dates, "acquired": None},
                  depends_on=[c])
    summary = FleetWorker(cfg, queue, worker_id="t:1", sleep=lambda s: None,
                          device="cpu").run(until_drained=True)
    assert summary["acked"] == 2 and summary["queue"]["done"] == 2
    pipeline.classify_tile(*POINT, msday=MSDAY, meday=MEDAY, acquired=ACQ,
                           aux_source=SyntheticSource(seed=0), store=direct,
                           device="cpu")
    products.save([tuple(b) for b in bounds], names, dates, cfg=cfg,
                  store=direct, device="cpu")
    for table in ("segment", "product"):
        assert _table(store, table) == _table(direct, table), table
    tile = {k: {c: v for c, v in row.items() if c != "updated"}
            for k, row in _table(store, "tile").items()}
    want = {k: {c: v for c, v in row.items() if c != "updated"}
            for k, row in _table(direct, "tile").items()}
    assert tile == want and len(tile) == 1
    seg = store.read("segment")
    assert any(r is not None for r in seg["rfrawp"])
    queue.close()
    store.close()


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

def test_fleet_commands_on_the_queue(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("FIREBIRD_STORE_PATH", str(tmp_path / "fb.db"))
    tmain.main(["fleet", "enqueue", "-t", "100,200", "-n", "4", "-c", "2",
                "-a", ACQ, "-s", "724204", "-e", "735598", "-p",
                "seglength", "-d", "1996-01-01", "--max-attempts", "1"])
    out = json.loads(capsys.readouterr().out)
    assert out["queue"] == str(tmp_path / "fleet.db")
    assert (len(out["detect"]), len(out["classify"]),
            len(out["product"]), out["jobs"]) == (2, 1, 1, 4)
    q = FleetQueue(out["queue"])
    lease = q.claim("w")
    q.fail(lease, RuntimeError("x"))
    tmain.main(["fleet", "status"])
    st = json.loads(capsys.readouterr().out)
    assert st["jobs"] == {"pending": 3, "leased": 0, "done": 0, "dead": 1}
    tmain.main(["fleet", "requeue", "--dead"])
    assert capsys.readouterr().out.strip() == "1 job(s) requeued"
    assert q.counts()["dead"] == 0
    q.close()
    monkeypatch.setenv("FIREBIRD_FLEET_DB", str(tmp_path / "no" / "x" /
                                                 "fleet.db"))
    os.makedirs(tmp_path / "no")
    (tmp_path / "no" / "x").write_text("")    # a file where a dir must be
    with pytest.raises(SystemExit) as e:
        tmain.main(["fleet", "status"])
    assert e.value.code == 3
    assert "error" in json.loads(capsys.readouterr().out)


# ---------------------------------------------------------------------------
# Repair and stream jobs on the CPU
# ---------------------------------------------------------------------------

def test_repair_job_stores_rows_and_a_checkpoint_fenced(tmp_path):
    """A repair job runs ``repair_chip`` on the worker's device: the
    chip's rows through the fenced store and a fresh checkpoint, and a
    zombie's checkpoint save is refused by the fence guard."""
    from firebird_tpu_torch.streamops import statestore as sstore_mod

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"),
                 source_backend="synthetic", synth_sensor="landsat-ard-tiny")
    cid = tuple(int(v) for v in grid.chips(grid.tile(x=100, y=200))[0])
    q = FleetQueue(str(tmp_path / "fleet.db"), lease_sec=300.0)
    q.enqueue("repair", {"cx": cid[0], "cy": cid[1],
                         "acquired": DETECT_ACQ, "pixels": 3})
    w = FleetWorker(cfg, q, worker_id="t:1", sleep=lambda s: None,
                    device="cpu")
    assert w.run(until_drained=True)["acked"] == 1
    store = _store(cfg)
    assert store.chip_ids("segment") == {cid}
    sstore = sstore_mod.open_statestore(cfg)
    assert sstore.exists(cid)
    sstore.close()
    store.close()
    # the fence guard: a lease that lapsed before the save is refused
    clock = Clock()
    q2 = FleetQueue(str(tmp_path / "fleet2.db"), lease_sec=30.0,
                    clock=clock)
    jid = q2.enqueue("repair", {"cx": cid[0], "cy": cid[1],
                                "acquired": DETECT_ACQ})
    from firebird_tpu_torch.alerts import repair as repairlib

    real = repairlib.repair_chip

    def lapsed(cfg, c, acquired, *, fence_guard, **kw):
        clock.advance(31.0)
        return real(cfg, c, acquired, fence_guard=fence_guard, **kw)

    import unittest.mock as mock

    with mock.patch.object(repairlib, "repair_chip", lapsed):
        s = FleetWorker(cfg, q2, worker_id="zombie", sleep=lambda s: None,
                        device="cpu").run(max_jobs=1)
    assert s["lost"] == 1 and q2.fence_rejects("write") >= 1
    assert q2.job(jid)["state"] == "leased"
    q.close()
    q2.close()


def test_stream_job_runs_the_stream_driver(tmp_path):
    """A stream job runs the stream driver on the worker's device against
    the fenced store, with no ops port of its own, and the worker's ops
    state is back after it."""
    from firebird_tpu_torch.obs import server as obs_server
    from firebird_tpu_torch.streamops import statestore as sstore_mod

    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"),
                 source_backend="synthetic", ops_port=0, flightrec=0)
    q = FleetQueue(str(tmp_path / "fleet.db"), lease_sec=300.0)
    q.enqueue("stream", {"x": 100, "y": 200, "number": 1,
                         "acquired": "2000-01-01/2001-06-01"})
    w = FleetWorker(cfg, q, worker_id="t:1", sleep=lambda s: None,
                    device="cpu")
    status, srv, wd = w.start_ops()
    try:
        summary = w.run(until_drained=True)
        assert obs_server.current() is status       # restored
    finally:
        core.stop_ops(srv, wd)
    assert summary["acked"] == 1
    cid = tuple(int(v) for v in grid.chips(grid.tile(x=100, y=200))[0])
    sstore = sstore_mod.open_statestore(cfg)
    assert sstore.exists(cid)
    sstore.close()
    store = _store(cfg)
    assert store.chip_ids("segment") == {cid}
    store.close()
    q.close()

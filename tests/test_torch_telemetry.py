"""The port's fleet telemetry plane against the JAX package's: the spool
ring, wire-format trace propagation, the collector's merged trace and
critical-path attribution, and the snapshot-rebuilt Prometheus
exposition (firebird_tpu_torch/obs/spool.py, obs/collect.py).

The JAX package's tests/test_telemetry.py cases on the port's modules,
plus the formats carried across: a spool segment the port writes is the
JAX package's byte for byte, and the port's ``collect`` equals the JAX
package's over the same spool directory, whichever package wrote it.
"""

import json
import os

import pytest
import torch

from firebird_tpu.obs import collect as jcollect
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu.obs import spool as jspool
from firebird_tpu.obs import tracing as jtracing
from firebird_tpu_torch.alerts.log import AlertLog
from firebird_tpu_torch.fleet.queue import FleetQueue
from firebird_tpu_torch.obs import collect as obs_collect
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import report as obs_report
from firebird_tpu_torch.obs import spool as obs_spool
from firebird_tpu_torch.obs import tracing


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_metrics():
    obs_metrics.reset_registry()
    yield
    obs_metrics.reset_registry()


@pytest.fixture
def sink_guard():
    """Every test that installs the spool span sink must leave the
    process clean — a leaked sink would spool every later test's spans."""
    yield
    tracing.set_spool(None)
    obs_spool.disarm()


# ---------------------------------------------------------------------------
# Wire format: the trace id as it crosses processes
# ---------------------------------------------------------------------------

def test_wire_roundtrip():
    ctx = tracing.TraceContext("scene/LC08_2020-01-01/ab12cd34",
                               run_id="r1")
    wire = tracing.to_wire(ctx)
    assert wire == "scene/LC08_2020-01-01/ab12cd34"
    back = tracing.from_wire(wire, run_id="r2")
    assert back is not None and back.batch_id == wire
    assert back.run_id == "r2"
    assert tracing.to_wire(None) is None


def test_from_wire_rejects_malformed():
    # Queue payloads and HTTP headers are untrusted: anything outside
    # WIRE_RE must be refused (the caller then mints its own context).
    for bad in (None, "", "has space", "semi;colon", "x" * 161,
                42, {"trace": "scene/x"}, b"scene/x", "new\nline"):
        assert tracing.from_wire(bad) is None, bad
    for ok in ("scene/LC08/1a", "req-0f3c", "run.id:7/b3", "a",
               "x" * 160):
        assert tracing.from_wire(ok) is not None, ok


# ---------------------------------------------------------------------------
# The spool: bounded ring, crash recovery, zero-cost disarm
# ---------------------------------------------------------------------------

def test_spool_ring_is_bounded(tmp_path):
    sp = obs_spool.TelemetrySpool(str(tmp_path), "worker",
                                  events_per_segment=5, segments=2,
                                  snapshot_sec=1e9)
    for i in range(23):
        sp.mark("tick", trace=f"t/{i}", i=i)
    sp.close()   # writes the final snapshot line
    segs = sorted(p.name for p in tmp_path.iterdir())
    assert segs == [f"spool.worker.{os.getpid()}.{s}.jsonl"
                    for s in (0, 1)]
    events = obs_collect.read_events(str(tmp_path))
    marks = [e for e in events if e["kind"] == "mark"]
    # the ring kept only the newest <= 2 * 5 events; the oldest rolled off
    assert 0 < len(marks) <= 10
    assert max(e["attrs"]["i"] for e in marks) == 22
    # every surviving event is attributed from its segment header
    assert all(e["role"] == "worker" and e["pid"] == os.getpid()
               for e in events)


def test_collector_skips_torn_tail_line(tmp_path):
    sp = obs_spool.TelemetrySpool(str(tmp_path), "worker",
                                  events_per_segment=100, segments=2,
                                  snapshot_sec=1e9)
    sp.mark("whole", trace="t/1")
    sp.close()
    path = sp.segment_path(0)
    with open(path, "a") as f:
        f.write('{"kind":"mark","name":"torn","t":12')   # SIGKILL mid-write
    events = obs_collect.read_events(str(tmp_path))
    names = [e["name"] for e in events if e["kind"] == "mark"]
    assert names == ["whole"]           # torn line skipped, not fatal


def test_spool_captures_spans_with_trace(tmp_path, sink_guard):
    sp = obs_spool.TelemetrySpool(str(tmp_path), "worker",
                                  snapshot_sec=1e9)
    tracing.set_spool(sp)
    with tracing.activate(tracing.TraceContext("scene/S1/aa")):
        with tracing.span("fetch", chip=(1, 2)):
            pass
    with tracing.span("fetch"):         # outside any context: no trace
        pass
    tracing.set_spool(None)
    sp.close()
    spans = [e for e in obs_collect.read_events(str(tmp_path))
             if e["kind"] == "span"]
    assert [s["trace"] for s in spans] == ["scene/S1/aa", None]
    assert all(s["name"] == "fetch" and s["dur"] >= 0 for s in spans)


def test_arm_disarmed_by_knob_and_memory_backend(tmp_path, sink_guard):
    from firebird_tpu_torch.config import Config

    base = {"FIREBIRD_STORE_BACKEND": "sqlite",
            "FIREBIRD_STORE_PATH": str(tmp_path / "store" / "f.db")}
    cfg = Config.from_env(env=dict(base, FIREBIRD_TELEMETRY="0"))
    assert obs_spool.arm(cfg, "worker") is None
    assert obs_spool.active() is None
    obs_spool.mark("noop", trace="t/1")          # must not throw
    assert tracing.span("fetch") is tracing._NULL_SPAN   # no-op gate holds
    assert not (tmp_path / "store" / "telemetry").exists()
    # the memory backend has no cross-process "next to": spool disabled
    mcfg = Config.from_env(env={"FIREBIRD_STORE_BACKEND": "memory"})
    assert obs_spool.spool_dir(mcfg) is None
    assert obs_spool.arm(mcfg, "worker") is None


def test_arm_derives_dir_next_to_store(tmp_path, sink_guard):
    from firebird_tpu_torch.config import Config

    cfg = Config.from_env(env={
        "FIREBIRD_STORE_BACKEND": "sqlite",
        "FIREBIRD_STORE_PATH": str(tmp_path / "store" / "f.db"),
        "FIREBIRD_TELEMETRY_SNAPSHOT_SEC": "1e9"})
    sp = obs_spool.arm(cfg, "watcher", "run-1")
    assert sp is not None
    assert obs_spool.arm(cfg, "watcher") is sp   # idempotent
    obs_spool.mark("scene_enqueued", trace="scene/S/1", jobs=2)
    obs_spool.disarm()
    d = tmp_path / "store" / "telemetry"
    events = obs_collect.read_events(str(d))
    marks = [e for e in events if e["kind"] == "mark"]
    assert marks and marks[0]["run_id"] == "run-1"


# ---------------------------------------------------------------------------
# Collector: merged Perfetto trace + critical-path attribution
# ---------------------------------------------------------------------------

def _write_segment(directory, role, pid, lines):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"spool.{role}.{pid}.0.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "header", "role": role, "pid": pid,
                            "run_id": f"run-{role}", "segment": 0,
                            "t": 0.0}) + "\n")
        for doc in lines:
            f.write(json.dumps(doc) + "\n")


def _fleet_spool(directory):
    """A hand-built three-process spool for one scene trace: the joints
    and spans of publish(t=1000) -> append(t=1002) -> deliver(t=1002.5)."""
    tr = "scene/LC08_X/aa11"
    _write_segment(directory, "watcher", 11, [
        {"kind": "mark", "name": "scene_enqueued", "t": 1000.5,
         "trace": tr, "tid": 1,
         "attrs": {"scene": "LC08_X", "jobs": 1, "published": 1000.0}}])
    _write_segment(directory, "worker", 12, [
        {"kind": "mark", "name": "job_claimed", "t": 1001.0, "trace": tr,
         "tid": 2, "attrs": {"job": 7}},
        {"kind": "span", "name": "fetch", "t0": 1001.1, "dur": 0.2,
         "trace": tr, "tid": 2, "thread": "MainThread"},
        {"kind": "span", "name": "step", "t0": 1001.4, "dur": 0.3,
         "trace": tr, "tid": 2, "thread": "MainThread"},
        {"kind": "span", "name": "alert", "t0": 1001.8, "dur": 0.1,
         "trace": tr, "tid": 2, "thread": "MainThread"},
        {"kind": "mark", "name": "alert_appended", "t": 1002.0,
         "trace": tr, "tid": 2,
         "attrs": {"chip": [1, 2], "alerts": 5, "deduped": 0,
                   "published": 1000.0, "acq_to_alert": 2.0}},
        {"kind": "mark", "name": "job_acked", "t": 1002.1, "trace": tr,
         "tid": 2, "attrs": {"job": 7}}])
    _write_segment(directory, "deliverer", 13, [
        {"kind": "span", "name": "deliver", "t0": 1002.3, "dur": 0.2,
         "trace": tr, "tid": 3, "thread": "MainThread"},
        {"kind": "mark", "name": "alert_delivered", "t": 1002.5,
         "trace": tr, "tid": 3, "attrs": {"subscriber": 1, "cursor": 5}}])
    return tr


def test_collector_merges_processes_into_valid_trace(tmp_path):
    tr = _fleet_spool(str(tmp_path))
    doc = obs_collect.collect(str(tmp_path))
    obs_report.validate_trace(doc["trace"])      # Perfetto-loadable
    assert [(p["role"], p["pid"]) for p in doc["processes"]] == \
        [("deliverer", 13), ("watcher", 11), ("worker", 12)]
    evs = doc["trace"]["traceEvents"]
    # one process track per pid, named "<role> <pid>"
    names = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"watcher 11", "worker 12", "deliverer 13"}
    # every span/instant carries the scene's trace id in args — the one
    # filterable id across all three OS processes
    tagged = [e for e in evs if e.get("args", {}).get("trace") == tr]
    pids = {e["pid"] for e in tagged}
    assert pids == {11, 12, 13}
    # instants use the Perfetto-required scope field
    assert all(e.get("s") == "p" for e in evs if e["ph"] == "i")


def test_critical_path_stages_sum_exactly(tmp_path):
    tr = _fleet_spool(str(tmp_path))
    paths = obs_collect.critical_paths(
        obs_collect.read_events(str(tmp_path)))
    assert len(paths) == 1
    cp = paths[0]
    assert cp["trace"] == tr and cp["alerts"] == 5
    assert set(cp["stages"]) == set(obs_collect.CRITICAL_PATH_STAGES)
    s = cp["stages"]
    assert s["watch_lag"] == pytest.approx(0.5)
    assert s["queue_wait"] == pytest.approx(0.5)
    assert s["fetch"] == pytest.approx(0.2)
    assert s["step"] == pytest.approx(0.3)
    assert s["append"] == pytest.approx(0.1)
    # `other` is the explicit residual, so the stages sum EXACTLY
    assert sum(s.values()) == pytest.approx(cp["total"], abs=1e-6)
    assert cp["total"] == pytest.approx(2.0)
    # the measured histogram observation rides on the mark
    assert cp["measured_acq_to_alert"] == pytest.approx(2.0)
    assert cp["delivery"] == pytest.approx(0.5)
    assert cp["processes"] == ["deliverer:13", "watcher:11", "worker:12"]


def test_critical_path_needs_an_append(tmp_path):
    # a trace that never reached a durable append yields no breakdown
    _write_segment(str(tmp_path), "watcher", 11, [
        {"kind": "mark", "name": "scene_enqueued", "t": 1.0,
         "trace": "scene/never/1", "tid": 1,
         "attrs": {"published": 0.5}}])
    assert obs_collect.critical_paths(
        obs_collect.read_events(str(tmp_path))) == []


# ---------------------------------------------------------------------------
# Metric snapshots: exposition rebuild + fleet percentile re-derivation
# ---------------------------------------------------------------------------

def test_prometheus_rebuilt_from_spool_snapshot(tmp_path, fresh_metrics,
                                                sink_guard):
    obs_metrics.counter("fetch_retries").inc(3)
    obs_metrics.gauge("store_queue_depth").set(2)
    h = obs_metrics.histogram("pipeline_fetch_seconds")
    for v in (0.01, 0.2, 1.5):
        h.observe(v)
    sp = obs_spool.TelemetrySpool(str(tmp_path), "worker",
                                  snapshot_sec=1e9)
    sp.close()                                    # close() snapshots
    snaps = obs_collect.latest_snapshots(
        obs_collect.read_events(str(tmp_path)))
    (snap,) = snaps.values()
    text = obs_metrics.prometheus_from_snapshot(snap["metrics"])
    for line in text.splitlines():
        assert obs_metrics.PROM_LINE_RE.match(line), line
    # catalog help + shared naming rules: the rebuilt exposition IS the
    # scrape the live process would have served
    assert text == obs_metrics.get_registry().prometheus()
    assert 'firebird_pipeline_fetch_seconds_bucket{le="+Inf"} 3' in text


def test_fleet_merge_rederives_percentiles(fresh_metrics):
    # two "processes": disjoint observation sets, same fixed buckets
    a_obs = [0.01, 0.02, 0.05, 0.1]
    b_obs = [0.5, 1.0, 2.0, 5.0, 9.0]
    h = obs_metrics.histogram("pipeline_drain_seconds")
    for v in a_obs:
        h.observe(v)
    obs_metrics.gauge("stream_chips").set(3)
    obs_metrics.gauge("store_queue_depth").set(1)
    snap_a = obs_metrics.get_registry().snapshot()
    obs_metrics.reset_registry()
    h = obs_metrics.histogram("pipeline_drain_seconds")
    for v in b_obs:
        h.observe(v)
    obs_metrics.gauge("stream_chips").set(4)
    obs_metrics.gauge("store_queue_depth").set(5)
    snap_b = obs_metrics.get_registry().snapshot()
    merged = obs_collect.merge_snapshots({
        "worker:1": {"t": 1.0, "metrics": snap_a},
        "worker:2": {"t": 2.0, "metrics": snap_b}})
    mh = merged["histograms"]["pipeline_drain_seconds"]
    assert mh["count"] == len(a_obs) + len(b_obs)
    assert mh["sum"] == pytest.approx(sum(a_obs) + sum(b_obs))
    # percentiles re-derive from the ADDED bucket counts: identical to a
    # single registry that observed every value itself
    obs_metrics.reset_registry()
    h = obs_metrics.histogram("pipeline_drain_seconds")
    for v in a_obs + b_obs:
        h.observe(v)
    ref = obs_metrics.histogram("pipeline_drain_seconds").snapshot()
    for q in ("p50", "p95", "p99"):
        assert mh[q] == pytest.approx(ref[q]), q
    assert mh["bucket_counts"] == ref["bucket_counts"]
    # gauges merge per the declared policy: stream_* sums, depths max
    assert merged["gauges"]["stream_chips"] == 7
    assert merged["gauges"]["store_queue_depth"] == 5


# ---------------------------------------------------------------------------
# Propagation surfaces: queue payloads and alert rows
# ---------------------------------------------------------------------------

def test_queue_payload_trace_survives_redelivery(tmp_path):
    clock = [1000.0]
    q = FleetQueue(str(tmp_path / "fleet.db"), lease_sec=30.0,
                   clock=lambda: clock[0])
    tr = "scene/LC08_X/aa11"
    q.enqueue("stream", {"cx": 1, "cy": 2, tracing.TRACE_KEY: tr})
    lease = q.claim("w1")
    assert lease.payload[tracing.TRACE_KEY] == tr
    clock[0] += 31.0                 # the SIGKILLed worker's lease lapses
    lease2 = q.claim("w2")           # re-delivery, fresh fence
    assert lease2.job_id == lease.job_id and lease2.fence != lease.fence
    assert lease2.payload[tracing.TRACE_KEY] == tr   # verbatim round-trip
    q.ack(lease2)
    q.close()


def test_alert_rows_carry_trace_and_migrate(tmp_path):
    import sqlite3

    path = str(tmp_path / "alerts.db")
    log = AlertLog(path)
    tr = "scene/LC08_X/aa11"
    rec = {"cx": 1, "cy": 2, "px": 10, "py": 20, "break_day": 730000.0}
    log.append([rec], run_id="r1", trace=tr)
    # a record carrying its OWN trace wins over the batch default
    log.append([dict(rec, px=11, trace="scene/other/bb22")], trace=tr)
    rows = log.since(0)
    assert [r["trace"] for r in rows] == [tr, "scene/other/bb22"]
    log.close()
    # pre-telemetry schema (no trace column) migrates on open
    old = str(tmp_path / "old.db")
    con = sqlite3.connect(old)
    con.execute("CREATE TABLE alerts ("
                " id INTEGER PRIMARY KEY AUTOINCREMENT,"
                " cx INTEGER NOT NULL, cy INTEGER NOT NULL,"
                " px INTEGER NOT NULL, py INTEGER NOT NULL,"
                " break_day REAL NOT NULL,"
                " score REAL, magnitude REAL,"
                " run_id TEXT, detected_at TEXT,"
                " UNIQUE (px, py, break_day))")
    con.execute("INSERT INTO alerts (cx, cy, px, py, break_day) "
                "VALUES (1, 2, 3, 4, 729000.0)")
    con.commit()
    con.close()
    mig = AlertLog(old)
    rows = mig.since(0)
    assert [r["trace"] for r in rows] == [None]      # legacy row readable
    mig.append([dict(rec, px=12)], trace=tr)
    assert mig.since(0)[-1]["trace"] == tr           # new rows stamped
    mig.close()


# ---------------------------------------------------------------------------
# Formats carried across: the segment bytes and the collected artifact
# ---------------------------------------------------------------------------

PKGS = {"port": (obs_spool, obs_metrics), "jax": (jspool, jmetrics)}


@pytest.fixture
def both_registries():
    obs_metrics.reset_registry()
    jmetrics.reset_registry()
    yield
    obs_metrics.reset_registry()
    jmetrics.reset_registry()


def _fake_time(monkeypatch):
    """A time.time that steps 0.25 s a call from 1000.0, restarted per
    spool so both packages see the same stamps."""
    import time

    state = {"t": 1000.0}

    def now():
        state["t"] += 0.25
        return state["t"]

    monkeypatch.setattr(time, "time", now)
    # the registries' elapsed_sec: one frozen monotonic clock
    monkeypatch.setattr(time, "monotonic", lambda: 50.0)
    return state


def _drive_spool(pkg, directory, role, run_id, *, claims=3):
    """One fleet process's telemetry through ``pkg``'s spool: a small
    ring (3 events a segment, 2 segments) so the rollover is exercised,
    claim/ack marks under per-job trace ids, span events, an
    alert-append joint and the closing metric snapshot."""
    spool_mod, metrics_mod = PKGS[pkg]
    metrics_mod.reset_registry()
    metrics_mod.counter("fleet_jobs_claimed").inc(claims)
    metrics_mod.gauge("fleet_lease_age_seconds").set(1.5)
    h = metrics_mod.histogram("fleet_job_seconds_detect")
    for v in (0.01, 0.4, 2.5):
        h.observe(v)
    sp = spool_mod.TelemetrySpool(directory, role, run_id,
                                  events_per_segment=3, segments=2,
                                  snapshot_sec=1e9)
    for j in range(claims):
        tr = f"{run_id}/b{j}"
        sp.mark("job_claimed", trace=tr, job=j + 1, type="detect",
                fence=j + 1, attempt=1)
        sp.span_event("dispatch", 0.125, tr)
        sp.span_event("drain", 0.0625, tr)
        sp.mark("job_acked", trace=tr, job=j + 1, type="detect")
    sp.mark("alert_appended", trace=f"{run_id}/b0", chip=[1, 2], alerts=2,
            deduped=0, published=999.0, acq_to_alert=1.0)
    sp.close()
    return sp


def test_spool_segments_are_the_jax_format_byte_for_byte(
        tmp_path, monkeypatch, both_registries):
    state = _fake_time(monkeypatch)
    for pkg in PKGS:
        state["t"] = 1000.0
        _drive_spool(pkg, str(tmp_path / pkg), "worker", "run-w")
    port = sorted(os.listdir(tmp_path / "port"))
    assert port == sorted(os.listdir(tmp_path / "jax"))
    assert port == [f"spool.worker.{os.getpid()}.{s}.jsonl" for s in (0, 1)]
    for name in port:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def _collected(mod, directory):
    doc = mod.collect(directory)
    doc["trace"]["otherData"].pop("producer")
    return doc


@pytest.mark.parametrize("writer", ["port", "jax", "hand"])
def test_collect_equals_jax_collect(tmp_path, monkeypatch, both_registries,
                                    writer):
    """Either package's collector over either package's spool (and over
    the hand-built three-process spool) gives the same artifact: the
    same processes, the same Chrome trace, the same critical paths and
    the same merged metrics."""
    d = str(tmp_path / "spool")
    if writer == "hand":
        _fleet_spool(d)
    else:
        _fake_time(monkeypatch)
        _drive_spool(writer, d, "worker", "run-w")
        _drive_spool(writer, d, "supervisor", "run-s", claims=1)
    got, want = _collected(obs_collect, d), _collected(jcollect, d)
    assert got == want
    assert got["processes"]
    obs_report.validate_trace(got["trace"])
    # the port's artifact file reads back as the same document
    path = obs_collect.write(obs_collect.collect(d), str(tmp_path / "c.json"))
    assert json.load(open(path))["processes"] == got["processes"]


def test_port_spool_span_sink_carries_the_jax_trace_ids(tmp_path,
                                                         sink_guard):
    """A trace id minted by the JAX package's tracing (a JAX enqueuer's
    payload) crosses into the port's spans unchanged."""
    jctx = jtracing.TraceContext("scene/LC08_X/ab12", run_id="jax")
    wire = jtracing.to_wire(jctx)
    sp = obs_spool.TelemetrySpool(
        str(tmp_path), "worker", snapshot_sec=1e9)
    tracing.set_spool(sp)
    with tracing.activate(tracing.from_wire(wire, run_id="port")):
        with tracing.span("dispatch"):
            pass
    tracing.set_spool(None)
    sp.close()
    (span,) = [e for e in jcollect.read_events(str(tmp_path))
               if e["kind"] == "span"]
    assert span["trace"] == wire and span["name"] == "dispatch"

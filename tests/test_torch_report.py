"""The port's run report against the JAX package's, on the CPU: a
``changedetection`` run's trace and report pass the JAX package's driver
contract, the two packages merge one set of shards alike, the JAX
package's tooling reads the port's fleet report, and the multi-process
artifact rules (obs/report.py) hold."""

import json
import os

import pytest
import torch

from firebird_tpu.ccd.sensor import SENSORS as JSENSORS
from firebird_tpu.ingest import SyntheticSource as JSyntheticSource
from firebird_tpu.obs import report as jreport
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import core
from firebird_tpu_torch.ingest import SyntheticSource
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import report as obs_report
from firebird_tpu_torch.obs import tracing


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def driver_run(tmp_path_factory):
    """tests/test_obs.py's driver run, through the port on the CPU: two
    chips of the synthetic source (seed 9) into sqlite with the tracer
    on; the report takes its default place next to the store.  The chips
    are the tiny sensor's (10x10 pixels): a 100x100 chip takes tens of
    seconds on one CPU thread."""
    tmp = tmp_path_factory.mktemp("report")
    cfg = Config(store_backend="sqlite", store_path=str(tmp / "fb.db"),
                 source_backend="synthetic", chips_per_batch=1,
                 device_sharding="off", fetch_retries=0,
                 trace=str(tmp / "trace.json"))
    src = SyntheticSource(seed=9, start="1995-01-01", end="1998-01-01",
                          cloud_frac=0.1, sensor=LANDSAT_ARD_TINY)
    done = core.changedetection(x=100, y=200,
                                acquired="1995-01-01/1997-06-01",
                                number=2, chunk_size=2, cfg=cfg, source=src,
                                device="cpu")
    assert len(done) == 2
    return tmp


def test_driver_artifacts_pass_the_jax_contract(driver_run):
    trace = json.load(open(driver_run / "trace.json"))
    rep = json.load(open(driver_run / "obs_report.json"))
    jreport.validate_driver_artifacts(trace, rep)
    obs_report.validate_driver_artifacts(trace, rep)
    assert rep["run"]["kind"] == "changedetection"
    assert rep["run_counters"]["chips"] == 2
    assert rep["spans"]["dispatch"]["count"] >= 1
    assert trace["otherData"]["run_id"] == rep["run"]["run_id"]


def test_report_keys_are_the_jax_reports_and_a_device_block(driver_run,
                                                            tmp_path):
    rep = json.load(open(driver_run / "obs_report.json"))
    assert rep["device"] == {"platform": "cpu"}
    want = jreport.build_report(run={"kind": "x"}, run_counters={"c": 1})
    assert set(rep) - set(want) == {"device"}
    assert rep["schema"] == jreport.SCHEMA
    assert obs_report.SPAN_NAMES == jreport.SPAN_NAMES
    assert obs_report.DRIVER_SPAN_NAMES == jreport.DRIVER_SPAN_NAMES
    assert obs_report.DRIVER_STAGE_HISTOGRAMS == \
        jreport.DRIVER_STAGE_HISTOGRAMS


def test_every_driver_span_is_a_catalogued_name(driver_run):
    trace = json.load(open(driver_run / "trace.json"))
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert names <= set(obs_report.SPAN_NAMES)
    assert {"store_write", "store_flush", "first_dispatch"} <= names
    # the batch id crosses the thread hops: the drain and the writer's
    # spans carry the batch of the dispatch that produced them
    batch = {e["name"]: e["args"].get("batch") for e in trace["traceEvents"]
             if e["ph"] == "X"}
    assert batch["dispatch"] and batch["drain"] and batch["store_write"]


def test_default_sqlite_run_writes_the_report_next_to_the_store(
        driver_run):
    assert Config().obs_report == ""
    assert obs_report.run_report_path(Config(store_path=str(
        driver_run / "fb.db"))) == str(driver_run / "obs_report.json")
    assert obs_report.run_report_path(Config(store_backend="memory")) is None
    assert os.path.exists(driver_run / "obs_report.json")


def _host_report(host, *, chips, fetch_obs, queue_depth, elapsed):
    """One host's report shard, as tests/test_ops.py builds them, through
    the port."""
    reg = obs_metrics.MetricsRegistry()
    reg.counter("chips_detected").inc(chips)
    reg.gauge("store_queue_depth").set(queue_depth)
    reg.gauge("stream_updated").set(chips)
    h = reg.histogram("pipeline_fetch_seconds")
    for i, v in enumerate(fetch_obs):
        with tracing.activate(tracing.TraceContext(f"{host}/b{i}")):
            h.observe(v)
    t = tracing.Tracer()
    with t.span("fetch"):
        pass
    rep = obs_report.build_report(
        registry=reg, tracer=t,
        run={"kind": "changedetection", "run_id": "fleet-1", "host": host,
             "process_id": int(host[-1]), "chips": chips},
        run_counters={"chips": chips, "elapsed_sec": elapsed,
                      "chips_per_sec": chips / elapsed})
    rep["profile"]["device_time"].update(
        source="trace", fit_ms=1.5 * chips, total_ms=2.0 * chips,
        events=chips, device_busy_ms=1.0 * chips, window_ms=100.0)
    return json.loads(json.dumps(rep))


def _shards():
    return [_host_report("h0", chips=4, fetch_obs=[0.01, 0.02],
                         queue_depth=5, elapsed=10.0),
            _host_report("h1", chips=6, fetch_obs=[0.04, 0.08],
                         queue_depth=2, elapsed=8.0)]


def test_merge_reports_equals_jax():
    shards = _shards()
    got = obs_report.merge_reports(shards)
    want = jreport.merge_reports(shards)
    assert got == want
    jreport.validate_report(got)
    assert got["metrics"]["counters"]["chips_detected"] == 10
    assert got["metrics"]["gauges"]["store_queue_depth"] == 5
    assert got["metrics"]["gauges"]["stream_updated"] == 10
    assert got["metrics"]["histograms"]["pipeline_fetch_seconds"][
        "exemplars"][0]["batch"] == "h1/b1"
    assert got["run_counters"]["chips"] == 10
    assert got["profile"]["device_time"]["device_busy_ms"] == 10.0
    assert got["fleet"]["hosts"] == 2


def test_jax_tooling_reads_the_ports_fleet_report(tmp_path):
    path = str(tmp_path / "obs_report.json")
    for i, rep in enumerate(_shards()):
        with open(obs_report.shard_report_path(path, i), "w") as f:
            json.dump(rep, f)
    merged = obs_report.merge_fleet_report(path, 2, timeout=1.0)
    assert merged["fleet"]["expected_hosts"] == 2
    loaded = jreport.load_fleet_report(str(tmp_path))
    jreport.validate_report(loaded)
    assert loaded == json.load(open(path))
    assert loaded["metrics"]["counters"]["chips_detected"] == 10


def test_clear_stale_artifacts_is_scoped_per_process(tmp_path, monkeypatch):
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"))
    path = obs_report.run_report_path(cfg)
    shard0 = obs_report.shard_report_path(path, 0)
    shard1 = obs_report.shard_report_path(path, 1)
    for p in (path, shard0, shard1):
        with open(p, "w") as f:
            f.write("{}")
    monkeypatch.setattr(obs_report, "_process_info", lambda: (2, 0))
    obs_report.clear_stale_artifacts(cfg)
    assert not os.path.exists(path) and not os.path.exists(shard0)
    assert os.path.exists(shard1)
    monkeypatch.setattr(obs_report, "_process_info", lambda: (2, 1))
    obs_report.clear_stale_artifacts(cfg)
    assert not os.path.exists(shard1)
    with open(path, "w") as f:
        f.write("{}")
    monkeypatch.setattr(obs_report, "_process_info", lambda: (1, 0))
    obs_report.clear_stale_artifacts(cfg)
    assert os.path.exists(path)


def test_merge_tolerates_a_missing_host(tmp_path):
    path = str(tmp_path / "obs_report.json")
    first, late = _shards()
    with open(obs_report.shard_report_path(path, 0), "w") as f:
        json.dump(first, f)
    merged = obs_report.merge_fleet_report(path, 2, timeout=0.3,
                                           poll_sec=0.05)
    assert merged["fleet"]["hosts"] == 1 and merged["fleet"]["missing"] == [1]
    assert obs_report.merge_fleet_report(
        str(tmp_path / "empty" / "obs_report.json"), 2, timeout=0.1,
        poll_sec=0.05) is None
    with open(obs_report.shard_report_path(path, 1), "w") as f:
        json.dump(late, f)
    for mod in (obs_report, jreport):
        again = mod.load_fleet_report(str(tmp_path))
        assert again["fleet"]["hosts"] == 2
        assert again["run_counters"]["chips"] == 10


def test_multi_process_runs_write_one_trace_and_shard_a_process(
        tmp_path, monkeypatch):
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"),
                 trace="1", obs_merge_timeout=0.2)
    t = tracing.Tracer(run_id="r")
    with t.span("fetch"):
        pass
    monkeypatch.setattr(obs_report, "_process_info", lambda: (2, 1))
    paths = obs_report.finish_run(cfg, tracer=t, run={"run_id": "r"})
    assert paths == {"trace": str(tmp_path / "trace.host1.json"),
                     "report_shard": str(tmp_path / "obs_report.host1.json")}
    monkeypatch.setattr(obs_report, "_process_info", lambda: (2, 0))
    paths = obs_report.finish_run(cfg, tracer=t, run={"run_id": "r"})
    assert paths["report"] == str(tmp_path / "obs_report.json")
    assert json.load(open(paths["report"]))["fleet"]["hosts"] == 2


def test_jax_source_and_port_source_make_one_chip():
    """The driver run above uses the port's source: it makes the chips the
    JAX package's source makes, so the contract is held on the same
    data."""
    kw = dict(seed=9, start="1995-01-01", end="1998-01-01", cloud_frac=0.1)
    a = SyntheticSource(**kw, sensor=LANDSAT_ARD_TINY).chip(100, 200)
    b = JSyntheticSource(**kw, sensor=JSENSORS["landsat-ard-tiny"]).chip(
        100, 200)
    assert (a.spectra == b.spectra).all() and (a.dates == b.dates).all()

"""The port's ops surface against the JAX package's, on the CPU: the span
tracer and its wire format, JSON log lines, histogram exemplars, the ops
endpoints, the stall watchdog, the flight recorder, the device profiler's
attribution and the live SLO evaluation (firebird_tpu_torch/obs/)."""

import gzip
import json
import logging
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from firebird_tpu.obs import flightrec as jflightrec
from firebird_tpu.obs import jsonlog as jjsonlog
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu.obs import profiling as jprofiling
from firebird_tpu.obs import slo as jslo
from firebird_tpu.obs import tracing as jtracing
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import core
from firebird_tpu_torch.obs import flightrec, jsonlog, profiling, slo
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import report as obs_report
from firebird_tpu_torch.obs import server as obs_server
from firebird_tpu_torch.obs import tracing
from firebird_tpu_torch.obs.metrics import PROM_LINE_RE
from firebird_tpu_torch.obs.watchdog import Watchdog

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def clean():
    obs_metrics.reset_registry()
    yield
    obs_server.clear_status()
    jsonlog.clear_run_context()
    jjsonlog.clear_run_context()
    flightrec.disarm()
    jflightrec.disarm()
    obs_metrics.reset_registry()


def _get(port, path, method="GET"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method=method, data=b"" if method == "POST"
                                 else None)
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# ---------------------------------------------------------------------------
# Tracer, wire format, JSON logs, exemplars
# ---------------------------------------------------------------------------

def _drive(mod):
    """One sequence of spans, nested and on two threads, through a
    tracing module; returns its Chrome trace."""
    tr = mod.start(run_id="rid")
    try:
        def work(tag):
            with mod.activate(mod.TraceContext(f"rid/{tag}", run_id="rid")):
                with mod.span("fetch", chips=2):
                    with mod.span("pack", chips=1):
                        pass
                    with mod.span("stage", chips=1, leg=("h2d",)):
                        time.sleep(0.001)
        work("b0")
        t = threading.Thread(target=work, args=("b1",), name="worker-1")
        t.start()
        t.join()
        with mod.span("drain", chips=3):
            pass
    finally:
        mod.stop()
    return tr.to_chrome_trace()


def _structure(trace):
    """(lane name, span name, args less the span id, parent span name) of
    every complete event, and the metadata tracks; timestamps ignored."""
    evs = trace["traceEvents"]
    lanes = {e["tid"]: e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "thread_name"}
    xs = [e for e in evs if e["ph"] == "X"]
    out = []
    for e in xs:
        enclosing = [p for p in xs if p is not e and p["tid"] == e["tid"]
                     and p["ts"] <= e["ts"]
                     and p["ts"] + p["dur"] >= e["ts"] + e["dur"]]
        parent = min(enclosing, key=lambda p: p["dur"])["name"] \
            if enclosing else None
        args = {k: v for k, v in e.get("args", {}).items()
                if k != "span_id"}
        assert e.get("args", {}).get("span_id", 0) > 0
        out.append((lanes[e["tid"]], e["name"], args, parent))
    meta = sorted((e["name"], json.dumps(e["args"])) for e in evs
                  if e["ph"] == "M")
    return out, meta


def test_tracer_chrome_structure_equals_jax():
    got, want = _structure(_drive(tracing)), _structure(_drive(jtracing))
    assert got == want
    spans = got[0]
    assert ("worker-1", "pack", {"chips": 1, "batch": "rid/b1"},
            "fetch") in spans
    assert ("MainThread", "drain", {"chips": 3}, None) in spans
    obs_report.validate_trace(_drive(tracing))


def test_tracer_summary_equals_jax():
    a, b = tracing.Tracer(), jtracing.Tracer()
    for t in (a, b):
        for name in ("fetch", "fetch", "drain"):
            with t.span(name):
                pass
    sa, sb = a.summary(), b.summary()
    assert set(sa) == set(sb) == {"fetch", "drain"}
    for k in sa:
        assert sa[k]["count"] == sb[k]["count"]
        assert set(sa[k]) == set(sb[k])


@pytest.mark.parametrize("src, dst", [(tracing, jtracing),
                                      (jtracing, tracing)],
                         ids=["port_to_jax", "jax_to_port"])
def test_wire_format_roundtrips_between_packages(src, dst):
    ctx = src.TraceContext(src.new_batch_id("6ad4-1a2b"), run_id="6ad4-1a2b")
    back = dst.from_wire(src.to_wire(ctx), run_id="6ad4-1a2b")
    assert back.batch_id == ctx.batch_id and back.run_id == ctx.run_id
    assert dst.from_wire("bad id with spaces") is None
    assert src.to_wire(None) is None


def test_json_log_line_equals_jax(clean):
    rec = logging.LogRecord("firebird.pyccd", logging.WARNING, __file__, 1,
                            "chip (%d,%d) failed", (3, 4), None)
    lines = []
    for jl, tr in ((jsonlog, tracing), (jjsonlog, jtracing)):
        jl.set_run_context(run_id="run-x", process_index=1)
        with tr.activate(tr.TraceContext("run-x/b3", run_id="run-x")):
            lines.append(json.loads(jl.JsonFormatter().format(rec)))
        lines.append(json.loads(jl.JsonFormatter().format(rec)))
        jl.clear_run_context()
    assert lines[0] == lines[2] and lines[1] == lines[3]
    assert lines[0]["batch"] == "run-x/b3" and "batch" not in lines[1]
    assert lines[0]["run_id"] == "run-x" and lines[0]["process_id"] == 1


def test_configure_swaps_in_the_json_formatter(monkeypatch):
    import firebird_tpu_torch.obs as obs

    root = logging.getLogger("firebird")
    monkeypatch.setenv("FIREBIRD_LOG_FORMAT", "json")
    monkeypatch.setattr(obs, "_configured", False)
    obs.configure()
    assert root.handlers and all(
        isinstance(h.formatter, jsonlog.JsonFormatter)
        for h in root.handlers)
    monkeypatch.delenv("FIREBIRD_LOG_FORMAT")
    monkeypatch.setattr(obs, "_configured", False)
    obs.configure()
    assert not any(isinstance(h.formatter, jsonlog.JsonFormatter)
                   for h in root.handlers)


def test_histogram_exemplars_equal_jax_and_survive_the_merge(clean):
    snaps = []
    for m, tr in ((obs_metrics, tracing), (jmetrics, jtracing)):
        hs = []
        for host in ("A", "B"):
            h = m.Histogram("drain_seconds")
            for i in range(6):
                with tr.activate(tr.TraceContext(f"{host}/b{i}")):
                    h.observe(0.01 * (i + 1) * (2 if host == "B" else 1))
            h.observe(9.0)                       # no context: no exemplar
            hs.append(h.snapshot())
        snaps.append((hs, m.merge_histogram_snapshots(hs)))
    # span ids are each package's own process-wide counter
    strip = lambda snap: dict(snap, exemplars=[
        {k: v for k, v in e.items() if k != "span_id"}
        for e in snap["exemplars"]])
    snaps = [([strip(h) for h in hs], strip(m)) for hs, m in snaps]
    assert snaps[0] == snaps[1]
    (a, _), merged = snaps[0]
    assert len(a["exemplars"]) == obs_metrics.EXEMPLAR_SLOTS
    assert a["exemplars"][0]["batch"] == "A/b5"
    assert merged["exemplars"][0]["batch"] == "B/b5"


def test_prometheus_exposition_equals_jax():
    regs = []
    for m in (obs_metrics, jmetrics):
        reg = m.MetricsRegistry()
        reg.counter("chips_detected").inc(3)
        reg.counter("watchdog_stall_total").inc()
        reg.gauge("store_queue_depth").set(2)
        reg.histogram("pipeline_drain_seconds").observe(0.2)
        regs.append(reg.prometheus())
    assert regs[0] == regs[1]
    for ln in regs[0].splitlines():
        assert PROM_LINE_RE.match(ln), ln


# ---------------------------------------------------------------------------
# Ops endpoints
# ---------------------------------------------------------------------------

def test_default_config_binds_nothing(clean):
    assert Config().ops_port == 0 and Config().stall_sec == 0
    _, srv, wd = core.start_ops(Config(), "rid", "test", chips_total=1,
                                counters=obs_metrics.Counters(),
                                run_block={})
    try:
        assert srv is None and wd is None
        assert flightrec.active() is not None      # armed by default
    finally:
        core.stop_ops(srv, wd)
    assert flightrec.active() is None and obs_server.current() is None


def test_ops_endpoints_roundtrip(clean):
    counters = obs_metrics.Counters()
    counters.add("chips", 3)
    obs_metrics.histogram("pipeline_drain_seconds").observe(1.0)
    status = obs_server.set_status(obs_server.RunStatus(
        "run-1", "changedetection", chips_total=8, counters=counters,
        run={"kind": "changedetection", "run_id": "run-1"},
        slo_spec="batch_p95=30"))
    srv = obs_server.start_ops_server(0, status, host="127.0.0.1")
    try:
        assert _get(srv.port, "/healthz") == (200, b"ok\n")
        assert _get(srv.port, "/readyz")[0] == 503
        status.dispatch_starting()                 # no profiler: no-op
        status.batch_dispatched()
        assert _get(srv.port, "/readyz")[0] == 200
        status.set_stage("dispatch")
        status.batch_done(3)
        code, body = _get(srv.port, "/progress")
        prog = json.loads(body)
        assert code == 200 and prog["run_id"] == "run-1"
        assert prog["stage"] == "dispatch" and prog["chips_done"] == 3
        assert prog["batches_dispatched"] == prog["batches_done"] == 1
        code, body = _get(srv.port, "/metrics")
        assert code == 200 and b"firebird_pipeline_drain_seconds" in body
        for ln in body.decode().splitlines():
            assert PROM_LINE_RE.match(ln), ln
        code, body = _get(srv.port, "/report")
        rep = json.loads(body)
        obs_report.validate_report(rep)
        assert rep["run_counters"]["chips"] == 3
        assert rep["slo"]["spec"] == "batch_p95=30"
        code, body = _get(srv.port, "/slo")
        doc = json.loads(body)
        assert code == 200 and doc["ok"] is True
        assert doc["objectives"][0]["value_sec"] == 1.0
        # the series store is not ported: the JAX server's answers with
        # that store off
        assert doc["budgets"]["disabled"] is True
        assert "not ported" in doc["budgets"]["reason"]
        assert "budgets" not in json.loads(
            _get(srv.port, "/slo?budgets=0")[1])
        code, body = _get(srv.port, "/metrics/history")
        assert code == 503 and b"metric history disabled" in body
        assert _get(srv.port, "/metrics/history?res=x")[0] == 400
        # no profiler for this run
        assert _get(srv.port, "/profile")[0] == 503
        assert _get(srv.port, "/profile?seconds=1", "POST")[0] == 503
        code, body = _get(srv.port, "/nope")
        assert code == 404 and b"unknown path" in body
    finally:
        srv.close()


def test_post_profile_opens_a_window(clean, tmp_path):
    prof = profiling.DeviceProfiler(str(tmp_path / "dp"))
    status = obs_server.RunStatus("r", "test", profiler=prof)
    srv = obs_server.start_ops_server(0, status, host="127.0.0.1")
    try:
        code, body = _get(srv.port, "/profile?seconds=0.05", "POST")
        assert code == 202 and json.loads(body)["started"]
        assert _get(srv.port, "/profile?seconds=nan", "POST")[0] == 400
        prof.close()
        code, body = _get(srv.port, "/profile")
        assert code == 200 and len(json.loads(body)["windows"]) == 1
    finally:
        srv.close()


def test_start_ops_tears_down_on_bind_failure(clean, monkeypatch):
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    cfg = Config(store_backend="memory", ops_port=port, stall_sec=60.0,
                 ops_host="127.0.0.1")
    try:
        with pytest.raises(OSError):
            core.start_ops(cfg, "rid", "test", chips_total=1,
                           counters=obs_metrics.Counters(), run_block={})
        assert obs_server.current() is None
        assert jsonlog.get_run_context()["run_id"] is None
        assert flightrec.active() is None
    finally:
        blocker.close()


# ---------------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------------

def test_watchdog_stalls_recovers_and_flips_healthz(clean):
    clock = [0.0]
    wd = Watchdog(stall_sec=5.0, clock=lambda: clock[0])
    clock[0] = 12.0                 # inside the bring-up grace (3x)
    assert not wd.check()
    wd.beat()
    status = obs_server.RunStatus("run-3", "changedetection", watchdog=wd)
    srv = obs_server.start_ops_server(0, status, host="127.0.0.1")
    try:
        assert _get(srv.port, "/healthz")[0] == 200
        clock[0] = 18.0
        assert _get(srv.port, "/healthz") == (503, b"stalled\n")
        _get(srv.port, "/healthz")
        assert obs_metrics.counter("watchdog_stall_total").value == 1
        assert not json.loads(_get(srv.port, "/progress")[1])["healthy"]
        wd.beat()
        assert _get(srv.port, "/healthz")[0] == 200
        assert obs_metrics.counter("watchdog_recovered_total").value == 1
    finally:
        srv.close()


class _NoChips:
    """A source whose every fetch fails: the chip is quarantined at once,
    so a run spends next to nothing after its ops surface comes up."""

    def chip(self, cx, cy, acquired=None):
        raise IOError("no chip")


@pytest.mark.parametrize("slow_in", ["build", "run"])
def test_slow_kernel_build_does_not_trip_the_watchdog(clean, tmp_path,
                                                      monkeypatch, slow_in):
    """The kernels build before the watchdog starts: a build longer than
    the bring-up grace (stall_sec x 3) trips nothing, where the same wait
    inside the run stalls it."""
    if slow_in == "build":
        monkeypatch.setattr(core, "build_kernels",
                            lambda dev, cfg, log: time.sleep(1.0))
    else:
        run_chunk = core.run_chunk

        def slow(*a, **kw):
            time.sleep(1.0)
            return run_chunk(*a, **kw)

        monkeypatch.setattr(core, "run_chunk", slow)
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"),
                 fetch_retries=0, stall_sec=0.2)
    assert core.changedetection(100, 200, number=1, chunk_size=1, cfg=cfg,
                                source=_NoChips(), device="cpu") == ()
    rep = json.load(open(tmp_path / "obs_report.json"))
    stalls = rep["metrics"]["counters"].get("watchdog_stall_total", 0)
    if slow_in == "build":
        assert stalls == 0
        assert not (tmp_path / "postmortem.json").exists()
    else:
        assert stalls == 1
        pm = json.load(open(tmp_path / "postmortem.json"))
        assert pm["reason"] == "watchdog_stall"


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

def _thread_crash_bundle(mod, path):
    quiet = lambda args: None
    orig = threading.excepthook
    threading.excepthook = quiet
    try:
        mod.arm(str(path), ring=8, run_id="rid", fingerprint="fp")

        def crash():
            raise ValueError("thread died")

        t = threading.Thread(target=crash, name="doomed")
        t.start()
        t.join()
    finally:
        mod.disarm()
        threading.excepthook = orig
    return json.load(open(path))


def test_flightrec_excepthook_bundle_has_the_jax_keys(clean, tmp_path):
    got = _thread_crash_bundle(flightrec, tmp_path / "port.json")
    want = _thread_crash_bundle(jflightrec, tmp_path / "jax.json")
    assert set(want) <= set(got) and set(got) - set(want) == {"device"}
    assert got["schema"] == want["schema"] == "firebird-postmortem/1"
    assert got["reason"] == "unhandled_exception"
    assert got["exception"] == {**want["exception"],
                                "traceback": got["exception"]["traceback"]}
    assert got["device"] == {"platform": "cpu"}
    assert got["run_id"] == "rid" and got["config_fingerprint"] == "fp"


def _stall_bundle(rec_mod, tr_mod, wd_cls, path):
    rec_mod.arm(str(path), ring=8, run_id="rid")
    try:
        clock = [0.0]
        wd = wd_cls(stall_sec=10.0, clock=lambda: clock[0])
        wd.beat()
        with tr_mod.span("drain", chips=1):
            pass
        clock[0] = 11.0
        assert wd.check()
    finally:
        rec_mod.disarm()
    return json.load(open(path))


def test_flightrec_watchdog_stall_bundle_has_the_jax_keys(clean, tmp_path):
    from firebird_tpu.obs.watchdog import Watchdog as JWatchdog

    got = _stall_bundle(flightrec, tracing, Watchdog, tmp_path / "p.json")
    want = _stall_bundle(jflightrec, jtracing, JWatchdog, tmp_path / "j.json")
    assert set(got) - set(want) == {"device"} and set(want) <= set(got)
    assert got["reason"] == want["reason"] == "watchdog_stall"
    ring = got["threads"][threading.current_thread().name]
    assert ("span", "drain") in [(e["kind"], e.get("name")) for e in ring]
    assert got["metrics"]["counters"]["watchdog_stall_total"] == 1


def test_postmortem_path_is_next_to_the_store(tmp_path):
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "x.db"))
    assert flightrec.postmortem_path(cfg) == str(tmp_path / "postmortem.json")
    assert flightrec.postmortem_path(Config(store_backend="memory")) is None


# ---------------------------------------------------------------------------
# Device profiler
# ---------------------------------------------------------------------------

def _write(dirpath, events, name="host.1.trace.json.gz"):
    os.makedirs(dirpath, exist_ok=True)
    with gzip.open(os.path.join(dirpath, name), "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_attribution_counts_device_events_only(tmp_path):
    _write(str(tmp_path), [
        {"ph": "X", "cat": "kernel", "name": "lasso_fit_kernel(short const*,"
         " float const*)", "ts": 100.0, "dur": 2000.0},
        {"ph": "X", "cat": "kernel", "name": "monitor_kernel", "ts": 1100.0,
         "dur": 1000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
         "Pinned)", "ts": 5000.0, "dur": 500.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 6000.0, "dur": 250.0},
        # host events: never device time
        {"ph": "X", "cat": "cpu_op", "name": "aten::lasso_fit_like",
         "ts": 0.0, "dur": 9e6},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 0.0, "dur": 8e6},
        {"ph": "X", "cat": "python_function", "name": "monitor", "ts": 0.0,
         "dur": 7e6},
        {"ph": "B", "cat": "kernel", "name": "not_complete", "dur": 9e9},
    ])
    a = profiling.attribute_phases(str(tmp_path))
    assert a["source"] == "trace" and a["events"] == 4
    assert a["fit_ms"] == 2.0 and a["monitor_ms"] == 1.0
    assert a["other_ms"] == 0.75 and a["total_ms"] == 3.75
    # the two kernels overlap by a millisecond
    assert a["device_busy_ms"] == 2.75
    # the JAX package's rule (every complete event) on the same trace
    # would book the host events too
    assert jprofiling.attribute_phases(str(tmp_path))["total_ms"] > 1e4


# The port's kernel symbols and the phase each falls under.
PORT_KERNELS = [
    ("lasso_fit_kernel", "fit"), ("fused_fit_close_kernel", "fit"),
    ("lasso_cd_kernel", "fit"), ("monitor_kernel", "monitor"),
    ("monitor_plane_kernel", "monitor"), ("tmask_kernel", "monitor"),
    ("init_kernel", "other"), ("fused_round_kernel", "other"),
    ("mega_kernel", "other"), ("ring_copy_kernel", "other")]


@pytest.mark.parametrize("symbol, phase", PORT_KERNELS,
                         ids=[k for k, _ in PORT_KERNELS])
def test_port_kernels_bucket_as_in_jax(tmp_path, symbol, phase):
    names = (symbol, f"{symbol}(short const*, float const*, int, float*)",
             f"void {symbol}<7>(float const*, unsigned char const*, int)")
    for i, name in enumerate(names):
        d = str(tmp_path / str(i))
        _write(d, [{"ph": "X", "cat": "kernel", "name": name, "ts": 0.0,
                    "dur": 1000.0}])
        assert profiling.phase_of(name) == phase, name
        a, j = profiling.attribute_phases(d), jprofiling.attribute_phases(d)
        assert a[f"{phase}_ms"] == j[f"{phase}_ms"] == 1.0, name
    assert profiling.PHASE_PATTERNS == jprofiling.PHASE_PATTERNS
    assert profiling.PHASES == jprofiling.PHASES


def test_cpu_window_writes_its_trace_and_reports_no_device_events(
        clean, tmp_path):
    prof = profiling.DeviceProfiler(str(tmp_path / "device_profile"))
    x = torch.ones(64, 64)
    info = prof.window(0.05, block=True)
    (x @ x).sum()
    assert "error" not in info, info
    assert os.path.exists(info["trace_file"])
    assert info["trace_file"].endswith(".trace.json.gz")
    a = info["attribution"]
    assert a["source"] == "no-device-events" and a["total_ms"] == 0.0
    assert a["events"] == 0 and a["window_ms"] > 0
    assert set(jprofiling.empty_attribution()) <= set(a)
    s = prof.summary()
    assert len(s["windows"]) == 1 and not s["in_flight"]
    assert s["device_time"]["source"] == "no-device-events"
    assert obs_metrics.counter("profile_windows").value == 1


def test_one_window_at_a_time_and_early_close(tmp_path):
    prof = profiling.DeviceProfiler(str(tmp_path / "dp"))
    prof.window(60.0, wait_started=30.0)
    with pytest.raises(profiling.ProfilerBusy):
        prof.window(1.0)
    prof.close(timeout=120.0)
    s = prof.summary()
    assert len(s["windows"]) == 1 and not s["in_flight"]
    assert s["windows"][0]["attribution"]["window_ms"] < 30_000


def test_auto_window_opens_once_and_waits_for_its_capture(tmp_path,
                                                          monkeypatch):
    prof = profiling.DeviceProfiler(str(tmp_path / "dp"))
    started = []
    monkeypatch.setattr(prof, "window",
                        lambda s, wait_started=0.0: started.append(
                            (s, wait_started)))
    prof.arm_auto(2.5)
    prof.maybe_start_auto()
    prof.maybe_start_auto()
    assert len(started) == 1 and started[0][0] == 2.5
    assert started[0][1] > 0


def test_profile_report_block_always_structured():
    profiling.set_active(None)
    block = profiling.report_block()
    assert block["windows"] == [] and block["in_flight"] is False
    assert block["device_time"]["source"] == "none"
    assert set(jprofiling.report_block()["device_time"]) <= set(
        block["device_time"])


# ---------------------------------------------------------------------------
# Live SLO evaluation
# ---------------------------------------------------------------------------

SNAPSHOTS = [
    ({"histograms": {"pipeline_drain_seconds": {"count": 10, "p95": 12.0}}},
     None, "batch_p95=30;serve_p99=2"),
    ({"histograms": {"pipeline_drain_seconds": {
        "count": 3, "p95": 50.0,
        "exemplars": [{"value": 55.0, "batch": "r/b9", "span_id": 4}]}}},
     {"last_beat_age_sec": 700.0}, "batch_p95=30;freshness=600"),
    ({"histograms": {}, "gauges": {"serve_changefeed_lag_seconds": 3.0},
      "counters": {"probe_failures": 1, "probe_attempts": 4}}, None, None),
    ({"histograms": {}}, None, "0"),
]


@pytest.mark.parametrize("metrics, watchdog, spec", SNAPSHOTS)
def test_slo_evaluation_equals_jax(metrics, watchdog, spec):
    got = slo.evaluate_snapshot(metrics, watchdog=watchdog, spec=spec)
    assert got == jslo.evaluate_snapshot(metrics, watchdog=watchdog,
                                         spec=spec)


def test_slo_spec_grammar_and_config_fail_fast():
    assert slo.parse_spec("batch_p95=30;serve_p99=2") == \
        jslo.parse_spec("batch_p95=30;serve_p99=2")
    assert slo.OBJECTIVES == jslo.OBJECTIVES
    assert slo.DEFAULT_SPEC == jslo.DEFAULT_SPEC
    for bad in ("bogus=1", "batch_p95", "batch_p95=fast", "batch_p95=0"):
        with pytest.raises(ValueError):
            slo.parse_spec(bad)
        with pytest.raises(ValueError):
            Config(slo=bad)
    Config(slo="0")
    Config(slo="batch_p95=10")

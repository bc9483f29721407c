"""The port's error budgets (firebird_tpu_torch/obs/slo.py over
obs/series.py), the ops endpoints that serve them and the ``slo``
command, against the JAX package's on the CPU.

Every budget case evaluates the same series directory through both
packages: the verdicts must be equal, key for key and value for value,
and the durable event logs (``slo_events.jsonl``) the same bytes."""

import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

from firebird_tpu.obs import series as jseries
from firebird_tpu.obs import slo as jslo
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import series as tseries
from firebird_tpu_torch.obs import server as obs_server
from firebird_tpu_torch.obs import slo

from test_torch_series import T0, _hist, _snap, _write_spool


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
    obs_server.clear_status()


def _ingest(directory, events):
    store = tseries.SeriesStore(str(directory))
    store.ingest_events(events)
    store.close()


def _verdicts(directory, spec, **kw):
    """The port's and JAX's verdicts on one series directory, held equal."""
    v = slo.evaluate_budgets(str(directory), spec, now=T0, **kw)
    assert v == jslo.evaluate_budgets(str(directory), spec, now=T0, **kw)
    return v


# ---------------------------------------------------------------------------
# The budget grammar and the config's fail-fast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "alert_freshness<60@99.9/28d", "probe_errors@99/1d", "",
    slo.DEFAULT_BUDGET_SPEC, "serve_p99<2@99/7d;changefeed_lag<10@95/90m",
    "drain_eta<3600@99.5/3600s;fanout_p99<30@99/2h"])
def test_budget_spec_parses_as_jax(spec):
    assert slo.parse_budget_spec(spec) == jslo.parse_budget_spec(spec)


@pytest.mark.parametrize("spec, match", [
    ("bogus<1@99/1d", "unknown budget objective"),
    ("freshness<600@99/1d", "watchdog-kind"),
    ("probe_errors<1@99/1d", "takes no"),
    ("serve_p99@99/1d", "needs a <threshold"),
    ("serve_p99<2@99", "missing its /window"),
    ("serve_p99<2@99/soon", "not\\s+<number>"),
    ("serve_p99<2@100/1d", "percentage"),
    ("serve_p99<x@99/1d", "is not a number"),
    ("serve_p99<0@99/1d", "must be > 0"),
    ("serve_p99", "is not name")])
def test_budget_spec_refuses_as_jax(spec, match):
    with pytest.raises(ValueError, match=match) as mine:
        slo.parse_budget_spec(spec)
    with pytest.raises(ValueError) as theirs:
        jslo.parse_budget_spec(spec)
    assert str(mine.value) == str(theirs.value)


def test_budget_config_fail_fast():
    Config(slo_budget="serve_p99<2@99/7d")               # valid
    Config(slo_budget="0")                               # disabled
    with pytest.raises(ValueError):
        Config(slo_budget="nope<1@99/1d")
    with pytest.raises(ValueError, match="two scales"):
        Config(slo_fast_sec=600.0, slo_slow_sec=600.0)
    with pytest.raises(ValueError):
        Config(slo_burn=0.0)
    with pytest.raises(ValueError):
        Config(series=-1)
    with pytest.raises(ValueError):
        Config(series_segments=1)


def test_slo_budget_is_ported():
    """FIREBIRD_SLO_BUDGET is honoured: no longer refused, parsed from the
    environment, and the spec every budget reader evaluates."""
    from firebird_tpu_torch.config import NOT_PORTED

    assert "slo_budget" not in NOT_PORTED
    cfg = Config.from_env(slo_budget="probe_errors@99/1d")
    assert [b["name"] for b in slo.parse_budget_spec(cfg.slo_budget)] == \
        ["probe_errors"]


@pytest.mark.parametrize("window, res", [
    (60.0, 10), (300.0, 10), (3600.0, 300), (86400.0, 3600),
    (28 * 86400.0, 3600), (1.0, 10)])
def test_pick_resolution_as_jax(window, res):
    got = slo._pick_resolution(window, tseries.RESOLUTIONS)
    assert got == res == jslo._pick_resolution(window, jseries.RESOLUTIONS)


# ---------------------------------------------------------------------------
# Evaluation: no-data semantics, burn, exhaustion, durable events
# ---------------------------------------------------------------------------

def test_budget_no_data_contributes_zero_burn(tmp_path):
    v = _verdicts(tmp_path, "probe_errors@99/1d")
    assert v["ok"] is True and v["violations"] == 0
    (b,) = v["budgets"]
    assert b["ok"] is None and not b["exhausted"] and not b["burning"]
    assert b["empty_windows"] == ["window", "fast", "slow"]
    assert b["fast_burn"] is None and b["budget_spent"] is None


def test_budget_partial_data_names_empty_windows(tmp_path):
    bad = _hist(10, 100.0, (2.0,), (0, 10))
    _ingest(tmp_path, [
        _snap(T0 - 2000.0, role="serve", pid=9,
              hists={"serve_request_seconds": _hist(0, 0.0, (2.0,),
                                                    (0, 0))}),
        _snap(T0 - 1000.0, role="serve", pid=9,
              hists={"serve_request_seconds": bad})])
    v = _verdicts(tmp_path, "serve_p99<2@99/7d")
    (b,) = v["budgets"]
    assert b["empty_windows"] == ["fast"]
    assert b["burning"] is False and b["exhausted"] is True
    assert b["ok"] is False and v["ok"] is False


def test_budget_burning_and_exhaustion_from_ratio_counters(tmp_path):
    _ingest(tmp_path, [
        _snap(T0 - 3000.0, role="prober", pid=5,
              counters={"probe_attempts": 10.0, "probe_failures": 0.0}),
        _snap(T0 - 310.0, role="prober", pid=5,
              counters={"probe_attempts": 90.0, "probe_failures": 40.0}),
        _snap(T0 - 100.0, role="prober", pid=5,
              counters={"probe_attempts": 100.0, "probe_failures": 50.0})])
    v = _verdicts(tmp_path, "probe_errors@99/1d")
    assert v["sources"] == ["prober:5"]
    (b,) = v["budgets"]
    assert b["fast_burn"] == pytest.approx(100.0)
    assert b["slow_burn"] == pytest.approx(50.0)
    assert b["burning"] is True
    assert b["total"] == 100.0 and b["bad"] == 50.0
    assert b["exhausted"] is True and b["budget_spent"] == 50.0
    assert b["ok"] is False and v["violations"] == 1
    # a healthy canary over the same shape: no page, budget intact
    for f in tmp_path.iterdir():
        f.unlink()
    _ingest(tmp_path, [
        _snap(T0 - 3000.0, role="prober", pid=5,
              counters={"probe_attempts": 10.0, "probe_failures": 0.0}),
        _snap(T0 - 100.0, role="prober", pid=5,
              counters={"probe_attempts": 500.0, "probe_failures": 0.0})])
    (b,) = _verdicts(tmp_path, "probe_errors@99/1d")["budgets"]
    assert b["ok"] is True and b["fast_burn"] == 0.0


@pytest.mark.parametrize("threshold, burning", [(14.4, False),
                                                (14.39, True)])
def test_budget_burn_decision_uses_unrounded_ratio(tmp_path, threshold,
                                                   burning):
    """A window burning at 14.3996x reports 14.4 but must not page a 14.4
    threshold; a threshold just under the true ratio must page."""
    _ingest(tmp_path, [
        _snap(T0 - 4000.0, role="prober", pid=5,
              counters={"probe_attempts": 10_000_000.0,
                        "probe_failures": 0.0}),
        _snap(T0 - 310.0, role="prober", pid=5,
              counters={"probe_attempts": 10_000_000.0,
                        "probe_failures": 0.0}),
        _snap(T0 - 100.0, role="prober", pid=5,
              counters={"probe_attempts": 10_250_000.0,
                        "probe_failures": 35_999.0})])
    v = _verdicts(tmp_path, "probe_errors@99/1d", burn_threshold=threshold)
    (b,) = v["budgets"]
    assert b["fast_burn"] == 14.4 and b["slow_burn"] == 14.4
    assert b["burning"] is burning and b["exhausted"] is False
    assert v["ok"] is (not burning)


def test_budget_gauge_and_histogram_chain(tmp_path):
    """Gauge budgets count bad samples over samples; the alert_freshness
    chain judges on the first histogram with observations."""
    _ingest(tmp_path, [
        _snap(T0 - 320.0 + 10 * i, role="serve", pid=3,
              gauges={"serve_changefeed_lag_seconds": float(5 * i)},
              hists={"alert_visible_seconds": _hist(
                  2 * i, 30.0 * i, (30.0, 90.0), (i, i, 0))})
        for i in range(12)])
    v = _verdicts(tmp_path, "changefeed_lag<10@95/1h;"
                            "alert_freshness<60@99.9/28d")
    by = {b["name"]: b for b in v["budgets"]}
    assert by["changefeed_lag"]["total"] > 0
    assert by["changefeed_lag"]["bad"] > 0
    assert by["alert_freshness"]["kind"] == "histogram"


@pytest.mark.parametrize("seed", [3, 4])
def test_default_spec_verdicts_equal_jax_on_random_series(tmp_path, seed):
    """The built-in spec over random multi-source history, at a few
    evaluation instants: the verdicts equal JAX's."""
    import numpy as np

    rng = np.random.default_rng(seed)
    events = []
    for pid in (11, 12):
        att = fail = 0.0
        lat = np.zeros(3)
        for t in np.sort(rng.uniform(-7200, 0, 40)):
            att += float(rng.integers(1, 20))
            fail += float(rng.integers(0, 3))
            lat += rng.integers(0, 4, 3)
            events.append(_snap(
                T0 + float(t), role="prober", pid=pid,
                counters={"probe_attempts": att, "probe_failures": fail},
                hists={"serve_request_seconds": _hist(
                    int(lat.sum()), float(lat @ [0.5, 1.5, 9.0]),
                    (1.0, 2.0), lat.tolist())}))
    _ingest(tmp_path, events)
    for dt_ in (0.0, -900.0, -3600.0):
        kw = dict(now=T0 + dt_, fast_sec=300.0, slow_sec=1800.0)
        v = slo.evaluate_budgets(str(tmp_path), None, **kw)
        assert v == jslo.evaluate_budgets(str(tmp_path), None, **kw)
        assert {b["name"] for b in v["budgets"]} == {
            b["name"] for b in slo.parse_budget_spec(
                slo.DEFAULT_BUDGET_SPEC)}


def _state_verdict(state):
    return {"budgets": [{
        "name": "probe_errors", "bad": 5.0, "total": 10.0,
        "allowed_bad": 0.1, "window_sec": 300.0,
        "fast_burn": 50.0, "slow_burn": 50.0,
        "exhausted": state == "exhausted",
        "burning": state in ("burning", "exhausted"),
        "ok": None if state == "no_data" else state == "ok"}]}


def test_budget_events_record_transitions_only(tmp_path):
    dt, dj = tmp_path / "port", tmp_path / "jax"
    seq = ("ok", "burning", "burning", "exhausted", "ok", "no_data")
    for i, state in enumerate(seq):
        got = slo.record_budget_events(str(dt), _state_verdict(state),
                                       now=T0 + i)
        assert got == jslo.record_budget_events(
            str(dj), _state_verdict(state), now=T0 + i)
    assert (dt / slo.BUDGET_EVENTS_FILE).read_bytes() == \
        (dj / jslo.BUDGET_EVENTS_FILE).read_bytes()
    states = [e["state"] for e in slo.read_budget_events(str(dt))]
    assert states == ["burning", "exhausted", "ok"]
    assert slo.read_budget_events(str(dt)) == \
        jslo.read_budget_events(str(dt))
    with open(slo.budget_events_path(str(dt)), "a") as f:
        f.write('{"name": "torn')
    assert [e["state"] for e in slo.read_budget_events(str(dt))] == states


def test_evaluate_and_record_appends_as_jax(tmp_path):
    events = [
        _snap(T0 - 700.0, role="prober", pid=5,
              counters={"probe_attempts": 0.0, "probe_failures": 0.0}),
        _snap(T0 - 100.0, role="prober", pid=5,
              counters={"probe_attempts": 10.0, "probe_failures": 10.0})]
    dt, dj = tmp_path / "port", tmp_path / "jax"
    _ingest(dt, events)
    store = jseries.SeriesStore(str(dj))
    store.ingest_events(events)
    store.close()
    v = slo.evaluate_and_record(str(dt), "probe_errors@99/1d", now=T0)
    assert v == jslo.evaluate_and_record(str(dj), "probe_errors@99/1d",
                                         now=T0)
    assert v["ok"] is False
    assert [e["state"] for e in v["events_appended"]] in \
        (["burning"], ["exhausted"])
    assert (dt / slo.BUDGET_EVENTS_FILE).read_bytes() == \
        (dj / jslo.BUDGET_EVENTS_FILE).read_bytes()
    # JAX's reader reads the port's log, and the reverse
    assert jslo.read_budget_events(str(dt)) == slo.read_budget_events(
        str(dj))


# ---------------------------------------------------------------------------
# Ops endpoints: /metrics/history and the /slo budgets block
# ---------------------------------------------------------------------------

@pytest.fixture
def ops_env(tmp_path, monkeypatch):
    """A file-backed telemetry home for Config.from_env(): one spool with
    historic snapshots plus the series dir next to it."""
    _write_spool(str(tmp_path), "worker", 42, [
        _snap(T0 + 5.0, counters={"scenes_seen": 3.0}),
        _snap(T0 + 25.0, counters={"scenes_seen": 8.0})])
    monkeypatch.setenv("FIREBIRD_SERIES_DIR", str(tmp_path / "series"))
    monkeypatch.setenv("FIREBIRD_TELEMETRY_DIR", str(tmp_path))
    return tmp_path


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as r:
        return json.loads(r.read())


def test_history_and_slo_budget_endpoints(ops_env, fresh_metrics):
    status = obs_server.set_status(obs_server.RunStatus(
        "r", "test", slo_spec="batch_p95=30"))
    srv = obs_server.start_ops_server(0, status, host="127.0.0.1")
    try:
        big = int(time.time() - T0 + 3600)
        doc = _get(srv.port, f"/metrics/history?window={big}")
        assert doc["schema"] == "firebird-metric-history/1"
        assert doc["sources"] == ["worker:42"]
        assert [p["b"] for p in doc["points"]] == \
            [int((T0 + 5.0) // 10), int((T0 + 25.0) // 10)]
        # the points are the rings' own, as JAX's reader reads them
        assert doc["points"] == jseries.read_points(
            str(ops_env / "series"), 10, doc["t1"] - big, doc["t1"])
        doc = _get(srv.port,
                   f"/metrics/history?window={big}&metric=scenes_seen")
        assert all(list(p["m"]["counters"]) == ["scenes_seen"]
                   for p in doc["points"])
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.port, "/metrics/history?res=7")
        assert ei.value.code == 400
        doc = _get(srv.port, "/slo")
        assert doc["ok"] is True and doc["budgets"]["ok"] is True
        assert {b["ok"] for b in doc["budgets"]["budgets"]} == {None}
        assert doc["budgets"]["spec"] == jslo.DEFAULT_BUDGET_SPEC
        assert "budgets" not in _get(srv.port, "/slo?budgets=0")
    finally:
        srv.close()
    assert jseries.read_points(str(ops_env / "series"), 10)


def test_slo_endpoint_evaluates_the_configured_budget(ops_env,
                                                      fresh_metrics,
                                                      monkeypatch):
    """FIREBIRD_SLO_BUDGET picks the budgets /slo evaluates."""
    monkeypatch.setenv("FIREBIRD_SLO_BUDGET", "probe_errors@99/1d")
    srv = obs_server.start_ops_server(0, None, host="127.0.0.1")
    try:
        doc = _get(srv.port, "/slo")
    finally:
        srv.close()
    assert doc["budgets"]["spec"] == "probe_errors@99/1d"
    assert [b["name"] for b in doc["budgets"]["budgets"]] == \
        ["probe_errors"]


def test_ops_server_shares_one_series_store(tmp_path, monkeypatch):
    monkeypatch.setenv("FIREBIRD_SERIES_DIR", str(tmp_path / "series"))
    monkeypatch.setenv("FIREBIRD_TELEMETRY_DIR", str(tmp_path))
    s1 = obs_server._shared_store(Config.from_env())
    s2 = obs_server._shared_store(Config.from_env())
    assert s1 is not None and s1 is s2
    monkeypatch.setenv("FIREBIRD_SERIES", "0")
    assert obs_server._shared_store(Config.from_env()) is None


def test_history_endpoint_disabled_without_series(tmp_path, monkeypatch,
                                                  fresh_metrics):
    monkeypatch.setenv("FIREBIRD_SERIES_DIR", str(tmp_path / "series"))
    monkeypatch.setenv("FIREBIRD_SERIES", "0")
    status = obs_server.set_status(obs_server.RunStatus("r", "test"))
    srv = obs_server.start_ops_server(0, status, host="127.0.0.1")
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.port, "/metrics/history")
        assert ei.value.code == 503
        assert _get(srv.port, "/slo")["budgets"]["disabled"] is True
    finally:
        srv.close()
    assert not (tmp_path / "series").exists()


# ---------------------------------------------------------------------------
# The slo command: exit codes 0, 1 and 2
# ---------------------------------------------------------------------------

def _slo(argv, env, monkeypatch, capsys):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        tmain.main(["slo"] + argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def test_slo_cli_exit_codes(tmp_path, monkeypatch, capsys):
    env = {"FIREBIRD_SERIES_DIR": str(tmp_path / "series"),
           "FIREBIRD_TELEMETRY_DIR": str(tmp_path)}
    code, out = _slo([], dict(env, FIREBIRD_TELEMETRY="0"), monkeypatch,
                     capsys)
    assert code == 2 and json.loads(out)["disabled"]
    monkeypatch.delenv("FIREBIRD_TELEMETRY")
    code, out = _slo([], env, monkeypatch, capsys)
    assert code == 0, out
    doc = json.loads(out)
    assert doc["ok"] is True and {b["ok"] for b in doc["budgets"]} == {None}
    now = time.time()
    _write_spool(str(tmp_path), "prober", 5, [
        _snap(now - 60.0, role="prober", pid=5,
              counters={"probe_attempts": 1.0, "probe_failures": 1.0}),
        _snap(now - 11.0, role="prober", pid=5,
              counters={"probe_attempts": 20.0, "probe_failures": 20.0})])
    args = ["-b", "probe_errors@99/5m", "--fast", "45", "--slow", "90"]
    code, out = _slo(args, env, monkeypatch, capsys)
    assert code == 1, out
    doc = json.loads(out)
    (b,) = doc["budgets"]
    assert b["ok"] is False and (b["burning"] or b["exhausted"])
    assert doc["events_appended"]
    n = len(slo.read_budget_events(str(tmp_path / "series")))
    assert n and jslo.read_budget_events(str(tmp_path / "series"))
    code, out = _slo(args + ["--no-record"], env, monkeypatch, capsys)
    assert code == 1 and "events_appended" not in json.loads(out)
    assert len(slo.read_budget_events(str(tmp_path / "series"))) == n


def test_slo_cli_answers_as_jax(tmp_path, monkeypatch, capsys):
    """The port's command and JAX's on one telemetry home, both pure reads
    at a fixed spec: the same JSON keys, the same verdicts."""
    from click.testing import CliRunner

    from firebird_tpu import cli

    now = time.time()
    _write_spool(str(tmp_path), "prober", 5, [
        _snap(now - 100.0, role="prober", pid=5,
              counters={"probe_attempts": 1.0, "probe_failures": 0.0}),
        _snap(now - 20.0, role="prober", pid=5,
              counters={"probe_attempts": 50.0, "probe_failures": 1.0})])
    env = {"FIREBIRD_SERIES_DIR": str(tmp_path / "series"),
           "FIREBIRD_TELEMETRY_DIR": str(tmp_path)}
    args = ["--no-record", "-b", "probe_errors@99/1h", "--fast", "60",
            "--slow", "600"]
    code, out = _slo(args, env, monkeypatch, capsys)
    res = CliRunner().invoke(cli.entrypoint, ["slo"] + args, env=env)
    assert code == res.exit_code == 1
    mine, theirs = json.loads(out), json.loads(res.output)
    assert set(mine) == set(theirs)
    for k in ("spec", "ok", "violations", "sources", "fast_sec", "slow_sec"):
        assert mine[k] == theirs[k], k
    for a, b in zip(mine["budgets"], theirs["budgets"]):
        assert set(a) == set(b)
        for k in ("name", "ok", "exhausted", "burning", "total", "bad",
                  "empty_windows"):
            assert a[k] == b[k], k

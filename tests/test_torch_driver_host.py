"""The port's host planes of the batch driver against the JAX package's, on
the CPU: ``config``, ``grid``, ``retry``, ``driver.quarantine`` and the
chip sources (``FileSource``, ``ChipmunkSource``, ``decode_raster``).

Each is the port's own copy of the JAX module, so the same inputs must
give the same outputs: the same Config and validation errors, the same
grid geometry on the recorded service responses, the same retry delays
under one seeded ``random`` and clock, quarantine and manifest files that
either package reads (byte for byte the same), and the same chips from a
directory or from the recorded Chipmunk responses.  Nothing here touches
the network.
"""

import base64
import json
import random
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np
import pytest

from firebird_tpu import config as jconfig
from firebird_tpu import grid as jgrid
from firebird_tpu import retry as jretry
from firebird_tpu.ingest import SyntheticSource as JSource
from firebird_tpu.ingest import sources as jsources
from firebird_tpu.utils import fn as jfn
from firebird_tpu_torch import config as tconfig
from firebird_tpu_torch import grid as tgrid
from firebird_tpu_torch import retry as tretry
from firebird_tpu_torch.driver import core as tcore
from firebird_tpu_torch.driver import quarantine as tq
from firebird_tpu_torch.ingest import sources as tsources
from firebird_tpu_torch.ingest.registry import Registry as TRegistry
from firebird_tpu_torch.utils import fn as tfn

DATA = Path(__file__).parent / "data" / "recorded"


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

ENVS = {
    "empty": {},
    "driver": {"FIREBIRD_STORE_BACKEND": "sqlite",
               "FIREBIRD_STORE_PATH": "/data/fb.db",
               "FIREBIRD_SOURCE": "synthetic", "FIREBIRD_DTYPE": "float64",
               "FIREBIRD_CHIPS_PER_BATCH": "0",
               "FIREBIRD_PIPELINE_DEPTH": "4",
               "FIREBIRD_INPUT_PARTITIONS": "3",
               "FIREBIRD_SYNTH_SENSOR": "landsat-ard-tiny"},
    "urls": {"ARD_CHIPMUNK": "http://host:5656/ard/c01/v1",
             "AUX_CHIPMUNK": "http://host:5656/aux/v2",
             "FIREBIRD_FETCH_RETRIES": "5",
             "FIREBIRD_RETRY_BUDGET": "40",
             "FIREBIRD_BREAKER_THRESHOLD": "0"},
    "bad_dtype": {"FIREBIRD_DTYPE": "bfloat16"},
    "bad_sharding": {"FIREBIRD_DEVICE_SHARDING": "some"},
    "bad_depth": {"FIREBIRD_PIPELINE_DEPTH": "0"},
    "bad_sensor": {"FIREBIRD_SYNTH_SENSOR": "modis"},
    "bad_retries": {"FIREBIRD_FETCH_RETRIES": "-1"},
    "bad_port": {"FIREBIRD_OPS_PORT": "70000"},
}


def _from_env(mod, env):
    try:
        return mod.Config.from_env(env), None
    except Exception as e:                                  # noqa: BLE001
        return None, (type(e), str(e))


@pytest.mark.parametrize("name", list(ENVS))
def test_config_from_env_equals_jax(name):
    want, werr = _from_env(jconfig, ENVS[name])
    got, gerr = _from_env(tconfig, ENVS[name])
    assert gerr == werr
    if want is not None:
        assert tconfig.Config.__dataclass_fields__.keys() == \
            jconfig.Config.__dataclass_fields__.keys()
        for f in jconfig.Config.__dataclass_fields__:
            assert getattr(got, f) == getattr(want, f), f
        assert got.keyspace() == want.keyspace()


def test_config_knob_registry_and_keyspace_equal_jax():
    assert [k.name for k in tconfig.KNOBS] == [k.name for k in jconfig.KNOBS]
    for k in jconfig.KNOBS:
        t = tconfig.KNOBS_BY_NAME[k.name]
        assert (t.field, t.default) == (k.field, k.default), k.name
    assert tconfig.Config().keyspace() == jconfig.Config().keyspace() \
        == "ccdc_0_2_0"


@pytest.mark.parametrize("override", [
    dict(faults="ingest:p=0.1"), dict(object_root="/tmp/obj"),
    dict(compile_cache="/tmp/cc"), dict(store_backend="cassandra")])
def test_driver_refuses_unported_knobs(override):
    cfg = tconfig.Config(**override)
    with pytest.raises(ValueError, match="not ported"):
        tcore.refuse_not_ported(cfg)
    with pytest.raises(ValueError, match="not ported"):
        tcore.changedetection(0, 0, cfg=cfg, device="cpu")


@pytest.fixture(scope="module")
def ops_knob_run(tmp_path_factory):
    """One CPU changedetection run (two chips of the tiny sensor) with the
    ops knobs that used to be refused set; what each knob does is read
    back from the run's artifacts and from what the run bound."""
    import torch
    from conftest import free_port
    from firebird_tpu_torch.obs import server as obs_server

    tmp = tmp_path_factory.mktemp("ops_knobs")
    port = free_port()
    cfg = tconfig.Config(
        store_backend="sqlite", store_path=str(tmp / "fb.db"),
        source_backend="synthetic", synth_sensor="landsat-ard-tiny",
        chips_per_batch=1, ops_port=port, ops_host="127.0.0.1",
        profile=0.05, trace="1", slo="batch_p95=30")
    served = []
    start = obs_server.start_ops_server

    def start_and_probe(p, status=None, host=None):
        srv = start(p, status, host=host)
        served.append((srv.port, _http_status(srv.port, "/healthz")))
        return srv

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(obs_server, "start_ops_server", start_and_probe)
        tcore.changedetection(100, 200, acquired="1995-01-01/1996-06-01",
                              number=2, chunk_size=2, cfg=cfg, device="cpu")
    torch.set_num_threads(n)
    return tmp, port, served, json.load(open(tmp / "obs_report.json"))


def _http_status(port, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.mark.parametrize("knob", ["ops_port", "profile", "trace", "slo"])
def test_driver_honours_ported_ops_knobs(ops_knob_run, knob):
    tmp, port, served, rep = ops_knob_run
    assert knob not in tconfig.NOT_PORTED
    if knob == "ops_port":
        assert served == [(port, 200)]
    elif knob == "profile":
        [w] = rep["profile"]["windows"]
        assert w["seconds"] == 0.05 and "error" not in w
        assert Path(w["trace_file"]).exists()
        assert w["dir"] == str(tmp / "device_profile" / "window_00")
    elif knob == "trace":
        trace = json.load(open(tmp / "trace.json"))
        assert trace["otherData"]["run_id"] == rep["run"]["run_id"]
        assert {"fetch", "dispatch", "drain"} <= {
            e["name"] for e in trace["traceEvents"]}
    else:
        assert rep["slo"]["spec"] == "batch_p95=30"
        assert rep["slo"]["objectives"][0]["value_sec"] is not None


def test_driver_takes_the_default_config():
    tcore.refuse_not_ported(tconfig.Config())
    assert set(tconfig.NOT_PORTED) <= set(tconfig.Config.__dataclass_fields__)


# ---------------------------------------------------------------------------
# grid and utils.fn
# ---------------------------------------------------------------------------

def _recorded(name):
    return json.loads((DATA / f"{name}_response.json").read_text())


def test_grid_equals_jax_on_the_recorded_responses():
    snap, near, tile = (_recorded(n) for n in ("snap", "near", "tile"))
    x, y = snap["chip"]["proj-pt"]
    assert tgrid.snap(x, y) == jgrid.snap(x, y)
    assert tgrid.near(x, y) == jgrid.near(x, y)
    tx, ty = tile["x"], tile["y"]
    t, j = tgrid.tile(tx, ty), jgrid.tile(tx, ty)
    assert {k: v for k, v in t.items() if k != "chips"} == \
        {k: v for k, v in j.items() if k != "chips"}
    np.testing.assert_array_equal(t["chips"], j["chips"])
    assert (t["h"], t["v"]) == (tile["h"], tile["v"])
    assert tgrid.chips(t) == jgrid.chips(j)
    assert tgrid.training(x, y) == jgrid.training(x, y)
    assert tgrid.classification(x, y) == jgrid.classification(x, y)
    bounds = [(-543585.0, 2378805.0), (-393585.0, 2228805.0)]
    assert tgrid.tiles_for_bounds(bounds) == jgrid.tiles_for_bounds(bounds)
    cids = tgrid.chips(t)
    assert list(tfn.partition_all(7, tfn.take(23, cids))) == \
        list(jfn.partition_all(7, jfn.take(23, cids)))


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------

def _retry_trace(mod, fails):
    """The delays and outcome of one RetryPolicy.run over ``fails``
    failures, with a seeded random and a recording sleep."""
    slept = []

    class Log:
        def warning(self, *a):
            pass

    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise IOError(f"blip {calls['n']}")
        return "ok"

    pol = mod.RetryPolicy(4, base=0.5, cap=8.0, sleep=slept.append,
                          rng=random.Random(7),
                          budget=mod.RetryBudget(3))
    try:
        out = pol.run(Log(), "fetch", fn)
    except IOError as e:
        out = f"raised {e}"
    return slept, out, calls["n"], pol.budget.spent


@pytest.mark.parametrize("fails", [0, 2, 4])
def test_retry_policy_sequence_equals_jax(fails):
    assert _retry_trace(tretry, fails) == _retry_trace(jretry, fails)


def test_circuit_breaker_sequence_equals_jax():
    def trace(mod):
        now = [0.0]
        b = mod.CircuitBreaker(2, 10.0, clock=lambda: now[0])
        out = []
        for step in ("f", "f", "try", "t+5", "try", "t+6", "try", "s",
                     "f", "f", "t+11", "try", "f", "try"):
            if step == "f":
                b.record_failure()
            elif step == "s":
                b.record_success()
            elif step.startswith("t+"):
                now[0] += float(step[2:])
            else:
                out.append(b.try_acquire())
            out.append(b.state_name())
        return out, b.snapshot()

    assert trace(tretry) == trace(jretry)


# ---------------------------------------------------------------------------
# quarantine and run manifest
# ---------------------------------------------------------------------------

def _fixed_time(monkeypatch):
    from firebird_tpu.driver import quarantine as jq

    for mod in (jq, tq):
        monkeypatch.setattr(mod, "_now_iso", lambda: "2026-01-02T03:04:05Z")
    return jq


def _fill_quarantine(mod, path):
    q = mod.Quarantine.load(path, run_id="run1")
    q.record((3000, 6000), IOError("chipmunk down"), attempts=4)
    q.record((3000, 6000), IOError("still down"), attempts=4)
    q.record_many([(9000, 0), (12000, 0)], RuntimeError("kernel"),
                  attempts=1, stage="chunk")
    q.discard((12000, 0))
    return q


def test_quarantine_file_is_jaxs_byte_for_byte(tmp_path, monkeypatch):
    jq = _fixed_time(monkeypatch)
    _fill_quarantine(jq, str(tmp_path / "j.json"))
    _fill_quarantine(tq, str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_quarantine_files_cross_between_the_packages(tmp_path, monkeypatch):
    jq = _fixed_time(monkeypatch)
    _fill_quarantine(tq, str(tmp_path / "t.json"))
    _fill_quarantine(jq, str(tmp_path / "j.json"))
    from_port = jq.Quarantine.load(str(tmp_path / "t.json"))
    from_jax = tq.Quarantine.load(str(tmp_path / "j.json"))
    assert from_port.chip_ids() == from_jax.chip_ids() == {(3000, 6000),
                                                          (9000, 0)}
    assert len(from_port) == len(from_jax) == 2


def test_run_manifest_crosses_between_the_packages(tmp_path, monkeypatch):
    jq = _fixed_time(monkeypatch)
    tcfg = tconfig.Config(store_backend="sqlite",
                          store_path=str(tmp_path / "t" / "fb.db"))
    jcfg = jconfig.Config(store_backend="sqlite",
                          store_path=str(tmp_path / "j" / "fb.db"))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tile = {"h": 5, "v": 15}
    tq.write_manifest(tcfg, acquired="1995-01-01/1999-01-01", run_id="r",
                      tile=tile)
    jq.write_manifest(jcfg, acquired="1995-01-01/1999-01-01", run_id="r",
                      tile=tile)
    assert (tmp_path / "t" / "run_manifest.json").read_bytes() == \
        (tmp_path / "j" / "run_manifest.json").read_bytes()
    assert tq.config_fingerprint(tcfg) == jq.config_fingerprint(jcfg)

    class Log:
        def warning(self, *a):
            pass

    # Each package's resume gate reads the other's manifest.
    tq.check_resume(jcfg, acquired="1995-01-01/1999-01-01", log=Log())
    jq.check_resume(tcfg, acquired="1995-01-01/1999-01-01", log=Log())
    with pytest.raises(tq.ResumeMismatch):
        tq.check_resume(jcfg, acquired="1996-01-01/1999-01-01", log=Log())


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

def test_file_source_reads_jax_fetch_directory(tmp_path):
    from firebird_tpu.driver import core as jcore

    src = JSource(seed=2, start="1995-01-01", end="1996-06-01")
    n, attempted = jcore.fetch(
        x=542000, y=1650000, outdir=str(tmp_path), number=2,
        cfg=jconfig.Config(source_backend="synthetic",
                           store_backend="memory"), source=src)
    assert (n, attempted) == (2, 2)
    fs = tsources.FileSource(str(tmp_path))
    for cx, cy in jgrid.chips(jgrid.tile(542000, 1650000))[:2]:
        live = src.chip(cx, cy, "1995-01-01/1996-03-01")
        got = fs.chip(cx, cy, "1995-01-01/1996-03-01")
        np.testing.assert_array_equal(got.spectra, live.spectra)
        np.testing.assert_array_equal(got.qas, live.qas)
        np.testing.assert_array_equal(got.dates, live.dates)


def test_decode_raster_on_the_recorded_chip():
    rec = _recorded("chip")[0]
    got = tsources.decode_raster(rec)
    np.testing.assert_array_equal(got, jsources.decode_raster(rec))
    assert got.dtype == np.int16 and got.shape == (100, 100)
    a = (np.arange(10000, dtype=np.int16) - 5000).reshape(100, 100)
    rec2 = {"data": base64.b64encode(a.astype("<i2").tobytes()).decode()}
    np.testing.assert_array_equal(tsources.decode_raster(rec2), a)
    with pytest.raises(ValueError, match="multiple"):
        tsources.decode_raster({"data": base64.b64encode(b"abc").decode()},
                               dtype=np.int16, side=1)


def _recorded_service():
    """An http_get replaying the recorded responses: /registry, and the
    recorded le07_srb1 raster (all fill) for every spectral ubid of that
    platform, a clear QA raster for its pixelqa ubid."""
    registry = _recorded("registry")
    chip = _recorded("chip")[0]
    qa = np.full((100, 100), 1 << 1, np.uint16)
    qa_b64 = base64.b64encode(qa.astype("<u2").tobytes()).decode()

    def http_get(url):
        u = urlparse(url)
        if u.path.endswith("/registry"):
            return registry
        q = parse_qs(u.query)
        ubid = q["ubid"][0].lower()
        if not ubid.startswith("le07"):
            return []
        rec = dict(chip, ubid=ubid)
        if ubid.endswith("pixelqa"):
            rec["data"] = qa_b64
        return [rec]

    return http_get


def test_chipmunk_source_on_the_recorded_responses_equals_jax():
    get = _recorded_service()
    t = tsources.ChipmunkSource("http://chipmunk/ard", http_get=get)
    j = jsources.ChipmunkSource("http://chipmunk/ard", http_get=get)
    rec = _recorded("chip")[0]
    acq = "2002-01-01/2003-01-01"
    got, want = t.chip(rec["x"], rec["y"], acq), j.chip(rec["x"], rec["y"],
                                                        acq)
    assert got.dates.tolist() == want.dates.tolist()
    assert got.dates.shape[0] == 1
    np.testing.assert_array_equal(got.spectra, want.spectra)
    np.testing.assert_array_equal(got.qas, want.qas)
    assert np.all(got.spectra == -9999)


def test_registry_on_the_recorded_response_equals_jax():
    from firebird_tpu.ingest.registry import Registry as JRegistry

    doc = _recorded("registry")
    t, j = TRegistry(doc), JRegistry(doc)
    assert t.ard_ubids() == j.ard_ubids()
    assert t.aux_ubids() == j.aux_ubids()
    for ubids in t.ard_ubids().values():
        for u in ubids:
            assert t.wire_dtype(u) == j.wire_dtype(u)

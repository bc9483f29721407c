"""The port's black-box canary prober (firebird_tpu_torch/obs/prober.py)
against the JAX package's, on the CPU.

The prober cases of tests/test_slo_budget.py, each run on both packages:
the refused configurations, the webhook sink's first receipt, the SSE
watcher's parse, an unresolved probe timing out as a failure, and the
alert conveyor (its scenes, its archive arrays and manifest lines, equal to
the JAX conveyor's; the port's ``FileSource`` writes an uncompressed npz,
so arrays are compared, not archive bytes).  Two cases against a serve
replica in-process: the serve surface's ``probe_*`` counters and its 304s
equal the JAX prober's against a JAX replica over the same store; and with
the ``serve`` fault scope on, every serve probe is booked as a failure and
the ``probe_errors@99/5m`` budget over the prober's spool burns in both
packages.
"""

import json
import os
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

from firebird_tpu.config import Config as JConfig
from firebird_tpu.ingest.sources import FileSource as JFileSource
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu.obs import prober as jprober
from firebird_tpu.obs import slo as jslo
from firebird_tpu.obs import spool as jspool
from firebird_tpu.serve import api as japi
from firebird_tpu.serve import pyramid as jpyramid
from firebird_tpu.store import open_store as jopen_store
from firebird_tpu_torch import grid
from firebird_tpu_torch.config import Config as TConfig
from firebird_tpu_torch.ingest.sources import FileSource as TFileSource
from firebird_tpu_torch.obs import metrics as tmetrics
from firebird_tpu_torch.obs import prober as tprober
from firebird_tpu_torch.obs import slo as tslo
from firebird_tpu_torch.obs import spool as tspool
from firebird_tpu_torch.serve import api as tapi
from firebird_tpu_torch.serve import pyramid as tpyramid
from firebird_tpu_torch.store import open_store as topen_store

JAX = types.SimpleNamespace(
    name="jax", prober=jprober, Config=JConfig, metrics=jmetrics,
    FileSource=JFileSource, api=japi, open_store=jopen_store, slo=jslo,
    spool=jspool, pyramid=jpyramid)
PORT = types.SimpleNamespace(
    name="torch", prober=tprober, Config=TConfig, metrics=tmetrics,
    FileSource=TFileSource, api=tapi, open_store=topen_store, slo=tslo,
    spool=tspool, pyramid=tpyramid)
PKGS = (JAX, PORT)

PROBE_COUNTERS = ("probe_attempts", "probe_attempts_serve", "probe_failures",
                  "probe_failures_serve", "probe_etag_304",
                  "probe_attempts_alert", "probe_failures_alert")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_metrics():
    jmetrics.reset_registry()
    tmetrics.reset_registry()
    yield
    jmetrics.reset_registry()
    tmetrics.reset_registry()


def test_prober_constants_and_refused_configs(tmp_path):
    for name in ("PROBE_ROLE", "SCENES_TO_CONFIRM", "BOOT_START", "BOOT_END",
                 "CADENCE_DAYS", "PROBE_STEP"):
        assert getattr(tprober, name) == getattr(jprober, name), name
    msgs = []
    for P in PKGS:
        got = []
        for kw, match in ((dict(), "at least one surface"),
                          (dict(landing=str(tmp_path)), "-x/-y")):
            with pytest.raises(ValueError, match=match) as ei:
                P.prober.CanaryProber(P.Config(), **kw)
            got.append(str(ei.value))
        with pytest.raises(ValueError, match="refuses to arm") as ei:
            P.prober.CanaryProber(P.Config(probe_sec=0),
                                  serve_url="http://127.0.0.1:1")
        got.append(str(ei.value))
        p = P.prober.CanaryProber(P.Config(probe_sec=0),
                                  serve_url="http://127.0.0.1:1/",
                                  interval=5.0)
        assert p.interval == 5.0 and p.serve_url == "http://127.0.0.1:1"
        got.append(p.status())
        msgs.append(got)
    assert msgs[1] == msgs[0]


def test_webhook_sink_records_first_receipt():
    rng = np.random.default_rng(3)
    cx, cy = (int(v) for v in rng.integers(1, 10_000, 2))
    seen = []
    for P in PKGS:
        sink = P.prober._WebhookSink()
        try:
            body = json.dumps({"schema": "firebird-alert-webhook/1",
                               "cursor": 3,
                               "alerts": [{"cx": cx, "cy": cy}]}).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{sink.port}/probe", data=body,
                method="POST")
            t0 = time.time()
            code = urllib.request.urlopen(req, timeout=5).status
            t = sink.first_receipt((cx, cy), after=t0 - 1.0)
            assert t is not None and t >= t0 - 1.0
            late = sink.first_receipt((cx, cy), time.time() + 60)
            other = sink.first_receipt((1, 2), 0.0)
            urllib.request.urlopen(req, timeout=5)
            kept = sink.first_receipt((cx, cy), after=0.0) == t
            garbage = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{sink.port}/probe", data=b"not json",
                method="POST"), timeout=5).status
            seen.append((code, late, other, kept, garbage,
                         sorted(sink.received)))
        finally:
            sink.close()
    assert seen[1] == seen[0] == (200, None, None, True, 200, [(cx, cy)])


def test_sse_watcher_parses_alert_events():
    frames = [b": keepalive\n", b"\n",
              b"event: alert\n",
              b'data: {"cx": 100, "cy": 200, "date": 730000}\n',
              b"id: 17\n", b"\n",
              b"event: other\n", b'data: {"cx": 1, "cy": 2}\n', b"\n",
              b"event: alert\n", b"data: not-json\n", b"\n",
              b"event: alert\r\n", b'data: {"cx": 5, "cy": 6}\r\n',
              b"id: x\r\n", b"\r\n"]
    seen = []
    for P in PKGS:
        w = P.prober._SSEWatcher("http://127.0.0.1:1/", timeout=1.0)
        w._consume(iter(frames))
        seen.append((w.serve_url, w.cursor, sorted(w.seen),
                     w.first_seen((100, 200), after=0.0) is not None,
                     w.first_seen((1, 2), after=0.0),
                     w.first_seen((100, 200), after=time.time() + 60)))
    assert seen[1] == seen[0]
    assert seen[1][1] == 17 and seen[1][2] == [(5, 6), (100, 200)]
    assert seen[1][3] is True and seen[1][4] is None


def test_resolve_pending_times_out_as_failure():
    seen = []
    for P in PKGS:
        P.metrics.reset_registry()
        p = P.prober.CanaryProber(P.Config(), serve_url="http://127.0.0.1:1")
        now = time.time()
        p.pending += [{"kind": "alert", "cid": (1, 2),
                       "t_appended": now - 999.0, "deadline": 10.0},
                      {"kind": "webhook", "cid": (1, 2),
                       "t_appended": now - 999.0, "deadline": 10.0},
                      {"kind": "alert", "cid": (3, 4), "t_appended": now,
                       "deadline": 999.0}]
        p._resolve_pending()
        seen.append(([P.metrics.counter(n).value for n in (
            "probe_failures_alert", "probe_attempts_alert",
            "probe_failures_webhook", "probe_attempts", "probe_failures")],
            [q["cid"] for q in p.pending]))
    assert seen[1] == seen[0] == ([1, 1, 1, 2, 2], [(3, 4)])


def test_alert_conveyor_confirms_on_sixth_scene(tmp_path):
    """The staged conveyor in both packages over two probe chips: one
    scene per tick per in-flight chip, the SCENES_TO_CONFIRM-th append is
    the end-to-end attempt, scenes are bbox'd strictly inside their
    chip's cell; both conveyors land the same arrays and the same
    manifest lines (but the publish stamps)."""
    x, y = 542000.0, 1650000.0
    runs = {}
    for P in PKGS:
        land = str(tmp_path / P.name)
        os.makedirs(land)
        c = P.prober._AlertConveyor(land, x, y, chip_offset=3, chips=2)
        cids = list(c.reserve)
        sx, sy = c.span
        for cid in cids:
            x0, y0, x1, y1 = c._bbox(cid)
            assert cid[0] < x0 < x1 < cid[0] + sx
            assert cid[1] - sy < y0 < y1 < cid[1]
        confirmed, ticks = [], 0
        while not c.exhausted():
            confirmed += c.tick()
            ticks += 1
        assert c.tick() == []
        scenes = P.FileSource(land).list_acquisitions()
        chips = {}
        for cid in cids:
            ch = P.FileSource(land).chip(*cid, "1990-01-01/2000-01-01")
            chips[cid] = (np.asarray(ch.dates), np.asarray(ch.spectra),
                          np.asarray(ch.qas))
        runs[P.name] = (cids, [(a["cid"], a["scene_id"]) for a in confirmed],
                        ticks, [{k: v for k, v in s.items()
                                 if k != "published"} for s in scenes],
                        chips)
    j, t = runs["jax"], runs["torch"]
    assert t[:4] == j[:4]
    cids, confirmed, ticks, scenes, chips = t
    assert cids == [tuple(int(v) for v in c)
                    for c in grid.chips(grid.tile(x=x, y=y))[3:5]]
    assert [a for a, _ in confirmed] == cids and ticks == 7
    assert confirmed[0][1] == f"PROBE_{cids[0][0]}_{cids[0][1]}_5"
    assert len(scenes) == 2 * tprober.SCENES_TO_CONFIRM
    assert all(s.get("bbox") for s in scenes)
    for cid in cids:
        for a, b in zip(chips[cid], j[4][cid]):
            np.testing.assert_array_equal(a, b)
    d, spectra, _ = chips[cids[0]]
    step = d >= d[-tprober.SCENES_TO_CONFIRM]
    assert spectra.dtype == np.int16 and step.sum() == 6
    assert (spectra[:, step].astype(float).mean()
            - spectra[:, ~step].astype(float).mean()) > 700


# ---------------------------------------------------------------------------
# The serve surface against a replica in-process
# ---------------------------------------------------------------------------

CX, CY = (int(v) for v in grid.snap(100, 200)["chip"]["proj-pt"])
DATE = "1998-01-01"


def _segments(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return {"cx": [CX] * n, "cy": [CY] * n,
            "px": [CX + 30 * i for i in range(n)], "py": [CY - 30] * n,
            "sday": ["1995-01-01"] * n, "eday": ["1999-01-01"] * n,
            "bday": ["1997-06-01"] * n, "chprob": [1.0] * n,
            "curqa": [int(v) for v in rng.integers(1, 16, n)],
            "rfrawp": [None] * n}


def _probe_replica(P, tmp, faults=None, cycles=4, arm=False):
    """``cycles`` serve-only probe cycles of P's prober against P's
    replica over a sqlite store holding one chip's segment rows and a
    pyramid whose root tile (the one the prober GETs) is persisted; the
    prober's probe_* counters."""
    path = str(tmp / P.name / "fb.db")
    cfg = P.Config(store_backend="sqlite", store_path=path,
                   serve_deadline_sec=5.0, faults=faults,
                   telemetry_dir=str(tmp / P.name / "telemetry"))
    store = P.open_store("sqlite", path, cfg.keyspace())
    store.write("segment", _segments())
    pyr = P.pyramid.TilePyramid(str(tmp / P.name / "pyramid"))
    pyr._persist("ccd", DATE, 0, 0, 0, np.full(
        (100, 100), P.pyramid.FILL_VALUE, np.int32))
    svc = P.api.ServeService(store, cfg, pyramid=pyr)
    srv = P.api.start_serve_server(0, svc, host="127.0.0.1")
    p = P.prober.CanaryProber(
        cfg, serve_url=f"http://127.0.0.1:{srv.port}", x=CX + 31.0,
        y=CY - 31.0, pixel_date=DATE, interval=0.05, timeout=5.0)
    try:
        if arm:
            p.arm()
        p.run(cycles=cycles)
    finally:
        if arm:
            p.close()
        srv.close()
        store.close()
    return ({n: P.metrics.counter(n).value for n in PROBE_COUNTERS},
            P.metrics.histogram("probe_serve_seconds").snapshot()["count"],
            p.status())


def test_serve_probes_equal_jax_prober(tmp_path):
    got = []
    for P in PKGS:
        P.metrics.reset_registry()
        counters, n_lat, status = _probe_replica(P, tmp_path)
        status.pop("serve_url")
        got.append((counters, n_lat, status))
    assert got[1] == got[0]
    counters, n_lat, _ = got[1]
    # Each cycle GETs the pixel (no ETag) and the root pyramid tile, which
    # revalidates with its ETag from the second cycle on (a 304).
    assert counters["probe_attempts_serve"] == counters["probe_attempts"] == 8
    assert counters["probe_failures"] == 0 and n_lat == 8
    assert counters["probe_etag_304"] == 3


def test_serve_fault_burns_probe_budget(tmp_path, monkeypatch, capsys):
    """``serve:p=1`` answers every /v1 GET 503: every serve probe is a
    failure, and the ``probe_errors@99/5m`` budget over each prober's
    spool burns in both packages."""
    from click.testing import CliRunner

    from firebird_tpu import cli
    from firebird_tpu_torch import __main__ as tmain

    got = []
    for P in PKGS:
        P.metrics.reset_registry()
        counters, n_lat, _ = _probe_replica(P, tmp_path, faults="serve:p=1",
                                            cycles=6, arm=True)
        got.append((counters, n_lat))
        assert P.spool.active() is None
    assert got[1] == got[0]
    counters, n_lat = got[1]
    assert counters["probe_failures"] == counters["probe_attempts"] == 12
    assert counters["probe_failures_serve"] == 12 and n_lat == 0
    args = ["--no-record", "-b", "probe_errors@99/5m", "--fast", "45",
            "--slow", "90"]
    verdicts = []
    for P in PKGS:
        home = str(tmp_path / P.name / "telemetry")
        assert any(f.startswith("spool.prober.") for f in os.listdir(home))
        env = {"FIREBIRD_TELEMETRY_DIR": home,
               "FIREBIRD_SERIES_DIR": os.path.join(home, "series")}
        if P is JAX:
            res = CliRunner().invoke(cli.entrypoint, ["slo"] + args, env=env)
            code, out = res.exit_code, res.output
        else:
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            capsys.readouterr()
            try:
                tmain.main(["slo"] + args)
                code = 0
            except SystemExit as e:
                code = e.code
            out = capsys.readouterr().out
        (b,) = json.loads(out)["budgets"]
        verdicts.append((code, b["name"], b["ok"], b["burning"],
                         b["exhausted"], b["bad"], b["total"]))
    assert verdicts[1] == verdicts[0]
    code, name, ok, burning, exhausted, bad, total = verdicts[1]
    assert code == 1 and name == "probe_errors" and ok is False
    assert burning or exhausted
    assert bad == total > 0

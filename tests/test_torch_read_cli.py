"""The port's read-side commands (``python -m firebird_tpu_torch`` products,
tiles, status, top) against the JAX package's (``firebird`` products,
tiles, status, top), on the CPU.

``tiles`` and ``products`` must print the same bytes.  ``status`` and
``top`` read one telemetry home (a store with segment rows, a quarantined
chip, a fleet queue with a lease, an alert log with a subscriber, worker
spools with recent snapshots): their documents must carry the same keys,
section for section, and the same values where the values do not depend
on the clock.  JAX's ``status`` and ``top`` import ``firebird_tpu.driver``
and so JAX, so they run in a subprocess.  The host-only commands must not
touch CUDA."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch
from click.testing import CliRunner

from firebird_tpu import cli
from firebird_tpu_torch import __main__ as tmain
from firebird_tpu_torch import grid
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.store import open_store

from test_torch_series import _snap, _write_spool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINT = (542000.0, 1650000.0)
BOUNDS = ["-b", "-543585,2378805", "-b", "-393585,2228805"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(argv, monkeypatch=None, env=None, capsys=None):
    """(exit code, stdout) of the port's command line, in this process."""
    if env:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
    try:
        tmain.main(argv)
        code = 0
    except SystemExit as e:
        code = e.code
    return code, capsys.readouterr().out


def _jax_env(env):
    """The environment of a JAX subprocess: the repo importable from any
    working directory, JAX on the CPU."""
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH"))
                           if p)
    return dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu",
                FIREBIRD_JAX_PLATFORM="cpu", **env)


def _jax(argv, env):
    """(exit code, stdout) of JAX's command line in a subprocess (its
    status and top import JAX through firebird_tpu.driver)."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys; from firebird_tpu import cli; "
         "cli.entrypoint.main(args=sys.argv[1:], prog_name='firebird')"]
        + argv, env=_jax_env(env),
        capture_output=True, text=True, timeout=300)
    return r.returncode, r.stdout


# ---------------------------------------------------------------------------
# tiles and products: the same bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["products"],
    ["tiles"] + BOUNDS,
    ["tiles", "-b", "542000,1650000"],
    ["tiles"] + BOUNDS + ["-s", "0/3"],
    ["tiles"] + BOUNDS + ["-s", "2/3"],
    ["tiles"] + BOUNDS + ["--shard", "0/1"]])
def test_output_is_jaxs_byte_for_byte(argv, capsys):
    code, out = _port(argv, capsys=capsys)
    res = CliRunner().invoke(cli.entrypoint, argv, catch_exceptions=False)
    assert code == res.exit_code == 0
    assert out == res.output and out


@pytest.mark.parametrize("shard", ["3/2", "-1/2", "x", "1/0", "1/2/3"])
def test_tiles_refuses_a_bad_shard_as_jax(shard, capsys):
    code, out = _port(["tiles"] + BOUNDS + ["-s", shard], capsys=capsys)
    res = CliRunner().invoke(cli.entrypoint, ["tiles"] + BOUNDS
                             + ["-s", shard])
    assert code == res.exit_code == 2
    assert out == ""
    assert "shard must be i/n with 0 <= i < n" in res.output


def test_tiles_shards_partition_the_rows(capsys):
    _, whole = _port(["tiles"] + BOUNDS, capsys=capsys)
    rows = whole.strip().splitlines()
    assert rows[0] == "h,v,ulx,uly,lrx,lry" and len(rows) == 5
    sharded = []
    for i in range(3):
        sharded += _port(["tiles"] + BOUNDS + ["-s", f"{i}/3"],
                         capsys=capsys)[1].strip().splitlines()[1:]
    assert sorted(sharded) == sorted(rows[1:])
    h, v, ulx, uly, lrx, lry = rows[1].split(",")
    t = grid.tile((float(ulx) + float(lrx)) / 2, (float(uly) + float(lry)) / 2)
    assert (t["h"], t["v"]) == (int(h), int(v))


# ---------------------------------------------------------------------------
# status and top over one telemetry home
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """A store with segment rows for two chips, one quarantined chip, a
    fleet queue (two detect jobs, one leased), an alert log with two
    alerts and a subscriber, and two worker spools with recent
    snapshots."""
    from firebird_tpu.alerts.log import AlertLog as JAlertLog
    from firebird_tpu_torch.alerts import AlertLog, alert_db_path
    from firebird_tpu_torch.driver.quarantine import (Quarantine,
                                                      quarantine_path)
    from firebird_tpu_torch.fleet import make_queue
    from firebird_tpu_torch.store import SqliteStore

    root = tmp_path_factory.mktemp("home")
    env = {"FIREBIRD_STORE_BACKEND": "sqlite",
           "FIREBIRD_STORE_PATH": str(root / "fb.db")}
    cfg = Config(store_backend="sqlite", store_path=env[
        "FIREBIRD_STORE_PATH"])
    store = SqliteStore(cfg.store_path, cfg.keyspace())
    chips = grid.chips(grid.tile(*POINT))[:3]
    for cx, cy in chips[:2]:
        store.write("segment", {
            "cx": [cx], "cy": [cy], "px": [cx], "py": [cy],
            "sday": ["2000-01-01"], "eday": ["2005-01-01"],
            "bday": ["2005-01-01"], "chprob": [1.0], "curqa": [8]})
    store.close()
    Quarantine(quarantine_path(cfg)).record(chips[2], TimeoutError("slow"),
                                            attempts=3)
    q = make_queue(cfg)
    for c in chips[:2]:
        q.enqueue("detect", {"x": POINT[0], "y": POINT[1], "chips": [c]})
    assert q.claim("w-1") is not None
    q.close()
    al = AlertLog(alert_db_path(cfg))
    al.append([{"cx": chips[0][0], "cy": chips[0][1], "px": chips[0][0],
                "py": chips[0][1], "break_day": 730000 + i}
               for i in range(2)])
    al.close()
    jal = JAlertLog(alert_db_path(cfg))
    jal.subscribe("http://127.0.0.1:9/hook", cursor=1)
    jal.close()
    now = time.time()
    for pid in (41, 42):
        reg, snaps = obs_metrics.MetricsRegistry(), []
        for i in range(10):
            reg.counter("fleet_jobs_acked").inc(i % 3)
            reg.histogram("fleet_job_seconds_detect").observe(0.5 * pid + i)
            snaps.append(dict(_snap(now - 200 + 20 * i, pid=pid),
                              metrics=reg.snapshot()))
        _write_spool(str(root / "telemetry"), "worker", pid, snaps)
    return root, env


def same_keys(a, b, path="$"):
    """Dicts with the same keys at every level (lists of dicts element for
    element)."""
    assert type(a) is type(b), (path, a, b)
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            same_keys(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list) and a and isinstance(a[0], dict):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_keys(x, y, f"{path}[{i}]")


def test_status_answers_as_jax(home, monkeypatch, capsys):
    root, env = home
    argv = ["status", "-x", str(POINT[0]), "-y", str(POINT[1])]
    code, out = _port(argv, monkeypatch, env, capsys)
    jcode, jout = _jax(argv, env)
    assert code == jcode == 0, jout
    mine, theirs = json.loads(out), json.loads(jout)
    same_keys(mine, theirs)
    assert list(mine) == list(theirs)
    for k in ("backend", "path", "keyspace", "tables", "chips_with_segments",
              "quarantine", "alerts", "streamops", "budgets", "tile"):
        assert mine[k] == theirs[k], k
    for k in ("path", "jobs", "by_type", "blocked", "dead", "dead_errors",
              "fence_rejects"):
        assert mine["fleet"][k] == theirs["fleet"][k], k
    assert mine["tables"]["segment"] == 2 and mine["quarantine"]["chips"] == 1
    assert mine["tile"]["chips_done"] == 2
    assert mine["alerts"]["depth"] == 2
    assert mine["fleet"]["jobs"]["leased"] == 1
    assert set(mine["budgets"]["budgets"]) == {
        "alert_freshness", "serve_p99", "probe_errors", "fanout_p99"}


def test_status_refuses_one_coordinate_as_jax(home, monkeypatch, capsys):
    root, env = home
    code, out = _port(["status", "-x", "1"], monkeypatch, env, capsys)
    res = CliRunner().invoke(cli.entrypoint, ["status", "-x", "1"], env=env)
    assert code == res.exit_code == 2 and out == ""


def test_status_memory_backend_as_jax(tmp_path, monkeypatch, capsys):
    """No home: no quarantine path, no fleet, alert or budget section."""
    env = {"FIREBIRD_STORE_BACKEND": "memory"}
    monkeypatch.chdir(tmp_path)
    code, out = _port(["status"], monkeypatch, env, capsys)
    jcode, jout = _jax(["status"], env)
    assert code == jcode == 0
    mine, theirs = json.loads(out), json.loads(jout)
    same_keys(mine, theirs)
    assert mine == theirs
    assert mine["quarantine"] == {"path": None, "chips": 0, "errors": {}}
    assert "budgets" not in mine and "fleet" not in mine


def test_status_names_the_views_it_does_not_port(tmp_path, monkeypatch,
                                                 capsys):
    """The serving view (a changefeed db with two replicas' checkpoints
    and a pyramid directory, written through the JAX package's serving
    layer) reads as JAX's status reads it, key for key; the clock-free
    values are equal."""
    from firebird_tpu.serve import changefeed as jcf
    from firebird_tpu.serve import pyramid as jpyr
    from firebird_tpu.store import open_store as jopen_store

    env = {"FIREBIRD_STORE_BACKEND": "sqlite",
           "FIREBIRD_STORE_PATH": str(tmp_path / "fb.db"),
           "FIREBIRD_CHANGEFEED_DB": str(tmp_path / "changefeed.db")}
    cx, cy = (int(v) for v in grid.snap(100, 200)["chip"]["proj-pt"])
    feed = jcf.ProductWrites(env["FIREBIRD_CHANGEFEED_DB"])
    feed.append("product", [(cx, cy), (cx + 3000, cy)])
    feed.checkpoint("replica-a", alert_cursor=0, writes_cursor=2,
                    lag_sec=0.5)
    feed.checkpoint("replica-b", alert_cursor=0, writes_cursor=1)
    feed.close()
    store = jopen_store("memory", "", "t")
    store.write("segment", {
        "cx": [cx], "cy": [cy], "px": [cx], "py": [cy - 30],
        "sday": ["1995-01-01"], "eday": ["1999-01-01"],
        "bday": ["1997-06-01"], "chprob": [1.0], "curqa": [8],
        "rfrawp": [None]})
    pyr = jpyr.TilePyramid(str(tmp_path / "pyramid"),
                           jpyr.store_read_chip(store))
    pyr.build_area(["curveqa"], ["1996-01-01"], [(cx + 1.0, cy - 1.0)],
                   levels=2)
    pyr.invalidate_chip(cx, cy)
    code, out = _port(["status"], monkeypatch, env, capsys)
    jcode, jout = _jax(["status"], env)
    assert code == jcode == 0, jout
    mine, theirs = json.loads(out), json.loads(jout)
    same_keys(mine, theirs)
    assert list(mine) == list(theirs)
    serving, jserving = mine["serving"], theirs["serving"]
    assert serving["pyramid"] == jserving["pyramid"]
    assert serving["pyramid"]["tiles_by_level"] == {
        "10": {"tiles": 1, "stale": 1}, "11": {"tiles": 4, "stale": 1}}
    cf, jcf_ = serving["changefeed"], jserving["changefeed"]
    assert cf["replicas_seen"] == jcf_["replicas_seen"] == 2
    assert cf["latest_cursor"] == jcf_["latest_cursor"] == 2
    for r, jr in zip(cf["replicas"], jcf_["replicas"]):
        assert {k: v for k, v in r.items() if k != "updated_age_sec"} == \
            {k: v for k, v in jr.items() if k != "updated_age_sec"}
    assert [r["writes_behind"] for r in cf["replicas"]] == [0, 1]
    assert "watcher" not in mine["streamops"] and "object" not in mine


@pytest.mark.parametrize("view", ["watcher", "object"])
def test_status_shows_the_watcher_and_object_views_as_jax(
        tmp_path, monkeypatch, capsys, view):
    """The acquisition watcher's cursor (a ``watcher.db`` next to the
    store, written by the JAX package's SceneCursor) and the object
    root's census (objects both packages wrote, one orphaned upload)
    read as JAX's status reads them, section for section."""
    from firebird_tpu.store.objectstore import LocalObjectStore
    from firebird_tpu.streamops.watcher import SceneCursor as JCursor
    from firebird_tpu_torch.store import objectstore as tobj

    env = {"FIREBIRD_STORE_BACKEND": "sqlite",
           "FIREBIRD_STORE_PATH": str(tmp_path / "fb.db")}
    if view == "watcher":
        cur = JCursor(str(tmp_path / "watcher.db"))
        for i, date in enumerate(("2016-01-01", "2016-01-17")):
            cur.record({"scene_id": f"S{i}", "published": 100.0 + i,
                        "date": date, "bbox": [0, 0, 3000, 3000]},
                       chips=2, jobs=2 * (1 - i))
        cur.close()
    else:
        env["FIREBIRD_OBJECT_ROOT"] = str(tmp_path / "objects")
        LocalObjectStore(env["FIREBIRD_OBJECT_ROOT"], 32).put(
            "a/b", bytes(range(100)))
        o = tobj.LocalObjectStore(env["FIREBIRD_OBJECT_ROOT"], 32)
        o.put("a/c", b"c" * 70)
        o.put("a/d", bytes(range(100, 160)), _torn="manifest")
    code, out = _port(["status"], monkeypatch, env, capsys)
    jcode, jout = _jax(["status"], env)
    assert code == jcode == 0, jout
    mine, theirs = json.loads(out), json.loads(jout)
    same_keys(mine, theirs)
    assert list(mine) == list(theirs)
    if view == "watcher":
        assert mine["streamops"] == theirs["streamops"]
        w = mine["streamops"]["watcher"]
        assert w["scenes"] == 2 and w["jobs"] == 2 and w["cursor"] == 101.0
        assert w["last_scene"]["scene_id"] == "S1"
        assert "object" not in mine
    else:
        assert mine["object"] == theirs["object"]
        assert mine["object"]["keys"] == 2
        assert mine["object"]["orphan_chunks"] == 2
        assert "error" not in mine["object"]


_JAX_FRAME = ("import json; from firebird_tpu import cli; "
              "from firebird_tpu.config import Config; "
              "print(json.dumps(cli._top_frame(Config.from_env())))")


def test_top_frame_answers_as_jax(home, monkeypatch):
    root, env = home
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mine = json.loads(json.dumps(tmain._top_frame(Config.from_env())))
    r = subprocess.run([sys.executable, "-c", _JAX_FRAME],
                       env=_jax_env(env),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    theirs = json.loads(r.stdout)
    same_keys(mine, theirs)
    assert mine["fleet"]["jobs"] == theirs["fleet"]["jobs"]
    assert mine["alerts"] == theirs["alerts"]
    assert mine["telemetry"] == theirs["telemetry"]
    assert mine["series"] == theirs["series"]
    assert sorted(mine["telemetry"]["snapshots"]) == ["worker:41",
                                                      "worker:42"]
    assert mine["series"]["res_sec"] == 10
    assert set(mine["series"]["sparklines"]) == {"fleet_jobs_acked",
                                                 "fleet_job_seconds_detect"}


def test_top_renders_as_jax(home, monkeypatch, capsys):
    root, env = home
    code, out = _port(["top", "-n", "1"], monkeypatch, env, capsys)
    jcode, jout = _jax(["top", "-n", "1"], env)
    assert code == jcode == 0
    mine, theirs = out.splitlines(), jout.splitlines()
    assert len(mine) == len(theirs)
    assert mine[0].startswith("firebird top — ")
    for a, b in zip(mine[1:], theirs[1:]):
        if " snap " in a:          # the snapshot's age on the reader's clock
            a, b = a.split(" snap ")[0], b.split(" snap ")[0]
        assert a == b
    assert any(ln.startswith("history (10s buckets") for ln in mine)
    assert "fleet: pending=1 leased=1 done=0 dead=0" in mine[1]


def test_top_with_nothing_to_show(tmp_path, monkeypatch, capsys):
    env = {"FIREBIRD_STORE_BACKEND": "memory",
           "FIREBIRD_FLEET_DB": str(tmp_path / "q.db")}
    lines = tmain._render_top({})
    assert lines[1:] == ["(no fleet, alert, or telemetry state found)"]
    code, out = _port(["top", "-n", "1"], monkeypatch, env, capsys)
    assert code == 0 and "fleet: pending=0" in out


def test_sparkline_rendering():
    assert tmain._SPARK_GLYPHS == cli._SPARK_GLYPHS
    for vals in ([], [0.0, 0.0], [0.0, 4.0, 8.0], list(range(30)),
                 [3.0, 1.0, 2.0, 0.5]):
        assert tmain._sparkline(vals) == cli._sparkline(vals)
    s = tmain._sparkline([0.0, 4.0, 8.0])
    assert s[0] == tmain._SPARK_GLYPHS[0] and s[-1] == tmain._SPARK_GLYPHS[-1]


# ---------------------------------------------------------------------------
# Host only: no CUDA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["status", "-x", str(POINT[0]), "-y", str(POINT[1])],
    ["top", "-n", "1"],
    ["slo", "--no-record"],
    ["slo"],
    ["tiles"] + BOUNDS,
    ["products"]])
def test_read_commands_never_touch_cuda(home, argv, monkeypatch, capsys):
    """Every torch.cuda entry the read-side commands could reach is
    replaced by a recorder: none is reached."""
    root, env = home
    touched = []
    for name in ("is_available", "device_count", "init", "_lazy_init",
                 "current_device", "get_device_name", "mem_get_info",
                 "max_memory_allocated", "synchronize", "set_device",
                 "empty_cache", "get_device_properties"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **k: touched.append(_n))
    code, out = _port(argv, monkeypatch, env, capsys)
    assert code in (0, 1) and out
    assert touched == []
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("argv", [
    ["status", "-x", str(POINT[0]), "-y", str(POINT[1])],
    ["top", "-n", "1"],
    ["slo", "--no-record"],
    ["tiles", "-b", "542000,1650000"],
    ["fetch", "-x", str(POINT[0]), "-y", str(POINT[1]), "-n", "1", "-a",
     "1995-01-01/1995-06-01", "-o", "{tmp}/archive"],
    ["watch", "-x", str(POINT[0]), "-y", str(POINT[1]), "-n", "1",
     "--once"],
    ["objectstore", "scrub", "--dry-run"],
    ["objectstore", "census"],
    ["export", "-b", "542000,1650000", "-p", "curveqa", "-d", "2000-06-01",
     "-o", "{tmp}/rasters", "-f", "envi"],
    ["pyramid", "build", "-b", "542000,1650000", "-p", "curveqa", "-p",
     "seglength", "-d", "2000-06-01", "-l", "2"],
    ["serve", "--port", "0", "--host", "127.0.0.1"],
    ["probe", "--serve-url", "http://127.0.0.1:9", "--landing", "{tmp}",
     "-x", str(POINT[0]), "-y", str(POINT[1]), "--chip-offset", "0",
     "--chips", "1", "-n", "1", "--timeout", "2"]])
def test_read_commands_start_without_torch(home, argv, tmp_path):
    """The host-only commands load neither torch nor the detector: a
    console an operator polls costs a python start-up, not a CUDA
    library load.  ``fetch``, ``watch --once``, the ``objectstore``
    commands and the serving commands run in a home of their own (a
    synthetic source, an object root, a store with one chip's segment
    rows) and must exit 0; the sources and the product math read the
    detector's parameters, whose chi2 thresholds come from scipy, so
    those may load scipy.  ``serve`` (with its alert feed, webhook
    deliverer and fanout coordinator over the alert log next to the
    store) is started, asked for a cold product raster (computed on the
    host and persisted) and stopped with SIGTERM.  ``probe`` runs one
    cycle against a dead serve URL and lands one synthetic probe scene in
    the home's landing zone."""
    root, env = home
    own = argv[0] in ("fetch", "watch", "objectstore", "export", "pyramid",
                      "serve", "probe")
    heavy = ("torch", "firebird_tpu_torch.ccd.kernel") if own \
        else ("torch", "scipy", "firebird_tpu_torch.ccd.kernel")
    if own:
        env = {"FIREBIRD_STORE_BACKEND": "sqlite",
               "FIREBIRD_STORE_PATH": str(tmp_path / "fb.db"),
               "FIREBIRD_SOURCE": "synthetic",
               "FIREBIRD_OBJECT_ROOT": str(tmp_path / "objects")}
        argv = [a.format(tmp=tmp_path) for a in argv]
        cx, cy = grid.chips(grid.tile(*POINT))[0]
        store = open_store("sqlite", env["FIREBIRD_STORE_PATH"],
                           Config().keyspace())
        store.write("segment", {
            "cx": [cx], "cy": [cy], "px": [cx], "py": [cy],
            "sday": ["2000-01-01"], "eday": ["2005-01-01"],
            "bday": ["2005-01-01"], "chprob": [1.0], "curqa": [8]})
        store.close()
    cmd = [sys.executable, "-c",
           "import sys; from firebird_tpu_torch import __main__ as m; "
           "m.main(sys.argv[1:]); "
           f"print('loaded', sorted(n for n in {heavy!r} "
           "if n in sys.modules))"] + argv
    penv = dict(_jax_env(env), PYTHONPATH=ROOT)
    if argv[0] != "serve":
        r = subprocess.run(cmd, env=penv, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode in ((0,) if own else (0, 1)), r.stderr[-2000:]
        assert r.stdout.strip().splitlines()[-1] == "loaded []"
        return
    import signal
    import urllib.request

    proc = subprocess.Popen(cmd, env=penv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert " on port " in line, proc.stderr.read()[-2000:]
        port = int(line.split(" on port ")[1].split()[0])
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/v1/product/seglength?cx={cx}"
                f"&cy={cy}&date=2003-01-01", timeout=60) as r:
            assert r.status == 200 and sum(json.loads(r.read())["cells"])
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-2000:]
    assert out.strip().splitlines()[-1] == "loaded []"

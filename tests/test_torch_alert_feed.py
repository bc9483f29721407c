"""The port's alert feed (firebird_tpu_torch/alerts/feed.py and the
``/v1/alerts*`` endpoints of serve/api.py) against the JAX package's, on
the CPU.

The consumer-side cases of tests/test_alerts.py, each run on both packages
over the same alert db (records made from a seed with numpy, appended
once, the file copied for each package so the ``detected_at`` stamps are
the same bytes): the subscriber registry, ``status``, the webhook
deliverer's durable cursor and its failure hold, the pull endpoint, the
404 without a log, webhook registration and the SSE stream.  Status codes,
JSON bodies, SSE event payloads and ids, and the cursors after delivery
must be equal.  Wall-clock fields (``created``, ``last_ok``, the
``detected_at`` of a record appended live) are left out of a comparison by
name.  Two crossing cases: subscribers the JAX package registered are
delivered by the port's deliverers, and the port's registrations and
cursors are read by the JAX package's ``subscribers()`` and ``status()``.
"""

import json
import os
import shutil
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from firebird_tpu.alerts import fanout as jfanout
from firebird_tpu.alerts import feed as jfeed
from firebird_tpu.alerts import log as jlog
from firebird_tpu.config import Config as JConfig
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu.serve import api as japi
from firebird_tpu.serve import pyramid as jpyr
from firebird_tpu.store import open_store as jopen_store
from firebird_tpu.utils import dates as jdt
from firebird_tpu_torch.alerts import fanout as tfanout
from firebird_tpu_torch.alerts import feed as tfeed
from firebird_tpu_torch.alerts import log as tlog
from firebird_tpu_torch.config import Config as TConfig
from firebird_tpu_torch.obs import metrics as tmetrics
from firebird_tpu_torch.serve import api as tapi
from firebird_tpu_torch.store import open_store as topen_store

JAX = types.SimpleNamespace(
    name="jax", log=jlog, feed=jfeed, fanout=jfanout, Config=JConfig,
    api=japi, open_store=jopen_store, metrics=jmetrics)
PORT = types.SimpleNamespace(
    name="torch", log=tlog, feed=tfeed, fanout=tfanout, Config=TConfig,
    api=tapi, open_store=topen_store, metrics=tmetrics)
PKGS = (JAX, PORT)

# Subscriber and record fields stamped from the wall clock.
WALL = ("created", "last_ok", "detected_at")


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


def _recs(n, seed, day0=728000, step=16, **kw):
    """``n`` alert records of one chip, pixel offsets drawn from ``seed``
    with numpy, distinct break days ``day0 + step*i``."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 100, n)
    py = rng.integers(0, 100, n)
    return [dict({"cx": 100, "cy": 200, "px": 100 + int(px[i]),
                  "py": 200 - int(py[i]), "break_day": float(day0 + step * i)},
                 **kw) for i in range(n)]


def _strip(x):
    """``x`` with the wall-clock fields left out, at any depth."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in WALL}
    if isinstance(x, (list, tuple)):
        return type(x)(_strip(v) for v in x)
    return x


def _twin_dbs(tmp_path, recs, run_id="t"):
    """One alert db holding ``recs``, copied for each package: the
    package name -> its db path."""
    src = str(tmp_path / "src" / "alerts.db")
    al = jlog.AlertLog(src)
    al.append(recs, run_id=run_id)
    al._con.execute("PRAGMA wal_checkpoint(TRUNCATE)")
    al.close()
    out = {}
    for P in PKGS:
        d = tmp_path / P.name
        d.mkdir()
        shutil.copy(src, d / "alerts.db")
        out[P.name] = str(d / "alerts.db")
    return out


def both(scenario, dbs=None):
    """``scenario(P, db)`` on the JAX package, then the port; the two
    results."""
    out = []
    for P in PKGS:
        jmetrics.reset_registry()
        tmetrics.reset_registry()
        out.append(scenario(P, None if dbs is None else dbs[P.name]))
    return out


# ---------------------------------------------------------------------------
# the registry and status
# ---------------------------------------------------------------------------

def test_subscribers_idempotent_and_monotonic(tmp_path):
    dbs = _twin_dbs(tmp_path, [])

    def run(P, db):
        al = P.log.AlertLog(db)
        try:
            out = []
            sid = al.subscribe("http://h/hook")
            out.append(("sid", sid, al.subscribe("http://h/hook")))
            al.append(_recs(2, seed=1, day0=1000))
            out.append(("lag", al.subscribers()[0]["lag"]))
            al.advance(sid, 2)
            out.append(("advanced", _strip(al.subscribers())))
            al.advance(sid, 1)                    # rewind rejected
            out.append(("rewind", al.subscribers()[0]["cursor"]))
            with pytest.raises(ValueError) as ei:
                al.subscribe("not-a-url")
            out.append(("refused", str(ei.value)))
            return out
        finally:
            al.close()

    j, t = both(run, dbs)
    assert t == j
    assert t[0] == ("sid", 1, 1) and t[1] == ("lag", 2)
    assert t[2][1][0]["cursor"] == 2 and t[2][1][0]["lag"] == 0
    assert t[3] == ("rewind", 2)


def test_status_and_parse_bbox(tmp_path):
    dbs = _twin_dbs(tmp_path, _recs(1, seed=2, day0=1000))

    def run(P, db):
        al = P.log.AlertLog(db)
        try:
            al.subscribe("http://h/hook")
            s = al.status()
            s.pop("path")
            bad = []
            for raw in ("1,2,3", "a,b,c,d", ""):
                with pytest.raises(ValueError) as ei:
                    P.feed.parse_bbox(raw)
                bad.append(str(ei.value))
            return _strip(s), P.feed.parse_bbox("1,2,3.5,4"), bad
        finally:
            al.close()

    j, t = both(run, dbs)
    assert t == j
    s, box, _ = t
    assert s["depth"] == 1 and s["latest_cursor"] == 1
    assert s["subscribers"][0]["lag"] == 1
    assert box == (1.0, 2.0, 3.5, 4.0)


# ---------------------------------------------------------------------------
# webhook delivery: durable cursor, retries, catch-up
# ---------------------------------------------------------------------------

def test_webhook_delivery_cursor_catchup(tmp_path):
    dbs = _twin_dbs(tmp_path, _recs(10, seed=3, day0=1000, step=1))

    def run(P, db):
        cfg = P.Config(store_backend="memory")
        al = P.log.AlertLog(db)
        got = []

        def post(url, body, timeout):
            got.append(json.loads(body))
            return 200

        try:
            sid = al.subscribe("http://h/hook")
            d1 = P.feed.WebhookDeliverer(al, cfg, post=post,
                                         sleep=lambda s: None)
            n1 = d1.deliver_once(batch=4, max_batches=1)   # partial, "dies"
            c1 = al.subscribers()[0]["cursor"]
            d2 = P.feed.WebhookDeliverer(al, cfg, post=post,
                                         sleep=lambda s: None)
            n2 = d2.deliver_once(batch=4)
            lag = al.subscribers()[0]["lag"]
            al.append([{"cx": 100, "cy": 200, "px": 199, "py": 101,
                        "break_day": 2000.0}])
            n3 = d2.deliver_once()
            return (sid, n1, c1, n2, lag, n3, _strip(got),
                    _strip(al.subscribers()))
        finally:
            al.close()

    j, t = both(run, dbs)
    assert t == j
    sid, n1, c1, n2, lag, n3, got, subs = t
    assert (sid, n1, c1, n2, lag, n3) == (1, 4, 4, 6, 0, 1)
    ids = [a["id"] for doc in got for a in doc["alerts"]]
    assert ids == list(range(1, 12))                 # exactly once
    assert got[-1]["alerts"][0]["px"] == 199
    assert subs[0]["cursor"] == 11


def test_webhook_failure_holds_cursor(tmp_path):
    dbs = _twin_dbs(tmp_path, _recs(3, seed=4, day0=1000, step=1))

    def run(P, db):
        cfg = P.Config(store_backend="memory", fetch_retries=1)
        al = P.log.AlertLog(db)
        calls = []

        def post(url, body, timeout):
            calls.append(url)
            raise OSError("connection refused")

        try:
            al.subscribe("http://dead/hook")
            d = P.feed.WebhookDeliverer(al, cfg, post=post,
                                        sleep=lambda s: None)
            n1 = d.deliver_once()
            held = _strip(al.subscribers())
            d._post = lambda url, body, timeout: 200
            n2 = d.deliver_once()
            return (n1, len(calls), held, n2, _strip(al.subscribers()),
                    P.metrics.counter("alert_webhook_failures_total").value,
                    P.metrics.counter("alert_webhook_retries").value)
        finally:
            al.close()

    j, t = both(run, dbs)
    assert t == j
    n1, ncalls, held, n2, subs, fails, retries = t
    assert (n1, ncalls, n2, fails, retries) == (0, 2, 3, 1, 1)
    assert held[0]["cursor"] == 0 and held[0]["failures"] == 1
    assert subs[0]["lag"] == 0 and subs[0]["failures"] == 0


# ---------------------------------------------------------------------------
# the serve mount: pull, SSE, webhook registration
# ---------------------------------------------------------------------------

@pytest.fixture
def served(tmp_path):
    """A JAX and a port server, each over its copy of one alert db of five
    records: package name -> (base url, its AlertLog)."""
    dbs = _twin_dbs(tmp_path, _recs(5, seed=5, score=1.0, magnitude=2.5))
    out, closers = {}, []
    for P in PKGS:
        cfg = P.Config(store_backend="memory", serve_deadline_sec=5.0)
        store = P.open_store("memory", "", cfg.keyspace())
        al = P.log.AlertLog(dbs[P.name])
        svc = P.api.ServeService(store, cfg, alerts=P.feed.AlertFeed(al, cfg))
        srv = P.api.start_serve_server(0, svc, host="127.0.0.1")
        out[P.name] = (f"http://127.0.0.1:{srv.port}", al)
        closers.append((srv, al, store))
    yield out
    for srv, al, store in closers:
        srv.close()
        al.close()
        store.close()


def _get(base, path):
    try:
        r = urllib.request.urlopen(base + path, timeout=10)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(base, path):
    req = urllib.request.Request(base + path, data=b"", method="POST")
    try:
        r = urllib.request.urlopen(req, timeout=10)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same(served, path, post=False):
    """Both servers' (code, JSON body) for one request, held equal."""
    fn = _post if post else _get
    j = fn(served["jax"][0], path)
    t = fn(served["torch"][0], path)
    assert t == j, (path, t, j)
    return t


def test_alerts_pull_endpoint(served):
    code, doc = _same(served, "/v1/alerts?since=0")
    assert code == 200 and len(doc["alerts"]) == 5
    assert doc["cursor"] == doc["latest"] == 5
    a = doc["alerts"][0]
    assert a["break_date"] == jdt.to_iso(728000)
    code, doc = _same(served, "/v1/alerts?since=3")
    assert [r["id"] for r in doc["alerts"]] == [4, 5]
    xs = sorted(r["px"] for r in _same(served, "/v1/alerts?since=0")[1]
                ["alerts"])
    code, doc = _same(served, f"/v1/alerts?since=0&bbox={xs[1]},0,"
                              f"{xs[3]},1000&limit=2")
    assert code == 200 and len(doc["alerts"]) == 2
    assert all(xs[1] <= r["px"] <= xs[3] for r in doc["alerts"])
    code, doc = _same(served, "/v1/alerts?since=0&t1="
                      + jdt.to_iso(728000 + 16))
    assert len(doc["alerts"]) == 2
    code, doc = _same(served, "/v1/alerts?since=0&t0="
                      + jdt.to_iso(728000 + 48))
    assert [r["id"] for r in doc["alerts"]] == [4, 5]
    for bad in ("/v1/alerts?since=0&bbox=1,2",
                "/v1/alerts?since=0&t0=garbage",
                "/v1/alerts/stream?since=0&t1=garbage",
                "/v1/alerts?since=x"):
        code, doc = _same(served, bad)
        assert code == 400, bad


def test_alerts_404_without_log():
    answers = []
    for P in PKGS:
        cfg = P.Config(store_backend="memory")
        store = P.open_store("memory", "", cfg.keyspace())
        srv = P.api.start_serve_server(0, P.api.ServeService(store, cfg),
                                       host="127.0.0.1")
        base = f"http://127.0.0.1:{srv.port}"
        try:
            answers.append([_get(base, p) for p in (
                "/v1/alerts?since=0", "/v1/alerts/webhooks",
                "/v1/alerts/stream")]
                + [_post(base, "/v1/alerts/webhooks?url=http://h/hook")])
        finally:
            srv.close()
            store.close()
    j, t = answers
    assert t == j
    assert {code for code, _ in t} == {404}
    assert "alerts/feed.py" not in t[0][1]["error"]


def test_webhook_registration_endpoint(served):
    code, doc = _same(served, "/v1/alerts/webhooks?url=http://h/hook"
                      "&since=2", post=True)
    assert code == 200 and doc["latest"] == 5 and doc["id"] == 1
    _same(served, "/v1/alerts/webhooks?url=http://h/hook", post=True)
    subs = []
    for name in ("jax", "torch"):
        code, doc = _get(served[name][0], "/v1/alerts/webhooks")
        assert code == 200
        subs.append(_strip(doc["subscribers"]))
    assert subs[1] == subs[0]
    assert len(subs[1]) == 1
    assert subs[1][0]["cursor"] == 2 and subs[1][0]["lag"] == 3
    for bad in ("?url=no-scheme", "?url=http://h2/hook&mode=bogus",
                "?url=http://h2/hook&mode=digest", "?since=1"):
        code, _ = _same(served, "/v1/alerts/webhooks" + bad, post=True)
        assert code == 400, bad


def _sse_events(r, n):
    """The first ``n`` SSE events of response ``r`` as (id, data) pairs,
    and the comment lines seen on the way."""
    events, comments, ev = [], [], {}
    while len(events) < n:
        line = r.readline()
        assert line, "server closed before all events arrived"
        line = line.decode().rstrip("\n")
        if not line:
            if "data" in ev:
                events.append((ev.get("event"), int(ev["id"]),
                               json.loads(ev["data"])))
            ev = {}
        elif line.startswith(":"):
            comments.append(line)
        else:
            k, _, v = line.partition(":")
            ev[k] = v.strip()
    return events, comments


def test_sse_stream_replay_and_live(served):
    got = {}
    for name in ("jax", "torch"):
        base, al = served[name]
        r = urllib.request.urlopen(base + "/v1/alerts/stream?since=0",
                                   timeout=10)
        ctype = r.headers["Content-Type"]
        threading.Timer(0.1, lambda al=al: al.append(
            [{"cx": 100, "cy": 200, "px": 999, "py": 999,
              "break_day": 730000.0}])).start()
        events, _ = _sse_events(r, 6)
        r.close()
        r = urllib.request.urlopen(base + "/v1/alerts/stream?since=5",
                                   timeout=10)
        resumed, _ = _sse_events(r, 1)
        r.close()
        got[name] = (ctype, _strip(events), _strip(resumed))
    assert got["torch"] == got["jax"]
    ctype, events, resumed = got["torch"]
    assert ctype == "text/event-stream"
    assert [e[0] for e in events] == ["alert"] * 6
    assert [e[1] for e in events] == [e[2]["id"] for e in events] \
        == [1, 2, 3, 4, 5, 6]
    assert events[-1][2]["px"] == 999
    assert resumed[0][1] == 6
    assert tmetrics.counter("serve_requests_alerts_stream").value == 2


# ---------------------------------------------------------------------------
# crossing: registrations and cursors read and delivered by the other
# ---------------------------------------------------------------------------

def _tile_aoi(x, y, inset=10.0):
    e = jpyr.tile_extent(11, x, y)
    return (e["ulx"] + inset, e["lry"] + inset, e["lrx"] - inset,
            e["uly"] - inset)


def _tile_recs(seed, n, tiles):
    """``n`` records in base tiles ``tiles``, points drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x, y = tiles[int(rng.integers(0, len(tiles)))]
        e = jpyr.tile_extent(11, x, y)
        px = int(e["ulx"] + rng.integers(1, 2999))
        py = int(e["uly"] - rng.integers(1, 2999))
        out.append({"cx": int(e["ulx"]), "cy": int(e["uly"]), "px": px,
                    "py": py, "break_day": float(1000 + i)})
    return out


class Clock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def test_jax_registrations_delivered_by_the_port(tmp_path):
    """Subscribers the JAX package registered (AOI, mode, window) over one
    alert log: the port's flat and fanout deliverers deliver them as the
    JAX package's do, POST for POST, cursor for cursor."""
    tiles = [(100, 200), (101, 200), (100, 201)]
    src = str(tmp_path / "src" / "alerts.db")
    al = jlog.AlertLog(src)
    al.append(_tile_recs(6, 60, tiles), run_id="x")
    al.subscribe("http://all/hook")
    al.subscribe("http://aoi/hook", aoi=_tile_aoi(100, 200), mode="batch",
                 max_n=7)
    al.subscribe("http://dig/hook", aoi=_tile_aoi(101, 200, 500.0),
                 mode="digest", window_sec=100.0)
    al.subscribe("http://far/hook", aoi=_tile_aoi(900, 900))
    al._con.execute("PRAGMA wal_checkpoint(TRUNCATE)")
    al.close()
    for P in PKGS:
        os.makedirs(tmp_path / P.name)
        shutil.copy(src, tmp_path / P.name / "alerts.db")

    def run(P, _):
        al = P.log.AlertLog(str(tmp_path / P.name / "alerts.db"))
        cfg = P.Config(store_backend="memory", fetch_retries=1)
        posts = []

        def post(url, body, timeout):
            posts.append((url, json.loads(body)))
            return 200

        clk = Clock()
        try:
            fd = P.fanout.FanoutDeliverer(al, cfg, post=post,
                                          sleep=lambda s: None, clock=clk)
            out = []
            for s in al.shards_since(0, 2):
                out.append(fd.drain_shard(s["shard"], s["upto"],
                                          since=s["since"]))
            al.append(_tile_recs(61, 40, tiles), run_id="y")
            clk.t = 1050.0
            for s in al.shards_since(60, 2):
                out.append(fd.drain_shard(s["shard"], s["upto"],
                                          since=s["since"]))
            flat = P.feed.WebhookDeliverer(al, cfg, post=post,
                                           sleep=lambda s: None)
            out.append(flat.deliver_once(batch=32))
            cursors = [(s["id"], sh, al.fanout_cursor(s["id"], sh))
                       for s in al.subscribers()
                       for sh in ("00", "01", "02", "03")]
            return (out, _strip(posts), _strip(al.subscribers()), cursors,
                    [al.shard_drained(sh) for sh in ("00", "01")])
        finally:
            al.close()

    j, t = both(run)
    assert t == j
    out, posts, subs, _, drained = t
    urls = {u for u, _ in posts}
    assert "http://far/hook" in urls     # the flat sweep has no AOI filter
    assert not any(u == "http://far/hook" and "shard" in d
                   for u, d in posts)
    assert {s["cursor"] for s in subs} == {100}
    assert drained[0] == 100


def test_port_registrations_read_by_jax(tmp_path):
    """The port registers and delivers; the JAX package's ``subscribers()``
    and ``status()`` on the same db read what the port's do."""
    db = str(tmp_path / "alerts.db")
    al = tlog.AlertLog(db)
    al.append(_tile_recs(7, 30, [(100, 200), (1500, 300)]), run_id="p")
    ids = al.subscribe_many([
        {"url": "http://a/hook"},
        {"url": "http://b/hook", "aoi": _tile_aoi(100, 200), "mode": "batch",
         "max_n": 4},
        {"url": "http://c/hook", "mode": "digest", "window_sec": 60.0,
         "cursor": 5}])
    al.advance(ids[0], 12)
    al.advance_fanout(ids[1], "00", 9, sent_at=123.0)
    al.record_failure(ids[2], park_after=1, base=1.0, cap=2.0,
                      clock=lambda: 5e9)
    al.set_rollup_cursor(17)
    al.set_shard_drained("00", 0, 17)
    mine = al.status()
    other = jlog.AlertLog(db)
    try:
        theirs = other.status()
        assert theirs == mine
        assert other.subscribers() == al.subscribers()
        assert other.fanout_cursor(ids[1], "00") == 9
        assert other.shard_subscribers("00") == al.shard_subscribers("00")
        assert other.shard_drained("00") == 17
        assert other.audience_for_cells(["", "0"]) == \
            al.audience_for_cells(["", "0"])
    finally:
        other.close()
        al.close()
    assert mine["fanout"]["parked"] == 1
    assert mine["fanout"]["by_mode"] == {"immediate": 1, "batch": 1,
                                         "digest": 1}
    assert mine["fanout"]["rollup_cursor"] == 17
    assert [s["cursor"] for s in mine["subscribers"]] == [12, 0, 5]

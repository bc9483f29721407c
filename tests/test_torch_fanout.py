"""The port's fanout plane (alerts/subindex.py, the shard half of
alerts/log.py, alerts/fanout.py, fleet/plan.py ``enqueue_fanout`` and the
fleet's ``fanout`` job) against the JAX package's, on the CPU.

The cases of tests/test_fanout.py, each run on both packages from the same
inputs (AOIs and alert points drawn from a seed with numpy) under the same
injected ``post``, ``sleep``, ``clock`` and ``rng``, and held equal: the
quadkey math and the index against brute force, the migration from the
schema before fanout, the shard queries and the watermark rules, exactly
once across deliverer incarnations, the AOI filter, the batch, digest and
parking cases, the flat deliverer's parking, ``rollup``, the worker's
``fanout`` job, the registration endpoint and the knobs.  Subscriber
fields stamped from the wall clock (``created``, ``last_ok``) and the
records' ``detected_at`` are left out of a comparison by name.
``cover_bbox`` and ``point_cells`` equal the JAX package's over a seeded
sweep.
"""

import json
import random
import sqlite3
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from firebird_tpu.alerts import fanout as jfanout
from firebird_tpu.alerts import feed as jfeed
from firebird_tpu.alerts import log as jlog
from firebird_tpu.alerts import subindex as jsub
from firebird_tpu.config import Config as JConfig
from firebird_tpu.fleet import plan as jplan
from firebird_tpu.fleet import queue as jqueue
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu.obs import slo as jslo
from firebird_tpu.serve import api as japi
from firebird_tpu.serve import pyramid as jpyr
from firebird_tpu.store import open_store as jopen_store
from firebird_tpu_torch.alerts import fanout as tfanout
from firebird_tpu_torch.alerts import feed as tfeed
from firebird_tpu_torch.alerts import log as tlog
from firebird_tpu_torch.alerts import subindex as tsub
from firebird_tpu_torch.config import Config as TConfig
from firebird_tpu_torch.fleet import plan as tplan
from firebird_tpu_torch.fleet import queue as tqueue
from firebird_tpu_torch.obs import metrics as tmetrics
from firebird_tpu_torch.obs import slo as tslo
from firebird_tpu_torch.serve import api as tapi
from firebird_tpu_torch.serve import pyramid as tpyr
from firebird_tpu_torch.store import open_store as topen_store

JAX = types.SimpleNamespace(
    name="jax", log=jlog, feed=jfeed, fanout=jfanout, sub=jsub, pyr=jpyr,
    plan=jplan, queue=jqueue, Config=JConfig, metrics=jmetrics, api=japi,
    open_store=jopen_store, slo=jslo)
PORT = types.SimpleNamespace(
    name="torch", log=tlog, feed=tfeed, fanout=tfanout, sub=tsub, pyr=tpyr,
    plan=tplan, queue=tqueue, Config=TConfig, metrics=tmetrics, api=tapi,
    open_store=topen_store, slo=tslo)
PKGS = (JAX, PORT)

WALL = ("created", "last_ok", "detected_at")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in WALL}
    if isinstance(x, (list, tuple)):
        return type(x)(_strip(v) for v in x)
    return x


def tile_pt(x, y):
    """A projection point inside base tile (x, y): records stamped here
    carry quadkey(Z_BASE, x, y)."""
    e = jpyr.tile_extent(jsub.Z_BASE, x, y)
    return int(e["ulx"]) + 1, int(e["uly"]) - 1


def tile_mid(x, y):
    e = jpyr.tile_extent(jsub.Z_BASE, x, y)
    return (e["ulx"] + e["lrx"]) / 2, (e["uly"] + e["lry"]) / 2


def inset_aoi(x, y, d=10.0):
    e = jpyr.tile_extent(jsub.Z_BASE, x, y)
    return (e["ulx"] + d, e["lry"] + d, e["lrx"] - d, e["uly"] - d)


def rec_at(x, y, day, **kw):
    px, py = tile_pt(x, y)
    r = {"cx": px, "cy": py, "px": px, "py": py, "break_day": float(day)}
    r.update(kw)
    return r


def recs_in(x, y, days, seed):
    """Records inside base tile (x, y), one a day in ``days``, points drawn
    from ``seed`` with numpy (clear of the inset AOIs' 10 m margin)."""
    rng = np.random.default_rng(seed)
    e = jpyr.tile_extent(jsub.Z_BASE, x, y)
    return [{"cx": int(e["ulx"]), "cy": int(e["uly"]),
             "px": int(e["ulx"]) + int(rng.integers(20, 2980)),
             "py": int(e["uly"]) - int(rng.integers(20, 2980)),
             "break_day": float(d)} for d in days]


class Clock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def both(scenario, tmp_path):
    """``scenario(P, dir)`` on the JAX package, then the port, each in a
    directory of its own with fresh metrics; the two results."""
    out = []
    for P in PKGS:
        jmetrics.reset_registry()
        tmetrics.reset_registry()
        d = tmp_path / P.name
        d.mkdir()
        out.append(scenario(P, d))
    jmetrics.reset_registry()
    tmetrics.reset_registry()
    return out


def cfg_mem(P, **kw):
    return P.Config(store_backend="memory", fetch_retries=1, **kw)


def _posting(log):
    def post(url, body, timeout):
        log.append((url, json.loads(body)))
        return 200
    return post


# ---------------------------------------------------------------------------
# subindex: quadkey math
# ---------------------------------------------------------------------------

def test_zbase_and_shard_helpers():
    for P in PKGS:
        assert P.sub.Z_BASE == P.pyr.Z_BASE == 11
        assert P.sub.MAX_CELLS == 64
        assert P.sub.shard_of("01230123012", 2) == "01"
        assert P.sub.shard_of("01230123012", 0) == ""
        assert P.sub.shard_prefixes("012") == ["", "0", "01"]
        assert P.sub.shard_prefixes("") == []
        assert P.sub.aoi_contains(None, 1.0, 1.0)
        assert P.sub.aoi_contains((0, 0, 2, 2), 2.0, 0.0)
        assert not P.sub.aoi_contains((0, 0, 2, 2), 3.0, 1.0)


def test_base_quadkey_and_point_cells():
    px, py = tile_pt(100, 200)
    qk = jpyr.quadkey(11, 100, 200)
    for P in PKGS:
        assert P.sub.base_quadkey(px, py) == qk
        cells = P.sub.point_cells(px, py)
        assert cells == [qk[:i] for i in range(12)]
        assert P.sub.base_quadkey(-1e9, 1e9) is None
        assert P.sub.point_cells(-1e9, 1e9) == [""]


def test_cover_bbox_shapes():
    e = jpyr.tile_extent(11, 100, 200)
    bbox = (e["ulx"] + 10, e["lry"] + 10, e["lrx"] - 10, e["uly"] - 10)
    d = jsub._extent(0, 0, 0)
    inset = (d[0] + 1, d[1] + 1, d[2] - 1, d[3] - 1)
    got = []
    for P in PKGS:
        assert P.sub._extent(0, 0, 0) == d
        assert P.sub.cover_bbox(bbox) == [jpyr.quadkey(11, 100, 200)]
        assert P.sub.cover_bbox(d) == [""]
        four = P.sub.cover_bbox(inset, max_cells=4)
        assert four == sorted(jpyr.quadkey(1, x, y)
                              for x in (0, 1) for y in (0, 1))
        cells = P.sub.cover_bbox(inset, max_cells=64)
        assert 4 <= len(cells) <= 64
        rng = np.random.default_rng(7)
        have = set(cells)
        for px, py in zip(rng.uniform(inset[0], inset[2], 50),
                          rng.uniform(inset[1], inset[3], 50)):
            assert any(c in have for c in P.sub.point_cells(px, py))
        assert P.sub.cover_bbox((-1e9, 1e9, -1e9 + 5, 1e9 + 5)) == []
        with pytest.raises(ValueError):
            P.sub.cover_bbox((5, 0, 0, 5))
        with pytest.raises(ValueError):
            P.sub.cover_bbox(bbox, max_cells=3)
        got.append((four, cells))
    assert got[1] == got[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_cover_and_point_cells_equal_jax_over_a_sweep(seed):
    """``cover_bbox`` at several budgets and ``point_cells`` string for
    string with the JAX package's, over AOIs from 30 m to ~2 000 km
    half-widths (some off the domain's edge) and points in and out of the
    domain, drawn from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    dminx, dminy, dmaxx, dmaxy = jsub._extent(0, 0, 0)
    w, h = dmaxx - dminx, dmaxy - dminy
    for _ in range(120):
        cx = rng.uniform(dminx - 0.05 * w, dmaxx + 0.05 * w)
        cy = rng.uniform(dminy - 0.05 * h, dmaxy + 0.05 * h)
        half = 10.0 ** rng.uniform(1.5, 6.3)
        aoi = (cx - half, cy - half * rng.uniform(0.2, 2.0), cx + half,
               cy + half)
        budget = int(rng.choice([4, 9, 64, 200]))
        assert tsub.cover_bbox(aoi, budget) == jsub.cover_bbox(aoi, budget)
        assert tsub.point_cells(cx, cy) == jsub.point_cells(cx, cy)
        assert tsub.base_quadkey(cx, cy) == jsub.base_quadkey(cx, cy)


def test_property_index_matches_brute_force(tmp_path):
    """Audience through the quadkey cell index == a brute-force bbox scan,
    in both packages, over AOIs drawn from a seed (100 m to ~2 000 km
    half-widths) and random in-domain points: and the two packages'
    answers equal."""
    rng = np.random.default_rng(20260807)
    dminx, dminy, dmaxx, dmaxy = jsub._extent(0, 0, 0)
    entries = []
    for i in range(100):
        cx = rng.uniform(dminx, dmaxx)
        cy = rng.uniform(dminy, dmaxy)
        half = 10.0 ** rng.uniform(2.0, 6.3)
        entries.append({"url": f"http://s{i}/hook",
                        "aoi": (cx - half, cy - half, cx + half, cy + half)})
    entries += [{"url": f"http://g{i}/hook"} for i in range(10)]
    pts = list(zip(rng.uniform(dminx, dmaxx, 120),
                   rng.uniform(dminy, dmaxy, 120)))

    def run(P, d):
        al = P.log.AlertLog(str(d / "alerts.db"))
        try:
            ids = al.subscribe_many(entries)
            out = []
            for px, py in pts:
                a = al.audience(px, py)
                assert a == al.audience_brute(px, py)
                out.append(a)
            return ids, out, al.status()["fanout"]["cells"]
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    assert len(t[0]) == 110 and any(t[1])


# ---------------------------------------------------------------------------
# AlertLog: migration, registration, shard queries
# ---------------------------------------------------------------------------

def _old_schema(path):
    con = sqlite3.connect(path)
    con.execute(
        "CREATE TABLE alerts ("
        " id INTEGER PRIMARY KEY AUTOINCREMENT,"
        " cx INTEGER NOT NULL, cy INTEGER NOT NULL,"
        " px INTEGER NOT NULL, py INTEGER NOT NULL,"
        " break_day REAL NOT NULL, score REAL, magnitude REAL,"
        " run_id TEXT, detected_at TEXT,"
        " UNIQUE (px, py, break_day))")
    con.execute(
        "CREATE TABLE subscribers ("
        " id INTEGER PRIMARY KEY AUTOINCREMENT,"
        " url TEXT NOT NULL UNIQUE,"
        " cursor INTEGER NOT NULL DEFAULT 0,"
        " created TEXT, last_ok TEXT,"
        " failures INTEGER NOT NULL DEFAULT 0)")
    con.execute("INSERT INTO subscribers (url, cursor) "
                "VALUES ('http://old/hook', 1)")
    con.execute("INSERT INTO alerts (cx, cy, px, py, break_day) "
                "VALUES (100, 200, 100, 200, 1000.0)")
    con.commit()
    con.close()


def test_migration_from_pre_fanout_schema(tmp_path):
    def run(P, d):
        path = str(d / "old.db")
        _old_schema(path)
        al = P.log.AlertLog(path)
        try:
            sub = al.subscribers()[0]
            out = [_strip(sub), al.audience(*tile_pt(100, 200)),
                   al.shards_since(0, 2)]
            al.append([rec_at(100, 200, 2000)])
            out.append(al.shards_since(0, 2))
            return out
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    sub, aud, before, after = t
    assert sub["cursor"] == 1 and sub["aoi"] is None
    assert sub["mode"] == "immediate" and sub["parked_until"] is None
    assert aud == [sub["id"]] and before == []
    assert len(after) == 1 and after[0]["count"] == 1 and after[0]["upto"] == 2
    # Each package opens the other's migrated file alike.
    path = str(tmp_path / "cross.db")
    _old_schema(path)
    a = tlog.AlertLog(path)
    a.close()
    b = jlog.AlertLog(path)
    try:
        assert _strip(b.subscribers()) == [sub]
    finally:
        b.close()


def test_subscribe_validation_and_replace(tmp_path):
    def run(P, d):
        al = P.log.AlertLog(str(d / "alerts.db"))
        try:
            errs = []
            for bad in (dict(url="no-scheme"),
                        dict(url="http://x/", mode="bogus"),
                        dict(url="http://x/", mode="digest"),
                        dict(url="http://x/", mode="batch")):
                with pytest.raises(ValueError) as ei:
                    al.subscribe(**bad)
                errs.append(str(ei.value))
            sid = al.subscribe("http://x/hook", cursor=5,
                               aoi=inset_aoi(100, 200))
            out = [errs, sid, al.audience(*tile_mid(100, 200)),
                   al.audience(*tile_pt(500, 500))]
            out.append(al.subscribe("http://x/hook", mode="digest",
                                    window_sec=60.0))
            out += [_strip(al.subscribers()),
                    al.audience(*tile_pt(500, 500))]
            return out
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    _, sid, near, far, again, subs, far2 = t
    assert near == [sid] and far == [] and again == sid
    assert subs[0]["cursor"] == 5 and subs[0]["mode"] == "digest"
    assert subs[0]["aoi"] is None and subs[0]["window_sec"] == 60.0
    assert far2 == [sid]


def test_shard_queries_and_cursor_rules(tmp_path):
    def run(P, d):
        al = P.log.AlertLog(str(d / "alerts.db"))
        try:
            sid = al.subscribe("http://s/hook")
            al.append(recs_in(100, 200, range(1000, 1003), seed=3))
            al.append([rec_at(1500, 300, 2000)])
            out = [al.shards_since(0, 2),
                   _strip(al.alerts_for_shard("00", upto=3)),
                   [a["id"] for a in al.alerts_for_shard("10", upto=4)],
                   [[s["id"] for s in al.shard_subscribers(sh)]
                    for sh in ("00", "10")]]
            al.advance_fanout(sid, "00", 10, sent_at=123.0)
            al.advance_fanout(sid, "00", 5)
            out += [al.fanout_cursor(sid, "00"),
                    al.shard_subscribers("00")[0]["last_sent"]]
            al.advance_fanout(sid, "00", 12)
            out += [al.fanout_cursor(sid, "00"), al.fanout_cursor(sid, "10")]
            al.set_rollup_cursor(4)
            al.set_rollup_cursor(2)
            out.append(al.rollup_cursor())
            return out, sid
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    (shards, page, ten, subs, c10, sent, c12, c0, roll), sid = t
    assert [s["shard"] for s in shards] == ["00", "10"]
    assert [s["upto"] for s in shards] == [3, 4]
    assert [a["id"] for a in page] == [1, 2, 3]
    assert all(a["qk"].startswith("00") for a in page)
    assert ten == [4] and subs == [[sid], [sid]]
    assert (c10, sent, c12, c0, roll) == (10, 123.0, 12, 0, 4)


def test_shard_drained_watermark_rules(tmp_path):
    steps = [("00", 0, 5), ("00", 10, 20), ("00", 3, 12), ("00", 12, 8),
             ("00", 12, 20), ("zz", 4, 9)]

    def run(P, d):
        al = P.log.AlertLog(str(d / "alerts.db"))
        try:
            seen = [al.shard_drained("00")]
            for shard, since, upto in steps:
                al.set_shard_drained(shard, since, upto)
                seen.append(al.shard_drained(shard))
            return seen
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j == [0, 5, 5, 12, 12, 20, 0]


def test_status_fanout_block(tmp_path):
    def run(P, d):
        al = P.log.AlertLog(str(d / "alerts.db"))
        try:
            al.subscribe("http://a/hook")
            al.subscribe("http://b/hook", mode="batch", max_n=2)
            s = al.status()
            s.pop("path")
            return _strip(s)
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    f = t["fanout"]
    assert f["cells"] == 2 and f["by_mode"] == {"immediate": 1, "batch": 1}
    assert f["parked"] == 0 and f["rollup_cursor"] == 0


# ---------------------------------------------------------------------------
# FanoutDeliverer: exactly-once, policies, parking
# ---------------------------------------------------------------------------

def test_exactly_once_across_incarnations(tmp_path):
    def run(P, d):
        al = P.log.AlertLog(str(d / "alerts.db"))
        got, calls = [], {"n": 0}

        def post_then_die(url, body, timeout):
            calls["n"] += 1
            if calls["n"] > 1:
                raise OSError("killed")
            got.append(json.loads(body))
            return 200

        try:
            sid = al.subscribe("http://sink/hook")
            al.append(recs_in(100, 200, range(1000, 1010), seed=4))
            shard = al.shards_since(0, 2)[0]["shard"]
            d1 = P.fanout.FanoutDeliverer(al, cfg_mem(P), post=post_then_die,
                                          sleep=lambda s: None)
            out = [d1.drain_shard(shard, 10, batch=4),
                   al.fanout_cursor(sid, shard)]
            d2 = P.fanout.FanoutDeliverer(
                al, cfg_mem(P), sleep=lambda s: None,
                post=lambda u, b, t: got.append(json.loads(b)) or 200)
            out += [d2.drain_shard(shard, 10, batch=4),
                    al.fanout_cursor(sid, shard),
                    al.subscribers()[0]["failures"]]
            n = len(got)
            out += [d2.drain_shard(shard, 10, batch=4), len(got) - n,
                    _strip(got), al.shard_drained(shard),
                    P.metrics.counter("fanout_delivered_total").value,
                    P.metrics.counter("fanout_failures_total").value]
            return out
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    n1, c1, n2, c2, fails, n3, extra, got, drained, deliv, ffail = t
    assert (n1, c1, n2, c2, fails, n3, extra) == (4, 4, 6, 0, 0, 0, 0)
    assert [a["id"] for doc in got for a in doc["alerts"]] == \
        list(range(1, 11))
    assert drained == 10 and deliv == 10 and ffail == 1


def test_aoi_filtered_subscriber_pays_nothing(tmp_path):
    def run(P, d):
        al = P.log.AlertLog(str(d / "alerts.db"))
        posts = []
        try:
            far = al.subscribe("http://far/hook", aoi=inset_aoi(101, 201))
            near = al.subscribe("http://near/hook", aoi=inset_aoi(100, 200))
            al.append([rec_at(100, 200, 1000 + i) for i in range(3)])
            dl = P.fanout.FanoutDeliverer(
                al, cfg_mem(P), sleep=lambda s: None,
                post=lambda u, b, t: posts.append((u, json.loads(b)))
                or 200)
            out = [dl.drain_shard("00", 3), list(posts),
                   al.fanout_cursor(far, "00"), al.fanout_cursor(near, "00")]
            px, py = tile_mid(100, 200)
            al.append([{"cx": px, "cy": py, "px": px, "py": py,
                        "break_day": 5000.0}])
            out += [dl.drain_shard("00", 4, since=3), _strip(posts)]
            return out
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    n1, before, cf, cn, n2, posts = t
    assert (n1, before, cf, cn, n2) == (0, [], 0, 0, 1)
    assert [u for u, _ in posts] == ["http://near/hook"]
    assert [a["id"] for a in posts[0][1]["alerts"]] == [4]


def test_batch_mode_chunks_posts(tmp_path):
    def run(P, d):
        al = P.log.AlertLog(str(d / "alerts.db"))
        got = []
        try:
            sid = al.subscribe("http://b/hook", mode="batch", max_n=3)
            al.append(recs_in(100, 200, range(1000, 1008), seed=5))
            dl = P.fanout.FanoutDeliverer(al, cfg_mem(P),
                                          sleep=lambda s: None,
                                          post=_posting(got))
            return (dl.drain_shard("00", 8), _strip(got),
                    al.fanout_cursor(sid, "00"))
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    n, got, cur = t
    assert n == 8 and cur == 0
    assert [doc["count"] for _, doc in got] == [3, 3, 2]
    assert {doc["schema"] for _, doc in got} == {"firebird-alert-webhook/1"}
    assert [doc["cursor"] for _, doc in got] == [3, 6, 8]


def test_digest_holds_window_then_flushes(tmp_path):
    def run(P, d):
        clk = Clock(1000.0)
        al = P.log.AlertLog(str(d / "alerts.db"))
        got = []
        try:
            sid = al.subscribe("http://d/hook", mode="digest",
                               window_sec=100.0)
            al.append(recs_in(100, 200, range(1000, 1003), seed=6))
            dl = P.fanout.FanoutDeliverer(al, cfg_mem(P), clock=clk,
                                          sleep=lambda s: None,
                                          post=_posting(got))
            out = [dl.drain_shard("00", 3), len(got)]
            al.append(recs_in(100, 200, range(2000, 2002), seed=7))
            clk.t = 1050.0
            out += [dl.drain_shard("00", 5), len(got),
                    al.fanout_cursor(sid, "00")]
            clk.t = 1200.0
            out += [dl.drain_shard("00", 5), _strip(got),
                    al.fanout_cursor(sid, "00"),
                    al.shard_subscribers("00")[0]["last_sent"]]
            return out
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    n1, k1, n2, k2, c2, n3, got, c3, last = t
    assert (n1, k1, n2, k2, c2, n3, c3, last) == (3, 1, 0, 1, 3, 2, 5,
                                                  1200.0)
    assert got[0][1]["schema"] == "firebird-alert-digest/1"
    assert [a["id"] for a in got[-1][1]["alerts"]] == [4, 5]


def test_digest_row_survives_unmatched_window(tmp_path):
    def run(P, d):
        clk = Clock(1000.0)
        al = P.log.AlertLog(str(d / "alerts.db"))
        got = []
        try:
            sid = al.subscribe("http://d/hook", mode="digest",
                               window_sec=100.0, aoi=inset_aoi(100, 200))
            px, py = tile_mid(100, 200)
            al.append([{"cx": px, "cy": py, "px": px, "py": py,
                        "break_day": 1000.0}])
            dl = P.fanout.FanoutDeliverer(al, cfg_mem(P), clock=clk,
                                          sleep=lambda s: None,
                                          post=_posting(got))
            out = [dl.drain_shard("00", 1), al.fanout_cursor(sid, "00")]
            al.append([rec_at(100, 200, 3000)])
            clk.t = 1050.0
            out += [dl.drain_shard("00", 2, since=1),
                    al.fanout_cursor(sid, "00")]
            al.append([{"cx": px, "cy": py, "px": px + 1, "py": py - 1,
                        "break_day": 4000.0}])
            out += [dl.drain_shard("00", 3, since=2), len(got)]
            clk.t = 1200.0
            out += [dl.drain_shard("00", 3, since=2), _strip(got)]
            return out
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    assert t[:7] == [1, 1, 0, 2, 0, 1, 1]
    assert [a["id"] for a in t[7][-1][1]["alerts"]] == [3]


def test_parking_backoff_and_heal(tmp_path):
    def run(P, d):
        cfg = cfg_mem(P, fanout_park_after=2, fanout_park_base_sec=1.0,
                      fanout_park_cap_sec=2.0)
        al = P.log.AlertLog(str(d / "alerts.db"))
        calls = []

        def post(url, body, timeout):
            calls.append(url)
            raise OSError("connection refused")

        clk = Clock(1000.0)
        try:
            al.subscribe("http://dead/hook")
            al.append([rec_at(100, 200, 1500)])
            dl = P.fanout.FanoutDeliverer(al, cfg, post=post,
                                          sleep=lambda s: None, clock=clk,
                                          rng=random.Random(0))
            out = [dl.drain_shard("00", 1), _strip(al.subscribers())]
            out += [dl.drain_shard("00", 1), _strip(al.subscribers())]
            n = len(calls)
            out += [dl.drain_shard("00", 1), len(calls) - n]
            clk.t = 1010.0
            dl._post = lambda u, b, t: 200
            out += [dl.drain_shard("00", 1), _strip(al.subscribers()),
                    P.metrics.counter("fanout_parked_total").value,
                    P.metrics.counter("fanout_skipped_parked_total").value]
            return out
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    n1, s1, n2, s2, n3, extra, n4, s4, parked, skipped = t
    assert (n1, n2, n3, extra, n4, parked, skipped) == (0, 0, 0, 0, 1, 1, 1)
    assert s1[0]["failures"] == 1 and s1[0]["parked_until"] is None
    assert s2[0]["failures"] == 2
    assert 1001.0 <= s2[0]["parked_until"] <= 1002.0
    assert s4[0]["failures"] == 0 and s4[0]["parked_until"] is None


def test_flat_deliverer_parks_dead_subscriber(tmp_path):
    def run(P, d):
        cfg = cfg_mem(P, fanout_park_after=1)
        al = P.log.AlertLog(str(d / "alerts.db"))
        calls = []

        def post(url, body, timeout):
            calls.append(url)
            if "dead" in url:
                raise OSError("connection refused")
            return 200

        try:
            al.append([rec_at(100, 200, 1000 + i) for i in range(3)])
            al.subscribe("http://dead/hook")
            al.subscribe("http://live/hook")
            dl = P.feed.WebhookDeliverer(al, cfg, post=post,
                                         sleep=lambda s: None)
            out = [dl.deliver_once()]
            subs = {s["url"]: s for s in al.subscribers()}
            out += [subs["http://live/hook"]["cursor"],
                    subs["http://dead/hook"]["cursor"],
                    subs["http://dead/hook"]["parked_until"] is not None]
            n = calls.count("http://dead/hook")
            out += [dl.deliver_once(), calls.count("http://dead/hook") - n,
                    P.metrics.counter(
                        "alert_webhook_skipped_parked_total").value]
            return out
        finally:
            al.close()

    j, t = both(run, tmp_path)
    assert t == j == [3, 3, 0, True, 0, 0, 1]


# ---------------------------------------------------------------------------
# Rollup + fleet integration
# ---------------------------------------------------------------------------

def test_rollup_watermark_and_open_job_skip(tmp_path):
    def run(P, d):
        cfg = cfg_mem(P)
        al = P.log.AlertLog(str(d / "alerts.db"))
        queue = P.queue.FleetQueue(str(d / "fleet.db"), lease_sec=300.0)
        try:
            al.subscribe("http://s/hook")
            al.append(recs_in(100, 200, range(1000, 1003), seed=8))
            al.append([rec_at(1500, 300, 2000)])
            ids = P.fanout.rollup(al, queue, cfg, clock=lambda: 77.0)
            upto = {p["shard"]: p["upto"]
                    for _, p in queue.open_payloads("fanout")}
            out = [ids, upto, al.rollup_cursor(),
                   P.fanout.rollup(al, queue, cfg)]
            al.append([rec_at(100, 200, 3000)])
            ids2 = P.fanout.rollup(al, queue, cfg, clock=lambda: 78.0)
            out += [ids2, queue.job(ids2[0])["payload"],
                    P.plan.enqueue_fanout(
                        queue, [{"shard": s, "upto": u, "count": 1}
                                for s, u in upto.items()]),
                    [queue.job(i)["payload"] for i in ids],
                    P.metrics.counter("fanout_jobs_enqueued").value,
                    P.metrics.counter("fanout_jobs_skipped_open").value]
            return out
        finally:
            queue.close()
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    ids, upto, roll, again, ids2, pay2, skip, _, enq, skipped = t
    assert len(ids) == 2 and upto == {"00": 3, "10": 4} and roll == 4
    assert again == [] and len(ids2) == 1 and skip == []
    assert pay2["shard"] == "00" and pay2["upto"] == 5
    assert pay2["rolled_at"] == 78.0 and pay2["since"] == 4
    assert enq == 3 and skipped == 2


def test_worker_runs_fanout_job(tmp_path, monkeypatch):
    """A ``fanout`` job on the port's worker drains its shard on the host
    (the worker holds the CPU device here, a card on the chip), equal to
    the JAX package's worker on the same log."""
    from firebird_tpu.fleet.worker import FleetWorker as JWorker
    from firebird_tpu_torch.fleet.worker import FleetWorker as TWorker

    def run(P, d):
        cfg = cfg_mem(P, alert_db=str(d / "alerts.db"))
        al = P.log.AlertLog(cfg.alert_db)
        queue = P.queue.FleetQueue(str(d / "fleet.db"), lease_sec=300.0)
        got = []
        try:
            sid = al.subscribe("http://sink/hook")
            al.append(recs_in(100, 200, range(1000, 1005), seed=9))
            n = len(P.fanout.rollup(al, queue, cfg))
            monkeypatch.setattr(P.fanout, "_default_post",
                                lambda url, body, timeout:
                                got.append(json.loads(body)) or 200)
            kw = dict(device="cpu") if P is PORT else {}
            w = (TWorker if P is PORT else JWorker)(
                cfg, queue, worker_id="t:1", sleep=lambda s: None, **kw)
            summary = w.run(until_drained=True)
            return (n, summary["acked"], summary["queue"]["done"],
                    _strip(got), al.fanout_cursor(sid, got[0]["shard"]),
                    al.shard_drained(got[0]["shard"]),
                    P.metrics.histogram(
                        "fanout_completion_seconds").snapshot()["count"])
        finally:
            queue.close()
            al.close()

    j, t = both(run, tmp_path)
    assert t == j
    n, acked, done, got, cur, drained, observed = t
    assert (n, acked, done, cur, drained, observed) == (1, 1, 1, 0, 5, 1)
    assert sum(doc["count"] for doc in got) == 5
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# Serve endpoint + SLO + knobs
# ---------------------------------------------------------------------------

def _post(url):
    req = urllib.request.Request(url, data=b"", method="POST")
    try:
        r = urllib.request.urlopen(req, timeout=10)
        return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_webhook_registration_with_aoi_and_policy(tmp_path):
    e = jpyr.tile_extent(11, 100, 200)
    bbox = f"{e['ulx'] + 10},{e['lry'] + 10},{e['lrx'] - 10},{e['uly'] - 10}"

    def run(P, d):
        cfg = P.Config(store_backend="memory", serve_deadline_sec=5.0)
        store = P.open_store("memory", "", cfg.keyspace())
        al = P.log.AlertLog(str(d / "alerts.db"))
        srv = P.api.start_serve_server(
            0, P.api.ServeService(store, cfg,
                                  alerts=P.feed.AlertFeed(al, cfg)),
            host="127.0.0.1")
        base = f"http://127.0.0.1:{srv.port}/v1/alerts/webhooks"
        try:
            out = [_post(base + f"?url=http://h/hook&bbox={bbox}"
                         "&mode=batch&max_n=5")]
            out += [_strip(al.subscribers()),
                    al.audience(*tile_mid(100, 200)),
                    al.audience(*tile_pt(500, 500))]
            out += [_post(base + b) for b in (
                "?url=http://h2/hook&mode=bogus",
                "?url=http://h2/hook&mode=digest",
                "?url=http://h3/hook&mode=digest&window=30",
                f"?url=http://h4/hook&bbox={bbox}&mode=batch&max_n=0")]
            out.append(_strip(al.subscribers()))
            return out
        finally:
            srv.close()
            al.close()
            store.close()

    j, t = both(run, tmp_path)
    assert t == j
    (code, doc), subs, near, far = t[:4]
    assert code == 200 and doc["mode"] == "batch" and len(doc["aoi"]) == 4
    assert subs[0]["mode"] == "batch" and subs[0]["max_n"] == 5
    assert near == [subs[0]["id"]] and far == []
    assert [c for c, _ in t[4:8]] == [400, 400, 200, 400]
    assert [s["mode"] for s in t[8]] == ["batch", "digest"]


def test_fanout_slo_objective_in_default_budget():
    for P in PKGS:
        kind, metric, stat, _ = P.slo.OBJECTIVES["fanout_p99"]
        assert (kind, metric, stat) == \
            ("histogram", "fanout_completion_seconds", "p99")
        budgets = {b["name"]: b
                   for b in P.slo.parse_budget_spec(P.slo.DEFAULT_BUDGET_SPEC)}
        assert budgets["fanout_p99"]["threshold"] == 30.0
        assert budgets["fanout_p99"]["window_sec"] == 7 * 86400.0


def test_fanout_knobs_validate_and_parse():
    bads = (dict(fanout_shard_prefix=0), dict(fanout_shard_prefix=12),
            dict(fanout_max_cells=3), dict(fanout_park_after=0),
            dict(fanout_park_base_sec=2.0, fanout_park_cap_sec=1.0),
            dict(fanout_poll_sec=0.0))
    env = {"FIREBIRD_FANOUT": "0", "FIREBIRD_FANOUT_SHARD_PREFIX": "3",
           "FIREBIRD_FANOUT_PARK_AFTER": "5", "FIREBIRD_FANOUT_POLL": "0.5",
           "FIREBIRD_FANOUT_MAX_CELLS": "16"}
    seen = []
    for P in PKGS:
        msgs = []
        for bad in bads:
            with pytest.raises(ValueError) as ei:
                P.Config(store_backend="memory", **bad)
            msgs.append(str(ei.value))
        cfg = P.Config.from_env(env)
        seen.append((msgs, cfg.fanout_enabled, cfg.fanout_shard_prefix,
                     cfg.fanout_park_after, cfg.fanout_poll_sec,
                     cfg.fanout_max_cells))
    assert seen[1] == seen[0]
    assert seen[1][1:] == (False, 3, 5, 0.5, 16)

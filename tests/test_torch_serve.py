"""The port's serving layer against the JAX package's, on the CPU.

The port keeps its own copies of ``serve/cache.py``, ``serve/flight.py``
and ``serve/api.py``.  Here, the cases of tests/test_serve.py, each run
on both packages over the same store frames (segment rows made from a
seed with numpy) and held to each other: the two-tier cache and its
spill files, generations, single-flight, admission control, degraded
mode, compute-on-miss, and the HTTP surface, where status codes, JSON
bodies, ``.npy`` bodies and ETags must be equal.  Beyond JAX's cases:
the change-alert endpoints answer as JAX's do with an alert log and
without one (tests/test_torch_alert_feed.py holds the feed case for
case); the ``serve`` fault scope answers 503; and a cold ``cover`` miss
computes on the host without loading torch.
"""

import concurrent.futures
import io
import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from firebird_tpu import products as jproducts
from firebird_tpu.config import Config as JConfig
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu.retry import CircuitBreaker as JBreaker
from firebird_tpu.serve import api as japi
from firebird_tpu.serve import cache as jcache
from firebird_tpu.serve import flight as jflight
from firebird_tpu.store import AsyncWriter as JAsyncWriter
from firebird_tpu.store import open_store as jopen_store
from firebird_tpu.utils import dates as jdt
from firebird_tpu_torch import grid
from firebird_tpu_torch import products as tproducts
from firebird_tpu_torch.config import Config as TConfig
from firebird_tpu_torch.obs import metrics as tmetrics
from firebird_tpu_torch.retry import CircuitBreaker as TBreaker
from firebird_tpu_torch.serve import api as tapi
from firebird_tpu_torch.serve import cache as tcache
from firebird_tpu_torch.serve import flight as tflight
from firebird_tpu_torch.store import AsyncWriter as TAsyncWriter
from firebird_tpu_torch.store import open_store as topen_store

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The chip containing projection point (100, 200), as JAX's tests.
CX, CY = (int(v) for v in grid.snap(100, 200)["chip"]["proj-pt"])
DATE = "1996-01-01"
CHIP_M = 3000

# One namespace a package: the same scenario runs on each.
JAX = types.SimpleNamespace(
    name="jax", api=japi, cache=jcache, flight=jflight, metrics=jmetrics,
    products=jproducts, Config=JConfig, Breaker=JBreaker,
    open_store=jopen_store, AsyncWriter=JAsyncWriter)
PORT = types.SimpleNamespace(
    name="torch", api=tapi, cache=tcache, flight=tflight, metrics=tmetrics,
    products=tproducts, Config=TConfig, Breaker=TBreaker,
    open_store=topen_store, AsyncWriter=TAsyncWriter)
PKGS = (JAX, PORT)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fresh_metrics():
    """Serve counters are asserted absolutely: each package's registry
    starts empty."""
    jmetrics.reset_registry()
    tmetrics.reset_registry()
    yield
    jmetrics.reset_registry()
    tmetrics.reset_registry()


def seg_frame(cx=CX, cy=CY, chprob=1.0, n=3, seed=0, curqa=None):
    """A segment frame for chip (cx, cy): n pixels on row 1, one row
    each, dates drawn from ``seed`` with numpy (JAX's tests use the same
    shape with fixed values; curqa defaults to theirs for n == 3)."""
    rng = np.random.default_rng(seed)
    s0 = int(rng.integers(0, 60))
    e0 = int(rng.integers(0, 60))
    b0 = int(rng.integers(0, 60))
    sday = jdt.to_iso(jdt.to_ordinal("1995-01-01") + s0)
    eday = jdt.to_iso(jdt.to_ordinal("1999-01-01") + e0)
    bday = jdt.to_iso(jdt.to_ordinal("1997-06-01") + b0)
    if curqa is None:
        curqa = [4, 8, 4][:n] + [int(v) for v in
                                 rng.integers(1, 16, max(n - 3, 0))]
    return {
        "cx": [cx] * n, "cy": [cy] * n,
        "px": [cx + 30 * i for i in range(n)],
        "py": [cy - 30] * n,
        "sday": [sday] * n, "eday": [eday] * n,
        "bday": [bday] * n, "chprob": [chprob] * n,
        "curqa": list(curqa)[:n],
        "rfrawp": [None] * n,
    }


def make_service(P, store=None, **kw):
    store = store or P.open_store("memory", "", "t")
    cfg = P.Config(store_backend="memory")
    return P.api.ServeService(store, cfg, **kw), store


def both(scenario, *args):
    """``scenario(P, *args)`` on JAX's package, then the port's; the two
    results, which the caller holds equal."""
    out = []
    for P in PKGS:
        jmetrics.reset_registry()
        tmetrics.reset_registry()
        out.append(scenario(P, *args))
    return out


def put_product(store, name, date, cx, cy, cells):
    col = np.empty(1, object)
    col[0] = np.asarray(cells, np.int32).tolist()
    store.write("product", {"name": [name], "date": [date], "cx": [cx],
                            "cy": [cy], "cells": col})


# ---------------------------------------------------------------------------
# Cache: LRU, spill, generations
# ---------------------------------------------------------------------------

def test_lru_eviction_order(fresh_metrics):
    def run(P):
        c = P.cache.LRUCache(max_entries=2)
        c.put(("a",), 1)
        c.put(("b",), 2)
        touched = c.get(("a",))
        c.put(("c",), 3)
        got = (touched, c.get(("b",)), c.get(("a",)), c.get(("c",)))
        with pytest.raises(ValueError):
            P.cache.LRUCache(max_entries=0)
        return got, [P.metrics.counter(n).value for n in (
            "serve_cache_evictions", "serve_cache_misses",
            "serve_cache_hits")]

    j, t = both(run)
    assert j == t == ((1, None, 1, 3), [1, 1, 3])


def test_disk_spill_round_trip(tmp_path, fresh_metrics):
    """The spill tier's files are JAX's (names sha256(repr(key))[:32],
    ``.npy`` arrays, ``.json`` frames): a spill directory either package
    wrote, the other promotes from."""
    arr = np.random.default_rng(1).integers(-50, 50, 6).astype(np.int32)
    frame = {"px": [1, 2], "sday": ["1995-01-01", "1995-01-01"]}

    def run(P, d):
        c = P.cache.LRUCache(max_entries=1, spill_dir=str(d))
        c.put(("raster",), arr)
        c.put(("frame",), frame)
        got = c.get(("raster",))
        ok = isinstance(got, np.ndarray) and (got == arr).all()
        return ok, c.get(("frame",)), P.metrics.counter(
            "serve_cache_disk_hits").value, sorted(os.listdir(d))

    j = run(JAX, tmp_path / "j")
    tmetrics.reset_registry()
    t = run(PORT, tmp_path / "t")
    assert j == t and j[0] and j[1] == frame and j[2] == 2
    for n in j[3]:
        assert (tmp_path / "j" / n).read_bytes() == \
            (tmp_path / "t" / n).read_bytes(), n
    # Crossing: a fresh cache of each package reads the other's files.
    for P, d in ((PORT, "j"), (JAX, "t")):
        c = P.cache.LRUCache(max_entries=1, spill_dir=str(tmp_path / d))
        assert (c.get(("raster",)) == arr).all()


def test_generations_bump_per_chip_and_table():
    def run(P):
        g = P.cache.StoreGenerations()
        out = [g.gen("segment", 1, 2)]
        g.bump_frame("segment", {"cx": [1, 1, 5], "cy": [2, 2, 6]})
        out += [g.gen("segment", 1, 2), g.gen("segment", 5, 6),
                g.gen("segment", 9, 9)]
        g.bump_frame("tile", {"tx": [7], "ty": [8], "name": ["rf"]})
        out.append(g.table_gen("tile"))
        g.bump_table("segment")
        out.append(g.gen("segment", 9, 9))
        return out

    j, t = both(run)
    assert j == t == [0, 1, 1, 0, 1, 1]


def test_watched_store_invalidates_serve_cache(fresh_metrics):
    def run(P):
        svc, store = make_service(P)
        watched = svc.watched_store()
        watched.write("segment", seg_frame(chprob=0.0))
        first = svc.segments(CX, CY)
        cached = svc.segments(CX, CY) is first
        watched.write("segment", seg_frame(chprob=1.0))
        return first["chprob"], cached, svc.segments(CX, CY)["chprob"]

    j, t = both(run)
    assert j == t == ([0.0] * 3, True, [1.0] * 3)


# ---------------------------------------------------------------------------
# Flight: coalescing, admission, deadline
# ---------------------------------------------------------------------------

def test_single_flight_coalesces(fresh_metrics):
    def run(P):
        sf = P.flight.SingleFlight()
        calls = []

        def compute():
            calls.append(1)
            deadline = time.monotonic() + 10
            while (P.metrics.counter("serve_coalesced_waits").value < 3
                   and time.monotonic() < deadline):
                time.sleep(0.002)
            return "value"

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            results = [f.result() for f in
                       [ex.submit(sf.do, "k", compute) for _ in range(4)]]
        waits = P.metrics.counter("serve_coalesced_waits").value
        again = sf.do("k", compute)
        return results, waits, again, len(calls)

    j, t = both(run)
    assert j == t == (["value"] * 4, 3, "value", 2)


def test_single_flight_shares_leader_error():
    def run(P):
        sf = P.flight.SingleFlight()
        gate = threading.Barrier(2, timeout=10)

        def boom():
            raise RuntimeError("leader failed")

        def request():
            gate.wait()
            return sf.do("k", boom)

        errs = []
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            for f in [ex.submit(request) for _ in range(2)]:
                try:
                    f.result()
                except RuntimeError as e:
                    errs.append(str(e))
        return errs

    j, t = both(run)
    assert j == t == ["leader failed"] * 2


def test_admission_sheds_and_deadlines(fresh_metrics):
    def run(P):
        ac = P.flight.AdmissionControl(max_inflight=1, max_queue=1,
                                       deadline_sec=0.5)
        release, inside = threading.Event(), threading.Event()

        def hold():
            with ac:
                inside.set()
                release.wait(10)

        t = threading.Thread(target=hold, daemon=True)
        t.start()
        assert inside.wait(5)
        errs: list = []

        def attempt():
            try:
                with ac:
                    pass
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=attempt, daemon=True)
                   for _ in range(2)]
        for a in threads:
            a.start()
        for a in threads:
            a.join(10)
        release.set()
        t.join(5)
        shed = next(e for e in errs if isinstance(e, P.flight.Overload))
        return (sorted(type(e).__name__ for e in errs),
                shed.retry_after_sec,
                P.metrics.counter("serve_rejected_total").value >= 1,
                P.metrics.counter("serve_deadline_exceeded_total").value >= 1)

    j, t = both(run)
    assert j == t == (["DeadlineExceeded", "Overload"], 0.25, True, True)


def test_admission_zero_queue_still_serves(fresh_metrics):
    def run(P):
        ac = P.flight.AdmissionControl(max_inflight=2, max_queue=0,
                                       deadline_sec=0.2)
        with ac:
            with ac:
                pass
        release, inside = threading.Event(), threading.Event()

        def hold():
            with ac:
                with ac:
                    inside.set()
                    release.wait(10)

        t = threading.Thread(target=hold, daemon=True)
        t.start()
        assert inside.wait(5)
        try:
            with ac:
                pass
            shed = False
        except P.flight.Overload:
            shed = True
        release.set()
        t.join(5)
        return shed

    assert both(run) == [True, True]


def test_admission_burst_onto_free_slots_never_sheds(fresh_metrics):
    def run(P):
        ac = P.flight.AdmissionControl(max_inflight=8, max_queue=1,
                                       deadline_sec=1.0)
        gate = threading.Barrier(6, timeout=10)
        errs: list = []

        def req():
            gate.wait()
            try:
                with ac:
                    pass
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=req, daemon=True)
                   for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        return errs, P.metrics.counter("serve_rejected_total").value

    assert both(run) == [([], 0), ([], 0)]


def test_spill_dir_is_bounded(tmp_path, fresh_metrics):
    def run(P):
        d = tmp_path / P.name
        c = P.cache.LRUCache(max_entries=1, spill_dir=str(d),
                             spill_max_files=3)
        for gen in range(10):
            c.put(("raster", gen), np.arange(4, dtype=np.int32))
        return len([n for n in os.listdir(d) if n.endswith(".npy")])

    j, t = both(run)
    assert j == t and t <= 3


def test_spill_trim_is_lru_by_access(tmp_path, fresh_metrics):
    def run(P):
        d = tmp_path / P.name
        c = P.cache.LRUCache(max_entries=1, spill_dir=str(d),
                             spill_max_files=2)
        hot = ("hot-tile",)
        c.put(hot, np.arange(8, dtype=np.int32))
        c.put(("cold", 0), np.zeros(1, np.int32))
        time.sleep(0.05)
        c.put(("cold", 1), np.zeros(1, np.int32))
        time.sleep(0.05)
        got = c.get(hot)
        c.clear()
        again = c.get(hot)
        return (int(got[3]), isinstance(again, np.ndarray),
                len([n for n in os.listdir(d) if n.endswith(".npy")]) <= 2,
                sorted(os.listdir(d)))

    j, t = both(run)
    assert j == t and j[:3] == (3, True, True)


# ---------------------------------------------------------------------------
# Service: queries, compute-on-miss, degraded mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["seglength", "ccd", "curveqa"])
def test_product_raster_matches_chip_product_and_persists(name,
                                                          fresh_metrics):
    frame = seg_frame(n=7, seed=3)

    def run(P):
        svc, store = make_service(P)
        store.write("segment", frame)
        got = svc.product_raster(name, DATE, CX, CY)
        rows = store.read("product", {"name": name, "date": DATE,
                                      "cx": CX, "cy": CY})
        computes = P.metrics.counter("serve_product_computes").value
        svc.product_raster(name, DATE, CX, CY)
        return (got, rows["cells"][0],
                computes, P.metrics.counter("serve_product_computes").value)

    (jg, jrow, jc, jc2), (tg, trow, tc, tc2) = both(run)
    want = jproducts.chip_product(name, jdt.to_ordinal(DATE), CX, CY, frame)
    assert tg.dtype == jg.dtype == np.int32
    assert np.array_equal(tg, jg) and np.array_equal(tg, want)
    assert trow == jrow == want.tolist()
    assert (jc, jc2) == (tc, tc2) == (1, 1)


def test_stored_product_row_wins_over_compute(fresh_metrics):
    stored = np.random.default_rng(5).integers(0, 16, 10000)

    def run(P):
        svc, store = make_service(P)
        store.write("segment", seg_frame())
        put_product(store, "curveqa", DATE, CX, CY, stored)
        return (svc.product_raster("curveqa", DATE, CX, CY),
                P.metrics.counter("serve_product_computes").value)

    (jg, jc), (tg, tc) = both(run)
    assert np.array_equal(jg, tg) and np.array_equal(tg, stored)
    assert jc == tc == 0


def test_compute_on_miss_disabled_404s():
    def run(P):
        svc, store = make_service(P, compute_on_miss=False)
        store.write("segment", seg_frame())
        with pytest.raises(P.api.NotFound) as e:
            svc.product_raster("seglength", DATE, CX, CY)
        return str(e.value)

    j, t = both(run)
    assert j == t


def test_bad_product_and_date_are_400s():
    def run(P):
        svc, _ = make_service(P)
        msgs = []
        for name, date in (("nope", DATE), ("seglength", "not-a-date")):
            with pytest.raises(P.api.BadRequest) as e:
                svc.product_raster(name, date, CX, CY)
            msgs.append(str(e.value))
        return msgs

    j, t = both(run)
    assert j == t


def test_no_segments_is_404():
    def run(P):
        svc, _ = make_service(P)
        with pytest.raises(P.api.NotFound) as e:
            svc.product_raster("seglength", DATE, CX, CY)
        return str(e.value)

    j, t = both(run)
    assert j == t


def test_pixel_values(fresh_metrics):
    rng = np.random.default_rng(11)
    frame = seg_frame(n=40, seed=11)
    points = [(CX + float(rng.uniform(0, CHIP_M)),
               CY - float(rng.uniform(0, 60))) for _ in range(6)]

    def run(P):
        svc, store = make_service(P)
        store.write("segment", frame)
        return [svc.pixel(x, y, DATE) for x, y in points]

    j, t = both(run)
    assert j == t
    svc, store = make_service(PORT)
    store.write("segment", seg_frame())
    out = svc.pixel(CX + 35.0, CY - 35.0, DATE)
    assert out["pixel"] == {"row": 1, "col": 1}
    assert out["products"]["curveqa"] == 8
    assert out["products"]["cover"] is None


class Flaky:
    """Store whose reads can be switched to fail."""

    def __init__(self, inner):
        self.inner = inner
        self.broken = False

    def read(self, table, where=None):
        if self.broken:
            raise OSError("store down")
        return self.inner.read(table, where)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_degraded_mode_serves_cache_only(fresh_metrics):
    def run(P):
        inner = P.open_store("memory", "", "t")
        inner.write("segment", seg_frame())
        inner.write("segment", seg_frame(cx=CX + CHIP_M))
        flaky = Flaky(inner)
        breaker = P.Breaker(1, cooldown_sec=60.0, name="serve-store")
        svc, _ = make_service(P, store=flaky, breaker=breaker)
        warm = svc.segments(CX, CY)
        out = [svc.degraded()]
        flaky.broken = True
        with pytest.raises(P.api.StoreError):
            svc.segments(CX + CHIP_M, CY)
        out.append(svc.degraded())
        out.append(svc.segments(CX, CY) is warm)
        with pytest.raises(P.flight.StoreDegraded):
            svc.segments(CX + 2 * CHIP_M, CY)
        out.append(P.metrics.counter("serve_degraded_misses_total").value)
        flaky.broken = False
        breaker._opened_at = -1e9
        out.append(svc.segments(CX + CHIP_M, CY)["chprob"])
        out.append(svc.degraded())
        return out

    j, t = both(run)
    assert j == t == [False, True, True, 1, [1.0] * 3, False]


def test_compute_error_does_not_open_breaker(fresh_metrics, monkeypatch):
    def run(P):
        svc, store = make_service(
            P, breaker=P.Breaker(1, cooldown_sec=60.0, name="serve-store"))
        store.write("segment", seg_frame())

        def boom(*a, **kw):
            raise RuntimeError("stale rfrawp vs retrained model")

        monkeypatch.setattr(P.products, "save_chip_raster", boom)
        with pytest.raises(RuntimeError, match="stale rfrawp"):
            svc.product_raster("seglength", DATE, CX, CY)
        return svc.degraded(), svc.segments(CX, CY)["chprob"]

    j, t = both(run)
    assert j == t == (False, [1.0] * 3)


# ---------------------------------------------------------------------------
# HTTP surface: both servers over the same store frames
# ---------------------------------------------------------------------------

def _get(base, path, headers=None):
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        r = urllib.request.urlopen(req, timeout=10)
        return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _settled(metrics, name, want, timeout=5.0):
    """True once counter ``name`` reads ``want`` (a handler bumps its
    counters after the response went out, so a client can read the
    answer first)."""
    end = time.monotonic() + timeout
    while metrics.counter(name).value != want and time.monotonic() < end:
        time.sleep(0.005)
    return metrics.counter(name).value == want


def _post(base, path):
    req = urllib.request.Request(base + path, data=b"", method="POST")
    try:
        r = urllib.request.urlopen(req, timeout=10)
        return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def served(fresh_metrics):
    """A JAX and a port server, each over its own memory store holding
    the same segment frame: {"jax": (svc, store, base), "torch": ...}."""
    out, srvs = {}, []
    for P in PKGS:
        svc, store = make_service(P)
        store.write("segment", seg_frame())
        srv = P.api.start_serve_server(0, svc, host="127.0.0.1")
        srvs.append(srv)
        out[P.name] = (svc, store, f"http://127.0.0.1:{srv.port}")
    yield out
    for srv in srvs:
        srv.close()


def _same(served, path, headers=None):
    """(code, body, headers) of both servers for one request, held
    equal: status, body bytes and the edge headers."""
    j = _get(served["jax"][2], path, headers)
    t = _get(served["torch"][2], path, headers)
    assert t[0] == j[0], (path, t[0], j[0], t[1][:200])
    if j[2].get("Content-Type", "").startswith("application/json"):
        assert json.loads(t[1]) == json.loads(j[1]), path
    else:
        assert t[1] == j[1], path
    for h in ("ETag", "Cache-Control", "Content-Type", "X-Firebird-Chip",
              "X-Firebird-Product", "X-Firebird-Date", "X-Firebird-Ulx",
              "X-Firebird-Uly", "X-Firebird-Quadkey",
              "X-Firebird-Tile-Version", "Retry-After"):
        assert t[2].get(h) == j[2].get(h), (path, h)
    return t


def test_http_endpoints_roundtrip(served):
    code, body, _ = _same(served, "/healthz")
    assert (code, body) == (200, b"ok\n")
    code, body, _ = _same(served, "/v1/products")
    assert json.loads(body)["products"] == list(jproducts.PRODUCTS)
    code, body, _ = _same(served, f"/v1/segments?cx={CX}&cy={CY}")
    doc = json.loads(body)
    assert code == 200 and doc["n"] == 3
    assert doc["segments"]["curqa"] == [4, 8, 4]
    code, body, h = _same(
        served, f"/v1/product/curveqa?cx={CX}&cy={CY}&date={DATE}")
    assert code == 200 and sum(json.loads(body)["cells"]) == 16
    assert h["ETag"].startswith('"p-curveqa-')
    code, body, h = _same(
        served, f"/v1/product/curveqa?cx={CX}&cy={CY}&date={DATE}"
                "&format=npy")
    arr = np.load(io.BytesIO(body))
    assert arr.shape == (100, 100) and int(arr.sum()) == 16
    assert h["X-Firebird-Chip"] == f"{CX},{CY}"
    for name in ("jax", "torch"):
        code, body, _ = _get(served[name][2], "/metrics")
        assert code == 200
        assert b"firebird_serve_request_seconds" in body
        assert b"firebird_serve_requests_total" in body


def test_http_errors(served):
    for path in ("/v1/segments?cx=1", "/v1/product/nope?cx=1&cy=2&date="
                 + DATE, f"/v1/product/ccd?cx=1&cy=2&date={DATE}",
                 "/nope", f"/v1/product/ccd?cx={CX}&cy={CY}&date={DATE}"
                 "&format=tiff", f"/v1/tile/ccd?date={DATE}"):
        _same(served, path)
    # The handler counts after its response is out: let both settle.
    assert _settled(jmetrics, "serve_errors_total", 5)
    assert _settled(tmetrics, "serve_errors_total", 5)
    code, body, _ = _get(served["torch"][2], "/v1/segments?cx=1")
    assert code == 400 and b"cy" in body
    code, body, _ = _get(served["torch"][2], "/nope")
    assert code == 404 and b"paths" in body


def test_http_coalesced_cold_miss(served):
    """8 concurrent identical cold requests -> ONE computation, in each
    package, with equal bodies."""
    path = f"/v1/product/seglength?cx={CX}&cy={CY}&date={DATE}"
    bodies = {}
    for name in ("jax", "torch"):
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            res = [f.result() for f in
                   [ex.submit(_get, served[name][2], path)
                    for _ in range(8)]]
        assert [r[0] for r in res] == [200] * 8
        assert len({r[1] for r in res}) == 1
        bodies[name] = res[0][1]
    assert json.loads(bodies["jax"]) == json.loads(bodies["torch"])
    assert jmetrics.counter("serve_product_computes").value == 1
    assert tmetrics.counter("serve_product_computes").value == 1


def test_request_trace_ids_survive_coalescing(served):
    path = f"/v1/product/ccd?cx={CX}&cy={CY}&date={DATE}"
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        results = [f.result() for f in
                   [ex.submit(_get, served["torch"][2], path)
                    for _ in range(8)]]
    assert [code for code, _, _ in results] == [200] * 8
    assert tmetrics.counter("serve_product_computes").value == 1
    ids = [headers["X-Firebird-Trace"] for _, _, headers in results]
    assert all(i.startswith("req-") and len(i) == 16 for i in ids)
    assert len(set(ids)) == 8
    snap = tmetrics.histogram("serve_request_seconds").snapshot()
    assert any(e["batch"].startswith("req-")
               for e in snap.get("exemplars", ()))
    # JAX's server mints the same shape of id
    _, _, h = _get(served["jax"][2], path)
    assert h["X-Firebird-Trace"].startswith("req-")
    assert len(h["X-Firebird-Trace"]) == 16


def test_inbound_trace_header_adopted(served):
    base = served["torch"][2]
    path = f"/v1/segments?cx={CX}&cy={CY}"
    for name in ("jax", "torch"):
        _, _, h = _get(served[name][2], path,
                       {"X-Firebird-Trace": "scene/LC08_X/aa11"})
        assert h["X-Firebird-Trace"] == "scene/LC08_X/aa11"
        for bad in ("has spaces", "x" * 161):
            _, _, h = _get(served[name][2], path,
                           {"X-Firebird-Trace": bad})
            assert h["X-Firebird-Trace"].startswith("req-")
    cold = f"/v1/product/ccd?cx={CX}&cy={CY}&date={DATE}"
    sent = [f"client/{i:02d}/ffee" for i in range(8)]
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        results = [f.result() for f in
                   [ex.submit(_get, base, cold, {"X-Firebird-Trace": s})
                    for s in sent]]
    assert [code for code, _, _ in results] == [200] * 8
    assert tmetrics.counter("serve_product_computes").value == 1
    assert [h["X-Firebird-Trace"] for _, _, h in results] == sent


def test_http_degraded_healthz(fresh_metrics):
    bodies = []
    for P in PKGS:
        svc, _ = make_service(
            P, breaker=P.Breaker(1, cooldown_sec=60.0, name="serve-store"))
        svc.breaker.record_failure()
        srv = P.api.start_serve_server(0, svc, host="127.0.0.1")
        try:
            bodies.append(_get(f"http://127.0.0.1:{srv.port}",
                               "/healthz")[:2])
        finally:
            srv.close()
    assert bodies == [(200, b"degraded\n")] * 2


def test_tile_mosaic_json(served):
    for fmt in ("json", "npy"):
        code, body, h = _same(
            served, f"/v1/tile/curveqa?bounds={CX + 1},{CY - 1}"
                    f"&bounds={CX + CHIP_M + 1},{CY - 1}&date={DATE}"
                    f"&format={fmt}")
        assert code == 200 and h["ETag"].startswith('"t-')
    doc = json.loads(_same(
        served, f"/v1/tile/curveqa?bounds={CX + 1},{CY - 1}&date={DATE}"
                "&format=json")[1])
    assert doc["shape"] == [100, 100]
    assert doc["ulx"] == CX and doc["uly"] == CY
    assert int(np.asarray(doc["cells"]).sum()) == 16


def test_alert_endpoints_answer_404_naming_the_feed(served, tmp_path):
    """The change-alert feed: over a store with an alert log, /v1/alerts,
    its SSE stream (a bad date, refused before the stream opens), its
    webhook list and a webhook registration answer as JAX's do, and count
    as /v1 requests; with the log absent, both packages answer 404 with
    JAX's text, which names no module of the port."""
    import shutil

    from firebird_tpu.alerts import AlertFeed as JFeed
    from firebird_tpu.alerts import AlertLog as JLog
    from firebird_tpu_torch.alerts import AlertFeed as TFeed
    from firebird_tpu_torch.alerts import AlertLog as TLog

    rng = np.random.default_rng(4)
    src = str(tmp_path / "alerts.db")
    al = JLog(src)
    al.append([{"cx": CX, "cy": CY, "px": CX + 30 * int(rng.integers(100)),
                "py": CY - 30 * int(rng.integers(100)),
                "break_day": float(730000 + 16 * i)} for i in range(4)])
    al.close()
    srvs, bases = [], {}
    for P, Log, Feed in ((JAX, JLog, JFeed), (PORT, TLog, TFeed)):
        db = str(tmp_path / f"{P.name}.db")
        shutil.copy(src, db)
        svc, _ = make_service(P, alerts=Feed(Log(db), P.Config(
            store_backend="memory")))
        srv = P.api.start_serve_server(0, svc, host="127.0.0.1")
        srvs.append((srv, svc))
        bases[P.name] = f"http://127.0.0.1:{srv.port}"
    try:
        for path in ("/v1/alerts", "/v1/alerts?since=2&limit=1",
                     "/v1/alerts/stream?t0=garbage", "/v1/alerts/webhooks"):
            j, t = (_get(bases[n], path) for n in ("jax", "torch"))
            assert t[0] == j[0] and json.loads(t[1]) == json.loads(j[1]), path
        code, body = _post(bases["torch"],
                           "/v1/alerts/webhooks?url=http://x/hook&since=1")
        assert (code, json.loads(body)) == (lambda r: (r[0], json.loads(
            r[1])))(_post(bases["jax"],
                          "/v1/alerts/webhooks?url=http://x/hook&since=1"))
        assert code == 200 and json.loads(body)["latest"] == 4
        assert _settled(tmetrics, "serve_requests_total", 5)
        assert _settled(tmetrics, "serve_errors_total", 1)
        assert tmetrics.counter("serve_requests_alerts_stream").value == 1
    finally:
        for srv, svc in srvs:
            srv.close()
            svc.alerts.close()
    tmetrics.reset_registry()
    base = served["torch"][2]
    for path in ("/v1/alerts", "/v1/alerts?since=0",
                 "/v1/alerts/stream", "/v1/alerts/webhooks"):
        code, body, _ = _get(base, path)
        jcode, jbody, _ = _get(served["jax"][2], path)
        assert code == jcode == 404, path
        assert json.loads(body) == json.loads(jbody), path
        assert "alerts/feed.py" not in json.loads(body)["error"], path
    code, body = _post(base, "/v1/alerts/webhooks?url=http://x/hook")
    jcode, jbody = _post(served["jax"][2],
                         "/v1/alerts/webhooks?url=http://x/hook")
    assert code == jcode == 404 and json.loads(body) == json.loads(jbody)
    assert _settled(tmetrics, "serve_requests_total", 5)
    assert _settled(tmetrics, "serve_errors_total", 5)
    assert tmetrics.counter("serve_requests_alerts_stream").value == 1


def test_serve_fault_scope_answers_503(fresh_metrics):
    """FIREBIRD_FAULTS naming the ``serve`` scope fires on every /v1
    request before admission: 503 in both packages."""
    codes = []
    for P in PKGS:
        cfg = P.Config(store_backend="memory", faults="serve:p=1")
        store = P.open_store("memory", "", "t")
        store.write("segment", seg_frame())
        svc = P.api.ServeService(store, cfg)
        srv = P.api.start_serve_server(0, svc, host="127.0.0.1")
        try:
            base = f"http://127.0.0.1:{srv.port}"
            codes.append((_get(base, f"/v1/segments?cx={CX}&cy={CY}")[0],
                          _get(base, "/healthz")[0]))
        finally:
            srv.close()
    assert codes == [(503, 200)] * 2


# ---------------------------------------------------------------------------
# Read-under-write: serve reads while an AsyncWriter flushes (sqlite)
# ---------------------------------------------------------------------------

def test_serve_reads_under_async_writer_never_torn(tmp_path):
    store = topen_store("sqlite", str(tmp_path / "rw.db"), "t")
    n = 40
    frames = [seg_frame(chprob=float(v), n=n) for v in (0.0, 1.0)]
    store.write("segment", frames[0])
    stop = threading.Event()
    torn: list = []
    svc = tapi.ServeService(store, TConfig(store_backend="memory"))

    def reader():
        while not stop.is_set():
            got = store.read("segment", {"cx": CX, "cy": CY})
            vals = set(got["chprob"])
            if len(got["px"]) != n or len(vals) != 1 or vals - {0.0, 1.0}:
                torn.append((len(got["px"]), vals))
                return

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    writer = TAsyncWriter(svc.watched_store())
    try:
        for i in range(60):
            writer.write("segment", frames[i % 2], key=(CX, CY))
            if i % 10 == 9:
                writer.flush()
    finally:
        writer.close()
        stop.set()
        for t in threads:
            t.join(10)
    assert not torn, f"torn read frames observed: {torn[:3]}"
    # the last write (i = 59: chprob 1.0) is what the service serves
    assert svc.segments(CX, CY)["chprob"] == [1.0] * n
    store.close()


def test_service_over_sqlite_sees_writer_results(tmp_path, fresh_metrics):
    def run(P):
        store = P.open_store("sqlite", str(tmp_path / f"{P.name}.db"), "t")
        svc = P.api.ServeService(store, P.Config(store_backend="memory"))
        writer = P.AsyncWriter(svc.watched_store())
        try:
            writer.write("segment", seg_frame(chprob=0.0), key=(CX, CY))
            writer.flush()
            first = svc.segments(CX, CY)["chprob"]
            writer.write("segment", seg_frame(chprob=1.0), key=(CX, CY))
            writer.flush()
            return first, svc.segments(CX, CY)["chprob"]
        finally:
            writer.close()
            store.close()

    j, t = both(run)
    assert j == t == ([0.0] * 3, [1.0] * 3)


def test_serve_config_validation():
    assert TConfig().serve_port == JConfig().serve_port == 8080
    env = {"FIREBIRD_SERVE_PORT": "9001", "FIREBIRD_SERVE_CACHE_ENTRIES": "7",
           "FIREBIRD_SERVE_CACHE_DIR": "/tmp/x", "FIREBIRD_SERVE_INFLIGHT": "3",
           "FIREBIRD_SERVE_QUEUE": "5", "FIREBIRD_SERVE_DEADLINE": "2.5"}
    fields = ("serve_port", "serve_cache_entries", "serve_cache_dir",
              "serve_inflight", "serve_queue", "serve_deadline_sec")
    for C in (TConfig, JConfig):
        cfg = C.from_env(env=env)
        assert tuple(getattr(cfg, f) for f in fields) == \
            (9001, 7, "/tmp/x", 3, 5, 2.5)
        for bad in ({"serve_port": 0}, {"serve_cache_entries": 0},
                    {"serve_inflight": 0}, {"serve_queue": -1},
                    {"serve_deadline_sec": 0.0}):
            with pytest.raises(ValueError):
                C(**bad)


# ---------------------------------------------------------------------------
# cover: the tile model's class order, read on the host
# ---------------------------------------------------------------------------

def _cover_store(path):
    """A sqlite store at ``path`` with seeded segment rows carrying vote
    vectors and a stored tile model (the port's forest format, which is
    JAX's), for chip (CX, CY)."""
    from firebird_tpu_torch.rf import forest, pipeline

    rng = np.random.default_rng(21)
    classes = np.array([5, 1, 7], np.int64)
    model = forest.RandomForest(
        feature=np.zeros((1, 1), np.int32),
        threshold=np.full((1, 1), np.inf, np.float32),
        leaf_proba=np.full((1, 2, 3), 1 / 3, np.float32), classes=classes)
    frame = seg_frame(n=12, seed=21)
    frame["rfrawp"] = [rng.random(3).tolist() for _ in range(12)]
    store = topen_store("sqlite", path, "t")
    store.write("segment", frame)
    t = grid.tile(CX, CY)
    pipeline.save_model(store, int(t["x"]), int(t["y"]), model)
    store.close()
    return frame, classes


def test_cover_cold_miss_is_jaxs_and_loads_no_torch(tmp_path):
    """A cold ``cover`` miss maps the stored votes through the tile
    model's class order, equal to JAX's, and a serve process computes it
    without loading torch (rf/tilemodel.py reads the order with numpy)."""
    db = str(tmp_path / "cover.db")
    frame, classes = _cover_store(db)
    got = {}
    for P in PKGS:
        store = P.open_store("sqlite", db, "t")
        svc = P.api.ServeService(store, P.Config(store_backend="memory"))
        got[P.name] = svc.product_raster("cover", DATE, CX, CY)
        store.close()
    want = jproducts.chip_product("cover", jdt.to_ordinal(DATE), CX, CY,
                                  frame, classes=classes)
    assert np.array_equal(got["torch"], got["jax"])
    assert np.array_equal(got["torch"], want) and (want != 0).any()
    code = (
        "import sys, numpy as np\n"
        "from firebird_tpu_torch.config import Config\n"
        "from firebird_tpu_torch.serve import api\n"
        "from firebird_tpu_torch.store import open_store\n"
        f"s = open_store('sqlite', {db!r}, 't')\n"
        "svc = api.ServeService(s, Config(store_backend='memory'))\n"
        f"v = svc.product_raster('cover', '1996-02-01', {CX}, {CY})\n"
        "print(int(np.count_nonzero(v)), "
        "[m for m in ('torch', 'firebird_tpu_torch.ccd.kernel') "
        "if m in sys.modules])\n")
    r = subprocess.run([sys.executable, "-c", code],
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    n, loaded = r.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) > 0 and loaded == "[]"

"""The port's quadkey tile pyramid and changefeed against the JAX
package's, on the CPU.

The port keeps its own copies of ``serve/pyramid.py`` and
``serve/changefeed.py`` with the JAX package's formats.  Here, the cases
of tests/test_pyramid.py, each run on both packages over the same store
frames (made from a seed with numpy) and held to each other — the
quadkey/Albers math, tile builds and their files, invalidation, the
product_writes feed and its consumer, ``/v1/pyramid`` with its ETags and
304s, and the fleet ``pyramid`` job — and two kinds of crossing: a
pyramid directory either package built, the other serves (``.npy`` bytes
equal, meta JSON equal key for key), and one changefeed db both packages
append to, consume and checkpoint.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from firebird_tpu.alerts.log import AlertLog as JAlertLog
from firebird_tpu.obs import metrics as jmetrics
from firebird_tpu.serve import changefeed as jcf
from firebird_tpu.serve import pyramid as jpyr
from firebird_tpu.serve.cache import StoreGenerations as JGens
from firebird_tpu_torch import products as tproducts
from firebird_tpu_torch.alerts.log import AlertLog as TAlertLog
from firebird_tpu_torch.ccd.params import FILL_VALUE
from firebird_tpu_torch.config import Config as TConfig
from firebird_tpu_torch.ingest.packer import CHIP_SIDE
from firebird_tpu_torch.obs import metrics as tmetrics
from firebird_tpu_torch.serve import changefeed as tcf
from firebird_tpu_torch.serve import pyramid as tpyr
from firebird_tpu_torch.serve.cache import StoreGenerations as TGens
from firebird_tpu_torch.utils import dates as dt

from test_torch_serve import (CHIP_M, CX, CY, DATE, JAX, PKGS, PORT, _get,
                              both, fresh_metrics, seg_frame)

assert fresh_metrics  # the fixture, shared with the serve tests

JAX.pyr, JAX.cf, JAX.Gens, JAX.AlertLog = jpyr, jcf, JGens, JAlertLog
PORT.pyr, PORT.cf, PORT.Gens, PORT.AlertLog = tpyr, tcf, TGens, TAlertLog
ZB = tpyr.Z_BASE


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_store(P, chips=((CX, CY),), seed=0):
    store = P.open_store("memory", "", "t")
    for i, (cx, cy) in enumerate(chips):
        store.write("segment", seg_frame(cx, cy, n=9, seed=seed + i))
    return store


def tree(root):
    """{relative path: bytes} of a pyramid directory's tile files."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith((".npy", ".json")):
                p = os.path.join(d, n)
                out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def same_tiles(a, b):
    """Two pyramid trees with the same files: ``.npy`` bytes equal, meta
    JSON equal key for key (floats to the bit)."""
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb) and ta
    for rel in ta:
        if rel.endswith(".npy"):
            assert ta[rel] == tb[rel], rel
        else:
            ma, mb = json.loads(ta[rel]), json.loads(tb[rel])
            assert list(ma) == list(mb) and ma == mb, rel
            for k in ("ulx", "uly", "lrx", "lry"):
                assert float(ma["extent"][k]).hex() == \
                    float(mb["extent"][k]).hex(), (rel, k)


# ---------------------------------------------------------------------------
# Quadkey / Albers math
# ---------------------------------------------------------------------------

def test_quadkey_round_trip_every_zoom():
    rng = random.Random(7)
    for z in range(ZB + 1):
        for _ in range(8):
            x, y = rng.randrange(1 << z), rng.randrange(1 << z)
            qk = tpyr.quadkey(z, x, y)
            assert qk == jpyr.quadkey(z, x, y) and len(qk) == z
            assert tpyr.tile_from_quadkey(qk) == (z, x, y)
    assert tpyr.tile_from_quadkey("") == (0, 0, 0)
    for P in PKGS:
        with pytest.raises(ValueError):
            P.pyr.tile_from_quadkey("4")
        with pytest.raises(ValueError):
            P.pyr.quadkey(2, 4, 0)


def test_albers_round_trip_every_zoom():
    rng = random.Random(13)
    for z in range(ZB + 1):
        for _ in range(8):
            x, y = rng.randrange(1 << z), rng.randrange(1 << z)
            ext = tpyr.tile_extent(z, x, y)
            assert ext == jpyr.tile_extent(z, x, y)
            assert all(float(ext[k]).hex() == float(
                jpyr.tile_extent(z, x, y)[k]).hex()
                for k in ("ulx", "uly", "lrx", "lry"))
            assert tpyr.tile_for_point(ext["ulx"], ext["uly"], z) == (x, y)
            assert tpyr.tile_for_point(
                ext["ulx"] + 1.0, ext["uly"] - 1.0, z) == (x, y)
            span = 1 << (ZB - z)
            assert ext["lrx"] - ext["ulx"] == span * CHIP_M
            assert ext["uly"] - ext["lry"] == span * CHIP_M


def test_tile_chip_mapping_and_tree():
    def run(P):
        pyr = P.pyr
        bx, by = pyr.tile_of_chip(CX, CY)
        z, x, y = pyr.parent(ZB, bx, by)
        out = [pyr.chips_of_tile(ZB, bx, by), (z, x, y),
               pyr.children(z, x, y), pyr.ancestors(ZB, bx, by),
               pyr.chips_of_tile(z, x, y)]
        assert all(pyr.tile_of_chip(cx, cy, z) == (x, y)
                   for cx, cy in out[-1])
        with pytest.raises(ValueError, match="quadkey domain"):
            pyr.tile_of_chip(-3_000_000.0, CY)
        return out

    j, t = both(run)
    assert j == t and t[0] == [(CX, CY)] and len(t[3]) == ZB + 1


def test_downsample2x_is_selection():
    cells = np.random.default_rng(2).integers(-9, 99, (100, 100)) \
        .astype(np.int32)
    got = tpyr.downsample2x(cells)
    assert np.array_equal(got, jpyr.downsample2x(cells))
    assert got.flags.c_contiguous and got.shape == (50, 50)
    small = np.arange(16, dtype=np.int32).reshape(4, 4)
    assert tpyr.downsample2x(small).tolist() == [[0, 2], [8, 10]]
    # the pyramid's constants are the detector's and the packer's
    assert (tpyr.FILL_VALUE, tpyr.TILE_SIDE) == (FILL_VALUE, CHIP_SIDE) \
        == (jpyr.FILL_VALUE, jpyr.TILE_SIDE)


# ---------------------------------------------------------------------------
# TilePyramid: build, versioning, invalidation
# ---------------------------------------------------------------------------

def test_base_tile_byte_identical_to_products(tmp_path, fresh_metrics):
    def run(P):
        store = seeded_store(P)
        p = P.pyr.TilePyramid(str(tmp_path / P.name),
                              P.pyr.store_read_chip(store))
        bx, by = P.pyr.tile_of_chip(CX, CY)
        cells, meta = p.tile("curveqa", DATE, ZB, bx, by)
        rows = store.read("product", {"name": "curveqa", "date": DATE,
                                      "cx": CX, "cy": CY})
        built = P.metrics.counter("pyramid_tiles_built").value
        _, meta2 = p.tile("curveqa", DATE, ZB, bx, by)
        return (cells, meta, rows["cells"][0], meta2["version"],
                P.metrics.counter("pyramid_tiles_built").value - built,
                P.metrics.counter("pyramid_tile_hits").value >= 1)

    j, t = both(run)
    want = tproducts.chip_product(
        "curveqa", dt.to_ordinal(DATE), CX, CY, seg_frame(n=9, seed=0))
    assert np.array_equal(t[0].ravel(), want) and t[0].dtype == np.int32
    assert np.array_equal(t[0], j[0]) and t[1] == j[1]
    assert t[2] == j[2] == want.tolist()
    assert t[3:] == j[3:] == (1, 0, True)
    same_tiles(tmp_path / "jax", tmp_path / "torch")


def test_parent_downsamples_children(tmp_path, fresh_metrics):
    def run(P):
        store = seeded_store(P)
        p = P.pyr.TilePyramid(str(tmp_path / P.name),
                              P.pyr.store_read_chip(store))
        bx, by = P.pyr.tile_of_chip(CX, CY)
        base, _ = p.tile("curveqa", DATE, ZB, bx, by)
        z, x, y = P.pyr.parent(ZB, bx, by)
        cells, meta = p.tile("curveqa", DATE, z, x, y)
        half = P.pyr.TILE_SIDE // 2
        dx, dy = bx - 2 * x, by - 2 * y
        quad = cells[dy * half:(dy + 1) * half, dx * half:(dx + 1) * half]
        other = cells[(1 - dy) * half:(2 - dy) * half,
                      dx * half:(dx + 1) * half]
        assert np.array_equal(quad, P.pyr.downsample2x(base))
        assert (other == FILL_VALUE).all()
        return cells, meta

    j, t = both(run)
    assert np.array_equal(j[0], t[0]) and j[1] == t[1]
    same_tiles(tmp_path / "jax", tmp_path / "torch")


def test_invalidation_is_surgical_and_versions_rise(tmp_path,
                                                    fresh_metrics):
    chips = [(CX, CY), (CX + CHIP_M, CY)]

    def run(P):
        store = seeded_store(P, chips)
        p = P.pyr.TilePyramid(str(tmp_path / P.name),
                              P.pyr.store_read_chip(store))
        t0, t1 = (P.pyr.tile_of_chip(*c) for c in chips)
        for bx, by in (t0, t1):
            p.tile("curveqa", DATE, ZB, bx, by)
        n = p.invalidate_chip(*chips[0])
        out = [n, p.peek_meta("curveqa", DATE, ZB, *t0)["stale"],
               p.peek_meta("curveqa", DATE, ZB, *t1)["stale"]]
        _, meta = p.tile("curveqa", DATE, ZB, *t0)
        out += [meta["version"], meta["stale"],
                P.metrics.counter("pyramid_tiles_dirtied").value,
                p.invalidate_chip(-3_000_000.0, CY)]
        return out

    j, t = both(run)
    assert j == t and t[0] >= 1 and t[1:] == [True, False, 2, False, t[0], 0]


def test_compute_on_miss_depth_floor(tmp_path):
    def run(P):
        p = P.pyr.TilePyramid(str(tmp_path / P.name),
                              P.pyr.store_read_chip(seeded_store(P)))
        with pytest.raises(LookupError, match="not\\s+precomputed"):
            p.tile("curveqa", DATE, 0, 0, 0)
        z = ZB - P.pyr.MAX_MISS_DEPTH
        bx, by = P.pyr.tile_of_chip(CX, CY, z)
        cells, _ = p.tile("curveqa", DATE, z, bx, by)
        return cells

    j, t = both(run)
    assert np.array_equal(j, t) and (t != FILL_VALUE).any()
    same_tiles(tmp_path / "jax", tmp_path / "torch")


def test_build_area_two_levels(tmp_path):
    chips = [(CX + CHIP_M * i, CY - CHIP_M * j)
             for i in range(2) for j in range(2)]
    bounds = [(CX + 1.0, CY - 1.0),
              (CX + 2 * CHIP_M - 1.0, CY - 2 * CHIP_M + 1.0)]

    def run(P):
        p = P.pyr.TilePyramid(str(tmp_path / P.name),
                              P.pyr.store_read_chip(seeded_store(P, chips)))
        first = p.build_area(["curveqa", "seglength"], [DATE], bounds,
                             levels=2)
        again = p.build_area(["curveqa", "seglength"], [DATE], bounds,
                             levels=2)
        st = p.status()
        with pytest.raises(ValueError, match="quadkey domain"):
            p.build_area(["curveqa"], [DATE], [(-3_000_000.0, CY)],
                         levels=1)
        return first, again, st["tiles_by_level"], st["products"]

    j, t = both(run)
    assert j == t
    assert t[0]["chips"] == 4 and t[0]["levels"][str(ZB)]["built"] == 8
    assert t[1]["levels"][str(ZB)]["built"] == 0
    assert t[2][str(ZB)]["tiles"] >= 8
    same_tiles(tmp_path / "jax", tmp_path / "torch")


# ---------------------------------------------------------------------------
# Changefeed: product_writes feed, consumer, replica registry
# ---------------------------------------------------------------------------

def test_product_writes_feed_cursors(tmp_path):
    def run(P):
        feed = P.cf.ProductWrites(str(tmp_path / f"{P.name}.db"))
        try:
            out = [feed.latest_cursor(),
                   feed.append("product", [(CX, CY), (CX + CHIP_M, CY)])]
            recs = feed.since(0)
            out += [[r["id"] for r in recs], recs[0]["table"],
                    feed.since(2)]
            feed.checkpoint("r1", alert_cursor=5, writes_cursor=2)
            feed.checkpoint("r1", alert_cursor=3, writes_cursor=1)
            out += [feed.replica_cursors("r1"),
                    feed.replica_cursors("unknown")]
            reps = feed.replicas()
            out += [len(reps), reps[0]["writes_behind"],
                    sorted(reps[0]), sorted(feed.status())]
            return out
        finally:
            feed.close()

    j, t = both(run)
    assert j == t
    assert t[:7] == [0, 2, [1, 2], "product", [], (5, 2), (0, 0)]


def test_consumer_applies_and_resumes(tmp_path, fresh_metrics):
    def run(P):
        d = tmp_path / P.name
        feed = P.cf.ProductWrites(str(d / "cf.db"))
        gens = P.Gens()
        p = P.pyr.TilePyramid(str(d / "pyr"),
                              P.pyr.store_read_chip(seeded_store(P)))
        bx, by = P.pyr.tile_of_chip(CX, CY)
        p.tile("curveqa", DATE, ZB, bx, by)
        try:
            cons = P.cf.ChangefeedConsumer(gens, feed=feed, pyramid=p,
                                           replica="r1", poll_sec=60)
            feed.append("product", [(CX, CY)])
            out = cons.poll_once()
            res = [out["applied"], out["writes_cursor"],
                   gens.gen("product", CX, CY),
                   p.peek_meta("curveqa", DATE, ZB, bx, by)["stale"],
                   P.metrics.counter("changefeed_records_applied").value,
                   P.metrics.gauge("serve_changefeed_lag_seconds").value >= 0]
            cons2 = P.cf.ChangefeedConsumer(gens, feed=feed, pyramid=p,
                                            replica="r1", poll_sec=60)
            res.append(cons2.poll_once()["applied"])
            cons3 = P.cf.ChangefeedConsumer(P.Gens(), feed=feed,
                                            replica="r2", poll_sec=60)
            res += [cons3.poll_once()["applied"], len(feed.replicas()),
                    sorted(cons3.status())]
            return res
        finally:
            feed.close()

    j, t = both(run)
    assert j == t and t[:9] == [1, 1, 1, True, 1, True, 0, 1, 2]


def test_consumer_tails_alert_log(tmp_path, fresh_metrics):
    def run(P):
        alog = P.AlertLog(str(tmp_path / f"{P.name}_alerts.db"))
        gens = P.Gens()
        try:
            alog.append([{"cx": CX, "cy": CY, "px": CX, "py": CY - 30,
                          "break_day": 728000}])
            cons = P.cf.ChangefeedConsumer(gens, alerts=alog, replica="r1",
                                           poll_sec=60)
            out = cons.poll_once()
            return (out["applied"], out["alert_cursor"],
                    gens.gen("segment", CX, CY), cons.poll_once()["applied"])
        finally:
            alog.close()

    j, t = both(run)
    assert j == t == (1, 1, 1, 0)


def test_gens_on_bump_hook_fires_outside_lock():
    def run(P):
        seen = []
        gens = P.Gens(on_bump=lambda t, cx, cy: seen.append((t, cx, cy)))
        gens.bump("segment", CX, CY)
        gens.bump_frame("product", {"cx": [CX], "cy": [CY]})
        return seen

    j, t = both(run)
    assert j == t == [("segment", CX, CY), ("product", CX, CY)]


# ---------------------------------------------------------------------------
# HTTP: /v1/pyramid + the ETag/304 edge contract, both servers
# ---------------------------------------------------------------------------

@pytest.fixture
def served_pyramid(tmp_path, fresh_metrics):
    out, srvs = {}, []
    for P in PKGS:
        store = seeded_store(P)
        p = P.pyr.TilePyramid(str(tmp_path / P.name / "pyr"))
        svc = P.api.ServeService(store, P.Config(store_backend="memory"),
                                 pyramid=p)
        srv = P.api.start_serve_server(0, svc, host="127.0.0.1")
        srvs.append(srv)
        out[P.name] = (svc, store, f"http://127.0.0.1:{srv.port}")
    yield out
    for srv in srvs:
        srv.close()


def _both_get(served, path, headers=None):
    j = _get(served["jax"][2], path, headers)
    t = _get(served["torch"][2], path, headers)
    assert t[0] == j[0], (path, t, j)
    if t[2].get("Content-Type", "").startswith("application/json"):
        assert json.loads(t[1]) == json.loads(j[1]), path
    else:
        assert t[1] == j[1], path
    for h in ("ETag", "Cache-Control", "X-Firebird-Quadkey",
              "X-Firebird-Ulx", "X-Firebird-Uly", "X-Firebird-Tile-Version"):
        assert t[2].get(h) == j[2].get(h), (path, h)
    return t


def test_http_pyramid_tile_and_304(served_pyramid, tmp_path):
    import io

    bx, by = tpyr.tile_of_chip(CX, CY)
    path = f"/v1/pyramid/curveqa/{ZB}/{bx}/{by}?date={DATE}"
    code, body, h = _both_get(served_pyramid, path)
    assert code == 200
    want = tproducts.chip_product("curveqa", dt.to_ordinal(DATE), CX, CY,
                                  seg_frame(n=9, seed=0))
    assert np.array_equal(np.load(io.BytesIO(body)).ravel(), want)
    assert h["X-Firebird-Quadkey"] == tpyr.quadkey(ZB, bx, by)
    etag = h["ETag"]
    assert etag.startswith('"py-') and "max-age=" in h["Cache-Control"]
    code, body, h2 = _both_get(served_pyramid, path, {"If-None-Match": etag})
    assert (code, body, h2["ETag"]) == (304, b"", etag)
    assert tmetrics.counter("serve_304_total").value == 1
    code, body, _ = _both_get(served_pyramid, path + "&format=json")
    doc = json.loads(body)
    assert (doc["z"], doc["x"], doc["y"]) == (ZB, bx, by)
    assert doc["version"] == 1 and doc["extent"]["chip_span"] == 1
    same_tiles(tmp_path / "jax" / "pyr", tmp_path / "torch" / "pyr")


def test_http_pyramid_errors(served_pyramid):
    for path, code, needle in (
            (f"/v1/pyramid/curveqa/3/1?date={DATE}", 400,
             b"/v1/pyramid/<name>/<z>/<x>/<y>"),
            (f"/v1/pyramid/nope/3/1/1?date={DATE}", 400, b"nope"),
            (f"/v1/pyramid/curveqa/3/999/0?date={DATE}", 400, b"domain"),
            (f"/v1/pyramid/curveqa/0/0/0?date={DATE}", 404, b"precomputed"),
            (f"/v1/pyramid/curveqa/3/a/0?date={DATE}", 400, b"address"),
            (f"/v1/pyramid/curveqa/3/1/0?date={DATE}&format=tif", 400,
             b"format")):
        got = _both_get(served_pyramid, path)
        assert got[0] == code and needle in got[1], path
    for name in ("jax", "torch"):
        served_pyramid[name][0].pyramid = None
    got = _both_get(served_pyramid, f"/v1/pyramid/curveqa/11/1/1?date={DATE}")
    assert got[0] == 404 and b"pyramid root" in got[1]


def test_http_product_etag_flips_on_write(served_pyramid):
    path = f"/v1/product/curveqa?cx={CX}&cy={CY}&date={DATE}"
    code, _, h = _both_get(served_pyramid, path)
    etag = h["ETag"]
    assert code == 200
    assert _both_get(served_pyramid, path,
                     {"If-None-Match": etag})[:2] == (304, b"")
    for name in ("jax", "torch"):
        served_pyramid[name][0].watched_store().write(
            "segment", seg_frame(curqa=(9, 9, 9)))
    code, _, h2 = _both_get(served_pyramid, path, {"If-None-Match": etag})
    assert code == 200 and h2["ETag"] != etag
    bx, by = tpyr.tile_of_chip(CX, CY)
    stale = []
    for name in ("jax", "torch"):
        svc = served_pyramid[name][0]
        svc.pyramid.tile("curveqa", DATE, ZB, bx, by)
        svc.watched_store().write("segment", seg_frame(curqa=(5, 5, 5)))
        stale.append(svc.pyramid.peek_meta("curveqa", DATE, ZB, bx,
                                           by)["stale"])
    assert stale == [True, True]


def test_http_tile_etag_covers_all_chips(served_pyramid):
    path = (f"/v1/tile/curveqa?bounds={CX + 1},{CY - 1}"
            f"&bounds={CX + CHIP_M + 1},{CY - 1}&date={DATE}")
    code, _, h = _both_get(served_pyramid, path)
    etag = h["ETag"]
    assert code == 200
    assert _both_get(served_pyramid, path,
                     {"If-None-Match": etag})[:2] == (304, b"")
    for name in ("jax", "torch"):
        served_pyramid[name][0].watched_store().write(
            "segment", seg_frame(cx=CX + CHIP_M))
    code, _, h2 = _both_get(served_pyramid, path, {"If-None-Match": etag})
    assert code == 200 and h2["ETag"] != etag


# ---------------------------------------------------------------------------
# Fleet pyramid job
# ---------------------------------------------------------------------------

def test_fleet_pyramid_job_builds_area(tmp_path, fresh_metrics):
    """A ``pyramid`` job on the port's fleet queue, through the port's
    worker (fenced store), builds the tiles JAX's ``build_area`` builds
    over the same rows."""
    from firebird_tpu_torch.fleet.queue import FleetQueue
    from firebird_tpu_torch.fleet.worker import FleetWorker
    from firebird_tpu_torch.store import open_store

    cfg = TConfig(store_backend="sqlite", store_path=str(tmp_path / "fb.db"),
                  serve_pyramid_dir=str(tmp_path / "pyr"))
    store = open_store("sqlite", cfg.store_path, cfg.keyspace())
    store.write("segment", seg_frame(n=9, seed=4))
    store.close()
    q = FleetQueue(str(tmp_path / "fleet.db"))
    try:
        q.enqueue("pyramid", {"bounds": [[CX + 1.0, CY - 1.0]],
                              "products": ["curveqa"],
                              "product_dates": [DATE], "levels": 2})
        summary = FleetWorker(cfg, q, device="cpu").run()
        assert summary["acked"] == 1 and summary["dead"] == 0
    finally:
        q.close()
    p = tpyr.TilePyramid(str(tmp_path / "pyr"))
    bx, by = tpyr.tile_of_chip(CX, CY)
    assert p.peek_meta("curveqa", DATE, ZB, bx, by)["version"] == 1
    assert p.peek_meta("curveqa", DATE, *tpyr.parent(ZB, bx, by))
    jstore = JAX.open_store("memory", "", "t")
    jstore.write("segment", seg_frame(n=9, seed=4))
    jpyr.TilePyramid(str(tmp_path / "jpyr"),
                     jpyr.store_read_chip(jstore)).build_area(
        ["curveqa"], [DATE], [(CX + 1.0, CY - 1.0)], levels=2)
    same_tiles(tmp_path / "jpyr", tmp_path / "pyr")


# ---------------------------------------------------------------------------
# Crossing: tiles and the changefeed db, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("built_by", ["jax", "torch"])
def test_pyramid_dirs_cross_both_ways(built_by, tmp_path, fresh_metrics):
    """A pyramid directory one package built, the other serves: the
    served bodies and ETags equal the building package's own, with no
    rebuild."""
    chips = [(CX + CHIP_M * i, CY) for i in range(2)]
    B = JAX if built_by == "jax" else PORT
    S = PORT if built_by == "jax" else JAX
    root = str(tmp_path / "pyr")
    B.pyr.TilePyramid(root, B.pyr.store_read_chip(
        seeded_store(B, chips, seed=7))).build_area(
        ["curveqa", "ccd"], [DATE], [(CX + 1.0, CY - 1.0),
                                     (CX + CHIP_M + 1.0, CY - 1.0)],
        levels=3)
    before = tree(root)
    jmetrics.reset_registry()
    tmetrics.reset_registry()
    bases = {}
    for P in (B, S):
        svc = P.api.ServeService(seeded_store(P, chips, seed=7),
                                 P.Config(store_backend="memory"),
                                 pyramid=P.pyr.TilePyramid(root))
        srv = P.api.start_serve_server(0, svc, host="127.0.0.1")
        bases[P.name] = (srv, f"http://127.0.0.1:{srv.port}")
    try:
        bx, by = tpyr.tile_of_chip(*chips[0])
        for z, x, y in tpyr.ancestors(ZB, bx, by)[:3]:
            for name in ("curveqa", "ccd"):
                path = f"/v1/pyramid/{name}/{z}/{x}/{y}?date={DATE}"
                b = _get(bases[B.name][1], path)
                s = _get(bases[S.name][1], path)
                assert s[0] == b[0] == 200 and s[1] == b[1], path
                assert s[2]["ETag"] == b[2]["ETag"], path
                assert _get(bases[S.name][1], path, {
                    "If-None-Match": b[2]["ETag"]})[0] == 304
    finally:
        for srv, _ in bases.values():
            srv.close()
    assert tree(root) == before          # served, never rebuilt
    assert tmetrics.counter("pyramid_tiles_built").value == \
        jmetrics.counter("pyramid_tiles_built").value == 0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_changefeed_db_crosses_both_ways(writer, tmp_path, fresh_metrics):
    """One feed db: one package's producer appends, the other's consumer
    applies (bumps, stale stamps, checkpoint), and the first package's
    registry reads the checkpoint."""
    W = JAX if writer == "jax" else PORT
    C = PORT if writer == "jax" else JAX
    path = str(tmp_path / "changefeed.db")
    rng = np.random.default_rng(9)
    chips = [(CX + CHIP_M * int(i), CY) for i in rng.permutation(3)]
    wfeed = W.cf.ProductWrites(path)
    p = C.pyr.TilePyramid(str(tmp_path / "pyr"), C.pyr.store_read_chip(
        seeded_store(C, chips)))
    for cx, cy in chips:
        p.tile("curveqa", DATE, ZB, *C.pyr.tile_of_chip(cx, cy))
    cfeed = C.cf.ProductWrites(path)
    try:
        assert wfeed.append("product", chips[:2]) == 2
        assert wfeed.append("segment", chips[2:]) == 1
        gens = C.Gens()
        out = C.cf.ChangefeedConsumer(gens, feed=cfeed, pyramid=p,
                                      replica="r-cross",
                                      poll_sec=60).poll_once()
        assert (out["applied"], out["writes_cursor"]) == (3, 3)
        assert [gens.gen("product", *c) for c in chips] == [1, 1, 0]
        assert gens.gen("segment", *chips[2]) == 1
        assert all(p.peek_meta("curveqa", DATE, ZB,
                               *C.pyr.tile_of_chip(*c))["stale"]
                   for c in chips)
        reps = wfeed.replicas()
        assert [(r["replica"], r["writes_cursor"], r["writes_behind"])
                for r in reps] == [("r-cross", 3, 0)]
        assert wfeed.replica_cursors("r-cross") == (0, 3)
        assert wfeed.status()["latest_cursor"] == \
            cfeed.status()["latest_cursor"] == 3
    finally:
        wfeed.close()
        cfeed.close()


def test_object_tile_storage_crosses_both_ways(tmp_path, fresh_metrics):
    """Object-native tiles: the port's ObjectTileStorage writes the JAX
    package's objects (meta in the manifest), and each package's storage
    reads what the other wrote."""
    from firebird_tpu.store import objectstore as jobj
    from firebird_tpu_torch.store import objectstore as tobj

    root = str(tmp_path / "objects")
    storages = {"jax": jpyr.ObjectTileStorage(jobj.LocalObjectStore(root),
                                              "scope"),
                "torch": tpyr.ObjectTileStorage(tobj.LocalObjectStore(root),
                                                "scope")}
    bx, by = tpyr.tile_of_chip(CX, CY)
    for P, name in ((PORT, "curveqa"), (JAX, "ccd")):
        P.pyr.TilePyramid(str(tmp_path / "unused"), P.pyr.store_read_chip(
            seeded_store(P)), storage=storages[P.name]).tile(
            name, DATE, ZB, bx, by)
    for name in ("curveqa", "ccd"):
        j = storages["jax"].load_meta(name, DATE, ZB, bx, by)
        t = storages["torch"].load_meta(name, DATE, ZB, bx, by)
        assert j == t and j["version"] == 1
        assert np.array_equal(
            storages["jax"].load_cells(name, DATE, ZB, bx, by),
            storages["torch"].load_cells(name, DATE, ZB, bx, by))
    assert storages["jax"].tiles_by_level() == \
        storages["torch"].tiles_by_level()
    assert storages["torch"].product_dates() == [("ccd", DATE),
                                                 ("curveqa", DATE)]

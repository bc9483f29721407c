"""The port's durable metric history (firebird_tpu_torch/obs/series.py)
against the JAX package's (firebird_tpu/obs/series.py), on the CPU.

Each case of the JAX package's series tests runs through both stores on
the same events, each in its own directory: the port must pass the JAX
case's assertions, and since both writers run in this one process (one
pid, so the same ring file names), the two directories must hold the same
files byte for byte.  Ring files also cross both ways: the port's rings
read through JAX's ``read_points`` and the reverse, point for point."""

import json
import os
import time

import numpy as np
import pytest
import torch

from firebird_tpu.config import Config as JConfig
from firebird_tpu.obs import series as jseries
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.obs import series as tseries

# A fixed "now" far from the test host's clock: every bucket assertion
# below only holds if ingestion keys on the EMITTER's stamps.
T0 = 1_700_000_000.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snap(t, role="worker", pid=7, counters=None, gauges=None, hists=None):
    return {"kind": "snap", "t": t, "role": role, "pid": pid,
            "metrics": {"counters": counters or {},
                        "gauges": gauges or {},
                        "histograms": hists or {}}}


def _hist(count, s, bounds, counts):
    return {"count": count, "sum": s, "bucket_bounds": list(bounds),
            "bucket_counts": list(counts)}


def _write_spool(directory, role, pid, snaps):
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"spool.{role}.{pid}.0.jsonl")
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "header", "role": role, "pid": pid,
                            "run_id": f"run-{role}", "segment": 0,
                            "t": 0.0}) + "\n")
        for doc in snaps:
            f.write(json.dumps(doc) + "\n")


def _files(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.is_file()}


def both(tmp_path, scenario):
    """``scenario(series_module, directory)`` in a directory of its own for
    each package; returns (port result, JAX result, port dir, JAX dir) after
    holding the two directories' files equal byte for byte."""
    dt, dj = tmp_path / "port", tmp_path / "jax"
    dt.mkdir()
    dj.mkdir()
    rt, rj = scenario(tseries, dt), scenario(jseries, dj)
    assert _files(dt) == _files(dj)
    return rt, rj, dt, dj


def random_snaps(seed, n=60, sources=3, span=4000.0):
    """Snapshots from ``sources`` processes with cumulative counters, a
    gauge and a histogram, at random emitter stamps (seeded)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(sources):
        c, h = 0.0, np.zeros(3)
        for t in np.sort(rng.uniform(0, span, n // sources)):
            c += float(rng.integers(0, 5))
            h += rng.integers(0, 3, 3)
            out.append(_snap(
                T0 + float(t), role=("worker", "supervisor")[s % 2],
                pid=100 + s, counters={"jobs": c},
                gauges={"depth": float(rng.integers(0, 9))},
                hists={"lat_seconds": _hist(int(h.sum()), float(h @ [0.5, 2,
                                                                     8]),
                                            (1.0, 5.0), h.tolist())}))
    order = rng.permutation(len(out))
    return [out[i] for i in order]


# ---------------------------------------------------------------------------
# The store: ring files, idempotency, the emitter-clock rule
# ---------------------------------------------------------------------------

def test_series_buckets_key_on_emitter_stamps_never_reader_clock(tmp_path):
    spools = tmp_path / "spools"
    _write_spool(str(spools), "worker", 42,
                 [_snap(T0 + 5.0, counters={"c": 1.0})])
    _write_spool(str(spools), "serve", 43,
                 [_snap(T0 + 43_200.0, counters={"c": 9.0})])

    def run(mod, d):
        store = mod.SeriesStore(str(d))
        n = store.ingest_spools(str(spools))
        store.close()
        return n, mod.read_points(str(d), 10)

    (n, pts), jres, _, _ = both(tmp_path, run)
    assert n > 0 and (n, pts) == jres
    by_src = {p["src"]: p for p in pts}
    assert by_src["worker:42"]["b"] == int((T0 + 5.0) // 10)
    assert by_src["serve:43"]["b"] == int((T0 + 43_200.0) // 10)
    assert all(abs(p["b"] * 10 - time.time()) > 86_400 * 365 for p in pts)


def test_series_reingest_is_idempotent_across_restart(tmp_path):
    events = [_snap(T0 + i * 20.0, counters={"c": float(i)})
              for i in range(5)]

    def run(mod, d):
        store = mod.SeriesStore(str(d))
        got = [store.ingest_events(events), store.ingest_events(events)]
        store.close()
        store2 = mod.SeriesStore(str(d))     # restarted reader
        got.append(store2.ingest_events(events))
        store2.close()
        return got

    got, jgot, _, _ = both(tmp_path, run)
    assert got == jgot and got[0] > 0 and got[1:] == [0, 0]


def test_series_history_survives_reopen_then_write(tmp_path):
    def run(mod, d):
        store = mod.SeriesStore(str(d), resolutions=(10,))
        n = store.ingest_events([_snap(T0 + i * 20.0,
                                       counters={"c": float(i)})
                                 for i in range(10)])
        store.close()
        store2 = mod.SeriesStore(str(d), resolutions=(10,))
        n2 = store2.ingest_events([_snap(T0 + 500.0, counters={"c": 99.0})])
        store2.close()
        return n, n2, mod.read_points(str(d), 10)

    (n, n2, pts), jres, _, _ = both(tmp_path, run)
    assert (n, n2) == (10, 1) and (n, n2, pts) == jres
    assert [p["m"]["counters"]["c"] for p in pts] == \
        [float(i) for i in range(10)] + [99.0]


def test_series_reopen_resumes_ring_position(tmp_path):
    def run(mod, d):
        kw = dict(points_per_segment=2, segments=3, resolutions=(10,))
        store = mod.SeriesStore(str(d), **kw)
        for i in range(3):
            store.ingest_events(
                [_snap(T0 + i * 20.0, counters={"c": float(i)})])
        store.close()
        store2 = mod.SeriesStore(str(d), **kw)
        n = store2.ingest_events([_snap(T0 + 60.0, counters={"c": 3.0})])
        store2.close()
        return n, mod.read_points(str(d), 10)

    (n, pts), jres, dt, _ = both(tmp_path, run)
    assert n == 1 and (n, pts) == jres
    pid = os.getpid()
    assert sorted(p.name for p in dt.iterdir()) == \
        [f"series.10.{pid}.{s}.jsonl" for s in (0, 1)]
    assert [p["m"]["counters"]["c"] for p in pts] == [0.0, 1.0, 2.0, 3.0]


def test_series_gc_reclaims_stale_dead_incarnation_files(tmp_path):
    def _pt(t, src):
        return json.dumps(
            {"kind": "pt", "res": 10, "b": int(t // 10), "t": t,
             "src": src, "m": {"counters": {}, "gauges": {},
                               "histograms": {}}}) + "\n"

    def run(mod, d):
        kw = dict(points_per_segment=4, segments=2, resolutions=(10,))
        store = mod.SeriesStore(str(d), **kw)
        store.ingest_events([_snap(T0, counters={"c": 1.0})])
        store.close()
        (d / "series.10.999999.0.jsonl").write_text(_pt(T0 - 900.0,
                                                        "worker:1"))
        (d / "series.10.999998.0.jsonl").write_text(_pt(T0 - 30.0,
                                                        "worker:2"))
        store2 = mod.SeriesStore(str(d), **kw)
        removed = store2.status()["gc_removed"]
        store2.close()
        return removed, mod.sources(mod.read_points(str(d), 10))

    (removed, srcs), jres, dt, _ = both(tmp_path, run)
    assert (removed, srcs) == jres == (1, ["worker:2", "worker:7"])
    names = {p.name for p in dt.iterdir()}
    assert "series.10.999999.0.jsonl" not in names
    assert "series.10.999998.0.jsonl" in names


def test_series_live_bucket_refresh_is_throttled(tmp_path):
    def run(mod, d):
        store = mod.SeriesStore(str(d), resolutions=(80,))
        got = [store.ingest_events([_snap(T0 + dt_, counters={"c": c})])
               for dt_, c in ((0.0, 1.0), (5.0, 2.0), (11.0, 3.0),
                              (-500.0, 0.5))]
        store.close()
        return got

    got, jgot, _, _ = both(tmp_path, run)
    assert got == jgot == [1, 0, 1, 0]


def test_series_segment_ring_is_bounded(tmp_path):
    def run(mod, d):
        store = mod.SeriesStore(str(d), points_per_segment=4, segments=2,
                                resolutions=(10,))
        for i in range(40):
            store.ingest_events(
                [_snap(T0 + i * 10.0, counters={"c": float(i)})])
        store.close()
        return mod.read_points(str(d), 10)

    pts, jpts, dt, _ = both(tmp_path, run)
    assert pts == jpts
    pid = os.getpid()
    assert sorted(p.name for p in dt.iterdir()) == \
        [f"series.10.{pid}.{s}.jsonl" for s in (0, 1)]
    assert pts and pts[-1]["b"] == int((T0 + 390.0) // 10)
    assert len(pts) <= 8


def test_read_points_dedupes_and_windows(tmp_path):
    def run(mod, d):
        store = mod.SeriesStore(str(d), resolutions=(10,))
        store.ingest_events([_snap(T0 + 1.0, counters={"c": 1.0}),
                             _snap(T0 + 9.0, counters={"c": 2.0}),
                             _snap(T0 + 21.0, counters={"c": 3.0})])
        store.close()
        return (mod.read_points(str(d), 10),
                mod.read_points(str(d), 10, T0 + 9.0),
                mod.read_points(str(d), 10, None, T0 + 9.0))

    (pts, after, before), jres, _, _ = both(tmp_path, run)
    assert (pts, after, before) == jres
    assert [p["m"]["counters"]["c"] for p in pts] == [2.0, 3.0]
    assert after == pts[1:] and before == pts[:1]
    assert tseries.sources(pts) == ["worker:7"]


# ---------------------------------------------------------------------------
# Windowed aggregates: the burn-rate substrate
# ---------------------------------------------------------------------------

def _pt(t, src, counters=None, gauges=None, hists=None):
    return {"kind": "pt", "res": 10, "b": int(t // 10), "t": t, "src": src,
            "m": {"counters": counters or {}, "gauges": gauges or {},
                  "histograms": hists or {}}}


def test_counter_window_sums_per_source_deltas():
    pts = [_pt(T0 + 10, "worker:1", {"c": 10.0}),
           _pt(T0 + 100, "worker:1", {"c": 30.0}),
           _pt(T0 + 110, "worker:2", {"c": 5.0})]
    for name, t0, t1, want in (("c", T0 + 50, T0 + 200, 25.0),
                               ("c", T0 + 500, T0 + 900, None),
                               ("other", T0, T0 + 200, 0.0)):
        got = tseries.counter_window(pts, name, t0, t1)
        assert got == want == jseries.counter_window(pts, name, t0, t1)


def test_counter_window_resets_per_source():
    """A restarted process's counter starts again from zero: a source's
    delta never goes negative, and each source's delta is its own."""
    pts = [_pt(T0 + 10, "worker:1", {"c": 50.0}),
           _pt(T0 + 100, "worker:1", {"c": 3.0}),     # restarted: reset
           _pt(T0 + 100, "worker:9", {"c": 7.0})]
    got = tseries.counter_window(pts, "c", T0 + 50, T0 + 200)
    assert got == 7.0 == jseries.counter_window(pts, "c", T0 + 50, T0 + 200)


def test_hist_window_merges_deltas_and_over_threshold():
    pts = [_pt(T0 + 10, "a:1",
               hists={"h_seconds": _hist(4, 2.0, (1.0, 5.0), (4, 0, 0))}),
           _pt(T0 + 100, "a:1",
               hists={"h_seconds": _hist(10, 20.0, (1.0, 5.0), (6, 2, 2))}),
           _pt(T0 + 100, "b:2",
               hists={"h_seconds": _hist(3, 9.0, (1.0, 5.0), (0, 3, 0))})]
    win = tseries.hist_window(pts, "h_seconds", T0 + 50, T0 + 200)
    assert win == jseries.hist_window(pts, "h_seconds", T0 + 50, T0 + 200)
    assert win["count"] == 9.0 and win["bucket_counts"] == [2.0, 5.0, 2.0]
    for thr, want in ((1.0, 7.0), (5.0, 2.0)):
        assert tseries.hist_over_threshold(win, thr) == want \
            == jseries.hist_over_threshold(win, thr)
    assert tseries.hist_window(pts, "h_seconds", T0 + 500, T0 + 900) is None


def test_bucket_series_per_kind():
    pts = [_pt(T0 + 5, "w:1", {"c": 10.0}, {"g": 1.0}),
           _pt(T0 + 15, "w:1", {"c": 25.0}, {"g": 2.0}),
           _pt(T0 + 25, "w:1", {"c": 25.0}, {"g": 3.0})]
    b0 = int(T0 // 10)
    got = tseries.bucket_series(pts, "c", "counter", 10)
    assert got == [(b0, 10.0), (b0 + 1, 15.0), (b0 + 2, 0.0)]
    for name, kind in (("c", "counter"), ("g", "gauge"), ("x", "histogram")):
        assert tseries.bucket_series(pts, name, kind, 10) == \
            jseries.bucket_series(pts, name, kind, 10)
    assert [v for _, v in tseries.bucket_series(pts, "g", "gauge", 10)] == \
        [1.0, 2.0, 3.0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_functions_equal_jax_on_random_series(tmp_path, seed):
    """Random multi-source snapshots through both stores: the rings are
    the same bytes, and every windowed aggregate over random windows at
    every resolution equals JAX's."""
    events = random_snaps(seed)

    def run(mod, d):
        store = mod.SeriesStore(str(d), points_per_segment=16, segments=3)
        n = store.ingest_events(events)
        store.close()
        return n

    n, jn, dt, _ = both(tmp_path, run)
    assert n == jn > 0
    rng = np.random.default_rng(seed + 100)
    for res in tseries.RESOLUTIONS:
        pts = tseries.read_points(str(dt), res)
        assert pts == jseries.read_points(str(dt), res)
        for _ in range(8):
            t0, t1 = np.sort(T0 + rng.uniform(-500, 4500, 2)).tolist()
            assert tseries.counter_window(pts, "jobs", t0, t1) == \
                jseries.counter_window(pts, "jobs", t0, t1)
            assert tseries.hist_window(pts, "lat_seconds", t0, t1) == \
                jseries.hist_window(pts, "lat_seconds", t0, t1)
            assert tseries.gauge_samples(pts, "depth", t0, t1) == \
                jseries.gauge_samples(pts, "depth", t0, t1)
        for name, kind in (("jobs", "counter"), ("depth", "gauge"),
                           ("lat_seconds", "histogram")):
            assert tseries.bucket_series(pts, name, kind, res) == \
                jseries.bucket_series(pts, name, kind, res)


# ---------------------------------------------------------------------------
# The format crosses both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rings_cross_both_ways_point_for_point(tmp_path, writer):
    """One package's rings read through the other's ``read_points``,
    ``sources`` and a reopened store (whose dedup state comes from the
    other's files, so re-ingesting the same events writes nothing)."""
    w, r = (tseries, jseries) if writer == "port" else (jseries, tseries)
    events = random_snaps(7)
    store = w.SeriesStore(str(tmp_path), points_per_segment=32)
    assert store.ingest_events(events) > 0
    store.close()
    for res in tseries.RESOLUTIONS:
        mine = w.read_points(str(tmp_path), res)
        theirs = r.read_points(str(tmp_path), res)
        assert mine and theirs == mine
        assert r.sources(theirs) == w.sources(mine)
    other = r.SeriesStore(str(tmp_path), points_per_segment=32)
    assert other.ingest_events(events) == 0
    assert other.status()["sources"] == sorted(
        {f"{e['role']}:{e['pid']}" for e in events})
    other.close()


def test_port_spool_ingests_into_jax_readable_rings(tmp_path):
    """A spool the port's own TelemetrySpool wrote, ingested through the
    port's collector (``snap_events``) into the port's store, reads
    through JAX's ``read_points`` point for point."""
    from firebird_tpu_torch.obs import metrics as obs_metrics
    from firebird_tpu_torch.obs import spool as tspool

    obs_metrics.reset_registry()
    try:
        sp = tspool.TelemetrySpool(str(tmp_path), "worker", "run-1",
                                   snapshot_sec=1e9)
        obs_metrics.counter("jobs_done").inc(3)
        sp.snapshot()
        obs_metrics.counter("jobs_done").inc(2)
        sp.close()
    finally:
        obs_metrics.reset_registry()
    store = tseries.SeriesStore(str(tmp_path / "series"))
    assert store.ingest_spools() > 0      # default: the series dir's parent
    store.close()
    pts = jseries.read_points(str(tmp_path / "series"), 10)
    assert pts == tseries.read_points(str(tmp_path / "series"), 10)
    assert pts[-1]["m"]["counters"]["jobs_done"] == 5.0
    assert tseries.sources(pts) == [f"worker:{os.getpid()}"]


# ---------------------------------------------------------------------------
# open_store: the zero-cost paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw, opens", [
    (dict(telemetry=0), False),
    (dict(series=0, series_dir="{d}"), False),
    (dict(store_backend="memory"), False),
    (dict(series_dir="{d}"), True),
    (dict(store_backend="sqlite", store_path="{d}/fb.db"), True)])
def test_open_store_zero_cost_paths(tmp_path, kw, opens):
    kw = {k: v.format(d=tmp_path) if isinstance(v, str) else v
          for k, v in kw.items()}
    store = tseries.open_store(Config(**kw))
    jstore = jseries.open_store(JConfig(**kw))
    assert (store is not None) == (jstore is not None) == opens
    if opens:
        assert store.dir == jstore.dir == tseries.series_dir(Config(**kw))
        store.close()
        jstore.close()

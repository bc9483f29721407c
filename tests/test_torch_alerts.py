"""The port's alert log, fleet queue and product_writes feed against the
JAX package's.

``AlertLog`` append (with the (pixel, break_day) dedup), ``since``,
``count`` and ``status`` on the same records in both packages; each
package's log read by the other (the schema is shared); the fleet queue's
``enqueue_repairs`` (one open job per chip) with a JAX ``FleetQueue``
reading and leasing the port's job; the repair path's feed record read by
the JAX package's ``ProductWrites``.
"""

import numpy as np
import pytest
import torch

from firebird_tpu.alerts import log as jlog
from firebird_tpu.alerts import subindex as jsub
from firebird_tpu.config import Config as JConfig
from firebird_tpu.fleet import plan as jplan
from firebird_tpu.fleet import queue as jqueue
from firebird_tpu.serve import changefeed as jfeed
from firebird_tpu_torch import grid
from firebird_tpu_torch.alerts import log as tlog
from firebird_tpu_torch.alerts import repair as trepair
from firebird_tpu_torch.alerts import subindex as tsub
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.fleet import plan as tplan
from firebird_tpu_torch.fleet import queue as tqueue
from firebird_tpu_torch.serve import changefeed as tfeed


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# Fields of a record that depend on the run (ids, clocks), not the alert.
RUN_FIELDS = ("id", "detected_at", "run_id")


def _records(n=40, seed=0):
    rng = np.random.default_rng(seed)
    cids = [tuple(int(v) for v in c)
            for c in grid.chips(grid.tile(x=542000, y=1650000))[:4]]
    out = []
    for i in range(n):
        cx, cy = cids[i % 4]
        out.append({"cx": cx, "cy": cy,
                    "px": cx + 30 * int(rng.integers(0, 100)),
                    "py": cy - 30 * int(rng.integers(0, 100)),
                    "break_day": float(736000 + int(rng.integers(0, 600))),
                    "score": 1.0,
                    "magnitude": float(rng.uniform(1, 9))})
    return out


@pytest.fixture
def logs(tmp_path):
    j = jlog.AlertLog(str(tmp_path / "j" / "alerts.db"))
    t = tlog.AlertLog(str(tmp_path / "t" / "alerts.db"))
    yield j, t
    j.close()
    t.close()


def _strip(recs):
    return [{k: v for k, v in r.items() if k not in RUN_FIELDS} for r in recs]


def test_base_quadkey_equals_jax():
    for c in grid.chips(grid.tile(x=542000, y=1650000))[:64]:
        assert tsub.base_quadkey(*c) == jsub.base_quadkey(*c)
    assert tsub.base_quadkey(-1e9, 1e9) is None
    assert tsub.Z_BASE == jsub.Z_BASE and tsub.MAX_CELLS == jsub.MAX_CELLS


def test_append_dedup_since_count_as_jax(logs):
    j, t = logs
    recs = _records()
    dupes = recs[:7]
    for log in (j, t):
        assert log.append(recs, run_id="r1") == (len(set(
            (r["px"], r["py"], r["break_day"]) for r in recs)),
            len(recs) - len(set((r["px"], r["py"], r["break_day"])
                                for r in recs)))
        assert log.append(dupes, run_id="r2") == (0, 7)
        assert log.append([], run_id="r3") == (0, 0)
    assert t.count() == j.count() and t.latest_cursor() == j.latest_cursor()
    assert _strip(t.since(0, limit=10_000)) == _strip(j.since(0,
                                                              limit=10_000))
    assert [r["id"] for r in t.since(0)] == [r["id"] for r in j.since(0)]
    # cursor pagination, bbox and date filters
    assert _strip(t.since(5, limit=3)) == _strip(j.since(5, limit=3))
    c0 = recs[0]
    bbox = (c0["px"] - 600, c0["py"] - 600, c0["px"] + 600, c0["py"] + 600)
    assert _strip(t.since(0, bbox=bbox)) == _strip(j.since(0, bbox=bbox))
    assert (_strip(t.since(0, t0="2016-03-01", t1="2016-09-01"))
            == _strip(j.since(0, t0="2016-03-01", t1="2016-09-01")))


def test_rebreak_same_pixel_new_day_is_new_alert(logs):
    _, t = logs
    r = _records(1)[0]
    assert t.append([r]) == (1, 0)
    assert t.append([dict(r, break_day=r["break_day"] + 100)]) == (1, 0)
    assert t.count() == 2


def test_status_as_jax(logs):
    j, t = logs
    for log in (j, t):
        log.append(_records(12, seed=3), run_id="r")
    js, ts = j.status(), t.status()
    for k in ("depth", "latest_cursor", "subscribers", "fanout"):
        assert ts[k] == js[k], k
    assert ts["path"] == t.path


def test_logs_read_each_other(tmp_path):
    """The schema is shared: the port's log opens in the JAX package (its
    quadkey stamps included) and the JAX package's in the port."""
    recs = _records(20, seed=5)
    t = tlog.AlertLog(str(tmp_path / "a.db"))
    t.append(recs, run_id="port", trace="t-1")
    t.close()
    j = jlog.AlertLog(str(tmp_path / "a.db"))
    assert j.count() == 20
    assert j.shards_since(0, 11) and all(
        s["count"] >= 1 for s in j.shards_since(0, 11))
    assert j.append(recs[:3]) == (0, 3)
    j.append([dict(recs[0], break_day=1.0)])
    j.close()
    t = tlog.AlertLog(str(tmp_path / "a.db"))
    assert t.count() == 21
    assert t.since(20)[0]["break_day"] == 1.0
    t.close()


def test_alert_db_path_as_jax(tmp_path):
    kw = dict(store_backend="sqlite", store_path=str(tmp_path / "fb.db"))
    assert tlog.alert_db_path(Config(**kw)) == jlog.alert_db_path(JConfig(**kw))
    assert tlog.alert_db_path(Config(store_backend="memory")) is None
    assert tlog.alert_db_path(Config(store_backend="memory",
                                     alert_db="/x/a.db")) == "/x/a.db"


def test_enqueue_repairs_one_open_job_per_chip_read_by_jax(tmp_path):
    path = str(tmp_path / "fleet.db")
    q = tqueue.FleetQueue(path)
    chips = {(100, 200): 5, (3100, 200): 2}
    ids = tplan.enqueue_repairs(q, chips, acquired="1985-01-01/2017-12-31",
                                run_id="r1")
    assert len(ids) == 2
    # the same debt re-rolled: no new job while one is open
    assert tplan.enqueue_repairs(q, chips, acquired="x") == []
    assert set(q.open_jobs("repair")) == set(chips)
    assert q.counts()["pending"] == 2
    # A JAX fleet queue reads, leases and acks the port's job.
    jq = jqueue.FleetQueue(path)
    assert jq.open_jobs("repair") == q.open_jobs("repair")
    assert jq.job(ids[0]) == q.job(ids[0])
    lease = jq.claim("jax-worker")
    assert lease.job_type == "repair" and lease.payload["pixels"] == 5
    jq.ack(lease)
    # the acked chip may be scheduled again: a new debt
    assert tplan.enqueue_repairs(q, {(100, 200): 1}, acquired="x") != []
    assert jq.counts() == q.counts()
    jq.close()
    q.close()


def test_enqueue_repairs_as_jax(tmp_path):
    chips = {(100, 200): 5, (3100, 200): 2, (6100, 200): 0}
    got, want = [], []
    for mod, plan, out in ((tqueue, tplan, got), (jqueue, jplan, want)):
        q = mod.FleetQueue(str(tmp_path / f"{mod.__name__}.db"))
        plan.enqueue_repairs(q, chips, acquired="a/b", run_id="r")
        plan.enqueue_repairs(q, {(100, 200): 9}, acquired="a/b")
        out.extend((j["job_type"], j["payload"], j["state"])
                   for j in (q.job(i) for i in range(1, 5)) if j)
        q.close()
    assert got == want


def test_schedule_repairs(tmp_path):
    cfg = Config(store_backend="sqlite", store_path=str(tmp_path / "fb.db"))
    ids = trepair.schedule_repairs(cfg, {(100, 200): 3, (3100, 200): 0},
                                   acquired="a/b", run_id="r")
    assert len(ids) == 1
    q = jqueue.FleetQueue(jqueue.queue_path(JConfig(**vars(cfg))))
    assert list(q.open_jobs("repair")) == [(100, 200)]
    q.close()
    # A memory store has no queue location: nothing scheduled.
    assert trepair.schedule_repairs(Config(store_backend="memory"),
                                    {(100, 200): 3}, acquired="a/b") == []


def test_product_writes_read_by_jax(tmp_path):
    store_path = tmp_path / "fb.db"
    cfg = Config(store_backend="sqlite", store_path=str(store_path))
    # No store on disk yet: no feed (the JAX package's litter rule).
    assert tfeed.append_product_writes(cfg, "segment", [(100, 200)]) == 0
    store_path.write_bytes(b"")
    assert (tfeed.changefeed_db_path(cfg)
            == jfeed.changefeed_db_path(JConfig(**vars(cfg))))
    assert tfeed.append_product_writes(cfg, "segment",
                                       [(100, 200), (3100, 200)]) == 2
    feed = jfeed.ProductWrites(tfeed.changefeed_db_path(cfg))
    got = [(r["table"], r["cx"], r["cy"]) for r in feed.since(0)]
    feed.close()
    assert got == [("segment", 100, 200), ("segment", 3100, 200)]

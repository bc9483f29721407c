"""The port's store against the JAX package's, on the CPU.

``firebird_tpu_torch.store`` is the port's own copy of
``firebird_tpu.store``: the same tables, keys and column types, and the
same sqlite file layout, so a sqlite store one package writes reads the
same rows in the other.  Also the backends' round trips and the async
writer's contract (keyed order, flush, close, peek_error).
"""

import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from firebird_tpu.store import SqliteStore as JSqliteStore
from firebird_tpu.store import schema as jschema
from firebird_tpu_torch import retry as tretry
from firebird_tpu_torch.store import (AsyncWriter, MemoryStore, ParquetStore,
                                      SqliteStore, open_store)
from firebird_tpu_torch.store import schema as tschema


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HAVE_PYARROW = importlib.util.find_spec("pyarrow") is not None


def seg_frame(cx=1, cy=2, px=3, py=4, sday="1999-01-01", chprob=1.0):
    f = {"cx": [cx], "cy": [cy], "px": [px], "py": [py],
         "sday": [sday], "eday": ["2000-01-01"], "bday": [sday],
         "chprob": [chprob], "curqa": [8], "rfrawp": [None]}
    for p in ("bl", "gr", "re", "ni", "s1", "s2", "th"):
        f[f"{p}mag"] = [1.5]
        f[f"{p}rmse"] = [0.5]
        f[f"{p}coef"] = [[0.1, 0.2, 0.3]]
        f[f"{p}int"] = [7.0]
    return f


def _fill(store):
    # One chip a frame: the parquet backend writes a partition a frame.
    store.write("chip", {"cx": [10], "cy": [20],
                         "dates": [["1999-01-01", "1999-02-01"]]})
    store.write("chip", {"cx": [13], "cy": [20], "dates": [[]]})
    store.write("pixel", {"cx": [10, 10], "cy": [20, 20], "px": [10, 11],
                          "py": [20, 20],
                          "mask": [np.array([1, 0, 1], np.uint8),
                                   np.array([0, 0, 1], np.uint8)]})
    # A chip's segments in one frame: a parquet write replaces the chip's
    # partition.
    a, b = (seg_frame(cx=10, cy=20),
            seg_frame(cx=10, cy=20, sday="2001-01-01", chprob=0.25))
    store.write("segment", {k: a[k] + b[k] for k in a})
    store.write("tile", {"tx": [1], "ty": [2], "name": ["rf"],
                         "model": ["BLOB"], "updated": ["2020-01-01"]})


def _rows(store, table):
    """A table's rows as a sorted list of tuples (order-free equality)."""
    d = store.read(table)
    cols = sorted(d)
    conv = lambda v: tuple(v) if isinstance(v, list) else v
    return cols, sorted(tuple(conv(d[c][i]) for c in cols)
                        for i in range(len(d[cols[0]])))


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", sorted(jschema.TABLES))
def test_schema_equals_jax(table):
    assert set(tschema.TABLES) == set(jschema.TABLES)
    assert tschema.TABLES[table] == jschema.TABLES[table]
    assert tschema.primary_key(table) == jschema.primary_key(table)
    assert tschema.PACKED_DTYPES == jschema.PACKED_DTYPES


# ---------------------------------------------------------------------------
# Round trips
# ---------------------------------------------------------------------------

BACKENDS = ["memory", "sqlite",
            pytest.param("parquet", marks=pytest.mark.skipif(
                not HAVE_PYARROW, reason="pyarrow is not installed"))]


@pytest.mark.parametrize("backend", BACKENDS)
def test_roundtrip_all_tables(tmp_path, backend):
    store = open_store(backend, str(tmp_path / "st"), "ks")
    _fill(store)
    assert store.read("chip", {"cx": 10, "cy": 20})["dates"][0] == \
        ["1999-01-01", "1999-02-01"]
    assert store.count("pixel") == 2
    assert sorted(store.read("pixel")["mask"]) == [[0, 0, 1], [1, 0, 1]]
    seg = store.read("segment")
    assert seg["blcoef"][0] == [0.1, 0.2, 0.3]
    assert sorted(seg["chprob"]) == [0.25, 1.0]
    assert store.read("tile")["model"] == ["BLOB"]
    assert store.chip_ids("segment") == {(10, 20)}
    store.close()


@pytest.mark.parametrize("backend", ["memory", "sqlite"])
def test_upsert_idempotence(tmp_path, backend):
    store = open_store(backend, str(tmp_path / "st"), "ks")
    store.write("segment", seg_frame(chprob=0.5))
    store.write("segment", seg_frame(chprob=0.9))
    out = store.read("segment")
    assert len(out["cx"]) == 1 and out["chprob"][0] == 0.9
    store.write("segment", seg_frame(sday="2001-01-01"))
    assert store.count("segment") == 2
    store.close()


@pytest.mark.parametrize("backend", ["cassandra"])
def test_open_store_refuses_unported_backends(tmp_path, backend):
    """Every backend is ported: ``cassandra`` opens a CassandraStore from
    the CASSANDRA_* environment, and without cassandra-driver (installed
    nowhere here) fails with the JAX package's clear error, not a
    refusal."""
    from firebird_tpu_torch.config import NOT_PORTED_BACKENDS

    assert backend not in NOT_PORTED_BACKENDS
    with pytest.raises(RuntimeError, match="cassandra-driver"):
        open_store(backend, str(tmp_path / "st"), "ks")


def test_open_store_opens_the_object_backend(tmp_path, monkeypatch):
    """The ``object`` backend is ported: over FIREBIRD_OBJECT_ROOT it
    upserts and reads like the local backends, and the JAX package's
    object backend reads what it wrote."""
    from firebird_tpu.store import open_store as jopen_store
    from firebird_tpu_torch.store import ObjectBackedStore

    monkeypatch.setenv("FIREBIRD_OBJECT_ROOT", str(tmp_path / "objects"))
    store = open_store("object", str(tmp_path / "st"), "ks")
    assert isinstance(store, ObjectBackedStore)
    _fill(store)
    store.write("segment", seg_frame(chprob=0.9))
    want = {t: _canon(store.read(t)) for t in ("chip", "pixel", "segment",
                                                 "tile")}
    assert store.read("segment")["chprob"].count(0.9) == 1
    store.close()
    jstore = jopen_store("object", str(tmp_path / "st"), "ks")
    assert {t: _canon(jstore.read(t)) for t in want} == want
    jstore.close()


def _canon(frame: dict) -> list:
    cols = sorted(frame)
    n = len(frame[cols[0]]) if cols else 0
    return sorted(json.dumps([(c, frame[c][i]) for c in cols],
                             sort_keys=True) for i in range(n))


def test_open_store_read_only_is_sqlite_only(tmp_path):
    with pytest.raises(ValueError, match="read_only"):
        open_store("memory", str(tmp_path / "st"), "ks", read_only=True)


def test_sqlite_rows_land_in_the_keyspace_file(tmp_path):
    store = open_store("sqlite", str(tmp_path / "fb.db"), "ccdc_0_2_0")
    _fill(store)
    store.close()
    assert (tmp_path / "fb.ccdc_0_2_0.db").exists()
    assert not (tmp_path / "fb.db").exists()


# ---------------------------------------------------------------------------
# Sqlite files cross between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["chip", "pixel", "segment", "tile"])
def test_port_sqlite_reads_in_jax(tmp_path, table):
    path = str(tmp_path / "fb.db")
    port = SqliteStore(path, "ccdc_0_2_0")
    _fill(port)
    port.close()
    jax_store = JSqliteStore(path, "ccdc_0_2_0")
    mem = MemoryStore("ks")
    _fill(mem)
    assert _rows(jax_store, table) == _rows(mem, table)
    jax_store.close()


@pytest.mark.parametrize("table", ["chip", "pixel", "segment", "tile"])
def test_jax_sqlite_reads_in_port(tmp_path, table):
    path = str(tmp_path / "fb.db")
    jax_store = JSqliteStore(path, "ccdc_0_2_0")
    _fill(jax_store)
    jax_store.close()
    port = SqliteStore(path, "ccdc_0_2_0")
    again = JSqliteStore(path, "ccdc_0_2_0")
    assert _rows(port, table) == _rows(again, table)
    assert port.chip_ids("segment") == again.chip_ids("segment")
    port.close()
    again.close()


# ---------------------------------------------------------------------------
# AsyncWriter
# ---------------------------------------------------------------------------

def test_async_writer_keyed_ordering():
    order: dict = {}
    lock = threading.Lock()

    class Recorder(MemoryStore):
        def write(self, table, frame):
            with lock:
                order.setdefault((frame["cx"][0], frame["cy"][0]),
                                 []).append(table)
            return 1

    w = AsyncWriter(Recorder(), workers=4)
    for i in range(24):
        for t in ("chip", "pixel", "segment"):
            w.write(t, {"cx": [i], "cy": [0]}, key=(i, 0))
    w.flush()
    w.close()
    assert len(order) == 24
    assert all(seq == ["chip", "pixel", "segment"] for seq in order.values())


def test_async_writer_flush_lands_every_frame():
    store = MemoryStore("ks")
    w = AsyncWriter(store, workers=2)
    for i in range(10):
        w.write("segment", seg_frame(cx=i), key=(i, 2))
    w.flush()
    assert store.count("segment") == 10
    w.close()


def test_async_writer_raises_on_flush_and_peeks():
    gate = threading.Event()

    class Boom(MemoryStore):
        def write(self, table, frame):
            gate.wait(5)
            raise RuntimeError("disk full")

    w = AsyncWriter(Boom(), workers=1)
    w.write("chip", {"cx": [1], "cy": [0], "dates": [[]]}, key=(1,))
    assert w.peek_error() is None
    gate.set()
    with pytest.raises(RuntimeError, match="disk full"):
        w.flush()
    assert w.peek_error() is None        # flush popped it
    w.close()


def test_async_writer_peek_keeps_the_error_and_close_never_raises():
    class Boom(MemoryStore):
        def write(self, table, frame):
            raise tretry.NonRetryable("fenced")

    w = AsyncWriter(Boom(), workers=1)
    w.write("chip", {"cx": [1], "cy": [0], "dates": [[]]})
    for q in w._qs:
        q.join()
    assert isinstance(w.peek_error(), tretry.NonRetryable)
    assert isinstance(w.peek_error(), tretry.NonRetryable)   # not cleared
    w.close()                      # logs, never raises
    assert not any(t.is_alive() for t in w._threads)


def test_async_writer_retry_heals_a_brownout():
    calls = {"n": 0}

    class Flaky(MemoryStore):
        def write(self, table, frame):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise IOError("brownout")
            return super().write(table, frame)

    store = Flaky("ks")
    w = AsyncWriter(store, retry=tretry.RetryPolicy(3, sleep=lambda s: None))
    w.write("segment", seg_frame())
    w.flush()
    w.close()
    assert store.count("segment") == 1 and calls["n"] == 3


@pytest.mark.skipif(not HAVE_PYARROW, reason="pyarrow is not installed")
def test_parquet_rewrite_idempotent(tmp_path):
    store = ParquetStore(str(tmp_path / "pq"), "ks")
    store.write("segment", seg_frame(cx=5, cy=6, chprob=0.1))
    store.write("segment", seg_frame(cx=5, cy=6, chprob=0.7))
    out = store.read("segment", {"cx": 5})
    assert len(out["cx"]) == 1 and out["chprob"][0] == 0.7


def test_sqlite_read_decodes_each_column_as_jax(tmp_path):
    """The column-at-a-time read equals JAX's cell-at-a-time read on one
    file, with NULLs, a packed column of mixed lengths, JSON cells and a
    filter that matches nothing."""
    path = str(tmp_path / "fb.db")
    port = SqliteStore(path, "ks")
    f = seg_frame(cx=1, cy=2)
    for k in f:
        f[k] = f[k] * 4
    f["px"] = [3, 4, 5, 6]
    f["blcoef"] = [[0.1, 0.2], None, [0.3], []]
    f["grcoef"] = [None] * 4
    f["rfrawp"] = [None, [1.0, 2.0], [], [0.5]]
    f["chprob"] = [1.0, None, float("nan"), 0.25]
    port.write("segment", f)
    jax_store = JSqliteStore(path, "ks")
    for where in (None, {"cx": 1, "cy": 2}, {"cx": 9}):
        got, want = port.read("segment", where), jax_store.read(
            "segment", where)
        assert got == want, where
    assert port.read("segment")["blcoef"] == [[0.1, 0.2], None, [0.3], []]
    port.close()
    jax_store.close()


def _chip_rows(rng, n):
    """``n`` segment rows of chip (1, 2) at distinct pixels."""
    f = seg_frame(cx=1, cy=2)
    for k in f:
        f[k] = f[k] * n
    f["px"] = [int(v) for v in rng.permutation(1000)[:n]]
    f["blcoef"] = rng.normal(0, 1, (n, 8)).tolist()
    return f


def test_column_update_writes_its_columns_as_an_upsert_would(tmp_path):
    """A ColumnUpdate frame (rows read back with rfrawp changed) leaves the
    sqlite table an upsert of the whole frame leaves, row for row and in
    the order a chip's read returns them, and the JAX package reads it
    alike; with a row gone from the store it upserts the whole frame."""
    from firebird_tpu_torch.store import ColumnUpdate

    rng = np.random.default_rng(5)
    n = 30
    f = _chip_rows(rng, n)
    stores = [SqliteStore(str(tmp_path / d / "fb.db"), "ks")
              for d in ("update", "upsert")]
    for st in stores:
        st.write("segment", f)
    seg = stores[0].read("segment", {"cx": 1, "cy": 2})
    votes = [None if i % 7 == 0 else rng.random(4).tolist()
             for i in range(n)]
    upd = ColumnUpdate(seg, ("rfrawp",))
    upd["rfrawp"] = votes
    whole = dict(seg, rfrawp=votes)
    assert stores[0].write("segment", upd) == stores[1].write("segment",
                                                              whole) == n
    reads = [st.read("segment", {"cx": 1, "cy": 2}) for st in stores]
    assert reads[0] == reads[1]
    assert reads[0]["rfrawp"] == votes
    jax_store = JSqliteStore(str(tmp_path / "update" / "fb.db"), "ks")
    assert jax_store.read("segment") == stores[1].read("segment")
    jax_store.close()
    # A row deleted under the frame: the whole frame is upserted instead.
    con = stores[0]._conn()
    con.execute('DELETE FROM "segment" WHERE px = ?', (seg["px"][3],))
    con.commit()
    upd["rfrawp"] = [[0.5] * 4] * n
    assert stores[0].write("segment", upd) == n
    got = stores[0].read("segment", {"cx": 1, "cy": 2})
    assert sorted(got["px"]) == sorted(seg["px"])
    assert got["rfrawp"] == [[0.5] * 4] * n
    for st in stores:
        st.close()


@pytest.mark.parametrize("wrap", ["fenced", "mirrored", "async", "all"])
def test_column_update_keeps_its_update_through_wrappers(
        tmp_path, monkeypatch, wrap):
    """A ColumnUpdate handed to the fleet's fenced store, the object
    mirror, the async writer, or all three stacked as a fleet classify
    job stacks them, reaches the sqlite store as a ColumnUpdate: the
    sqlite store takes its UPDATE path, and the rows (the mirror's too)
    carry the new column."""
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.fleet.queue import FencedStore, FleetQueue
    from firebird_tpu_torch.store import ColumnUpdate
    from firebird_tpu_torch.store import objectstore as tobj

    rng = np.random.default_rng(7)
    n = 20
    local = SqliteStore(str(tmp_path / "fb.db"), "ks")
    local.write("segment", _chip_rows(rng, n))
    seg = local.read("segment", {"cx": 1, "cy": 2})
    updated = []
    real_update = SqliteStore._update

    def spy(*args):
        updated.append(real_update(*args))
        return updated[-1]

    monkeypatch.setattr(SqliteStore, "_update", staticmethod(spy))
    q = FleetQueue(str(tmp_path / "q.db"), lease_sec=30)
    q.enqueue("classify", {"n": 1})
    lease = q.claim("w:1")
    root = str(tmp_path / "objects")
    mirror = tobj.ObjectBackedStore(tobj.open_object_root(
        root=root, cfg=Config.from_env(env=dict(
            os.environ, FIREBIRD_OBJECT_ROOT=root))), "scope", "ks")
    store = local
    if wrap in ("mirrored", "all"):
        store = tobj.MirroredStore(local, mirror)
    if wrap in ("fenced", "all"):
        store = FencedStore(store, q, lease)
    votes = [rng.random(4).tolist() for _ in range(n)]
    upd = ColumnUpdate(seg, ("rfrawp",))
    upd["rfrawp"] = votes
    if wrap in ("async", "all"):
        writer = AsyncWriter(store)
        writer.write("segment", upd)
        writer.close()
    else:
        store.write("segment", upd)
    assert updated == [True]
    got = local.read("segment", {"cx": 1, "cy": 2})
    assert got == dict(seg, rfrawp=votes)
    if wrap in ("mirrored", "all"):
        rows = mirror.read("segment", {"cx": 1, "cy": 2})
        by_px = dict(zip(rows["px"], rows["rfrawp"]))
        assert [by_px[p] for p in seg["px"]] == votes
    mirror.close()
    q.close()
    local.close()


@pytest.mark.parametrize("backend", ["memory", "sqlite", "object"])
def test_read_of_named_columns_equals_the_whole_read(
        tmp_path, monkeypatch, backend):
    """``read(columns=...)`` gives the named columns of the whole read, in
    that order, with the same filter; on sqlite, a packed column with
    NULL cells between vectors of one length decodes as the JAX package
    reads it."""
    monkeypatch.setenv("FIREBIRD_OBJECT_ROOT", str(tmp_path / "objects"))
    rng = np.random.default_rng(9)
    store = open_store(backend, str(tmp_path / "st"), "ks")
    for cx in (1, 5):
        f = _chip_rows(rng, 25)
        f["cx"] = [cx] * 25
        f["rfrawp"] = [None if i % 4 == 0 else rng.random(3).tolist()
                       for i in range(25)]
        store.write("segment", f)
    where = {"cx": 1, "cy": 2}
    whole = store.read("segment", where)
    names = ("rfrawp", "px", "sday", "blcoef", "chprob")
    part = store.read("segment", where, columns=names)
    assert list(part) == list(names)
    assert part == {c: whole[c] for c in names}
    assert len(part["px"]) == 25
    assert store.read("segment", {"cx": 9, "cy": 2}, columns=names) == {
        c: [] for c in names}
    if backend == "sqlite":
        jstore = JSqliteStore(str(tmp_path / "st"), "ks")
        assert jstore.read("segment", where) == whole
        jstore.close()
    store.close()

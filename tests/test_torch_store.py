"""The port's store against the JAX package's, on the CPU.

``firebird_tpu_torch.store`` is the port's own copy of
``firebird_tpu.store``: the same tables, keys and column types, and the
same sqlite file layout, so a sqlite store one package writes reads the
same rows in the other.  Also the backends' round trips and the async
writer's contract (keyed order, flush, close, peek_error).
"""

import importlib.util
import threading

import numpy as np
import pytest

from firebird_tpu.store import SqliteStore as JSqliteStore
from firebird_tpu.store import schema as jschema
from firebird_tpu_torch import retry as tretry
from firebird_tpu_torch.store import (AsyncWriter, MemoryStore, ParquetStore,
                                      SqliteStore, open_store)
from firebird_tpu_torch.store import schema as tschema

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


@pytest.mark.parametrize("backend", ["object", "cassandra"])
def test_open_store_refuses_unported_backends(tmp_path, backend):
    with pytest.raises(ValueError, match="not ported"):
        open_store(backend, str(tmp_path / "st"), "ks")


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

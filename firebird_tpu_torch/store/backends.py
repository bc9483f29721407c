"""Store backends: memory, sqlite, parquet.

The port's own copy of the JAX package's ``store/backends.py``, less the
Cassandra store (not ported yet; :func:`open_store` refuses it and the
object store by name).

The Store interface: ``write(table, frame)`` upserts a dict-of-columns
frame; ``read(table, where=None)`` returns a dict of columns (optionally
filtered by exact-match key values).  Frames are dicts of equal-length numpy
arrays / lists, as produced by firebird_tpu_torch.ccd.format.chip_frames.

Idempotence: rows are keyed by the table's primary key (schema.py);
re-writing the same key replaces the row — the reference's rerun-upsert
semantics (mode('append') onto Cassandra PKs, ccdc/cassandra.py:62-63,
SURVEY.md §5).
"""

from __future__ import annotations

import json
import math
import os
import sqlite3
import threading
import time

import numpy as np

from firebird_tpu_torch.store import schema


def _retry_locked(fn, attempts: int = 240, delay: float = 0.25):
    """Run fn, retrying while sqlite reports the database locked.

    The WAL-conversion pragma and schema DDL need exclusive access for an
    instant; when several processes open the same store simultaneously
    (multi-host runs sharing one sqlite file) the loser gets 'database is
    locked' immediately rather than waiting on the busy handler.  Setup is
    the only place this can happen — writes ride the busy timeout.
    """
    for attempt in range(attempts):
        try:
            return fn()
        except sqlite3.OperationalError as e:
            if "locked" not in str(e) or attempt == attempts - 1:
                raise
            time.sleep(delay)


def _normalize(v):
    """Plain-Python cell values; NaN becomes None uniformly across backends
    (the reference stores NULL for absent model fields, schema.cql)."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        v = float(v)
    if isinstance(v, float) and math.isnan(v):
        return None
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _col_types(table: str) -> dict[str, str]:
    return dict(schema.TABLES[table]["columns"])


def _encode_cell(v, typ: str):
    """One frame cell -> wire value for the sqlite/cassandra backends:
    JSON columns serialize, packed-array columns become raw little-endian
    bytes, scalars normalize with NaN -> NULL."""
    if typ in schema.PACKED_DTYPES:
        # Pack ndarrays directly — normalizing first would round-trip
        # every row through a Python list on the host-bound egress path.
        if v is None:
            return None
        return np.asarray(v, schema.PACKED_DTYPES[typ]).tobytes()
    v = _normalize(v)
    if v is None:
        return None
    if typ == "JSON":
        return json.dumps(v)
    return v


def _encode_column(frame: dict, c: str, typ: str, n: int) -> list:
    """A whole column encoded at once — the per-cell Python of a naive
    encode loop dominates chip egress (38 cols x ~12k rows per chip)."""
    if c not in frame:
        return [None] * n
    vals = frame[c]
    if typ == "JSON" or typ in schema.PACKED_DTYPES:
        return [_encode_cell(v, typ) for v in vals]
    a = np.asarray(vals)
    if a.dtype == object or a.dtype.kind in "US":
        return [_normalize(v) for v in vals]
    out = a.tolist()
    if a.dtype.kind == "f" and np.isnan(a).any():
        out = [None if v != v else v for v in out]
    return out


def _decode_cell(v, typ: str):
    if v is None:
        return None
    if typ == "JSON":
        return json.loads(v)
    if typ in schema.PACKED_DTYPES:
        return np.frombuffer(v, schema.PACKED_DTYPES[typ]).tolist()
    return v


class MemoryStore:
    """Dict-backed store for tests: {table: {key_tuple: row_dict}}."""

    def __init__(self, keyspace: str = "default"):
        self.keyspace = keyspace
        self._tables: dict[str, dict] = {t: {} for t in schema.TABLES}
        self._lock = threading.Lock()

    def write(self, table: str, frame: dict) -> int:
        key = schema.primary_key(table)
        cols = list(frame.keys())
        n = len(next(iter(frame.values())))
        with self._lock:
            for i in range(n):
                row = {c: _normalize(frame[c][i]) for c in cols}
                self._tables[table][tuple(row[k] for k in key)] = row
        return n

    def read(self, table: str, where: dict | None = None) -> dict:
        with self._lock:
            rows = [r for r in self._tables[table].values()
                    if not where or all(r.get(k) == v for k, v in where.items())]
        cols = schema.columns(table)
        return {c: [r.get(c) for r in rows] for c in cols}

    def count(self, table: str) -> int:
        return len(self._tables[table])

    def chip_ids(self, table: str = "segment") -> set[tuple[int, int]]:
        """Distinct (cx, cy) present in a table (the reference's
        select(cx, cy).distinct(), ccdc/randomforest.py:67)."""
        with self._lock:
            return {k[:2] for k in self._tables[table]}

    def close(self):
        pass


class SqliteStore:
    """Sqlite-backed store with INSERT OR REPLACE upserts.

    One database file per keyspace (the reference namespaces by Cassandra
    keyspace derived from inputs+version, ccdc/__init__.py:29-44; here the
    keyspace is part of the filename).

    ``read_only=True`` opens a **replica connection**: a ``mode=ro`` URI
    open plus ``PRAGMA query_only=ON``, so the handle can never take the
    write lock — N serve replicas tailing one WAL database read
    concurrently with the writer's AsyncWriter and never contend on its
    lock (WAL readers see the last committed transaction; they block
    nothing and nothing blocks them).  Schema DDL is skipped (the writer
    owns it) and ``write`` refuses loudly before sqlite would.
    """

    def __init__(self, path: str, keyspace: str = "default",
                 read_only: bool = False):
        self.read_only = bool(read_only)
        if not self.read_only:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        root, ext = os.path.splitext(path)
        self.path = f"{root}.{keyspace}{ext or '.db'}"
        self.keyspace = keyspace
        if self.read_only and not os.path.exists(self.path):
            raise FileNotFoundError(
                f"read-only replica open of {self.path}: the database "
                "does not exist (the writer creates it; replicas only "
                "ever attach)")
        self._local = threading.local()
        self._all_conns: list[sqlite3.Connection] = []
        self._conns_lock = threading.Lock()
        if not self.read_only:
            self._create()

    def _conn(self) -> sqlite3.Connection:
        if not hasattr(self._local, "conn"):
            # check_same_thread=False so close() can shut every thread's
            # connection down; each thread still only *uses* its own.
            if self.read_only:
                # mode=ro refuses the write lock at the VFS layer;
                # query_only refuses at the SQL layer — defense in
                # depth, and neither converts journal modes (a replica
                # must never run the WAL-conversion DDL the writer owns).
                conn = sqlite3.connect(
                    f"file:{self.path}?mode=ro", uri=True, timeout=60,
                    check_same_thread=False)
                conn.execute("PRAGMA query_only=ON")
            else:
                conn = sqlite3.connect(self.path, timeout=60,
                                       check_same_thread=False)
                _retry_locked(
                    lambda: conn.execute("PRAGMA journal_mode=WAL"))
                # WAL + NORMAL is durable to application crash (not OS
                # crash); the durability model is rerun-idempotence
                # (keyed upserts), so trading fsync-per-commit for write
                # throughput is right.
                conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
            with self._conns_lock:
                self._all_conns.append(conn)
        return self._local.conn

    def _create(self):
        con = self._conn()
        sql_type = lambda typ: ("TEXT" if typ == "JSON" else
                                "BLOB" if typ in schema.PACKED_DTYPES else typ)
        for t, spec in schema.TABLES.items():
            cols = ", ".join(
                f'"{c}" {sql_type(typ)}' for c, typ in spec["columns"])
            pk = ", ".join(spec["key"])
            sql = (f'CREATE TABLE IF NOT EXISTS "{t}" '
                   f'({cols}, PRIMARY KEY ({pk}))')
            _retry_locked(lambda: con.execute(sql))
        # Secondary (cx, cy) index for the serve-path point reads.  The
        # segment PK's autoindex already leads with (cx, cy), but the
        # product PK leads with (name, date) — a `WHERE cx=? AND cy=?`
        # chip read there (serve cache fills, chip_ids) would scan the
        # whole table.  Explicit on both so the serving layer's access
        # pattern is index-backed regardless of which table it reads;
        # tests pin the query plan (tests/test_store.py).
        for t in ("segment", "product"):
            sql = (f'CREATE INDEX IF NOT EXISTS "idx_{t}_chip" '
                   f'ON "{t}" (cx, cy)')
            _retry_locked(lambda: con.execute(sql))
        con.commit()

    def write(self, table: str, frame: dict) -> int:
        if self.read_only:
            raise RuntimeError(
                f"write to {table!r} on a read-only replica connection "
                f"({self.path}): writes belong to the writer process "
                "(open_store(..., read_only=False))")
        types = _col_types(table)
        cols = list(types)
        n = len(next(iter(frame.values())))
        rows = list(zip(*(_encode_column(frame, c, types[c], n)
                          for c in cols)))
        ph = ", ".join("?" * len(cols))
        con = self._conn()
        con.executemany(
            f'INSERT OR REPLACE INTO "{table}" ({", ".join(cols)}) VALUES ({ph})',
            rows)
        con.commit()
        return n

    def read(self, table: str, where: dict | None = None) -> dict:
        types = _col_types(table)
        cols = list(types)
        sql = f'SELECT {", ".join(cols)} FROM "{table}"'
        args: list = []
        if where:
            sql += " WHERE " + " AND ".join(f'"{k}" = ?' for k in where)
            args = list(where.values())
        cur = self._conn().execute(sql, args)
        out: dict[str, list] = {c: [] for c in cols}
        for row in cur:
            for c, v in zip(cols, row):
                out[c].append(_decode_cell(v, types[c]))
        return out

    def count(self, table: str) -> int:
        return self._conn().execute(
            f'SELECT COUNT(*) FROM "{table}"').fetchone()[0]

    def chip_ids(self, table: str = "segment") -> set[tuple[int, int]]:
        k1, k2 = schema.primary_key(table)[:2]
        cur = self._conn().execute(
            f'SELECT DISTINCT "{k1}", "{k2}" FROM "{table}"')
        return {(r[0], r[1]) for r in cur}

    def close(self):
        with self._conns_lock:
            conns, self._all_conns = self._all_conns, []
        for conn in conns:
            try:
                conn.close()
            except sqlite3.Error:
                pass
        if hasattr(self._local, "conn"):
            del self._local.conn


class ParquetStore:
    """Parquet-backed store: one file per (table, partition key prefix).

    Idempotence by construction — a rerun of the same chip rewrites the same
    file.  Suited to bulk analytics egress; requires pyarrow.
    """

    def __init__(self, path: str, keyspace: str = "default"):
        self.root = os.path.join(path, keyspace)
        os.makedirs(self.root, exist_ok=True)

    # Partition prefix per table: one file per chip (cx, cy) for the three
    # result tables; the full (tx, ty, name) key for tile so models with
    # different names never clobber each other.
    _PART = {"chip": 2, "pixel": 2, "segment": 2, "tile": 3, "product": 4}

    def _file(self, table: str, frame: dict) -> str:
        key = schema.primary_key(table)[: self._PART[table]]
        part = "_".join(str(_normalize(frame[k][0])) for k in key)
        d = os.path.join(self.root, table)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{part}.parquet")

    def write(self, table: str, frame: dict) -> int:
        import pyarrow as pa
        import pyarrow.parquet as pq
        # One frame = one partition: the file is named after row 0's key
        # prefix, so rows for a second chip would silently land in (and
        # clobber) the first chip's file.
        keyp = schema.primary_key(table)[: self._PART[table]]
        first = tuple(_normalize(frame[k][0]) for k in keyp)
        for i in range(1, len(frame[keyp[0]])):
            if tuple(_normalize(frame[k][i]) for k in keyp) != first:
                raise ValueError(
                    f"ParquetStore.write({table!r}): frame spans multiple "
                    f"partitions {first} vs row {i}; write one partition "
                    "per frame")
        cols = {c: [_normalize(v) for v in frame[c]] for c in frame}
        pq.write_table(pa.table(cols), self._file(table, frame))
        return len(next(iter(frame.values())))

    def read(self, table: str, where: dict | None = None) -> dict:
        import pyarrow.parquet as pq
        d = os.path.join(self.root, table)
        cols = schema.columns(table)
        out: dict[str, list] = {c: [] for c in cols}
        if not os.path.isdir(d):
            return out
        # When the filter pins the whole partition key prefix, only that
        # partition's file can match — skip the full-table scan (a per-chip
        # read over a tile would otherwise be O(chips^2) file reads).
        keyp = schema.primary_key(table)[: self._PART[table]]
        if where and all(k in where for k in keyp):
            part = "_".join(str(_normalize(where[k])) for k in keyp)
            files = [f"{part}.parquet"] if os.path.exists(
                os.path.join(d, f"{part}.parquet")) else []
        else:
            files = sorted(os.listdir(d))
        for f in files:
            t = pq.read_table(os.path.join(d, f)).to_pydict()
            n = len(next(iter(t.values()), []))
            for i in range(n):
                if where and any(t.get(k, [None] * n)[i] != v
                                 for k, v in where.items()):
                    continue
                for c in cols:
                    out[c].append(t.get(c, [None] * n)[i])
        return out

    def count(self, table: str) -> int:
        return len(self.read(table)["cx" if table != "tile" else "tx"])

    def chip_ids(self, table: str = "segment") -> set[tuple[int, int]]:
        d = os.path.join(self.root, table)
        if not os.path.isdir(d):
            return set()
        # One file per (cx, cy) partition: parse keys from filenames,
        # skipping anything that isn't a well-formed partition file.
        out = set()
        for f in os.listdir(d):
            stem, ext = os.path.splitext(f)
            parts = stem.split("_")
            if ext != ".parquet" or len(parts) < 2:
                continue
            try:
                out.add((int(parts[0]), int(parts[1])))
            except ValueError:
                continue
        return out

    def close(self):
        pass


def open_store(backend: str, path: str, keyspace: str,
               read_only: bool = False):
    """The store of a backend name (cfg.store_backend): 'sqlite' (its rows
    in the keyspace-suffixed file next to ``path``, :class:`SqliteStore`),
    'parquet' (:class:`ParquetStore`; needs pyarrow, imported at first
    use) or 'memory'.  ``read_only=True`` opens a sqlite replica
    connection; the other backends refuse it.  The object store and
    Cassandra are not ported yet: naming them raises."""
    from firebird_tpu_torch.config import NOT_PORTED_BACKENDS

    if backend in NOT_PORTED_BACKENDS:
        raise ValueError(f"store backend {backend!r}: "
                         f"{NOT_PORTED_BACKENDS[backend]} is not ported to "
                         f"firebird_tpu_torch yet")
    if read_only and backend != "sqlite":
        raise ValueError(
            f"read_only is a sqlite replica mode; backend {backend!r} "
            "has no writer lock for replicas to avoid")
    if backend == "sqlite":
        return SqliteStore(path, keyspace, read_only=read_only)
    if backend == "memory":
        return MemoryStore(keyspace)
    if backend == "parquet":
        return ParquetStore(path, keyspace)
    raise ValueError(f"unknown store backend: {backend!r}")

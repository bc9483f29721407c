"""Store backends: memory, sqlite, parquet, Cassandra and the object tier.

The port's own copy of the JAX package's ``store/backends.py``.  The
object backend and the write-through mirror live in
``store/objectstore.py``.

The Store interface: ``write(table, frame)`` upserts a dict-of-columns
frame; ``read(table, where=None, columns=None)`` returns a dict of columns
(optionally filtered by exact-match key values, and optionally only the
named columns).  Frames are dicts of equal-length numpy
arrays / lists, as produced by firebird_tpu_torch.ccd.format.chip_frames.

Idempotence: rows are keyed by the table's primary key (schema.py);
re-writing the same key replaces the row — the reference's rerun-upsert
semantics (mode('append') onto Cassandra PKs, ccdc/cassandra.py:62-63,
SURVEY.md §5).  A :class:`ColumnUpdate` frame (rows read back from the
store with some columns changed) is upserted the same way by every
backend; the sqlite store writes its changed columns alone.  Every
backend's ``read`` takes ``columns=``, a parameter the JAX package's
stores lack.
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


class ColumnUpdate(dict):
    """A whole frame of rows read from the store in which only ``columns``
    changed: every other cell equals the stored row's.  Upserting it and
    updating those columns of the keyed rows leave the same table, so
    :meth:`SqliteStore.write` updates just those columns (and upserts
    the frame when a row is no longer there); the other backends upsert
    it like any frame."""

    def __init__(self, frame: dict, columns):
        super().__init__(frame)
        self.columns = tuple(columns)


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


def _decode_column(col, typ: str) -> list:
    """A whole column decoded at once: :func:`_decode_cell` of each
    cell."""
    if typ == "JSON":
        return [None if v is None else json.loads(v) for v in col]
    if typ in schema.PACKED_DTYPES:
        dt = np.dtype(schema.PACKED_DTYPES[typ])
        nulls = col.count(None)
        blobs = col if not nulls else [v for v in col if v is not None]
        sizes = set(map(len, blobs))
        if len(sizes) != 1 or 0 in sizes:
            return [None if v is None else np.frombuffer(v, dt).tolist()
                    for v in col]
        # One blob length: one frombuffer over the column's bytes, the
        # NULL cells put back in place.
        vecs = np.frombuffer(b"".join(blobs), dt).reshape(
            len(blobs), sizes.pop() // dt.itemsize).tolist()
        if not nulls:
            return vecs
        it = iter(vecs)
        return [None if v is None else next(it) for v in col]
    return list(col)


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

    def read(self, table: str, where: dict | None = None,
             columns=None) -> dict:
        with self._lock:
            rows = [r for r in self._tables[table].values()
                    if not where or all(r.get(k) == v for k, v in where.items())]
        cols = list(columns or schema.columns(table))
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
        con = self._conn()
        if isinstance(frame, ColumnUpdate) and self._update(
                con, table, frame, types, n):
            return n
        rows = list(zip(*(_encode_column(frame, c, types[c], n)
                          for c in cols)))
        ph = ", ".join("?" * len(cols))
        con.executemany(
            f'INSERT OR REPLACE INTO "{table}" ({", ".join(cols)}) VALUES ({ph})',
            rows)
        con.commit()
        return n

    @staticmethod
    def _update(con, table: str, frame: ColumnUpdate, types: dict,
                n: int) -> bool:
        """``frame``'s changed columns written onto its keyed rows in one
        transaction; False (nothing written) when a row is missing, and
        the caller upserts the whole frame instead."""
        key = list(schema.primary_key(table))
        sets = [c for c in frame.columns if c not in key]
        rows = list(zip(*(_encode_column(frame, c, types[c], n)
                          for c in sets + key)))
        cur = con.executemany(
            f'UPDATE "{table}" SET '
            + ", ".join(f'"{c}" = ?' for c in sets) + " WHERE "
            + " AND ".join(f'"{k}" = ?' for k in key), rows)
        if cur.rowcount != n:
            con.rollback()
            return False
        con.commit()
        return True

    def read(self, table: str, where: dict | None = None,
             columns=None) -> dict:
        types = _col_types(table)
        cols = list(columns or types)
        sql = f'SELECT {", ".join(cols)} FROM "{table}"'
        args: list = []
        if where:
            sql += " WHERE " + " AND ".join(f'"{k}" = ?' for k in where)
            args = list(where.values())
        rows = self._conn().execute(sql, args).fetchall()
        if not rows:
            return {c: [] for c in cols}
        # Decoded a column at a time: the scalar columns pass through as
        # sqlite gave them, only JSON and packed cells are decoded (a
        # per-cell decode call dominated a chip's read).
        return {c: _decode_column(col, types[c])
                for c, col in zip(cols, zip(*rows))}

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

    def read(self, table: str, where: dict | None = None,
             columns=None) -> dict:
        import pyarrow.parquet as pq
        d = os.path.join(self.root, table)
        cols = list(columns or schema.columns(table))
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


def sanitize_keyspace(keyspace: str) -> str:
    """A valid unquoted CQL keyspace identifier (cqlstr semantics,
    ccdc/__init__.py:44; CQL's unquoted-identifier grammar requires a
    leading *letter*, so digit- and underscore-leading names are prefixed
    ``ks_``).  A non-letter-leading name could never have been created
    unquoted by Cassandra itself, so the prefix cannot orphan existing
    data."""
    from firebird_tpu_torch.config import _cqlstr

    ks = _cqlstr(keyspace) or "default"
    return ks if ks[0].isalpha() else f"ks_{ks}"


def cassandra_ddl(keyspace: str, replication: int = 1) -> list[str]:
    """The CQL DDL statements for the result tables — the reference ships
    these as resources/schema.cql and loads them with `make db-schema`
    (Makefile:24-39); here the single source of truth is schema.TABLES and
    this generator (printed by the ``schema`` command, executed verbatim
    by CassandraStore._ensure_schema)."""
    ks = sanitize_keyspace(keyspace)
    stmts = [
        f"CREATE KEYSPACE IF NOT EXISTS {ks} WITH replication"
        f" = {{'class': 'SimpleStrategy', 'replication_factor': "
        f"{int(replication)}}}"]
    for t, spec in schema.TABLES.items():
        cols = ", ".join(f"{c} {CassandraStore._TYPES[typ]}"
                         for c, typ in spec["columns"])
        key = spec["key"]
        pk = (f"(({key[0]}, {key[1]})"
              + ("".join(f", {k}" for k in key[2:])) + ")")
        stmts.append(f"CREATE TABLE IF NOT EXISTS {ks}.{t} "
                     f"({cols}, PRIMARY KEY {pk})")
    return stmts


class CassandraStore:
    """Store over Apache Cassandra — the reference's production sink.

    Parity with ccdc/cassandra.py + resources/schema.cql:
    - same four (+product) tables; partition key = the first two key
      columns, remaining key columns clustering — the natural-key PKs that
      make rerun writes idempotent upserts (schema.cql:34,54,142;
      mode('append'), cassandra.py:62-63).
    - QUORUM consistency and bounded concurrent writes (cassandra.py:20-26,
      reference default 2 concurrent writes).
    - keyspace per inputs+version (ccdc/__init__.py:29-44 — Config.keyspace).

    Array-valued columns are JSON-encoded text (uniform with the sqlite
    backend) rather than frozen<list<...>>; the key design, not the cell
    encoding, carries the durability semantics.  A :class:`ColumnUpdate`
    is upserted as whole rows, as any frame; ``read(..., columns=)``
    selects the named columns alone.

    ``session`` is injectable (the tests pass a recording fake).  Without
    it, the DataStax ``cassandra-driver`` package is required and a clear
    error is raised when absent — the driver is not bundled.
    """

    _TYPES = {"INTEGER": "bigint", "REAL": "double", "TEXT": "text",
              "JSON": "text", "BITS": "blob", "F64S": "blob", "I32S": "blob"}

    def __init__(self, contact_points=("127.0.0.1",), port: int = 9042,
                 keyspace: str = "default", username: str = "",
                 password: str = "", concurrent_writes: int = 2,
                 replication: int = 1, session=None):
        self.keyspace = sanitize_keyspace(keyspace)
        self.concurrent_writes = max(int(concurrent_writes), 1)
        self._replication = int(replication)
        self._cluster = None
        if session is None:
            session = self._connect(contact_points, port, username, password)
        self.session = session
        self._prepared: dict[str, object] = {}
        self._ensure_schema()

    def _connect(self, contact_points, port, username, password):
        try:
            from cassandra.cluster import Cluster
        except ImportError as e:
            raise RuntimeError(
                "store backend 'cassandra' needs the cassandra-driver "
                "package (or pass an explicit session=); install it or use "
                "the sqlite/parquet backends") from e
        auth = None
        if username:
            from cassandra.auth import PlainTextAuthProvider
            auth = PlainTextAuthProvider(username=username, password=password)
        self._cluster = Cluster(list(contact_points), port=port,
                                auth_provider=auth)
        session = self._cluster.connect()
        from cassandra import ConsistencyLevel
        session.default_consistency_level = ConsistencyLevel.QUORUM
        return session

    def _ensure_schema(self):
        for stmt in cassandra_ddl(self.keyspace, self._replication):
            self.session.execute(stmt)

    def _prepare(self, table: str):
        if table not in self._prepared:
            cols = schema.columns(table)
            ph = ", ".join("?" * len(cols))
            self._prepared[table] = self.session.prepare(
                f"INSERT INTO {self.keyspace}.{table} "
                f"({', '.join(cols)}) VALUES ({ph})")
        return self._prepared[table]

    def write(self, table: str, frame: dict) -> int:
        types = _col_types(table)
        cols = list(types)
        stmt = self._prepare(table)
        n = len(next(iter(frame.values())))
        rows = zip(*(_encode_column(frame, c, types[c], n) for c in cols))
        # Bounded in-flight async writes (the reference's
        # spark.cassandra.output.concurrent.writes, ccdc/__init__.py:20).
        pending = []
        for row in rows:
            pending.append(self.session.execute_async(stmt, row))
            if len(pending) >= self.concurrent_writes:
                pending.pop(0).result()
        for f in pending:
            f.result()
        return n

    def read(self, table: str, where: dict | None = None,
             columns=None) -> dict:
        types = _col_types(table)
        cols = list(columns or types)
        cql = f"SELECT {', '.join(cols)} FROM {self.keyspace}.{table}"
        params: tuple = ()
        if where:
            cql += " WHERE " + " AND ".join(f"{k} = %s" for k in where)
            cql += " ALLOW FILTERING"
            params = tuple(_normalize(v) for v in where.values())
        out: dict[str, list] = {c: [] for c in cols}
        for row in self.session.execute(cql, params):
            for c, v in zip(cols, row):
                out[c].append(_decode_cell(v, types[c]))
        return out

    def count(self, table: str) -> int:
        rows = self.session.execute(
            f"SELECT COUNT(*) FROM {self.keyspace}.{table}", ())
        return int(next(iter(rows))[0])

    def chip_ids(self, table: str = "segment") -> set[tuple[int, int]]:
        # The first two key columns are exactly the partition key, so
        # DISTINCT reads only partition keys — a full-row scan here would
        # stream millions of segment rows just to dedupe chips (the resume
        # path, driver/core.py).
        k1, k2 = schema.primary_key(table)[:2]
        rows = self.session.execute(
            f"SELECT DISTINCT {k1}, {k2} FROM {self.keyspace}.{table}", ())
        return {(r[0], r[1]) for r in rows}

    def close(self):
        if self._cluster is not None:
            self._cluster.shutdown()


def open_store(backend: str, path: str, keyspace: str,
               read_only: bool = False):
    """The store of a backend name (cfg.store_backend): 'sqlite' (its rows
    in the keyspace-suffixed file next to ``path``, :class:`SqliteStore`),
    'parquet' (:class:`ParquetStore`; needs pyarrow, imported at first
    use), 'memory', 'cassandra' (:class:`CassandraStore`; needs
    cassandra-driver), or 'object' (``objectstore.ObjectBackedStore`` over
    FIREBIRD_OBJECT_ROOT, ``path`` scoping its keys).  ``read_only=True``
    opens a sqlite replica connection or a read-only object handle; the
    other backends refuse it.  With FIREBIRD_OBJECT_ROOT set, a local
    backend's writes also publish to the object tier, object first
    (:func:`_maybe_mirror`).

    For the 'cassandra' backend, connection settings come from the
    reference's env contract (ccdc/__init__.py:17-22): CASSANDRA
    (contact host[,host...]), CASSANDRA_PORT, CASSANDRA_USER,
    CASSANDRA_PASS, CASSANDRA_OUTPUT_CONCURRENT_WRITES — credentials stay
    in the environment, not in Config.
    """
    if read_only and backend not in ("sqlite", "object"):
        raise ValueError(
            f"read_only is a sqlite replica mode; backend {backend!r} "
            "has no writer lock for replicas to avoid")
    if backend == "object":
        # Object-native: shards, manifests and fencing all live in the
        # object tier; ``path`` only scopes the key prefix so distinct
        # logical stores share one root safely.
        from firebird_tpu_torch.store import objectstore as objlib
        return objlib.ObjectBackedStore(
            objlib.open_object_root(), objlib.scope_for_path(path),
            keyspace, read_only=read_only)
    if backend == "sqlite":
        store = SqliteStore(path, keyspace, read_only=read_only)
        return _maybe_mirror(store, path, keyspace, read_only)
    if backend == "cassandra":
        hosts = os.environ.get("CASSANDRA", "127.0.0.1").split(",")
        return CassandraStore(
            contact_points=[h.strip() for h in hosts if h.strip()],
            port=int(os.environ.get("CASSANDRA_PORT", "9042")),
            keyspace=keyspace,
            username=os.environ.get("CASSANDRA_USER", ""),
            password=os.environ.get("CASSANDRA_PASS", ""),
            concurrent_writes=int(
                os.environ.get("CASSANDRA_OUTPUT_CONCURRENT_WRITES", "2")))
    if backend == "memory":
        return _maybe_mirror(MemoryStore(keyspace), path, keyspace, False)
    if backend == "parquet":
        return _maybe_mirror(ParquetStore(path, keyspace), path, keyspace,
                             False)
    raise ValueError(f"unknown store backend: {backend!r}")


def _maybe_mirror(store, path: str, keyspace: str, read_only: bool):
    """Wrap a local store in the object tier's write-through mirror
    (``objectstore.MirroredStore``) when FIREBIRD_OBJECT_ROOT is set, as
    the JAX package does: every ``open_store`` call site (driver, stream,
    fleet workers, the command line) inherits the mirror from the
    environment.  Local files stay read-authoritative; writes publish to
    the object tier first, so a zombie's stale-fence write is rejected
    there before any local byte lands.  Read-only replicas never write,
    so they are not wrapped."""
    from firebird_tpu_torch.config import env_knob
    if read_only or not env_knob("FIREBIRD_OBJECT_ROOT"):
        return store
    from firebird_tpu_torch.store import objectstore as objlib
    mirror = objlib.ObjectBackedStore(
        objlib.open_object_root(), objlib.scope_for_path(path), keyspace)
    return objlib.MirroredStore(store, mirror)

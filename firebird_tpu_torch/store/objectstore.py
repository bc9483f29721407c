"""The object tier: the port's own copy of the JAX package's
``store/objectstore.py``, with its on-disk layout byte for byte, so an
object either package wrote reads in the other.

One storage plane under the durable state: a minimal **ObjectStore
protocol** (``put/get/list/delete/head`` plus a *conditional put keyed on
object generation*) with content-addressed chunking and a
manifest-commit publish step, so a multi-chunk upload is invisible until
one atomic final write lands.

Layout of the local-directory implementation::

    <root>/chunks/<sha256>                      content-addressed chunks
    <root>/keys/<quoted-key>/g<N>.json          per-generation manifests
    <root>/keys/<quoted-key>/.lock              conditional-put lock

Invariants:

- **Atomic publish.** Chunks upload first; the object only becomes
  visible when its manifest commits via tmp+rename.  A SIGKILL between
  the last chunk upload and the manifest commit leaves *no visible
  object* — just orphaned chunks that ``scrub`` reclaims after a grace
  window (never sooner, so a live writer's not-yet-committed chunks
  survive the scrub race).
- **Conditional put.** ``put(key, data, if_generation=g)`` succeeds only
  if the newest committed generation is exactly ``g`` (``0`` = the key
  must not exist).  Losers get :class:`PreconditionFailed` — a
  :class:`~firebird_tpu_torch.retry.NonRetryable`, so retry wrappers
  re-raise instead of burning budget on a race they already lost.
- **Generation fallback.** The last two generations are retained (the
  object-tier analogue of the statestore's double-bank slots).  ``get``
  verifies every chunk's sha256+size against the manifest and falls
  back one generation on a torn newest (``objectstore_torn_recoveries``
  counts it).
- **Fencing at the object layer.** :class:`ObjectBackedStore` stamps the
  fleet fencing token into each shard's manifest metadata; a zombie
  whose fence is older than the stored one is rejected *before any
  bytes land* (:class:`StaleObjectFence`, counted durably in the
  ``_meta/fence_rejects`` object and by ``object_fence_rejected_total``).

Every operation is fault-injectable (faults.py ``object`` scope,
including the ``torn`` kind that commits a truncated chunk or drops the
manifest write) and routes through ``retry.RetryPolicy.for_object`` with
the shared budget/breaker (:func:`open_object_root`).  Nothing here
imports torch.
"""

from __future__ import annotations

import base64
import dataclasses
import fcntl
import hashlib
import json
import os
import threading
import time
import urllib.parse

import numpy as np

from firebird_tpu_torch import retry as retrylib
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.store import schema
from firebird_tpu_torch.store.backends import _col_types, _normalize

# Retained generations per key: newest + one fallback — the double-bank
# contract (statestore.py slot banks) lifted to the object tier.
KEEP_GENERATIONS = 2

DEFAULT_CHUNK_SIZE = 256 * 1024


class ObjectStoreError(OSError):
    """Base for object-tier failures (transient unless subclassed)."""


class PreconditionFailed(ObjectStoreError, retrylib.NonRetryable):
    """Conditional put lost the generation race.

    NonRetryable: replaying the same put can never succeed — the caller
    must re-read and merge, not spend retry budget.
    """

    def __init__(self, msg: str, current: int = -1):
        super().__init__(msg)
        self.current = current


class StaleObjectFence(ObjectStoreError, retrylib.NonRetryable):
    """A zombie's write arrived with a fencing token older than one
    already stamped on the object — rejected before any bytes landed."""


@dataclasses.dataclass(frozen=True)
class ObjectMeta:
    """head() result: the committed manifest, minus the bytes."""

    key: str
    generation: int
    size: int
    chunks: tuple  # ((sha256, size), ...)
    meta: dict
    updated: float


class LocalObjectStore:
    """Local-directory reference implementation of the protocol.

    Process- and thread-safe: conditional puts serialize on a per-key
    ``fcntl`` lock file, chunk and manifest writes are tmp+rename (both
    idempotent — chunks are content-addressed, manifests are
    per-generation), and readers never take the lock.
    """

    def __init__(self, root: str, chunk_size: int = DEFAULT_CHUNK_SIZE):
        self.root = root
        self.chunk_size = max(int(chunk_size), 1)
        self._chunk_dir = os.path.join(root, "chunks")
        self._key_dir = os.path.join(root, "keys")
        os.makedirs(self._chunk_dir, exist_ok=True)
        os.makedirs(self._key_dir, exist_ok=True)
        self._lock = threading.Lock()  # serialize same-process putters

    # -- key <-> directory mapping ---------------------------------------

    def _kdir(self, key: str) -> str:
        return os.path.join(self._key_dir,
                            urllib.parse.quote(key, safe=""))

    @staticmethod
    def _unq(name: str) -> str:
        return urllib.parse.unquote(name)

    def _generations(self, kdir: str) -> list[int]:
        """Committed generation numbers for a key, newest first."""
        try:
            names = os.listdir(kdir)
        except OSError:
            return []
        gens = []
        for n in names:
            if n.startswith("g") and n.endswith(".json"):
                try:
                    gens.append(int(n[1:-5]))
                except ValueError:
                    continue
        return sorted(gens, reverse=True)

    def _manifest(self, kdir: str, gen: int) -> dict | None:
        try:
            with open(os.path.join(kdir, f"g{gen}.json"), "rb") as f:
                m = json.loads(f.read())
        except (OSError, ValueError):
            return None
        if not isinstance(m, dict) or "chunks" not in m:
            return None
        return m

    @staticmethod
    def _meta_of(key: str, gen: int, m: dict) -> ObjectMeta:
        return ObjectMeta(
            key=key, generation=gen, size=int(m.get("size", 0)),
            chunks=tuple((c[0], int(c[1])) for c in m["chunks"]),
            meta=dict(m.get("meta") or {}),
            updated=float(m.get("updated", 0.0)))

    # -- chunk plumbing ---------------------------------------------------

    def _chunk_path(self, sha: str) -> str:
        return os.path.join(self._chunk_dir, sha)

    def _put_chunk(self, sha: str, blob: bytes, force: bool = False):
        path = self._chunk_path(sha)
        if not force and os.path.exists(path):
            return  # content-addressed: identical bytes already landed
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _read_chunk(self, sha: str, size: int) -> bytes:
        with open(self._chunk_path(sha), "rb") as f:
            blob = f.read()
        if len(blob) != size or hashlib.sha256(blob).hexdigest() != sha:
            raise ObjectStoreError(
                f"chunk {sha[:12]} torn: {len(blob)} bytes vs manifest "
                f"{size}")
        return blob

    # -- the protocol -----------------------------------------------------

    def put(self, key: str, data: bytes, *, if_generation: int | None = None,
            meta: dict | None = None, _torn: str | None = None) -> ObjectMeta:
        """Publish ``data`` under ``key`` as generation N+1.

        ``if_generation`` makes the put conditional: it succeeds only
        when the newest committed generation equals it (0 = key must not
        exist); otherwise :class:`PreconditionFailed`.

        ``_torn`` is the fault-injection hatch (faults.py ``torn`` kind):
        ``"chunk"`` commits the manifest over a truncated final chunk,
        ``"manifest"`` uploads every chunk and drops the commit — the
        two halves of a torn multi-part upload.
        """
        data = bytes(data)
        chunks = []
        for off in range(0, max(len(data), 1), self.chunk_size):
            blob = data[off:off + self.chunk_size]
            sha = hashlib.sha256(blob).hexdigest()
            if _torn == "chunk" and off + self.chunk_size >= len(data):
                # Commit a truncated final chunk under the full-content
                # sha — the manifest will promise bytes that are not
                # there, which is exactly what readers must survive.
                self._put_chunk(sha, blob[:max(len(blob) - 1, 0)],
                                force=True)
            else:
                self._put_chunk(sha, blob)
            chunks.append((sha, len(blob)))

        if _torn == "manifest":
            # The upload dies before the commit: chunks are orphaned
            # debris for scrub; the object (this generation) never
            # becomes visible.
            return self.head(key) or ObjectMeta(key, 0, 0, (), {}, 0.0)

        from firebird_tpu_torch.config import env_knob
        hold = float(env_knob("FIREBIRD_OBJECT_COMMIT_HOLD_SEC") or 0)
        if hold > 0:
            # Chaos hook: widen the chunk-upload -> manifest-commit
            # window so a SIGKILL can land inside it deterministically.
            time.sleep(hold)

        kdir = self._kdir(key)
        os.makedirs(kdir, exist_ok=True)
        with self._lock, open(os.path.join(kdir, ".lock"), "a+") as lk:
            fcntl.lockf(lk, fcntl.LOCK_EX)
            gens = self._generations(kdir)
            cur = gens[0] if gens else 0
            if if_generation is not None and cur != if_generation:
                obs_metrics.counter(
                    "objectstore_conflicts",
                    help="conditional puts that lost the generation race"
                ).inc()
                raise PreconditionFailed(
                    f"put {key!r}: expected generation {if_generation}, "
                    f"found {cur}", current=cur)
            gen = cur + 1
            m = {"key": key, "generation": gen, "size": len(data),
                 "chunks": chunks, "meta": dict(meta or {}),
                 "updated": time.time()}
            path = os.path.join(kdir, f"g{gen}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(json.dumps(m).encode())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            for old in gens[KEEP_GENERATIONS - 1:]:
                try:
                    os.unlink(os.path.join(kdir, f"g{old}.json"))
                except OSError:
                    pass
        obs_metrics.counter(
            "objectstore_puts",
            help="objects published (manifest commits)").inc()
        return self._meta_of(key, gen, m)

    def get(self, key: str) -> tuple[bytes, ObjectMeta]:
        """Newest verifiable generation's bytes.

        Every chunk is checked against the manifest's sha256+size; a
        torn newest generation falls back one generation — the same
        recovery the packed statestore's double-bank CRC slots give."""
        kdir = self._kdir(key)
        gens = self._generations(kdir)
        if not gens:
            raise KeyError(f"object {key!r} does not exist")
        last_err: Exception | None = None
        for i, gen in enumerate(gens):
            m = self._manifest(kdir, gen)
            if m is None:
                continue
            try:
                data = b"".join(self._read_chunk(sha, size)
                                for sha, size in m["chunks"])
            except OSError as e:
                last_err = e
                continue
            if i > 0:
                obs_metrics.counter(
                    "objectstore_torn_recoveries",
                    help=("reads that fell back a generation past a "
                          "torn newest object")).inc()
            obs_metrics.counter("objectstore_gets",
                                help="object reads served").inc()
            return data, self._meta_of(key, gen, m)
        raise ObjectStoreError(
            f"object {key!r}: no verifiable generation "
            f"(newest error: {last_err})")

    def head(self, key: str) -> ObjectMeta | None:
        kdir = self._kdir(key)
        for gen in self._generations(kdir):
            m = self._manifest(kdir, gen)
            if m is not None:
                return self._meta_of(key, gen, m)
        return None

    def list(self, prefix: str = "") -> list[str]:
        try:
            names = os.listdir(self._key_dir)
        except OSError:
            return []
        out = []
        for n in sorted(names):
            key = self._unq(n)
            if key.startswith(prefix) and self._generations(
                    os.path.join(self._key_dir, n)):
                out.append(key)
        return out

    def delete(self, key: str) -> None:
        """Drop every generation of a key (chunks become scrub debris)."""
        kdir = self._kdir(key)
        try:
            names = os.listdir(kdir)
        except OSError:
            return
        for n in names:
            try:
                os.unlink(os.path.join(kdir, n))
            except OSError:
                pass
        try:
            os.rmdir(kdir)
        except OSError:
            pass

    # -- maintenance ------------------------------------------------------

    def _referenced(self) -> set[str]:
        refs: set[str] = set()
        try:
            names = os.listdir(self._key_dir)
        except OSError:
            return refs
        for n in names:
            kdir = os.path.join(self._key_dir, n)
            for gen in self._generations(kdir):
                m = self._manifest(kdir, gen)
                if m:
                    refs.update(sha for sha, _ in m["chunks"])
        return refs

    def scrub(self, grace_sec: float = 60.0, dry_run: bool = False) -> dict:
        """Reclaim chunks unreferenced by any retained manifest.

        Only chunks older than ``grace_sec`` go — a live writer's
        chunks-uploaded-manifest-pending window is younger than any sane
        grace, so the scrub-vs-live-writer race resolves to "keep"."""
        refs = self._referenced()
        now = time.time()
        removed = kept_young = 0
        try:
            names = os.listdir(self._chunk_dir)
        except OSError:
            names = []
        for n in names:
            if n in refs:
                continue
            path = os.path.join(self._chunk_dir, n)
            try:
                age = now - os.stat(path).st_mtime
            except OSError:
                continue
            if age < grace_sec:
                kept_young += 1
                continue
            if not dry_run:
                try:
                    os.unlink(path)
                except OSError:
                    continue
            removed += 1
        if removed and not dry_run:
            obs_metrics.counter(
                "objectstore_scrubbed_chunks",
                help="orphaned chunks reclaimed by the scrubber"
            ).inc(removed)
        return {"removed": removed, "kept_young": kept_young,
                "referenced": len(refs), "dry_run": bool(dry_run)}

    def census(self) -> dict:
        """Key/manifest/chunk/orphan counts — never raises (the status
        view must degrade honestly on a corrupt root, not crash)."""
        out = {"root": self.root, "keys": 0, "manifests": 0, "chunks": 0,
               "orphan_chunks": 0, "chunk_bytes": 0, "junk": 0}
        refs: set[str] = set()
        try:
            names = os.listdir(self._key_dir)
        except OSError as e:
            out["error"] = f"{type(e).__name__}: {e}"
            return out
        for n in names:
            kdir = os.path.join(self._key_dir, n)
            gens = self._generations(kdir)
            parsed = 0
            for gen in gens:
                m = self._manifest(kdir, gen)
                if m is None:
                    out["junk"] += 1
                    continue
                parsed += 1
                refs.update(sha for sha, _ in m["chunks"])
            if parsed:
                out["keys"] += 1
                out["manifests"] += parsed
            elif gens:
                out["junk"] += 1
        try:
            chunk_names = os.listdir(self._chunk_dir)
        except OSError as e:
            out["error"] = f"{type(e).__name__}: {e}"
            return out
        for n in chunk_names:
            if n.endswith(".tmp") or ".tmp." in n:
                out["junk"] += 1
                continue
            out["chunks"] += 1
            try:
                out["chunk_bytes"] += os.stat(
                    os.path.join(self._chunk_dir, n)).st_size
            except OSError:
                pass
            if n not in refs:
                out["orphan_chunks"] += 1
        return out

    def close(self) -> None:
        pass


class RetryingObjectStore:
    """Every object operation through one shared ``RetryPolicy``.

    Transient injected faults (ioerror/timeout/conn) heal inline under
    the run's budget/breaker; :class:`PreconditionFailed`,
    :class:`StaleObjectFence`, and the torn kind are NonRetryable and
    surface immediately (a lost race or a torn upload is a fact, not a
    blip)."""

    def __init__(self, inner, policy: retrylib.RetryPolicy):
        self._inner = inner
        self._policy = policy
        import logging
        self._log = logging.getLogger("firebird.objectstore")

    def _run(self, what: str, fn):
        return self._policy.run(self._log, what, fn)

    def put(self, key, data, **kw):
        return self._run(f"object put {key}",
                         lambda: self._inner.put(key, data, **kw))

    def get(self, key):
        return self._run(f"object get {key}", lambda: self._inner.get(key))

    def head(self, key):
        return self._run(f"object head {key}", lambda: self._inner.head(key))

    def list(self, prefix=""):
        return self._run(f"object list {prefix!r}",
                         lambda: self._inner.list(prefix))

    def delete(self, key):
        return self._run(f"object delete {key}",
                         lambda: self._inner.delete(key))

    def __getattr__(self, name):
        return getattr(self._inner, name)


def cas_update(store, key: str, fn, attempts: int = 64) -> bytes:
    """Atomic read-modify-write of one object via conditional put.

    ``fn(old_bytes_or_None) -> new_bytes``; loops on
    :class:`PreconditionFailed` (somebody else won the generation race —
    re-read and reapply)."""
    for _ in range(attempts):
        h = store.head(key)
        if h is None:
            old, gen = None, 0
        else:
            # Precondition on head()'s newest committed generation, not
            # get()'s — a torn newest makes get fall back a generation,
            # and a put conditioned on the fallback gen can never land.
            old, _ = store.get(key)
            gen = h.generation
        try:
            new = fn(old)
            store.put(key, new, if_generation=gen)
            return new
        except PreconditionFailed:
            continue
    raise ObjectStoreError(
        f"cas_update {key!r}: lost the generation race {attempts} times")


def scope_for_path(path: str) -> str:
    """Stable per-store key-prefix scope, so two runs pointing different
    local store paths at ONE object root never collide."""
    return hashlib.sha256(
        os.path.abspath(path).encode()).hexdigest()[:12]


# -- the Store facade ------------------------------------------------------

# Shard partitioning: leading primary-key columns per table — the same
# one-file-per-chip rule ParquetStore uses (backends.ParquetStore._PART),
# so a chip rerun rewrites exactly its own shard.
_PART = {"chip": 2, "pixel": 2, "segment": 2, "tile": 3, "product": 4}


def _encode_cell_json(v, typ: str):
    """One cell -> JSON-safe wire value: packed arrays base64, scalars
    normalized NaN->None, JSON columns stay structured."""
    if typ in schema.PACKED_DTYPES:
        if v is None:
            return None
        return base64.b64encode(
            np.asarray(v, schema.PACKED_DTYPES[typ]).tobytes()).decode()
    return _normalize(v)


def _decode_cell_json(v, typ: str):
    """Inverse of :func:`_encode_cell_json`, matching SqliteStore's
    decoded cell values (packed columns come back as plain lists)."""
    if v is None:
        return None
    if typ in schema.PACKED_DTYPES:
        return np.frombuffer(base64.b64decode(v),
                             schema.PACKED_DTYPES[typ]).tolist()
    return v


class ObjectBackedStore:
    """The Store interface (write/read/count/chip_ids) over ObjectStore.

    One object per (table, partition-key prefix) shard; the shard body
    is a JSON document of rows keyed by primary key, merged under a
    conditional-put loop so concurrent writers to one shard serialize on
    generations instead of clobbering.

    ``bind_fence`` stamps the fleet fencing token into every shard's
    manifest metadata; a staler writer is rejected at the object layer
    (:class:`StaleObjectFence`) before any row lands, and the rejection
    is counted durably in the scope's ``_meta/fence_rejects`` object.
    """

    FENCE_REJECTS_KEY = "_meta/fence_rejects"

    def __init__(self, objstore, scope: str, keyspace: str = "default",
                 read_only: bool = False):
        self._obj = objstore
        self.keyspace = keyspace
        self.read_only = bool(read_only)
        self._prefix = f"{scope}/{keyspace}"
        self._fence: int | None = None

    # -- fencing ----------------------------------------------------------

    def bind_fence(self, fence: int) -> None:
        """Arm object-layer fencing: every subsequent write carries this
        token and refuses to land under a newer one (FencedStore calls
        this at construction, fleet/queue.py)."""
        self._fence = int(fence)

    def _record_fence_reject(self, table: str, stored: int) -> None:
        def bump(old):
            d = json.loads(old) if old else {"total": 0}
            d["total"] = int(d.get("total", 0)) + 1
            d[f"table_{table}"] = int(d.get(f"table_{table}", 0)) + 1
            return json.dumps(d).encode()

        cas_update(self._obj, f"{self._prefix}/{self.FENCE_REJECTS_KEY}",
                   bump)
        obs_metrics.counter(
            "object_fence_rejected_total",
            help=("stale-fence conditional puts rejected at the "
                  "object layer")).inc()

    def fence_rejects(self) -> int:
        """Durable count of object-layer stale-fence rejections for this
        store scope (the proof a zombie's write never landed)."""
        try:
            data, _ = self._obj.get(
                f"{self._prefix}/{self.FENCE_REJECTS_KEY}")
        except KeyError:
            return 0
        return int(json.loads(data).get("total", 0))

    # -- shard plumbing ---------------------------------------------------

    def _shard_key(self, table: str, part: tuple) -> str:
        pid = "_".join(str(p) for p in part)
        return f"{self._prefix}/{table}/{pid}"

    @staticmethod
    def _row_key(row: dict, pk: tuple) -> str:
        return json.dumps([_normalize(row[k]) for k in pk])

    def write(self, table: str, frame: dict) -> int:
        if self.read_only:
            raise RuntimeError(
                f"write to {table!r} on a read-only object-store handle")
        types = _col_types(table)
        pk = schema.primary_key(table)
        keyp = pk[:_PART[table]]
        n = len(next(iter(frame.values())))
        # Encode once, then group rows by partition shard.
        rows: dict[tuple, dict[str, dict]] = {}
        for i in range(n):
            row = {c: _encode_cell_json(frame[c][i], types[c])
                   for c in types if c in frame}
            part = tuple(_normalize(frame[k][i]) for k in keyp)
            rk = json.dumps([_normalize(frame[k][i]) for k in pk])
            rows.setdefault(part, {})[rk] = row
        for part, newrows in rows.items():
            self._merge_shard(table, part, newrows)
        return n

    def _merge_shard(self, table: str, part: tuple,
                     newrows: dict[str, dict]) -> None:
        key = self._shard_key(table, part)
        while True:
            h = self._obj.head(key)
            stored_fence = int(h.meta.get("fence", 0)) if h else 0
            if self._fence is not None and stored_fence > self._fence:
                # A successor already wrote with a newer token: this
                # handle is a zombie's.  Refuse before any bytes land.
                self._record_fence_reject(table, stored_fence)
                raise StaleObjectFence(
                    f"object write to {key!r} carries fence "
                    f"{self._fence} but generation {h.generation} was "
                    f"written under fence {stored_fence}; this writer "
                    "has been fenced off")
            merged = dict(newrows)
            if h is not None:
                # Merge against readable rows but condition the put on
                # head()'s generation — get() may have fallen back past
                # a torn newest, whose generation number still counts.
                data, _ = self._obj.get(key)
                doc = json.loads(data)
                merged = {**doc.get("rows", {}), **newrows}
            meta = {"rows": len(merged), "table": table}
            fence = max(stored_fence,
                        self._fence if self._fence is not None else 0)
            if fence:
                meta["fence"] = fence
            body = json.dumps({"table": table, "rows": merged}).encode()
            try:
                self._obj.put(key, body, meta=meta,
                              if_generation=h.generation if h else 0)
                return
            except PreconditionFailed:
                continue  # another writer won this generation: re-merge

    # -- reads ------------------------------------------------------------

    def _shards(self, table: str) -> list[str]:
        return self._obj.list(f"{self._prefix}/{table}/")

    def read(self, table: str, where: dict | None = None,
             columns=None) -> dict:
        types = _col_types(table)
        cols = list(columns or types)
        keyp = schema.primary_key(table)[:_PART[table]]
        if where and all(k in where for k in keyp):
            part = tuple(_normalize(where[k]) for k in keyp)
            skey = self._shard_key(table, part)
            keys = [skey] if self._obj.head(skey) is not None else []
        else:
            keys = self._shards(table)
        out: dict[str, list] = {c: [] for c in cols}
        decode = cols + [k for k in where or () if k in types
                         and k not in cols]
        for skey in keys:
            try:
                data, _ = self._obj.get(skey)
            except KeyError:
                continue
            for row in json.loads(data).get("rows", {}).values():
                vals = {c: _decode_cell_json(row.get(c), types[c])
                        for c in decode}
                if where and any(vals.get(k) != _normalize(v)
                                 for k, v in where.items()):
                    continue
                for c in cols:
                    out[c].append(vals[c])
        return out

    def count(self, table: str) -> int:
        # Head-only: row counts ride shard manifest metadata.
        total = 0
        for skey in self._shards(table):
            h = self._obj.head(skey)
            if h is not None:
                total += int(h.meta.get("rows", 0))
        return total

    def chip_ids(self, table: str = "segment") -> set[tuple[int, int]]:
        k1, k2 = schema.primary_key(table)[:2]
        out: set[tuple[int, int]] = set()
        for skey in self._shards(table):
            try:
                data, _ = self._obj.get(skey)
            except KeyError:
                continue
            for rk in json.loads(data).get("rows", {}):
                kv = json.loads(rk)
                out.add((kv[0], kv[1]))
        return out

    def close(self) -> None:
        close = getattr(self._obj, "close", None)
        if close is not None:
            close()


class MirroredStore:
    """Write-through mirror: a local Store stays read-authoritative,
    every durable write ALSO publishes to the object tier — **object
    first**, so a zombie's stale write is rejected at the object layer
    before a single local byte lands (every ``open_store`` of a local
    backend runs its writes through here when ``FIREBIRD_OBJECT_ROOT`` is
    set).  A failed object put raises before the local write: nothing is
    logged and skipped."""

    def __init__(self, local, mirror: ObjectBackedStore):
        self._local = local
        self._mirror = mirror

    def bind_fence(self, fence: int) -> None:
        self._mirror.bind_fence(fence)

    def write(self, table: str, frame: dict) -> int:
        self._mirror.write(table, frame)
        return self._local.write(table, frame)

    def fence_rejects(self) -> int:
        return self._mirror.fence_rejects()

    @property
    def object_mirror(self) -> ObjectBackedStore:
        return self._mirror

    def close(self) -> None:
        try:
            self._mirror.close()
        finally:
            self._local.close()

    def __getattr__(self, name):
        return getattr(self._local, name)


# -- wiring ----------------------------------------------------------------

def open_object_root(root: str | None = None, cfg=None):
    """One fully-wired object root: LocalObjectStore under the run's
    fault plan (``object`` scope) under ``RetryPolicy.for_object`` with
    the shared budget semantics.  ``cfg=None`` reads the environment
    (the route every existing ``open_store`` call site inherits)."""
    from firebird_tpu_torch.config import Config
    if cfg is None:
        cfg = Config.from_env()
    root = root or cfg.object_root
    if not root:
        raise ValueError(
            "open_object_root: no object root (set FIREBIRD_OBJECT_ROOT "
            "or pass root=)")
    store = LocalObjectStore(
        root, chunk_size=int(cfg.object_chunk_kb) * 1024)
    from firebird_tpu_torch import faults as faultslib
    plan = faultslib.FaultPlan.parse(cfg.faults)
    if plan is not None:
        store = faultslib.wrap_objectstore(store, plan)
    return RetryingObjectStore(store, retrylib.RetryPolicy.for_object(cfg))

"""Two-tier read cache for the serving layer: the port's own copy of the
JAX package's ``serve/cache.py`` (host only; the spill tier's file names
and formats are the JAX package's, so either package reads the other's).

Design target: the O(1)-cache-for-inference pattern (PAPERS.md,
arXiv:2603.09555) applied to the CCDC read path.  A chip's decoded
segment frame or a computed product raster is expensive to produce
(store decode of ~12k rows, or a full product computation) and
perfectly reusable — *until the store underneath changes*.  So:

- **Tier 1** (:class:`LRUCache`): a bounded in-memory LRU.  Values are
  decoded chip frames (dict-of-columns) or computed ``[10000]`` int32
  product rasters, keyed by ``(table, cx, cy, date, generation)``-shaped
  tuples.  Hits are O(1) dict moves; the bound is entry count, not
  bytes, because serve values are near-uniform (one chip each).
- **Tier 2** (optional, ``FIREBIRD_SERVE_CACHE_DIR``): evicted entries
  spill to disk (``.npy`` for arrays, ``.json`` for frames) and promote
  back on a memory miss — a restart-warm cache for rasters that took a
  products.save-path computation to build.  The bound trims
  LRU-by-access (promotions touch the file), so hot entries survive
  cold churn.
- **Invalidation** (:class:`StoreGenerations` + :func:`watch_store`): a
  per-``(table, cx, cy)`` generation counter bumped by every store write
  that touches the chip.  Cache keys embed the generation at build time,
  so a live detection run writing through the watched store silently
  invalidates exactly the chips it rewrote — the serving layer and the
  run can share one store with no cross-talk.  (Generations track
  *in-process* writes; a writer in another process is invisible until
  restart — docs/SERVING.md spells out the deployment rule.)

Counters: ``serve_cache_hits`` / ``serve_cache_misses`` (memory tier),
``serve_cache_disk_hits`` / ``serve_cache_spills`` (disk tier),
``serve_cache_evictions``; gauge ``serve_cache_entries``.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import threading

import numpy as np

from firebird_tpu_torch.obs import metrics as obs_metrics


def _key_digest(key: tuple) -> str:
    """Stable filename for a cache key (spill tier)."""
    return hashlib.sha256(repr(key).encode()).hexdigest()[:32]


class LRUCache:
    """Bounded thread-safe LRU with optional disk spill.

    ``get`` returns None on a miss (both tiers); ``put`` inserts at the
    MRU end and evicts the LRU entry past ``max_entries`` (spilling it to
    ``spill_dir`` when configured).  Values must be numpy arrays or
    JSON-encodable objects — the spill tier round-trips exactly those.
    """

    def __init__(self, max_entries: int = 256, spill_dir: str | None = None,
                 spill_max_files: int | None = None):
        if max_entries < 1:
            raise ValueError(f"cache needs max_entries >= 1, got "
                             f"{max_entries}")
        self.max_entries = int(max_entries)
        self.spill_dir = spill_dir or None
        # Spill files are keyed by (…, store-generation) digests, so an
        # invalidated entry's file can never match a future key — without
        # a bound, a server sharing a store with a live run spills a new
        # orphan per eviction per generation until the disk fills.  The
        # bound is enforced oldest-first at spill time.
        self.spill_max_files = (int(spill_max_files)
                                if spill_max_files is not None
                                else self.max_entries * 4)
        self._spill_count = 0  # guarded-by: _lock
        if self.spill_dir:
            os.makedirs(self.spill_dir, exist_ok=True)
            # One directory scan at construction; spills maintain the
            # count in memory so the bound check is O(1) per spill.
            self._spill_count = sum(
                n.endswith((".npy", ".json"))
                for n in os.listdir(self.spill_dir))
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = \
            collections.OrderedDict()  # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def _gauge(self, n: int) -> None:
        obs_metrics.gauge(
            "serve_cache_entries",
            help="in-memory serve cache entries").set(n)

    def get(self, key: tuple):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                obs_metrics.counter(
                    "serve_cache_hits",
                    help="serve cache hits (memory tier)").inc()
                return self._entries[key]
        v = self._disk_get(key)
        if v is not None:
            obs_metrics.counter(
                "serve_cache_disk_hits",
                help="serve cache hits promoted from the disk tier").inc()
            self.put(key, v)
            return v
        obs_metrics.counter(
            "serve_cache_misses",
            help="serve cache misses (both tiers)").inc()
        return None

    def put(self, key: tuple, value) -> None:
        spill = []
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                spill.append(self._entries.popitem(last=False))
                obs_metrics.counter(
                    "serve_cache_evictions",
                    help="serve cache LRU evictions").inc()
            self._gauge(len(self._entries))
        for k, v in spill:
            self._disk_put(k, v)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._gauge(0)

    # -- disk spill tier ---------------------------------------------------

    def _disk_paths(self, key: tuple) -> tuple[str, str] | None:
        if not self.spill_dir:
            return None
        h = _key_digest(key)
        return (os.path.join(self.spill_dir, h + ".npy"),
                os.path.join(self.spill_dir, h + ".json"))

    def _disk_put(self, key: tuple, value) -> None:
        paths = self._disk_paths(key)
        if paths is None:
            return
        npy, js = paths
        try:
            if isinstance(value, np.ndarray):
                # The .npy suffix keeps np.save from appending its own.
                tmp = npy + ".tmp.npy"
                np.save(tmp, value)
                fresh = not os.path.exists(npy)
                os.replace(tmp, npy)
            else:
                tmp = js + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(value, f)
                fresh = not os.path.exists(js)
                os.replace(tmp, js)
            obs_metrics.counter(
                "serve_cache_spills",
                help="entries spilled to the disk cache tier").inc()
            with self._lock:
                self._spill_count += fresh
                over = self._spill_count > self.spill_max_files
            if over:
                self._trim_spill_dir()
        except (OSError, TypeError, ValueError):
            # The spill tier is best-effort: a full disk or an
            # unserializable value must not fail the request that
            # triggered the eviction.
            pass

    def _trim_spill_dir(self) -> None:
        """Drop the least-recently-ACCESSED spill files past the bound
        (best-effort).  Only called when the in-memory count crosses the
        bound, so the directory scan is amortized — not per spill.

        Trim order is LRU-by-access, not insert order: ``_disk_get``
        touches a file's mtime on every hit, so a hot entry (a pyramid
        tile the whole map fleet revalidates against) keeps floating to
        the young end while cold generation churn ages out — without
        the touch, steady cold-spill traffic would evict the hottest
        file as surely as the coldest (it was merely written first)."""
        names = [n for n in os.listdir(self.spill_dir)
                 if n.endswith((".npy", ".json"))]
        excess = len(names) - self.spill_max_files
        if excess > 0:
            paths = [os.path.join(self.spill_dir, n) for n in names]

            def mtime(p):
                try:
                    return os.path.getmtime(p)
                except OSError:
                    return 0.0          # already gone: oldest, harmless
            paths.sort(key=mtime)
            for p in paths[:excess]:
                try:
                    os.remove(p)
                except OSError:
                    pass
        with self._lock:
            self._spill_count = min(len(names), self.spill_max_files)

    def _disk_get(self, key: tuple):
        paths = self._disk_paths(key)
        if paths is None:
            return None
        npy, js = paths
        try:
            if os.path.exists(npy):
                v = np.load(npy)
                self._touch(npy)
                return v
            if os.path.exists(js):
                with open(js) as f:
                    v = json.load(f)
                self._touch(js)
                return v
        except (OSError, ValueError):
            return None
        return None

    @staticmethod
    def _touch(path: str) -> None:
        """Record the access: trim is LRU-by-access over mtimes."""
        try:
            os.utime(path, None)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Store-write invalidation
# ---------------------------------------------------------------------------

# Tables whose rows are keyed by chip id in their first two key columns.
_CHIP_TABLES = ("chip", "pixel", "segment", "product")


class StoreGenerations:
    """Per-(table, chip) write-generation counters.

    ``gen(table, cx, cy)`` is embedded in every cache key at build time;
    ``bump_frame(table, frame)`` advances the counter of each distinct
    chip the written frame touches, so stale cache entries simply stop
    matching — no scan, no TTL.  Non-chip tables (``tile`` — the trained
    model) bump a table-wide generation because a retrained model changes
    every chip's ``cover`` answer.
    """

    def __init__(self, on_bump=None):
        self._lock = threading.Lock()
        self._gens: dict[tuple, int] = {}  # guarded-by: _lock
        self._table_gens: dict[str, int] = {}  # guarded-by: _lock
        # Optional (table, cx, cy) hook fired AFTER a chip bump, outside
        # the lock (it may do file I/O — the serving layer wires it to
        # pyramid.invalidate_chip so in-process writes dirty the tile
        # pyramid exactly like changefeed-applied ones).
        self.on_bump = on_bump
        # Folded into EVERY generation.  The changefeed consumer sets it
        # to its resumed durable cursor sum at construction: in-memory
        # counters reset to 0 on restart, but a PERSISTENT disk-spill
        # cache keeps files keyed by the previous incarnation's
        # generations — without the epoch, a resumed replica (which
        # skips the replay) would recompute the pre-restart keys and
        # serve pre-mutation spill entries forever.  Any feed movement
        # across a restart therefore re-keys everything (coarse, but
        # strictly over-invalidating); an unmoved feed keeps the warm
        # spill cache valid.
        self.epoch = 0

    def gen(self, table: str, cx, cy) -> int:
        with self._lock:
            return (self._gens.get((table, int(cx), int(cy)), 0)
                    + self._table_gens.get(table, 0) + self.epoch)

    def table_gen(self, table: str) -> int:
        with self._lock:
            return self._table_gens.get(table, 0) + self.epoch

    def bump(self, table: str, cx, cy) -> None:
        with self._lock:
            k = (table, int(cx), int(cy))
            self._gens[k] = self._gens.get(k, 0) + 1
        if self.on_bump is not None:
            self.on_bump(table, int(cx), int(cy))

    def bump_table(self, table: str) -> None:
        with self._lock:
            self._table_gens[table] = self._table_gens.get(table, 0) + 1

    def bump_frame(self, table: str, frame: dict) -> None:
        if table not in _CHIP_TABLES:
            self.bump_table(table)
            return
        cxs, cys = frame.get("cx"), frame.get("cy")
        if cxs is None or cys is None:
            self.bump_table(table)
            return
        for cid in {(int(a), int(b)) for a, b in zip(cxs, cys)}:
            self.bump(table, *cid)


class _WatchedStore:
    """Store proxy: ``write`` bumps the generation tracker, everything
    else passes through.  Identity-thin — the hot write path pays one
    set-build per frame, nothing per row."""

    def __init__(self, store, gens: StoreGenerations):
        self._store = store
        self._gens = gens

    def write(self, table: str, frame: dict) -> int:
        n = self._store.write(table, frame)
        self._gens.bump_frame(table, frame)
        return n

    def __getattr__(self, name):
        return getattr(self._store, name)


def watch_store(store, gens: StoreGenerations):
    """Wrap ``store`` so writes invalidate serve-cache entries keyed via
    ``gens``.  Hand the wrapped store to anything that writes while the
    serving layer is up (a live driver run, products.save)."""
    return _WatchedStore(store, gens)

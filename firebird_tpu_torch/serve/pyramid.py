"""Quadkey tile pyramid: precomputed map-serving rasters over the store:
the port's own copy of the JAX package's ``serve/pyramid.py``, with its
tile format (a pyramid directory either package built, the other
serves).

The point endpoints (serve/api.py) answer one chip at a time — correct,
but a map client zoomed out over CONUS needs thousands of chips per
viewport, and "heavy traffic from millions of users"
is map traffic.  This module materializes the standard products as a
quadkey tile pyramid (the Bing/slippy-map scheme, anchored on the
Albers chip grid instead of Web Mercator):

- **Addressing.**  A tile is ``(z, x, y)`` with ``0 <= x, y < 2**z``.
  ``Z_BASE`` (11) is the base level: one tile == one chip (``2**11``
  chips per side covers the whole CONUS chip grid index range).  A tile
  at level ``z`` covers ``2**(Z_BASE - z)`` chips per side; level 0 is
  the single root.  Every tile renders at ``TILE_SIDE`` (100) pixels —
  zooming out halves the ground resolution per level, exactly the
  overview-pyramid contract.  ``quadkey`` interleaves the x/y bits into
  the base-4 digit string (one digit per level) used by tile CDNs.
- **Base tiles** render through an injectable ``read_chip(name, date,
  cx, cy) -> flat cells | None`` — the serving layer passes its cached
  compute-on-miss reader (the ``export.mosaic`` seam), the CLI and the
  fleet a store-backed one — so a base tile is byte-identical to the
  ``products.save`` raster for that chip.  **Parent tiles** downsample
  their four children 2x (top-left-of-each-2x2 selection: products are
  categorical/ordinal int32 rasters where averaging would invent
  values).
- **Versioned static files.**  Tiles persist as
  ``<root>/<product>/<date>/<z>/<x>/<y>.npy`` + ``<y>.json`` meta
  (atomic writes; ``version`` increments per rebuild and survives
  invalidation — the serving layer derives strong ETags from it).  A
  hit is a file read: no store, no decode, no compute.
- **Invalidation** is marker-touching, not deletion or meta rewriting:
  ``invalidate_chip`` touches a ``<y>.stale`` sidecar for the chip's
  base tile and every ancestor across all persisted (product, date)
  combos — O(levels x products x dates) utimes per changed chip, the
  O(changes) coherence move the changefeed consumer
  (serve/changefeed.py) drives.  A tile is stale when its marker's
  mtime reaches its meta's; rebuilding writes a fresh meta that
  outdates the marker.  Because the meta (and its version counter) has
  exactly one writer, a stamp racing a rebuild in another process can
  only force one extra rebuild, never roll a version back.  A stale
  parent rebuild reloads its three clean children from disk and
  re-renders only the dirty quadrant chain.

Cold misses build on demand, but only within ``MAX_MISS_DEPTH`` levels
of the base — a root tile build walks 4**Z_BASE chips, which is a
precompute job (``firebird pyramid build`` / the fleet ``pyramid`` job
type), not something a GET should trigger.
"""

from __future__ import annotations

import json
import os
import threading

import numpy as np

from firebird_tpu_torch import grid
from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.obs import metrics as obs_metrics

log = logger("serve")

TILE_SCHEMA = "firebird-pyramid-tile/1"

# ccd/params.py's FILL_VALUE and ingest/packer.py's CHIP_SIDE, spelled
# out: both modules load scipy (the detector's chi2 thresholds), and
# ``status`` censuses a pyramid on the host without it.  The tests hold
# them equal.
FILL_VALUE = -9999
CHIP_SIDE = 100

# Base level: one tile == one chip; 2**Z_BASE chips per side bounds the
# quadkey domain (the CONUS chip grid h/v index range fits in [0, 2048)).
Z_BASE = 11
TILE_SIDE = CHIP_SIDE

# Deepest compute-on-miss: a miss at z >= Z_BASE - MAX_MISS_DEPTH may
# build (at most 4**MAX_MISS_DEPTH = 256 chip reads); farther-out tiles
# must be precomputed (firebird pyramid build / fleet pyramid jobs) and
# answer 404 cold — a GET must never walk millions of chips.
MAX_MISS_DEPTH = 4


# ---------------------------------------------------------------------------
# Quadkey / Albers grid math (pure)
# ---------------------------------------------------------------------------

def _check_tile(z: int, x: int, y: int) -> None:
    if not 0 <= z <= Z_BASE:
        raise ValueError(f"zoom must be in [0, {Z_BASE}], got {z}")
    if not (0 <= x < (1 << z) and 0 <= y < (1 << z)):
        raise ValueError(
            f"tile ({x}, {y}) outside the level-{z} domain [0, {1 << z})")


def chip_hv(cx: float, cy: float) -> tuple[int, int]:
    """Chip grid index (h, v) of the chip whose UL corner is (cx, cy)."""
    return grid.grid_pt(float(cx), float(cy), grid.CONUS.chip)


def tile_of_chip(cx: float, cy: float, z: int = Z_BASE) -> tuple[int, int]:
    """The level-``z`` tile containing chip (cx, cy).  Chips outside the
    quadkey domain (off the CONUS grid's index range) are rejected —
    the pyramid cannot address them."""
    h, v = chip_hv(cx, cy)
    if not (0 <= h < (1 << Z_BASE) and 0 <= v < (1 << Z_BASE)):
        raise ValueError(
            f"chip ({cx}, {cy}) -> grid index ({h}, {v}) is outside the "
            f"pyramid's quadkey domain [0, {1 << Z_BASE})")
    _check_tile(z, h >> (Z_BASE - z), v >> (Z_BASE - z))
    return h >> (Z_BASE - z), v >> (Z_BASE - z)


def chips_of_tile(z: int, x: int, y: int) -> list[tuple[int, int]]:
    """Chip ids (UL projection coords) covered by tile (z, x, y), row
    major north-to-south.  Use at or near the base only — the count is
    ``4**(Z_BASE - z)``."""
    _check_tile(z, x, y)
    span = 1 << (Z_BASE - z)
    g = grid.CONUS.chip
    out = []
    for v in range(y * span, (y + 1) * span):
        for h in range(x * span, (x + 1) * span):
            px, py = grid.proj_pt(h, v, g)
            out.append((int(px), int(py)))
    return out


def children(z: int, x: int, y: int) -> list[tuple[int, int, int]]:
    """The four level-``z+1`` children, quadrant order (NW, NE, SW, SE)."""
    _check_tile(z, x, y)
    if z >= Z_BASE:
        raise ValueError(f"level {z} is the base; base tiles have chips, "
                         "not children")
    return [(z + 1, 2 * x + dx, 2 * y + dy)
            for dy in (0, 1) for dx in (0, 1)]


def parent(z: int, x: int, y: int) -> tuple[int, int, int]:
    _check_tile(z, x, y)
    if z == 0:
        raise ValueError("the root tile has no parent")
    return z - 1, x >> 1, y >> 1


def ancestors(z: int, x: int, y: int):
    """(z, x, y) and every ancestor up to the root, base-first."""
    _check_tile(z, x, y)
    out = [(z, x, y)]
    while z > 0:
        z, x, y = parent(z, x, y)
        out.append((z, x, y))
    return out


def quadkey(z: int, x: int, y: int) -> str:
    """Bing-style quadkey: one base-4 digit per level, most significant
    first; the root (z=0) is the empty string."""
    _check_tile(z, x, y)
    digits = []
    for i in range(z, 0, -1):
        bit = 1 << (i - 1)
        digits.append(str(((1 if y & bit else 0) << 1)
                          | (1 if x & bit else 0)))
    return "".join(digits)


def tile_from_quadkey(qk: str) -> tuple[int, int, int]:
    z = len(qk)
    if z > Z_BASE:
        raise ValueError(f"quadkey {qk!r} is deeper than the base level "
                         f"{Z_BASE}")
    x = y = 0
    for i, d in enumerate(qk):
        if d not in "0123":
            raise ValueError(f"quadkey digit {d!r} in {qk!r} (base-4 only)")
        bit = 1 << (z - 1 - i)
        n = int(d)
        if n & 1:
            x |= bit
        if n & 2:
            y |= bit
    return z, x, y


def tile_extent(z: int, x: int, y: int) -> dict:
    """Albers projection extents of tile (z, x, y): the UL corner of its
    NW chip and the LR corner of its SE chip."""
    _check_tile(z, x, y)
    span = 1 << (Z_BASE - z)
    g = grid.CONUS.chip
    ulx, uly = grid.proj_pt(x * span, y * span, g)
    return {"ulx": ulx, "uly": uly,
            "lrx": ulx + span * g.sx, "lry": uly - span * g.sy,
            "chip_span": span}


def tile_for_point(px: float, py: float, z: int) -> tuple[int, int]:
    """The level-``z`` tile containing Albers projection point (px, py)
    — the quadkey<->Albers round trip's other half."""
    cxf, cyf = grid.snap(px, py)["chip"]["proj-pt"]
    return tile_of_chip(cxf, cyf, z)


# ---------------------------------------------------------------------------
# The materialized pyramid
# ---------------------------------------------------------------------------

def pyramid_root(cfg) -> str | None:
    """Where a config's pyramid lives: ``FIREBIRD_SERVE_PYRAMID_DIR``
    when set, else ``pyramid/`` under the serve cache dir, else
    ``pyramid/`` next to the results store (the fleet.db placement
    rule).  None — pyramid disabled — for the memory backend with
    neither dir configured."""
    if getattr(cfg, "serve_pyramid_dir", ""):
        return cfg.serve_pyramid_dir
    if getattr(cfg, "serve_cache_dir", ""):
        return os.path.join(cfg.serve_cache_dir, "pyramid")
    from firebird_tpu_torch.driver import quarantine as qlib

    d = qlib._artifact_dir(cfg)
    return None if d is None else os.path.join(d, "pyramid")


def _atomic_json(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def downsample2x(cells: np.ndarray) -> np.ndarray:
    """2x overview reduction by top-left-of-each-2x2 selection.  The
    products are categorical/ordinal int32 rasters (cover labels, QA
    flags, day-of-year codes) — averaging would invent values no pixel
    holds, and any fixed-cell selection is deterministic and
    FILL-stable."""
    return np.ascontiguousarray(cells[::2, ::2])


class LocalTileStorage:
    """The classic on-disk tile tree: ``<root>/<product>/<date>/<z>/
    <x>/<y>.npy`` + ``<y>.json`` meta + ``<y>.stale`` marker, all
    atomic-replace writes.  This is the storage seam's reference
    implementation — :class:`TilePyramid` defaults to it, and
    :class:`ObjectTileStorage` implements the same interface over the
    object tier (store/objectstore.py)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _tile_dir(self, name: str, date: str, z: int, x: int) -> str:
        return os.path.join(self.root, name, date, str(z), str(x))

    def tile_paths(self, name: str, date: str, z: int, x: int,
                   y: int) -> tuple[str, str]:
        d = self._tile_dir(name, date, z, x)
        return os.path.join(d, f"{y}.npy"), os.path.join(d, f"{y}.json")

    def marker_path(self, name: str, date: str, z: int, x: int,
                    y: int) -> str:
        """The stale MARKER sidecar.  Invalidation touches this file
        instead of rewriting the meta: a consumer's stamp can therefore
        never clobber a build that persisted concurrently in another
        process (the meta — and its version counter — has exactly one
        writer, ``persist``).  Staleness = marker mtime >= meta mtime;
        a rebuild's fresh meta outdates the marker, and a marker
        touched while a build races lands >= and forces one extra
        rebuild — over-invalidation, never under."""
        return os.path.join(self._tile_dir(name, date, z, x),
                            f"{y}.stale")

    def meta_ident(self, name, date, z, x, y):
        """A cheap identity token for the persisted meta (None when the
        tile does not exist): any stamp/rebuild changes it, so a cached
        meta validated against it can never go stale silently."""
        _, mpath = self.tile_paths(name, date, z, x, y)
        try:
            st = os.stat(mpath)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_ino)

    def load_meta(self, name, date, z, x, y) -> dict | None:
        _, mpath = self.tile_paths(name, date, z, x, y)
        try:
            with open(mpath) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def is_stale(self, name, date, z, x, y, ident) -> bool:
        try:
            mst = os.stat(self.marker_path(name, date, z, x, y))
        except OSError:
            return False
        return mst.st_mtime_ns >= ident[0]

    def load_cells(self, name, date, z, x, y):
        npy, _ = self.tile_paths(name, date, z, x, y)
        try:
            return np.load(npy)
        except (OSError, ValueError):
            return None

    def persist(self, name, date, z, x, y, cells, meta: dict) -> None:
        npy, mpath = self.tile_paths(name, date, z, x, y)
        os.makedirs(os.path.dirname(npy), exist_ok=True)
        tmp = f"{npy}.tmp.{os.getpid()}.npy"
        np.save(tmp, np.asarray(cells, np.int32))
        os.replace(tmp, npy)
        _atomic_json(mpath, meta)

    def stamp(self, name, date, z, x, y) -> bool:
        marker = self.marker_path(name, date, z, x, y)
        try:
            with open(marker, "a"):
                pass
            os.utime(marker, None)
        except OSError:
            return False
        return True

    def product_dates(self) -> list[tuple[str, str]]:
        out = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for n in names:
            d = os.path.join(self.root, n)
            if not os.path.isdir(d):
                continue
            try:
                out.extend((n, dt) for dt in sorted(os.listdir(d)))
            except OSError:
                continue
        return out

    def tiles_by_level(self) -> dict:
        """Tile counts by level (+ stale counts) — a directory walk, no
        tile loads."""
        by_level: dict[str, dict] = {}
        for name, date in self.product_dates():
            droot = os.path.join(self.root, name, date)
            try:
                zs = sorted(os.listdir(droot))
            except OSError:
                continue
            for z in zs:
                zdir = os.path.join(droot, z)
                if not os.path.isdir(zdir):
                    continue
                lv = by_level.setdefault(z, {"tiles": 0, "stale": 0})
                for xdir in os.listdir(zdir):
                    xd = os.path.join(zdir, xdir)
                    if not os.path.isdir(xd):
                        continue
                    for fn in os.listdir(xd):
                        if fn.endswith(".json"):
                            mpath = os.path.join(xd, fn)
                            try:
                                mt = os.stat(mpath).st_mtime_ns
                            except OSError:
                                continue
                            lv["tiles"] += 1
                            try:
                                stale = os.stat(
                                    mpath[:-len(".json")] + ".stale"
                                ).st_mtime_ns >= mt
                            except OSError:
                                stale = False
                            lv["stale"] += stale
        return by_level

    def describe(self) -> str:
        return self.root


class ObjectTileStorage:
    """Tiles + ``.stale`` markers as objects (store/objectstore.py).

    One object per tile — the ``.npy`` bytes as the body, the tile meta
    dict riding the manifest user metadata, so the 304-revalidation
    probe (``meta_ident`` + ``load_meta``) is a pure ``head`` and the
    ETag contract (``meta["version"]``, monotonic under ``persist``'s
    read-increment-write) is unchanged.  The stale marker is a tiny
    sibling object whose ``updated`` plays the marker-mtime role:
    stale when ``marker.updated >= tile.updated``, and a rebuild's
    fresh manifest outdates the marker — the exact over-invalidation
    (never under-) semantics of the local marker files."""

    def __init__(self, objstore, scope: str):
        self._obj = objstore
        self.scope = scope

    def _tkey(self, name, date, z, x, y) -> str:
        return f"{self.scope}/pyramid/{name}/{date}/{z}/{x}/{y}"

    def _mkey(self, name, date, z, x, y) -> str:
        return self._tkey(name, date, z, x, y) + ".stale"

    def meta_ident(self, name, date, z, x, y):
        h = self._obj.head(self._tkey(name, date, z, x, y))
        return None if h is None else (h.generation, h.updated)

    def load_meta(self, name, date, z, x, y) -> dict | None:
        h = self._obj.head(self._tkey(name, date, z, x, y))
        return None if h is None else dict(h.meta)

    def is_stale(self, name, date, z, x, y, ident) -> bool:
        m = self._obj.head(self._mkey(name, date, z, x, y))
        return m is not None and m.updated >= ident[1]

    def load_cells(self, name, date, z, x, y):
        import io

        try:
            data, _ = self._obj.get(self._tkey(name, date, z, x, y))
        except (KeyError, OSError):
            return None
        try:
            return np.load(io.BytesIO(data), allow_pickle=False)
        except ValueError:
            return None

    def persist(self, name, date, z, x, y, cells, meta: dict) -> None:
        import io

        buf = io.BytesIO()
        np.save(buf, np.asarray(cells, np.int32))
        self._obj.put(self._tkey(name, date, z, x, y), buf.getvalue(),
                      meta=meta)

    def stamp(self, name, date, z, x, y) -> bool:
        try:
            self._obj.put(self._mkey(name, date, z, x, y), b"")
        except OSError:
            return False
        return True

    def _tile_keys(self):
        prefix = f"{self.scope}/pyramid/"
        for key in self._obj.list(prefix):
            parts = key[len(prefix):].split("/")
            if len(parts) == 5 and not parts[4].endswith(".stale"):
                yield parts  # name, date, z, x, y

    def product_dates(self) -> list[tuple[str, str]]:
        return sorted({(p[0], p[1]) for p in self._tile_keys()})

    def tiles_by_level(self) -> dict:
        by_level: dict[str, dict] = {}
        for name, date, z, x, y in self._tile_keys():
            lv = by_level.setdefault(z, {"tiles": 0, "stale": 0})
            lv["tiles"] += 1
            ident = self.meta_ident(name, date, int(z), int(x), int(y))
            if ident is not None and self.is_stale(
                    name, date, int(z), int(x), int(y), ident):
                lv["stale"] += 1
        return by_level

    def describe(self) -> str:
        return f"object:{self.scope}/pyramid"


def pyramid_storage(cfg, root: str):
    """The config's tile storage for ``root``: ObjectTileStorage when
    the deployment is object-native (``FIREBIRD_STORE_BACKEND=object``
    with an object root), else None — TilePyramid then defaults to
    LocalTileStorage, including under the mirror mode, where local
    files stay read-authoritative."""
    if getattr(cfg, "store_backend", "") != "object" or \
            not getattr(cfg, "object_root", ""):
        return None
    from firebird_tpu_torch.store import objectstore as objlib

    return ObjectTileStorage(objlib.open_object_root(cfg=cfg),
                             objlib.scope_for_path(root))


class TilePyramid:
    """The versioned static-tile tree under ``root``.

    ``read_chip(name, date, cx, cy) -> flat cells | None`` renders base
    tiles; ``flight`` (a serve/flight.SingleFlight, optional) coalesces
    concurrent builds of one tile.  Thread-safe; cross-process build
    races resolve by atomic last-writer-wins replaces.  ``storage``
    picks the durable layer (default :class:`LocalTileStorage`;
    :class:`ObjectTileStorage` for object-native deployments — see
    :func:`pyramid_storage`).
    """

    def __init__(self, root: str, read_chip=None, *, flight=None,
                 max_miss_depth: int = MAX_MISS_DEPTH, storage=None):
        self.root = root
        self.read_chip = read_chip
        self.flight = flight
        self.max_miss_depth = int(max_miss_depth)
        self.storage = storage if storage is not None \
            else LocalTileStorage(root)
        self._lock = threading.Lock()
        # ident-validated meta cache: the conditional-request (304) hot
        # path peeks a tile's meta on EVERY revalidation; a storage
        # meta_ident probe (an os.stat / object head) against the cached
        # identity replaces the full meta load, and invalidation stamps
        # / rebuilds change the identity, so a hit can never serve a
        # stamp that already landed.
        self._meta_cache: dict = {}  # guarded-by: _meta_lock
        self._meta_lock = threading.Lock()

    # -- paths --------------------------------------------------------------

    def tile_paths(self, name: str, date: str, z: int, x: int,
                   y: int) -> tuple[str, str]:
        """Local tile file paths — the byte-compare hook smoke tools
        use; only meaningful for LocalTileStorage."""
        return self.storage.tile_paths(name, date, z, x, y)

    # -- serving ------------------------------------------------------------

    def peek_meta(self, name: str, date: str, z: int, x: int,
                  y: int) -> dict | None:
        """The persisted tile meta, or None — the cheap freshness probe
        the conditional-request (304) path uses before touching cells.
        Validated against the storage identity (file (mtime_ns, inode)
        / object (generation, updated)): every stamp and rebuild
        changes it, so a cached meta never matches a changed tile."""
        key = (name, date, z, x, y)
        ident = self.storage.meta_ident(name, date, z, x, y)
        if ident is None:
            return None
        with self._meta_lock:
            hit = self._meta_cache.get(key)
            meta = hit[1] if hit is not None and hit[0] == ident else None
        if meta is None:
            meta = self.storage.load_meta(name, date, z, x, y)
            if meta is None:
                return None
            with self._meta_lock:
                if len(self._meta_cache) > 4096:
                    self._meta_cache.clear()  # crude bound; re-warms in
                self._meta_cache[key] = (ident, meta)  # one hot pass
        # Marker staleness is evaluated per call (never cached): the
        # marker is what another process's invalidation touches.
        if not meta.get("stale") and self.storage.is_stale(
                name, date, z, x, y, ident):
            meta = {**meta, "stale": True}
        return meta

    def tile(self, name: str, date: str, z: int, x: int, y: int,
             deadline=None) -> tuple[np.ndarray, dict]:
        """One tile's ``([TILE_SIDE, TILE_SIDE] int32 cells, meta)`` —
        the persisted file when fresh, else a (single-flight coalesced)
        rebuild.  Raises LookupError for a cold tile past the
        compute-on-miss depth floor."""
        _check_tile(z, x, y)
        got = self._load_fresh(name, date, z, x, y)
        if got is not None:
            obs_metrics.counter(
                "pyramid_tile_hits",
                help="pyramid tiles served from their persisted static "
                     "file (no store, no compute)").inc()
            return got
        if z < Z_BASE - self.max_miss_depth:
            raise LookupError(
                f"pyramid tile {name}@{date} z{z}/{x}/{y} is not "
                f"precomputed and is {Z_BASE - z} levels above the base "
                f"(compute-on-miss floor: {self.max_miss_depth}); run "
                "`firebird pyramid build` (or enqueue a fleet `pyramid` "
                "job) over this area first")

        def build():
            # Re-check under the flight: a follower admitted after the
            # leader persisted must load, not rebuild.
            fresh = self._load_fresh(name, date, z, x, y)
            if fresh is not None:
                return fresh
            return self._build(name, date, z, x, y, deadline=deadline)

        key = ("pyramid", name, date, z, x, y)
        if self.flight is None:
            return build()
        return self.flight.do(key, build, deadline=deadline)

    def _load_fresh(self, name, date, z, x, y):
        meta = self.peek_meta(name, date, z, x, y)
        if meta is None or meta.get("stale"):
            return None
        cells = self.storage.load_cells(name, date, z, x, y)
        if cells is None:
            return None
        return np.asarray(cells, np.int32), meta

    # -- building -----------------------------------------------------------

    def _build(self, name, date, z, x, y, deadline=None) -> tuple:
        if deadline is not None:
            deadline.check("pyramid tile build")
        with obs_metrics.timer() as tm:
            if z == Z_BASE:
                cells = self._render_base(name, date, x, y)
            else:
                cells = self._render_parent(name, date, z, x, y,
                                            deadline=deadline)
        meta = self._persist(name, date, z, x, y, cells)
        obs_metrics.counter(
            "pyramid_tiles_built",
            help="pyramid tiles rendered and persisted (base renders + "
                 "parent downsamples; rebuilds included)").inc()
        obs_metrics.histogram(
            "pyramid_tile_build_seconds",
            help="per-tile pyramid render+persist latency (children "
                 "included for parents)").observe(tm.elapsed)
        return cells, meta

    def _render_base(self, name, date, x, y) -> np.ndarray:
        (cx, cy), = chips_of_tile(Z_BASE, x, y)
        flat = self.read_chip(name, date, cx, cy)
        if flat is None:
            return np.full((TILE_SIDE, TILE_SIDE), FILL_VALUE, np.int32)
        cells = np.asarray(flat, np.int32)
        if cells.size != TILE_SIDE * TILE_SIDE:
            raise ValueError(
                f"read_chip({name}@{date}, {cx}, {cy}) returned "
                f"{cells.size} cells; base tiles are "
                f"{TILE_SIDE}x{TILE_SIDE}")
        return cells.reshape(TILE_SIDE, TILE_SIDE)

    def _render_parent(self, name, date, z, x, y, deadline=None):
        half = TILE_SIDE // 2
        out = np.full((TILE_SIDE, TILE_SIDE), FILL_VALUE, np.int32)
        for cz, cxt, cyt in children(z, x, y):
            cells, _ = self.tile(name, date, cz, cxt, cyt,
                                 deadline=deadline)
            dx, dy = cxt - 2 * x, cyt - 2 * y
            out[dy * half:(dy + 1) * half,
                dx * half:(dx + 1) * half] = downsample2x(cells)
        return out

    def _persist(self, name, date, z, x, y, cells) -> dict:
        prev = self.peek_meta(name, date, z, x, y)
        meta = {
            "schema": TILE_SCHEMA,
            "name": name, "date": date, "z": z, "x": x, "y": y,
            "quadkey": quadkey(z, x, y),
            "version": int(prev.get("version", 0)) + 1 if prev else 1,
            "stale": False,
            "empty": bool((cells == FILL_VALUE).all()),
            "fill": FILL_VALUE,
            "extent": tile_extent(z, x, y),
        }
        self.storage.persist(name, date, z, x, y, cells, meta)
        return meta

    # -- invalidation (the changefeed consumer's hook) ----------------------

    def _product_dates(self) -> list[tuple[str, str]]:
        return self.storage.product_dates()

    def invalidate_chip(self, cx: float, cy: float) -> int:
        """Mark the base tile of chip (cx, cy) and every ancestor stale
        across all persisted (product, date) combos, by TOUCHING each
        tile's stale marker (``storage.stamp`` — the meta and its
        version counter have exactly one writer, so a stamp can never
        roll back a concurrent rebuild's version, and the rebuilt
        tile's ETag can never collide with the stale one's).  Returns
        tiles dirtied."""
        try:
            bx, by = tile_of_chip(cx, cy, Z_BASE)
        except ValueError:
            return 0                       # off-grid chip: nothing to dirty
        dirtied = 0
        with self._lock:
            for name, date in self._product_dates():
                for z, x, y in ancestors(Z_BASE, bx, by):
                    meta = self.peek_meta(name, date, z, x, y)
                    if meta is None or meta.get("stale"):
                        continue
                    if not self.storage.stamp(name, date, z, x, y):
                        continue
                    dirtied += 1
        if dirtied:
            obs_metrics.counter(
                "pyramid_tiles_dirtied",
                help="pyramid tiles stale-stamped by chip "
                     "invalidations (changefeed + in-process "
                     "writes)").inc(dirtied)
        return dirtied

    # -- bulk precompute (CLI / fleet pyramid jobs) -------------------------

    def build_area(self, names, dates, bounds, *, levels: int = 2,
                   refresh: bool = False) -> dict:
        """Materialize ``levels`` pyramid levels (base upward) of each
        (product, date) over the chips covering ``bounds``.  Bottom-up:
        base tiles first, then parents — so a parent build finds its
        in-area children persisted and never recurses past them.
        ``refresh`` rebuilds fresh tiles too (else they are skipped).
        Returns per-level built/skipped counts."""
        from firebird_tpu_torch import products as prodlib

        levels = max(int(levels), 1)
        cids = prodlib.covering_chips(bounds)
        base = sorted({tile_of_chip(cx, cy, Z_BASE) for cx, cy in cids})
        summary: dict = {"chips": len(cids), "levels": {}}
        for name in names:
            for date in dates:
                tiles = [(Z_BASE, x, y) for x, y in base]
                for li in range(levels):
                    z = Z_BASE - li
                    built = skipped = 0
                    for tz, tx, ty in tiles:
                        got = None if refresh else self._load_fresh(
                            name, date, tz, tx, ty)
                        # An EMPTY fresh tile is rebuilt anyway: a
                        # no-compute replica's cold miss may have
                        # persisted all-FILL for a chip whose product
                        # row did not exist yet — skipping it here
                        # would lock the hole in; re-rendering an
                        # genuinely empty tile costs one store read.
                        if got is not None and not got[1].get("empty"):
                            skipped += 1
                            continue
                        self._build(name, date, tz, tx, ty)
                        built += 1
                    lv = summary["levels"].setdefault(
                        str(z), {"built": 0, "skipped": 0, "tiles": 0})
                    lv["built"] += built
                    lv["skipped"] += skipped
                    lv["tiles"] += len(tiles)
                    if z == 0:
                        break
                    tiles = sorted({parent(tz, tx, ty)
                                    for tz, tx, ty in tiles})
        return summary

    # -- operator surface ---------------------------------------------------

    def status(self) -> dict:
        """Tile counts by level (+ stale counts) for ``firebird status``
        and the loadtest artifact — a storage census, no tile loads."""
        by_level = self.storage.tiles_by_level()
        return {"root": self.storage.describe(),
                "products": sorted({n for n, _ in self._product_dates()}),
                "tiles_by_level": dict(sorted(by_level.items(),
                                              key=lambda kv: int(kv[0])))}


def store_read_chip(store, *, compute: bool = True, classes_cache=None):
    """A ``read_chip`` over a Store: the stored product row when
    present, else (``compute``) the products.save-path computation,
    persisted — the reader of the CLI's and the fleet's builds.  The
    serving layer injects its cache-aware reader instead (serve/api.py)."""
    from firebird_tpu_torch import products as prodlib
    from firebird_tpu_torch.utils import dates as dt

    cache = classes_cache if classes_cache is not None else {}

    def read_chip(name, date, cx, cy):
        cx, cy = int(cx), int(cy)
        rows = store.read("product", {"name": name, "date": date,
                                      "cx": cx, "cy": cy})
        if rows["cells"]:
            return rows["cells"][0]
        if not compute:
            return None
        seg = store.read("segment", {"cx": cx, "cy": cy})
        if not seg["px"]:
            return None
        classes = None
        if name == "cover":
            classes = prodlib.tile_classes(store, cx, cy, cache)
            if classes is None:
                return None
        return prodlib.save_chip_raster(
            store, name, date, dt.to_ordinal(date), cx, cy,
            prodlib.ChipSegmentArrays(cx, cy, seg), classes=classes)

    return read_chip

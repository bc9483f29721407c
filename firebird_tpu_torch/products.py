"""Product rasters derived from stored segments: the port's own copy of
the JAX package's ``products.py``.

The product math is host numpy on stored rows; only the detection of
chips with no stored segments (``save`` with ``acquired``) reaches the
card, through the port's ``driver.core.detect_chunk``.

The JAX package's module completes the reference 0.5 ``ccdc-save``
capability that was dropped by 1.0 and survives only in its docs
(docs/faq.rst:38-109; SURVEY.md §2.5 "behavior the rebuild must
complete"): per-pixel product rasters
(``seglength``, ``ccd``, ``curveqa``) computed for query dates over areas
given as ``--bounds`` points, with whole-chip or clipped (``--clip``)
output, and ``ccdc-products`` listing what can be run.

The reference never shipped the implementation (only the CLI transcript in
the FAQ), so the product semantics are re-derived from the LCMAP product
definitions and pinned here:

- ``seglength``: days of continuity at date D — ``D - sday`` of the segment
  containing D; if D falls after a segment's confirmed break, days since
  that break (``D - bday`` of the most recent ``bday <= D``); 0 before the
  first segment or when the pixel has no models.
- ``ccd``: day-of-year (1..366) of a confirmed change (``chprob >= 1``)
  whose break day falls in the same calendar year as D, else 0.
- ``curveqa``: the ``curqa`` flag of the segment containing D, else 0.
- ``cover`` (beyond the reference list): the predicted land-cover label of
  the segment containing D — the stored ``rfrawp`` vote vector's argmax
  mapped through the tile model's class order; 0 when the segment was
  never classified or no model is stored for the tile.

Run modes (faq.rst examples): every chip intersecting the bounding box of
the ``bounds`` points is produced; ``clip`` masks pixels outside the
polygon of the points (two points: their bounding box; one point: the
single pixel containing it) to FILL (-9999).  Results land in the keyed
``product`` table (store.schema) so reruns upsert idempotently.
"""

from __future__ import annotations

import datetime

import numpy as np

from firebird_tpu_torch import grid
from firebird_tpu_torch.ccd.params import FILL_VALUE
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.ingest.packer import CHIP_SIDE, PIXEL_SIZE_M, PIXELS
from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.store import open_store
from firebird_tpu_torch.utils import dates as dt

log = logger("products")

PRODUCTS = ("seglength", "ccd", "curveqa", "cover")


def available() -> tuple[str, ...]:
    """Products that can be run (the ``ccdc-products`` listing)."""
    return PRODUCTS


# ---------------------------------------------------------------------------
# Per-chip product math (vectorized over segment rows)
# ---------------------------------------------------------------------------

def _ordinals(iso_col) -> np.ndarray:
    # One parse per distinct date: a chip's rows share a few hundred.
    ords = {s: dt.to_ordinal(s[:10]) for s in set(iso_col)}
    return np.array(list(map(ords.__getitem__, iso_col)), np.int64)


class ChipSegmentArrays:
    """A chip's segment rows parsed once (ISO dates -> ordinals, pixel
    indices bounds-checked) and shared by every (product, date) raster.
    ``COLUMNS`` are the segment columns it reads."""

    COLUMNS = ("px", "py", "sday", "eday", "bday", "chprob", "curqa",
               "rfrawp")

    def __init__(self, cx: int, cy: int, seg: dict):
        from firebird_tpu_torch.rf.features import pixel_index

        px = np.asarray(seg["px"], np.int64)
        py = np.asarray(seg["py"], np.int64)
        if px.size:
            row, col = pixel_index(cx, cy, px, py)
            self.pix = row * CHIP_SIDE + col
        else:
            self.pix = np.zeros(0, np.int64)
        self.sday = _ordinals(seg["sday"])
        self.eday = _ordinals(seg["eday"])
        self.bday = _ordinals(seg["bday"])
        self.chprob = np.array([0.0 if v is None else float(v)
                                for v in seg["chprob"]])
        self.curqa = np.array([0 if v is None else int(v)
                               for v in seg["curqa"]], np.int32)
        # argmax class index of each row's rfrawp vote vector (-1 when the
        # segment was never classified) — the cover product's input
        raw = seg.get("rfrawp")
        if raw is None or len(raw) == 0:
            raw = [None] * len(seg["sday"])
        # `v is not None and len(v)` rather than truthiness: rfrawp columns
        # may hold numpy arrays (no store round-trip), whose bool() raises.
        voted = np.array([v is not None and len(v) > 0 for v in raw], bool)
        self.rfidx = np.full(len(raw), -1, np.int64)
        if voted.any():
            votes = [raw[i] for i in np.flatnonzero(voted)]
            try:
                self.rfidx[voted] = np.asarray(votes).argmax(axis=1)
            except ValueError:   # vote vectors of several lengths
                self.rfidx[voted] = [np.argmax(v) for v in votes]
        self.real = self.sday > 1


def chip_product(name: str, date_ord: int, cx: int, cy: int,
                 seg: dict | ChipSegmentArrays,
                 classes: np.ndarray | None = None) -> np.ndarray:
    """One product raster for one chip.

    ``seg`` is the segment-table frame for the chip (dict of columns, as
    returned by ``store.read('segment', {'cx':…, 'cy':…})``) or an already
    parsed :class:`ChipSegmentArrays`.  Returns a flat [10000] int32 array
    in the packer's row-major pixel order.  Sentinel rows (sday ==
    0001-01-01, ccdc/pyccd.py:99-103) contribute nothing: their ordinals
    (1) never contain or precede a real query date with chprob/curqa set.

    ``cover`` (the predicted land-cover label of the segment containing D,
    from the stored rfrawp vote vectors) additionally needs ``classes`` —
    the trained model's label order (forest.RandomForest.classes) that
    maps vote argmax to the original label values.
    """
    if name not in PRODUCTS:
        raise ValueError(f"unknown product {name!r}; available: {PRODUCTS}")
    a = seg if isinstance(seg, ChipSegmentArrays) \
        else ChipSegmentArrays(cx, cy, seg)
    out = np.zeros(PIXELS, np.int32)
    if a.pix.size == 0:
        return out
    contains = a.real & (a.sday <= date_ord) & (date_ord <= a.eday)

    if name == "cover":
        if classes is None:
            raise ValueError("the cover product needs the trained model's "
                             "class order (classes=)")
        classes = np.asarray(classes)
        stale = contains & (a.rfidx >= classes.shape[0])
        if np.any(stale):
            log.warning(
                "cover chip (%d, %d): %d segments hold vote vectors longer "
                "than the stored model's %d classes (stale rfrawp vs a "
                "retrained model?) — emitted as 0", cx, cy,
                int(np.sum(stale)), classes.shape[0])
        hit = contains & (a.rfidx >= 0) & (a.rfidx < classes.shape[0])
        out[a.pix[hit]] = classes[a.rfidx[hit]].astype(np.int32)
        return out

    if name == "seglength":
        # Most recent confirmed break at or before D, per pixel.
        broke = a.real & (a.chprob >= 1.0) & (a.bday <= date_ord)
        last_brk = np.zeros(PIXELS, np.int64)
        np.maximum.at(last_brk, a.pix[broke], a.bday[broke])
        since_start = np.zeros(PIXELS, np.int64)
        np.maximum.at(since_start, a.pix[contains],
                      date_ord - a.sday[contains])
        has = np.zeros(PIXELS, bool)
        has[a.pix[contains]] = True
        out = np.where(has, since_start,
                       np.where(last_brk > 0, date_ord - last_brk, 0))
        return out.astype(np.int32)

    if name == "ccd":
        year = datetime.date.fromordinal(int(date_ord)).year
        y0 = datetime.date(year, 1, 1).toordinal()
        y1 = datetime.date(year, 12, 31).toordinal()
        hit = a.real & (a.chprob >= 1.0) & (a.bday >= y0) & (a.bday <= y1)
        np.maximum.at(out, a.pix[hit], (a.bday[hit] - y0 + 1).astype(np.int32))
        return out

    # curveqa
    out[a.pix[contains]] = a.curqa[contains]
    return out


# ---------------------------------------------------------------------------
# Area selection (bounds / clip)
# ---------------------------------------------------------------------------

def covering_chips(bounds: list[tuple[float, float]]) -> list[tuple[int, int]]:
    """Chip ids intersecting the bounding box of the bounds points
    (faq.rst "run a bigger area": several --bounds extend the area)."""
    g = grid.CONUS.chip
    return [tuple(int(c) for c in grid.proj_pt(h, v, g))
            for h, v in grid.cells_for_bounds(bounds, g)]


def _point_in_poly(px: np.ndarray, py: np.ndarray, poly) -> np.ndarray:
    """Vectorized ray-casting point-in-polygon (boundary-exclusive on the
    upper edge, standard even-odd rule)."""
    inside = np.zeros(px.shape, bool)
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        cross = (yi > py) != (yj > py)
        xint = (xj - xi) * (py - yi) / ((yj - yi) or 1e-30) + xi
        inside ^= cross & (px < xint)
        j = i
    return inside


def clip_mask(cx: int, cy: int, bounds: list[tuple[float, float]]) -> np.ndarray:
    """[10000] bool: pixels of chip (cx, cy) kept under --clip.

    Three or more points clip to their polygon (faq.rst "run a triangle"),
    two points to their bounding box, one point to the single containing
    pixel (faq.rst "run a single point").
    """
    col = np.tile(np.arange(CHIP_SIDE), CHIP_SIDE)
    row = np.repeat(np.arange(CHIP_SIDE), CHIP_SIDE)
    # pixel centers
    px = cx + col * PIXEL_SIZE_M + PIXEL_SIZE_M / 2.0
    py = cy - row * PIXEL_SIZE_M - PIXEL_SIZE_M / 2.0
    if len(bounds) == 1:
        x, y = bounds[0]
        ux = cx + (np.floor((x - cx) / PIXEL_SIZE_M)) * PIXEL_SIZE_M
        uy = cy - (np.floor((cy - y) / PIXEL_SIZE_M)) * PIXEL_SIZE_M
        return ((px > ux) & (px < ux + PIXEL_SIZE_M)
                & (py < uy) & (py > uy - PIXEL_SIZE_M))
    if len(bounds) == 2:
        (x0, y0), (x1, y1) = bounds
        return ((px >= min(x0, x1)) & (px <= max(x0, x1))
                & (py >= min(y0, y1)) & (py <= max(y0, y1)))
    return _point_in_poly(px, py, bounds)


# ---------------------------------------------------------------------------
# The save run
# ---------------------------------------------------------------------------

def tile_classes(store, cx: int, cy: int,
                 cache: dict | None = None) -> np.ndarray | None:
    """The trained model's class order for the tile containing chip
    (cx, cy), or None when no model is stored — the ``cover`` product's
    vote-argmax -> label mapping.  ``cache`` (a caller-held dict) keeps
    one store lookup per tile across a chip loop; models are persisted
    per tile (tile table), so chips of one tile share the entry."""
    t = grid.tile(cx, cy)
    key = (int(t["x"]), int(t["y"]))
    if cache is None:
        cache = {}
    if key not in cache:
        # The class order alone, read without the forest (torch): a serve
        # replica computes a cold cover raster on the host.
        from firebird_tpu_torch.rf.tilemodel import model_classes

        cache[key] = model_classes(store, key[0], key[1])
        if cache[key] is None:
            log.warning("cover: no trained model stored for tile "
                        "(%d, %d); run the classification command first",
                        *key)
    return cache[key]


def save_chip_raster(store, name: str, date: str, date_ord: int,
                     cx: int, cy: int, seg: "dict | ChipSegmentArrays",
                     classes: np.ndarray | None = None,
                     keep: np.ndarray | None = None) -> np.ndarray:
    """Compute ONE (product, date, chip) raster and persist it to the
    keyed product table — the unit of work of the ``save`` run (and of
    the JAX package's serving layer's compute-on-miss path, serve/api.py,
    so a raster served cold is byte-identical to one a batch ``save``
    would have produced).  Returns the flat
    [10000] int32 cells as written (clip mask applied)."""
    vals = chip_product(name, date_ord, cx, cy, seg, classes=classes)
    if keep is not None:
        vals = np.where(keep, vals, FILL_VALUE).astype(np.int32)
    cells = np.empty(1, object)
    cells[0] = vals.tolist()
    store.write("product", {
        "name": np.array([name], object),
        "date": np.array([date], object),
        "cx": np.array([cx], np.int64),
        "cy": np.array([cy], np.int64),
        "cells": cells,
    })
    return vals


def save(bounds, products, product_dates, acquired: str | None = None,
         clip: bool = False, cfg: Config | None = None, store=None,
         source=None, device=None) -> list[tuple[str, str, int, int]]:
    """Compute and persist product rasters (the ``ccdc-save`` run).

    For chips in the area with no stored segments, change detection is run
    first over ``acquired`` on ``device`` (that is what made the
    reference's ccdc-save self-contained; pass ``acquired=None`` to derive
    strictly from the store).  ``device`` defaults to CUDA: without a card
    the run raises unless "cpu" is asked.  Returns the (name, date, cx, cy)
    keys written.
    """
    from firebird_tpu_torch.ccd.kernel import resolve_device

    dev = resolve_device(device)
    for p in products:
        if p not in PRODUCTS:
            raise ValueError(f"unknown product {p!r}; available: {PRODUCTS}")
    # Dates parse before any work: a malformed date must fail in
    # milliseconds, not after the detection phase.
    date_ords = {d: dt.to_ordinal(d) for d in product_dates}
    cfg = cfg or Config.from_env()
    store = store or open_store(cfg.store_backend, cfg.store_path,
                                cfg.keyspace())
    cids = covering_chips(bounds)
    log.info("products %s at %s over %d chips (clip=%s)",
             list(products), list(product_dates), len(cids), clip)

    detected: list[tuple[int, int]] = []
    if acquired:
        have = store.chip_ids("segment")
        missing = [c for c in cids if c not in have]
        if missing:
            from firebird_tpu_torch.driver import core
            from firebird_tpu_torch.obs import Counters
            from firebird_tpu_torch.store import AsyncWriter

            log.info("detecting %d chips with no stored segments", len(missing))
            writer = AsyncWriter(store)
            try:
                processed = core.detect_chunk(
                    missing, source=source or core.make_source(cfg),
                    writer=writer, acquired=acquired, cfg=cfg,
                    counters=Counters(), log=log, device=dev)
            finally:
                writer.close()
            # detect_chunk isolates failures per chip (returning only the
            # survivors); a product raster computed over silently missing
            # segments would be wrong without looking wrong, so here —
            # with no quarantine/resume loop to drain into — absence must
            # stay loud, the pre-quarantine behavior.
            lost = [c for c in missing if c not in set(processed)]
            if lost:
                raise RuntimeError(
                    f"products: {len(lost)} chips failed detection "
                    f"(first: {lost[0]}); rerun once ingest recovers")
            detected = list(processed)

    # The cover product maps stored rfrawp votes through the trained
    # model's class order; tile_classes keeps one tile-table lookup per
    # tile across the chip loop via this shared dict.
    model_classes: dict[tuple[int, int], np.ndarray | None] = {}

    written = []
    for cx, cy in cids:
        seg = store.read("segment", {"cx": cx, "cy": cy},
                         columns=ChipSegmentArrays.COLUMNS)
        if not seg["px"]:
            log.warning("no segments stored for chip (%d, %d); skipping",
                        cx, cy)
            continue
        keep = clip_mask(cx, cy, bounds) if clip else None
        arrays = ChipSegmentArrays(cx, cy, seg)
        for name in products:
            classes = tile_classes(store, cx, cy, model_classes) \
                if name == "cover" else None
            if name == "cover" and classes is None:
                continue
            for d in product_dates:
                save_chip_raster(store, name, d, date_ords[d], cx, cy,
                                 arrays, classes=classes, keep=keep)
                written.append((name, d, cx, cy))
    log.info("products complete: %d rasters written", len(written))
    # Cross-process coherence (serve/changefeed.py): a batch save is
    # exactly the "non-alert mutation" the serve replicas cannot see
    # through the alert log — append one product_writes record per
    # touched chip (and per chip the self-contained acquired path
    # re-detected) AFTER the rows land, so a replica that applies the
    # record is guaranteed to read the new rows.
    from firebird_tpu_torch.serve.changefeed import append_product_writes

    if written:
        append_product_writes(cfg, "product",
                              {(cx, cy) for _, _, cx, cy in written})
    if detected:
        append_product_writes(cfg, "segment", detected)
    return written

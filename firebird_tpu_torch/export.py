"""Raster export: stored product rows -> georeferenced files on disk; the
port's own copy of the JAX package's ``export.py`` (host only), writing
the same bytes.

The reference pipeline ends at its store — users then pull rasters out of
Cassandra with external tooling.  This module completes that last mile
natively: mosaic the per-chip product rows (products.save) covering an
area into one int32 raster and write it as a georeferenced file, GDAL-free:

- ``envi``: raw band-sequential int32 ``.dat`` + ENVI ``.hdr`` with
  ``map info`` (Albers tie point at the mosaic's UL corner, 30 m pixels)
  and the grid's WKT as ``coordinate system string`` — opens directly in
  QGIS/ENVI/GDAL.
- ``npy``: ``numpy.save`` array + a ``.json`` sidecar carrying the same
  georeferencing (ulx, uly, pixel size, projection WKT).

Missing chips (no stored product row) fill with FILL_VALUE (-9999), the
same sentinel ``--clip`` writes outside the clip region.
"""

from __future__ import annotations

import json
import os

import numpy as np

from firebird_tpu_torch import grid, products
from firebird_tpu_torch.ccd.params import FILL_VALUE
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, Sensor
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.store import open_store

log = logger("export")

FORMATS = ("envi", "npy")


def mosaic(name: str, date: str, bounds, store,
           sensor: Sensor = LANDSAT_ARD,
           read_chip=None) -> tuple[np.ndarray, float, float]:
    """Assemble the stored product chips covering ``bounds`` into one
    raster.

    Chip geometry (pixels per side, meters per pixel) comes from the
    campaign's ``sensor`` spec; stored rows whose cell count disagrees
    with it fail loudly rather than mis-georeference.  The chip *ids*
    themselves still come from the CONUS Albers grid
    (products.covering_chips) — the only tiling the store keys on.

    ``read_chip(name, date, cx, cy) -> flat cells | None`` overrides the
    per-chip product lookup — the serving layer injects its cache-aware
    (and compute-on-miss) reader here so ``/v1/tile`` mosaics reuse
    every chip raster the point endpoints already built.  Default: read
    the stored product row.

    Returns ``(cells [H, W] int32, ulx, uly)`` — ulx/uly is the projection
    coordinate of the raster's upper-left corner (the UL chip's UL pixel
    corner).  Chips in the area with no stored row are FILL_VALUE.
    """
    side, psz = sensor.chip_side, sensor.pixel_size_m
    if side * psz != grid.CONUS.chip.sx:
        raise ValueError(
            f"sensor {sensor.name!r} chip extent {side * psz} m disagrees "
            f"with the chip grid spacing {grid.CONUS.chip.sx} m — the "
            "mosaic would overlap or gap chips")
    if read_chip is None:
        def read_chip(name, date, cx, cy):
            rows = store.read("product", {"name": name, "date": date,
                                          "cx": cx, "cy": cy})
            return rows["cells"][0] if rows["cells"] else None
    cids = products.covering_chips(bounds)
    ulx = min(cx for cx, _ in cids)
    uly = max(cy for _, cy in cids)
    chip_m = side * psz
    W = int((max(cx for cx, _ in cids) - ulx) / chip_m) * side + side
    H = int((uly - min(cy for _, cy in cids)) / chip_m) * side + side
    out = np.full((H, W), FILL_VALUE, np.int32)
    missing = 0
    for cx, cy in cids:
        cells_flat = read_chip(name, date, cx, cy)
        if cells_flat is None:
            missing += 1
            continue
        flat = np.asarray(cells_flat, np.int32)
        if flat.size != sensor.pixels:
            raise ValueError(
                f"product row ({name}@{date}, chip {cx},{cy}) has "
                f"{flat.size} cells but sensor {sensor.name!r} chips are "
                f"{side}x{side}; pass the campaign's sensor to export")
        cells = flat.reshape(side, side)
        r0 = int((uly - cy) / psz)
        c0 = int((cx - ulx) / psz)
        out[r0:r0 + side, c0:c0 + side] = cells
    if missing:
        log.warning("mosaic %s@%s: %d of %d chips have no stored product "
                    "row (run `firebird save` first); filled with %d",
                    name, date, missing, len(cids), FILL_VALUE)
    return out, float(ulx), float(uly)


def write_envi(base: str, cells: np.ndarray, ulx: float, uly: float,
               proj: str | None = None,
               pixel_size_m: float = LANDSAT_ARD.pixel_size_m) -> list[str]:
    """``base``.dat (int32 little-endian BSQ) + ``base``.hdr."""
    proj = proj or grid.CONUS_ALBERS_PROJ
    dat, hdr = base + ".dat", base + ".hdr"
    cells.astype("<i4").tofile(dat)
    H, W = cells.shape
    # ENVI: data type 3 = int32; tie point (1,1) is the UL pixel's corner.
    lines = [
        "ENVI",
        # The JAX package's header, byte for byte.
        "description = {firebird_tpu product raster}",
        f"samples = {W}", f"lines = {H}", "bands = 1",
        "header offset = 0", "file type = ENVI Standard",
        "data type = 3", "interleave = bsq", "byte order = 0",
        f"data ignore value = {FILL_VALUE}",
        f"map info = {{Albers Conical Equal Area, 1, 1, {ulx:.1f}, "
        f"{uly:.1f}, {pixel_size_m:.1f}, {pixel_size_m:.1f}, "
        "units=Meters}",
        f"coordinate system string = {{{proj}}}",
    ]
    with open(hdr, "w") as f:
        f.write("\n".join(lines) + "\n")
    return [dat, hdr]


def write_npy(base: str, cells: np.ndarray, ulx: float, uly: float,
              proj: str | None = None,
              pixel_size_m: float = LANDSAT_ARD.pixel_size_m) -> list[str]:
    """``base``.npy + ``base``.json georeferencing sidecar."""
    npy, meta = base + ".npy", base + ".json"
    np.save(npy, cells)
    with open(meta, "w") as f:
        json.dump({"ulx": ulx, "uly": uly, "pixel_size_m": pixel_size_m,
                   "fill": FILL_VALUE, "crs_wkt": proj
                   or grid.CONUS_ALBERS_PROJ}, f, indent=1)
    return [npy, meta]


def export(product_names, product_dates, bounds, outdir: str,
           fmt: str = "envi", cfg: Config | None = None,
           store=None, sensor: Sensor = LANDSAT_ARD) -> list[str]:
    """Export one raster file set per (product, date) over ``bounds``.

    Reads the product table only — run ``products.save`` (or
    ``firebird save``) first to compute and persist the product rows.
    Returns the paths written.
    """
    if fmt not in FORMATS:
        raise ValueError(f"unknown format {fmt!r}; available: {FORMATS}")
    for p in product_names:
        if p not in products.PRODUCTS:
            raise ValueError(
                f"unknown product {p!r}; available: {products.PRODUCTS}")
    from firebird_tpu_torch.utils import dates as dt

    for d in product_dates:
        dt.to_ordinal(d)  # malformed dates fail before any work, and a
        # non-ISO spelling would never match the stored row keys
    cfg = cfg or Config.from_env()
    store = store or open_store(cfg.store_backend, cfg.store_path,
                                cfg.keyspace())
    os.makedirs(outdir, exist_ok=True)
    writer = write_envi if fmt == "envi" else write_npy
    paths: list[str] = []
    for name in product_names:
        for d in product_dates:
            cells, ulx, uly = mosaic(name, d, bounds, store, sensor=sensor)
            base = os.path.join(outdir, f"{name}_{d}")
            wrote = writer(base, cells, ulx, uly,
                           pixel_size_m=sensor.pixel_size_m)
            log.info("exported %s@%s -> %s (%dx%d)", name, d, wrote[0],
                     cells.shape[1], cells.shape[0])
            paths += wrote
    return paths

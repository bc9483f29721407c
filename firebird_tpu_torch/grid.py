"""Albers CONUS grid geometry — pure functions, no HTTP.

The reference delegates all geometry to the Chipmunk service over HTTP via
merlin (`grid_fn` -> GET /grid, `snap_fn` -> GET /snap, `near_fn` -> GET /near;
ccdc/grid.py:17-53,69-89).  The math is fully determined by the grid
definition ``{rx, ry, sx, sy, tx, ty}`` (test/data/grid_response.json), so
here it is implemented directly:

    grid-pt:  h = floor((rx*x + tx) / sx),   v = floor((ry*y + ty) / sy)
    proj-pt:  x = rx * (h*sx - tx),          y = ry * (v*sy - ty)

Verified against the reference fixtures: tile grid tx=2565585, ty=3314805,
sx=sy=150000 maps proj (-615585, 2414805) <-> grid (13, 6); chip grid sx=3000
maps (-543585, 2378805) <-> (674, 312) (test/data/snap_response.json,
grid_response.json).

A tile is 150 km x 150 km = 50x50 chips of 3 km x 3 km = 100x100 30 m pixels
(SURVEY.md §0).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridDef:
    """One grid level (tile or chip): reflection r, spacing s, translation t."""

    name: str
    rx: float
    ry: float
    sx: float
    sy: float
    tx: float
    ty: float
    proj: str | None = None

    def to_dict(self) -> dict:
        return dict(
            name=self.name, proj=self.proj, rx=self.rx, ry=self.ry,
            sx=self.sx, sy=self.sy, tx=self.tx, ty=self.ty,
        )


# The LCMAP Albers CONUS grid (values from the reference grid fixture,
# test/data/grid_response.json).
CONUS_ALBERS_PROJ = (
    'PROJCS["Albers",GEOGCS["WGS 84",DATUM["WGS_1984",'
    'SPHEROID["WGS 84",6378140,298.257]],PRIMEM["Greenwich",0],'
    'UNIT["degree",0.0174532925199433]],PROJECTION["Albers_Conic_Equal_Area"],'
    'PARAMETER["standard_parallel_1",29.5],'
    'PARAMETER["standard_parallel_2",45.5],'
    'PARAMETER["latitude_of_center",23],'
    'PARAMETER["longitude_of_center",-96],UNIT["metre",1]]'
)

CONUS_TILE = GridDef("tile", 1.0, -1.0, 150000.0, 150000.0, 2565585.0,
                     3314805.0, CONUS_ALBERS_PROJ)
CONUS_CHIP = GridDef("chip", 1.0, -1.0, 3000.0, 3000.0, 2565585.0,
                     3314805.0, CONUS_ALBERS_PROJ)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """A pair of grid levels.  Replaces the merlin cfg dict-of-functions
    (reference conftest swaps grid_fn/snap_fn/near_fn for fixtures;
    test/conftest.py:20-37) — here the definition itself is the seam."""

    tile: GridDef = CONUS_TILE
    chip: GridDef = CONUS_CHIP

    def definition(self) -> list[dict]:
        """Grid definition list, shaped like GET /grid responses."""
        return [self.tile.to_dict(), self.chip.to_dict()]


CONUS = GridConfig()


def grid_pt(x: float, y: float, g: GridDef) -> tuple[int, int]:
    """Snap a projection point to its (h, v) cell index in grid g."""
    h = int(np.floor((g.rx * x + g.tx) / g.sx))
    v = int(np.floor((g.ry * y + g.ty) / g.sy))
    return h, v


def proj_pt(h: int, v: int, g: GridDef) -> tuple[float, float]:
    """Upper-left projection coordinate of cell (h, v) in grid g."""
    return g.rx * (h * g.sx - g.tx), g.ry * (v * g.sy - g.ty)


def snap(x: float, y: float, cfg: GridConfig = CONUS) -> dict:
    """Snap a point to both grid levels.

    Returns the same shape as Chipmunk GET /snap
    (test/data/snap_response.json):
    {'tile': {'proj-pt': (x,y), 'grid-pt': (h,v)}, 'chip': {...}}
    """
    out = {}
    for name, g in (("tile", cfg.tile), ("chip", cfg.chip)):
        h, v = grid_pt(x, y, g)
        out[name] = {"proj-pt": proj_pt(h, v, g), "grid-pt": (h, v)}
    return out


def extents(ulx: float, uly: float, g: GridDef) -> dict:
    """Bounding extents of the cell whose upper-left is (ulx, uly).

    Assumes the LCMAP orientation rx=+1, ry=-1 (x east, y south with v);
    extents/coordinates are not defined for other reflections.
    """
    assert g.rx == 1.0 and g.ry == -1.0, "only rx=+1, ry=-1 grids supported"
    return {"ulx": ulx, "uly": uly, "lrx": ulx + g.sx, "lry": uly - g.sy}


def coordinates(ext: dict, g: GridDef) -> np.ndarray:
    """All cell upper-left coordinates of grid g within extents.

    Row-major: y descending (north to south) outer, x ascending inner.
    For one tile with the chip grid this yields 50*50 = 2500 chip ids.
    Returns an int64 array of shape [N, 2] (chip coords are whole meters).
    """
    xs = np.arange(ext["ulx"], ext["lrx"], g.sx)
    ys = np.arange(ext["uly"], ext["lry"], -g.sy)
    gx, gy = np.meshgrid(xs, ys)  # [ny, nx]
    return np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.int64)


def near(x: float, y: float, cfg: GridConfig = CONUS) -> dict:
    """The 3x3 neighborhood of tiles and chips around a point.

    Same shape as Chipmunk GET /near (test/data/near_response.json):
    {'tile': [{'proj-pt': .., 'grid-pt': ..} x 9], 'chip': [... x 9]},
    ordered h ascending outer, proj-y ascending inner (v descending).
    """
    out = {}
    for name, g in (("tile", cfg.tile), ("chip", cfg.chip)):
        h0, v0 = grid_pt(x, y, g)
        cells = []
        for dh in (-1, 0, 1):
            for dv in (1, 0, -1):  # proj-y ascending == v descending
                h, v = h0 + dh, v0 + dv
                cells.append({"proj-pt": proj_pt(h, v, g), "grid-pt": (h, v)})
        out[name] = cells
    return out


def tile(x: float, y: float, cfg: GridConfig = CONUS) -> dict:
    """Given a point, return its tile record (ref ccdc/grid.py:23-53).

    Returns {'x','y','h','v','ulx','uly','lrx','lry','chips'} where chips is
    an [N,2] int array of the tile's chip upper-left coordinates.
    """
    h, v = grid_pt(x, y, cfg.tile)
    tx, ty = proj_pt(h, v, cfg.tile)
    ext = extents(tx, ty, cfg.tile)
    return dict(x=tx, y=ty, h=h, v=v, **ext,
                chips=coordinates(ext, cfg.chip))


def chips(tile_record: dict) -> list[tuple[int, int]]:
    """Chip ids of a tile as a list of int (x, y) (ref ccdc/grid.py:56-66)."""
    return [(int(cx), int(cy)) for cx, cy in tile_record["chips"]]


def training(x: float, y: float, cfg: GridConfig = CONUS) -> list[tuple[int, int]]:
    """Chip ids for training: the 3x3 tile neighborhood (ref
    ccdc/grid.py:69-89, 9 tiles = 22500 chips)."""
    out: list[tuple[int, int]] = []
    for t in near(x, y, cfg)["tile"]:
        tx, ty = t["proj-pt"]
        out.extend(chips(tile(tx, ty, cfg)))
    return out


def classification(x: float, y: float, cfg: GridConfig = CONUS) -> list[tuple[int, int]]:
    """Chip ids for classification: the single containing tile (ref
    ccdc/grid.py:92-103)."""
    return chips(tile(x, y, cfg))


def cells_for_bounds(bounds: list[tuple[float, float]],
                     g: GridDef) -> list[tuple[int, int]]:
    """(h, v) cells of grid g covering the bounding box of the points,
    row-major (north-to-south outer, west-to-east inner)."""
    assert g.rx == 1.0 and g.ry == -1.0, "only rx=+1, ry=-1 grids supported"
    xs = [p[0] for p in bounds]
    ys = [p[1] for p in bounds]
    h0, v0 = grid_pt(min(xs), max(ys), g)   # upper-left corner
    h1, v1 = grid_pt(max(xs), min(ys), g)   # lower-right corner
    return [(h, v) for v in range(v0, v1 + 1) for h in range(h0, h1 + 1)]


def tiles_for_bounds(bounds: list[tuple[float, float]],
                     cfg: GridConfig = CONUS) -> list[dict]:
    """Tile records covering the bounding box of the given points.

    The reference enumerates its run area as a static tile CSV
    (resources/conus.csv, header h,v,ulx,uly,lrx,lry) consumed by deploy
    scripts; here the enumeration is computed from the grid definition for
    any area.  Returns [{'h','v','ulx','uly','lrx','lry'}, ...] in
    row-major order (v then h), the same fields as that CSV.
    """
    out = []
    for h, v in cells_for_bounds(bounds, cfg.tile):
        tx, ty = proj_pt(h, v, cfg.tile)
        out.append(dict(h=h, v=v, **extents(tx, ty, cfg.tile)))
    return out

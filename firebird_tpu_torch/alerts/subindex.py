"""Quadkey subscription index: spatial audience resolution in O(levels).

The port's own copy of the JAX package's ``alerts/subindex.py``.  The
flat subscriber table scales delivery O(subscribers) per alert (a bbox
test against every registered row); this module is the spatial half of
the fanout plane.  A subscriber AOI is decomposed once, at registration,
into a small covering set of quadkey cells (serve/pyramid.py's
Bing-style scheme over the Albers chip grid: base level Z_BASE, one base
tile a chip), and an alert point resolves its audience by looking up the
O(Z_BASE) quadkeys on its ancestor chain instead of scanning subscribers:

- **Registration** (:func:`cover_bbox`): descend from the AOI's deepest
  single ancestor tile, emitting a tile when it is fully inside the bbox
  or the cell budget is reached: CONUS-wide AOIs register a few coarse
  cells, chip-sized AOIs one base cell, and every AOI costs at most
  ``max_cells`` index rows whatever its area.
- **Resolution** (:func:`point_cells`): the alert pixel's base quadkey
  and every prefix of it (root included).  A covering cell contains the
  point iff it is one of those prefixes, so audience lookup is one
  ``cell IN (12 quadkeys)`` probe of the ``subscription_cells`` table.

Covering cells may overhang the exact bbox (partial base cells, budget
coalescing), so resolution post-filters candidates against the exact AOI
stored on the subscriber row.  The root quadkey is the empty string: a
subscriber with no AOI registers the root cell and matches everywhere.
Points or AOIs outside the quadkey domain (off the CONUS chip grid's
[0, 2**Z_BASE) index range) cannot be indexed: such AOIs get no cells and
such alerts resolve to root-cell (global) subscribers only.  The cells are
the JAX package's string for string, so a subscriber registered by either
package gets the same audience in the other.
"""

from __future__ import annotations

from firebird_tpu_torch import grid

# Deepest quadkey level (== serve.pyramid.Z_BASE; one base tile is one
# chip).  Redeclared here so the alert log does not drag the pyramid's
# numpy stack into import time.
Z_BASE = 11

# Default AOI covering budget (FIREBIRD_FANOUT_MAX_CELLS): the most index
# rows one registration may cost.  64 coarse-to-base cells cover any
# rectangle with < one tile-width of overhang per edge.
MAX_CELLS = 64


def quadkey(z: int, x: int, y: int) -> str:
    """Bing-style quadkey: one base-4 digit per level, most significant
    first; the root (z=0) is the empty string."""
    if not 0 <= z <= Z_BASE:
        raise ValueError(f"zoom must be in [0, {Z_BASE}], got {z}")
    if not (0 <= x < (1 << z) and 0 <= y < (1 << z)):
        raise ValueError(
            f"tile ({x}, {y}) outside the level-{z} domain [0, {1 << z})")
    digits = []
    for i in range(z, 0, -1):
        bit = 1 << (i - 1)
        digits.append(str(((1 if y & bit else 0) << 1)
                          | (1 if x & bit else 0)))
    return "".join(digits)


def base_quadkey(cx: float, cy: float) -> str | None:
    """The base-level quadkey of chip (cx, cy); None for chips outside the
    quadkey domain (off the CONUS chip grid's [0, 2**Z_BASE) index
    range)."""
    h, v = grid.grid_pt(float(cx), float(cy), grid.CONUS.chip)
    if not (0 <= h < (1 << Z_BASE) and 0 <= v < (1 << Z_BASE)):
        return None
    return quadkey(Z_BASE, h, v)


def point_cells(px: float, py: float) -> list[str]:
    """Every quadkey whose tile contains projection point (px, py): the
    base tile's quadkey and all its prefixes, root ("") first — the
    O(levels) lookup set of audience resolution.  Out-of-domain points
    degrade to the root cell alone (global subscribers)."""
    from firebird_tpu_torch.serve import pyramid as pyr

    try:
        x, y = pyr.tile_for_point(px, py, Z_BASE)
    except ValueError:
        return [""]
    qk = pyr.quadkey(Z_BASE, x, y)
    return [qk[:i] for i in range(Z_BASE + 1)]


def _extent(z: int, x: int, y: int) -> tuple[float, float, float, float]:
    from firebird_tpu_torch.serve import pyramid as pyr

    e = pyr.tile_extent(z, x, y)
    return e["ulx"], e["lry"], e["lrx"], e["uly"]     # minx,miny,maxx,maxy


def cover_bbox(bbox, max_cells: int = MAX_CELLS) -> list[str]:
    """A covering quadkey cell set for projection bbox (minx, miny, maxx,
    maxy): at most ``max_cells`` cells whose union contains every
    in-domain point of the bbox.  Cells are emitted coarse where the bbox
    fully contains a tile (or the budget forces coalescing) and at the
    base level otherwise; the overhang is post-filtered at resolution
    time by the exact AOI.  Empty when the bbox misses the quadkey domain
    entirely."""
    from firebird_tpu_torch.serve import pyramid as pyr

    minx, miny, maxx, maxy = (float(v) for v in bbox)
    if minx > maxx or miny > maxy:
        raise ValueError(f"bbox must be minx,miny,maxx,maxy with "
                         f"min <= max, got {bbox!r}")
    if max_cells < 4:
        raise ValueError(f"max_cells must be >= 4, got {max_cells}")
    dminx, dminy, dmaxx, dmaxy = _extent(0, 0, 0)
    if minx > dmaxx or maxx < dminx or miny > dmaxy or maxy < dminy:
        return []
    # Clamp the corner chip indices into the domain, then start the
    # descent at the corners' deepest common ancestor: a chip-sized AOI
    # costs ~Z_BASE quadkey digits of shared prefix, not a walk from the
    # root.
    g = grid.CONUS.chip
    lim = (1 << Z_BASE) - 1
    h0, v0 = grid.grid_pt(max(minx, dminx), min(maxy, dmaxy), g)
    h1, v1 = grid.grid_pt(min(maxx, dmaxx), max(miny, dminy), g)
    h0, v0 = min(max(h0, 0), lim), min(max(v0, 0), lim)
    h1, v1 = min(max(h1, 0), lim), min(max(v1, 0), lim)
    qk0 = pyr.quadkey(Z_BASE, h0, v0)
    qk1 = pyr.quadkey(Z_BASE, h1, v1)
    n = 0
    while n < Z_BASE and qk0[n] == qk1[n]:
        n += 1
    z0, x0, y0 = pyr.tile_from_quadkey(qk0[:n])
    out: list[str] = []
    queue: list[tuple[int, int, int]] = [(z0, x0, y0)]
    while queue:
        z, x, y = queue.pop()
        tminx, tminy, tmaxx, tmaxy = _extent(z, x, y)
        if tminx > maxx or tmaxx < minx or tminy > maxy or tmaxy < miny:
            continue
        inside = (tminx >= minx and tmaxx <= maxx
                  and tminy >= miny and tmaxy <= maxy)
        # Budget rule: emitting this tile coarse (overhang and all) keeps
        # the total at most max_cells; splitting must leave room for this
        # tile's four children plus everything still queued.
        if inside or z == Z_BASE \
                or len(out) + len(queue) + 4 > max_cells:
            out.append(pyr.quadkey(z, x, y))
        else:
            queue.extend(pyr.children(z, x, y))
    return sorted(out)


def shard_of(qk: str, prefix_len: int) -> str:
    """The fanout shard of a base quadkey: its leading ``prefix_len``
    digits (the quadkey-prefix shard key)."""
    return qk[:max(int(prefix_len), 0)]


def shard_prefixes(shard: str) -> list[str]:
    """The proper prefixes of a shard key, root first: the coarse cells
    whose subscribers also belong to the shard (a CONUS-wide cell at z=1
    intersects every deeper shard under it).  The shard itself and its
    descendants match by ``LIKE shard || '%'``."""
    return [shard[:i] for i in range(len(shard))]


def aoi_contains(aoi, px: float, py: float) -> bool:
    """Exact post-filter: True when ``aoi`` (a 4-tuple or None) is global
    or contains the point — the closed-interval rule the alert log's
    ``since(bbox=...)`` filter uses."""
    if aoi is None:
        return True
    minx, miny, maxx, maxy = aoi
    return minx <= px <= maxx and miny <= py <= maxy

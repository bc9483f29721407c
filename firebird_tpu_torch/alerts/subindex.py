"""Quadkey stamps for alert records.

The port's own copy of what the alert log needs from the JAX package's
``alerts/subindex.py``: :func:`base_quadkey`, the chip's base-level
quadkey that the log stamps on every record so the fanout plane can roll
alerts up by quadkey prefix (a ``substr()`` group-by).  The quadkey
scheme is the JAX package's ``serve/pyramid.py``: Bing-style, one base-4
digit a level over the Albers chip grid, base level Z_BASE, one base tile
a chip.  The covering and audience functions of the subscription index
are not ported yet.
"""

from __future__ import annotations

from firebird_tpu_torch import grid

# Deepest quadkey level: one base tile is one chip; 2**Z_BASE chips a side
# bound the quadkey domain (the CONUS chip grid's h/v range fits).
Z_BASE = 11

# Default AOI covering budget (FIREBIRD_FANOUT_MAX_CELLS).
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

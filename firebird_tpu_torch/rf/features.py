"""Classification feature assembly: the port's own copy of the JAX
package's ``rf/features.py`` (which replaces ccdc/features.py + ccdc/udfs.py).

The 33-column contract is the reference's exactly (ccdc/features.py:20-37 —
"Altering this list invalidates all persisted models"): 7 magnitudes,
7 rmses, 7 first harmonic coefficients, 7 intercepts, then dem, aspect,
slope, mpw, posidex.  The reference's ``densify`` UDF takes ``first(x)`` of
any list-valued column (ccdc/udfs.py:19-21) — hence *first* coefficient
only, and element 0 of each length-1 aux array.  Label = ``trends[0]``
(ccdc/features.py:40-50).

The reference assembles rows via a Spark inner join of the aux and segment
dataframes on (cx, cy, px, py) (ccdc/features.py:6-17).  Here the join is a
direct array gather: aux layers are dense [100, 100] chip rasters and
segment rows carry (px, py), so ``aux[py - cy-edge, ...]`` indexing replaces
the shuffle.
"""

from __future__ import annotations

import numpy as np

from firebird_tpu_torch.ccd.format import BAND_PREFIX
from firebird_tpu_torch.ingest.packer import CHIP_SIDE, PIXEL_SIZE_M
from firebird_tpu_torch.utils import dates as dt

AUX_FEATURES = ("dem", "aspect", "slope", "mpw", "posidex")

COLUMNS = (
    tuple(f"{p}mag" for p in BAND_PREFIX)
    + tuple(f"{p}rmse" for p in BAND_PREFIX)
    + tuple(f"{p}coef" for p in BAND_PREFIX)
    + tuple(f"{p}int" for p in BAND_PREFIX)
    + AUX_FEATURES
)

TRENDS_EXCLUDE = (0, 9)      # ccdc/randomforest.py:63 'trends[0] NOT IN (0, 9)'


def pixel_index(cx: int, cy: int, px: np.ndarray, py: np.ndarray):
    """(px, py) projection coords -> (row, col) into a [100, 100] chip
    raster.  px increases east from cx; py decreases south from cy."""
    col = ((np.asarray(px) - cx) // PIXEL_SIZE_M).astype(np.int64)
    row = ((cy - np.asarray(py)) // PIXEL_SIZE_M).astype(np.int64)
    if ((col < 0) | (col >= CHIP_SIDE) | (row < 0) | (row >= CHIP_SIDE)).any():
        raise ValueError("pixel coords outside chip")
    return row, col


def _first(v):
    """densify's first(x)-if-sequence rule (ccdc/udfs.py:19-21)."""
    if isinstance(v, (list, tuple, np.ndarray)):
        return v[0] if len(v) else np.nan
    return v


def segment_window(seg: dict, msday: int, meday: int) -> np.ndarray:
    """Row mask: training window 'sday >= msday AND eday <= meday'
    (ccdc/randomforest.py:69), on ISO-string day columns."""
    lo, hi = dt.to_iso(msday), dt.to_iso(meday)
    sday = np.asarray(seg["sday"], object)
    eday = np.asarray(seg["eday"], object)
    return np.array([s >= lo and e <= hi for s, e in zip(sday, eday)], bool)


def real_rows(seg: dict) -> np.ndarray:
    """Mask off sentinel rows (sday == eday == 0001-01-01,
    ccdc/pyccd.py:99-103): they carry no model and can't be featurized."""
    return np.array([s != "0001-01-01" for s in seg["sday"]], bool)


def assemble(seg: dict, aux: dict, cx: int, cy: int,
             row_mask: np.ndarray | None = None):
    """Segment rows + aux chip rasters -> (X [N, 33], meta dict).

    ``seg`` is a segment-table frame (dict of columns) for one chip;
    ``aux`` maps layer name -> [100, 100] array.  Mirrors
    features.dataframe (ccdc/features.py:66-82): the output meta carries
    (cx, cy, px, py, sday, eday) and, when ``trends`` is present in aux,
    a ``label`` column.
    """
    n = len(seg["sday"])
    mask = np.ones(n, bool) if row_mask is None else np.asarray(row_mask)
    idx = np.flatnonzero(mask)
    px = np.asarray(seg["px"], np.int64)[idx]
    py = np.asarray(seg["py"], np.int64)[idx]
    row, col = pixel_index(cx, cy, px, py)

    X = np.empty((idx.size, len(COLUMNS)), np.float32)
    for j, name in enumerate(COLUMNS):
        if name in AUX_FEATURES:
            X[:, j] = np.asarray(aux[name], np.float32)[row, col]
        else:
            colv = seg[name]
            X[:, j] = [np.float32(_first(colv[i])) if colv[i] is not None
                       else np.nan for i in idx]

    meta = {k: [seg[k][i] for i in idx]
            for k in ("cx", "cy", "px", "py", "sday", "eday")}
    if "trends" in aux:
        meta["label"] = np.asarray(aux["trends"])[row, col]
    return X, meta

"""Result formatting: detector output -> the store's row contracts.

A copy of the JAX package's ``ccd/format.py`` against this package's
``ChipSegments``: the pyccd-style per-pixel rows (``format_records``), the
int-coded egress decode, and the vectorized chip-level path that goes
straight from ChipSegments arrays to the three table frames (chip / pixel /
segment).  ChipSegments may hold tensors (any device) or host arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from firebird_tpu_torch.ccd import harmonic, kernel, params
from firebird_tpu_torch.store.schema import BAND_PREFIX
from firebird_tpu_torch.utils import dates as dt


def default(change_models: list) -> list:
    """Sentinel segment when ccd ran but found no models
    (ccdc/pyccd.py:99-103)."""
    return ([{"start_day": 1, "end_day": 1, "break_day": 1}]
            if not change_models else change_models)


def format_records(cx, cy, px, py, dates, ccdresult) -> list[dict]:
    """Per-pixel result -> list of flat row dicts (ccdc/pyccd.py:106-148).

    ``dates`` are ordinal days; emitted as ISO strings in input order, the
    processing mask alongside.
    """
    def g(cm, *keys, default=None):
        v = cm
        for k in keys:
            if not isinstance(v, dict) or k not in v:
                return default
            v = v[k]
        return v

    mask = ccdresult.get("processing_mask")
    rows = []
    for cm in default(ccdresult.get("change_models") or []):
        row = {
            "cx": int(cx), "cy": int(cy), "px": int(px), "py": int(py),
            "sday": dt.to_iso(cm["start_day"]),
            "eday": dt.to_iso(cm["end_day"]),
            "bday": dt.to_iso(cm.get("break_day", cm["end_day"])),
            "chprob": g(cm, "change_probability"),
            "curqa": g(cm, "curve_qa"),
        }
        for b, name in enumerate(params.BAND_NAMES):
            p = BAND_PREFIX[b]
            row[f"{p}mag"] = g(cm, name, "magnitude")
            row[f"{p}rmse"] = g(cm, name, "rmse")
            row[f"{p}coef"] = g(cm, name, "coefficients")
            row[f"{p}int"] = g(cm, name, "intercept")
        row["dates"] = [dt.to_iso(int(o)) for o in dates]
        row["mask"] = list(mask) if mask is not None else None
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Int-coded egress decode (the host half of kernel.pack_egress)
# ---------------------------------------------------------------------------

def decode_egress(tables: dict, T: int):
    """Int egress tables (kernel.pack_egress; tensors or host arrays) -> a
    float32 host ChipSegments of numpy arrays,
    bit-exact against the raw f32 drain (the kernel.pack_egress coding
    contract): integer meta columns widen exactly (< 2^24), the
    count-coded chprob column re-runs the kernel's own f32 division,
    the bitcast planes reinterpret in place (zero-copy views), and the
    bitpacked mask unpacks to ``T`` columns.  Segment planes come back
    at the PACKED depth ``s_eff`` — every consumer reads capacity from
    ``seg_meta.shape[-2]``, and the drain's capacity probe guarantees no
    pixel closed more than ``s_eff`` segments, so frames are identical
    to the full-capacity result."""
    tables = {k: _host(v) for k, v in tables.items()}
    f32 = lambda a: np.ascontiguousarray(
        np.asarray(a, np.int32)).view(np.float32)
    meta_i = np.asarray(tables["meta"], np.int32)
    meta = meta_i.astype(np.float32)
    meta[..., 3] = meta_i[..., 3].astype(np.float32) \
        / np.float32(params.PEEK_SIZE)
    mask = np.unpackbits(np.asarray(tables["mask"], np.uint8),
                         axis=-1, count=T).astype(bool)
    opt = {f: (np.asarray(tables[f]) if f in tables else None)
           for f in kernel.EGRESS_INTS}
    vario = f32(tables["vario"]) if "vario" in tables else None
    return kernel.ChipSegments(
        n_segments=np.asarray(tables["n_segments"]),
        seg_meta=meta, seg_rmse=f32(tables["rmse"]),
        seg_mag=f32(tables["mag"]), seg_coef=f32(tables["coef"]),
        mask=mask, procedure=np.asarray(tables["procedure"]),
        vario=vario, **opt)


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else a


# ---------------------------------------------------------------------------
# Vectorized chip-level frames
# ---------------------------------------------------------------------------

def _int_or_none(vals: np.ndarray, real: np.ndarray) -> np.ndarray:
    """Object column of ints, None on sentinel rows (NULL in the store)."""
    col = np.empty(vals.shape[0], object)
    col[:] = np.asarray(vals, np.int64).tolist()
    col[~real] = None
    return col


def _iso_col(ordinals: np.ndarray) -> np.ndarray:
    """Vector ordinal->ISO via a small unique-value table."""
    ordinals = np.asarray(ordinals, np.int64)
    uniq, inv = np.unique(ordinals, return_inverse=True)
    table = np.array([dt.to_iso(int(o)) if o > 0 else "0001-01-01"
                      for o in uniq], dtype=object)
    return table[inv]


def _check_landsat_schema(packed, what: str) -> None:
    if packed.sensor.band_names != params.BAND_NAMES:
        raise ValueError(
            f"{what} writes the reference's Landsat segment schema "
            f"(7 bands, ccdc/segment.py:16-56); got sensor "
            f"{packed.sensor.name!r} with {packed.sensor.n_bands} bands — "
            "persist non-Landsat results through a sensor-specific schema")


def chip_frames(packed, chip: int, seg) -> dict[str, dict]:
    """ChipSegments (host arrays, single chip) -> the three table frames.

    Returns {'chip': {...}, 'pixel': {...}, 'segment': {...}} where each
    value is a dict of column -> numpy array, matching the reference table
    schemas (ccdc/chip.py:15-22, pixel.py:14-21, segment.py:16-56).
    Pixels with no segments contribute the sentinel row (sday=eday=bday=
    0001-01-01, ccdc/pyccd.py:99-103) so reruns stay idempotent.
    """
    _check_landsat_schema(packed, "chip_frames")
    seg = kernel.segments_to_numpy(seg)
    cx, cy = (int(v) for v in packed.cids[chip])
    T = int(packed.n_obs[chip])
    dates_ord = packed.dates[chip][:T]
    anchor = float(dates_ord[0]) if T else 0.0
    dates_iso = [dt.to_iso(int(o)) for o in dates_ord]

    P = seg.n_segments.shape[0]
    coords = packed.pixel_coords(chip)                         # [P,2]

    # clip to buffer capacity: detect_packed re-dispatches on overflow, so
    # this only guards frames built from a raw kernel result
    nseg = np.minimum(np.asarray(seg.n_segments, np.int64),
                      seg.seg_meta.shape[-2])
    n_rows = np.maximum(nseg, 1)                               # sentinel rows
    pix_of_row = np.repeat(np.arange(P), n_rows)
    # per-row segment index; sentinel rows get -1
    seg_idx = np.concatenate([
        np.arange(n) if n else np.array([-1])
        for n in nseg]).astype(np.int64)
    real = seg_idx >= 0
    si = np.maximum(seg_idx, 0)

    meta = np.asarray(seg.seg_meta, np.float64)[pix_of_row, si]    # [R,6]
    rmse = np.asarray(seg.seg_rmse, np.float64)[pix_of_row, si]    # [R,7]
    mag = np.asarray(seg.seg_mag, np.float64)[pix_of_row, si]
    coefs = np.asarray(seg.seg_coef, np.float64)[pix_of_row, si]   # [R,7,8]
    coefs7, intercept = harmonic.to_pyccd_convention(coefs, anchor)

    R = meta.shape[0]
    segment = {
        "cx": np.full(R, cx, np.int64), "cy": np.full(R, cy, np.int64),
        "px": coords[pix_of_row, 0], "py": coords[pix_of_row, 1],
        "sday": np.where(real, _iso_col(meta[:, 0]), "0001-01-01"),
        "eday": np.where(real, _iso_col(meta[:, 1]), "0001-01-01"),
        "bday": np.where(real, _iso_col(meta[:, 2]), "0001-01-01"),
        "chprob": np.where(real, meta[:, 3], np.nan),
        "curqa": _int_or_none(meta[:, 4], real),
        "rfrawp": np.full(R, None, object),
    }
    for b in range(params.NUM_BANDS):
        p = BAND_PREFIX[b]
        segment[f"{p}mag"] = np.where(real, mag[:, b], np.nan)
        segment[f"{p}rmse"] = np.where(real, rmse[:, b], np.nan)
        segment[f"{p}int"] = np.where(real, intercept[:, b], np.nan)
        col = np.empty(R, object)
        col[:] = list(coefs7[:, b])         # rows stay numpy; backends pack
        col[~real] = None
        segment[f"{p}coef"] = col

    mask = np.asarray(seg.mask, np.uint8)[:, :T]
    mask_col = np.empty(P, object)
    mask_col[:] = list(mask)                # rows stay numpy; backends pack
    dates_col = np.empty(1, object)
    dates_col[0] = dates_iso
    pixel = {
        "cx": np.full(P, cx, np.int64), "cy": np.full(P, cy, np.int64),
        "px": coords[:, 0], "py": coords[:, 1],
        "mask": mask_col,
    }
    chip_frame = {
        "cx": np.array([cx], np.int64), "cy": np.array([cy], np.int64),
        "dates": dates_col,
    }
    return {"chip": chip_frame, "pixel": pixel, "segment": segment}


def batch_frames(packed, seg,
                 n_real: int | None = None) -> list[tuple[tuple, dict]]:
    """A whole drained batch -> per-chip table frames in ONE numpy pass.

    ``seg`` is a batched ChipSegments ([C, P, ...], fetched to the host
    in one pass here); the
    segment table — by far the widest of the three — is built across the
    entire chip axis at once (row expansion, ISO tables, coefficient
    convention) and only *split* per chip at the end, so the egress cost
    is one vectorized pass instead of C python formatting loops.  Padded
    chips beyond ``n_real`` are dropped.

    Returns ``[((cx, cy), {'chip': .., 'pixel': .., 'segment': ..}), ...]``
    for the first ``n_real`` chips, each entry identical to
    ``chip_frames(packed, c, chip_slice(seg, c, to_host=True))`` — the
    rows the store writes.
    """
    _check_landsat_schema(packed, "batch_frames")
    seg = kernel.segments_to_numpy(seg)
    C = packed.n_chips if n_real is None else int(n_real)
    if C == 0:
        return []
    P = seg.n_segments.shape[1]

    # ---- global row expansion across the chip axis ----
    nseg = np.minimum(np.asarray(seg.n_segments[:C], np.int64),
                      seg.seg_meta.shape[-2])                  # [C,P]
    n_rows = np.maximum(nseg, 1).reshape(-1)                   # sentinels
    R = int(n_rows.sum())
    flat = np.repeat(np.arange(C * P), n_rows)                 # [R] c*P+p
    chip_of_row = flat // P
    pix_of_row = flat % P
    starts = np.cumsum(n_rows) - n_rows
    within = np.arange(R) - np.repeat(starts, n_rows)
    seg_idx = np.where(nseg.reshape(-1)[flat] > 0, within, -1)
    real = seg_idx >= 0
    si = np.maximum(seg_idx, 0)

    meta = np.asarray(seg.seg_meta, np.float64)[chip_of_row, pix_of_row, si]
    rmse = np.asarray(seg.seg_rmse, np.float64)[chip_of_row, pix_of_row, si]
    mag = np.asarray(seg.seg_mag, np.float64)[chip_of_row, pix_of_row, si]
    coefs = np.asarray(seg.seg_coef, np.float64)[chip_of_row, pix_of_row, si]
    # Per-chip design anchors, broadcast per row: the convention change is
    # elementwise, so per-row anchors are bit-identical to the per-chip
    # scalar calls.
    anchors = np.array([float(packed.dates[c][0]) if int(packed.n_obs[c])
                        else 0.0 for c in range(C)])
    coefs7, intercept = harmonic.to_pyccd_convention(
        coefs, anchors[chip_of_row][:, None])

    coords_all = np.stack([packed.pixel_coords(c)
                           for c in range(C)])                 # [C,P,2]
    segment = {
        "cx": packed.cids[chip_of_row, 0].astype(np.int64),
        "cy": packed.cids[chip_of_row, 1].astype(np.int64),
        "px": coords_all[chip_of_row, pix_of_row, 0],
        "py": coords_all[chip_of_row, pix_of_row, 1],
        "sday": np.where(real, _iso_col(meta[:, 0]), "0001-01-01"),
        "eday": np.where(real, _iso_col(meta[:, 1]), "0001-01-01"),
        "bday": np.where(real, _iso_col(meta[:, 2]), "0001-01-01"),
        "chprob": np.where(real, meta[:, 3], np.nan),
        "curqa": _int_or_none(meta[:, 4], real),
        "rfrawp": np.full(R, None, object),
    }
    for b in range(params.NUM_BANDS):
        p = BAND_PREFIX[b]
        segment[f"{p}mag"] = np.where(real, mag[:, b], np.nan)
        segment[f"{p}rmse"] = np.where(real, rmse[:, b], np.nan)
        segment[f"{p}int"] = np.where(real, intercept[:, b], np.nan)
        col = np.empty(R, object)
        col[:] = list(coefs7[:, b])
        col[~real] = None
        segment[f"{p}coef"] = col

    # ---- split per chip (keyed writes preserve the resume invariant) ----
    rows_per_chip = n_rows.reshape(C, P).sum(1)
    bounds = np.concatenate([[0], np.cumsum(rows_per_chip)])
    mask_all = np.asarray(seg.mask, np.uint8)
    out = []
    for c in range(C):
        cx, cy = (int(v) for v in packed.cids[c])
        lo, hi = int(bounds[c]), int(bounds[c + 1])
        seg_c = {k: v[lo:hi] for k, v in segment.items()}
        T = int(packed.n_obs[c])
        mask_col = np.empty(P, object)
        mask_col[:] = list(mask_all[c, :, :T])
        pixel = {
            "cx": np.full(P, cx, np.int64), "cy": np.full(P, cy, np.int64),
            "px": coords_all[c, :, 0], "py": coords_all[c, :, 1],
            "mask": mask_col,
        }
        dates_col = np.empty(1, object)
        dates_col[0] = [dt.to_iso(int(o)) for o in packed.dates[c][:T]]
        chip_frame = {
            "cx": np.array([cx], np.int64), "cy": np.array([cy], np.int64),
            "dates": dates_col,
        }
        out.append(((cx, cy), {"chip": chip_frame, "pixel": pixel,
                               "segment": seg_c}))
    return out

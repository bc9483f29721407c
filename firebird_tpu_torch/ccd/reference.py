"""CCDC reference implementation (NumPy float64 oracle).

The port's own copy of the JAX package's ``ccd/reference.py``; the
variogram mode defaults to ``params.VARIOGRAM_DEFAULT`` (this package reads
no FIREBIRD_VARIOGRAM).  Defines the algorithm the detector must match.
Per-pixel, readable,
sequential — the shape of the original science code — while every numeric
step (design matrix, Lasso coordinate descent, IRLS Tmask) is specified so
a fixed-shape JAX translation is possible.

Interface mirrors the external pyccd package the reference drives
(``ccd.detect(**timeseries_data)``, ccdc/pyccd.py:161-168): keyword arrays
``dates, blues, greens, reds, nirs, swir1s, swir2s, thermals, qas`` and a
result dict ``{change_models, processing_mask, algorithm, procedure}`` whose
change-model records carry exactly the fields consumed by the format layer
(ccdc/pyccd.py:106-148, golden-tested by test/test_pyccd.py:37-126).

Algorithm: Zhu & Woodcock 2014 CCDC with the lcmap-pyccd 2018.03.12
parameterization (see params.py):

1. QA triage -> standard / permanent-snow / insufficient-clear procedure.
2. Standard: clear+water obs, de-duplicated, range-filtered; per-band
   variogram; then a sequential pass over time:
   a. *Initialize*: find a window with >= MEOW_SIZE obs spanning >=
      INIT_DAYS; Tmask-screen it (robust IRLS harmonic on green/swir1);
      fit 4-coef Lasso models; stable iff |slope*span|, |first resid| and
      |last resid| all <= STABILITY_FACTOR * max(rmse, variogram) for every
      detection band, else slide the window start forward.
   b. *Extend*: score each next observation against the model
      (sum over detection bands of (resid / max(rmse, vario))^2).  All
      PEEK_SIZE consecutive above CHANGE_THRESHOLD -> change: close the
      segment (break day = first exceeding obs, probability 1, magnitude =
      per-band median residual of the peek window) and re-initialize there.
      A single spike above OUTLIER_THRESHOLD -> drop the obs.  Otherwise
      absorb it, refitting whenever the segment grew REFIT_FACTOR x since
      the last fit (coef count 4/6/8 by obs count).
   c. *Tail*: fewer than PEEK_SIZE obs left -> close the final segment with
      change probability = exceeding/PEEK_SIZE.
"""

from __future__ import annotations

import numpy as np

from firebird_tpu_torch.ccd import harmonic, params
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, chi2_thresholds

ALGORITHM = "firebird-ccd:v1"


# ---------------------------------------------------------------------------
# QA predicates
# ---------------------------------------------------------------------------

def _bit(qa: np.ndarray, bit: int) -> np.ndarray:
    return (qa.astype(np.int64) >> bit) & 1 == 1


def qa_fill(qa):
    return _bit(qa, params.QA_FILL_BIT)


def qa_clear(qa):
    return _bit(qa, params.QA_CLEAR_BIT)


def qa_water(qa):
    return _bit(qa, params.QA_WATER_BIT)


def qa_snow(qa):
    return _bit(qa, params.QA_SNOW_BIT)


def in_range(Y: np.ndarray, sensor=LANDSAT_ARD) -> np.ndarray:
    """[B, T] spectra -> [T] all-bands-in-valid-range mask."""
    opt = Y[list(sensor.optical_bands)]
    ok = np.all((opt > params.OPTICAL_MIN) & (opt < params.OPTICAL_MAX),
                axis=0)
    if sensor.thermal_bands:
        th = Y[list(sensor.thermal_bands)]
        ok &= np.all((th > params.THERMAL_MIN) & (th < params.THERMAL_MAX),
                     axis=0)
    return ok


def dedup_first(t: np.ndarray, candidate: np.ndarray) -> np.ndarray:
    """Among candidate obs (sorted by t), keep only the first per date."""
    keep = candidate.copy()
    seen: set[int] = set()
    for k in np.flatnonzero(candidate):
        d = int(t[k])
        if d in seen:
            keep[k] = False
        else:
            seen.add(d)
    return keep


# ---------------------------------------------------------------------------
# Fitting helpers
# ---------------------------------------------------------------------------

def num_coefs(n_obs: int) -> int:
    """4/6/8 coefficients by observation density (pyccd obs factor 3)."""
    if n_obs >= params.MAX_COEFS * params.NUM_OBS_FACTOR:
        return params.MAX_COEFS
    if n_obs >= params.MID_COEFS * params.NUM_OBS_FACTOR:
        return params.MID_COEFS
    return params.MIN_COEFS


def variogram(t: np.ndarray, Y: np.ndarray,
              adjusted: bool = False) -> np.ndarray:
    """Per-band median absolute successive difference, floored at 1e-6.

    ``adjusted=True`` applies the lcmap-pyccd ``adjusted_variogram`` rule
    (reconstructed from the public lcmap-pyccd package the reference pins
    at setup.py:32; the pinned source itself is unreachable offline —
    docs/DIVERGENCE.md #1): restrict the successive-difference set to
    pairs more than VARIOGRAM_GAP_DAYS apart, so dense multi-sensor
    archives with near-coincident acquisitions (the 'ncompare' case: L7+L8
    pairs days apart whose tiny |diffs| crater the madogram and inflate
    false breaks) measure seasonal-scale variation instead.  When no pair
    clears the gap, the plain madogram is used.  The pair-selection is
    date-driven and shared by all bands, as in pyccd.
    """
    if t.shape[0] < 2:
        return np.ones(Y.shape[0], dtype=np.float64)
    d = np.abs(np.diff(Y.astype(np.float64), axis=1))
    if adjusted:
        sel = np.diff(t.astype(np.float64)) > params.VARIOGRAM_GAP_DAYS
        if np.any(sel):
            d = d[:, sel]
    v = np.median(d, axis=1)
    return np.maximum(v, 1e-6)


class _Model:
    """A fitted multi-band harmonic model over a window of observations.

    ``anchor`` is the global series anchor (first observation of the whole
    series), shared by every fit of a pixel — see harmonic.fit_bands.
    """

    def __init__(self, t: np.ndarray, Y: np.ndarray, ncoef: int, anchor: float):
        self.anchor = anchor
        self.ncoef = ncoef
        self.coefs, self.rmse = harmonic.fit_bands(t, Y, ncoef, anchor)

    def resid(self, t: np.ndarray, Y: np.ndarray) -> np.ndarray:
        """[7, n] residuals at times t."""
        return Y.astype(np.float64) - harmonic.predict(t, self.coefs, self.anchor)


def change_score(model: _Model, vario: np.ndarray, t: np.ndarray,
                 Y: np.ndarray, sensor=LANDSAT_ARD) -> np.ndarray:
    """[n] chi-square change scores for obs (t, Y) against the model."""
    r = model.resid(t, Y)
    s = np.zeros(t.shape[0], dtype=np.float64)
    for b in sensor.detection_bands:
        denom = max(model.rmse[b], vario[b])
        s += (r[b] / denom) ** 2
    return s


def tmask_outliers(t: np.ndarray, Y: np.ndarray, vario: np.ndarray,
                   sensor=LANDSAT_ARD) -> np.ndarray:
    """[n] True where an obs fails the robust Tmask screen on the sensor's
    Tmask bands (green/swir1 for Landsat ARD)."""
    # Tmask design has no trend column: build [1, yr, cos, sin, cos2, sin2]
    # then drop the yr column (index 1) -> TMASK_COEFS columns.  With the
    # trend gone the design is anchor-independent.
    X = harmonic.design_matrix(t, 0.0, params.TMASK_COEFS + 1)
    X = np.concatenate([X[:, :1], X[:, 2:]], axis=1)
    bad = np.zeros(t.shape[0], dtype=bool)
    for b in sensor.tmask_bands:
        y = Y[b].astype(np.float64)
        beta = harmonic.irls_huber(X, y)
        r = np.abs(y - X @ beta)
        bad |= r > params.TMASK_CONST * vario[b]
    return bad


# ---------------------------------------------------------------------------
# Segment record assembly
# ---------------------------------------------------------------------------

def _segment_record(model: _Model, *,
                    start_day: int, end_day: int, break_day: int,
                    n_obs: int, change_prob: float, curve_qa: int,
                    magnitudes: np.ndarray, sensor=LANDSAT_ARD) -> dict:
    coefs7, intercept = harmonic.to_pyccd_convention(model.coefs, model.anchor)
    rec = {
        "start_day": int(start_day),
        "end_day": int(end_day),
        "break_day": int(break_day),
        "observation_count": int(n_obs),
        "change_probability": float(change_prob),
        "curve_qa": int(curve_qa),
    }
    for b, name in enumerate(sensor.band_names):
        rec[name] = {
            "magnitude": float(magnitudes[b]),
            "rmse": float(model.rmse[b]),
            "coefficients": tuple(float(x) for x in coefs7[b]),
            "intercept": float(intercept[b]),
        }
    return rec


# ---------------------------------------------------------------------------
# The standard procedure state machine
# ---------------------------------------------------------------------------

def _standard_procedure(t: np.ndarray, Y: np.ndarray, usable: np.ndarray,
                        sensor=LANDSAT_ARD, adjusted_variogram=None):
    """Run CCDC over sorted obs.

    Args:
        t: [T] sorted ordinal days (all obs).
        Y: [B, T] spectra.
        usable: [T] candidate mask (clear, in-range, deduped).
        sensor: band layout (detection/Tmask roles, thresholds per dof).

    Returns:
        (change_models list, processing_mask [T] — usable obs that survived
        Tmask / spike removal).
    """
    CHANGE_THRESHOLD, OUTLIER_THRESHOLD = chi2_thresholds(
        len(sensor.detection_bands))
    if adjusted_variogram is None:
        adjusted_variogram = params.VARIOGRAM_DEFAULT == "adjusted"
    alive = usable.copy()
    idx_all = np.flatnonzero(usable)
    vario = variogram(t[idx_all], Y[:, idx_all],
                      adjusted=adjusted_variogram)
    # Global design anchor: the series' first observation — shared by all
    # pixels of a chip, so the TPU kernel can precompute one design matrix.
    anchor = float(t[0]) if t.shape[0] else 0.0

    segments: list[dict] = []

    def alive_from(k0: int) -> np.ndarray:
        return np.flatnonzero(alive[k0:]) + k0

    # Cursor i indexes into t (absolute position of the prospective segment
    # start).  Runs until no initialization window fits.
    n_total = t.shape[0]
    i = idx_all[0] if idx_all.size else n_total
    first_segment = True

    while True:
        # ------------------------------------------------------------- init
        w = alive_from(i)
        if w.size < params.MEOW_SIZE:
            break
        # Smallest j with MEOW_SIZE obs and INIT_DAYS span.
        jj = params.MEOW_SIZE - 1
        while jj < w.size and t[w[jj]] - t[w[0]] < params.INIT_DAYS:
            jj += 1
        if jj >= w.size:
            break
        window = w[: jj + 1]

        # Tmask screen (permanent removals).
        bad = tmask_outliers(t[window], Y[:, window], vario, sensor)
        if bad.any():
            alive[window[bad]] = False
            continue  # re-derive the window from the same cursor

        model = _Model(t[window], Y[:, window], params.MIN_COEFS, anchor)
        r = model.resid(t[window], Y[:, window])
        span = float(t[window[-1]] - t[window[0]])
        stable = True
        for b in sensor.detection_bands:
            denom = params.STABILITY_FACTOR * max(model.rmse[b], vario[b])
            slope_per_day = model.coefs[b, 1] / 365.25
            if (abs(slope_per_day * span) > denom
                    or abs(r[b, 0]) > denom
                    or abs(r[b, -1]) > denom):
                stable = False
                break
        if not stable:
            nxt = alive_from(window[0] + 1)
            if nxt.size == 0:
                break
            i = nxt[0]
            continue

        # -------------------------------------------------------- extension
        included = list(window)
        n_last_fit = len(included)
        model = _Model(t[included], Y[:, included], num_coefs(len(included)),
                       anchor)
        cursor = window[-1] + 1
        closed = False

        while not closed:
            peek = alive_from(cursor)[: params.PEEK_SIZE]
            if peek.size < params.PEEK_SIZE:
                # ------------------------------------------------------ tail
                # Absorb below-threshold tail obs into the final segment;
                # exceeding ones feed the residual change probability.
                n_exceed = 0
                if peek.size:
                    scores = change_score(model, vario, t[peek], Y[:, peek],
                                          sensor)
                    n_exceed = int(np.sum(scores > CHANGE_THRESHOLD))
                    for p, s in zip(peek, scores):
                        if s <= CHANGE_THRESHOLD:
                            included.append(p)
                        else:
                            alive[p] = False
                qa = params.CURVE_QA_END | (params.CURVE_QA_START if first_segment else 0)
                segments.append(_segment_record(
                    model,
                    start_day=t[included[0]], end_day=t[included[-1]],
                    break_day=t[included[-1]], n_obs=len(included),
                    change_prob=n_exceed / params.PEEK_SIZE, curve_qa=qa,
                    magnitudes=np.zeros(sensor.n_bands), sensor=sensor))
                return segments, alive

            scores = change_score(model, vario, t[peek], Y[:, peek], sensor)
            if np.all(scores > CHANGE_THRESHOLD):
                # ---------------------------------------------------- break
                resid_peek = model.resid(t[peek], Y[:, peek])
                mags = np.median(resid_peek, axis=1)
                qa = params.CURVE_QA_START if first_segment else params.CURVE_QA_INSIDE
                segments.append(_segment_record(
                    model,
                    start_day=t[included[0]], end_day=t[included[-1]],
                    break_day=t[peek[0]], n_obs=len(included),
                    change_prob=1.0, curve_qa=qa, magnitudes=mags,
                    sensor=sensor))
                first_segment = False
                i = peek[0]
                closed = True
            elif scores[0] > OUTLIER_THRESHOLD:
                alive[peek[0]] = False
                cursor = peek[0] + 1
            else:
                included.append(peek[0])
                if len(included) >= params.REFIT_FACTOR * n_last_fit:
                    model = _Model(t[included], Y[:, included],
                                   num_coefs(len(included)), anchor)
                    n_last_fit = len(included)
                cursor = peek[0] + 1

    return segments, alive


# ---------------------------------------------------------------------------
# Alternate procedures
# ---------------------------------------------------------------------------

def _single_model_procedure(t, Y, usable, curve_qa, sensor=LANDSAT_ARD):
    """Permanent-snow / insufficient-clear: one unbroken model over all
    usable obs (no change monitoring)."""
    idx = np.flatnonzero(usable)
    if idx.size < params.MEOW_SIZE:
        return [], np.zeros_like(usable)
    tw, Yw = t[idx], Y[:, idx]
    anchor = float(t[0])
    model = _Model(tw, Yw, num_coefs(idx.size), anchor)
    rec = _segment_record(
        model,
        start_day=tw[0], end_day=tw[-1], break_day=tw[-1],
        n_obs=idx.size, change_prob=0.0, curve_qa=curve_qa,
        magnitudes=np.zeros(sensor.n_bands), sensor=sensor)
    return [rec], usable.copy()


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def detect(dates, blues, greens, reds, nirs, swir1s, swir2s, thermals, qas,
           adjusted_variogram=None, **ignored) -> dict:
    """Run CCDC on one pixel's time series.

    Same keyword contract as pyccd's ccd.detect (driven at
    ccdc/pyccd.py:161-168).  Input arrays may be in any date order (the
    reference data plane delivers them newest-first); the processing mask in
    the result aligns with the *input* order, as the reference persists it
    next to the input dates (ccdc/pixel.py:14-21).

    ``adjusted_variogram`` switches the change/Tmask denominator floor to
    the reconstructed pyccd adjusted-variogram rule (docs/DIVERGENCE.md #1);
    ``None`` (the default) follows FIREBIRD_VARIOGRAM exactly as the kernel
    does (params.variogram_adjusted_default), so oracle and kernel can
    never disagree on the mode by default.
    """
    Y_in = np.stack([np.asarray(b, dtype=np.float64)
                     for b in (blues, greens, reds, nirs, swir1s, swir2s,
                               thermals)])
    return detect_sensor(dates, Y_in, qas, LANDSAT_ARD,
                         adjusted_variogram=adjusted_variogram)


def detect_sensor(dates, spectra, qas, sensor, adjusted_variogram=None) -> dict:
    """Sensor-generic oracle: ``spectra`` is [B, T] in the sensor's band
    order.  Same algorithm and result contract as :func:`detect`; the
    sensor supplies band roles and the chi2 thresholds' degrees of
    freedom, exactly as the kernel's static ``sensor`` argument does
    (kernel._detect_core)."""
    t_in = np.asarray(dates, dtype=np.int64)
    Y_in = np.asarray(spectra, dtype=np.float64)
    qa_in = np.asarray(qas)

    order = np.argsort(t_in, kind="stable")
    t, Y, qa = t_in[order], Y_in[:, order], qa_in[order]

    fill = qa_fill(qa)
    clear = (qa_clear(qa) | qa_water(qa)) & ~fill
    snow = qa_snow(qa) & ~fill

    n_nonfill = int(np.sum(~fill))
    n_clear = int(np.sum(clear))
    n_snow = int(np.sum(snow))

    if n_nonfill == 0:
        return {"change_models": [],
                "processing_mask": [0] * t_in.shape[0],
                "algorithm": ALGORITHM,
                "procedure": "no-data"}

    clear_pct = n_clear / n_nonfill
    snow_pct = n_snow / (n_clear + n_snow) if (n_clear + n_snow) else 0.0

    rng_ok = in_range(Y, sensor)
    if clear_pct >= params.CLEAR_PCT_THRESHOLD:
        usable = dedup_first(t, clear & rng_ok)
        models, mask = _standard_procedure(
            t, Y, usable, sensor, adjusted_variogram=adjusted_variogram)
        procedure = "standard"
    elif snow_pct > params.SNOW_PCT_THRESHOLD:
        usable = dedup_first(t, (clear | snow) & rng_ok)
        models, mask = _single_model_procedure(t, Y, usable,
                                               params.CURVE_QA_PERSIST_SNOW,
                                               sensor)
        procedure = "permanent-snow"
    else:
        cand = ~fill & rng_ok
        blue = Y[sensor.blue_band]
        if cand.any():
            blue_med = float(np.median(blue[cand]))
            cand = cand & (blue < blue_med + params.INSUF_CLEAR_BLUE_DELTA)
        usable = dedup_first(t, cand)
        models, mask = _single_model_procedure(t, Y, usable,
                                               params.CURVE_QA_INSUF_CLEAR,
                                               sensor)
        procedure = "insufficient-clear"

    # Map the (sorted-order) mask back to input order.
    mask_input = np.zeros(t_in.shape[0], dtype=np.int8)
    mask_input[order] = mask.astype(np.int8)

    return {"change_models": models,
            "processing_mask": mask_input.tolist(),
            "algorithm": ALGORITHM,
            "procedure": procedure}

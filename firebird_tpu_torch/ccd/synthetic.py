"""Synthetic Landsat-like time series for tests and benchmarks.

The reference has no numerical-accuracy fixtures (SURVEY.md §4 "notably
absent"); this generator closes that gap: harmonic + trend + noise series
with controllable QA patterns, step changes and outliers, so segment counts
and break dates have known ground truth.
"""

from __future__ import annotations

import numpy as np

from firebird_tpu_torch.ccd import harmonic, params
from firebird_tpu_torch.utils import dates as dt

QA_CLEAR = 1 << params.QA_CLEAR_BIT
QA_FILL = 1 << params.QA_FILL_BIT
QA_SNOW = 1 << params.QA_SNOW_BIT
QA_CLOUD = 1 << params.QA_CLOUD_BIT

# A plausible mean reflectance per band (blue..thermal, int16 scale).
DEFAULT_MEANS = np.array([400.0, 600.0, 500.0, 2500.0, 1500.0, 800.0, 2900.0])
DEFAULT_AMPS = np.array([50.0, 80.0, 80.0, 400.0, 250.0, 120.0, 500.0])


def means_amps(sensor) -> tuple[np.ndarray, np.ndarray]:
    """Per-band (means, amps) sized to a sensor spec.

    Landsat ARD gets the calibrated defaults; other band counts cycle the
    optical palette (plausible vegetation-reflectance scale), with thermal
    bands pinned to the thermal default so range checks behave."""
    B = sensor.n_bands
    if B == DEFAULT_MEANS.shape[0] and sensor.thermal_bands == (6,):
        return DEFAULT_MEANS.copy(), DEFAULT_AMPS.copy()
    means = np.resize(DEFAULT_MEANS[:6], B).astype(np.float64)
    amps = np.resize(DEFAULT_AMPS[:6], B).astype(np.float64)
    for b in sensor.thermal_bands:
        means[b], amps[b] = DEFAULT_MEANS[6], DEFAULT_AMPS[6]
    return means, amps


def acquisition_dates(start="1995-01-01", end="2015-01-01", cadence_days=16,
                      rng=None, drop_frac=0.0) -> np.ndarray:
    """Ordinal acquisition dates at a fixed cadence, optionally thinned."""
    t0, t1 = dt.to_ordinal(start), dt.to_ordinal(end)
    t = np.arange(t0, t1, cadence_days, dtype=np.int64)
    if rng is not None and drop_frac > 0:
        keep = rng.random(t.shape[0]) >= drop_frac
        t = t[keep]
    return t


def harmonic_series(t: np.ndarray, rng: np.random.Generator, *,
                    means: np.ndarray = DEFAULT_MEANS,
                    amps: np.ndarray = DEFAULT_AMPS,
                    slope_per_year: float = 0.0,
                    noise: float = 30.0) -> np.ndarray:
    """[B, T] spectra: mean + annual harmonic + trend + N(0, noise);
    B follows ``means`` (7-band Landsat defaults)."""
    means = np.asarray(means)
    ph = harmonic.day_phase(t)
    yr = (t - t[0]) / 365.25
    Y = (means[:, None]
         + np.asarray(amps)[:, None] * np.cos(ph)[None, :]
         + slope_per_year * yr[None, :]
         + rng.normal(0.0, noise, size=(means.shape[0], t.shape[0])))
    return Y


def with_step_change(Y: np.ndarray, t: np.ndarray, change_date: str,
                     delta: np.ndarray | float = 800.0) -> np.ndarray:
    """Add a step change to all bands at the given date."""
    c = dt.to_ordinal(change_date)
    out = Y.copy()
    after = t >= c
    delta = np.broadcast_to(np.asarray(delta, dtype=np.float64),
                            (Y.shape[0],))
    out[:, after] += delta[:, None]
    return out


def pixel(t: np.ndarray, Y: np.ndarray, qa: np.ndarray | None = None) -> dict:
    """Pack into the detect() keyword contract (ccdc/pyccd.py:161-168)."""
    if qa is None:
        qa = np.full(t.shape[0], QA_CLEAR, dtype=np.uint16)
    names = params.BAND_NAMES_PLURAL
    d = {n: np.clip(Y[i], -32768, 32767).astype(np.int16)
         for i, n in enumerate(names)}
    d["dates"] = t.astype(np.int64)
    d["qas"] = np.asarray(qa, dtype=np.uint16)
    return d


def chip(rng: np.random.Generator, n_pixels: int = 100, *,
         start="1995-01-01", end="2015-01-01", cadence_days=16,
         change_frac: float = 0.3) -> list[dict]:
    """A bag of pixels, a fraction of which contain one step change."""
    t = acquisition_dates(start, end, cadence_days)
    out = []
    for p in range(n_pixels):
        Y = harmonic_series(t, rng)
        if rng.random() < change_frac:
            mid = dt.to_iso(int(t[t.shape[0] // 2]))
            Y = with_step_change(Y, t, mid, delta=600 + 400 * rng.random())
        out.append(pixel(t, Y))
    return out

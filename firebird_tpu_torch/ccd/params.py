"""CCDC algorithm parameters.

One place for every constant of the change-detection spec.  Values are
pinned to the published CCDC algorithm (Zhu & Woodcock 2014, "Continuous
change detection and classification of land cover using all available
Landsat data", RSE 144) with the lcmap-pyccd 2018.03.12 parameterization the
reference pins (setup.py:32) where known.  The reference repo itself never
contains these numbers — they lived inside the external pyccd package — so
this module is the authoritative spec for the PyTorch detector.

It is a copy of the JAX package's ``ccd/params.py`` constants (the tests
hold the two equal name by name).  The JAX package's environment-knob
readers are not copied: the port takes the variogram mode as a keyword
argument (``kernel.detect_packed(variogram_mode=...)``, default
:data:`VARIOGRAM_DEFAULT`) and reads no environment.
"""

from __future__ import annotations

import numpy as np
from scipy import stats

# ---------------------------------------------------------------------------
# Bands.  Input order follows the reference timeseries contract
# (ccdc/timeseries.py:33-45): blues, greens, reds, nirs, swir1s, swir2s,
# thermals — indexes 0..6.
# ---------------------------------------------------------------------------
NUM_BANDS = 7
BAND_NAMES = ("blue", "green", "red", "nir", "swir1", "swir2", "thermal")
# Plural forms are the data-plane keyword names (ccdc/timeseries.py:33-45)
# and index the spectra axis everywhere.
BAND_NAMES_PLURAL = ("blues", "greens", "reds", "nirs", "swir1s", "swir2s",
                     "thermals")

# Bands used for change scoring (green, red, nir, swir1, swir2).
DETECTION_BANDS = (1, 2, 3, 4, 5)

# Bands used by the Tmask outlier screen (green, swir1).
TMASK_BANDS = (1, 4)

# Valid data ranges; observations outside are treated as unusable.
# Optical bands are scaled reflectance [0, 10000]; thermal is Kelvin*10.
OPTICAL_MIN, OPTICAL_MAX = 0, 10000
THERMAL_MIN, THERMAL_MAX = -9320, 7070
FILL_VALUE = -9999

# ---------------------------------------------------------------------------
# QA.  ARD pixel_qa is bit-packed (see the reference example series values
# 1 / 66 / 322, ccdc/timeseries.py:104-115: 1 = fill bit, 66/322 contain the
# clear bit).
# ---------------------------------------------------------------------------
QA_FILL_BIT = 0
QA_CLEAR_BIT = 1
QA_WATER_BIT = 2
QA_SHADOW_BIT = 3
QA_SNOW_BIT = 4
QA_CLOUD_BIT = 5

# Procedure selection thresholds (Zhu 2014 §3.2; pyccd procedures).
CLEAR_PCT_THRESHOLD = 0.25   # below: not enough clear obs for standard proc
SNOW_PCT_THRESHOLD = 0.75    # above (of snow/(snow+clear)): permanent snow

# ---------------------------------------------------------------------------
# Model structure.
# ---------------------------------------------------------------------------
# Harmonic design: [1, t, cos wt, sin wt, cos 2wt, sin 2wt, cos 3wt, sin 3wt]
# with w = 2*pi / 365.25 and t in ordinal days.
OMEGA = 2.0 * np.pi / 365.25
MAX_COEFS = 8
MIN_COEFS = 4
MID_COEFS = 6

# Coefficient count by observation density: >= 24 obs -> 8 coefs,
# >= 18 -> 6, else 4 (pyccd num-obs factor 3).
NUM_OBS_FACTOR = 3  # num_coefs*3 observations required per tier

# Minimum observations and time span to initialize a model (Zhu 2014 §3.1).
MEOW_SIZE = 12            # minimum observations in an initialization window
INIT_DAYS = 365.25        # minimum time span of the initialization window

# Stability: initial model is unstable if |slope * span| or the first/last
# absolute residual exceeds STABILITY_FACTOR * adjusted-RMSE (Zhu 2014 §3.1).
STABILITY_FACTOR = 3.0

# Number of consecutive exceeding observations that confirm a change.
PEEK_SIZE = 6

# Change score threshold: chi2 inverse CDF at 0.99 with one degree of
# freedom per detection band.
CHISQUARE_PROB = 0.99
CHANGE_THRESHOLD = float(stats.chi2.ppf(CHISQUARE_PROB, len(DETECTION_BANDS)))

# Single-observation outlier threshold (obs removed, not a change):
# the far chi2 tail, as pyccd's T_MAX_CG.
OUTLIER_PROB = 1 - 1e-6
OUTLIER_THRESHOLD = float(stats.chi2.ppf(OUTLIER_PROB, len(DETECTION_BANDS)))

# Refit schedule: refit the running model when the segment has grown to
# REFIT_FACTOR x the observation count at the previous fit (Zhu 2014 §3.3.1).
REFIT_FACTOR = 1.33

# ---------------------------------------------------------------------------
# Fitting.
# ---------------------------------------------------------------------------
# Lasso regularization (sklearn-style objective 1/(2n)||y-Xb||^2 + alpha|b|_1,
# intercept unpenalized).  Solved by cyclic coordinate descent with a fixed
# iteration count so the TPU kernel jits to a static loop.
LASSO_ALPHA = 1.0
LASSO_ITERS = 50

# Mixed-precision coef/rmse drift budget (FIREBIRD_MIXED_PRECISION):
# max scale-anchored ulp distance |mixed - f32| / (eps32 * scale)
# enforced by tools/precision_smoke.py and tests/test_precision.py,
# where ``scale`` anchors at the magnitude the error actually
# propagates from — max(|f32 value|, 1) for rmse, and the coefficient
# VECTOR's max(|coef|, 1) per (pixel, band, segment) for coefs (a
# lasso-thresholded near-zero coefficient absorbs absolute error
# proportional to its siblings' scale, so elementwise ulps there are
# meaningless).  The bf16 split-dot gram carries ~2^-17 relative error
# into the normal equations versus f32's ~2^-24; measured drift on the
# adversarial-fuzz chip is ~340 coef / ~670 rmse scaled ulps, while a
# naive bf16 weight cast (the bug this budget exists to catch) lands
# ~2^15.  Decisions (break day/QA/segment count/curve rank) must be
# IDENTICAL — the budget applies only to the continuous payload.
MIXED_ULP_BUDGET = 1 << 12

# Tmask robust screen: IRLS (Huber weights) harmonic fit without trend on
# TMASK_BANDS; an observation is an outlier if |residual| exceeds
# TMASK_CONST * max(variogram, rmse) in any Tmask band.
TMASK_COEFS = 5           # [1, cos wt, sin wt, cos 2wt, sin 2wt]
TMASK_CONST = 4.89

# Minimum date gap for a successive-difference pair to enter the ADJUSTED
# variogram (lcmap-pyccd's adjusted_variogram rule, reconstructed — the
# pinned package at reference setup.py:32 is unreachable offline; see
# docs/DIVERGENCE.md #1).  Near-coincident multi-sensor acquisitions
# (combined L7+L8 archives) otherwise crater the madogram denominator.
VARIOGRAM_GAP_DAYS = 30.0
TMASK_IRLS_ITERS = 5
HUBER_K = 1.345

# The variogram rule the detector runs unless told otherwise: "adjusted"
# (the reconstructed lcmap-pyccd adjusted_variogram, docs/DIVERGENCE.md #1)
# or "plain" (the plain madogram).
VARIOGRAM_DEFAULT = "adjusted"

# ---------------------------------------------------------------------------
# Curve QA flags (segment provenance), pyccd-style bit values.
# ---------------------------------------------------------------------------
CURVE_QA_INSUF_CLEAR = 1    # fit by the insufficient-clear procedure
CURVE_QA_PERSIST_SNOW = 2   # fit by the permanent-snow procedure
CURVE_QA_INSIDE = 4         # interior segment (bounded by breaks both sides)
CURVE_QA_START = 8          # first segment of the series
CURVE_QA_END = 16           # segment running to the end of the series

# Insufficient-clear procedure: keep non-fill obs whose blue value is below
# median(blue) + INSUF_CLEAR_BLUE_DELTA.
INSUF_CLEAR_BLUE_DELTA = 400.0

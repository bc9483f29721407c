"""Sensor specs: band layout + chip geometry the kernel is generic over.

The reference is hard-wired to Landsat ARD — 7 bands at 30 m, 100x100-pixel
chips (ccdc/timeseries.py:33-45, test/data/registry_response.json
``data_shape: [100, 100]``).  Here the spectral/spatial contract is a value
(:class:`Sensor`) threaded through the packer and the CCD kernel as a
static argument, so denser sensors compile to their own XLA program with
nothing Landsat-specific baked in.  BASELINE.json config #5 (Sentinel-2
10 m, 12-band stack, 10x pixel density) is the second instance.

The science parameters (params.py) stay shared: CCDC's thresholds are
defined per detection-band-count (chi2 dof = len(detection_bands)), which
the spec derives, not per sensor.
"""

from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class Sensor:
    """Immutable (hashable — usable as a jit static arg) sensor spec.

    Band indices index the spectra axis.  ``optical_bands`` are range-
    checked against params.OPTICAL_MIN/MAX, ``thermal_bands`` against
    THERMAL_MIN/MAX (empty for sensors with no thermal band).
    ``blue_band`` drives the insufficient-clear procedure's blue-median
    screen (params.INSUF_CLEAR_BLUE_DELTA).
    """

    name: str
    band_names: tuple[str, ...]
    detection_bands: tuple[int, ...]
    tmask_bands: tuple[int, ...]
    optical_bands: tuple[int, ...]
    thermal_bands: tuple[int, ...]
    blue_band: int
    chip_side: int
    pixel_size_m: int

    @property
    def n_bands(self) -> int:
        return len(self.band_names)

    @property
    def pixels(self) -> int:
        return self.chip_side * self.chip_side

    @property
    def band_names_plural(self) -> tuple[str, ...]:
        return tuple(f"{n}s" for n in self.band_names)


@functools.lru_cache(maxsize=None)
def chi2_thresholds(n_detection_bands: int) -> tuple[float, float]:
    """(change, outlier) score thresholds for a detection-band count —
    the chi2 inverse CDF the spec defines per dof (params.py)."""
    from scipy import stats

    from firebird_tpu_torch.ccd import params

    return (float(stats.chi2.ppf(params.CHISQUARE_PROB, n_detection_bands)),
            float(stats.chi2.ppf(params.OUTLIER_PROB, n_detection_bands)))


# Landsat ARD: the reference's contract (band order ccdc/timeseries.py:33-45).
LANDSAT_ARD = Sensor(
    name="landsat-ard",
    band_names=("blue", "green", "red", "nir", "swir1", "swir2", "thermal"),
    detection_bands=(1, 2, 3, 4, 5),      # green, red, nir, swir1, swir2
    tmask_bands=(1, 4),                   # green, swir1
    optical_bands=(0, 1, 2, 3, 4, 5),
    thermal_bands=(6,),
    blue_band=0,
    chip_side=100,
    pixel_size_m=30,
)

# Sentinel-2 L2A surface reflectance, 12-band stack resampled to 10 m: a
# 3 km chip is 300x300 px — 9x the pixel density of Landsat ARD
# (BASELINE.json config #5).  CCDC detection/Tmask band roles map by
# wavelength: green, red, nir, swir1, swir2; no thermal instrument.
SENTINEL2 = Sensor(
    name="sentinel2",
    band_names=("coastal", "blue", "green", "red", "re1", "re2", "re3",
                "nir", "nir08", "wv", "swir1", "swir2"),
    detection_bands=(2, 3, 7, 10, 11),
    tmask_bands=(2, 10),
    optical_bands=tuple(range(12)),
    thermal_bands=(),
    blue_band=1,
    chip_side=300,
    pixel_size_m=10,
)

# Landsat ARD band semantics on a 10x10 chip: the fleet-scale test
# geometry.  A full-CONUS plan is 726 tiles; at 100 px/chip the elastic
# soak (tools/elastic_soak.py) drains all 726 through real detection in
# smoke time while every queue/fencing/store code path stays the
# production one.  Only the synthetic source honors it
# (FIREBIRD_SYNTH_SENSOR) — real archives are fixed-geometry.
LANDSAT_ARD_TINY = dataclasses.replace(
    LANDSAT_ARD, name="landsat-ard-tiny", chip_side=10)

SENSORS = {s.name: s for s in (LANDSAT_ARD, SENTINEL2, LANDSAT_ARD_TINY)}

"""The synthetic chip source: a copy of the JAX package's
``ingest/sources.py::SyntheticSource`` and ``_slice_acquired``.

Deterministic per (seed, cx, cy), so the two packages see the same chips
from the same arguments.
"""

from __future__ import annotations

import numpy as np

from firebird_tpu_torch.ccd import harmonic, synthetic
from firebird_tpu_torch.ingest.packer import ChipData
from firebird_tpu_torch.utils import dates as dt


def _slice_acquired(t, spectra, qas, acquired):
    """Restrict a chip archive to an ISO8601 acquired range.

    The window is HALF-OPEN: ``[start, end)`` — an observation dated
    exactly ``end`` belongs to the next window, never to both or neither."""
    if not acquired:
        return t, spectra, qas
    lo, hi = dt.acquired_range(acquired)
    keep = (t >= lo) & (t < hi)
    return t[keep], spectra[:, keep], qas[keep]


class SyntheticSource:
    """Deterministic synthetic ARD per chip id.

    Each chip gets a harmonic landscape with per-pixel level offsets; a
    rectangular patch of ``change_frac`` of the area undergoes a step change
    at a chip-specific date.  QA marks a fraction of acquisitions cloudy.
    Fully determined by (seed, cx, cy).
    """

    def __init__(self, seed: int = 0, *, start="1995-01-01", end="2005-01-01",
                 cadence_days: int = 16, change_frac: float = 0.25,
                 cloud_frac: float = 0.15, sensor=None, n_changes: int = 1,
                 seasonal_gap_frac: float = 0.0):
        from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD

        self.seed = seed
        self.start, self.end = start, end
        self.cadence_days = cadence_days
        self.change_frac = change_frac
        self.cloud_frac = cloud_frac
        self.sensor = sensor or LANDSAT_ARD
        # Several well-separated step changes per affected patch, and
        # winter acquisitions dropped with the given probability (seasonal
        # gaps — the case the adjusted variogram exists for).
        self.n_changes = n_changes
        self.seasonal_gap_frac = seasonal_gap_frac

    def _rng(self, cx: int, cy: int, salt: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            abs(hash((int(self.seed), int(cx), int(cy), salt))) % (2**63))

    def chip(self, cx: int, cy: int, acquired: str | None = None) -> ChipData:
        # Generate the full archive first, slice at the end: the same chip
        # queried with different acquired windows agrees on overlapping
        # dates.
        rng = self._rng(cx, cy)
        sn = self.sensor
        B, csd = sn.n_bands, sn.chip_side
        t = synthetic.acquisition_dates(self.start, self.end, self.cadence_days)
        T = t.shape[0]
        ph = harmonic.day_phase(t).astype(np.float32)

        means, amps = synthetic.means_amps(sn)
        means = means.astype(np.float32)
        amps = amps.astype(np.float32)
        # Per-pixel level field (spatially smooth-ish random offsets).
        level = rng.normal(0, 60, size=(csd, csd)).astype(np.float32)

        spectra = np.empty((B, T, csd, csd), np.int16)
        noise_scale = 30.0
        for b in range(B):
            base = (means[b] + amps[b] * np.cos(ph))[:, None, None]
            series = base + level[None, :, :] + rng.normal(
                0, noise_scale, size=(T, csd, csd)).astype(np.float32)
            spectra[b] = np.clip(series, -32768, 32767).astype(np.int16)

        # Step changes in a patch, at chip-specific dates; n_changes > 1
        # spaces them evenly through the middle of the archive.
        if self.change_frac > 0:
            side = max(1, int(csd * np.sqrt(self.change_frac)))
            r0 = int(rng.integers(0, csd - side + 1))
            c0 = int(rng.integers(0, csd - side + 1))
            nch = max(1, int(self.n_changes))
            lo, hi = T // 6, 5 * T // 6
            ks = (lo + (np.arange(nch) + rng.uniform(0.2, 0.8, nch))
                  * (hi - lo) / nch).astype(int) if nch > 1 \
                else np.array([int(rng.integers(T // 4, 3 * T // 4))])
            cum = np.zeros(B)
            for k in ks:
                delta = rng.uniform(500, 1000)
                # A negative step only where the band's seasonal low plus
                # the offset of earlier changes still clears the range
                # floor, or every post-change observation would be dropped.
                sign = np.where(rng.random(B) < 0.5, -1.0, 1.0)
                seasonal_low = means - amps
                sign = np.where(seasonal_low + cum < delta + 300, 1.0, sign)
                for b in range(B):
                    spectra[b, k:, r0:r0 + side, c0:c0 + side] = np.clip(
                        spectra[b, k:, r0:r0 + side, c0:c0 + side]
                        + np.int16(sign[b] * delta), -32768, 32767)
                cum += sign * delta

        qas = np.full((T, csd, csd), synthetic.QA_CLEAR, np.uint16)
        cloudy = rng.random(T) < self.cloud_frac
        if self.seasonal_gap_frac > 0:
            doy = np.mod(t.astype(np.float64), 365.25)
            winter = (doy < 75) | (doy > 320)
            cloudy = cloudy | (winter
                               & (rng.random(T) < self.seasonal_gap_frac))
        qas[cloudy] = synthetic.QA_CLOUD

        t, spectra, qas = _slice_acquired(t, spectra, qas, acquired)
        return ChipData(cx=int(cx), cy=int(cy), dates=t, spectra=spectra,
                        qas=qas, sensor=sn)

"""Dense packing of chip time series for device dispatch.

A copy of the JAX package's ``ingest/packer.py`` (numpy only).  The unit of
I/O is the chip: 100x100 pixels x 7 spectral bands + QA over T
acquisitions.  A :class:`ChipData` holds one chip's aligned arrays;
:func:`pack` batches several into a :class:`PackedChips` with the time axis
padded to a bucket size, so the detector sees few distinct shapes.

Padding convention: padded observations carry QA = fill (bit 0 set) and
spectra = FILL_VALUE, so the detector's QA triage drops them with no
special cases.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from firebird_tpu_torch.ccd import params
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, Sensor

CHIP_SIDE = 100          # pixels per chip side (registry data_shape [100,100])
PIXELS = CHIP_SIDE * CHIP_SIDE
PIXEL_SIZE_M = 30        # Landsat ARD pixel, meters

QA_FILL_PACKED = np.uint16(1 << params.QA_FILL_BIT)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ChipData:
    """One chip's date-aligned time series.

    dates:   [T] ordinal days, ascending.
    spectra: [B, T, side, side] int16 (sensor band order; Landsat ARD:
             blue..thermal, [7, T, 100, 100]).
    qas:     [T, side, side] uint16 bit-packed QA.
    sensor:  the band/geometry spec (default: Landsat ARD).
    """

    cx: int
    cy: int
    dates: np.ndarray
    spectra: np.ndarray
    qas: np.ndarray
    sensor: Sensor = LANDSAT_ARD

    def __post_init__(self):
        T = self.dates.shape[0]
        side = self.sensor.chip_side
        if self.spectra.shape != (self.sensor.n_bands, T, side, side):
            raise ValueError(f"spectra shape {self.spectra.shape} does not "
                             f"fit sensor {self.sensor.name}")
        if self.qas.shape != (T, side, side):
            raise ValueError(f"qas shape {self.qas.shape} != {(T, side, side)}")
        if T >= 2 and not bool(np.all(np.diff(self.dates) >= 0)):
            raise ValueError("dates must ascend")


@dataclasses.dataclass
class PackedChips:
    """A device-ready batch of chips.

    cids:    [C, 2] int64 chip ids (cx, cy).
    dates:   [C, T] int32, ascending within the valid prefix, 0-padded.
    spectra: [C, B, P, T] int16, FILL_VALUE-padded.
    qas:     [C, P, T] uint16, fill-bit padded.
    n_obs:   [C] int32 valid observation count per chip.
    sensor:  the shared band/geometry spec of every chip in the batch.

    P = side*side pixels in row-major order: pixel index p = row*side + col
    where (row, col) counts from the chip's upper-left, so the pixel's
    projection coordinate is (px, py) = (cx + col*psz, cy - row*psz).
    """

    cids: np.ndarray
    dates: np.ndarray
    spectra: np.ndarray
    qas: np.ndarray
    n_obs: np.ndarray
    sensor: Sensor = LANDSAT_ARD

    @property
    def n_chips(self) -> int:
        return self.cids.shape[0]

    @property
    def capacity(self) -> int:
        return self.dates.shape[1]

    def pixel_coords(self, c: int) -> np.ndarray:
        """[P, 2] (px, py) projection coordinates of chip c's pixels."""
        cx, cy = self.cids[c]
        side, psz = self.sensor.chip_side, self.sensor.pixel_size_m
        cols = np.arange(side) * psz
        rows = np.arange(side) * psz
        px = cx + np.tile(cols, side)
        py = cy - np.repeat(rows, side)
        return np.stack([px, py], axis=1).astype(np.int64)


def bucket_capacity(T: int, bucket: int, max_obs: int) -> int:
    """Round T up to a bucket multiple, capped at max_obs."""
    cap = ((max(T, 1) + bucket - 1) // bucket) * bucket
    return min(cap, max_obs) if max_obs else cap


def pack(chips: list[ChipData], *, bucket: int = 64,
         max_obs: int = 0) -> PackedChips:
    """Pack chips into one padded batch.

    If a chip has more observations than max_obs (when nonzero), the oldest
    are kept and the newest truncated, with a warning: truncation loses
    data, so max_obs should be sized to the archive.
    """
    if not chips:
        raise ValueError("cannot pack zero chips")
    sensor = chips[0].sensor
    if not all(c.sensor == sensor for c in chips):
        raise ValueError("all chips in a batch must share one sensor spec")
    B, npix = sensor.n_bands, sensor.pixels
    T_max = max(c.dates.shape[0] for c in chips)
    cap = bucket_capacity(T_max, bucket, max_obs)
    if T_max > cap:
        log.warning(
            "archive exceeds the packed capacity: a chip has %d "
            "acquisitions but max_obs caps the time axis at %d — the "
            "newest %d are DROPPED", T_max, cap, T_max - cap)

    C = len(chips)
    cids = np.zeros((C, 2), np.int64)
    dates = np.zeros((C, cap), np.int32)
    spectra = np.empty((C, B, npix, cap), np.int16)
    qas = np.empty((C, npix, cap), np.uint16)
    n_obs = np.zeros(C, np.int32)

    for i, c in enumerate(chips):
        T = min(c.dates.shape[0], cap)
        cids[i] = (c.cx, c.cy)
        dates[i, :T] = c.dates[:T]
        spectra[i, :, :, :T] = c.spectra[:, :T].reshape(B, T, npix) \
            .transpose(0, 2, 1)
        spectra[i, :, :, T:] = params.FILL_VALUE
        qas[i, :, :T] = c.qas[:T].reshape(T, npix).T
        qas[i, :, T:] = QA_FILL_PACKED
        n_obs[i] = T
    return PackedChips(cids=cids, dates=dates, spectra=spectra, qas=qas,
                       n_obs=n_obs, sensor=sensor)


def pixel_timeseries(p: PackedChips, c: int, pix: int) -> dict:
    """One pixel of a packed batch as :func:`ccd.reference.detect`'s
    keyword arguments (dates, one array per band, qas)."""
    T = int(p.n_obs[c])
    d = {n: p.spectra[c, b, pix, :T].copy()
         for b, n in enumerate(p.sensor.band_names_plural)}
    d["dates"] = p.dates[c, :T].astype(np.int64)
    d["qas"] = p.qas[c, pix, :T].copy()
    return d

"""Chip sources: the port's own copy of the JAX package's
``ingest/sources.py``.

- :class:`SyntheticSource` — deterministic per (seed, cx, cy), so the two
  packages see the same chips from the same arguments;
- :class:`FileSource` — .npz chip archives in a directory;
- :class:`ChipmunkSource` — the Chipmunk raster service over HTTP, with an
  injectable ``http_get`` (the tests replay recorded responses).
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
import urllib.request

import numpy as np

from firebird_tpu_torch import native
from firebird_tpu_torch.ccd import harmonic, params, synthetic
from firebird_tpu_torch.ingest.packer import CHIP_SIDE, ChipData
from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.utils import dates as dt

log = logger("timeseries")

AUX_NAMES = ("dem", "trends", "aspect", "posidex", "slope", "mpw")


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
    """Deterministic synthetic ARD and AUX per chip id.

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

    def list_acquisitions(self, since: float = 0.0) -> list[dict]:
        """The acquisition manifest (streamops/watcher.py contract):
        ``[{scene_id, published, date, bbox}, ...]`` with ``published >
        since``.  One deterministic scene per cadence date covering the
        whole grid (bbox None); ``published`` is the fabricated
        timestamp ``ordinal * 86400`` — monotone in acquisition date,
        so cursor tests are reproducible (the FileSource manifest
        carries real wall-clock publish times)."""
        t = synthetic.acquisition_dates(self.start, self.end,
                                        self.cadence_days)
        out = []
        for d in t:
            published = float(d) * 86400.0
            if published <= since:
                continue
            iso = dt.to_iso(int(d))
            out.append({"scene_id": f"synthetic-{self.seed}-{iso}",
                        "published": published, "date": iso,
                        "bbox": None})
        return out

    def aux(self, cx: int, cy: int, acquired: str | None = None) -> dict:
        """AUX layers: one [100,100] array per AUX_NAMES entry, drawn from
        the chip's own generator (salt 1) in the JAX package's order."""
        rng = self._rng(cx, cy, salt=1)
        row = np.arange(CHIP_SIDE, dtype=np.float32)
        grad = row[None, :] + row[:, None]
        side = (CHIP_SIDE, CHIP_SIDE)
        return {
            "dem": (300 + 5 * grad + rng.normal(0, 20, side)).astype(np.float32),
            "aspect": rng.integers(0, 360, side).astype(np.int16),
            "posidex": rng.random(side).astype(np.float32),
            "slope": np.abs(rng.normal(5, 3, side)).astype(np.float32),
            "mpw": (rng.random(side) < 0.1).astype(np.uint8),
            # Land-cover training labels in blobs; 0 and 9 are the values
            # the reference filters out of training (randomforest.py:63).
            "trends": (1 + (grad // 50) % 8).astype(np.uint8),
        }


# ---------------------------------------------------------------------------
# File-backed fixture source
# ---------------------------------------------------------------------------

class FileSource:
    """Chips stored as .npz files in a directory: chip_{cx}_{cy}.npz with
    arrays dates/spectra/qas, aux_{cx}_{cy}.npz with the AUX names (the
    layout ``driver.fetch.fetch`` mirrors a tile into).

    The directory doubles as a landing zone for the acquisition watcher: a
    ``scenes.jsonl`` manifest next to the chips records each delivered
    scene (one JSON line: scene_id, published, date, bbox), appended by
    :meth:`append_scene` after the chip archives are updated — so a
    watcher listing the manifest never sees a scene whose pixels have not
    landed yet.

    A chip archive is an uncompressed npz (the JAX package's
    ``np.savez_compressed`` deflates it): the same format, read by either
    package's ``np.load``.  A landing zone rewrites a chip's whole archive
    for every scene, and the stream reads it back for every update;
    deflate made each of those cost seconds a full chip, for an archive
    about two thirds the size."""

    SCENES_FILE = "scenes.jsonl"

    def __init__(self, root: str):
        self.root = root

    def _path(self, prefix: str, cx: int, cy: int) -> str:
        return f"{self.root}/{prefix}_{int(cx)}_{int(cy)}.npz"

    def chip(self, cx: int, cy: int, acquired: str | None = None) -> ChipData:
        z = np.load(self._path("chip", cx, cy))
        t, spectra, qas = _slice_acquired(z["dates"], z["spectra"], z["qas"],
                                          acquired)
        return ChipData(cx=int(cx), cy=int(cy), dates=t, spectra=spectra, qas=qas)

    def aux(self, cx: int, cy: int, acquired: str | None = None) -> dict:
        z = np.load(self._path("aux", cx, cy))
        return {k: z[k] for k in AUX_NAMES}

    def save_chip(self, c: ChipData) -> None:
        """Atomic archive write (tmp + rename): a reader fetching the
        chip mid-landing sees the previous archive, never a torn one."""
        path = self._path("chip", c.cx, c.cy)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            np.savez(f, dates=c.dates, spectra=c.spectra, qas=c.qas)
        os.replace(tmp, path)

    def save_aux(self, cx: int, cy: int, aux: dict) -> None:
        np.savez_compressed(self._path("aux", cx, cy), **aux)

    def append_scene(self, scene_id: str, *, date: str,
                     published: float | None = None, bbox=None) -> dict:
        """Publish one scene on the manifest (AFTER its chip archives
        landed — see class docstring).  Returns the manifest record."""
        rec = {"scene_id": str(scene_id),
               "published": float(published if published is not None
                                  else time.time()),
               "date": str(date),
               "bbox": None if bbox is None else [float(v) for v in bbox]}
        with open(os.path.join(self.root, self.SCENES_FILE), "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec

    def list_acquisitions(self, since: float = 0.0) -> list[dict]:
        """The acquisition manifest (streamops/watcher.py contract):
        scenes with ``published > since`` from ``scenes.jsonl``.  A
        truncated trailing line (a writer mid-append) is skipped — it
        re-lists complete on the next poll."""
        path = os.path.join(self.root, self.SCENES_FILE)
        out = []
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            return out
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue            # torn tail append; next poll has it
            if float(rec.get("published", 0.0)) > since:
                out.append(rec)
        return out


# ---------------------------------------------------------------------------
# Chipmunk HTTP source
# ---------------------------------------------------------------------------

class UnsupportedWireError(ValueError):
    """A service registry declares band dtypes the packed kernel wire format
    (int16 spectra / uint16 QA) cannot carry.  Deliberately NOT swallowed by
    the registry='auto' fallback: falling back to the built-in Collection-01
    tables against such a service would just query ubids it doesn't serve."""

# LCMAP ARD Collection-01 ubid layout: logical band -> ubids across
# platforms (merlin's chipmunk-ard profile; ubid example 'le07_srb1' in
# test/data/chip_response.json).
ARD_UBIDS = {
    "blues":    ("lt04_srb1", "lt05_srb1", "le07_srb1", "lc08_srb2"),
    "greens":   ("lt04_srb2", "lt05_srb2", "le07_srb2", "lc08_srb3"),
    "reds":     ("lt04_srb3", "lt05_srb3", "le07_srb3", "lc08_srb4"),
    "nirs":     ("lt04_srb4", "lt05_srb4", "le07_srb4", "lc08_srb5"),
    "swir1s":   ("lt04_srb5", "lt05_srb5", "le07_srb5", "lc08_srb6"),
    "swir2s":   ("lt04_srb7", "lt05_srb7", "le07_srb7", "lc08_srb7"),
    "thermals": ("lt04_btb6", "lt05_btb6", "le07_btb6", "lc08_btb10"),
    "qas":      ("lt04_pixelqa", "lt05_pixelqa", "le07_pixelqa", "lc08_pixelqa"),
}
BAND_ORDER = params.BAND_NAMES_PLURAL

AUX_UBIDS = {
    "dem": ("AUX_DEM",), "trends": ("AUX_TRENDS",), "aspect": ("AUX_ASPECT",),
    "posidex": ("AUX_POSIDEX",), "slope": ("AUX_SLOPE",), "mpw": ("AUX_MPW",),
}

# Fallback wire dtypes when no /registry is reachable (values transcribed
# from the reference's recorded registry, test/data/registry_response.json:
# SR/BT INT16, PIXELQA UINT16, ASPECT INT16, DEM/POSIDEX/SLOPE FLOAT32,
# MPW/TRENDS BYTE).
_FALLBACK_AUX_WIRE = {"dem": np.float32, "trends": np.uint8,
                      "aspect": np.int16, "posidex": np.float32,
                      "slope": np.float32, "mpw": np.uint8}


def _fallback_wire_dtypes() -> dict[str, np.dtype]:
    out = {}
    for name in BAND_ORDER:
        for u in ARD_UBIDS[name]:
            out[u] = np.dtype(np.int16)
    for u in ARD_UBIDS["qas"]:
        out[u] = np.dtype(np.uint16)
    for name, ubids in AUX_UBIDS.items():
        for u in ubids:
            out[u] = np.dtype(_FALLBACK_AUX_WIRE[name])
    return out


def decode_raster(rec: dict, dtype=np.int16, side: int = CHIP_SIDE) -> np.ndarray:
    """Decode one chip record's base64 payload to a [side,side] array.

    The payload is little-endian (int16 spectra, uint16 QA, float32/byte
    AUX), the wire format of the recorded Chipmunk responses.  The decode
    runs in the native data plane, straight into the result buffer, and is
    strict: whitespace is skipped, any other character outside the
    alphabet raises ValueError (``native.b64_decode_into``).
    """
    data = rec["data"]
    wire = np.dtype(dtype).newbyteorder("<")
    out = np.empty(len(data) * 3 // 4 // wire.itemsize + 1, wire)
    n = native.b64_decode_into(data, out)
    if n % wire.itemsize:
        raise ValueError(
            f"chip payload of {n} bytes is not a multiple of the "
            f"{wire.itemsize}-byte wire dtype — truncated or corrupt")
    a = out[:n // wire.itemsize]
    if wire != np.dtype(dtype):  # big-endian host: swap to native order
        a = a.astype(dtype)
    return a.reshape(side, side)


DEFAULT_HTTP_TIMEOUT = 60.0


def _default_http_get(url: str, timeout: float = DEFAULT_HTTP_TIMEOUT) \
        -> list | dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read().decode())


class ChipmunkSource:
    """HTTP client for the Chipmunk raster service.

    ``http_get`` is injectable (url -> parsed JSON) so tests run without a
    network, mirroring the reference's function-injection seam; it is
    called from ``band_parallelism`` threads concurrently and MUST be
    thread-safe.  ``band_parallelism`` fans the 8 logical bands of one
    chip out over a thread pool — a chip is 32 HTTP requests (8 bands x 4
    platform ubids), and fetching them serially leaves the request latency
    unamortized (the reference's INPUT_PARTITIONS only parallelizes across
    chips); total in-flight requests = input_parallelism x
    band_parallelism (Config.band_parallelism; 1 restores the strict
    INPUT_PARTITIONS ceiling).

    ``timeout`` bounds each HTTP request of the default client
    (``FIREBIRD_HTTP_TIMEOUT`` via Config.http_timeout — previously a
    hardcoded 60 s).

    ``registry='auto'`` (default) fetches ``/registry`` once, lazily, and
    derives the ubid maps, wire dtypes, and chip side from it (merlin's
    registry_fn role, SURVEY.md §2.2); on failure it falls back to the
    built-in Collection-01 tables with a warning.  Pass a
    :class:`~firebird_tpu_torch.ingest.registry.Registry` to pin one, or ``None``
    to force the built-in tables.
    """

    def __init__(self, url: str, http_get=None, band_parallelism: int = 8,
                 registry="auto", timeout: float = DEFAULT_HTTP_TIMEOUT):
        import threading

        if timeout <= 0:
            raise ValueError(f"http timeout must be > 0 s, got {timeout}")
        self.url = url.rstrip("/")
        self.timeout = float(timeout)
        # The timeout binds only when the default urllib client is in
        # play; an injected http_get owns its own transport policy.
        self.http_get = http_get or (
            lambda u: _default_http_get(u, timeout=self.timeout))
        self.band_parallelism = max(int(band_parallelism), 1)
        self._registry = registry
        self._resolved = None
        self._resolve_lock = threading.Lock()
        # Case-resolution memo (see _band_series): ubid -> casing the
        # service actually answers; _prefer_lower flips after the first
        # successful lowercase retry so later ubids query lowercase first.
        # GIL-atomic dict/flag writes; worst case under a race is one
        # redundant HTTP request.
        self._ubid_case: dict[str, str] = {}
        self._prefer_lower = False

    @staticmethod
    def _derive(reg):
        """(ard_ubids, aux_ubids, {ubid: wire dtype}, sensor) from a
        Registry.  A split deployment serves ARD and AUX from different
        services (Config.ard_url / aux_url), so a registry listing only one
        half is valid: the missing half keeps the built-in tables."""
        import dataclasses

        from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD

        try:
            ard = reg.ard_ubids()
        except LookupError as e:
            log.warning("registry ARD half unusable (%s); keeping the "
                        "built-in Collection-01 ARD tables", e)
            ard = None
        try:
            aux = reg.aux_ubids()
        except LookupError as e:
            log.warning("registry AUX half unusable (%s); keeping the "
                        "built-in Collection-01 AUX tables", e)
            aux = None
        if ard is None and aux is None:
            raise LookupError("registry has neither ARD nor AUX bands")
        used = [u for ubids in (*(ard or {}).values(), *(aux or {}).values())
                for u in ubids]
        dtypes = {u: reg.wire_dtype(u) for u in used}
        if ard is not None:
            # The packed kernel wire format is int16 spectra / uint16 QA
            # (PackedChips contract); a registry declaring float spectra
            # must fail loudly, not truncate on assignment.
            for band, ubids in ard.items():
                want = np.uint16 if band == "qas" else np.int16
                bad = [u for u in ubids if dtypes[u] != want]
                if bad:
                    raise UnsupportedWireError(
                        f"registry band {band!r} ubids {bad} declare wire "
                        f"dtypes {[str(dtypes[u]) for u in bad]}; the packed "
                        f"kernel wire format requires {np.dtype(want).name}")
        side = reg.chip_side(used)
        if (ard is None or aux is None) and side != CHIP_SIDE:
            # The built-in tables describe the fixed 100x100 Collection-01
            # service; mixing them with a different registry geometry would
            # decode the fallback half at the wrong shape.
            raise LookupError(
                f"partial registry declares chip side {side}, but the "
                f"built-in tables covering its missing half are "
                f"{CHIP_SIDE}x{CHIP_SIDE}")
        fallback = _fallback_wire_dtypes()
        if ard is None:
            ard = ARD_UBIDS
            dtypes.update((u, fallback[u])
                          for us in ARD_UBIDS.values() for u in us)
        if aux is None:
            aux = AUX_UBIDS
            dtypes.update((u, fallback[u])
                          for us in AUX_UBIDS.values() for u in us)
        sensor = LANDSAT_ARD
        if side != sensor.chip_side:
            # Chip extent is the grid's 3 km; a denser registry shape
            # means finer pixels (e.g. side 300 -> 10 m).
            sensor = dataclasses.replace(
                sensor, name=f"{sensor.name}-{side}", chip_side=side,
                pixel_size_m=max(1, (sensor.chip_side *
                                     sensor.pixel_size_m) // side))
        log.info("chipmunk registry: %d ubids across %d logical bands, "
                 "chip side %d", len(used), len(ard) + len(aux), side)
        return ard, aux, dtypes, sensor

    def _resolve(self):
        """(ard_ubids, aux_ubids, {ubid: wire dtype}, sensor) — from the
        service registry when reachable, built-in Collection-01 tables
        otherwise.  A pinned Registry propagates derivation errors; 'auto'
        falls back with a warning.  Locked: the driver calls chip() from
        input_parallelism threads, and every chip in a run must see one
        sensor spec (packer requires a single spec per batch)."""
        with self._resolve_lock:
            if self._resolved is None:
                from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD
                from firebird_tpu_torch.ingest.registry import Registry

                reg = self._registry
                if isinstance(reg, str) and reg == "auto":
                    try:
                        self._resolved = self._derive(
                            Registry.fetch(self.http_get, self.url))
                    except UnsupportedWireError:
                        raise
                    except Exception as e:
                        log.warning(
                            "chipmunk /registry unusable at %s (%s); using "
                            "built-in Collection-01 ubid tables", self.url, e)
                        reg = None
                if self._resolved is None:
                    if reg is None:
                        self._resolved = (ARD_UBIDS, AUX_UBIDS,
                                          _fallback_wire_dtypes(), LANDSAT_ARD)
                    else:
                        self._resolved = self._derive(reg)
            return self._resolved

    def _chips(self, ubid: str, x: int, y: int, acquired: str) -> list:
        q = urllib.parse.urlencode(
            {"ubid": ubid, "x": x, "y": y, "acquired": acquired})
        with obs_metrics.timer() as tm:
            recs = self.http_get(f"{self.url}/chips?{q}") or []
        obs_metrics.histogram("ingest_http_seconds").observe(tm.elapsed)
        obs_metrics.counter("ingest_http_requests").inc()
        # Decoded payload size (base64 is 4/3 of the raster bytes) — the
        # only honest bytes-in figure available above the socket layer,
        # since http_get returns parsed JSON.
        obs_metrics.counter("ingest_bytes_in").inc(
            sum(len(r.get("data", "")) for r in recs
                if isinstance(r, dict)) * 3 // 4)
        return recs

    def _band_series(self, ubids, cx, cy, acquired, dtypes,
                     side) -> dict[int, np.ndarray]:
        """{ordinal_date: raster} merged across a logical band's ubids.

        The recorded service contract disagrees on ubid case (/registry
        serves 'LE07_SRB1', the working /chips capture uses 'le07_srb1' —
        reference test/data/{registry,chip}_response.json), so an empty
        result for a mixed-case ubid is retried lowercased before being
        treated as genuinely absent; the resolved casing is memoized per
        ubid (and as a source-wide preference) so absent-platform chips
        don't pay the double request on every query.
        """
        series: dict[int, np.ndarray] = {}
        for ubid in ubids:
            first = self._ubid_case.get(
                ubid, ubid.lower() if self._prefer_lower else ubid)
            recs = self._chips(first, cx, cy, acquired)
            if recs:
                self._ubid_case.setdefault(ubid, first)
            elif first != ubid.lower():
                recs = self._chips(ubid.lower(), cx, cy, acquired)
                if recs:
                    self._ubid_case[ubid] = ubid.lower()
                    self._prefer_lower = True
            for rec in recs:
                d = dt.to_ordinal(rec["acquired"][:10])
                if d not in series:  # first writer wins; skip wasted decodes
                    series[d] = decode_raster(rec, dtypes[ubid], side)
        return series

    def chip(self, cx: int, cy: int, acquired: str | None = None) -> ChipData:
        import concurrent.futures as cf

        acquired = acquired or dt.default_acquired()
        ard, _aux, dtypes, sensor = self._resolve()
        side = sensor.chip_side
        bands = sensor.band_names_plural
        names = list(bands) + ["qas"]
        with cf.ThreadPoolExecutor(self.band_parallelism) as ex:
            series = dict(zip(names, ex.map(
                lambda n: self._band_series(ard[n], cx, cy, acquired,
                                            dtypes, side), names)))
        per_band = {n: series[n] for n in bands}
        qa_series = series["qas"]
        # Date alignment: keep acquisitions present in every band + QA
        # (merlin's alignment step, SURVEY.md §3.3).
        common = set(qa_series)
        for s in per_band.values():
            common &= set(s)
        t = np.array(sorted(common), dtype=np.int64)
        # The service's own acquired filter is inclusive; re-apply the
        # half-open [start, end) window here so every source agrees on
        # boundary ownership (_slice_acquired docstring).
        lo, hi = dt.acquired_range(acquired)
        t = t[(t >= lo) & (t < hi)]
        T = t.shape[0]
        spectra = np.empty((sensor.n_bands, T, side, side), np.int16)
        for b, name in enumerate(bands):
            for k, d in enumerate(t):
                spectra[b, k] = per_band[name][int(d)]
        qas = np.stack([qa_series[int(d)] for d in t]) if T else \
            np.zeros((0, side, side), np.uint16)
        log.debug("chipmunk chip (%s,%s): %d aligned acquisitions", cx, cy, T)
        return ChipData(cx=int(cx), cy=int(cy), dates=t, spectra=spectra,
                        qas=qas, sensor=sensor)

    def aux(self, cx: int, cy: int, acquired: str | None = None) -> dict:
        acquired = acquired or dt.default_acquired()
        _ard, auxm, dtypes, sensor = self._resolve()
        side = sensor.chip_side
        out = {}
        for name, ubids in auxm.items():
            series = self._band_series(ubids, cx, cy, acquired, dtypes, side)
            if not series:
                raise LookupError(f"no AUX {name} at ({cx},{cy})")
            out[name] = series[min(series)]
        return out

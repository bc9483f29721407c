"""Chipmunk ``/registry``-driven band discovery.

The reference resolves band ubids and chip geometry from the Chipmunk
``/registry`` endpoint through merlin's ``registry_fn`` (profile wiring at
ccdc/__init__.py:25-26; the recorded service contract is
test/data/registry_response.json — 97 entries of
``{ubid, data_type, data_shape, tags, ...}``).  Beside the built-in
Collection-01 ubid maps (:data:`sources.ARD_UBIDS` / :data:`sources.AUX_UBIDS`),
this module derives them from the service so a Collection-2 or new-sensor
deployment is configuration, not code edits.

Selection rules, golden-tested against the reference's recorded registry
(tests/test_registry.py):

- spectral band -> entries tagged ``{'sr', <color>}`` for color in
  blue / green / red / nir / swir1 / swir2
- QA            -> entries tagged ``{'pixelqa'}``
- thermal       -> entries tagged ``{'bt'}``; when one platform exposes
  several brightness-temperature bands (LC08 BTB10 + BTB11) the
  lowest-numbered wins — reproducing merlin's chipmunk-ard choice of
  ``lc08_btb10``
- AUX layer     -> entries tagged with the layer name (``dem``, ``trends``,
  ``aspect``, ``posidex``, ``slope``, ``mpw``)

Platforms are grouped by the ubid prefix before ``_`` (``lc08``, ``le07``,
``lt05``, ``lt04``) so each platform contributes at most one ubid per
logical band.
"""

from __future__ import annotations

import re

import numpy as np

from firebird_tpu_torch.obs import logger

log = logger("timeseries")

#: Chipmunk data_type strings -> numpy wire dtypes (registry fixture uses
#: INT16 / UINT16 / UINT8 / BYTE / FLOAT32).
DATA_TYPES = {
    "INT8": np.int8, "UINT8": np.uint8, "BYTE": np.uint8,
    "INT16": np.int16, "UINT16": np.uint16,
    "INT32": np.int32, "UINT32": np.uint32,
    "FLOAT32": np.float32, "FLOAT64": np.float64,
}

#: Logical ARD band -> tag query (every tag must be present).
ARD_TAG_RULES = {
    "blues": ("sr", "blue"),
    "greens": ("sr", "green"),
    "reds": ("sr", "red"),
    "nirs": ("sr", "nir"),
    "swir1s": ("sr", "swir1"),
    "swir2s": ("sr", "swir2"),
    "thermals": ("bt",),
    "qas": ("pixelqa",),
}

AUX_TAG_RULES = {
    "dem": ("dem",), "trends": ("trends",), "aspect": ("aspect",),
    "posidex": ("posidex",), "slope": ("slope",), "mpw": ("mpw",),
}


def _natural_key(s: str):
    """Case-insensitive natural sort key: 'BTB10' after 'BTB6'."""
    return [int(p) if p.isdigit() else p
            for p in re.split(r"(\d+)", s.lower())]


class Registry:
    """Parsed ``/registry`` response with band/dtype/geometry lookups."""

    def __init__(self, entries: list[dict]):
        self.entries = list(entries)
        self._by_ubid = {e["ubid"]: e for e in self.entries}

    @classmethod
    def fetch(cls, http_get, url: str) -> "Registry":
        """GET ``{url}/registry`` with an injectable url->JSON callable."""
        entries = http_get(url.rstrip("/") + "/registry") or []
        if not entries:
            raise LookupError(f"empty /registry at {url}")
        return cls(entries)

    @property
    def ubids(self) -> tuple[str, ...]:
        return tuple(self._by_ubid)

    def select(self, *tags: str) -> tuple[str, ...]:
        """ubids whose tag set contains every query tag (case-insensitive),
        natural-sorted for determinism."""
        want = {t.lower() for t in tags}
        hit = [e["ubid"] for e in self.entries
               if want <= {str(t).lower() for t in e.get("tags", ())}]
        return tuple(sorted(hit, key=_natural_key))

    @staticmethod
    def _platform(ubid: str) -> str:
        return ubid.split("_", 1)[0].lower()

    @staticmethod
    def _platform_key(platform: str):
        """Order platforms by trailing mission number (lt04 < lt05 < le07 <
        lc08): the downstream date-collision merge is first-writer-wins
        (sources._band_series), and the built-in Collection-01 tables give
        the older platform priority — the registry-derived order must not
        silently flip that."""
        m = re.search(r"(\d+)$", platform)
        return (int(m.group(1)) if m else -1, platform)

    def _one_per_platform(self, ubids) -> tuple[str, ...]:
        """Keep the lowest-numbered ubid per platform (LC08 BTB10 < BTB11),
        platforms in mission order."""
        best: dict[str, str] = {}
        for u in ubids:
            p = self._platform(u)
            if p not in best or _natural_key(u) < _natural_key(best[p]):
                best[p] = u
        return tuple(best[p] for p in sorted(best, key=self._platform_key))

    def ard_ubids(self) -> dict[str, tuple[str, ...]]:
        """Logical ARD band -> per-platform ubids (sources.ARD_UBIDS shape)."""
        out = {}
        for band, tags in ARD_TAG_RULES.items():
            ubids = self._one_per_platform(self.select(*tags))
            if not ubids:
                raise LookupError(f"registry has no ubids for band {band!r} "
                                  f"(tags {tags})")
            out[band] = ubids
        return out

    def aux_ubids(self) -> dict[str, tuple[str, ...]]:
        out = {}
        for name, tags in AUX_TAG_RULES.items():
            ubids = self.select(*tags)
            if not ubids:
                raise LookupError(f"registry has no AUX ubids for {name!r}")
            out[name] = ubids
        return out

    def entry(self, ubid: str) -> dict:
        try:
            return self._by_ubid[ubid]
        except KeyError:
            raise LookupError(f"ubid {ubid!r} not in registry") from None

    def wire_dtype(self, ubid: str) -> np.dtype:
        dt = str(self.entry(ubid).get("data_type", "")).upper()
        try:
            return np.dtype(DATA_TYPES[dt])
        except KeyError:
            raise LookupError(
                f"ubid {ubid!r} has unknown data_type {dt!r}") from None

    def data_shape(self, ubid: str) -> tuple[int, int]:
        shape = self.entry(ubid).get("data_shape") or None
        if not shape or len(shape) != 2:
            raise LookupError(f"ubid {ubid!r} has no data_shape")
        return int(shape[0]), int(shape[1])

    def chip_side(self, ubids=None) -> int:
        """The common square chip side across `ubids` (default: all entries
        that declare a shape).  Mixed or non-square shapes are an error —
        the packer requires one geometry per campaign."""
        sides = set()
        for u in (ubids if ubids is not None else self.ubids):
            try:
                h, w = self.data_shape(u)
            except LookupError:
                continue
            if h != w:
                raise ValueError(f"non-square chip {u!r}: {h}x{w}")
            sides.add(h)
        if not sides:
            raise LookupError("registry declares no data_shape")
        if len(sides) > 1:
            raise ValueError(f"mixed chip sides in registry: {sorted(sides)}")
        return sides.pop()

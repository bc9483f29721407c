"""Ordinal-day / ISO-8601 date helpers.

The reference's data plane uses proleptic-Gregorian ordinal days (as Python
``datetime.date.toordinal``) for observation timestamps and segment
start/end/break days, converting to ISO strings at format time
(ccdc/pyccd.py:113-115,146).  Acquired ranges are ``"YYYY-MM-DD/YYYY-MM-DD"``
(ccdc/core.py:41-50).
"""

from __future__ import annotations

import datetime

import numpy as np


def to_ordinal(iso: str) -> int:
    return datetime.date.fromisoformat(iso[:10]).toordinal()


def to_iso(ordinal: int) -> str:
    return datetime.date.fromordinal(int(ordinal)).isoformat()


def acquired_range(acquired: str) -> tuple[int, int]:
    """Parse an ISO8601 range 'start/end' into (start_ordinal, end_ordinal)."""
    start, _, end = acquired.partition("/")
    return to_ordinal(start), to_ordinal(end)


def default_acquired() -> str:
    """Full-archive default range (ccdc/core.py:41-50).

    Ends TOMORROW: acquired windows are half-open ``[start, end)``
    (ingest/sources._slice_acquired), so covering everything up to and
    including today — the freshest acquisitions are exactly what a
    default streaming run exists to process — needs today + 1 as the
    exclusive end."""
    tomorrow = datetime.datetime.now().date() + datetime.timedelta(days=1)
    return "0001-01-01/{}".format(tomorrow.isoformat())


def ordinal_to_fractional_year(ordinal) -> np.ndarray:
    """Ordinal days -> fractional years since epoch (not mod 1).

    Harmonic design matrices use omega = 2*pi/365.25 applied to ordinal days
    directly (the CCDC convention); helper kept for diagnostics.
    """
    return np.asarray(ordinal, dtype=np.float64) / 365.25

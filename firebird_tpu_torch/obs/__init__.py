"""Observability: logging and run metrics.

The port's own copy of what its batch driver calls from the JAX package's
``obs`` package: :func:`logger` (plain Python logging under the
``firebird.<category>`` names, an ISO8601 stderr line, FIREBIRD_LOG_LEVEL
and FIREBIRD_LOG_LEVELS) and :mod:`firebird_tpu_torch.obs.metrics`.  The
span tracer's trace files, JSON log lines, the run report, the ops server,
the watchdog, the flight recorder and the profiler are not ported yet.
"""

from __future__ import annotations

import logging
import sys
import threading

from firebird_tpu_torch.config import env_knob

from firebird_tpu_torch.obs.metrics import (Counters, Gauge, Histogram,
                                            MetricsRegistry, counter, gauge,
                                            get_registry, histogram,
                                            metrics_enabled, timer)

# Per-subsystem categories (the JAX package's, after the reference's log4j
# categories).
CATEGORIES = (
    "ids",
    "change-detection",
    "random-forest-training",
    "random-forest-classification",
    "timeseries",
    "pyccd",
)

_configured = False  # guarded-by: _lock
_lock = threading.Lock()


def configure(level: int | None = None) -> None:
    """Install the ISO8601 stderr handler once (idempotent):
    FIREBIRD_LOG_LEVEL sets the level of the ``firebird`` logger, and
    FIREBIRD_LOG_LEVELS="pyccd=DEBUG,timeseries=WARNING" overrides single
    categories."""
    global _configured
    with _lock:
        if _configured:
            return
        root = logging.getLogger("firebird")
        if not root.handlers:
            root.addHandler(logging.StreamHandler(sys.stderr))
        fmt = logging.Formatter(
            fmt="%(asctime)s %(levelname)s %(name)s: %(message)s",
            datefmt="%Y-%m-%dT%H:%M:%S")
        for handler in root.handlers:
            handler.setFormatter(fmt)
        if level is None:
            level = _parse_level(env_knob("FIREBIRD_LOG_LEVEL"),
                                 logging.INFO)
        root.setLevel(level)
        root.propagate = False
        for spec in (env_knob("FIREBIRD_LOG_LEVELS") or "").split(","):
            if "=" in spec:
                name, _, lv = spec.partition("=")
                logging.getLogger(f"firebird.{name.strip()}").setLevel(
                    _parse_level(lv, logging.INFO))
        _configured = True


def _parse_level(name: str, default: int) -> int:
    """Level name -> int; log4j's TRACE maps to DEBUG; an unknown name
    falls back to ``default`` with a warning on stderr."""
    n = name.strip().upper()
    levels = dict(logging.getLevelNamesMapping())
    levels["TRACE"] = logging.DEBUG
    if n in levels:
        return levels[n]
    print(f"firebird: unknown log level {name!r}, using "
          f"{logging.getLevelName(default)}", file=sys.stderr)
    return default


def logger(name: str) -> logging.Logger:
    """A per-subsystem logger, ``firebird.<name>``."""
    configure()
    return logging.getLogger(f"firebird.{name}")


__all__ = [
    "CATEGORIES", "configure", "logger",
    "Counters", "Gauge", "Histogram", "MetricsRegistry", "timer",
    "counter", "gauge", "histogram", "get_registry", "metrics_enabled",
]

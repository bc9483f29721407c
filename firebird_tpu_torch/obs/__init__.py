"""Observability: logging, span tracing, metrics, run reports and the ops
surface.

The port's own copy of the JAX package's ``obs`` package: :func:`logger`
(plain Python logging under the ``firebird.<category>`` names, an ISO8601
stderr line or, with FIREBIRD_LOG_FORMAT=json, one JSON object a line
carrying the run context — :mod:`.jsonlog`; FIREBIRD_LOG_LEVEL and
FIREBIRD_LOG_LEVELS), :mod:`.metrics`, the span tracer (:mod:`.tracing`,
FIREBIRD_TRACE), the per-run report (:mod:`.report`,
FIREBIRD_OBS_REPORT), the device profiler (:mod:`.profiling`,
FIREBIRD_PROFILE / FIREBIRD_PROFILE_DIR, on ``torch.profiler``), the ops
endpoint (:mod:`.server`, FIREBIRD_OPS_PORT), the stall watchdog
(:mod:`.watchdog`, FIREBIRD_STALL_SEC), the crash flight recorder
(:mod:`.flightrec`, FIREBIRD_FLIGHTREC) and the live SLO evaluation
(:mod:`.slo`, FIREBIRD_SLO).  The JAX package's telemetry spool, series
store and collector are not ported.
"""

from __future__ import annotations

import logging
import sys
import threading

from firebird_tpu_torch.config import env_knob
from firebird_tpu_torch.obs import jsonlog
from firebird_tpu_torch.obs.metrics import (Counters, Gauge, Histogram,
                                            MetricsRegistry, counter, gauge,
                                            get_registry, histogram,
                                            metrics_enabled, timer)
from firebird_tpu_torch.obs.report import (build_report,
                                           validate_driver_artifacts,
                                           validate_report, validate_trace,
                                           write_report)
from firebird_tpu_torch.obs.tracing import Tracer, span

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
    """Install the stderr handler once (idempotent): the ISO8601 line, or
    JSON lines with FIREBIRD_LOG_FORMAT=json; FIREBIRD_LOG_LEVEL sets the
    level of the ``firebird`` logger, and
    FIREBIRD_LOG_LEVELS="pyccd=DEBUG,timeseries=WARNING" overrides single
    categories."""
    global _configured
    with _lock:
        if _configured:
            return
        root = logging.getLogger("firebird")
        if not root.handlers:
            root.addHandler(logging.StreamHandler(sys.stderr))
        # The format choice is applied on every configure pass (tests
        # reset _configured), so flipping FIREBIRD_LOG_FORMAT between runs
        # takes effect on the existing handler.
        if jsonlog.wants_json():
            fmt: logging.Formatter = jsonlog.JsonFormatter()
        else:
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
    "CATEGORIES", "configure", "logger", "jsonlog",
    "Counters", "Gauge", "Histogram", "MetricsRegistry", "timer",
    "counter", "gauge", "histogram", "get_registry", "metrics_enabled",
    "Tracer", "span",
    "build_report", "write_report", "validate_report", "validate_trace",
    "validate_driver_artifacts",
]

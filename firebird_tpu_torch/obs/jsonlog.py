"""Run-correlated structured logging: JSON lines + the run context.

The port's own copy of the JAX package's ``obs/jsonlog.py``.  Every run
mints a ``run_id`` (driver/core.py, driver/stream.py; one id for all the
processes of a launch, ``driver.core.fleet_run_id``) and registers it —
with the process index (``parallel.dist``) — in a process-global run
context, and the opt-in JSON formatter (``FIREBIRD_LOG_FORMAT=json``,
applied by ``obs.configure``) stamps every log line with ``run_id`` /
``host`` / ``process_id`` / ``pid`` so a multi-process run's interleaved
logs are join-able by run and attributable to a process without any
out-of-band bookkeeping.

The same context feeds the ops server's ``/progress`` payload and the
report ``run`` block, so one identifier correlates logs, live endpoints,
and the post-hoc artifact.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time

from firebird_tpu_torch.config import env_knob
from firebird_tpu_torch.obs import tracing

HOST = socket.gethostname()

_lock = threading.Lock()
_context: dict = {"run_id": None, "process_index": None}


def new_run_id() -> str:
    """Mint a run id: coarse wall-clock prefix (sortable across a fleet)
    plus random suffix (collision-safe when hosts start in the same
    second)."""
    return f"{int(time.time()):x}-{os.urandom(4).hex()}"


def set_run_context(run_id: str | None = None,
                    process_index: int | None = None) -> None:
    """Install the current run's identity; every JSON log line and the
    ops endpoints read it.  Passing None leaves a field unchanged."""
    with _lock:
        if run_id is not None:
            _context["run_id"] = run_id
        if process_index is not None:
            _context["process_index"] = int(process_index)


def clear_run_context() -> None:
    with _lock:
        _context["run_id"] = None
        _context["process_index"] = None


def get_run_context() -> dict:
    with _lock:
        return dict(_context)


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts/level/logger/message plus the run
    correlation fields.  Values are whatever ``json.dumps`` can carry;
    anything else stringifies rather than crashing the log path."""

    def format(self, record: logging.LogRecord) -> str:
        ctx = get_run_context()
        out = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S",
                                time.localtime(record.created))
                  + f".{int(record.msecs):03d}",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
            "host": HOST,
            "pid": record.process,
            "run_id": ctx["run_id"],
            "process_id": ctx["process_index"],
        }
        # Batch-scoped parent id: a line logged from inside a unit of
        # work (any thread that activated the batch's TraceContext —
        # prefetch, dispatch, drain, writer) joins to its spans and
        # exemplars on one key (obs/tracing.py).
        tctx = tracing.current_context()
        if tctx is not None:
            out["batch"] = tctx.batch_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def wants_json(env: dict | None = None) -> bool:
    """FIREBIRD_LOG_FORMAT gate: 'json' (case-insensitive) opts in; empty
    or 'text' keeps the ISO8601 line format."""
    return (env_knob("FIREBIRD_LOG_FORMAT", env) or "").strip().lower() \
        == "json"

"""Span tracer: nested, thread-aware, Chrome-trace/Perfetto JSON export.

The port's own copy of the JAX package's ``obs/tracing.py``, whole.
``span("fetch", chip=cid)`` wraps any pipeline stage; spans nest naturally
(Chrome's trace viewer stacks complete events by interval containment per
thread), and each OS thread renders as its own track, so the driver's
prefetch/pack/dispatch/drain overlap is visually inspectable — the
host-orchestration counterpart of the device trace that ``profile_dir``
and the profile windows capture (obs/profiling.py).  A span is host time
only: it never synchronises with the card.

Disabled cost is one module-attribute read and a ``None`` check per span:
no tracer installed means ``span()`` returns a shared no-op context
manager and records nothing.  Enable per run with FIREBIRD_TRACE (see
resolve_path) or programmatically via ``start()``/``stop()``.

Export is the Chrome trace-event JSON format (``{"traceEvents": [...]}``,
"X" complete events with microsecond timestamps) — loads directly in
Perfetto (ui.perfetto.dev) and chrome://tracing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time


class _NullSpan:
    """Shared no-op span: tracing disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


# ---------------------------------------------------------------------------
# Cross-thread trace propagation: the per-batch/per-request TraceContext
# ---------------------------------------------------------------------------
#
# The pipeline's unit of work crosses FOUR threads (prefetch stage ->
# main-thread dispatch -> drain executor -> writer worker), so a
# thread-local alone cannot correlate one batch's spans and log lines.
# The drivers therefore mint ONE TraceContext per batch (per request in
# serve/api.py) and carry it EXPLICITLY across each thread hop; each
# thread activates it around the work it does for that batch, and
# everything recorded while it is active — spans (the ``batch`` arg),
# JSON log lines (obs/jsonlog.py), histogram exemplars
# (obs/metrics.py), flight-recorder events (obs/flightrec.py) — parents
# to the same batch id.

@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One unit of work's identity: ``batch_id`` is globally unique
    (``<run_id>/b<seq>`` in the drivers, ``req-<hex>`` in serve)."""

    batch_id: str
    run_id: str | None = None


class _Tls(threading.local):
    ctx: TraceContext | None = None
    last_span_id: int = 0


_tls = _Tls()

# Span ids are minted process-wide (not per tracer) so exemplars and
# flight-recorder events can reference spans even when no tracer runs.
_span_ids = itertools.count(1)
_batch_seq = itertools.count()


def new_batch_id(run_id: str | None) -> str:
    """Mint the next batch id for a run: ``<run_id>/b<seq>`` (seq is
    process-wide, so ids stay unique across chunks and drivers)."""
    return f"{run_id or 'run'}/b{next(_batch_seq)}"


# ---------------------------------------------------------------------------
# Cross-PROCESS trace propagation (the fleet telemetry plane)
# ---------------------------------------------------------------------------
# A trace id travels between processes as a plain string: the watcher
# stamps it into fleet-queue job payloads (key ``trace``), workers adopt
# it, alert rows persist it, and serve accepts it as an inbound
# X-Firebird-Trace header.  Wire ids are validated against WIRE_RE
# before adoption — a job payload and an HTTP header are both untrusted
# inputs, and an unbounded id would flow into log lines and sqlite rows.

TRACE_KEY = "trace"

import re as _re  # noqa: E402  (scoped import, stdlib only)

WIRE_RE = _re.compile(r"^[A-Za-z0-9._:/\-]{1,160}$")


def to_wire(ctx: TraceContext | None) -> str | None:
    """The propagable form of a context (its batch id), or None."""
    return None if ctx is None else ctx.batch_id


def from_wire(trace, run_id: str | None = None) -> TraceContext | None:
    """Adopt a trace id that arrived from another process (queue
    payload, HTTP header).  None — or None-return on a malformed id —
    means the caller mints its own context instead."""
    if not isinstance(trace, str) or WIRE_RE.match(trace) is None:
        return None
    return TraceContext(trace, run_id=run_id)


def current_context() -> TraceContext | None:
    """The TraceContext active on THIS thread (None outside any unit of
    work)."""
    return _tls.ctx


@contextlib.contextmanager
def activate(ctx: TraceContext | None):
    """Make ``ctx`` the calling thread's active context for the block.
    ``None`` is accepted (no-op) so call sites can thread an optional
    context without branching."""
    prev = _tls.ctx
    if ctx is not None:
        _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def exemplar() -> dict | None:
    """The histogram-exemplar payload for the current thread: the active
    batch id plus the most recently closed span's id — "the slow p99
    sample WAS this batch/span".  None outside any context (histograms
    then record no exemplar)."""
    ctx = _tls.ctx
    if ctx is None:
        return None
    out = {"batch": ctx.batch_id}
    if _tls.last_span_id:
        out["span_id"] = _tls.last_span_id
    return out


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0", "_ctx")

    def __init__(self, tracer: "Tracer | None", name: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._ctx = _tls.ctx
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        sid = next(_span_ids)
        _tls.last_span_id = sid
        args = self._args
        ctx = self._ctx
        if ctx is not None:
            args = dict(args, batch=ctx.batch_id, span_id=sid)
        else:
            args = dict(args, span_id=sid) if args else {"span_id": sid}
        if self._tracer is not None:
            self._tracer._record(self._name, self._t0, dur, args)
        rec = _recorder
        if rec is not None:
            rec.span_event(self._name, dur * 1e3,
                           ctx.batch_id if ctx is not None else None)
        sp = _spool
        if sp is not None:
            sp.span_event(self._name, dur,
                          ctx.batch_id if ctx is not None else None)
        return False


class Tracer:
    """Collects complete ("X") trace events; thread-safe.

    Timestamps are microseconds relative to the tracer's epoch; OS thread
    idents map to small sequential tids with ``thread_name`` metadata so
    Perfetto tracks are readable (MainThread, ThreadPoolExecutor-0_0, ...).
    """

    def __init__(self, run_id: str | None = None):
        # Run correlation: the trace artifact carries the same run_id as
        # the JSON logs, /progress, and the report run block (otherData
        # plus a process_name metadata track label in Perfetto).
        self.run_id = run_id
        self._lock = threading.Lock()
        self._events: list[dict] = []
        # tids assign through a threading.local, NOT by OS thread ident:
        # CPython reuses idents after a thread exits (the driver spins up
        # fresh executors per chunk), which would put a later thread's
        # spans on a dead thread's track under its stale name.
        self._local = threading.local()
        self._n_tids = 0
        self._epoch = time.perf_counter()

    def _tid(self) -> int:
        tid = getattr(self._local, "tid", None)
        if tid is None:
            tid = self._local.tid = self._n_tids
            self._n_tids += 1
            self._events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                "args": {"name": threading.current_thread().name}})
        return tid

    def _record(self, name: str, t0: float, dur: float, args: dict) -> None:
        ev = {"name": name, "ph": "X", "pid": 0,
              "ts": (t0 - self._epoch) * 1e6, "dur": dur * 1e6}
        if args:
            ev["args"] = {k: (v if isinstance(v, (int, float, bool))
                              else str(v)) for k, v in args.items()}
        with self._lock:
            ev["tid"] = self._tid()
            self._events.append(ev)

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def to_chrome_trace(self) -> dict:
        with self._lock:
            events = list(self._events)
        other = {"producer": "firebird_tpu_torch.obs.tracing"}
        if self.run_id:
            other["run_id"] = self.run_id
            events = [{"name": "process_name", "ph": "M", "pid": 0,
                       "tid": 0, "args": {"name": f"run {self.run_id}"}}] \
                + events
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": other}

    def save(self, path: str) -> str:
        """Write the Chrome-trace JSON (atomic tmp+rename)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path

    def summary(self) -> dict:
        """Per-span-name aggregate: count and total/mean/max milliseconds
        (the obs_report.json span table)."""
        with self._lock:
            events = [e for e in self._events if e.get("ph") == "X"]
        out: dict[str, dict] = {}
        for e in events:
            s = out.setdefault(e["name"],
                               {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            ms = e["dur"] / 1e3
            s["count"] += 1
            s["total_ms"] += ms
            s["max_ms"] = max(s["max_ms"], ms)
        for s in out.values():
            s["mean_ms"] = s["total_ms"] / s["count"]
            for k in ("total_ms", "max_ms", "mean_ms"):
                s[k] = round(s[k], 3)
        return out


_active: Tracer | None = None

# The crash flight recorder's span feed (obs/flightrec.py installs it
# while armed): spans record into the per-thread event rings even when
# no tracer is running, so a postmortem bundle has recent spans to show.
_recorder = None


def set_recorder(rec) -> None:
    """Install/clear the flight-recorder span sink (None clears)."""
    global _recorder
    # Single-reference swap from the run-owning thread (arm/disarm);
    # span exits read the reference once.
    _recorder = rec  # firebird-lint: disable=ownership-global-mutation


# The durable telemetry spool's span feed (obs/spool.py installs it
# while armed): a parallel sink to the flight recorder — the recorder
# keeps a crash-dump ring in memory, the spool appends to disk so a
# SIGKILLed process's spans survive for `trace collect`.
_spool = None


def set_spool(sp) -> None:
    """Install/clear the telemetry-spool span sink (None clears)."""
    global _spool
    # Single-reference swap from the process-owning thread (spool
    # arm/disarm); span exits read the reference once.
    _spool = sp  # firebird-lint: disable=ownership-global-mutation


def active() -> Tracer | None:
    return _active


def start(tracer: Tracer | None = None,
          run_id: str | None = None) -> Tracer:
    """Install ``tracer`` (or a fresh one) as the process-global span sink
    and return it.  Spans from any thread land in the active tracer.
    ``run_id`` stamps the exported trace for fleet-log correlation."""
    global _active
    # Single-reference swap from the run-owning thread; span() reads the
    # reference once, so torn state is impossible under the GIL.
    _active = tracer or Tracer(run_id=run_id)  # firebird-lint: disable=ownership-global-mutation
    if run_id and _active.run_id is None:
        _active.run_id = run_id
    return _active


def stop() -> Tracer | None:
    """Uninstall and return the active tracer (None if none installed)."""
    global _active
    # See start(): single-reference swap, run-owning thread only.
    t, _active = _active, None  # firebird-lint: disable=ownership-global-mutation
    return t


def span(name: str, **args):
    """A span against the active tracer (and the armed flight recorder
    and telemetry spool); a shared no-op when all three are off."""
    t = _active
    if t is None and _recorder is None and _spool is None:
        return _NULL_SPAN
    return _Span(t, name, args)


def wants_trace(trace: str) -> bool:
    """FIREBIRD_TRACE gate: ""/"0" off (matching the 0-disables
    convention of FIREBIRD_METRICS and FIREBIRD_OBS_REPORT), anything
    else on."""
    return trace not in ("", "0")


def resolve_path(trace: str, store_path: str,
                 default_name: str = "trace.json") -> str:
    """Resolve the FIREBIRD_TRACE value to an output file.

    "1" (just "turn it on") writes ``<store dir>/<default_name>`` next to
    the store; a directory path appends ``default_name``; anything else is
    the literal output file.
    """
    if trace == "1":
        return os.path.join(
            os.path.dirname(os.path.abspath(store_path)), default_name)
    if os.path.isdir(trace) or trace.endswith(os.sep):
        return os.path.join(trace, default_name)
    return trace

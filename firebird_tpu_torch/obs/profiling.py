"""On-demand device profiling: windowed ``torch.profiler`` captures mid-run.

The port's own copy of the JAX package's ``obs/profiling.py``, on
``torch.profiler`` where the JAX package uses ``jax.profiler``.  The host
span tracer (obs/tracing.py) says *that* a batch was slow; this module
says *where on the card* the time went, as a one-request operation on a
live run:

- ``FIREBIRD_PROFILE=<seconds>`` (``Config.profile``) arms an automatic
  window that opens at the run's FIRST dispatch.  The kernels are built
  before the run starts (``cuda_ops.build``), so there is no bring-up
  compile to skip; and the port's dispatch runs the event loop's host
  gates on the dispatching thread, so most of a batch's kernels launch
  before its dispatch returns.  The auto window therefore opens right
  BEFORE the first dispatch, and the dispatch waits until the capture has
  started (:meth:`DeviceProfiler.maybe_start_auto`).
- ``POST /profile?seconds=N`` on the ops endpoint (obs/server.py)
  captures a window on demand at any point mid-run.

Each window runs ``torch.profiler.profile`` with the CPU activity and,
on a card, the CUDA one, **started and stopped from the window's own
thread** while the driver's threads go on launching: CUPTI records the
context's kernels whichever thread launched them (the ``csrc/`` kernels
loaded through ctypes too).  The window writes its Chrome trace,
gzipped, under ``<store dir>/device_profile/window_<n>/`` as
``<host>.<pid>.trace.json.gz`` (loadable in Perfetto), and the trace is
then parsed for **per-phase device-time attribution**: event durations
bucketed into the CCD loop's phases (fit / monitor / compaction) by
kernel-name pattern, folded into ``obs_report.json``'s ``profile``
block.

The counting rule: a torch trace holds host events too (CPU operators,
CUDA runtime calls, Python functions), all of them complete ``X``
events.  Only **device events** count here: ``ph == "X"`` with ``cat``
``kernel``, ``gpu_memcpy`` or ``gpu_memset``.  Counting every complete
event, as the JAX package may on its XLA traces, would book host time as
device time.  Besides the per-phase sums (``total_ms`` adds the device
events' durations; two streams' overlapping kernels both count) the
attribution carries ``device_busy_ms``, the union of the device events'
intervals, and ``window_ms``, the window's wall: their ratio is the
card's busy share of the window.  A window that recorded no device
event says so in ``source`` (``"no-device-events"``) with zeros; it is
never passed off as a capture of zero work.

The port's kernel symbols fall under the JAX package's patterns
unchanged: ``lasso_fit_kernel``, ``fused_fit_close_kernel`` and
``lasso_cd_kernel`` are "fit"; ``monitor_kernel``,
``monitor_plane_kernel`` and ``tmask_kernel`` are "monitor";
``init_kernel``, ``fused_round_kernel``, ``mega_kernel`` and
``ring_copy_kernel`` are "other".

``Config.profile_dir`` (FIREBIRD_PROFILE_DIR) remains the whole-run
capture (:class:`RunCapture`); this module's windows are the complement
a long run needs (a full-run device trace of a tile run is gigabytes).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import socket
import threading
import time

from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import tracing

# Kernel-name patterns -> CCD event-loop phase: the JAX package's, and
# with them its report contract.  Matched as lowercase substrings against
# every device event name; first phase wins, anything unmatched lands in
# "other".
PHASE_PATTERNS = (
    ("fit", ("lasso", "gram", "cd_step", "lstsq", "fit")),
    ("monitor", ("monitor", "score", "peek", "tmask")),
    ("compaction", ("compact", "permut", "scatter", "cumsum", "sort")),
)
PHASES = tuple(name for name, _ in PHASE_PATTERNS) + ("other",)

# The trace-event categories torch's Chrome trace gives the card's own
# work; every other complete event is host time.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# Device events kept by name in a window's record (the slowest first).
TOP_KERNELS = 40


def empty_attribution(source: str = "none") -> dict:
    out = {f"{p}_ms": 0.0 for p in PHASES}
    out.update({"total_ms": 0.0, "events": 0, "device_busy_ms": 0.0,
                "window_ms": 0.0, "source": source})
    return out


def phase_of(name: str) -> str:
    """The phase a device event's name falls under (PHASE_PATTERNS)."""
    name = name.lower()
    for p, pats in PHASE_PATTERNS:
        if any(s in name for s in pats):
            return p
    return "other"


def _busy_ms(intervals: list) -> float:
    """Length of the union of [start, end) intervals (microseconds in,
    milliseconds out)."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _scan(trace_dir: str) -> tuple[dict, dict]:
    """(attribution, {device event name: {count, ms}}) of the Chrome
    traces under ``trace_dir``."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**",
                                          "*.trace.json.gz"),
                             recursive=True))
    if not paths:
        return empty_attribution("no-trace-files"), {}
    out = empty_attribution("trace")
    names: dict = {}
    intervals = []
    for path in paths:
        try:
            with gzip.open(path, "rt", errors="replace") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        for ev in doc.get("traceEvents", ()):
            if (not isinstance(ev, dict) or ev.get("ph") != "X"
                    or ev.get("cat") not in DEVICE_CATEGORIES):
                continue
            dur_us = float(ev.get("dur", 0.0))
            dur_ms = dur_us / 1e3
            name = str(ev.get("name", ""))
            out[f"{phase_of(name)}_ms"] += dur_ms
            out["total_ms"] += dur_ms
            out["events"] += 1
            ts = float(ev.get("ts", 0.0))
            intervals.append((ts, ts + dur_us))
            k = names.setdefault(name[:200], {"count": 0, "ms": 0.0})
            k["count"] += 1
            k["ms"] += dur_ms
    if not out["events"]:
        return empty_attribution("no-device-events"), {}
    out["device_busy_ms"] = _busy_ms(intervals)
    for k in [f"{p}_ms" for p in PHASES] + ["total_ms", "device_busy_ms"]:
        out[k] = round(out[k], 3)
    top = sorted(names.items(), key=lambda kv: -kv[1]["ms"])[:TOP_KERNELS]
    return out, {n: {"count": v["count"], "ms": round(v["ms"], 3)}
                 for n, v in top}


def attribute_phases(trace_dir: str) -> dict:
    """Per-phase device-time split of a captured window.

    Walks the window directory for the ``.trace.json.gz`` files a window
    writes, sums the DEVICE events' durations (the module docstring's
    rule) by PHASE_PATTERNS, and returns the attribution dict
    (milliseconds).  Unreadable/absent traces, or traces without a device
    event, return the zero structure with ``source`` saying why.
    """
    return _scan(trace_dir)[0]


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_name() -> str:
    return f"{socket.gethostname()}.{os.getpid()}.trace.json.gz"


def _export(prof, directory: str) -> str:
    """Write ``prof``'s Chrome trace, gzipped, into ``directory``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, _trace_name())
    raw = path[:-len(".gz")] + ".tmp"
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as src, gzip.open(path + ".tmp", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(raw)
    os.replace(path + ".tmp", path)
    return path


class ProfilerBusy(RuntimeError):
    """A capture window is already in flight (the torch profiler is one
    per process)."""


class DeviceProfiler:
    """Windowed device-trace capture for one run.

    ``outdir`` is the artifact root (``<store dir>/device_profile``);
    each window writes ``window_<n>/`` under it.  One window at a time —
    the torch profiler is a process singleton.
    """

    def __init__(self, outdir: str):
        self.outdir = os.path.abspath(outdir)
        self._lock = threading.Lock()
        self._busy = False  # guarded-by: _lock
        self._n = 0  # guarded-by: _lock
        self._windows: list[dict] = []  # guarded-by: _lock
        self._auto_seconds = 0.0  # guarded-by: _lock
        self._stop = threading.Event()
        self._started = threading.Event()
        self._thread: threading.Thread | None = None

    # -- capture -------------------------------------------------------------

    def window(self, seconds: float, block: bool = False,
               wait_started: float = 0.0) -> dict:
        """Start one capture window of ``seconds`` (bounded 0.05..600).
        Raises :class:`ProfilerBusy` when one is already in flight.
        ``block=True`` runs the capture synchronously (tests, tools);
        the default returns immediately and captures on a daemon thread,
        after waiting up to ``wait_started`` seconds for the capture to
        have started there.
        """
        seconds = min(max(float(seconds), 0.05), 600.0)
        with self._lock:
            if self._busy:
                raise ProfilerBusy("a profile window is already capturing")
            self._busy = True
            n = self._n
            self._n += 1
        info = {"window": n, "seconds": seconds,
                "dir": os.path.join(self.outdir, f"window_{n:02d}"),
                # UTC with designator — the written_at/generated_at
                # convention, so windows correlate across artifacts.
                "started_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime())}
        self._started.clear()
        if block:
            self._capture(info)
            return info
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._capture, args=(info,),
            name="firebird-profile", daemon=True)
        self._thread.start()
        if wait_started > 0:
            self._started.wait(wait_started)
        return info

    def _capture(self, info: dict) -> None:
        try:
            import torch

            os.makedirs(info["dir"], exist_ok=True)
            with tracing.span("profile", seconds=info["seconds"]):
                prof = torch.profiler.profile(activities=_activities())
                prof.start()
                t0 = time.perf_counter()
                self._started.set()
                try:
                    # Interruptible wait: close() ends an in-flight
                    # window early instead of leaking a started trace.
                    self._stop.wait(info["seconds"])
                finally:
                    prof.stop()
                    window_ms = (time.perf_counter() - t0) * 1e3
                info["trace_file"] = _export(prof, info["dir"])
            attribution, kernels = _scan(info["dir"])
            attribution["window_ms"] = round(window_ms, 3)
            info["attribution"] = attribution
            info["device_kernels"] = kernels
            info["trace_files"] = len(glob.glob(
                os.path.join(info["dir"], "**", "*"), recursive=True))
            obs_metrics.counter(
                "profile_windows",
                help="on-demand device-profile windows captured").inc()
        except Exception as e:
            # A broken profiler (no CUPTI, a concurrent capture) must
            # cost the operator a diagnosable record, not the run.
            info["error"] = f"{type(e).__name__}: {e}"
            info["attribution"] = empty_attribution("error")
            from firebird_tpu_torch.obs import logger
            logger("change-detection").warning(
                "device-profile window failed: %s", info["error"])
        finally:
            self._started.set()
            with self._lock:
                self._windows.append(info)
                self._busy = False

    # -- FIREBIRD_PROFILE auto window ---------------------------------------

    def arm_auto(self, seconds: float) -> None:
        """Arm a one-shot window that opens at the first dispatch
        (obs/server.py's ``dispatch_starting`` hook)."""
        with self._lock:
            self._auto_seconds = float(seconds)

    def maybe_start_auto(self, wait_started: float = 60.0) -> None:
        """Open the armed auto window, if any, and wait (bounded) until
        its capture has started, so the dispatch that follows is in it."""
        with self._lock:
            seconds, self._auto_seconds = self._auto_seconds, 0.0
        if seconds > 0:
            try:
                self.window(seconds, wait_started=wait_started)
            except ProfilerBusy:
                pass

    # -- reads / teardown ----------------------------------------------------

    def summary(self) -> dict:
        """The report's ``profile`` block: windows so far + device-time
        totals across them (structure matches :func:`report_block`)."""
        with self._lock:
            windows = [dict(w) for w in self._windows]
            busy = self._busy
        # Provenance must survive aggregation: 'trace' only when a
        # window REALLY found device events — every-window-failed reports
        # 'error', and windows that saw no device event say so.
        sources = {w.get("attribution", {}).get("source") for w in windows}
        device_time = empty_attribution(
            "trace" if "trace" in sources
            else "error" if ("error" in sources
                             or "no-trace-files" in sources)
            else "no-device-events" if "no-device-events" in sources
            else "none")
        for w in windows:
            a = w.get("attribution")
            if not a:
                continue
            for k in [f"{p}_ms" for p in PHASES] + [
                    "total_ms", "device_busy_ms", "window_ms"]:
                device_time[k] = round(device_time[k] + a.get(k, 0.0), 3)
            device_time["events"] += a.get("events", 0)
        return {"windows": windows, "in_flight": busy,
                "device_time": device_time, "dir": self.outdir}

    def close(self, timeout: float = 60.0) -> None:
        """End any in-flight window early and collect it — called before
        the report is written so a run's last window is never lost.  The
        wait covers the trace's export, which follows the capture."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
        self._thread = None


# ---------------------------------------------------------------------------
# The whole-run capture (Config.profile_dir)
# ---------------------------------------------------------------------------

class RunCapture:
    """One ``torch.profiler`` capture from :meth:`start` to :meth:`stop`,
    its Chrome trace then written (gzipped) into ``directory``; a no-op
    for an empty one."""

    def __init__(self, directory: str | None):
        self.directory = directory
        self._prof = None

    def start(self) -> "RunCapture":
        if self.directory:
            import torch

            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()
        return self

    def stop(self) -> None:
        """Stop and write the trace (never raises for the write)."""
        prof, self._prof = self._prof, None
        if prof is None:
            return
        prof.stop()
        try:
            _export(prof, self.directory)
        except OSError as e:
            from firebird_tpu_torch.obs import logger
            logger("change-detection").error(
                "profile_dir trace write failed: %s", e)


# ---------------------------------------------------------------------------
# Process-global slot (one run's profiler; obs/report reads it)
# ---------------------------------------------------------------------------

# Mutated by start_ops/stop_ops on the run-owning thread; readers grab
# the reference once (the obs/server._status discipline).
_active: DeviceProfiler | None = None


def set_active(prof: DeviceProfiler | None) -> DeviceProfiler | None:
    global _active
    _active = prof  # firebird-lint: disable=ownership-global-mutation
    return prof


def active() -> DeviceProfiler | None:
    return _active


def close_active() -> None:
    """Flush an in-flight window (never raises) — obs.report.finish_run
    calls this before building the report so the artifact carries the
    final window's attribution."""
    prof = _active
    if prof is not None:
        try:
            prof.close()
        except Exception:
            pass


def report_block() -> dict:
    """The obs_report ``profile`` block — ALWAYS structurally present
    (zeros allowed, structure never absent)."""
    prof = _active
    if prof is None:
        return {"windows": [], "in_flight": False,
                "device_time": empty_attribution("none"), "dir": None}
    return prof.summary()

"""Durable metric history: spool snapshots -> fixed-resolution rings.

The port's own copy of the JAX package's ``obs/series.py``, whole: it
writes the JAX ring format line for line (``firebird-metric-series/1``:
file names, header, point keys in the same order), so either package's
reader reads the other's rings.  The telemetry spool (obs/spool.py)
persists periodic metric-registry snapshots per process, but each spool
is a short ring scoped to one pid — history dies with segment rotation
and a restart starts a new file set.  This module is the history leg the
SLO plane needs: an append-only time-series store next to the spools,
downsampling every snapshot into fixed-resolution rings (10s / 5min /
1h) that survive process death, SIGKILL, and reader restarts — the
substrate for ``top`` sparklines, ``/metrics/history``, and the
error-budget burn-rate windows in obs/slo.py.

Design points (the spool's discipline, re-applied to the read side):

- **Reader-side ingestion.**  Points are written by whoever *reads* the
  spools (``slo`` / ``top`` / ``status`` / the ops endpoint), never by
  the pipeline hot path — FIREBIRD_TELEMETRY=0
  keeps its zero-cost guarantee because no snapshots exist to ingest.
- **Snapshot clocks only.**  A point's bucket is derived from the
  wall-clock ``t`` the *emitting* process stamped on its snap line —
  never the ingesting reader's clock (a reader on a skewed host must
  not re-time another host's history).
- **Bounded rings, crash-safe lines.**  One segment ring per
  resolution per ingesting pid (``series.<res>.<pid>.<seg>.jsonl``),
  ``flush()`` per line, OSError degrades to a drop counter.  A full
  segment truncate-reopens the oldest; a torn tail line is skipped by
  readers.  A (re)opened store RESUMES its newest on-disk segment in
  append mode — truncation only ever happens when the ring genuinely
  wraps, so reopening never destroys a prior incarnation's durable
  points.  Ring files whose entire content has aged past their
  resolution's retention are garbage-collected at open, so dead
  incarnations (cron runs, killed fleets) do not grow the directory
  without bound.
- **Idempotent.**  Re-ingesting the same spools is a no-op: a bucket
  already holding a point at the same or newer snapshot time is
  skipped, and live-bucket refreshes are throttled to ``res/8`` so the
  coarse rings keep their retention (counters are cumulative, so a
  skipped tail snapshot just lands in the next bucket's delta).

Retention math: a ring holds
``FIREBIRD_SERIES x FIREBIRD_SERIES_SEGMENTS`` lines shared by every
source process; one bucket costs 1 line when closed plus at most 8
throttled refreshes while live, so a ring of N lines retains at least
``N x res / 9`` seconds of history per source, typically ``~N x res``.
"""

from __future__ import annotations

import glob
import json
import os
import threading

from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import spool as spool_mod

SERIES_SCHEMA = "firebird-metric-series/1"

# Ring file name: series.<resolution-sec>.<ingesting-pid>.<segment>.jsonl
SERIES_GLOB = "series.*.jsonl"

# Fixed downsampling resolutions (seconds per bucket): sparkline-grade,
# burn-window-grade, and budget-window-grade history.
RESOLUTIONS = (10, 300, 3600)

# A live (newest) bucket accepts a refreshed point at most this often,
# in fractions of the resolution — bounds lines-per-bucket so the
# coarse rings keep their retention (module docstring math).
_LIVE_REFRESH_FRACTION = 8


def series_dir(cfg) -> str | None:
    """The series directory for a config: ``cfg.series_dir`` when set,
    else ``series/`` inside the telemetry spool directory (None when
    the spool has no home — the memory backend)."""
    if getattr(cfg, "series_dir", ""):
        return cfg.series_dir
    d = spool_mod.spool_dir(cfg)
    return None if d is None else os.path.join(d, "series")


def _compact(metrics: dict) -> dict:
    """The point payload: counters + gauges verbatim, histograms
    reduced to the mergeable cumulative form (count/sum/buckets —
    percentiles re-derive from bucket deltas, never stored)."""
    out = {"counters": dict(metrics.get("counters") or {}),
           "gauges": dict(metrics.get("gauges") or {}),
           "histograms": {}}
    for name, h in (metrics.get("histograms") or {}).items():
        out["histograms"][name] = {
            "count": h.get("count", 0), "sum": h.get("sum", 0.0),
            "bucket_bounds": list(h.get("bucket_bounds") or ()),
            "bucket_counts": list(h.get("bucket_counts") or ())}
    return out


class SeriesStore:
    """One ingesting process's series writer: per-resolution segment
    rings plus the dedup state that makes re-ingestion idempotent.
    Thread-safe (the ops endpoint and a CLI loop may share one)."""

    def __init__(self, directory: str, *, points_per_segment: int = 512,
                 segments: int = 4, resolutions=RESOLUTIONS):
        if points_per_segment < 1:
            raise ValueError("points_per_segment must be >= 1, got "
                             f"{points_per_segment}")
        if segments < 2:
            raise ValueError(f"segments must be >= 2, got {segments}")
        self.dir = directory
        self.pid = os.getpid()
        self.points_per_segment = int(points_per_segment)
        self.segments = int(segments)
        self.resolutions = tuple(int(r) for r in resolutions)
        # Lock order: _ingest_lock (whole-batch atomicity for
        # concurrent ingesters sharing one instance) outside _lock
        # (rings + dedup state).
        self._ingest_lock = threading.Lock()
        self._lock = threading.Lock()
        self._rings: dict = {}      # guarded-by: _lock  res -> {seg,n,f}
        self._state: dict = {}      # guarded-by: _lock  (res,src) -> (b,t)
        self._dropped = 0           # guarded-by: _lock
        self._gc_removed = 0        # guarded-by: _lock
        os.makedirs(directory, exist_ok=True)
        self._load_state()

    # -- segment rings -----------------------------------------------------

    def segment_path(self, res: int, seg: int) -> str:
        return os.path.join(
            self.dir, f"series.{int(res)}.{self.pid}.{seg}.jsonl")

    def _open_segment(self, res: int, seg: int, *, append: bool = False,
                      n: int = 0):
        # guarded-by: _lock (callers hold it)
        ring = self._rings.setdefault(res, {"seg": 0, "n": 0, "f": None})
        if ring["f"] is not None:
            ring["f"].close()
        ring["seg"], ring["n"] = seg, n
        ring["f"] = open(self.segment_path(res, seg),
                         "a" if append else "w")
        if not append:
            header = {"kind": "header", "schema": SERIES_SCHEMA,
                      "pid": self.pid, "res": int(res), "segment": seg}
            ring["f"].write(json.dumps(header, separators=(",", ":"))
                            + "\n")
            ring["f"].flush()
        return ring

    def _resume_point(self, res: int) -> tuple | None:
        """Where this pid's ring resumes after a (re)open: the newest
        existing segment (by last point time, then mtime) and its
        occupied line count, or None when no segment exists yet.
        Resuming in APPEND mode is what keeps a re-opened store — same
        process, same pid — from truncating a prior incarnation's
        durable points; a segment is only ever truncated when the ring
        genuinely wraps onto it."""
        # guarded-by: _lock (callers hold it)
        best_key, best = None, None
        for seg in range(self.segments):
            path = self.segment_path(res, seg)
            try:
                mtime = os.path.getmtime(path)
                n, last_t = 0, float("-inf")
                with open(path) as f:
                    for line in f:
                        try:
                            doc = json.loads(line)
                        except ValueError:
                            n += 1      # a torn line still fills a slot
                            continue
                        if isinstance(doc, dict) \
                                and doc.get("kind") == "pt":
                            n += 1
                            last_t = max(last_t,
                                         float(doc.get("t", 0.0)))
            except OSError:
                continue
            key = (last_t, mtime, seg)
            if best_key is None or key > best_key:
                best_key, best = key, (seg, n)
        return best

    def _write(self, res: int, doc: dict) -> None:
        line = json.dumps(doc, separators=(",", ":"), default=str)
        with self._lock:
            try:
                ring = self._rings.get(res)
                if ring is None or ring["f"] is None:
                    resume = self._resume_point(res)
                    if resume is None:
                        ring = self._open_segment(res, 0)
                    elif resume[1] >= self.points_per_segment:
                        # The resumed segment is already full: a
                        # genuine ring wrap, the one case where
                        # truncating the next slot is correct.
                        ring = self._open_segment(
                            res, (resume[0] + 1) % self.segments)
                    else:
                        ring = self._open_segment(
                            res, resume[0], append=True, n=resume[1])
                elif ring["n"] >= self.points_per_segment:
                    ring = self._open_segment(
                        res, (ring["seg"] + 1) % self.segments)
                ring["f"].write(line + "\n")
                ring["f"].flush()
                ring["n"] += 1
            except OSError:
                # Disk trouble degrades history, never the reader
                # writing it (the spool's own rule).
                self._dropped += 1

    def _load_state(self) -> None:
        """Rebuild the dedup state from EVERY pid's rings on disk (so a
        restarted ingester — or a second one — never re-appends points
        an earlier incarnation already durably wrote), then
        garbage-collect ring files whose whole content has aged out of
        their resolution's retention."""
        with self._lock:
            files = _scan_files(self.dir)
            for pts in files.values():
                for pt in pts:
                    key = (pt["res"], pt["src"])
                    cur = self._state.get(key)
                    cand = (pt["b"], pt["t"])
                    if cur is None or cand > cur:
                        self._state[key] = cand
            self._gc_locked(files)

    def _gc_locked(self, files: dict) -> None:
        """Reclaim dead incarnations' ring files.  Each ingesting pid
        (every cron ``slo`` run, every killed fleet) leaves up
        to resolutions x segments files behind; without collection the
        directory — and every ``_read_raw`` walk over it — grows
        without bound.  A file whose NEWEST point predates its
        resolution's whole-ring retention (``points_per_segment x
        segments x res`` seconds) can no longer serve any window the
        ring itself would have retained, so it is unlinked.  Staleness
        is judged against the newest point at the same resolution —
        the emitters' clock domain, never this reader's wall clock
        (historic spools must stay replayable) — and never touches
        this pid's own files (they may be live open handles)."""
        # guarded-by: _lock (called at open, before any ring opens)
        res_newest: dict = {}
        stamped: dict = {}
        for path, pts in files.items():
            name = _parse_ring_name(path)
            if name is None or not pts:
                continue        # foreign file / header-only segment
            newest = max(float(p.get("t", 0.0)) for p in pts)
            stamped[path] = (name, newest)
            res = name[0]
            res_newest[res] = max(res_newest.get(res, newest), newest)
        for path, ((res, pid, _seg), newest) in stamped.items():
            if pid == self.pid:
                continue
            horizon = self.points_per_segment * self.segments * res
            if newest < res_newest[res] - horizon:
                try:
                    os.remove(path)
                    self._gc_removed += 1
                except OSError:
                    pass

    # -- ingestion ---------------------------------------------------------

    def ingest_events(self, events: list) -> int:
        """Downsample spool snap events into the rings.  Buckets key on
        each snap line's own wall-clock ``t`` — the emitting process's
        clock, NEVER this reader's (clock-domain rule, module
        docstring).  Returns the number of points written.  The whole
        batch runs under the ingest lock, so concurrent ingesters
        sharing one instance (the threaded ops endpoint) cannot
        interleave their dedup checks and double-write points."""
        with self._ingest_lock:
            return self._ingest_events_locked(events)

    def _ingest_events_locked(self, events: list) -> int:
        # guarded-by: _ingest_lock
        # Batch pre-group: per (res, src, bucket) keep only the
        # newest-t snapshot, then walk buckets in order so a closed
        # bucket lands exactly one line (its final cumulative state).
        best: dict = {}
        for ev in events:
            if ev.get("kind") != "snap" or ev.get("pid") is None:
                continue
            t = float(ev["t"])
            src = f"{ev.get('role')}:{ev.get('pid')}"
            for res in self.resolutions:
                key = (res, src, int(t // res))
                cur = best.get(key)
                if cur is None or t > cur[0]:
                    best[key] = (t, ev)
        written = 0
        for (res, src, b), (t, ev) in sorted(
                best.items(), key=lambda kv: (kv[0][0], kv[0][1],
                                              kv[0][2], kv[1][0])):
            with self._lock:
                last = self._state.get((res, src))
            if last is not None:
                last_b, last_t = last
                if b < last_b or (b == last_b
                                  and t < last_t + res / _LIVE_REFRESH_FRACTION):
                    continue      # immutable past / throttled live bucket
            self._write(res, {"kind": "pt", "res": res, "b": b,
                              "t": t, "src": src,
                              "m": _compact(ev.get("metrics") or {})})
            with self._lock:
                self._state[(res, src)] = (b, t)
            written += 1
        return written

    def ingest_spools(self, spool_directory: str | None = None) -> int:
        """Ingest every spool snapshot under ``spool_directory``
        (default: the parent of this series dir — the spool/series
        co-location rule)."""
        from firebird_tpu_torch.obs import collect as obs_collect

        d = spool_directory or os.path.dirname(self.dir.rstrip("/"))
        return self.ingest_events(obs_collect.snap_events(d))

    # -- queries -----------------------------------------------------------

    def points(self, res: int, t0: float | None = None,
               t1: float | None = None) -> list:
        return read_points(self.dir, res, t0, t1)

    def status(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "pid": self.pid,
                    "resolutions": list(self.resolutions),
                    "sources": sorted({s for _, s in self._state}),
                    "dropped": self._dropped,
                    "gc_removed": self._gc_removed}

    def close(self) -> None:
        with self._lock:
            for ring in self._rings.values():
                if ring["f"] is not None:
                    ring["f"].close()
                    ring["f"] = None


def open_store(cfg) -> SeriesStore | None:
    """A SeriesStore for a config, or None when history is disabled
    (``FIREBIRD_SERIES=0`` / ``FIREBIRD_TELEMETRY=0``) or homeless (no
    file-backed artifact dir) — the zero-cost path writes nothing."""
    if getattr(cfg, "series", 0) <= 0 or cfg.telemetry <= 0:
        return None
    d = series_dir(cfg)
    if d is None:
        return None
    return SeriesStore(d, points_per_segment=cfg.series,
                       segments=cfg.series_segments)


# ---------------------------------------------------------------------------
# Read side: any process can query the rings without a writer instance
# ---------------------------------------------------------------------------

def _parse_ring_name(path: str) -> tuple | None:
    """``(res, pid, seg)`` from a ring file name
    (``series.<res>.<pid>.<seg>.jsonl``), or None for anything else
    the glob happened to match."""
    parts = os.path.basename(path).split(".")
    if len(parts) != 5 or parts[0] != "series" or parts[4] != "jsonl":
        return None
    try:
        return int(parts[1]), int(parts[2]), int(parts[3])
    except ValueError:
        return None


def _scan_files(directory: str) -> dict:
    """path -> parseable point lines for every ring file under
    ``directory`` (all pids, all segments); torn tail lines skipped,
    not fatal."""
    out: dict = {}
    for path in sorted(glob.glob(os.path.join(directory, SERIES_GLOB))):
        pts: list = []
        try:
            with open(path) as f:
                for line in f:
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        continue            # torn tail line
                    if not isinstance(doc, dict) \
                            or doc.get("kind") != "pt":
                        continue
                    pts.append(doc)
        except OSError:
            continue
        out[path] = pts
    return out


def _read_raw(directory: str) -> list:
    """Every parseable point line under ``directory``."""
    out: list = []
    for pts in _scan_files(directory).values():
        out.extend(pts)
    return out


def read_points(directory: str, res: int, t0: float | None = None,
                t1: float | None = None) -> list:
    """Retained points at one resolution within ``(t0, t1]``, deduped
    keep-latest per (bucket, source), sorted by snapshot time.  Reads
    every ingester's rings — two collectors ingesting concurrently
    still query as one history."""
    best: dict = {}
    for pt in _read_raw(directory):
        if pt.get("res") != int(res):
            continue
        t = float(pt.get("t", 0.0))
        if (t0 is not None and t <= t0) or (t1 is not None and t > t1):
            continue
        key = (pt.get("b"), pt.get("src"))
        cur = best.get(key)
        if cur is None or t > float(cur.get("t", 0.0)):
            best[key] = pt
    return sorted(best.values(), key=lambda p: (p["t"], str(p["src"])))


def sources(points: list) -> list:
    return sorted({p.get("src") for p in points})


def _by_src(points: list) -> dict:
    out: dict = {}
    for p in points:
        out.setdefault(p.get("src"), []).append(p)
    return out       # read_points order is time-sorted already


# -- windowed aggregates (the burn-rate substrate) --------------------------
#
# Counters and histogram bucket counts are CUMULATIVE per source
# process, so a window's activity is the delta between its edge points,
# summed per source and only then across sources — the fleet view is
# re-derived from merged host series, never one host's percentile.

def counter_window(points: list, name: str, t0: float,
                   t1: float) -> float | None:
    """Sum-over-sources of each source's counter delta across
    ``(t0, t1]``.  The baseline is the source's last point at or before
    ``t0`` (a source born inside the window baselines at zero — its
    whole cumulative count happened since start).  None when NO source
    has a point inside the window (an empty window is 'no data', never
    zero activity — obs/slo.py's no-data-is-zero-burn rule needs the
    distinction)."""
    total = None
    for pts in _by_src(points).values():
        inside = [p for p in pts if t0 < p["t"] <= t1]
        if not inside:
            continue
        before = [p for p in pts if p["t"] <= t0]
        base = (before[-1]["m"].get("counters") or {}).get(name, 0.0) \
            if before else 0.0
        end = (inside[-1]["m"].get("counters") or {}).get(name, 0.0)
        total = (total or 0.0) + max(float(end) - float(base), 0.0)
    return total


def hist_window(points: list, name: str, t0: float, t1: float) -> dict | None:
    """Merged histogram activity across ``(t0, t1]``: summed per-source
    deltas of count / sum / bucket_counts (same bounds).  None when no
    source has in-window data for the metric."""
    out = None
    for pts in _by_src(points).values():
        inside = [p for p in pts
                  if t0 < p["t"] <= t1 and name in p["m"]["histograms"]]
        if not inside:
            continue
        end = inside[-1]["m"]["histograms"][name]
        before = [p for p in pts
                  if p["t"] <= t0 and name in p["m"]["histograms"]]
        base = before[-1]["m"]["histograms"][name] if before else None
        bounds = list(end.get("bucket_bounds") or ())
        counts = [float(c) for c in (end.get("bucket_counts") or ())]
        n, s = float(end.get("count", 0)), float(end.get("sum", 0.0))
        if base is not None \
                and list(base.get("bucket_bounds") or ()) == bounds:
            bc = base.get("bucket_counts") or ()
            counts = [max(c - float(b), 0.0)
                      for c, b in zip(counts, bc)]
            n = max(n - float(base.get("count", 0)), 0.0)
            s = s - float(base.get("sum", 0.0))
        if out is None:
            out = {"count": 0.0, "sum": 0.0, "bucket_bounds": bounds,
                   "bucket_counts": [0.0] * len(counts)}
        if out["bucket_bounds"] == bounds \
                and len(out["bucket_counts"]) == len(counts):
            out["bucket_counts"] = [a + b for a, b
                                    in zip(out["bucket_counts"], counts)]
        out["count"] += n
        out["sum"] += s
    return out


def hist_over_threshold(win: dict, threshold: float) -> float:
    """Observations above ``threshold`` in a :func:`hist_window` result:
    total count minus the cumulative count of buckets whose upper bound
    is <= threshold (bucket granularity — the same quantization the
    percentile estimates already live with)."""
    under = 0.0
    for bound, c in zip(win.get("bucket_bounds") or (),
                        win.get("bucket_counts") or ()):
        if float(bound) <= threshold:
            under += float(c)
    return max(float(win.get("count", 0)) - under, 0.0)


def gauge_samples(points: list, name: str, t0: float,
                  t1: float) -> list:
    """Every in-window gauge sample as ``(t, src, value)`` — budget
    math counts bad samples over total samples."""
    out = []
    for p in points:
        if not (t0 < p["t"] <= t1):
            continue
        v = (p["m"].get("gauges") or {}).get(name)
        if v is not None:
            out.append((p["t"], p.get("src"), float(v)))
    return out


def bucket_series(points: list, name: str, kind: str,
                  res: int) -> list:
    """Per-bucket values for sparklines: counters render as per-bucket
    deltas (activity), gauges as the fleet-merged sample, histograms as
    per-bucket observation counts.  Returns ``[(bucket, value), ...]``
    in bucket order; buckets with no data are absent (the renderer
    decides how to show gaps)."""
    by_bucket: dict = {}
    for p in points:
        by_bucket.setdefault(int(p["b"]), []).append(p)
    out = []
    for b in sorted(by_bucket):
        t1 = (b + 1) * int(res)
        t0 = b * int(res)
        if kind == "gauge":
            vals = [v for (_, _, v)
                    in gauge_samples(points, name, t0, t1)]
            if vals:
                out.append((b, obs_metrics.merge_gauge_values(name, vals)))
        elif kind == "histogram":
            win = hist_window(points, name, t0, t1)
            if win is not None:
                out.append((b, win["count"]))
        else:
            v = counter_window(points, name, t0, t1)
            if v is not None:
                out.append((b, v))
    return out

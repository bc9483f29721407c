"""Telemetry collector: per-process spools -> one fleet trace + attribution.

The port's own copy of the JAX package's ``obs/collect.py``, whole: the
spool (obs/spool.py) leaves each fleet process's telemetry on disk; this
module is the read side — ``trace collect`` merges every segment under
the spool directory (this package's segments, the JAX package's, or
both) into:

- **One Perfetto trace.**  Process- and thread-aware Chrome-trace JSON
  (``{"traceEvents": [...]}``, validated by obs.report.validate_trace):
  each OS process renders as its own Perfetto process track (named
  ``<role> <pid>``), each of its threads as a thread track, and every
  span event carries its ``trace`` id in args — so one scene's causal
  chain (watcher -> queue -> worker -> alert append -> delivery) reads
  as one filterable id across the whole fleet, including segments a
  SIGKILLed worker left behind.
- **Per-alert critical-path breakdowns.**  For every trace id that
  reached a durable alert append, the scene's measured
  ``acquisition_to_alert_seconds`` decomposes into consecutive stages
  (watch lag, queue wait, fetch, step, append, other; delivery rides on
  top once a webhook carries it out) — computed from the cross-process
  marks the fleet stamps at each hop, summing to the measured total by
  construction (``other`` is the explicit residual, never silently
  absorbed).
- **A fleet metric view.**  The latest metric snapshot per process,
  merged under the obs_report fleet policy (counters sum, histogram
  buckets add and percentiles re-derive, gauges per
  merge_gauge_values).

Spool lines that a crash tore mid-write are skipped, not fatal: a
telemetry reader must never refuse the exact artifact a crash produced.
"""

from __future__ import annotations

import glob
import json
import os

from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import spool as spool_mod

COLLECT_SCHEMA = "firebird-telemetry-collect/1"

# The critical-path stage catalog: consecutive wall-clock stages of one scene's
# publish -> durable-alert-append window, plus delivery past it.
CRITICAL_PATH_STAGES = ("watch_lag", "queue_wait", "fetch", "step",
                       "append", "other")


def read_events(directory: str) -> list[dict]:
    """Parse every spool segment under ``directory`` into a flat event
    list; each event gains ``role``/``pid`` (and ``run_id``) from its
    segment header.  Torn lines (a crash mid-write) are skipped."""
    events: list[dict] = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              spool_mod.SPOOL_GLOB))):
        role = pid = run_id = None
        try:
            with open(path) as f:
                for line in f:
                    try:
                        doc = json.loads(line)
                    except ValueError:
                        continue            # torn tail line
                    if not isinstance(doc, dict):
                        continue
                    if doc.get("kind") == "header":
                        role = doc.get("role")
                        pid = doc.get("pid")
                        run_id = doc.get("run_id")
                        continue
                    doc["role"], doc["pid"] = role, pid
                    if run_id is not None:
                        doc.setdefault("run_id", run_id)
                    events.append(doc)
        except OSError:
            continue
    return events


def processes(events: list[dict]) -> list[dict]:
    """The distinct (role, pid) processes behind an event list."""
    seen: dict[tuple, dict] = {}
    for ev in events:
        key = (ev.get("role"), ev.get("pid"))
        if key[1] is None:
            continue
        p = seen.setdefault(key, {"role": key[0], "pid": key[1],
                                  "run_id": ev.get("run_id"), "events": 0})
        p["events"] += 1
    return [seen[k] for k in sorted(seen, key=str)]


def build_chrome_trace(events: list[dict]) -> dict:
    """Merge spool span/mark events into process/thread-aware
    Chrome-trace JSON (absolute wall-clock microseconds re-based to the
    earliest event, so cross-process ordering is faithful)."""
    spans = [e for e in events if e.get("kind") == "span"
             and e.get("pid") is not None]
    marks = [e for e in events if e.get("kind") == "mark"
             and e.get("pid") is not None]
    times = [e["t0"] for e in spans] + [e["t"] for e in marks]
    epoch = min(times) if times else 0.0
    out: list[dict] = []
    named_pids: set = set()
    tids: dict[tuple, int] = {}

    def tid_of(ev) -> int:
        pid = ev["pid"]
        if pid not in named_pids:
            named_pids.add(pid)
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "tid": 0,
                        "args": {"name": f"{ev.get('role')} {pid}"}})
        key = (pid, ev.get("tid"))
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = sum(1 for k in tids if k[0] == pid)
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid,
                        "args": {"name": ev.get("thread")
                                 or f"tid {ev.get('tid')}"}})
        return tid

    for ev in sorted(spans + marks,
                     key=lambda e: e.get("t0", e.get("t", 0.0))):
        args = {}
        if ev.get("trace"):
            args["trace"] = ev["trace"]
        args.update({k: (v if isinstance(v, (int, float, bool))
                         else str(v))
                     for k, v in (ev.get("attrs") or {}).items()})
        if ev["kind"] == "span":
            rec = {"name": ev["name"], "ph": "X", "pid": ev["pid"],
                   "tid": tid_of(ev), "ts": (ev["t0"] - epoch) * 1e6,
                   "dur": ev["dur"] * 1e6}
        else:
            rec = {"name": ev["name"], "ph": "i", "s": "p",
                   "pid": ev["pid"], "tid": tid_of(ev),
                   "ts": (ev["t"] - epoch) * 1e6}
        if args:
            rec["args"] = args
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": {"producer": "firebird_tpu_torch.obs.collect",
                          "epoch_unix": epoch}}


def _first_mark(marks: list[dict], name: str) -> dict | None:
    cands = [m for m in marks if m["name"] == name]
    return min(cands, key=lambda m: m["t"]) if cands else None


def critical_paths(events: list[dict]) -> list[dict]:
    """Per-trace critical-path breakdowns for every trace id that
    reached a durable alert append.

    Stages are consecutive wall-clock intervals, so they sum to the
    appended-minus-published total EXACTLY (``other`` is the residual of
    the claim->append window not covered by fetch/step/append spans);
    ``measured_acq_to_alert`` is the very value the emitting process
    observed into ``acquisition_to_alert_seconds`` at the append,
    carried on the mark — the breakdown and the histogram cannot drift
    apart by more than the mark-to-observe clock skew."""
    by_trace: dict[str, dict] = {}
    for ev in events:
        tr = ev.get("trace")
        if not tr or ev.get("kind") not in ("span", "mark"):
            continue
        g = by_trace.setdefault(tr, {"spans": [], "marks": []})
        g["spans" if ev["kind"] == "span" else "marks"].append(ev)
    out = []
    for tr in sorted(by_trace):
        marks = by_trace[tr]["marks"]
        appended = _first_mark(marks, "alert_appended")
        if appended is None:
            continue
        attrs = appended.get("attrs") or {}
        enq = _first_mark(marks, "scene_enqueued")
        claimed = _first_mark(marks, "job_claimed")
        delivered = _first_mark(marks, "alert_delivered")
        published = attrs.get("published")
        if published is None and enq is not None:
            published = (enq.get("attrs") or {}).get("published")
        t_app = appended["t"]
        t_enq = enq["t"] if enq is not None else None
        t_clm = claimed["t"] if claimed is not None else None

        def span_sum(name: str) -> float:
            return sum(s["dur"] for s in by_trace[tr]["spans"]
                       if s["name"] == name and s["t0"] <= t_app)

        doc: dict = {"trace": tr, "alerts": attrs.get("alerts"),
                     "appended_at": t_app}
        stages: dict[str, float] = {}
        if published is not None and t_enq is not None \
                and t_clm is not None:
            stages["watch_lag"] = t_enq - published
            stages["queue_wait"] = t_clm - t_enq
            covered = 0.0
            for name, key in (("fetch", "fetch"), ("step", "step"),
                              ("alert", "append")):
                stages[key] = span_sum(name)
                covered += stages[key]
            stages["other"] = (t_app - t_clm) - covered
            doc["stages"] = {k: round(v, 6) for k, v in stages.items()}
            doc["total"] = round(t_app - published, 6)
            doc["published"] = published
        measured = attrs.get("acq_to_alert")
        if measured is not None:
            doc["measured_acq_to_alert"] = measured
        if delivered is not None and delivered["t"] >= t_app:
            doc["delivery"] = round(delivered["t"] - t_app, 6)
        doc["processes"] = sorted(
            {f"{e.get('role')}:{e.get('pid')}"
             for g in (by_trace[tr]["spans"], by_trace[tr]["marks"])
             for e in g if e.get("pid") is not None})
        out.append(doc)
    return out


def snap_events(directory: str) -> list[dict]:
    """Just the metric snapshots under ``directory`` (role/pid
    attributed, torn lines skipped) — the series store's ingest feed
    (obs/series.py): history wants every stamped snapshot, not only
    the newest per process like :func:`latest_snapshots`."""
    return [ev for ev in read_events(directory)
            if ev.get("kind") == "snap" and ev.get("pid") is not None]


def latest_snapshots(events: list[dict]) -> dict:
    """The newest metric snapshot per process:
    ``{"<role>:<pid>": {"t": ..., "metrics": {...}}}``."""
    out: dict[str, dict] = {}
    for ev in events:
        if ev.get("kind") != "snap" or ev.get("pid") is None:
            continue
        key = f"{ev.get('role')}:{ev.get('pid')}"
        if key not in out or ev["t"] > out[key]["t"]:
            out[key] = {"t": ev["t"], "metrics": ev.get("metrics") or {}}
    return out


def merge_snapshots(snaps: dict) -> dict:
    """Fold per-process snapshots into one fleet view under the
    obs_report merge policy: counters sum, histogram buckets add (and
    percentiles re-derive), gauges combine per their declared policy."""
    shards = [s["metrics"] for s in snaps.values()]
    counters: dict[str, float] = {}
    gauges: dict[str, list] = {}
    hists: dict[str, list] = {}
    for m in shards:
        for n, v in (m.get("counters") or {}).items():
            counters[n] = counters.get(n, 0) + v
        for n, v in (m.get("gauges") or {}).items():
            gauges.setdefault(n, []).append(v)
        for n, h in (m.get("histograms") or {}).items():
            hists.setdefault(n, []).append(h)
    return {
        "counters": dict(sorted(counters.items())),
        "gauges": {n: obs_metrics.merge_gauge_values(n, vs)
                   for n, vs in sorted(gauges.items())},
        "histograms": {n: obs_metrics.merge_histogram_snapshots(hs)
                       for n, hs in sorted(hists.items())},
    }


def collect(directory: str) -> dict:
    """The full collected artifact for a spool directory."""
    events = read_events(directory)
    snaps = latest_snapshots(events)
    return {
        "schema": COLLECT_SCHEMA,
        "spool_dir": directory,
        "processes": processes(events),
        "trace": build_chrome_trace(events),
        "critical_paths": critical_paths(events),
        "metrics": merge_snapshots(snaps),
        "snapshots": snaps,
    }


def write(doc: dict, path: str) -> str:
    """Write a collected artifact (atomic tmp+rename)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    os.replace(tmp, path)
    return path

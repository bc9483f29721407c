"""Per-run report artifact: obs_report.json build, write, and validation.

The port's own copy of the JAX package's ``obs/report.py``.  One JSON
document per pipeline run — metrics snapshot (counters, gauges, latency
histograms), span summary table, SLO verdicts, device-profile block, run
identity and, beside the JAX package's keys, a ``device`` block (the
card's name and memory and the process's peak allocation, or the CPU) —
written next to the results store.  Under one process per card, each
process writes its own shard (``obs_report.host<i>.json``) and process 0
merges them into the fleet report.  ``validate_report`` /
``validate_trace`` / ``validate_driver_artifacts`` are the shared schema
checks, equal to the JAX package's.
"""

from __future__ import annotations

import datetime
import json
import os

SCHEMA = "firebird-obs-report/1"

# Stage keys a driver run is expected to populate (the obs-smoke contract):
# ingest, kernel, and store latencies.  Kept here — not in the smoke tool —
# so the driver tests and the Makefile target assert the same contract.
DRIVER_STAGE_HISTOGRAMS = (
    "ingest_chip_seconds",
    "pipeline_fetch_seconds",
    "pipeline_pack_seconds",
    "pipeline_stage_seconds",
    "pipeline_dispatch_seconds",
    "pipeline_drain_seconds",
    "pipeline_d2h_seconds",
    "store_write_seconds",
    "store_flush_seconds",
    "kernel_first_call_seconds",
)
DRIVER_SPAN_NAMES = ("fetch", "pack", "stage", "dispatch", "drain", "d2h",
                     "transfer")

# THE span-name catalog: every tracing.span(...) call site in the
# codebase must use a name declared here, and every declared name must
# still have a call site — firebird-lint's span-name rules check both
# directions against this literal AND the OBSERVABILITY.md span table
# (the metric-table pattern), so a new span cannot ship undocumented
# and a renamed one cannot leave a stale row.  Keep it a literal tuple:
# the linter parses it from source.
SPAN_NAMES = (
    "alert",
    "d2h",
    "deliver",
    "dispatch",
    "drain",
    "fetch",
    "first_dispatch",
    "fleet_job",
    "pack",
    "probe_cycle",
    "profile",
    "publish",
    "stage",
    "step",
    "store_flush",
    "store_write",
    "transfer",
    "warm_compile",
    "watch_poll",
)


def build_report(*, registry=None, tracer=None, run: dict | None = None,
                 run_counters: dict | None = None) -> dict:
    """Assemble the report dict from live objects (no I/O)."""
    from firebird_tpu_torch.obs import metrics as m
    from firebird_tpu_torch.obs import profiling
    from firebird_tpu_torch.obs import server as obs_server
    from firebird_tpu_torch.obs import slo as slomod

    reg = registry if registry is not None else m.get_registry()
    metrics = reg.snapshot()
    # SLO + device-profile blocks are structurally ALWAYS present (the
    # obs-smoke contract): no-data objectives report ok=null, a run
    # without profile windows reports the zero attribution.
    st = obs_server.current()
    wd_snap = None
    spec = None
    if st is not None:
        spec = getattr(st, "slo_spec", None)
        if st.watchdog is not None:
            wd_snap = st.watchdog.snapshot()
    rep = {
        "schema": SCHEMA,
        "generated_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "run": run or {},
        "metrics": metrics,
        "spans": tracer.summary() if tracer is not None else {},
        "slo": slomod.evaluate_snapshot(metrics, watchdog=wd_snap,
                                        spec=spec),
        "profile": profiling.report_block(),
    }
    if run_counters:
        rep["run_counters"] = run_counters
    try:
        rep["device"] = device_block((run or {}).get("device"))
    except Exception as e:
        rep["device"] = {"error": f"{type(e).__name__}: {e}"}
    return rep


def write_report(path: str, **kw) -> dict:
    """build_report + atomic write (tmp+rename); returns the report."""
    rep = build_report(**kw)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rep, f, indent=1)
    os.replace(tmp, path)
    return rep


def validate_report(rep: dict) -> None:
    """Raise ValueError unless ``rep`` is a structurally valid report."""
    if not isinstance(rep, dict):
        raise ValueError("report is not a JSON object")
    if rep.get("schema") != SCHEMA:
        raise ValueError(f"report schema {rep.get('schema')!r} != {SCHEMA!r}")
    met = rep.get("metrics")
    if not isinstance(met, dict):
        raise ValueError("report has no metrics snapshot")
    for kind in ("counters", "gauges", "histograms"):
        if not isinstance(met.get(kind), dict):
            raise ValueError(f"metrics snapshot missing {kind!r}")
    for name, h in met["histograms"].items():
        if not isinstance(h, dict) or "count" not in h:
            raise ValueError(f"histogram {name!r} snapshot malformed")
        if h["count"] > 0 and not all(k in h for k in ("p50", "p95", "p99")):
            raise ValueError(f"histogram {name!r} missing percentiles")
    if not isinstance(rep.get("spans"), dict):
        raise ValueError("report has no span summary")


def validate_trace(trace: dict) -> None:
    """Raise ValueError unless ``trace`` is valid Chrome-trace JSON (the
    subset Perfetto's JSON importer requires)."""
    if not isinstance(trace, dict) \
            or not isinstance(trace.get("traceEvents"), list):
        raise ValueError("trace is not {'traceEvents': [...]} JSON")
    for ev in trace["traceEvents"]:
        if not isinstance(ev, dict) or "ph" not in ev or "name" not in ev:
            raise ValueError(f"malformed trace event: {ev!r}")
        if ev["ph"] == "X" and not ("ts" in ev and "dur" in ev):
            raise ValueError(f"complete event missing ts/dur: {ev!r}")


def validate_driver_artifacts(trace: dict, rep: dict) -> None:
    """The full obs-smoke contract over a driver run's two artifacts —
    schema validity plus the stage-key coverage — shared by ``make
    obs-smoke`` (tools/obs_smoke.py) and the driver smoke test so the
    contract cannot drift between them.  Raises ValueError."""
    validate_trace(trace)
    names = {e.get("name") for e in trace["traceEvents"]}
    missing = [n for n in DRIVER_SPAN_NAMES if n not in names]
    if missing:
        raise ValueError(f"trace missing span names {missing}")
    validate_report(rep)
    hists = rep["metrics"]["histograms"]
    missing = [k for k in DRIVER_STAGE_HISTOGRAMS
               if k not in hists or hists[k]["count"] < 1]
    if missing:
        raise ValueError(f"report missing stage histograms {missing}")


def default_report_path(store_path: str) -> str:
    """obs_report.json next to the results store."""
    return os.path.join(os.path.dirname(os.path.abspath(store_path)),
                        "obs_report.json")


# ---------------------------------------------------------------------------
# Multi-host aggregation: per-process shards -> one fleet report
# ---------------------------------------------------------------------------

def shard_report_path(path: str, process_index: int) -> str:
    """Per-process shard next to the fleet report:
    obs_report.json -> obs_report.host<N>.json."""
    root, ext = os.path.splitext(path)
    return f"{root}.host{int(process_index)}{ext or '.json'}"


def _process_info() -> tuple[int, int]:
    """(process_count, process_index) from ``parallel.dist``; (1, 0) for a
    single-process run."""
    from firebird_tpu_torch.parallel import dist

    return dist.process_count(), dist.process_index()


def device_block(device=None) -> dict:
    """The report's ``device`` block: the card's name, its memory and the
    process's peak allocation on it (``torch.cuda.max_memory_allocated``),
    or ``{"platform": "cpu"}`` for a run on the CPU.  ``device`` is the
    run's device (default: the current card when CUDA is in use)."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return {"platform": "cpu"}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {"platform": "cpu"}
    idx = dev.index if dev is not None and dev.index is not None \
        else torch.cuda.current_device()
    props = torch.cuda.get_device_properties(idx)
    return {"platform": "gpu", "name": torch.cuda.get_device_name(idx),
            "index": idx, "memory_bytes": int(props.total_memory),
            "max_memory_allocated": int(torch.cuda.max_memory_allocated(idx))}


def clear_stale_artifacts(cfg) -> None:
    """Run-start cleanup for reused report directories (rolling soak).

    Merge-time shard discovery is by filename, so a shard left by a
    PREVIOUS run in the same directory would satisfy the wait loop
    instantly and contaminate the new fleet report with stale counters.
    Every process therefore deletes its OWN shard before doing any work,
    and process 0 also drops the old merged report — by the time any
    process can *write* a new shard (a full detect pass later), every
    peer has long since passed this point (all of them crossed the
    process-group bring-up before their run began).  Never
    raises: cleanup must not fail a run over a read-only artifact dir.
    """
    try:
        path = run_report_path(cfg)
        if path is None:
            return
        n_proc, proc_idx = _process_info()
        if n_proc <= 1:
            return
        stale = [shard_report_path(path, proc_idx)]
        if proc_idx == 0:
            stale.append(path)
        for p in stale:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
    except OSError:
        pass


def merge_reports(reports: list[dict]) -> dict:
    """Combine per-host report shards into one fleet report.

    Merge policy (declared with the metric kinds in obs/metrics.py):
    counters sum; histogram bucket counts add and percentiles recompute
    from the merged buckets; gauges combine per
    ``metrics.gauge_merge_policy`` (sum/max/min by name); span tables sum
    counts/totals and keep the fleet max; run_counters sum, with
    ``elapsed_sec`` as the fleet max (wall time, not CPU time) and the
    ``*_per_sec`` rates recomputed against it.
    """
    from firebird_tpu_torch.obs import metrics as m

    if not reports:
        raise ValueError("no report shards to merge")
    out = {
        "schema": SCHEMA,
        "generated_at": max(r.get("generated_at", "") for r in reports),
        "run": dict(reports[0].get("run", {})),
    }
    mets = [r.get("metrics", {}) for r in reports]
    counters: dict = {}
    for met in mets:
        for k, v in met.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
    gauges: dict = {}
    for name in sorted({k for met in mets for k in met.get("gauges", {})}):
        vals = [met["gauges"][name] for met in mets
                if name in met.get("gauges", {})]
        gauges[name] = m.merge_gauge_values(name, vals)
    hists: dict = {}
    for name in sorted({k for met in mets
                        for k in met.get("histograms", {})}):
        hists[name] = m.merge_histogram_snapshots(
            [met["histograms"][name] for met in mets
             if name in met.get("histograms", {})])
    out["metrics"] = {
        "elapsed_sec": max((met.get("elapsed_sec", 0.0) for met in mets),
                           default=0.0),
        "counters": counters, "gauges": gauges, "histograms": hists,
    }
    spans: dict = {}
    for r in reports:
        for name, s in (r.get("spans") or {}).items():
            t = spans.setdefault(name, {"count": 0, "total_ms": 0.0,
                                        "max_ms": 0.0})
            t["count"] += s.get("count", 0)
            t["total_ms"] += s.get("total_ms", 0.0)
            t["max_ms"] = max(t["max_ms"], s.get("max_ms", 0.0))
    for s in spans.values():
        s["mean_ms"] = round(s["total_ms"] / max(s["count"], 1), 3)
        s["total_ms"] = round(s["total_ms"], 3)
        s["max_ms"] = round(s["max_ms"], 3)
    out["spans"] = spans
    # SLO: RE-evaluated over the merged histograms (per-host verdicts
    # cannot be combined — a fleet p99 is not any host's p99); the first
    # shard's spec wins (every host of a fleet launch shares one config).
    from firebird_tpu_torch.obs import slo as slomod

    specs = [r.get("slo", {}).get("spec") for r in reports
             if r.get("slo")]
    out["slo"] = slomod.evaluate_snapshot(
        out["metrics"], spec=specs[0] if specs else None)
    # Device-profile attribution sums across hosts; windows concatenate
    # (each already names its host-local artifact directory).
    from firebird_tpu_torch.obs import profiling

    prof = {"windows": [], "in_flight": False,
            "device_time": profiling.empty_attribution("none"), "dir": None}
    sources = set()
    for r in reports:
        p = r.get("profile")
        if not p:
            continue
        prof["windows"].extend(p.get("windows", ()))
        dt = p.get("device_time") or {}
        sources.add(dt.get("source"))
        for k, v in dt.items():
            if isinstance(v, (int, float)):
                prof["device_time"][k] = round(
                    prof["device_time"].get(k, 0) + v, 3)
    # Shard provenance survives the merge: any real capture -> 'trace';
    # otherwise any failed shard -> 'error' (a fleet whose every
    # profiler broke must not read as one that never profiled).
    if "trace" in sources:
        prof["device_time"]["source"] = "trace"
    elif "error" in sources:
        prof["device_time"]["source"] = "error"
    elif "no-device-events" in sources:
        prof["device_time"]["source"] = "no-device-events"
    out["profile"] = prof
    rcs = [r["run_counters"] for r in reports if r.get("run_counters")]
    if rcs:
        merged: dict = {}
        elapsed = max(rc.get("elapsed_sec", 0.0) for rc in rcs)
        for rc in rcs:
            for k, v in rc.items():
                if k == "elapsed_sec" or k.endswith("_per_sec"):
                    continue
                merged[k] = merged.get(k, 0) + v
        for k in list(merged):
            if elapsed > 0:
                merged[f"{k}_per_sec"] = merged[k] / elapsed
        merged["elapsed_sec"] = elapsed
        out["run_counters"] = merged
    out["fleet"] = {
        "hosts": len(reports),
        "host_runs": [{k: r.get("run", {}).get(k)
                       for k in ("run_id", "host", "process_id", "chips")}
                      for r in reports],
    }
    return out


def merge_fleet_report(path: str, n_processes: int,
                       timeout: float | None = None,
                       poll_sec: float = 0.25) -> dict | None:
    """Process 0's half of the aggregation: wait (bounded) for every
    host's shard next to ``path``, merge whatever arrived, atomically
    write the fleet report to ``path``.  Returns the merged report, or
    None when not even one shard exists.  Hosts that never delivered are
    listed under ``fleet.missing`` rather than failing the merge — a
    crashed peer must not take down the survivors' telemetry."""
    import time as _time

    if timeout is None:
        from firebird_tpu_torch.config import env_knob

        timeout = float(env_knob("FIREBIRD_OBS_MERGE_TIMEOUT"))
    paths = [shard_report_path(path, j) for j in range(n_processes)]
    deadline = _time.monotonic() + timeout
    while not all(os.path.exists(p) for p in paths) \
            and _time.monotonic() < deadline:
        _time.sleep(poll_sec)
    shards, missing = [], []
    for j, p in enumerate(paths):
        try:
            shards.append(json.load(open(p)))
        except (OSError, ValueError):
            missing.append(j)
    if not shards:
        return None
    rep = merge_reports(shards)
    rep["fleet"]["expected_hosts"] = n_processes
    if missing:
        rep["fleet"]["missing"] = missing
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rep, f, indent=1)
    os.replace(tmp, path)
    return rep


def load_fleet_report(directory: str) -> dict | None:
    """The merged view of a run directory, for tooling (soak_report,
    bench).

    Prefers the fleet obs_report.json — UNLESS it recorded missing hosts
    whose shards have since landed (process 0's merge wait is one-shot
    at its run end; a host draining past FIREBIRD_OBS_MERGE_TIMEOUT
    writes its shard after the merge), in which case the shards on disk
    are re-merged so the late host's contribution is not undercounted
    forever.  When only shards exist (process 0 died before merging),
    they merge in memory.  None when the directory holds no report."""
    import glob as _glob

    shards = []
    for p in sorted(_glob.glob(
            os.path.join(directory, "obs_report.host*.json"))):
        try:
            shards.append(json.load(open(p)))
        except (OSError, ValueError):
            continue
    merged_path = os.path.join(directory, "obs_report.json")
    if os.path.exists(merged_path):
        try:
            merged = json.load(open(merged_path))
        except (OSError, ValueError):
            merged = None
        if merged is not None:
            fleet = merged.get("fleet") or {}
            stale = fleet.get("missing") and len(shards) > fleet.get(
                "hosts", 0)
            if not stale:
                return merged
    return merge_reports(shards) if shards else None


def run_report_path(cfg) -> str | None:
    """Where a driver run's report goes, or None to skip.

    cfg.obs_report: "0" never; a path always; "" auto — next to the store
    for file-backed backends, skipped for 'memory' (tests and embedded
    uses must not litter the CWD with artifacts nobody asked for).
    """
    if cfg.obs_report == "0":
        return None
    if cfg.obs_report:
        return cfg.obs_report
    if cfg.store_backend == "memory":
        return None
    return default_report_path(cfg.store_path)


def finish_run(cfg, *, tracer=None, run: dict | None = None,
               run_counters: dict | None = None) -> dict:
    """End-of-run artifact emission shared by the batch and streaming
    drivers: save the tracer's Chrome trace (when one ran) and write
    obs_report.json per cfg.obs_report policy.  Returns {artifact: path}
    for the paths actually written.  Never raises — a failed telemetry
    write must not fail a run whose results already landed."""
    from firebird_tpu_torch.obs import logger, profiling, tracing

    log = logger("change-detection")
    # Flush any in-flight device-profile window FIRST so the report's
    # profile block carries its attribution (never raises).
    profiling.close_active()
    out = {}
    # Independent try blocks: an unwritable trace path must not also
    # drop the report (or vice versa) when its own path is writable.
    n_proc, proc_idx = _process_info()
    try:
        if tracer is not None:
            path = tracing.resolve_path(cfg.trace or "1", cfg.store_path)
            if n_proc > 1:
                # One trace per process (trace.host<i>.json): the
                # processes of a launch share the artifact directory.
                path = shard_report_path(path, proc_idx)
            out["trace"] = tracer.save(path)
    except OSError as e:
        log.error("trace write failed: %s", e)
    try:
        path = run_report_path(cfg)
        if path is not None:
            if n_proc <= 1:
                write_report(path, tracer=tracer, run=run,
                             run_counters=run_counters)
                out["report"] = path
            else:
                # One process per card: every process writes its own
                # shard (obs_report.host<N>.json); process 0 then waits
                # for the others and merges into the single
                # obs_report.json that tooling reads — the per-process
                # view is preserved in the shards.
                shard = shard_report_path(path, proc_idx)
                write_report(shard, tracer=tracer, run=run,
                             run_counters=run_counters)
                out["report_shard"] = shard
                if proc_idx == 0:
                    merged = merge_fleet_report(
                        path, n_proc,
                        timeout=getattr(cfg, "obs_merge_timeout", None))
                    if merged is not None:
                        out["report"] = path
                        got = merged["fleet"]["hosts"]
                        if got < n_proc:
                            log.warning(
                                "fleet report merged %d/%d host shards "
                                "(missing hosts crashed or timed out)",
                                got, n_proc)
    except OSError as e:
        log.error("obs report write failed: %s", e)
    return out

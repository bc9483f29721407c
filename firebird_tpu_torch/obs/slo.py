"""SLO tracking: declared objectives evaluated against live histograms.

The obs stack records every latency but nothing *judges* them — an
operator watching ``/progress`` must remember what "healthy" looks like
for each number.  This module makes the objectives declarations: a spec
(``FIREBIRD_SLO`` / ``Config.slo``) names each objective and its
target, evaluation reads the SAME metric snapshots the report and
``/metrics`` expose, and the verdict is served live at ``/slo``
(obs/server.py) and summarized in every ``obs_report.json`` (fleet
merges re-evaluate over the merged histograms).

Objectives (the spec grammar is ``name=target;name=target``; targets
are seconds):

``batch_p95``
    p95 of ``pipeline_drain_seconds`` — the steady-state batch wall
    time as the drain thread sees it (device wait + egress; dispatch is
    asynchronous so this histogram is where a slow batch shows up).
``serve_p99``
    p99 of ``serve_request_seconds`` — the query layer's tail latency,
    admission wait included.
``freshness``
    Seconds since the last drained batch (the watchdog's
    ``last_beat_age_sec``) — the liveness half of an alerting-grade
    freshness promise: results are at most this stale.
``changefeed_lag``
    The ``serve_changefeed_lag_seconds`` gauge — how far behind the
    write feed a serve replica's cache-coherence loop ran at its last
    poll (docs/SERVING.md's staleness bound, measured).

An objective whose metric has no data reports ``ok: null`` ("no_data")
rather than passing or failing — a serve SLO must not fail a batch run
that never served a request.  ``FIREBIRD_SLO=0`` disables evaluation.

Error budgets (the durable half, over obs/series.py history): a budget
spec (``FIREBIRD_SLO_BUDGET``) declares target ratios over rolling
windows — ``alert_freshness<60@99.9/28d`` reads "the p95 source metric
stays under 60s for 99.9% of observations over 28 days".  Evaluation
replays the series store's merged per-host history (fleet verdicts are
re-derived from summed per-source deltas, never one host's percentile)
into three windows: the full budget window (exhaustion: bad >
(1-target) x total) and a fast+slow burn-rate pair (paging signal: both
windows burning >= ``FIREBIRD_SLO_BURN`` at once — the multi-window
rule that filters blips without missing slow leaks).  A window with no
data contributes ZERO burn — not a violation, not credit — and is named
in ``empty_windows`` so an operator can tell "healthy" from "blind".
Budget-state transitions append durably to ``slo_events.jsonl`` next to
the series rings.

The port's own copy of the JAX package's ``obs/slo.py``, whole: the live
objectives, the budget grammar, the burn-rate evaluation and the event
log's format (``firebird-slo-event/1``), so either package's verdicts and
events read the other's series directory alike.
"""

from __future__ import annotations

import json
import os
import time

DEFAULT_SPEC = ("batch_p95=30;serve_p99=2;freshness=600;"
                "alert_freshness=60;changefeed_lag=10;drain_eta=3600")

# The default error budgets (FIREBIRD_SLO_BUDGET): the alerting-grade
# freshness promise, the serve tail, and the black-box prober's failure
# ratio.  Objectives whose metrics never report (no prober running, no
# serve replica) contribute zero burn — a batch-only deployment is
# "no data", never "burned".
DEFAULT_BUDGET_SPEC = ("alert_freshness<60@99.9/28d;"
                       "serve_p99<2@99/7d;probe_errors@99/1d;"
                       "fanout_p99<30@99/7d")

# Multi-window burn-rate defaults (FIREBIRD_SLO_FAST_SEC /
# FIREBIRD_SLO_SLOW_SEC / FIREBIRD_SLO_BURN): page when the error rate
# runs >= 14.4x the budget rate over BOTH the 5-minute and 1-hour
# windows — at that burn a 28d budget dies in under 2 days, fast enough
# to matter, and the slow window filters one-batch blips.
DEFAULT_FAST_SEC = 300.0
DEFAULT_SLOW_SEC = 3600.0
DEFAULT_BURN = 14.4

BUDGET_EVENTS_FILE = "slo_events.jsonl"
BUDGET_EVENT_SCHEMA = "firebird-slo-event/1"

# name -> (kind, metric/field, stat, description)
OBJECTIVES = {
    "batch_p95": ("histogram", "pipeline_drain_seconds", "p95",
                  "steady-state batch seconds (device wait + egress, p95)"),
    "serve_p99": ("histogram", "serve_request_seconds", "p99",
                  "serve /v1 request seconds (admission wait incl., p99)"),
    "freshness": ("watchdog", "last_beat_age_sec", None,
                  "seconds since the last drained batch"),
    # The alerting-grade promise (docs/ALERTS.md, docs/STREAMING.md): a
    # new acquisition's confirmed break is VISIBLE on the alert feed
    # within the target.  The metric field is a fallback CHAIN: the
    # watcher-fed end-to-end histogram (scene publish time -> durable
    # alert append, acquisition_to_alert_seconds) judges when it has
    # data; runs without a watcher (manual `firebird stream`) fall back
    # to the stream-local alert_visible_seconds leg (per-chip ingest
    # start -> durable commit) rather than reporting no_data.
    "alert_freshness": ("histogram",
                        ("acquisition_to_alert_seconds",
                         "alert_visible_seconds"), "p95",
                        "scene publish (or stream ingest start) -> "
                        "alert-visible seconds (p95)"),
    # The replica-coherence promise (docs/SERVING.md): a serve replica
    # applies a changefeed record — and so stops serving stale cached
    # answers for the touched chips — within the target.  The gauge is
    # the age of the newest record the last poll applied (0 = caught
    # up), so the objective judges the serving staleness bound the
    # replica fleet actually ran at.
    "changefeed_lag": ("gauge", "serve_changefeed_lag_seconds", None,
                       "replica changefeed apply lag seconds "
                       "(newest-applied record age at last poll)"),
    # The elastic-fleet promise (docs/ROBUSTNESS.md "Elastic
    # operation"): at the capacity the supervisor is running, the open
    # batch backlog drains within the target.  The gauge is the
    # supervisor's per-tick open-work / trailing-ack-rate estimate; a
    # run with no supervisor has no gauge and reports no_data.
    "drain_eta": ("gauge", "queue_drain_eta_seconds", None,
                  "estimated seconds to drain the open batch backlog "
                  "at the observed ack rate"),
    # The black-box view (obs/prober.py): outage detection must not
    # depend on the sick process reporting itself, so these judge what
    # an outside canary measured — serve latency from a real GET, the
    # scene-drop -> SSE-alert round trip, the webhook sink round trip,
    # and the all-surfaces failure ratio (a "ratio" kind divides two
    # counters; its value/target are fractions, not seconds).
    "probe_p99": ("histogram", "probe_serve_seconds", "p99",
                  "black-box serve GET seconds as the canary prober "
                  "measured them (p99)"),
    "probe_alert": ("histogram", "probe_alert_seconds", "p95",
                    "black-box scene drop -> SSE alert seconds (p95)"),
    "probe_webhook": ("histogram", "probe_webhook_seconds", "p95",
                      "black-box scene drop -> webhook sink seconds "
                      "(p95)"),
    "probe_errors": ("ratio", ("probe_failures", "probe_attempts"), None,
                     "black-box probe failure ratio (failed probes / "
                     "attempted probes, all surfaces)"),
    # The fanout promise (docs/ALERTS.md "Fanout plane"): a rolled-up
    # shard of new alerts is DRAINED — every shard subscriber's cursor
    # at the job's bound — within the target.  The histogram is
    # observed by the fleet worker's fanout handler (rollup stamp ->
    # drain done); deployments with no fanout jobs report no_data.
    "fanout_p99": ("histogram", "fanout_completion_seconds", "p99",
                   "alert rollup -> shard fanout drained seconds (p99)"),
}


def parse_spec(spec: str) -> list[tuple[str, float]]:
    """``"batch_p95=30;serve_p99=2"`` -> [(name, target), ...].

    Raises ValueError on unknown objective names or unparseable targets
    — Config validates at construction (the FIREBIRD_FAULTS fail-fast
    rationale: a typo'd spec silently evaluating nothing is worse than
    a crash at bring-up).
    """
    out: list[tuple[str, float]] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, target = part.partition("=")
        name = name.strip()
        if not sep:
            raise ValueError(f"SLO objective {part!r} is not name=target")
        if name not in OBJECTIVES:
            raise ValueError(
                f"unknown SLO objective {name!r}; known: "
                f"{sorted(OBJECTIVES)}")
        try:
            t = float(target)
        except ValueError as e:
            raise ValueError(
                f"SLO target {target!r} for {name!r} is not a number"
            ) from e
        if t <= 0:
            raise ValueError(f"SLO target for {name!r} must be > 0, got {t}")
        out.append((name, t))
    return out


def evaluate_snapshot(metrics: dict, watchdog: dict | None = None,
                      spec: str | None = None) -> dict:
    """Evaluate the spec against a metrics *snapshot* (the JSON form —
    ``MetricsRegistry.snapshot()`` or a report's ``metrics`` block, so
    live endpoints, per-host shards, and merged fleet reports all
    evaluate identically).  ``watchdog`` is a watchdog snapshot for the
    freshness objective (None: no_data).

    Returns ``{"spec", "ok", "violations", "objectives": [...]}`` —
    ``ok`` is True only when no evaluated objective is violated
    (no_data objectives neither pass nor fail).
    """
    if spec is None or spec == "":
        spec = DEFAULT_SPEC
    if spec == "0":
        return {"spec": "0", "ok": True, "violations": 0, "objectives": []}
    objectives = []
    violations = 0
    hists = (metrics or {}).get("histograms", {})
    for name, target in parse_spec(spec):
        kind, key, stat, desc = OBJECTIVES[name]
        value = None
        if kind == "histogram":
            # A tuple key is a fallback chain: the first histogram with
            # observations judges the objective (alert_freshness above).
            for key in (key if isinstance(key, tuple) else (key,)):
                h = hists.get(key) or {}
                if h.get("count", 0) > 0:
                    value = h.get(stat)
                    break
        elif kind == "gauge":
            # An absent gauge is no_data (a batch run with no serve
            # replica must not pass or fail the coherence objective).
            value = ((metrics or {}).get("gauges") or {}).get(key)
        elif kind == "ratio":
            # Two cumulative counters; zero attempts is no_data (a run
            # with no prober must not pass or fail the probe ratio).
            ctr = (metrics or {}).get("counters") or {}
            den = float(ctr.get(key[1], 0) or 0)
            if den > 0:
                value = min(float(ctr.get(key[0], 0) or 0), den) / den
        else:                            # watchdog field
            if watchdog is not None:
                value = watchdog.get(key)
        ok = None if value is None else bool(value <= target)
        if ok is False:
            violations += 1
        obj = {"name": name, "target_sec": target, "value_sec": value,
               "ok": ok, "description": desc}
        if kind == "histogram":
            obj["metric"] = key
            obj["stat"] = stat
            # Exemplars turn a violated latency objective into a lead:
            # the exact batch/span ids behind the slowest observations.
            ex = (hists.get(key) or {}).get("exemplars")
            if ex and ok is False:
                obj["exemplars"] = ex
        objectives.append(obj)
    return {"spec": spec, "ok": violations == 0, "violations": violations,
            "objectives": objectives}


# ---------------------------------------------------------------------------
# Error budgets: multi-window burn rates over the durable series store
# ---------------------------------------------------------------------------

_WINDOW_UNITS = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}


def _parse_window(raw: str, part: str) -> float:
    raw = raw.strip()
    unit = _WINDOW_UNITS.get(raw[-1:].lower())
    num = raw[:-1] if unit else raw
    try:
        sec = float(num) * (unit or 1.0)
    except ValueError as e:
        raise ValueError(
            f"budget window {raw!r} in {part!r} is not "
            "<number>[s|m|h|d]") from e
    if sec <= 0:
        raise ValueError(f"budget window in {part!r} must be > 0")
    return sec


def parse_budget_spec(spec: str) -> list[dict]:
    """``"alert_freshness<60@99.9/28d;probe_errors@99/1d"`` -> budget
    objective dicts.  Grammar per part: ``name[<threshold]@target/window``
    — threshold (seconds) is required for histogram/gauge objectives
    (what counts as a bad observation), forbidden for ratio objectives
    (bad/total are the two counters themselves); target is the good
    percentage (0 < target < 100); window is ``<number>[s|m|h|d]``.

    Raises ValueError on unknown names, watchdog-kind objectives (a
    point-in-time liveness field has no per-observation history to
    budget), or malformed parts — Config validates at construction
    (the parse_spec fail-fast rationale).
    """
    out: list[dict] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        head, sep, rest = part.partition("@")
        if not sep:
            raise ValueError(
                f"budget {part!r} is not name[<threshold]@target/window")
        name, tsep, thr_raw = head.partition("<")
        name = name.strip()
        if name not in OBJECTIVES:
            raise ValueError(
                f"unknown budget objective {name!r}; known: "
                f"{sorted(OBJECTIVES)}")
        kind, key, stat, desc = OBJECTIVES[name]
        if kind == "watchdog":
            raise ValueError(
                f"budget objective {name!r} is watchdog-kind — a "
                "liveness field has no observation history to budget")
        threshold = None
        if tsep:
            try:
                threshold = float(thr_raw)
            except ValueError as e:
                raise ValueError(
                    f"budget threshold {thr_raw!r} in {part!r} is not "
                    "a number") from e
            if threshold <= 0:
                raise ValueError(
                    f"budget threshold in {part!r} must be > 0")
        if kind == "ratio" and threshold is not None:
            raise ValueError(
                f"budget {part!r}: ratio objective {name!r} takes no "
                "<threshold (its counters already split bad/total)")
        if kind != "ratio" and threshold is None:
            raise ValueError(
                f"budget {part!r} needs a <threshold: what counts as "
                f"a bad {kind} observation")
        target_raw, wsep, window_raw = rest.partition("/")
        if not wsep:
            raise ValueError(
                f"budget {part!r} is missing its /window")
        try:
            target_pct = float(target_raw)
        except ValueError as e:
            raise ValueError(
                f"budget target {target_raw!r} in {part!r} is not a "
                "number") from e
        if not 0.0 < target_pct < 100.0:
            raise ValueError(
                f"budget target in {part!r} must be a percentage in "
                f"(0, 100), got {target_pct}")
        out.append({"name": name, "kind": kind, "metric": key,
                    "stat": stat, "threshold": threshold,
                    "target_pct": target_pct,
                    "target": target_pct / 100.0,
                    "window_sec": _parse_window(window_raw, part),
                    "description": desc})
    return out


def _pick_resolution(window_sec: float, resolutions) -> int:
    """The coarsest series resolution that still gives a window >= ~4
    buckets — fast windows read the 10s ring, 28d budgets the 1h one."""
    floor = min(resolutions)
    cands = [r for r in resolutions
             if r <= max(window_sec / 4.0, floor)]
    return max(cands) if cands else floor


def _window_stats(points: list, budget: dict, t0: float,
                  t1: float) -> dict:
    """bad/total over one window from merged per-source deltas.  An
    empty window (no source reported the metric inside it) is
    ``empty: True`` with zero bad and zero total — the no-data-is-
    zero-burn rule (it must neither page nor bank credit)."""
    from firebird_tpu_torch.obs import series as series_mod

    kind, key = budget["kind"], budget["metric"]
    bad = total = 0.0
    empty = True
    if kind == "histogram":
        for m in (key if isinstance(key, tuple) else (key,)):
            win = series_mod.hist_window(points, m, t0, t1)
            if win is not None and win["count"] > 0:
                total = float(win["count"])
                bad = series_mod.hist_over_threshold(
                    win, budget["threshold"])
                empty = False
                break
    elif kind == "gauge":
        samples = series_mod.gauge_samples(points, key, t0, t1)
        if samples:
            total = float(len(samples))
            bad = float(sum(1 for (_, _, v) in samples
                            if v > budget["threshold"]))
            empty = False
    else:                                # ratio: (bad, total) counters
        den = series_mod.counter_window(points, key[1], t0, t1)
        if den is not None and den > 0:
            num = series_mod.counter_window(points, key[0], t0, t1) or 0.0
            total = float(den)
            bad = min(float(num), total)
            empty = False
    ratio = (bad / total) if total > 0 else None
    return {"t0": t0, "t1": t1, "sec": round(t1 - t0, 3),
            "total": total, "bad": bad, "error_ratio": ratio,
            "empty": empty}


def evaluate_budgets(directory: str, spec: str | None = None, *,
                     now: float | None = None,
                     fast_sec: float = DEFAULT_FAST_SEC,
                     slow_sec: float = DEFAULT_SLOW_SEC,
                     burn_threshold: float = DEFAULT_BURN,
                     resolutions=None) -> dict:
    """Evaluate the budget spec against the series rings under
    ``directory`` (obs/series.py).  Every number is re-derived from
    summed per-source deltas across EVERY host's points — the fleet
    verdict, never one process's self-report.

    Per budget: the full rolling window decides exhaustion (cumulative
    bad > (1-target) x total), and the fast/slow burn-window pair
    decides ``burning`` (BOTH >= ``burn_threshold``).  ``ok`` is None
    when every window was empty (no data -> zero burn), False on
    exhaustion or burning, True otherwise; ``empty_windows`` names the
    windows that had no data.
    """
    from firebird_tpu_torch.obs import series as series_mod

    if spec is None or spec == "":
        spec = DEFAULT_BUDGET_SPEC
    if spec == "0":
        return {"spec": "0", "ok": True, "violations": 0, "budgets": []}
    if now is None:
        now = time.time()
    if resolutions is None:
        resolutions = series_mod.RESOLUTIONS
    budgets = []
    violations = 0
    srcs: set = set()
    for b in parse_budget_spec(spec):
        windows: dict = {}
        burn_raw: dict = {}
        for wname, wsec in (("window", b["window_sec"]),
                            ("fast", fast_sec), ("slow", slow_sec)):
            res = _pick_resolution(wsec, resolutions)
            # Two extra buckets of lookback feed the pre-window
            # baseline the cumulative-delta math needs.
            points = series_mod.read_points(
                directory, res, now - wsec - 2 * res, now)
            srcs.update(p.get("src") for p in points)
            w = _window_stats(points, b, now - wsec, now)
            w["resolution_sec"] = res
            if w["error_ratio"] is None:
                burn_raw[wname] = None
                w["burn_rate"] = None
            else:
                # The paging decision below compares the UNROUNDED
                # ratio; rounding is display-only (a window burning at
                # 14.3996x must not page a 14.4 threshold).
                burn_raw[wname] = (w["error_ratio"]
                                   / max(1.0 - b["target"], 1e-9))
                w["burn_rate"] = round(burn_raw[wname], 3)
            windows[wname] = w
        full = windows["window"]
        allowed = (1.0 - b["target"]) * full["total"]
        exhausted = (not full["empty"]) and full["bad"] > allowed
        burning = (not windows["fast"]["empty"]
                   and not windows["slow"]["empty"]
                   and burn_raw["fast"] >= burn_threshold
                   and burn_raw["slow"] >= burn_threshold)
        empty_names = [n for n in ("window", "fast", "slow")
                       if windows[n]["empty"]]
        ok = None if len(empty_names) == 3 else \
            not (exhausted or burning)
        if ok is False:
            violations += 1
        budgets.append({
            "name": b["name"], "kind": b["kind"],
            "metric": b["metric"], "threshold": b["threshold"],
            "target_pct": b["target_pct"],
            "window_sec": b["window_sec"],
            "description": b["description"],
            "total": full["total"], "bad": full["bad"],
            "allowed_bad": round(allowed, 6),
            "budget_spent": (round(full["bad"] / allowed, 4)
                             if allowed > 0 else None),
            "exhausted": exhausted, "burning": burning,
            "fast_burn": windows["fast"]["burn_rate"],
            "slow_burn": windows["slow"]["burn_rate"],
            "empty_windows": empty_names, "ok": ok,
            "windows": windows,
        })
    return {"spec": spec, "evaluated_at": now,
            "fast_sec": fast_sec, "slow_sec": slow_sec,
            "burn_threshold": burn_threshold,
            "sources": sorted(s for s in srcs if s),
            "ok": violations == 0, "violations": violations,
            "budgets": budgets}


# -- durable budget-state events --------------------------------------------

def budget_events_path(directory: str) -> str:
    return os.path.join(directory, BUDGET_EVENTS_FILE)


def read_budget_events(directory: str) -> list[dict]:
    """Every parseable budget event under ``directory``, append order.
    Torn tail lines are skipped (the spool reader's rule)."""
    out: list[dict] = []
    try:
        with open(budget_events_path(directory)) as f:
            for line in f:
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue            # torn tail line
                if isinstance(doc, dict) and doc.get("name"):
                    out.append(doc)
    except OSError:
        pass
    return out


def _budget_state(b: dict) -> str:
    if b.get("exhausted"):
        return "exhausted"
    if b.get("burning"):
        return "burning"
    return "no_data" if b.get("ok") is None else "ok"


def record_budget_events(directory: str, verdict: dict,
                         now: float | None = None) -> list[dict]:
    """Append one durable event per budget whose state CHANGED into or
    out of trouble (exhausted/burning) since the last recorded event —
    flush-per-line JSONL next to the series rings, so exhaustion
    survives every process that witnessed it.  ok <-> no_data flaps are
    not recorded (a quiet fleet is not an incident timeline).  Returns
    the appended events; I/O trouble degrades to none appended."""
    last: dict = {}
    for ev in read_budget_events(directory):
        last[ev["name"]] = ev.get("state")
    appended = []
    trouble = ("exhausted", "burning")
    for b in verdict.get("budgets", ()):
        state = _budget_state(b)
        prev = last.get(b["name"])
        if state == prev or (state not in trouble
                             and prev not in trouble):
            continue
        appended.append({
            "kind": "budget_event", "schema": BUDGET_EVENT_SCHEMA,
            "t": time.time() if now is None else float(now),
            "name": b["name"], "state": state, "prev": prev,
            "bad": b["bad"], "total": b["total"],
            "allowed_bad": b["allowed_bad"],
            "window_sec": b["window_sec"],
            "fast_burn": b["fast_burn"], "slow_burn": b["slow_burn"]})
    if appended:
        try:
            os.makedirs(directory, exist_ok=True)
            with open(budget_events_path(directory), "a") as f:
                for ev in appended:
                    f.write(json.dumps(ev, separators=(",", ":")) + "\n")
                    f.flush()
        except OSError:
            return []    # degraded telemetry, never a crashed evaluator
    return appended


def evaluate_and_record(directory: str, spec: str | None = None,
                        **kwargs) -> dict:
    """:func:`evaluate_budgets` + :func:`record_budget_events`; the
    verdict gains ``events_appended``."""
    verdict = evaluate_budgets(directory, spec, **kwargs)
    verdict["events_appended"] = record_budget_events(
        directory, verdict, now=verdict.get("evaluated_at"))
    return verdict

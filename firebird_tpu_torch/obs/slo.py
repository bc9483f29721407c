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

The durable half of the JAX package's module — error budgets over the
series store (``FIREBIRD_SLO_BUDGET``, ``evaluate_and_record``) — needs
``obs/series.py``, which is not ported: ``Config.slo_budget`` stays in
``config.NOT_PORTED``.  This is the port's own copy of the live half:
the spec grammar, :data:`OBJECTIVES` and :func:`evaluate_snapshot`.
"""

from __future__ import annotations

DEFAULT_SPEC = ("batch_p95=30;serve_p99=2;freshness=600;"
                "alert_freshness=60;changefeed_lag=10;drain_eta=3600")

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

"""Metrics: counters, gauges, and fixed-bucket latency histograms.

The port's own copy of the JAX package's ``obs/metrics.py``: the three
Prometheus metric kinds, a text exposition (``prometheus()``, served at
the ops endpoint's ``/metrics``), a JSON snapshot embedded in the per-run
``obs_report.json`` (obs/report.py), the slowest observations' trace
exemplars on every histogram, and the fleet merge policy of the report
shards.

Instrumentation calls the module-level helpers (``counter("chips").inc()``,
``histogram("store_write_seconds").observe(dt)``) against a process-global
default registry — the pipeline stages live in different threads and
modules, and threading a registry handle through every seam would dwarf the
instrumentation itself.  FIREBIRD_METRICS=0 turns every recording call into
a no-op (all instrumented sites are per-batch/per-request, never
per-pixel).
"""

from __future__ import annotations

import bisect
import threading
import time

from firebird_tpu_torch.config import env_knob
from firebird_tpu_torch.obs import tracing as _tracing

# Exemplars kept per histogram: the slowest observations' trace
# identities (batch id + span id), so a hot p99 in a report links to the
# exact batch/trace that caused it instead of an anonymous bucket count.
EXEMPLAR_SLOTS = 4

# Fixed latency buckets (seconds): spans sub-millisecond packs up to
# multi-minute kernel builds.  Fixed — not adaptive — so percentiles are
# comparable across runs and the exposition is a stable schema.
LATENCY_BUCKETS_SEC = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def metrics_enabled() -> bool:
    """FIREBIRD_METRICS gate: unset/1 on, 0/empty off.  Read per call so
    tests (and the bench overhead check) can flip it without reimports."""
    return env_knob("FIREBIRD_METRICS") not in ("0", "")


class Counter:
    """Monotonic named counter."""

    def __init__(self, name: str, help: str | None = None):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0  # guarded-by: _lock

    def inc(self, n: int = 1) -> None:
        if not metrics_enabled():
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-written value (queue depths, capacities)."""

    def __init__(self, name: str, help: str | None = None):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0  # guarded-by: _lock

    def set(self, v: float) -> None:
        if not metrics_enabled():
            return
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not metrics_enabled():
            return
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    Cumulative-bucket exposition matches Prometheus; ``quantile`` linearly
    interpolates inside the containing bucket (the overflow bucket reports
    the observed max — better than +Inf for a report meant to be read).
    """

    def __init__(self, name: str, buckets=LATENCY_BUCKETS_SEC,
                 help: str | None = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # guarded-by: _lock
        self._sum = 0.0  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock
        self._min = float("inf")  # guarded-by: _lock
        self._max = float("-inf")  # guarded-by: _lock
        # Slowest-observation exemplars [(value, {batch, span_id}), ...],
        # descending, at most EXEMPLAR_SLOTS.
        self._exemplars: list = []  # guarded-by: _lock

    def observe(self, v: float) -> None:
        if not metrics_enabled():
            return
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        # Exemplar resolved OUTSIDE the lock (one thread-local read; None
        # when no TraceContext is active — e.g. registry unit tests).
        ex = _tracing.exemplar()
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if ex is not None and (len(self._exemplars) < EXEMPLAR_SLOTS
                                   or v > self._exemplars[-1][0]):
                self._exemplars.append((v, ex))
                self._exemplars.sort(key=lambda t: -t[0])
                del self._exemplars[EXEMPLAR_SLOTS:]

    def observe_many(self, values) -> None:
        """Bulk observe: vectorized binning + ONE lock acquisition for
        the whole array.  The per-batch occupancy feed
        (kernel.record_occupancy) delivers thousands of chip-round
        fractions from the driver's drain thread — per-value observe()
        calls there would serialize against every scraper."""
        if not metrics_enabled():
            return
        import numpy as np

        v = np.asarray(values, float).reshape(-1)
        if v.size == 0:
            return
        # side='left' matches observe()'s bisect_left binning exactly.
        binc = np.bincount(np.searchsorted(self.buckets, v, side="left"),
                           minlength=len(self.buckets) + 1)
        with self._lock:
            for i, c in enumerate(binc):
                self._counts[i] += int(c)
            self._sum += float(v.sum())
            self._count += v.size
            self._min = min(self._min, float(v.min()))
            self._max = max(self._max, float(v.max()))

    def quantile(self, q: float) -> float | None:
        with self._lock:
            counts, total = list(self._counts), self._count
            lo_obs, hi_obs = self._min, self._max
        if total == 0:
            return None
        target = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= target and c > 0:
                lo = self.buckets[i - 1] if i > 0 else min(lo_obs, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else hi_obs
                frac = (target - seen) / c
                est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                # clamp to the observed range: bucket interpolation must
                # not report a percentile beyond any recorded value
                return min(max(est, lo_obs), hi_obs)
            seen += c
        return hi_obs

    def snapshot(self) -> dict:
        with self._lock:
            if self._count == 0:
                return {"count": 0}
            out = {"count": self._count, "sum": self._sum,
                   "mean": self._sum / self._count,
                   "min": self._min, "max": self._max,
                   # Raw per-bucket counts (last = overflow) travel in the
                   # snapshot so per-host report shards stay mergeable —
                   # percentiles cannot be combined, bucket counts can
                   # (merge_histogram_snapshots).
                   "bucket_bounds": list(self.buckets),
                   "bucket_counts": list(self._counts)}
            if self._exemplars:
                out["exemplars"] = [dict(ex, value=round(v, 6))
                                    for v, ex in self._exemplars]
        out.update({"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                    "p99": self.quantile(0.99)})
        return out

    def cumulative_buckets(self) -> list[tuple[str, int]]:
        """[(le_label, cumulative_count), ...] ending with '+Inf'."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for b, c in zip(self.buckets, counts):
            cum += c
            out.append((format(b, "g"), cum))
        out.append(("+Inf", cum + counts[-1]))
        return out


# Exposition format contract: every non-empty line is a HELP/TYPE comment
# or a `name{labels} value` sample.  Shared by tools/obs_smoke.py and the
# test suite so the scrape-format check cannot drift from the emitter.
import re as _re

PROM_LINE_RE = _re.compile(
    r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+)$")


def _prom_name(name: str, kind: str | None = None) -> str:
    """Prometheus-sanitized metric name.  Counters get the conventional
    ``_total`` suffix exactly once — a counter already named ``*_total``
    (watchdog_stall_total) must not double up."""
    p = "firebird_" + _re.sub(r"[^a-zA-Z0-9_]", "_", name)
    if kind == "counter" and not p.endswith("_total"):
        p += "_total"
    return p


# Central ``# HELP`` catalog for instruments registered at hot call
# sites where an inline ``help=`` kwarg would crowd the instrumentation
# (an inline help still wins; this is the fallback before the generic
# default).  Glob keys (``stream_*``) cover dynamically-named families.
# firebird-lint's metric-help rule accepts an instrument iff SOME
# registration site passes help= or its name matches an entry here — so
# a new instrument cannot ship help-less.
METRIC_HELP = {
    "kernel_first_call_seconds":
        "per-shape first kernel call wall time (~ XLA compile)",
    "kernel_dispatch_shapes":
        "distinct compiled kernel shapes dispatched this run",
    "warm_compile_seconds":
        "background AOT warm-start compile wall time",
    "pipeline_fetch_seconds": "per-batch source fetch wall time",
    "pipeline_pack_seconds": "per-batch dense packing wall time",
    "pipeline_stage_seconds": "per-batch H2D staging wall time",
    "pipeline_dispatch_seconds": "per-batch dispatch (enqueue) wall time",
    "pipeline_drain_seconds": "per-batch result drain wall time",
    "pipeline_d2h_seconds": "per-batch bulk device_get wall time",
    "ingest_chip_seconds": "per-chip source fetch wall time",
    "ingest_http_seconds": "chipmunk HTTP request wall time",
    "ingest_http_requests": "chipmunk HTTP requests issued",
    "ingest_bytes_in": "decoded ingest payload bytes",
    "capacity_redispatches":
        "batches re-dispatched at doubled segment capacity",
    "chunk_failures": "chunks abandoned by the per-chunk isolation",
    "fetch_retries": "chip fetches retried after transient errors",
    "store_write_seconds": "store backend write wall time",
    "store_flush_seconds": "writer flush (drain-all) wall time",
    "store_write_errors": "store writes that exhausted their retries",
    "store_write_retries": "store writes retried after transient errors",
    "store_queue_depth": "frames queued to the async writer",
    "objectstore_puts": "objects published (manifest commits)",
    "objectstore_gets": "object reads served",
    "objectstore_conflicts":
        "conditional puts that lost the generation race",
    "objectstore_torn_recoveries":
        "reads that fell back a generation past a torn newest object",
    "objectstore_scrubbed_chunks":
        "orphaned chunks reclaimed by the scrubber",
    "objectstore_retries":
        "transient object-store operation failures retried under the "
        "shared budget",
    "object_fence_rejected_total":
        "stale-fence conditional puts rejected at the object layer",
    "watchdog_stall_total": "stall episodes declared by the watchdog",
    "watchdog_recovered_total": "stalls cleared by a later batch beat",
    "watchdog_throughput_drop_total":
        "rolling-window throughput drop events",
    "stream_publish_seconds": "streaming update publish wall time",
    "stream_*": "per-run streaming driver summary values",
    "faults_injected_*": "injected faults by scope (chaos drills)",
    "serve_requests_segments": "/v1/segments requests served",
    "serve_requests_pixel": "/v1/pixel requests served",
    "serve_requests_product": "/v1/product requests served",
    "serve_requests_tile": "/v1/tile requests served",
    "serve_deadline_exceeded_total":
        "requests past their deadline (504)",
    "fleet_jobs_claimed": "fleet jobs claimed (leased) by workers",
    "fleet_jobs_acked": "fleet jobs completed and acked",
    "fleet_jobs_requeued":
        "fleet jobs returned to the queue (lease expiry or retryable "
        "failure)",
    "fleet_jobs_dead":
        "fleet jobs dead-lettered after their attempt budget",
    "fleet_jobs_lost":
        "jobs abandoned after lease loss (zombie fenced off its output)",
    "fleet_fence_rejected":
        "operations rejected for a stale fencing token",
    "fleet_lease_age_seconds": "age of this worker's current fleet lease",
    "fleet_job_seconds_*": "fleet job execution wall time by job type",
    "probe_attempts": "black-box probes resolved (all surfaces)",
    "probe_attempts_*": "black-box probes resolved, by surface",
    "probe_failures":
        "black-box probes failed (timeout, transport error, or 5xx)",
    "probe_failures_*": "black-box probe failures, by surface",
    "probe_etag_304":
        "probe conditional GETs answered 304 (ETag revalidation "
        "worked end to end)",
    "probe_serve_seconds":
        "black-box serve GET seconds (the outside view of /v1 latency)",
    "probe_alert_seconds":
        "black-box scene drop -> SSE alert visibility seconds",
    "probe_webhook_seconds":
        "black-box scene drop -> webhook delivery seconds",
}


def _catalog_help(name: str) -> str | None:
    h = METRIC_HELP.get(name)
    if h is not None:
        return h
    import fnmatch

    for pat, text in METRIC_HELP.items():
        if "*" in pat and fnmatch.fnmatch(name, pat):
            return text
    return None


def _help_text(m, kind: str) -> str:
    """# HELP body: the metric's declared help, the METRIC_HELP catalog
    entry, or a readable default."""
    return m.help or _catalog_help(m.name) \
        or f"firebird {kind} {m.name.replace('_', ' ')}"


class MetricsRegistry:
    """Named metric registry: get-or-create accessors, Prometheus text
    exposition, and a JSON-ready snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        # The three stores are mutated only inside _get (under _lock);
        # accessors pass the dict REFERENCE through, which is why they
        # are not guarded-by annotated — the linter checks lexical
        # with-scopes, not aliases (docs/STATIC_ANALYSIS.md).
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._once: set = set()  # guarded-by: _lock
        self._t0 = time.monotonic()

    def once(self, key) -> bool:
        """True exactly the first time ``key`` is seen on this registry —
        first-call capture (e.g. per-shape kernel compile time) scoped to
        the registry's lifetime, so every run's report records its own."""
        with self._lock:
            if key in self._once:
                return False
            self._once.add(key)
            return True

    def _get(self, store: dict, name: str, factory, help: str | None):
        with self._lock:
            m = store.get(name)
            if m is None:
                m = store[name] = factory(name)
            if help and not m.help:   # first declared help wins
                m.help = help
            return m

    def counter(self, name: str, help: str | None = None) -> Counter:
        return self._get(self._counters, name, Counter, help)

    def gauge(self, name: str, help: str | None = None) -> Gauge:
        return self._get(self._gauges, name, Gauge, help)

    def histogram(self, name: str, buckets=LATENCY_BUCKETS_SEC,
                  help: str | None = None) -> Histogram:
        return self._get(self._histograms, name,
                         lambda n: Histogram(n, buckets), help)

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        return {
            "elapsed_sec": time.monotonic() - self._t0,
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {n: g.value for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot() for n, h in sorted(hists.items())},
        }

    def prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._histograms.items())
        lines = []
        for name, c in counters:
            p = _prom_name(name, "counter")
            lines += [f"# HELP {p} {_help_text(c, 'counter')}",
                      f"# TYPE {p} counter", f"{p} {c.value}"]
        for name, g in gauges:
            p = _prom_name(name)
            lines += [f"# HELP {p} {_help_text(g, 'gauge')}",
                      f"# TYPE {p} gauge", f"{p} {format(g.value, 'g')}"]
        for name, h in hists:
            p = _prom_name(name)
            lines.append(f"# HELP {p} {_help_text(h, 'histogram')}")
            lines.append(f"# TYPE {p} histogram")
            for le, cum in h.cumulative_buckets():
                lines.append(f'{p}_bucket{{le="{le}"}} {cum}')
            snap = h.snapshot()
            lines.append(f"{p}_sum {format(snap.get('sum', 0.0), 'g')}")
            lines.append(f"{p}_count {snap['count']}")
        # An empty registry exposes nothing — not a lone blank line
        # (scrape format: every line is a comment or a sample).
        return "\n".join(lines) + "\n" if lines else ""


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def reset_registry() -> MetricsRegistry:
    """Swap in a fresh default registry (test isolation; a run-scoped
    report should not carry a previous run's latencies)."""
    global _registry
    # Single-reference swap between runs (tests, driver run setup) while
    # no instrumented thread is live; readers grab the reference once.
    _registry = MetricsRegistry()  # firebird-lint: disable=ownership-global-mutation
    return _registry


def counter(name: str, help: str | None = None) -> Counter:
    return _registry.counter(name, help)


def gauge(name: str, help: str | None = None) -> Gauge:
    return _registry.gauge(name, help)


def histogram(name: str, buckets=LATENCY_BUCKETS_SEC,
              help: str | None = None) -> Histogram:
    return _registry.histogram(name, buckets, help)


# ---------------------------------------------------------------------------
# Multi-host merge policy (obs.report.merge_reports)
# ---------------------------------------------------------------------------
# Counters always sum across host shards and histogram bucket counts always
# add; gauges are last-written values, so each needs a declared combination.
# Prefix rules, first match wins; anything undeclared takes the default —
# "max" reads as "the worst host" for depth/backlog-style gauges, which is
# the operator-relevant view.
GAUGE_MERGE_POLICY: tuple[tuple[str, str], ...] = (
    ("stream_", "sum"),           # per-host stream summary counts add up
    ("store_queue_depth", "max"),  # worst backlog across the fleet
    ("mesh_", "max"),             # global topology, identical on every host
)
_GAUGE_MERGE_DEFAULT = "max"


def gauge_merge_policy(name: str) -> str:
    """'sum' | 'max' | 'min' for a gauge name under fleet merge."""
    for prefix, policy in GAUGE_MERGE_POLICY:
        if name.startswith(prefix):
            return policy
    return _GAUGE_MERGE_DEFAULT


def merge_gauge_values(name: str, values: list[float]) -> float:
    policy = gauge_merge_policy(name)
    if policy == "sum":
        return float(sum(values))
    if policy == "min":
        return float(min(values))
    return float(max(values))


def merge_histogram_snapshots(snaps: list[dict]) -> dict:
    """Combine per-host histogram snapshots into one fleet snapshot.

    When every live shard carries the same bucket bounds (the normal case
    — LATENCY_BUCKETS_SEC is a fixed schema precisely so runs compose),
    bucket counts add and the percentiles are *recomputed* from the merged
    buckets.  Shards without bucket data (older schema) or with mismatched
    bounds fall back to a count-weighted percentile average — labeled
    approximate, never silently wrong about count/sum/min/max, which merge
    exactly either way.
    """
    live = [s for s in snaps if s.get("count", 0) > 0]
    if not live:
        return {"count": 0}
    # Exemplars union across shards, slowest-first, re-bounded — a fleet
    # report's p99 exemplar should be the fleet's slowest batch.
    exemplars = sorted((e for s in live for e in s.get("exemplars", ())),
                       key=lambda e: -e.get("value", 0.0))[:EXEMPLAR_SLOTS]
    bounds = live[0].get("bucket_bounds")
    same = bounds is not None and \
        all(s.get("bucket_bounds") == bounds for s in live)
    if same:
        h = Histogram("merged", buckets=bounds)
        h._counts = [sum(s["bucket_counts"][i] for s in live)
                     for i in range(len(bounds) + 1)]
        h._count = sum(s["count"] for s in live)
        h._sum = float(sum(s["sum"] for s in live))
        h._min = min(s["min"] for s in live)
        h._max = max(s["max"] for s in live)
        out = h.snapshot()
        if exemplars:
            out["exemplars"] = exemplars
        return out
    total = sum(s["count"] for s in live)
    out = {"count": total, "sum": float(sum(s["sum"] for s in live)),
           "min": min(s["min"] for s in live),
           "max": max(s["max"] for s in live),
           "percentiles_approximate": True}
    out["mean"] = out["sum"] / total
    for q in ("p50", "p95", "p99"):
        vals = [(s[q], s["count"]) for s in live if s.get(q) is not None]
        out[q] = (sum(v * c for v, c in vals) / sum(c for _, c in vals)
                  if vals else None)
    if exemplars:
        out["exemplars"] = exemplars
    return out


class Counters:
    """Thread-safe run-scoped throughput counters (the original flat
    counter set; the driver logs its snapshot at run end).  Typical keys:
    chips, pixels, segments, bytes_in, bytes_out.

    The rate clock starts at the first ``add`` (or an explicit
    ``start()``), NOT at construction: the driver builds its Counters
    before source/store setup and the kernels' build, and dividing by that
    idle span deflated every ``*_per_sec`` rate — a 100s compile ahead of
    a 10s run read as a 10x slower pipeline."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}  # guarded-by: _lock
        self._t0: float | None = None  # guarded-by: _lock

    def start(self) -> None:
        """Explicitly (re)start the rate clock — call at the moment the
        run's productive work begins; otherwise the first add starts it."""
        with self._lock:
            self._t0 = time.monotonic()

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            if self._t0 is None:
                self._t0 = time.monotonic()
            self._counts[key] = self._counts.get(key, 0) + n

    def get(self, key: str) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def snapshot(self) -> dict:
        with self._lock:
            elapsed = (time.monotonic() - self._t0) \
                if self._t0 is not None else 0.0
            out = dict(self._counts)
        out["elapsed_sec"] = elapsed
        for k in list(out):
            if k != "elapsed_sec" and elapsed > 0:
                out[f"{k}_per_sec"] = out[k] / elapsed
        return out


class timer:
    """Context manager measuring wall time in seconds (``.elapsed``)."""

    def __enter__(self):
        self._t0 = time.monotonic()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc):
        self.elapsed = time.monotonic() - self._t0
        return False

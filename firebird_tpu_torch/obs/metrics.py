"""Run metrics: counters, gauges and fixed-bucket latency histograms.

The port's own copy of the part of the JAX package's ``obs/metrics.py``
that the batch driver, the store writer, the retry loop and the quarantine
record into: the registry (:func:`counter`, :func:`gauge`,
:func:`histogram`, :func:`get_registry`, :func:`reset_registry`), the run's
:class:`Counters` and :class:`timer`.  Histograms keep no trace exemplars
(this package has no span tracer yet), and the Prometheus exposition and
the multi-host merge policy stay with the ops plane, not ported yet.
FIREBIRD_METRICS=0 turns recording off, as in the JAX package.
"""

from __future__ import annotations

import bisect
import threading
import time

from firebird_tpu_torch.config import env_knob

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

    def observe(self, v: float) -> None:
        if not metrics_enabled():
            return
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)

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

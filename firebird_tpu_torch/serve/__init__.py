"""firebird_tpu_torch.serve — the query/serving layer: the port's own copy
of the JAX package's ``serve`` package, host only.

The write path (ingest -> the detector's kernels on the card -> store)
ends at the results store; this package is the read path over it,
designed like an inference server:

- :mod:`firebird_tpu_torch.serve.api` — the HTTP query API
  (``/v1/segments``, ``/v1/pixel``, ``/v1/product/<name>``,
  ``/v1/tile/<name>``, ``/v1/pyramid/...``) plus ``/healthz`` and
  ``/metrics``, over any Store backend.
- :mod:`firebird_tpu_torch.serve.cache` — the two-tier (memory LRU + disk
  spill) chip cache with store-write generation invalidation.
- :mod:`firebird_tpu_torch.serve.flight` — single-flight request
  coalescing, admission control (429/504), and breaker-backed degraded
  mode (cache-only serving while the store is down).
- :mod:`firebird_tpu_torch.serve.pyramid` — the quadkey tile pyramid:
  versioned static product tiles behind ``/v1/pyramid``, precomputed by
  ``pyramid build`` / fleet ``pyramid`` jobs.
- :mod:`firebird_tpu_torch.serve.changefeed` — replica-fleet cache
  coherence over the alert log + product_writes cursors, and the feed's
  producer hook (``products.save``, the repair path).

The JAX package's exports load on first use: the batch writers import
``serve.changefeed`` alone, without the HTTP layer or the pyramid.
"""

_EXPORTS = {
    "ServeServer": "api", "ServeService": "api", "start_serve_server": "api",
    "LRUCache": "cache", "StoreGenerations": "cache", "watch_store": "cache",
    "ChangefeedConsumer": "changefeed", "ProductWrites": "changefeed",
    "changefeed_db_path": "changefeed",
    "TilePyramid": "pyramid", "pyramid_root": "pyramid",
    "pyramid_storage": "pyramid", "LocalTileStorage": "pyramid",
    "ObjectTileStorage": "pyramid",
    "AdmissionControl": "flight", "DeadlineExceeded": "flight",
    "Overload": "flight", "SingleFlight": "flight", "StoreDegraded": "flight",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)

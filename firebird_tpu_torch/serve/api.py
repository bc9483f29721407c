"""The production query API over the CCDC results store: the port's own
copy of the JAX package's ``serve/api.py``.  It serves the product rasters
the card's detector and forest wrote (the batch driver's kernels and
the ``classification`` forest) and runs on the host only: neither this
module nor a request it serves loads torch.

The reference pipeline ends at its store — "users then pull rasters out
of Cassandra with external tooling" (export.py docstring).  This module
is the native read path: a concurrent HTTP query layer over any Store
backend, designed like an inference server (cf. the
processing-and-analysis split in arXiv:1703.10979):

``/v1/segments?cx=&cy=``
    A chip's stored segment rows (dict-of-columns JSON), decoded once
    and cached.
``/v1/pixel?x=&y=&date=``
    Per-pixel answers at projection point (x, y) for ISO date D: the
    ``seglength`` / ``ccd`` / ``curveqa`` / ``cover`` product values of
    the containing pixel — four cached chip-raster lookups + one index.
``/v1/product/<name>?cx=&cy=&date=[&format=json|npy]``
    A whole-chip [100x100] int32 product raster.  Cold misses compute
    through the exact products.save path (products.save_chip_raster) and
    persist the row — a raster served cold is byte-identical to one
    ``firebird save`` would write — under single-flight coalescing, so N
    identical concurrent misses cost ONE computation.
``/v1/tile/<name>?bounds=x,y&bounds=x,y&date=[&format=json|npy]``
    A mosaic over the bounds area via the export helpers, reading each
    chip through the same cache/compute path as ``/v1/product``.
``/v1/pyramid/<name>/<z>/<x>/<y>?date=[&format=npy|json]``
    One quadkey pyramid tile (serve/pyramid.py): a hit is a static-file
    read of the persisted versioned ``.npy`` — no store, no decode —
    and cold tiles near the base compute through the same single-flight
    path.  THE map-traffic endpoint.
``/v1/alerts?since=&bbox=&t0=&t1=``, ``/v1/alerts/stream``,
``/v1/alerts/webhooks``
    The change-alert feed over the durable alert log the card's stream
    jobs append to (firebird_tpu_torch.alerts): cursor pull, live SSE
    push, and webhook subscriber registration/listing.
``/v1/products``, ``/healthz``, ``/metrics``
    Discovery, liveness (``degraded`` while the store breaker is open),
    and the Prometheus exposition of the shared obs registry — the
    ``serve_*`` family lands next to the pipeline metrics.

Edge offload: ``/v1/product``, ``/v1/tile``, and ``/v1/pyramid``
responses carry strong ``ETag`` + ``Cache-Control`` headers, and a
request presenting a matching ``If-None-Match`` answers **304** without
touching the body path — so CDN/browser caches do the heavy lifting
and revalidations cost a generation lookup, not a raster.  ETags derive
from the replica's store-write generations (serve/cache.py) and the
pyramid tile version; the changefeed consumer (serve/changefeed.py)
bumps both on every cross-process write, which is what flips a cached
ETag to a fresh 200.

Every ``/v1`` request runs under admission control (429 + Retry-After
past the waiting line, 504 past the deadline) and the store sits behind
a circuit breaker (retry.py — the same machinery as the batch drivers):
a broken store degrades the layer to cache-only serving, it does not
kill it.

HTTP plumbing is shared with the ops surface (obs/httpd.py); metrics
register in the existing obs registry: ``serve_request_seconds``
histogram, ``serve_requests_total`` + per-endpoint counters,
``serve_cache_hits``/``serve_cache_misses``, ``serve_inflight`` gauge,
``serve_product_computes`` (the single-flight proof counter).
"""

from __future__ import annotations

import io
import uuid

import numpy as np

from firebird_tpu_torch import grid
from firebird_tpu_torch.obs import httpd, logger, tracing
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.serve.cache import (LRUCache, StoreGenerations,
                                            watch_store)
from firebird_tpu_torch.serve.flight import (AdmissionControl,
                                             DeadlineExceeded, Overload,
                                             SingleFlight, StoreDegraded)

log = logger("serve")


class BadRequest(ValueError):
    """Malformed query parameters (400)."""


class NotFound(LookupError):
    """No stored data answers the query (404)."""


class StoreError(RuntimeError):
    """A store operation failed (503 — the backend, not the request)."""


class _GuardedWriter:
    """Store facade passing only ``write`` through the service's breaker
    guard — handed to products.save_chip_raster so a compute-on-miss
    persist counts as a store op while the *computation* itself does
    not (a deterministic data-dependent compute error must surface as
    that request's failure, never open the store breaker and degrade
    every other chip to cache-only serving)."""

    def __init__(self, svc: "ServeService", what: str):
        self._svc = svc
        self._what = what

    def write(self, table: str, frame: dict) -> int:
        return self._svc._guard(
            self._what, lambda: self._svc.store.write(table, frame))


class ServeService:
    """The query layer's business logic, transport-free (the handler maps
    exceptions to status codes; tests call methods directly).

    ``store`` is any Store backend.  ``compute_on_miss`` gates the
    products.save-path computation for absent product rows; with it off
    the layer is strictly read-only and absent rows 404.
    """

    def __init__(self, store, cfg=None, *, cache: LRUCache | None = None,
                 gens: StoreGenerations | None = None,
                 admission: AdmissionControl | None = None,
                 breaker=None, compute_on_miss: bool = True, alerts=None,
                 pyramid=None, changefeed=None):
        from firebird_tpu_torch.config import Config
        from firebird_tpu_torch.retry import CircuitBreaker

        cfg = cfg or Config.from_env()
        self.cfg = cfg
        self.store = store
        self.gens = gens or StoreGenerations()
        self.cache = cache if cache is not None else LRUCache(
            cfg.serve_cache_entries, spill_dir=cfg.serve_cache_dir or None)
        self.flight = SingleFlight()
        self.admission = admission or AdmissionControl(
            cfg.serve_inflight, cfg.serve_queue, cfg.serve_deadline_sec)
        if breaker is None and cfg.breaker_threshold > 0:
            breaker = CircuitBreaker(cfg.breaker_threshold,
                                     cfg.breaker_cooldown_sec,
                                     name="serve-store")
        self.breaker = breaker
        self.compute_on_miss = bool(compute_on_miss)
        # Alert feed (alerts/feed.AlertFeed) — None when the store has
        # no alert log; the /v1/alerts endpoints then answer 404.
        self.alerts = alerts
        # Quadkey tile pyramid (serve/pyramid.TilePyramid) — None when
        # no pyramid root is configured; /v1/pyramid then answers 404.
        # The pyramid shares this service's SingleFlight, so concurrent
        # cold tile misses coalesce like product misses do.
        self.pyramid = pyramid
        if pyramid is not None:
            if pyramid.flight is None:
                pyramid.flight = self.flight
            if pyramid.read_chip is None:
                # Base tiles render through this service's cached,
                # compute-on-miss raster path — byte-identical to the
                # products.save output, warming the same cache.
                pyramid.read_chip = self.pyramid_read_chip()
            # In-process writes through the watched store dirty the
            # pyramid too (the changefeed covers other processes).
            self.gens.on_bump = \
                lambda table, cx, cy: pyramid.invalidate_chip(cx, cy)
        # Changefeed consumer (serve/changefeed.ChangefeedConsumer) —
        # owned by the caller (start/stop lifecycles belong to the serve
        # command); mounted here for /healthz context and status.
        self.changefeed = changefeed
        # Fault seam (faults.py ``serve`` scope): when the plan names
        # this scope, every /v1 request fires the injector before
        # admission — an injected failure answers 503, the serving
        # brownout the black-box prober (obs/prober.py) exists to see.
        from firebird_tpu_torch import faults
        plan = faults.FaultPlan.from_config(cfg)
        self.fault_injector = plan.injector("serve") \
            if plan is not None else None
        # One tile-model class-order lookup per tile, shared across
        # requests; invalidated wholesale when the tile table changes.
        self._classes: dict = {}
        self._classes_gen = -1

    # -- store sharing ------------------------------------------------------

    def watched_store(self):
        """The store wrapped so *writers* in this process (a live driver
        run, products.save) invalidate serve-cache entries as they land
        — hand this to anything that writes while serving is up."""
        return watch_store(self.store, self.gens)

    def degraded(self) -> bool:
        """Alive but cache-only: the store breaker is not closed."""
        return self.breaker is not None and self.breaker.state != 0

    # -- guarded store access ----------------------------------------------

    def _guard(self, what: str, fn):
        """Run a store operation behind the breaker.  Open circuit →
        StoreDegraded (503, cache-only mode); a failure → StoreError
        (503) and a breaker strike."""
        br = self.breaker
        if br is None:
            try:
                return fn()
            except (BadRequest, NotFound):
                raise
            except Exception as e:
                raise StoreError(f"{what} failed: {e}") from e
        ok, wait = br.try_acquire()
        if not ok:
            obs_metrics.counter(
                "serve_degraded_misses_total",
                help="requests refused because the store breaker is open "
                     "and the answer was not cached").inc()
            raise StoreDegraded(wait or br.cooldown_sec)
        try:
            result = fn()
        except (BadRequest, NotFound):
            # The request's fault, not the store's: no breaker strike.
            raise
        except Exception as e:
            br.record_failure()
            raise StoreError(f"{what} failed: {e}") from e
        else:
            br.record_success()
            return result

    # -- cache plumbing -----------------------------------------------------

    def _cached(self, key: tuple, build, deadline=None):
        """Two-tier cache lookup with single-flight fill: concurrent
        misses of one key coalesce into one ``build()``; only the
        leader populates the cache.  A follower's wait is bounded by
        its own ``deadline``."""
        v = self.cache.get(key)
        if v is not None:
            return v

        def fill():
            built = build()
            self.cache.put(key, built)
            return built

        return self.flight.do(key, fill, deadline=deadline)

    def _seg_key(self, cx: int, cy: int) -> tuple:
        return ("segment", cx, cy, self.gens.gen("segment", cx, cy))

    def _prod_key(self, name: str, date: str, cx: int, cy: int) -> tuple:
        # Product rasters derive from the chip's segments, the stored
        # product row, AND (for cover) the tile model — any of the three
        # changing must invalidate.
        return ("product", name, date, cx, cy,
                self.gens.gen("segment", cx, cy),
                self.gens.gen("product", cx, cy),
                self.gens.table_gen("tile"))

    # -- queries -------------------------------------------------------------

    def segments(self, cx: int, cy: int, deadline=None) -> dict:
        """A chip's segment frame (dict of columns), cached."""
        key = self._seg_key(cx, cy)
        return self._cached(key, lambda: self._guard(
            f"segment read ({cx}, {cy})",
            lambda: self.store.read("segment", {"cx": cx, "cy": cy})),
            deadline=deadline)

    def _tile_classes(self, cx: int, cy: int):
        gen = self.gens.table_gen("tile")
        if gen != self._classes_gen:
            self._classes = {}
            self._classes_gen = gen
        from firebird_tpu_torch import products

        return self._guard(
            "tile model read",
            lambda: products.tile_classes(self.store, cx, cy, self._classes))

    def product_raster(self, name: str, date: str, cx: int, cy: int,
                       deadline=None) -> np.ndarray:
        """One chip's [10000] int32 product raster: stored row if present,
        else (compute_on_miss) the products.save-path computation —
        computed once under single-flight and persisted, so the store
        warms as it serves."""
        from firebird_tpu_torch import products
        from firebird_tpu_torch.utils import dates as dt

        if name not in products.PRODUCTS:
            raise BadRequest(f"unknown product {name!r}; available: "
                             f"{products.PRODUCTS}")
        try:
            date_ord = dt.to_ordinal(date)
        except (ValueError, TypeError) as e:
            raise BadRequest(f"bad date {date!r}: {e}") from e
        key = self._prod_key(name, date, cx, cy)

        def build() -> np.ndarray:
            rows = self._guard(
                f"product read ({name}@{date}, {cx}, {cy})",
                lambda: self.store.read("product", {
                    "name": name, "date": date, "cx": cx, "cy": cy}))
            if rows["cells"]:
                return np.asarray(rows["cells"][0], np.int32)
            if not self.compute_on_miss:
                raise NotFound(
                    f"no stored product row ({name}@{date}, chip {cx},{cy})"
                    " and compute-on-miss is disabled")
            if deadline is not None:
                deadline.check("product computation")
            seg = self.segments(cx, cy, deadline=deadline)
            if not seg["px"]:
                raise NotFound(f"no segments stored for chip ({cx}, {cy})")
            classes = None
            if name == "cover":
                classes = self._tile_classes(cx, cy)
                if classes is None:
                    raise NotFound(
                        f"cover needs a trained model for the tile of chip "
                        f"({cx}, {cy}); run `firebird classification`")
            obs_metrics.counter(
                "serve_product_computes",
                help="cold product rasters computed on miss (the "
                     "single-flight acceptance counter: N identical "
                     "concurrent misses must bump this ONCE)").inc()
            arrays = products.ChipSegmentArrays(cx, cy, seg)
            # The computation runs OUTSIDE the breaker guard (only its
            # persist write counts as a store op — _GuardedWriter), and
            # persists through the RAW store: the row written is exactly
            # the value being cached, so bumping the generation here
            # would only invalidate our own fresh entry.
            return products.save_chip_raster(
                _GuardedWriter(self, f"product write ({name}@{date}, "
                                     f"{cx}, {cy})"),
                name, date, date_ord, cx, cy, arrays, classes=classes)

        return self._cached(key, build, deadline=deadline)

    def pixel(self, x: float, y: float, date: str, deadline=None) -> dict:
        """Per-pixel product answers at projection point (x, y), date D."""
        from firebird_tpu_torch.ingest.packer import CHIP_SIDE, PIXEL_SIZE_M
        from firebird_tpu_torch.products import PRODUCTS

        cxf, cyf = grid.snap(x, y)["chip"]["proj-pt"]
        cx, cy = int(cxf), int(cyf)
        col = int((x - cx) // PIXEL_SIZE_M)
        row = int((cy - y) // PIXEL_SIZE_M)
        if not (0 <= col < CHIP_SIDE and 0 <= row < CHIP_SIDE):
            raise BadRequest(f"point ({x}, {y}) does not land in chip "
                             f"({cx}, {cy})")
        idx = row * CHIP_SIDE + col
        values: dict[str, int | None] = {}
        for name in PRODUCTS:
            try:
                values[name] = int(self.product_raster(
                    name, date, cx, cy, deadline=deadline)[idx])
            except NotFound:
                if name == "cover":
                    values[name] = None   # no trained model is a data gap,
                    continue              # not a request failure
                # Propagate the precise reason (no segments vs no stored
                # product row under --no-compute) — rewriting it would
                # send the operator to debug the wrong stage.
                raise
        return {"x": x, "y": y, "date": date, "cx": cx, "cy": cy,
                "pixel": {"row": row, "col": col}, "products": values}

    def tile_mosaic(self, name: str, date: str,
                    bounds: list[tuple[float, float]], deadline=None):
        """Mosaic over the bounds area via export.mosaic, each chip read
        through the serve cache (and computed on miss).  Returns
        (cells [H, W] int32, ulx, uly)."""
        from firebird_tpu_torch import export

        def read_chip(n, d, cx, cy):
            try:
                return self.product_raster(n, d, int(cx), int(cy),
                                           deadline=deadline)
            except NotFound:
                return None   # absent chips fill with FILL_VALUE

        return export.mosaic(name, date, bounds, self.store,
                             read_chip=read_chip)

    # -- pyramid ------------------------------------------------------------

    def pyramid_read_chip(self, deadline=None):
        """The pyramid's base-tile renderer: this service's cached,
        compute-on-miss raster path — a base tile is byte-identical to
        the ``products.save`` raster, and building one warms the same
        cache the point endpoints use."""
        def read_chip(name, date, cx, cy):
            try:
                return self.product_raster(name, date, int(cx), int(cy),
                                           deadline=deadline)
            except NotFound:
                return None   # absent chips render as FILL
        return read_chip

    def pyramid_tile(self, name: str, date: str, z: int, x: int, y: int,
                     deadline=None):
        """One pyramid tile ``(cells [side, side] int32, meta)``; 404
        when no pyramid is mounted, the tile address is off-domain, or
        a cold tile sits past the compute-on-miss depth floor."""
        from firebird_tpu_torch import products
        from firebird_tpu_torch.utils import dates as dt

        if self.pyramid is None:
            raise NotFound(
                "no pyramid root configured — set "
                "FIREBIRD_SERVE_PYRAMID_DIR (or FIREBIRD_SERVE_CACHE_DIR; "
                "docs/SERVING.md) and precompute with "
                "`firebird pyramid build`")
        if name not in products.PRODUCTS:
            raise BadRequest(f"unknown product {name!r}; available: "
                             f"{products.PRODUCTS}")
        try:
            dt.to_ordinal(date)
        except (ValueError, TypeError) as e:
            raise BadRequest(f"bad date {date!r}: {e}") from e
        try:
            return self.pyramid.tile(name, date, z, x, y,
                                     deadline=deadline)
        except ValueError as e:
            raise BadRequest(str(e)) from e
        except LookupError as e:
            raise NotFound(str(e)) from e

    # -- ETags (edge offload) ----------------------------------------------

    def product_etag(self, name: str, date: str, cx: int, cy: int) -> str:
        """Strong ETag for one product raster: the (segment, product,
        tile-model) generations the cache key embeds — cheap to derive
        (no body computation) and bumped by exactly the writes that
        change the answer, in-process (watched store) and cross-process
        (changefeed) alike.  Replica-local: a peer restarted since may
        mint a different tag for the same bytes, which costs one full
        revalidation, never a stale hit."""
        return (f'"p-{name}-{date}-{cx}-{cy}-'
                f'g{self.gens.gen("segment", cx, cy)}.'
                f'{self.gens.gen("product", cx, cy)}.'
                f'{self.gens.table_gen("tile")}"')

    def tile_etag(self, name: str, date: str, bounds) -> str:
        """Strong ETag for a mosaic: a digest over every covering
        chip's generation triple — any chip changing changes the tag."""
        import hashlib

        from firebird_tpu_torch import products

        h = hashlib.sha256(f"{name}@{date}".encode())
        for cx, cy in products.covering_chips(bounds):
            h.update(b"%d,%d:%d.%d;" % (
                cx, cy, self.gens.gen("segment", cx, cy),
                self.gens.gen("product", cx, cy)))
        h.update(str(self.gens.table_gen("tile")).encode())
        return f'"t-{h.hexdigest()[:24]}"'

    @staticmethod
    def pyramid_etag(meta: dict) -> str:
        """Strong ETag for a pyramid tile: the persisted version
        counter, which survives invalidation (stale-stamping never
        resets it) — stable across replica restarts sharing one
        pyramid dir."""
        return (f'"py-{meta["name"]}-{meta["date"]}-{meta["z"]}-'
                f'{meta["x"]}-{meta["y"]}-v{meta["version"]}"')

    # -- alert feed ---------------------------------------------------------

    def alert_feed(self):
        """The mounted alerts/feed.AlertFeed; NotFound (404) when this
        store has no alert log behind it (streaming never ran, or
        FIREBIRD_ALERTS=0)."""
        if self.alerts is None:
            raise NotFound(
                "no alert log behind this endpoint — run the streaming "
                "driver against this store, or set FIREBIRD_ALERT_DB "
                "(docs/ALERTS.md)")
        return self.alerts


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------

def _one(query: dict, name: str, cast, required: bool = True):
    vals = query.get(name)
    if not vals:
        if required:
            raise BadRequest(f"missing query parameter {name!r}")
        return None
    try:
        return cast(vals[0])
    except (TypeError, ValueError) as e:
        raise BadRequest(f"bad {name}={vals[0]!r}: {e}") from e


def _bounds_param(query: dict) -> list[tuple[float, float]]:
    raw = query.get("bounds")
    if not raw:
        raise BadRequest("missing query parameter 'bounds' "
                         "(repeatable, 'x,y')")
    out = []
    for b in raw:
        try:
            xs, ys = b.split(",")
            out.append((float(xs), float(ys)))
        except ValueError as e:
            raise BadRequest(f"bad bounds={b!r}: {e}") from e
    return out


def _npy_bytes(cells: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, cells)
    return buf.getvalue()


class _ServeHandler(httpd.JsonHandler):
    server_version = "firebird-serve/1"
    log_category = "serve"

    def _req_ctx(self) -> tracing.TraceContext:
        """The request's trace context: adopt a well-formed inbound
        ``X-Firebird-Trace`` (a fleet caller joining its own causal
        chain — httpd._send echoes it back, so the id round-trips), else
        mint a fresh ``req-<hex>`` id.  Adoption is per-request and
        thread-local: requests coalesced by single-flight each keep
        their OWN id (only the leader's thread runs the fill)."""
        inbound = tracing.from_wire(self.headers.get("X-Firebird-Trace"))
        return inbound or tracing.TraceContext(
            f"req-{uuid.uuid4().hex[:12]}")

    def _route(self, path: str, query: dict) -> None:
        svc: ServeService = self.server.service
        if path == "/healthz":
            body = b"degraded\n" if svc.degraded() else b"ok\n"
            self._send(200, body, "text/plain")
            return
        if path == "/metrics":
            self._send(200, obs_metrics.get_registry().prometheus().encode(),
                       "text/plain; version=0.0.4")
            return
        if path == "/v1/products":
            from firebird_tpu_torch.products import PRODUCTS
            self._send_json(200, {"products": list(PRODUCTS)})
            return
        if path == "/v1/alerts/stream":
            # Long-lived SSE: its own envelope — same admission gate and
            # trace minting as _v1, but the session intentionally spans
            # the deadline window and must not land a multi-second
            # "latency" in serve_request_seconds (it would poison the
            # serve_p99 SLO with sessions that are SUPPOSED to be long).
            self._v1_alert_stream(svc, query)
            return
        if path.startswith("/v1/"):
            self._v1(svc, path, query)
            return
        self._send_json(404, {
            "error": f"unknown path {path!r}",
            "paths": ["/healthz", "/metrics", "/v1/products",
                      "/v1/segments", "/v1/pixel", "/v1/product/<name>",
                      "/v1/tile/<name>",
                      "/v1/pyramid/<name>/<z>/<x>/<y>", "/v1/alerts",
                      "/v1/alerts/stream", "/v1/alerts/webhooks"]})

    def _route_post(self, path: str, query: dict) -> None:
        """POST /v1/alerts/webhooks?url=… registers a webhook subscriber
        (idempotent on url — re-registering keeps the durable cursor but
        replaces AOI and policy); ``bbox=minx,miny,maxx,maxy`` scopes it
        to an AOI through the quadkey subscription index,
        ``mode=immediate|digest|batch`` with ``window``/``max_n`` picks
        the delivery policy (docs/ALERTS.md "Fanout plane").  DELETE is
        deliberately absent: unsubscribing is an operator action on the
        alert db, not an open endpoint."""
        svc: ServeService = self.server.service
        if path != "/v1/alerts/webhooks":
            super()._route_post(path, query)
            return
        ctx = self._req_ctx()
        status = "ok"
        with tracing.activate(ctx):
            try:
                try:
                    feed = svc.alert_feed()
                    url = _one(query, "url", str)
                    since = _one(query, "since", int, required=False)
                    aoi = self._bbox(query)
                    mode = _one(query, "mode", str,
                                required=False) or "immediate"
                    window = _one(query, "window", float, required=False)
                    max_n = _one(query, "max_n", int, required=False)
                    sid = feed.log.subscribe(
                        url, cursor=since, aoi=aoi, mode=mode,
                        window_sec=window, max_n=max_n,
                        max_cells=svc.cfg.fanout_max_cells)
                except NotFound as e:
                    status = "not_found"
                    self._send_json(404, {"error": str(e)})
                    return
                except (BadRequest, ValueError) as e:
                    status = "bad_request"
                    self._send_json(400, {"error": str(e)})
                    return
                self._send_json(200, {"id": sid, "url": url,
                                      "mode": mode, "aoi": aoi,
                                      "latest": feed.log.latest_cursor()})
            finally:
                obs_metrics.counter("serve_requests_total",
                                    help="/v1 requests served").inc()
                if status != "ok":
                    obs_metrics.counter(
                        "serve_errors_total",
                        help="/v1 requests answered with a non-200 "
                             "status").inc()

    def _v1(self, svc: ServeService, path: str, query: dict) -> None:
        from firebird_tpu_torch.serve.flight import Deadline

        # One TraceContext per request (the drivers' per-batch contract
        # at request granularity): every span, log line, and histogram
        # exemplar below carries this id, and httpd._send echoes it to
        # the client as X-Firebird-Trace — a slow call joins to its
        # server-side trace on one key.  Requests coalesced by
        # single-flight each keep their OWN id (the context is
        # thread-local; only the leader's thread runs the fill).
        ctx = self._req_ctx()
        with tracing.activate(ctx):
            with obs_metrics.timer() as tm:
                try:
                    # The deadline starts at ARRIVAL: queue wait +
                    # compute share one budget, so the documented worst
                    # case holds.
                    if svc.fault_injector is not None:
                        svc.fault_injector.fire()
                    deadline = Deadline(svc.admission.deadline_sec)
                    with svc.admission.admit(deadline):
                        self._dispatch(svc, path, query, deadline)
                        status = "ok"
                except Overload as e:
                    status = "rejected"
                    self._send_json(
                        429, {"error": str(e)},
                        {"Retry-After": f"{e.retry_after_sec:.0f}"})
                except DeadlineExceeded as e:
                    status = "deadline"
                    self._send_json(504, {"error": str(e)})
                except StoreDegraded as e:
                    status = "degraded"
                    self._send_json(
                        503, {"error": str(e), "degraded": True},
                        {"Retry-After": f"{e.retry_after_sec:.0f}"})
                except StoreError as e:
                    status = "store_error"
                    self._send_json(503, {"error": str(e)})
                except BadRequest as e:
                    status = "bad_request"
                    self._send_json(400, {"error": str(e)})
                except NotFound as e:
                    status = "not_found"
                    self._send_json(404, {"error": str(e)})
                except OSError as e:
                    # The injected-fault seam (and any raw transport
                    # error the layers below didn't classify): an
                    # outside client sees a 503 — precisely what the
                    # prober's serve surface must count as a failure.
                    status = "fault"
                    self._send_json(503, {"error": str(e)})
            # Observed INSIDE the activation: the latency histogram's
            # exemplars carry this request's trace id.
            obs_metrics.histogram(
                "serve_request_seconds",
                help="end-to-end /v1 request latency (admission wait "
                     "included)").observe(tm.elapsed)
        obs_metrics.counter(
            "serve_requests_total", help="/v1 requests served").inc()
        if status != "ok":
            obs_metrics.counter(
                "serve_errors_total",
                help="/v1 requests answered with a non-200 status").inc()

    # -- edge caching (ETag / If-None-Match / Cache-Control) ----------------

    def _edge_headers(self, svc: ServeService, etag: str) -> dict:
        h = {"ETag": etag}
        ttl = int(getattr(svc.cfg, "serve_edge_ttl", 0))
        if ttl > 0:
            h["Cache-Control"] = f"public, max-age={ttl}"
        return h

    def _not_modified(self, svc: ServeService, etag: str) -> bool:
        """304 the request when its If-None-Match covers ``etag`` —
        BEFORE the body path runs: a revalidation costs a generation
        lookup, not a raster.  True when the 304 went out."""
        inm = self.headers.get("If-None-Match")
        if not inm:
            return False
        # Exact-tag matches only.  `*` is deliberately NOT honored: it
        # matches "any current representation", and this check runs
        # BEFORE the body path decides whether one exists — a 304 here
        # would validate a cached copy of a 404.
        if etag not in (t.strip() for t in inm.split(",")):
            return False
        obs_metrics.counter(
            "serve_304_total",
            help="conditional requests answered 304 Not Modified (the "
                 "edge-offload proof: revalidations that never touched "
                 "the body path)").inc()
        self._send(304, b"", "application/octet-stream",
                   self._edge_headers(svc, etag))
        return True

    def _dispatch(self, svc: ServeService, path: str, query: dict,
                  deadline) -> None:
        if path == "/v1/segments":
            cx = _one(query, "cx", int)
            cy = _one(query, "cy", int)
            obs_metrics.counter("serve_requests_segments").inc()
            frame = svc.segments(cx, cy, deadline=deadline)
            self._send_json(200, {"cx": cx, "cy": cy,
                                  "n": len(frame.get("px", [])),
                                  "segments": frame})
        elif path == "/v1/pixel":
            x = _one(query, "x", float)
            y = _one(query, "y", float)
            date = _one(query, "date", str)
            obs_metrics.counter("serve_requests_pixel").inc()
            self._send_json(200, svc.pixel(x, y, date, deadline=deadline))
        elif path.startswith("/v1/product/"):
            name = path[len("/v1/product/"):]
            cx = _one(query, "cx", int)
            cy = _one(query, "cy", int)
            date = _one(query, "date", str)
            fmt = _one(query, "format", str, required=False) or "json"
            obs_metrics.counter("serve_requests_product").inc()
            etag = svc.product_etag(name, date, cx, cy)
            if self._not_modified(svc, etag):
                return
            cells = svc.product_raster(name, date, cx, cy, deadline=deadline)
            edge = self._edge_headers(svc, etag)
            if fmt == "npy":
                from firebird_tpu_torch.ingest.packer import CHIP_SIDE
                self._send(200,
                           _npy_bytes(cells.reshape(CHIP_SIDE, CHIP_SIDE)),
                           "application/octet-stream",
                           {"X-Firebird-Product": name,
                            "X-Firebird-Date": date,
                            "X-Firebird-Chip": f"{cx},{cy}", **edge})
            elif fmt == "json":
                self._send_json(200, {"name": name, "date": date,
                                      "cx": cx, "cy": cy,
                                      "cells": cells.tolist()}, edge)
            else:
                raise BadRequest(f"unknown format {fmt!r} (json|npy)")
        elif path.startswith("/v1/tile/"):
            name = path[len("/v1/tile/"):]
            date = _one(query, "date", str)
            bounds = _bounds_param(query)
            fmt = _one(query, "format", str, required=False) or "npy"
            obs_metrics.counter("serve_requests_tile").inc()
            etag = svc.tile_etag(name, date, bounds)
            if self._not_modified(svc, etag):
                return
            cells, ulx, uly = svc.tile_mosaic(name, date, bounds,
                                              deadline=deadline)
            edge = self._edge_headers(svc, etag)
            from firebird_tpu_torch.ccd.params import FILL_VALUE
            from firebird_tpu_torch.ingest.packer import PIXEL_SIZE_M
            if fmt == "npy":
                self._send(200, _npy_bytes(cells),
                           "application/octet-stream",
                           {"X-Firebird-Product": name,
                            "X-Firebird-Date": date,
                            "X-Firebird-Ulx": f"{ulx:.1f}",
                            "X-Firebird-Uly": f"{uly:.1f}",
                            "X-Firebird-Pixel-Size-M": PIXEL_SIZE_M,
                            "X-Firebird-Fill": FILL_VALUE, **edge})
            elif fmt == "json":
                self._send_json(200, {
                    "name": name, "date": date, "ulx": ulx, "uly": uly,
                    "pixel_size_m": PIXEL_SIZE_M, "fill": FILL_VALUE,
                    "shape": list(cells.shape), "cells": cells.tolist()},
                    edge)
            else:
                raise BadRequest(f"unknown format {fmt!r} (json|npy)")
        elif path.startswith("/v1/pyramid/"):
            self._pyramid(svc, path, query, deadline)
        elif path == "/v1/alerts":
            obs_metrics.counter(
                "serve_requests_alerts",
                help="/v1/alerts cursor-pull requests").inc()
            self._send_json(200, svc.alert_feed().pull(
                _one(query, "since", int, required=False) or 0,
                limit=_one(query, "limit", int, required=False) or 1000,
                bbox=self._bbox(query),
                t0=self._alert_date(query, "t0"),
                t1=self._alert_date(query, "t1")))
        elif path == "/v1/alerts/webhooks":
            self._send_json(
                200, {"subscribers": svc.alert_feed().log.subscribers()})
        else:
            raise NotFound(f"unknown path {path!r}")

    def _pyramid(self, svc: ServeService, path: str, query: dict,
                 deadline) -> None:
        """``/v1/pyramid/<name>/<z>/<x>/<y>?date=`` — the map-serving
        endpoint: a fresh tile is a static-file read; a conditional hit
        is a meta peek + 304."""
        parts = path[len("/v1/pyramid/"):].split("/")
        if len(parts) != 4:
            raise BadRequest(
                "pyramid path is /v1/pyramid/<name>/<z>/<x>/<y> "
                "(?date=YYYY-MM-DD[&format=npy|json])")
        name = parts[0]
        try:
            z, x, y = (int(v) for v in parts[1:])
        except ValueError as e:
            raise BadRequest(f"bad pyramid address {parts[1:]}: {e}") from e
        date = _one(query, "date", str)
        fmt = _one(query, "format", str, required=False) or "npy"
        if fmt not in ("npy", "json"):
            raise BadRequest(f"unknown format {fmt!r} (npy|json)")
        obs_metrics.counter(
            "serve_requests_pyramid",
            help="/v1/pyramid tile requests (304s included)").inc()
        # Conditional fast path: a FRESH persisted meta answers 304
        # without loading cells; a stale/missing tile falls through to
        # the (rebuilding) body path, whose new version can never match
        # the client's old tag.
        if svc.pyramid is not None:
            meta = svc.pyramid.peek_meta(name, date, z, x, y)
            if meta is not None and not meta.get("stale") and \
                    self._not_modified(svc, svc.pyramid_etag(meta)):
                return
        cells, meta = svc.pyramid_tile(name, date, z, x, y,
                                       deadline=deadline)
        etag = svc.pyramid_etag(meta)
        if self._not_modified(svc, etag):
            return                        # rebuilt to the same version
        edge = self._edge_headers(svc, etag)
        ext = meta.get("extent") or {}
        if fmt == "npy":
            self._send(200, _npy_bytes(cells), "application/octet-stream",
                       {"X-Firebird-Product": name,
                        "X-Firebird-Date": date,
                        "X-Firebird-Quadkey": meta.get("quadkey", ""),
                        "X-Firebird-Ulx": f"{ext.get('ulx', 0):.1f}",
                        "X-Firebird-Uly": f"{ext.get('uly', 0):.1f}",
                        "X-Firebird-Tile-Version": meta["version"],
                        **edge})
        else:
            self._send_json(200, {
                "name": name, "date": date, "z": z, "x": x, "y": y,
                "quadkey": meta.get("quadkey", ""),
                "version": meta["version"], "extent": ext,
                "empty": meta.get("empty"),
                "shape": list(cells.shape),
                "cells": cells.tolist()}, edge)

    # -- alert feed transport ------------------------------------------------

    @staticmethod
    def _bbox(query: dict):
        from firebird_tpu_torch.alerts.feed import parse_bbox

        raw = _one(query, "bbox", str, required=False)
        if raw is None:
            return None
        try:
            return parse_bbox(raw)
        except ValueError as e:
            raise BadRequest(str(e)) from e

    @staticmethod
    def _alert_date(query: dict, name: str):
        """An ISO t0/t1 bound, validated HERE: the SSE path must reject
        a malformed date BEFORE the 200 stream headers go out (an error
        mid-stream writes a second status line into the event body),
        and the pull path owes a 400, not a 500 from deep inside
        since()."""
        from firebird_tpu_torch.utils import dates as dt

        raw = _one(query, name, str, required=False)
        if raw is None:
            return None
        try:
            dt.to_ordinal(raw)
        except (ValueError, TypeError) as e:
            raise BadRequest(f"bad {name}={raw!r}: {e}") from e
        return raw

    def _v1_alert_stream(self, svc: ServeService, query: dict) -> None:
        """``/v1/alerts/stream``: live push over SSE.  Every event's
        ``id:`` is the record's cursor, so a reconnecting client resumes
        with ``since=<last id>`` and misses nothing.  The session holds
        ONE admission slot and is bounded by the request deadline: at
        the window's end the server closes cleanly (clients auto-
        reconnect per the SSE contract) — a slot can be occupied, never
        leaked."""
        from firebird_tpu_torch.serve.flight import Deadline

        ctx = self._req_ctx()
        status = "ok"
        with tracing.activate(ctx):
            obs_metrics.counter(
                "serve_requests_alerts_stream",
                help="/v1/alerts/stream SSE sessions opened").inc()
            try:
                try:
                    feed = svc.alert_feed()
                    since = _one(query, "since", int, required=False)
                    bbox = self._bbox(query)
                    t0 = self._alert_date(query, "t0")
                    t1 = self._alert_date(query, "t1")
                except BadRequest as e:
                    status = "bad_request"
                    self._send_json(400, {"error": str(e)})
                    return
                except NotFound as e:
                    status = "not_found"
                    self._send_json(404, {"error": str(e)})
                    return
                # Default: new alerts only.  since=0 replays the log.
                cursor = feed.log.latest_cursor() if since is None \
                    else int(since)
                try:
                    deadline = Deadline(svc.admission.deadline_sec)
                    with svc.admission.admit(deadline):
                        self._start_stream()
                        gauge = obs_metrics.gauge(
                            "alert_sse_clients",
                            help="live /v1/alerts/stream subscribers")
                        gauge.inc()
                        try:
                            self._sse_loop(feed, cursor, deadline,
                                           bbox=bbox, t0=t0, t1=t1)
                        except Exception as e:
                            # Headers are out: an error now must CLOSE
                            # the stream, not let _dispatch_safely write
                            # a second '500' status line into the event
                            # body (e.g. the alert db closing under a
                            # live session at serve shutdown).  The
                            # client reconnects from its cursor.
                            status = "stream_error"
                            log.warning(
                                "SSE alert session ended by error "
                                "(%s: %s)", type(e).__name__, e)
                        finally:
                            gauge.dec()
                except Overload as e:
                    status = "rejected"
                    self._send_json(
                        429, {"error": str(e)},
                        {"Retry-After": f"{e.retry_after_sec:.0f}"})
                except DeadlineExceeded as e:
                    status = "deadline"
                    self._send_json(504, {"error": str(e)})
            finally:
                # The documented counter contract (docs/OBSERVABILITY.md)
                # covers EVERY /v1 request; only the latency histogram is
                # exempt here (a deliberately long session is not tail
                # latency).
                obs_metrics.counter("serve_requests_total",
                                    help="/v1 requests served").inc()
                if status != "ok":
                    obs_metrics.counter(
                        "serve_errors_total",
                        help="/v1 requests answered with a non-200 "
                             "status").inc()

    def _sse_loop(self, feed, cursor: int, deadline, *, bbox, t0, t1,
                  poll_sec: float = 0.25, page: int = 256) -> None:
        import json as _json
        import time as _time

        filtered = bbox is not None or t0 is not None or t1 is not None
        while True:
            # Captured BEFORE the query: with filters on, a short page
            # means the whole tail up to this head held no more matches,
            # so the scan cursor may jump past it — without this, every
            # poll of a quiet filtered session re-scans the entire
            # unmatched tail (O(log depth), forever).  Rows landing
            # after the capture have higher ids and are not skipped.
            head = feed.log.latest_cursor() if filtered else 0
            recs = feed.log.since(cursor, limit=page, bbox=bbox,
                                  t0=t0, t1=t1)
            for r in recs:
                if not self._stream_event(_json.dumps(r), event="alert",
                                          event_id=r["id"]):
                    return                 # client hung up: normal end
                cursor = r["id"]
            if filtered and len(recs) < page:
                cursor = max(cursor, head)
            left = deadline.remaining()
            if left <= poll_sec:
                # Window over: say so and close cleanly — the client
                # reconnects with since=<last id> and misses nothing.
                self._stream_comment("window over; reconnect to resume")
                return
            if len(recs) == page:
                continue      # a full page means backlog: replay flat out
            if not recs and not self._stream_comment():
                return
            _time.sleep(min(poll_sec, left))


class ServeServer(httpd.Httpd):
    """The serving endpoint server (shared lifecycle: obs/httpd.py)."""

    thread_name = "firebird-serve"

    def __init__(self, addr, service: ServeService):
        super().__init__(addr, _ServeHandler)
        self.service = service


def start_serve_server(port: int, service: ServeService,
                       host: str | None = None) -> ServeServer:
    """Bind and start the query API.  ``port`` 0 binds an ephemeral port
    (tests, serve-smoke).  Bind host comes from ``Config.serve_host`` /
    FIREBIRD_SERVE_HOST (default all interfaces — the endpoint exists
    to be queried); cfg-carrying callers pass it explicitly."""
    if host is None:
        from firebird_tpu_torch.config import env_knob

        host = env_knob("FIREBIRD_SERVE_HOST")
    srv = ServeServer((host, int(port)), service).start()
    log.info("serve endpoint up on %s:%d (/healthz /metrics /v1/products "
             "/v1/segments /v1/pixel /v1/product/<name> /v1/tile/<name>"
             "%s%s)", host, srv.port,
             " /v1/pyramid/<name>/<z>/<x>/<y>"
             if service.pyramid is not None else "",
             " /v1/alerts /v1/alerts/stream /v1/alerts/webhooks"
             if service.alerts is not None else "")
    return srv

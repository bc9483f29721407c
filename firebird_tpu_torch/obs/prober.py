"""Black-box canary prober: the SLO plane's outside view.

The port's own copy of the JAX package's ``obs/prober.py``, host only.
Every number the obs stack has besides this module is white-box
self-report: the process being judged emits the histogram that judges
it, so a wedged serve replica or a dead watcher simply stops reporting
and the SLOs go quiet instead of red.  The prober closes that gap: a
standalone process (``python -m firebird_tpu_torch probe``) that
continuously exercises the real surfaces from outside and emits
``probe_*`` latency/success metrics into its own telemetry spool (role
``prober``), where the series store (obs/series.py) and the error
budgets (obs/slo.py) read them like any other host's.

Surfaces (each armed only when its target is configured):

- **serve**: GET ``/v1/pixel`` and ``/v1/pyramid/<name>/z/x/y`` with
  ETag revalidation (If-None-Match from the previous answer; a 304
  counts as ``probe_etag_304``).  Success is "the service answered under
  500"; transport errors, timeouts and 5xx are failures.
- **alert**: a synthetic scene dropped into the FileSource landing zone,
  bbox'd to a dedicated probe chip, must come back as an alert on the
  ``/v1/alerts/stream`` SSE feed: the full watcher -> fleet queue ->
  worker (the chip's bootstrap and stream jobs on the card) -> alert log
  -> SSE path, timed from the manifest append.  CCD confirms a break
  only after ``SCENES_TO_CONFIRM`` consecutive exceeding acquisitions,
  so the prober runs a conveyor of staggered probe chips (one scene per
  chip per cycle), and one chip confirms (one end-to-end sample) per
  cycle once the pipeline fills.  Probe chips come from a reserved block
  of the watched tile's chip list (``chip_offset``/``chips``) and are
  single-use: the conveyor stops attempting when the reserve is spent
  (reported in :meth:`CanaryProber.status`, counted neither attempt nor
  failure).
- **webhook**: the prober hosts a local sink, registers it via POST
  ``/v1/alerts/webhooks``, and times the same probe alert's arrival
  through the serve process's background deliverer.

No-data honesty: an unresolved probe is neither attempt nor failure
until it resolves (SSE event seen, or the per-probe timeout passes).
The prober itself never loads torch: the conveyor's archive is numpy.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import spool as obs_spool
from firebird_tpu_torch.obs import tracing

PROBE_ROLE = "prober"

# CCD's peek window: consecutive exceeding acquisitions before a break
# confirms — the conveyor depth (one scene per chip per cycle).
SCENES_TO_CONFIRM = 6

BOOT_START = "1995-01-01"
BOOT_END = "1999-01-01"
CADENCE_DAYS = 16
PROBE_STEP = 900.0            # spectral step: well past any CCD band RMSE


def _http_get(url: str, timeout: float, headers: dict | None = None):
    """(status, headers, body, seconds); transport trouble raises."""
    req = urllib.request.Request(url, headers=headers or {})
    t0 = time.time()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read(), time.time() - t0
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, dict(e.headers), body, time.time() - t0


class _WebhookSink:
    """A local sink recording each probe chip's first webhook receipt
    time — the far end of the append -> deliver round trip."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.received: dict = {}      # (cx, cy) -> wall-clock receipt
        self._lock = threading.Lock()
        sink = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length") or 0))
                now = time.time()
                try:
                    recs = json.loads(body).get("alerts", ())
                except ValueError:
                    recs = ()
                with sink._lock:
                    for r in recs:
                        key = (int(r.get("cx", 0)), int(r.get("cy", 0)))
                        sink.received.setdefault(key, now)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        self.port = self._srv.server_address[1]

    def first_receipt(self, cid, after: float) -> float | None:
        with self._lock:
            t = self.received.get(tuple(cid))
        return t if t is not None and t >= after else None

    def close(self) -> None:
        self._srv.shutdown()


class _SSEWatcher(threading.Thread):
    """A persistent ``/v1/alerts/stream`` session recording each probe
    chip's first SSE sighting; reconnects from its cursor when the
    server closes the window or dies (the SSE contract)."""

    def __init__(self, serve_url: str, timeout: float):
        super().__init__(name="firebird-probe-sse", daemon=True)
        self.serve_url = serve_url.rstrip("/")
        self.timeout = timeout
        self.seen: dict = {}          # (cx, cy) -> wall-clock receipt
        self.cursor: int | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def first_seen(self, cid, after: float) -> float | None:
        with self._lock:
            t = self.seen.get(tuple(cid))
        return t if t is not None and t >= after else None

    def stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        while not self._stop.is_set():
            url = f"{self.serve_url}/v1/alerts/stream"
            if self.cursor is not None:
                url += f"?since={self.cursor}"
            try:
                req = urllib.request.Request(url)
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as r:
                    self._consume(r)
            except OSError:
                pass
            self._stop.wait(0.5)

    def _consume(self, resp) -> None:
        event: dict = {}
        for raw in resp:
            if self._stop.is_set():
                return
            line = raw.decode("utf-8", "replace").rstrip("\n").rstrip("\r")
            if not line:                      # dispatch on blank line
                data = event.pop("data", None)
                if data is not None and event.get("event") == "alert":
                    try:
                        rec = json.loads(data)
                    except ValueError:
                        rec = None
                    if rec:
                        now = time.time()
                        with self._lock:
                            self.seen.setdefault(
                                (int(rec.get("cx", 0)),
                                 int(rec.get("cy", 0))), now)
                if "id" in event:
                    try:
                        self.cursor = int(event["id"])
                    except ValueError:
                        pass
                event = {}
                continue
            field, _, value = line.partition(":")
            if field in ("event", "data", "id"):
                event[field] = value.lstrip(" ")


class _AlertConveyor:
    """The staggered probe-chip pipeline: each cycle every in-flight
    chip gains one scene (archive extended, then the scene appended to
    the manifest bbox'd to the chip alone — production chips never see
    probe scenes), and the chip whose scene was its
    ``SCENES_TO_CONFIRM``-th exceeding one becomes this cycle's
    end-to-end alert attempt."""

    def __init__(self, landing: str, x: float, y: float, *,
                 chip_offset: int, chips: int):
        import numpy as np

        from firebird_tpu_torch import grid
        from firebird_tpu_torch.ccd import synthetic
        from firebird_tpu_torch.utils import dates as dt
        from firebird_tpu_torch.utils.fn import take

        self._np = np
        self._synthetic = synthetic
        self._dt = dt
        self.landing = landing
        tile = grid.tile(x=x, y=y)
        cids = [tuple(int(v) for v in c)
                for c in take(chip_offset + chips, grid.chips(tile))]
        self.reserve = cids[chip_offset:]
        self.span = (grid.CONUS.chip.sx, grid.CONUS.chip.sy)
        self.boot_t = synthetic.acquisition_dates(
            BOOT_START, BOOT_END, CADENCE_DAYS)
        self.scene_t = [int(self.boot_t[-1]) + CADENCE_DAYS * (k + 1)
                        for k in range(SCENES_TO_CONFIRM)]
        self._next = 0
        self.in_flight: list = []     # [{"cid", "stage"}]

    def exhausted(self) -> bool:
        return self._next >= len(self.reserve) and not self.in_flight

    def _series(self, cid, upto_ord: int):
        """The chip's clean harmonic archive up to ``upto_ord``, every
        post-boot scene carrying the spectral step (deterministic per
        chip — rebuilt each land, never cached)."""
        np, synthetic = self._np, self._synthetic
        full_t = np.concatenate(
            [self.boot_t, np.asarray(self.scene_t, self.boot_t.dtype)])
        rng = np.random.default_rng(hash(cid) & 0xFFFF)
        base = synthetic.harmonic_series(full_t, rng)
        base = base + np.where(full_t >= self.scene_t[0],
                               PROBE_STEP, 0.0)[None, :]
        m = full_t <= upto_ord
        return full_t[m], np.clip(base[:, m], -32768, 32767).astype(
            np.int16)

    def _land(self, cid, upto_ord: int) -> None:
        import numpy as np

        from firebird_tpu_torch.ingest.packer import CHIP_SIDE, ChipData
        from firebird_tpu_torch.ingest.sources import FileSource

        t, series = self._series(cid, upto_ord)
        spectra = np.ascontiguousarray(np.broadcast_to(
            series[:, :, None, None],
            (series.shape[0], series.shape[1], CHIP_SIDE, CHIP_SIDE)))
        qas = np.full((t.shape[0], CHIP_SIDE, CHIP_SIDE),
                      self._synthetic.QA_CLEAR, np.uint16)
        FileSource(self.landing).save_chip(ChipData(
            cx=cid[0], cy=cid[1], dates=t, spectra=spectra, qas=qas))

    def _bbox(self, cid):
        """A box strictly inside the chip's 3 km cell, so the watcher
        maps the probe scene to this chip and no other."""
        sx, sy = self.span
        cx, cy = cid
        return (cx + 0.25 * sx, cy - 0.75 * sy,
                cx + 0.75 * sx, cy - 0.25 * sy)

    def tick(self) -> list:
        """Advance every in-flight chip one scene; returns the
        confirming appends as ``[{"cid", "scene_id", "t_appended"}]``."""
        from firebird_tpu_torch.ingest.sources import FileSource

        if self._next < len(self.reserve) \
                and len(self.in_flight) < SCENES_TO_CONFIRM:
            self.in_flight.append(
                {"cid": self.reserve[self._next], "stage": 0})
            self._next += 1
        fs = FileSource(self.landing)
        confirmed = []
        for chip in list(self.in_flight):
            stage = chip["stage"]          # scenes appended so far
            cid = chip["cid"]
            date_ord = self.scene_t[stage]
            self._land(cid, date_ord)
            iso = self._dt.to_iso(date_ord)
            sid = f"PROBE_{cid[0]}_{cid[1]}_{stage}"
            fs.append_scene(sid, date=iso, bbox=self._bbox(cid))
            chip["stage"] = stage + 1
            if chip["stage"] >= SCENES_TO_CONFIRM:
                self.in_flight.remove(chip)
                confirmed.append({"cid": cid, "scene_id": sid,
                                  "t_appended": time.time()})
        return confirmed


class CanaryProber:
    """The standing canary: one :meth:`cycle` per ``interval``, every
    surface probed from outside, ``probe_*`` metrics into this
    process's own spool."""

    def __init__(self, cfg, *, serve_url: str | None = None,
                 landing: str | None = None, x: float | None = None,
                 y: float | None = None, chip_offset: int = 8,
                 chips: int = 24, pixel_date: str = "2010-01-01",
                 pyramid_product: str = "ccd",
                 interval: float | None = None,
                 timeout: float | None = None):
        if cfg.probe_sec <= 0 and interval is None:
            raise ValueError(
                "FIREBIRD_PROBE_SEC=0 — the prober refuses to arm "
                "(the zero-cost path)")
        if serve_url is None and landing is None:
            raise ValueError(
                "prober needs at least one surface: a serve URL "
                "and/or a FileSource landing zone")
        if landing is not None and (x is None or y is None):
            raise ValueError(
                "the alert probe needs the watched tile's -x/-y")
        self.cfg = cfg
        self.serve_url = serve_url.rstrip("/") if serve_url else None
        self.interval = float(interval if interval is not None
                              else cfg.probe_sec)
        self.timeout = float(timeout if timeout is not None
                             else cfg.probe_timeout)
        self.pixel = (x, y, pixel_date)
        self.pyramid_product = pyramid_product
        self._etags: dict = {}
        self.conveyor = _AlertConveyor(
            landing, x, y, chip_offset=chip_offset, chips=chips) \
            if landing is not None else None
        self.sse: _SSEWatcher | None = None
        self.sink: _WebhookSink | None = None
        self.pending: list = []       # unresolved alert/webhook probes
        self.cycles = 0
        self._webhook_registered = False

    # -- bookkeeping -------------------------------------------------------

    @staticmethod
    def _attempt(surface: str, ok: bool) -> None:
        obs_metrics.counter(
            "probe_attempts",
            help="black-box probes resolved (all surfaces)").inc()
        obs_metrics.counter(
            f"probe_attempts_{surface}",
            help="black-box probes resolved, by surface").inc()
        if not ok:
            obs_metrics.counter(
                "probe_failures",
                help="black-box probes failed (timeout, transport "
                     "error, or 5xx)").inc()
            obs_metrics.counter(
                f"probe_failures_{surface}",
                help="black-box probe failures, by surface").inc()

    # -- serve surface -----------------------------------------------------

    def _probe_url(self, url: str) -> None:
        headers = {}
        etag = self._etags.get(url)
        if etag:
            headers["If-None-Match"] = etag
        try:
            status, hdrs, _, dt_s = _http_get(url, self.timeout, headers)
        except OSError:
            self._attempt("serve", False)
            return
        if status == 304:
            obs_metrics.counter(
                "probe_etag_304",
                help="probe conditional GETs answered 304 (ETag "
                     "revalidation worked end to end)").inc()
        elif status == 200 and hdrs.get("ETag"):
            self._etags[url] = hdrs["ETag"]
        ok = status < 500
        if ok:
            obs_metrics.histogram(
                "probe_serve_seconds",
                help="black-box serve GET seconds (the outside view "
                     "of /v1 latency)").observe(dt_s)
        self._attempt("serve", ok)

    def probe_serve(self) -> None:
        x, y, date = self.pixel
        if x is not None:
            self._probe_url(f"{self.serve_url}/v1/pixel?x={x}&y={y}"
                            f"&date={date}")
        self._probe_url(f"{self.serve_url}/v1/pyramid/"
                        f"{self.pyramid_product}/0/0/0?date={date}")

    # -- alert + webhook surfaces ------------------------------------------

    def _resolve_pending(self) -> None:
        now = time.time()
        for p in list(self.pending):
            t_seen = None
            if p["kind"] == "alert" and self.sse is not None:
                t_seen = self.sse.first_seen(p["cid"], p["t_appended"])
            elif p["kind"] == "webhook" and self.sink is not None:
                t_seen = self.sink.first_receipt(p["cid"],
                                                 p["t_appended"])
            if t_seen is not None:
                obs_metrics.histogram(
                    f"probe_{p['kind']}_seconds",
                    help="black-box scene drop -> alert visibility "
                         "seconds, by egress surface").observe(
                    t_seen - p["t_appended"])
                self._attempt(p["kind"], True)
                self.pending.remove(p)
            elif now - p["t_appended"] > p["deadline"]:
                self._attempt(p["kind"], False)
                self.pending.remove(p)

    def probe_alerts(self) -> None:
        for c in self.conveyor.tick():
            # The end-to-end deadline is the full pipeline's, not one
            # request's: scene -> watcher poll -> bootstrap + stream
            # jobs -> alert append -> SSE/webhook egress.
            deadline = max(self.timeout,
                           4 * self.interval + self.timeout)
            self.pending.append({"kind": "alert", "cid": c["cid"],
                                 "t_appended": c["t_appended"],
                                 "deadline": deadline})
            if self.sink is not None:
                self.pending.append({"kind": "webhook", "cid": c["cid"],
                                     "t_appended": c["t_appended"],
                                     "deadline": deadline})

    # -- lifecycle ---------------------------------------------------------

    def _register_webhook(self) -> None:
        """POST the sink to ``/v1/alerts/webhooks`` with ``since`` at
        the log's current latest — a canary wants new alerts, not a
        backlog replay.  Retried from :meth:`cycle` until it lands, so
        a serve restart between arm and first probe self-heals."""
        try:
            _, _, body, _ = _http_get(
                f"{self.serve_url}/v1/alerts?limit=1", self.timeout)
            latest = int(json.loads(body).get("latest", 0))
            req = urllib.request.Request(
                f"{self.serve_url}/v1/alerts/webhooks"
                f"?url=http://127.0.0.1:{self.sink.port}/probe"
                f"&since={latest}", data=b"", method="POST")
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                self._webhook_registered = r.status == 200
        except (OSError, ValueError):
            pass

    def arm(self) -> "CanaryProber":
        obs_spool.arm(self.cfg, PROBE_ROLE)
        if self.serve_url is not None:
            self.sse = _SSEWatcher(self.serve_url, self.timeout)
            self.sse.start()
            if self.conveyor is not None:
                self.sink = _WebhookSink()
                self._register_webhook()
        return self

    def cycle(self) -> None:
        self.cycles += 1
        with tracing.span("probe_cycle", cycle=self.cycles):
            if self.sink is not None and not self._webhook_registered:
                self._register_webhook()
            if self.serve_url is not None:
                self.probe_serve()
            if self.conveyor is not None and not self.conveyor.exhausted():
                self.probe_alerts()
            self._resolve_pending()
        sp = obs_spool.active()
        if sp is not None:
            sp.snapshot()

    def status(self) -> dict:
        return {"cycles": self.cycles, "interval_sec": self.interval,
                "timeout_sec": self.timeout,
                "serve_url": self.serve_url,
                "pending": len(self.pending),
                "alert_reserve_exhausted":
                    (self.conveyor.exhausted()
                     if self.conveyor is not None else None)}

    def run(self, stop: threading.Event | None = None,
            cycles: int | None = None) -> None:
        stop = stop or threading.Event()
        while not stop.is_set():
            t0 = time.time()
            self.cycle()
            if cycles is not None and self.cycles >= cycles:
                return
            stop.wait(max(self.interval - (time.time() - t0), 0.05))

    def close(self) -> None:
        if self.sse is not None:
            self.sse.stop()
        if self.sink is not None:
            self.sink.close()
        obs_spool.disarm()

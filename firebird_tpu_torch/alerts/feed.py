"""Alert feed: the consumer side of the durable alert log.

The port's own copy of the JAX package's ``alerts/feed.py``, host only.
Three delivery modes over one cursor contract (alerts/log.py: the record
id is the cursor):

- **Pull** (``/v1/alerts?since=&bbox=&t0=&t1=``): a page of records past
  the caller's cursor plus the page's new cursor (poll-and-remember).
- **Push, SSE** (``/v1/alerts/stream``): a long-lived
  ``text/event-stream`` response where every event carries the record id
  as the SSE ``id:`` field, so a reconnecting client resumes with
  ``since=<last id>`` and misses nothing.  Mounted in serve/api.py over
  the shared httpd streaming support.
- **Push, webhooks**: registered subscriber URLs receive JSON batches
  POSTed by :class:`WebhookDeliverer`; each subscriber's durable cursor
  (in the alert db) advances only after a 2xx, so delivery crash-resumes
  from exactly the first undelivered record.  Transient delivery failures
  retry under the shared :class:`~firebird_tpu_torch.retry.RetryPolicy`
  (decorrelated jitter).
"""

from __future__ import annotations

import json
import threading
import time
from firebird_tpu_torch import retry as retrylib
from firebird_tpu_torch.alerts.log import AlertLog
from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import spool as obs_spool
from firebird_tpu_torch.obs import tracing

log = logger("alerts")

# Records per webhook POST: bounds one delivery's payload; the cursor
# makes multi-batch catch-up seamless.
WEBHOOK_BATCH = 500


def parse_bbox(raw: str):
    """``"minx,miny,maxx,maxy"`` -> 4-tuple of floats."""
    parts = raw.split(",")
    if len(parts) != 4:
        raise ValueError(f"bbox must be minx,miny,maxx,maxy, got {raw!r}")
    return tuple(float(p) for p in parts)


# Keep-alive connection pool for webhook POSTs, one per (thread,
# scheme, host): a delivery burst POSTs the same few endpoints
# thousands of times, and a fresh TCP connection per request triples
# the per-POST cost.  Thread-local because http.client connections
# are not thread-safe; deliverers are long-lived threads/processes.
_conn_pool = threading.local()


def _default_post(url: str, body: bytes, timeout: float) -> int:
    import http.client
    import urllib.parse

    u = urllib.parse.urlsplit(url)
    key = (u.scheme, u.netloc)
    conns = getattr(_conn_pool, "conns", None)
    if conns is None:
        conns = _conn_pool.conns = {}
    path = u.path or "/"
    if u.query:
        path += "?" + u.query
    for attempt in (0, 1):
        conn = conns.get(key)
        if conn is None:
            cls = (http.client.HTTPSConnection if u.scheme == "https"
                   else http.client.HTTPConnection)
            conn = conns[key] = cls(u.netloc, timeout=timeout)
        try:
            conn.request("POST", path, body,
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            r.read()
            # A 4xx/5xx is an ANSWER, not a transport failure: return
            # the code so the cursor-hold branch handles it instead of
            # the retry loop hammering a permanent 404.
            return r.status
        except (http.client.HTTPException, OSError):
            # A stale kept-alive connection (server closed it between
            # bursts) fails exactly once: retry on a fresh one, and
            # only surface the second, genuine transport failure.
            conn.close()
            conns.pop(key, None)
            if attempt:
                raise
    raise AssertionError("unreachable")


class AlertFeed:
    """The serving layer's view of the alert log: pull pages, feed
    status, and an optional background webhook deliverer."""

    def __init__(self, alog: AlertLog, cfg=None, *, post=None, sleep=None):
        from firebird_tpu_torch.config import Config

        self.log = alog
        self.cfg = cfg or Config.from_env()
        self.deliverer = WebhookDeliverer(alog, self.cfg, post=post,
                                          sleep=sleep)

    def pull(self, since: int = 0, *, limit: int = 1000, bbox=None,
             t0=None, t1=None) -> dict:
        """One page past ``since``: the records, the page's new cursor
        (== ``since`` when empty), and the log's latest cursor so a
        client can tell "caught up" from "more pages"."""
        recs = self.log.since(since, limit=limit, bbox=bbox, t0=t0, t1=t1)
        return {
            "alerts": recs,
            "cursor": recs[-1]["id"] if recs else int(since),
            "latest": self.log.latest_cursor(),
        }

    def status(self) -> dict:
        s = self.log.status()
        s["webhook_retries"] = obs_metrics.counter(
            "alert_webhook_retries",
            help="transient webhook-delivery failures retried").value
        return s

    def close(self) -> None:
        self.deliverer.stop()
        self.log.close()


class WebhookDeliverer:
    """Durable-cursor webhook delivery: for each subscriber, POST the
    records past its cursor in batches; advance the cursor only on 2xx.

    ``deliver_once`` is the synchronous unit (tests and the soak drive
    it directly); ``start``/``stop`` run it on a background poll thread
    for ``firebird serve``.  ``post`` is injectable for tests."""

    def __init__(self, alog: AlertLog, cfg, *, poll_sec: float = 1.0,
                 post=None, sleep=None):
        self.log = alog
        self.cfg = cfg
        self.poll_sec = float(poll_sec)
        self._post = post or _default_post
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # The drivers' transient-failure machinery, webhook-flavored —
        # but only ONE inline retry: the poll loop re-sweeps every
        # subscriber each tick anyway, so deep per-sweep backoff would
        # just let a dead receiver starve the healthy ones (delivery is
        # serial per sweep).  Transport errors only; a 4xx/5xx answer
        # comes back as a status code and holds the cursor instead.
        self.policy = retrylib.RetryPolicy(
            1, base=0.5, cap=2.0, sleep=sleep,
            counter_name="alert_webhook_retries",
            counter_help="transient webhook-delivery failures retried")

    def deliver_once(self, *, batch: int = WEBHOOK_BATCH,
                     max_batches: int | None = None) -> int:
        """One delivery sweep over every subscriber; returns records
        delivered.  A subscriber whose POST exhausts its retries keeps
        its cursor (and its place in line next sweep) — one dead
        receiver must not wedge the others.  ``max_batches`` caps the
        POSTs per subscriber per sweep (the soak uses it to leave a
        deliberate backlog for a successor incarnation to catch up)."""
        delivered = 0
        now = time.time()
        for sub in self.log.subscribers():
            # Head-of-line guard: a subscriber parked after consecutive
            # failures is skipped (cursor held) until its decorrelated
            # backoff elapses — one dead endpoint costs the sweep one
            # row check, not its retry budget every tick.
            if sub.get("parked_until") is not None \
                    and float(sub["parked_until"]) > now:
                obs_metrics.counter(
                    "alert_webhook_skipped_parked_total",
                    help="webhook sweep subscriber visits skipped while "
                         "parked after consecutive failures").inc()
                continue
            sent = 0
            while max_batches is None or sent < max_batches:
                recs = self.log.since(sub["cursor"], limit=batch)
                if not recs:
                    break
                sent += 1
                body = json.dumps({
                    "schema": "firebird-alert-webhook/1",
                    "cursor": recs[-1]["id"],
                    "alerts": recs,
                }).encode()
                # The causal chain's last hop: the batch's distinct trace
                # ids (stamped at append time) ride the deliver span and
                # the per-trace delivered marks, closing the scene ->
                # webhook path in the collected fleet trace.
                traces = sorted({r["trace"] for r in recs
                                 if r.get("trace")})
                dctx = tracing.from_wire(traces[0]) \
                    if len(traces) == 1 else None
                try:
                    with tracing.activate(dctx), tracing.span(
                            "deliver", subscriber=sub["id"],
                            records=len(recs)):
                        status = self.policy.run(
                            log, f"webhook {sub['url']}",
                            lambda b=body, u=sub["url"]: self._post(
                                u, b, self.cfg.alert_webhook_timeout))
                except Exception as e:
                    self._failed(sub, f"{type(e).__name__}: {e}")
                    break
                if not 200 <= int(status) < 300:
                    self._failed(sub, f"answered {status}")
                    break
                cursor = recs[-1]["id"]
                self.log.advance(sub["id"], cursor)
                sub = dict(sub, cursor=cursor)
                delivered += len(recs)
                for tr in traces:
                    obs_spool.mark("alert_delivered", trace=tr,
                                   subscriber=sub["id"], cursor=cursor)
                obs_metrics.counter(
                    "alert_webhook_delivered_total",
                    help="alert records delivered to webhook "
                         "subscribers (2xx-acknowledged)").inc(len(recs))
        return delivered

    def _failed(self, sub: dict, why: str) -> None:
        """One abandoned batch: count the failure and — once the
        subscriber hits ``fanout_park_after`` consecutive failures —
        park it under decorrelated backoff (the fanout plane's parking
        knobs; a 2xx heals).  The cursor always holds."""
        self.log.record_failure(
            sub["id"], park_after=self.cfg.fanout_park_after,
            base=self.cfg.fanout_park_base_sec,
            cap=self.cfg.fanout_park_cap_sec)
        obs_metrics.counter(
            "alert_webhook_failures_total",
            help="webhook batches abandoned after retries "
                 "(cursor held; redelivered next sweep)").inc()
        log.warning("webhook %s delivery failed (%s); cursor held at "
                    "%d", sub["url"], why, sub["cursor"])

    def start(self) -> "WebhookDeliverer":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="firebird-alert-webhooks",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_sec):
            try:
                self.deliver_once()
            except Exception as e:
                # The poll loop must survive a corrupt subscriber row or
                # a transient db error — delivery is retried next tick.
                log.error("webhook sweep failed (%s: %s)",
                          type(e).__name__, e)

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

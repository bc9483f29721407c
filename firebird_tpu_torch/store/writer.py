"""Async host-side writer: egress overlaps device compute.

The port's own copy of the JAX package's ``store/writer.py``.  A bounded
queue + worker pool drains table frames while the card computes the next
batch; each frame carries the submitting thread's trace context
(obs/tracing.py) into the worker that writes it.  ``flush()`` blocks until
everything queued has landed and raises
any pending write error (once — the error is cleared so the driver's
per-chunk isolation can continue with later chunks, ccdc/core.py:115-124
semantics).  ``close()`` never raises: a terminal error is logged and the
workers are always shut down.

Ordering: frames written with the same ``key`` drain through the same
worker in submission order — the driver keys by chip id so the resume
invariant holds (the segment frame lands last per chip, driver/core.py).
Keyless writes round-robin and carry no ordering guarantee beyond a
single worker.
"""

from __future__ import annotations

import itertools
import queue
import threading

from firebird_tpu_torch.obs import logger
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import tracing

log = logger("change-detection")


def _frame_rows(frame: dict) -> int:
    """Row count of a table frame (all columns share one length)."""
    for v in frame.values():
        try:
            return len(v)
        except TypeError:
            continue
    return 0


class AsyncWriter:
    """``retry`` is an optional :class:`firebird_tpu_torch.retry.RetryPolicy`
    applied around each backend ``store.write`` — a store brownout of a
    few ops heals inline (counted as ``store_write_retries``) instead of
    poisoning the writer and failing the whole chunk's flush."""

    def __init__(self, store, max_queue: int = 16, workers: int = 1,
                 retry=None):
        self.store = store
        self.retry = retry
        n = max(int(workers), 1)
        self._qs = [queue.Queue(maxsize=max_queue) for _ in range(n)]
        self._lock = threading.Lock()
        # First pending write error: set by any worker, popped (and
        # cleared) by the caller thread in write()/flush().
        self._error: Exception | None = None  # guarded-by: _lock
        self._rr = itertools.count()
        self._threads = []
        for q in self._qs:
            t = threading.Thread(target=self._run, args=(q,), daemon=True)
            t.start()
            self._threads.append(t)

    def _run(self, q: queue.Queue):
        while True:
            item = q.get()
            if item is None:
                q.task_done()
                return
            table, frame, ctx = item
            try:
                with self._lock:
                    poisoned = self._error is not None
                if not poisoned:
                    # The enqueueing thread's TraceContext rides the
                    # queue item: this write's span, exemplar and any log
                    # line parent to the batch that produced the frame.
                    # The observe stays inside the activation so the
                    # histogram exemplar sees the batch id.
                    with tracing.activate(ctx):
                        with tracing.span("store_write", table=table), \
                                obs_metrics.timer() as tm:
                            if self.retry is not None:
                                self.retry.run(
                                    log, f"store write to {table}",
                                    lambda: self.store.write(table, frame))
                            else:
                                self.store.write(table, frame)
                        obs_metrics.histogram(
                            "store_write_seconds").observe(tm.elapsed)
                    obs_metrics.counter(
                        "store_rows_written",
                        help="rows landed in the results store").inc(
                        _frame_rows(frame))
            except BaseException as e:  # incl. KeyboardInterrupt: a dead
                # worker with un-acked items would hang flush() forever
                log.error("async write to %s failed: %s", table, e)
                obs_metrics.counter("store_write_errors").inc()
                with self._lock:
                    self._error = e if isinstance(e, Exception) \
                        else RuntimeError(f"writer interrupted: {e!r}")
            finally:
                # Depth BEFORE task_done: the ack releases flush()'s
                # join(), and the gauge must already reflect the drain
                # (success or failure alike) when flush returns — a
                # failing backend must not leave a phantom backlog.
                self._update_depth()
                q.task_done()

    def _pop_error(self) -> Exception | None:
        with self._lock:
            err, self._error = self._error, None
        return err

    def peek_error(self) -> Exception | None:
        """The pending write error WITHOUT clearing it (write()/flush()
        still raise it).  The driver's chunk loop polls this between
        batches (driver/core.py detect_chunk): a retry.NonRetryable error
        sitting here means every further write will reject, so the loop
        abandons the remaining compute instead of discovering the loss at
        the final flush."""
        with self._lock:
            return self._error

    def _check_alive(self) -> None:
        if not all(t.is_alive() for t in self._threads):
            raise RuntimeError("async writer thread is dead")

    def _update_depth(self) -> None:
        # Egress backpressure signal: total frames queued across workers.
        # Gate BEFORE the qsize sweep — each qsize takes that queue's
        # mutex, and the per-frame cost must vanish when metrics are off.
        if obs_metrics.metrics_enabled():
            obs_metrics.gauge("store_queue_depth").set(
                sum(q.qsize() for q in self._qs))

    def write(self, table: str, frame: dict, key=None) -> None:
        """Queue a frame.  Frames sharing ``key`` keep submission order.
        The caller's TraceContext (if any) is captured with the frame and
        re-activated around the backend write on the worker thread."""
        err = self._pop_error()
        if err is not None:
            raise err
        self._check_alive()
        i = (hash(key) if key is not None else next(self._rr)) % len(self._qs)
        self._qs[i].put((table, frame, tracing.current_context()))
        self._update_depth()

    def flush(self) -> None:
        self._check_alive()
        with tracing.span("store_flush"), obs_metrics.timer() as tm:
            for q in self._qs:
                q.join()
        obs_metrics.histogram("store_flush_seconds").observe(tm.elapsed)
        # Authoritative sweep AFTER the joins and BEFORE any raise: all
        # acks happened-before this point, so even if worker-side updates
        # interleaved badly the gauge lands at the true (empty) depth on
        # the failure path too — not just when every write succeeded.
        self._update_depth()
        err = self._pop_error()
        if err is not None:
            raise err

    def close(self) -> None:
        try:
            self.flush()
        except Exception as e:
            log.error("async writer closed with pending error: %s", e)
        for q in self._qs:
            q.put(None)
        for t in self._threads:
            t.join(timeout=30)

"""The stream driver: bootstrap, checkpoint, apply new acquisitions, publish.

The port's counterpart of the JAX package's ``driver/stream.py``.  The
batch driver reruns the whole archive; this driver keeps each pixel's open
tail segment and extends it one acquisition at a time
(``ccd/incremental.py``):

- **bootstrap**: a chip's first run detects over ``acquired`` on the card
  (float32, the capacity check on), persists the chip / pixel / segment
  frames, and seeds a per-chip ``StreamState`` checkpoint in the stream
  statestore (tile-packed slot files by default,
  ``streamops/statestore.py``).  Batches are fetched, packed and staged on
  the prefetch thread (pinned buffers and the copy stream of
  ``driver.core.stage_batch``) while the previous batch computes, and
  drained on the drain stream.
- **update**: later runs fetch only the acquisitions past the
  checkpoint's horizon, move that delta (spectra, QA, design rows and
  days) to the card in one copy each, run ``incremental.step`` once per
  acquisition there, and republish the open tail segments' rows (the same
  sday key, eday and chprob advanced) as keyed upserts.
- **repair**: pixels whose tail broke (``StreamState.needs_batch``) roll
  up per chip into idempotent ``repair`` jobs on the fleet queue
  (``alerts/repair.py``, at most one open job a chip).
- **alerting**: a break confirmed by an update (``break_day`` 0 -> > 0)
  appends one durable record to the alert log (``alerts/log.py``) BEFORE
  the checkpoint saves: a crash between the two re-applies the delta on
  resume and the (pixel, break_day) key absorbs the re-emission, so alerts
  are exactly-once and never lost.

A checkpoint holds the StreamState arrays, the tail segments' identity
(sday, curqa), the design anchor and the horizon (the last ingested
ordinal day).  Entry points run on CUDA unless the caller passes
``device="cpu"``; a knob whose subsystem is not ported
(``config.NOT_PORTED``: the compile cache) makes :func:`stream` refuse
the run.  With FIREBIRD_OBJECT_ROOT set, the store's rows and the
checkpoints are mirrored to the object tier (``store/objectstore.py``).
In a
multi-process run each process takes its strided share of the tile's
chips (``driver.core.host_shard``) on its own card, with one run id.  The
run carries the batch driver's ops surface (``driver.core.start_ops``):
spans (``fetch``, ``pack``, ``dispatch``, ``drain``, ``step``,
``alert``, ``publish``), the progress hooks, the watchdog, the flight
recorder, the profiler and the run report.  Under a fleet worker the
alert append also marks ``alert_appended`` on the worker's telemetry
spool (obs/spool.py).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time

import numpy as np
import torch

from firebird_tpu_torch import grid
from firebird_tpu_torch.alerts import log as alerts_log
from firebird_tpu_torch.alerts import repair as alerts_repair
from firebird_tpu_torch.ccd import harmonic, incremental, kernel, params
from firebird_tpu_torch.ccd import format as ccdformat
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.driver import core as dcore
from firebird_tpu_torch.ingest import pack
from firebird_tpu_torch.obs import Counters, jsonlog, logger
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import profiling as obs_profiling
from firebird_tpu_torch.obs import report as obs_report
from firebird_tpu_torch.obs import server as obs_server
from firebird_tpu_torch.obs import spool as obs_spool
from firebird_tpu_torch.obs import tracing
from firebird_tpu_torch.streamops import statestore as sstore_mod
from firebird_tpu_torch.utils import dates as dt
from firebird_tpu_torch.utils.fn import partition_all, take

_host = sstore_mod._host


def _tail_identity(one: kernel.ChipSegments) -> tuple[np.ndarray, np.ndarray]:
    """(sday, curqa) of each pixel's last segment: the open tail whose row
    the stream keeps republishing under the same (sday, px, py) key."""
    nseg = _host(one.n_segments).astype(np.int64)
    meta = _host(one.seg_meta)
    # clip to the buffer capacity: guards a raw check_capacity=False result
    last = np.minimum(np.maximum(nseg - 1, 0), meta.shape[-2] - 1)
    m = meta.astype(np.float64)[np.arange(nseg.shape[0]), last]
    return m[:, 0], m[:, 4].astype(np.int64)


def seed_side(packed, c: int, one: kernel.ChipSegments) -> dict:
    """A fresh checkpoint's side fields for chip ``c`` of a batch: the tail
    identity, the design anchor (the first date) and the horizon (the
    last)."""
    sday, curqa = _tail_identity(one)
    T = int(packed.n_obs[c])
    return dict(sday=sday, curqa=curqa,
                anchor=np.float64(packed.dates[c][0]),
                horizon=np.float64(packed.dates[c][T - 1]))


def publish_frame(packed, st: incremental.StreamState, side: dict) -> dict:
    """Active pixels' updated tail segments as a segment-table frame.

    The row contract of format.chip_frames; the (cx,cy,px,py,sday,eday)
    key matches the bootstrap row only while eday is unchanged: an advanced
    eday upserts a new row for the same open segment, as a batch rerun over
    a longer range does.  Magnitudes publish as 0 (unbroken tails, and a
    stream-confirmed break until the cold-path rerun computes the residual
    medians)."""
    cx, cy = (int(v) for v in packed.cids[0])
    idx = np.nonzero(_host(st.active))[0]
    coords = packed.pixel_coords(0)[idx]
    anchor = float(side["anchor"])

    bday1 = _host(st.break_day).astype(np.float64)[idx]
    broke = bday1 > 0
    eday = _host(st.end_day).astype(np.float64)[idx]
    bday = np.where(broke, bday1, eday)
    chprob = np.where(
        broke, 1.0,
        _host(st.n_exceed).astype(np.float64)[idx] / params.PEEK_SIZE)
    curqa0 = np.asarray(side["curqa"], np.int64)[idx]
    # a confirmed break closes the tail: END drops, START survives, an
    # interior segment becomes INSIDE (the batch close's rule)
    curqa = np.where(broke,
                     np.where(curqa0 & params.CURVE_QA_START,
                              params.CURVE_QA_START, params.CURVE_QA_INSIDE),
                     curqa0)
    coefs7, intercept = harmonic.to_pyccd_convention(
        _host(st.coefs).astype(np.float64)[idx], anchor)
    rmse = _host(st.rmse).astype(np.float64)[idx]

    R = idx.shape[0]
    ones = np.ones(R, bool)
    frame = {
        "cx": np.full(R, cx, np.int64), "cy": np.full(R, cy, np.int64),
        "px": coords[:, 0], "py": coords[:, 1],
        "sday": ccdformat._iso_col(np.asarray(side["sday"], np.float64)[idx]),
        "eday": ccdformat._iso_col(eday),
        "bday": ccdformat._iso_col(bday),
        "chprob": chprob,
        "curqa": ccdformat._int_or_none(curqa, ones),
        "rfrawp": np.full(R, None, object),
    }
    for b in range(params.NUM_BANDS):
        p = ccdformat.BAND_PREFIX[b]
        frame[f"{p}mag"] = np.zeros(R)
        frame[f"{p}rmse"] = rmse[:, b]
        frame[f"{p}int"] = intercept[:, b]
        col = np.empty(R, object)
        col[:] = list(coefs7[:, b])
        frame[f"{p}coef"] = col
    return frame


def _new_break_records(packed, st: incremental.StreamState,
                       bday0: np.ndarray, anchor: float) -> list[dict]:
    """Alert records for the pixels whose tail break confirmed in this
    update (``break_day`` 0 -> > 0 against the pre-update snapshot).

    ``score`` is the confirmation change probability (n_exceed /
    PEEK_SIZE, 1.0 at confirmation).  ``magnitude`` is the rmse/vario-
    normalized detection-band residual of each pixel's newest usable
    observation (QA clear or water, in sensor range: the step's own
    triage) against the frozen tail model: a provisional deviation scale
    (the cold-path rerun computes the canonical residual medians).  A
    pixel with no usable observation in the window reports 0.0."""
    sensor = packed.sensor
    bday1 = _host(st.break_day).astype(np.float64)
    newly = (bday0 <= 0) & (bday1 > 0)
    idx = np.nonzero(newly)[0]
    if not idx.size:
        return []
    cx, cy = (int(v) for v in packed.cids[0])
    coords = packed.pixel_coords(0)[idx]
    score = _host(st.n_exceed).astype(np.float64)[idx] / params.PEEK_SIZE
    T = int(packed.n_obs[0])
    t = packed.dates[0][:T].astype(np.float64)
    qa = packed.qas[0][idx, :T].astype(np.int64)               # [N, T]
    fill = (qa >> params.QA_FILL_BIT) & 1 == 1
    usable = ((((qa >> params.QA_CLEAR_BIT) & 1 == 1)
               | ((qa >> params.QA_WATER_BIT) & 1 == 1)) & ~fill)
    y = packed.spectra[0][:, idx, :T].astype(np.float64)       # [B, N, T]
    opt = list(sensor.optical_bands)
    usable &= np.all((y[opt] > params.OPTICAL_MIN)
                     & (y[opt] < params.OPTICAL_MAX), axis=0)
    if sensor.thermal_bands:
        th = list(sensor.thermal_bands)
        usable &= np.all((y[th] > params.THERMAL_MIN)
                         & (y[th] < params.THERMAL_MAX), axis=0)
    any_usable = usable.any(axis=1)                            # [N]
    last_t = np.where(any_usable,
                      T - 1 - np.argmax(usable[:, ::-1], axis=1), 0)
    n_arange = np.arange(idx.shape[0])
    y_last = y[:, n_arange, last_t].T                          # [N, B]
    x_rows = harmonic.design_matrix(t, anchor,
                                    params.MAX_COEFS)[last_t]  # [N, 8]
    coefs = _host(st.coefs).astype(np.float64)[idx]
    pred = np.einsum("nbc,nc->nb", coefs, x_rows)
    den = np.maximum(_host(st.rmse).astype(np.float64),
                     _host(st.vario).astype(np.float64))[idx]
    det = list(sensor.detection_bands)
    rel = (y_last - pred)[:, det] / np.maximum(den[:, det], 1e-9)
    magnitude = np.where(any_usable,
                         np.sqrt(np.mean(rel ** 2, axis=1)), 0.0)
    return [{"cx": cx, "cy": cy,
             "px": int(coords[n, 0]), "py": int(coords[n, 1]),
             "break_day": float(bday1[i]), "score": float(score[n]),
             "magnitude": float(magnitude[n])}
            for n, i in enumerate(idx)]


def drain_to_host(seg):
    """The batch result to the host through ``driver.core.fetch_results``,
    on the card's drain stream after the compute stream's work."""
    dev = seg.n_segments.device
    if dev.type != "cuda":
        return dcore.fetch_results(seg)
    stream = dcore._side_stream(dev, "drain")
    stream.wait_stream(torch.cuda.current_stream(dev))
    return dcore.fetch_results(seg, stream=stream)


def _delta_on_device(p, idx, anchor: float, dtype, dev):
    """The delta's acquisitions ``idx`` of chip 0 of ``p`` on the card, one
    copy each: spectra [K, P, B], QA [K, P] int32, design rows [K, 8]
    float32 (one :func:`incremental.design_row` a day, as the JAX
    driver makes them) and days [K] in the state's dtype."""
    days = p.dates[0][idx].astype(np.float64)
    rows = np.stack([incremental.design_row(float(d), anchor) for d in days])
    y = np.ascontiguousarray(p.spectra[0][:, :, idx].transpose(2, 1, 0))
    qa = np.ascontiguousarray(p.qas[0][:, idx].T.astype(np.int32))
    move = lambda a: torch.from_numpy(a).to(dev)
    return move(y), move(qa), move(rows), move(days).to(dtype)


_UPDATE_STAGES = dict(load="statestore_load_seconds",
                      delta_fetch="stream_fetch_seconds",
                      step="stream_step_seconds",
                      step_device="stream_step_device_seconds",
                      alert="stream_alert_seconds",
                      publish="stream_publish_seconds",
                      save="statestore_save_seconds")


def stream_stage_seconds() -> dict:
    """The current run's stage seconds: the bootstrap's pipeline stages
    (``driver.core.stage_seconds``: fetch, pack, stage, dispatch, drain,
    d2h, write) and the update's, each the sum over its chips: checkpoint
    load, delta fetch and pack, the step loop's host wall (its delta copy
    and state fetch included) and its span on the card's timeline (CUDA
    events; 0 on the CPU), the alert append, the publish (frame, queued
    write and checkpoint save) and, inside it, the save."""
    snap = obs_metrics.get_registry().snapshot()["histograms"]
    out = dcore.stage_seconds()
    out.update({k: snap.get(v, {}).get("sum", 0.0)
                for k, v in _UPDATE_STAGES.items()})
    return out


def stream(x, y, acquired: str | None = None, number: int = 2500,
           cfg: Config | None = None, source=None, store=None,
           reset_metrics: bool = True, cids=None,
           published: float | None = None, device=None,
           counters: Counters | None = None) -> dict:
    """Streaming incremental change detection over one tile.

    A chip's first run bootstraps (batch detection + checkpoint); later
    runs apply only acquisitions newer than the checkpoint horizon.  The
    arguments follow the JAX package's ``stream``: ``cids`` scopes the
    pass to given chips instead of the tile's first ``number``;
    ``published`` is the driving scene's publish time (unix seconds), and
    alerts this pass commits observe publish -> durable append in the
    ``acquisition_to_alert_seconds`` histogram; ``reset_metrics=False``
    keeps the caller's metrics registry.  ``device`` is the card (default
    CUDA; "cpu" runs the plain versions); ``counters`` (a fresh one unless
    given) counts the chips done.

    Returns the summary: chips bootstrapped / updated, observations
    applied, pixels flagged for the cold-path rerun, alerts emitted and
    deduplicated, repair jobs enqueued, checkpoints voided, chips
    quarantined."""
    cfg = cfg or Config.from_env()
    dcore.refuse_not_ported(cfg)
    dev = dcore.run_device(device)
    acquired = acquired or dt.default_acquired()
    cfg = dcore.resolve_batching(cfg, acquired, dev)
    log = logger("stream")
    run_id = dcore.fleet_run_id()            # one id for the whole launch
    jsonlog.set_run_context(run_id=run_id)   # setup log lines carry it too
    if reset_metrics:
        obs_metrics.reset_registry()
    # The bootstrap runs float32 whatever cfg.dtype says.
    dcore.build_kernels(dev, dataclasses.replace(cfg, dtype="float32"), log)
    source, store, writer, policy, _breaker, quarantine = \
        dcore.robustness_setup(cfg, run_id, source=source, store=store)
    sstore = sstore_mod.open_statestore(cfg)
    # The durable alert log: None when alerting is off or the store has
    # no file-backed "next to".  An unopenable log degrades alerting,
    # never detection: breaks still publish to the segment table.
    alog = None
    if cfg.alerts_enabled:
        apath = alerts_log.alert_db_path(cfg)
        if apath is not None:
            try:
                alog = alerts_log.AlertLog(apath)
            except Exception as e:
                log.error("alert log %s unavailable (%s: %s) — alert "
                          "emission disabled for this run", apath,
                          type(e).__name__, e)

    tile = grid.tile(x=x, y=y)
    if cids is None:
        cids = dcore.host_shard(list(take(number, grid.chips(tile))))
    else:
        # A pass scoped to given chips takes them all: no sharding.
        cids = [tuple(int(v) for v in c) for c in cids]
    log.info("streaming tile h=%s v=%s: %d chips (acquired %s, state "
             "%s:%s, alerts %s) on %s", tile["h"], tile["v"], len(cids),
             acquired, sstore.backend, sstore_mod.state_dir(cfg),
             alog.path if alog is not None else "off", dev)
    summary = dict(bootstrapped=0, updated=0, obs_applied=0,
                   pixels_need_batch=0, alerts_emitted=0,
                   alerts_deduped=0, repair_jobs_enqueued=0,
                   state_voided=0)
    # Per-chip needs_batch rollup: the update loop fills it, the repair
    # scheduler turns it into fleet jobs at the end of the run.
    needs_by_chip: dict = {}
    # Chips whose fetch failed this run: a just-quarantined chip must not
    # be drained by the success path below.
    failed_cids: set = set()
    counters = Counters() if counters is None else counters

    def fetch_chip(cid, rng_iso):
        try:
            chip = dcore.with_retries(
                cfg, log, f"chip ({cid[0]},{cid[1]}) fetch",
                lambda: source.chip(cid[0], cid[1], rng_iso),
                policy=policy)
        except Exception as e:
            # Per-chip isolation: dead-letter the chip and keep streaming
            # the rest of the tile.
            log.error("chip (%s,%s) failed after retries (%s: %s); "
                      "quarantined", cid[0], cid[1], type(e).__name__, e)
            quarantine.record(cid, e, attempts=cfg.fetch_retries + 1,
                              stage="stream")
            failed_cids.add(tuple(int(v) for v in cid))
            return None
        if chip.sensor != LANDSAT_ARD:
            raise ValueError(
                "stream publishes the reference's Landsat segment "
                f"schema; got sensor {chip.sensor.name!r}")
        if not chip.dates.shape[0]:
            log.warning("chip (%s,%s): no acquisitions in %s; skipping",
                        cid[0], cid[1], rng_iso)
            return None
        return chip

    def save(cid, st, side):
        with obs_metrics.timer() as tm:
            sstore.save(cid, st, side)
        obs_metrics.histogram(
            "statestore_save_seconds",
            help="one chip's checkpoint save").observe(tm.elapsed)

    hi_iso = acquired.split("/")[1]
    boot = [c for c in cids if not sstore.exists(c)]
    upd = [c for c in cids if sstore.exists(c)]
    run_block = dict(kind="stream", run_id=run_id, host=jsonlog.HOST,
                     process_id=dcore._process_index(), tile_h=tile["h"],
                     tile_v=tile["v"], acquired=acquired, chips=len(cids),
                     device=str(dev))
    # The stream's progress unit is a chip (bootstrapped or updated):
    # /progress tracks chips over the tile, and every bootstrap batch and
    # updated chip beats the watchdog.
    _, ops_srv, wd = dcore.start_ops(
        cfg, run_id, "stream", chips_total=len(cids), counters=counters,
        run_block=run_block, quarantine=quarantine, breaker=_breaker,
        alerts=(None if alog is None else lambda: dict(
            alog.status(),
            run={k: summary[k] for k in ("alerts_emitted",
                                         "alerts_deduped",
                                         "pixels_need_batch",
                                         "repair_jobs_enqueued")})),
        streamops=sstore.status)
    tracer = tracing.start(run_id=run_id) \
        if tracing.wants_trace(cfg.trace) else None
    # The whole-run device capture (FIREBIRD_PROFILE_DIR), closed in the
    # finally before the report is written.
    capture = obs_profiling.RunCapture(cfg.profile_dir).start()
    counters.start()
    try:
        # --- bootstrap: batched through the batch driver's stages ---
        batches = list(partition_all(max(cfg.chips_per_batch, 1), boot))
        obs_server.set_stage("bootstrap")
        # One TraceContext a bootstrap batch, carried across the prefetch
        # hop (the batch driver's contract); a pass run under a caller's
        # context inherits it instead of minting.
        inherit = tracing.current_context()
        ctxs = [inherit
                or tracing.TraceContext(tracing.new_batch_id(run_id),
                                        run_id=run_id) for _ in batches]
        with cf.ThreadPoolExecutor(
                max_workers=max(cfg.input_parallelism, 1)) as ex, \
                cf.ThreadPoolExecutor(max_workers=1) as prefetch_ex:

            def prepare(bids, ctx):
                """fetch -> pack -> stage on the prefetch thread; None when
                every chip of the batch was dropped."""
                with tracing.activate(ctx):
                    with tracing.span("fetch", chips=len(bids)), \
                            obs_metrics.timer() as tm:
                        fetched = list(ex.map(
                            lambda c: fetch_chip(c, acquired), bids))
                    obs_metrics.histogram("pipeline_fetch_seconds").observe(tm.elapsed)
                    keep = [(cid, ch) for cid, ch in zip(bids, fetched)
                            if ch is not None]
                    if not keep:
                        return None
                    with tracing.span("pack", chips=len(keep)), \
                            obs_metrics.timer() as tm:
                        p = pack([ch for _, ch in keep],
                                 bucket=cfg.obs_bucket, max_obs=cfg.max_obs)
                    obs_metrics.histogram("pipeline_pack_seconds").observe(tm.elapsed)
                    return keep, dcore.stage_batch(
                        p, torch.float32, cfg.device_sharding, device=dev)

            def bootstrap_batch(keep, staged):
                """dispatch (the capacity check on: a synchronous retry, as
                the JAX package's bootstrap) -> drain -> frames and
                checkpoints, on this thread."""
                with tracing.span("dispatch", chips=staged.n_real), \
                        obs_metrics.timer() as tm:
                    seg, n_real = dcore.detect_batch(
                        staged.packed, torch.float32, cfg.device_sharding,
                        check_capacity=True, staged=staged,
                        compact=cfg.compact, device=dev)
                obs_metrics.histogram("pipeline_dispatch_seconds").observe(tm.elapsed)
                obs_server.batch_dispatched()
                with tracing.span("drain", chips=n_real), \
                        obs_metrics.timer() as tm:
                    host = drain_to_host(seg)
                    kernel.record_occupancy(host)
                    dcore.write_batch_frames(staged.packed, host, n_real,
                                             writer=writer)
                    for c in range(n_real):
                        cid = keep[c][0]
                        one = kernel.chip_slice(host, c)
                        st = incremental.StreamState.from_chip(one,
                                                               device="cpu")
                        summary["bootstrapped"] += 1
                        counters.add("chips")
                        save(cid, st, seed_side(staged.packed, c, one))
                        quarantine.discard(cid)
                        summary["pixels_need_batch"] += int(
                            st.needs_batch.sum())
                obs_metrics.histogram("pipeline_drain_seconds").observe(tm.elapsed)
                return n_real

            nxt = prefetch_ex.submit(prepare, batches[0], ctxs[0]) \
                if batches else None
            for i in range(len(batches)):
                prep = nxt.result()
                nxt = (prefetch_ex.submit(prepare, batches[i + 1],
                                          ctxs[i + 1])
                       if i + 1 < len(batches) else None)
                if prep is None:
                    continue
                keep, staged = prep
                obs_server.dispatch_starting()
                with tracing.activate(ctxs[i]):
                    n_real = bootstrap_batch(keep, staged)
                obs_server.batch_done(n_real)
                del staged

        # --- update: apply only acquisitions past each chip's horizon ---
        def update_one(cid) -> None:
            t_seen = time.monotonic()   # the freshness clock's start
            try:
                with obs_metrics.timer() as tm:
                    st, side = sstore.load(cid)
                obs_metrics.histogram(
                    "statestore_load_seconds",
                    help="one chip's checkpoint load").observe(tm.elapsed)
            except sstore_mod.StateStoreError as e:
                # Every bank failed its checksum: void the slot so that
                # `exists` turns False and the next run re-bootstraps the
                # chip, instead of failing here forever.
                log.error("chip (%s,%s): checkpoint unrecoverable (%s); "
                          "voided — the next stream run re-bootstraps",
                          cid[0], cid[1], e)
                sstore.void(cid)
                summary["state_voided"] += 1
                counters.add("chips")
                return
            horizon = float(side["horizon"])
            p = None
            # fetch only the delta past the horizon
            if horizon < dt.to_ordinal(hi_iso):
                with tracing.span("fetch", chip=tuple(cid), delta=True), \
                        obs_metrics.timer() as tm:
                    rng_iso = f"{dt.to_iso(int(horizon) + 1)}/{hi_iso}"
                    chip = fetch_chip(cid, rng_iso)
                    # pack() warns when the archive exceeds max_obs (the
                    # newest truncated: for a stream that would freeze the
                    # horizon)
                    if chip is not None:
                        p = pack([chip], bucket=cfg.obs_bucket,
                                 max_obs=cfg.max_obs)
                obs_metrics.histogram("stream_fetch_seconds").observe(tm.elapsed)
            new_idx = np.zeros(0, np.int64)
            if p is not None:
                T = int(p.n_obs[0])
                t = p.dates[0][:T].astype(np.float64)
                new_idx = np.nonzero(t > horizon)[0]
            if new_idx.size:
                anchor = float(side["anchor"])
                # Pre-update break snapshot: the 0 -> > 0 transition
                # against it is what emits alerts.
                bday0 = st.break_day.numpy().astype(np.float64)
                with tracing.span("step", chip=tuple(cid),
                                  obs=int(new_idx.size)), \
                        obs_metrics.timer() as tm:
                    y, qa, rows, days = _delta_on_device(
                        p, new_idx, anchor, st.rmse.dtype, dev)
                    st_dev = st.to(dev)
                    ev = None
                    if dev.type == "cuda":
                        ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                    for j in range(new_idx.size):
                        st_dev = incremental.step(st_dev, rows[j], y[j],
                                                  qa[j], days[j],
                                                  sensor=p.sensor)
                    if ev is not None:
                        ev[1].record()
                    st = st_dev.to("cpu")
                obs_metrics.histogram("stream_step_seconds").observe(tm.elapsed)
                if ev is not None:
                    obs_metrics.histogram("stream_step_device_seconds").observe(
                        ev[0].elapsed_time(ev[1]) / 1e3)
                side = dict(side, horizon=np.float64(t[-1]))
                # Alert BEFORE the checkpoint saves: a crash between them
                # re-applies this delta on resume and the (pixel,
                # break_day) key absorbs the re-emission; the reverse
                # order would lose the alert.
                if alog is not None:
                    with obs_metrics.timer() as tm:
                        recs = _new_break_records(p, st, bday0, anchor)
                        ins = dup = 0
                        if recs:
                            trace_id = tracing.to_wire(
                                tracing.current_context())
                            with tracing.span("alert", chip=tuple(cid),
                                              alerts=len(recs)):
                                ins, dup = alog.append(recs, run_id=run_id,
                                                       trace=trace_id)
                    obs_metrics.histogram("stream_alert_seconds").observe(tm.elapsed)
                    if recs:
                        obs_metrics.histogram("alert_visible_seconds",
                             help="stream-update ingest start to durable "
                                  "alert commit (the alert_freshness SLO "
                                  "feed)").observe(time.monotonic() - t_seen)
                        acq_to_alert = None
                        if published is not None:
                            acq_to_alert = max(time.time() - published, 0.0)
                            obs_metrics.histogram("acquisition_to_alert_seconds",
                                 help="scene publish time to durable "
                                      "alert-log append (the end-to-end "
                                      "alert_freshness SLO feed)").observe(
                                acq_to_alert)
                        # The causal chain's durable-append joint, with the
                        # freshness value the histogram observed, so the
                        # collector's critical-path breakdown decomposes
                        # what was measured (obs/collect.py).
                        obs_spool.mark(
                            "alert_appended", trace=trace_id,
                            chip=list(int(v) for v in cid), alerts=ins,
                            deduped=dup, published=published,
                            acq_to_alert=acq_to_alert)
                        summary["alerts_emitted"] += ins
                        summary["alerts_deduped"] += dup
                with tracing.span("publish", chip=tuple(cid)), \
                        obs_metrics.timer() as tm:
                    writer.write("segment", publish_frame(p, st, side),
                                 key=tuple(cid))
                    save(cid, st, side)
                obs_metrics.histogram("stream_publish_seconds").observe(tm.elapsed)
                summary["updated"] += 1
                summary["obs_applied"] += int(new_idx.size)
            n_need = int(st.needs_batch.sum())
            summary["pixels_need_batch"] += n_need
            if n_need:
                needs_by_chip[tuple(int(v) for v in cid)] = n_need
            counters.add("chips")
            if tuple(int(v) for v in cid) not in failed_cids:
                quarantine.discard(cid)

        obs_server.set_stage("update")
        for cid in upd:
            # One TraceContext a chip (the batch driver's per-batch
            # contract at chip granularity), unless the caller's wins.
            with tracing.activate(inherit or tracing.TraceContext(
                    tracing.new_batch_id(run_id), run_id=run_id)):
                update_one(cid)
            # Per-chip progress beat: the watchdog's liveness unit here is
            # a processed chip.
            obs_server.batch_done(1)
        # Cold-path repair scheduling: the flagged pixels become
        # idempotent fleet jobs, at most one open job a chip.  A
        # scheduling failure degrades to the count-only summary.
        obs_metrics.gauge(
            "repair_pixels_pending",
            help="pixels flagged needs_batch awaiting a cold-path "
                 "repair").set(sum(needs_by_chip.values()))
        # Independent of the alert log: FIREBIRD_ALERTS=0 darkens the
        # feed, not the repair loop.
        if cfg.alert_repair and needs_by_chip:
            try:
                jids = alerts_repair.schedule_repairs(
                    cfg, needs_by_chip, acquired=acquired, run_id=run_id)
                summary["repair_jobs_enqueued"] = len(jids)
            except Exception as e:
                log.error("repair scheduling failed (%s: %s) — "
                          "needs_batch debt stays count-only",
                          type(e).__name__, e)
        obs_server.set_stage("flush")
        writer.flush()
    finally:
        obs_server.set_stage("finalize")
        writer.close()
        sstore.close()
        if alog is not None:
            alog.close()
        capture.stop()
        summary["quarantined"] = len(quarantine)
        if summary["quarantined"]:
            log.warning("%d chips in quarantine (%s) — the next stream "
                        "run retries them", summary["quarantined"],
                        quarantine.path or "in-memory")
        for k, v in summary.items():
            obs_metrics.gauge(f"stream_{k}").set(v)
        if tracer is not None:
            tracing.stop()
        paths = obs_report.finish_run(
            cfg, tracer=tracer, run_counters=counters.snapshot(),
            run=dict(run_block, **summary))
        if paths:
            log.info("observability artifacts: %s", paths)
        dcore.last_run_artifacts.clear()
        dcore.last_run_artifacts.update(paths, run_id=run_id)
        obs_server.set_stage("done")
        dcore.stop_ops(ops_srv, wd)
    log.info("stream complete: %s", summary)
    return summary


__all__ = ["drain_to_host", "publish_frame", "seed_side", "stream",
           "stream_stage_seconds"]

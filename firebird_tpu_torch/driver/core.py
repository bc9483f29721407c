"""The batch driver: tile -> chunks -> prefetch -> card -> drain -> store.

The port's counterpart of the JAX package's ``driver/core.py`` batch path:
snap the point to a tile, enumerate its chips, ``partition_all(chunk_size,
take(number, chips))``, run each chunk with failure isolation, and persist
the chip / pixel / segment tables.  Chips are fetched by a host thread pool
(``cfg.input_parallelism``), packed into batches of
``cfg.chips_per_batch``, staged onto the card, run through
``kernel.detect_packed`` and drained to the store by an async writer, so
the store's egress overlaps the card's compute.  ``cfg.pipeline_depth``
batches are in flight at most: the one computing and ``depth - 1``
draining.

Threads and streams on CUDA.  The prefetch thread copies a batch's integer
wire (int32 days, int16 spectra, uint8 QA) into pinned host buffers and
moves it to the card with ``non_blocking`` copies on a copy stream of its
own, recording an event after them (:func:`stage_batch`).  The main thread
makes the compute stream wait on that event and ``record_stream``-s the
staged tensors onto it before it dispatches (:func:`detect_batch`), so the
caching allocator does not hand their blocks to the copy stream's next
batch early.  The drain thread takes the result on a stream of its own
that waits on an event recorded after the dispatch, packs an f32 result
into int-coded tables on the card (``kernel.pack_egress``), copies them
into pinned host buffers and decodes them (:func:`fetch_results`); an f64
result drains raw.  The capacity probe runs before the bulk fetch, and a
batch whose pixels closed more segments than its buffers hold is
recomputed with the capacity check on (:func:`drain_batch`).

Failure handling is per chip: a chip that exhausts its (jittered,
budgeted) fetch retries is dead-lettered to ``quarantine.json`` and its
chunk completes without it; kernel and store errors fail the chunk as a
backstop and dead-letter its chips too.  Store writes are keyed upserts,
so ``resume=True`` (gated by ``run_manifest.json``, draining the
quarantine first) repairs any gap.

:func:`classification` trains the tile's random forest on the stored
segments and scores them (``rf.pipeline.classify_tile``).

One process per card.  Launched by torchrun (``parallel.dist``), each
process takes its strided share of the tile's chips (:func:`host_shard`)
and runs this pipeline on its own card; the run has one id across the
processes (:func:`fleet_run_id`), each process writes its own report
shard and process 0 merges them (``obs.report.finish_run``).  Nothing
else crosses processes: the keyed store upserts make the union of the
processes' writes a one-process run's.

The ops surface (:func:`start_ops` / :func:`stop_ops`): the run context
of the JSON log lines, the crash flight recorder (FIREBIRD_FLIGHTREC,
armed by default), the device profiler (FIREBIRD_PROFILE,
``POST /profile``), the stall watchdog (FIREBIRD_STALL_SEC) and the ops
endpoint (FIREBIRD_OPS_PORT), and at the run's end the span trace
(FIREBIRD_TRACE) and ``obs_report.json`` (FIREBIRD_OBS_REPORT).  Spans
(``stage``, ``transfer``, ``dispatch``, ``drain``, ``d2h``, ``fetch``,
``pack``) are host time and add no synchronisation with the card; device
time comes from the profiler.

:func:`fetch` (with the source factories, in ``driver/fetch.py``, which
imports no torch) mirrors a tile's chips into a ``FileSource`` archive.

The entry points run on CUDA unless the caller passes ``device="cpu"``;
without a card and without that argument they raise (a multi-process run
takes this process's card, ``parallel.dist.local_device``).  Knobs whose
subsystems are not ported (``config.NOT_PORTED``) make
:func:`changedetection` and :func:`classification` refuse the run.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import dataclasses
import itertools
import os
import sys
import threading
import traceback

import numpy as np
import torch

from firebird_tpu_torch import faults as faultlib
from firebird_tpu_torch import grid
from firebird_tpu_torch import retry as retrylib
from firebird_tpu_torch.ccd import cuda_ops, kernel
from firebird_tpu_torch.ccd import format as ccdformat
from firebird_tpu_torch.config import (NOT_PORTED, NOT_PORTED_BACKENDS,
                                       Config)
from firebird_tpu_torch.driver import quarantine as qlib
from firebird_tpu_torch.driver.fetch import (fetch, make_aux_source,
                                             make_source, with_retries)
from firebird_tpu_torch.ingest import pack
from firebird_tpu_torch.ingest.packer import PackedChips, bucket_capacity
from firebird_tpu_torch.obs import Counters, flightrec, jsonlog, logger
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.obs import profiling as obs_profiling
from firebird_tpu_torch.obs import report as obs_report
from firebird_tpu_torch.obs import server as obs_server
from firebird_tpu_torch.obs import tracing
from firebird_tpu_torch.obs import watchdog as obs_watchdog
from firebird_tpu_torch.parallel import detect_sharded, dist
from firebird_tpu_torch.store import AsyncWriter, open_store
from firebird_tpu_torch.utils import dates as dt
from firebird_tpu_torch.utils.fn import partition_all, take

# The compute dtypes by their Config names (kernel.DTYPES).
_DTYPES = kernel.DTYPES


def refuse_not_ported(cfg: Config) -> None:
    """Raise when ``cfg`` sets a knob whose subsystem this package does not
    port yet (config.NOT_PORTED: a value other than the field's default;
    config.NOT_PORTED_BACKENDS: the store backend)."""
    bad = [f"{name}={getattr(cfg, name)!r} ({what})"
           for name, what in NOT_PORTED.items()
           if getattr(cfg, name) != getattr(Config, name)]
    if cfg.store_backend in NOT_PORTED_BACKENDS:
        bad.append(f"store_backend={cfg.store_backend!r} "
                   f"({NOT_PORTED_BACKENDS[cfg.store_backend]})")
    if bad:
        raise ValueError("not ported to firebird_tpu_torch yet: "
                         + "; ".join(bad))


# ---------------------------------------------------------------------------
# One process per card, and the run's ops surface
# ---------------------------------------------------------------------------

def _process_index() -> int:
    """This process's index in the run (0 single-process)."""
    return dist.process_index()


# Lockstep sequence for run-id broadcast keys: every process of a launch
# runs the same program, so the per-process counters agree.
_run_id_seq = itertools.count()


def fleet_run_id() -> str:
    """One run id for the whole launch.

    Single-process: a fresh id.  Multi-process: process 0 mints it and
    sets it in the bring-up's store (``parallel.dist``); the others wait
    for it (60 s), so every process's JSON log lines, report shard and
    /progress payload carry the same id."""
    rid = jsonlog.new_run_id()
    if dist.process_count() <= 1:
        return rid
    try:
        key = f"fb/run_id/{next(_run_id_seq)}"
        if dist.process_index() == 0:
            dist.kv_set(key, rid)
            return rid
        return dist.kv_get(key, 60_000)
    except Exception:
        return rid           # a broken broadcast degrades to per-process ids


def _mesh_ready() -> bool:
    """The /readyz mesh half: True when no process group is expected (no
    torchrun coordinator in the environment), or when it is up."""
    if int(os.environ.get("WORLD_SIZE") or 1) <= 1:
        return True
    return dist.is_initialized()


def record_topology_metrics(host_only: bool = False) -> None:
    """(Re-)record the topology gauges on the CURRENT registry:
    ``init_distributed`` sets them at bring-up, but the drivers reset the
    registry per run.  ``host_only``: a process that runs on no card (the
    fleet supervisor) records 0 cards without asking CUDA."""
    obs_metrics.gauge(
        "mesh_processes",
        help="torch.distributed process count").set(dist.process_count())
    if host_only:
        cards = 0
    elif dist.process_count() > 1:
        cards = dist.global_device_count()
    else:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    obs_metrics.gauge("mesh_global_devices",
                      help="cards the processes run on").set(cards)


def start_ops(cfg: Config, run_id: str, kind: str, *, chips_total: int,
              counters, run_block: dict, quarantine=None, breaker=None,
              fleet=None, alerts=None, streamops=None,
              host_only: bool = False):
    """Bring up the run's live ops surface (shared by both drivers).

    Registers the run context for JSON logs, clears stale report shards
    from a previous run in a reused artifact directory, arms the flight
    recorder (``cfg.flightrec``) and the device profiler, starts the stall
    watchdog when ``cfg.stall_sec`` asks for one, publishes a
    :class:`~firebird_tpu_torch.obs.server.RunStatus` for the module-level
    progress hooks, and binds the HTTP endpoint ONLY when ``cfg.ops_port``
    is set — the default run binds no port.  Returns (status, server,
    watchdog); tear down with :func:`stop_ops`.  If the port bind fails,
    everything already started is torn down before the error propagates.
    The kernels are built before this (:func:`build_kernels`), so the
    watchdog's clock starts after ``nvcc``.  ``host_only``: a process that
    runs no kernel (the fleet supervisor) asks CUDA nothing, so it never
    holds a card: 0 cards recorded, no device profiler (``POST /profile``
    answers 503).
    """
    jsonlog.set_run_context(run_id=run_id, process_index=_process_index())
    obs_report.clear_stale_artifacts(cfg)
    record_topology_metrics(host_only)
    watchdog = None
    server = None
    try:
        # Crash flight recorder (FIREBIRD_FLIGHTREC ring size; 0 off):
        # armed for the run so an unhandled exception, watchdog stall,
        # or SIGTERM leaves postmortem.json next to the store.
        if cfg.flightrec > 0:
            flightrec.arm(flightrec.postmortem_path(cfg),
                          ring=cfg.flightrec, run_id=run_id,
                          fingerprint=qlib.config_fingerprint(cfg))
        # On-demand device profiler: POST /profile windows land next to
        # the store; FIREBIRD_PROFILE=<seconds> arms an automatic window
        # at the first dispatch.  Memory-backend runs have no artifact
        # dir and get no profiler (the endpoint answers 503).
        profiler = None
        art_dir = qlib._artifact_dir(cfg)
        if art_dir is not None and not host_only:
            profiler = obs_profiling.set_active(obs_profiling.DeviceProfiler(
                os.path.join(art_dir, "device_profile")))
            if cfg.profile > 0:
                profiler.arm_auto(cfg.profile)
        if cfg.stall_sec > 0:
            watchdog = obs_watchdog.Watchdog(cfg.stall_sec).start()
        status = obs_server.set_status(obs_server.RunStatus(
            run_id, kind, chips_total=chips_total, counters=counters,
            watchdog=watchdog, run=run_block, mesh_up=_mesh_ready(),
            pipeline_depth=cfg.pipeline_depth, quarantine=quarantine,
            breaker=breaker, profiler=profiler, slo_spec=cfg.slo,
            fleet=fleet, alerts=alerts, streamops=streamops))
        if cfg.ops_port > 0:
            server = obs_server.start_ops_server(cfg.ops_port, status,
                                                 host=cfg.ops_host)
    except Exception:
        stop_ops(server, watchdog)
        raise
    return status, server, watchdog


def stop_ops(server, watchdog) -> None:
    """Tear down :func:`start_ops` state; never raises — ops teardown
    must not mask a run's real outcome.  Called from the drivers'
    ``finally``: when the run is unwinding on an exception, the flight
    recorder dumps its postmortem BEFORE disarming."""
    if sys.exc_info()[0] is not None:
        flightrec.dump_if_armed("unhandled_exception", sys.exc_info()[1])
    try:
        if server is not None:
            server.close()
        if watchdog is not None:
            watchdog.stop()
        obs_profiling.close_active()
    except Exception as e:
        logger("change-detection").error("ops teardown failed: %s", e)
    finally:
        obs_profiling.set_active(None)
        flightrec.disarm()
        obs_server.clear_status()
        jsonlog.clear_run_context()


def host_shard(cids: list) -> list:
    """This process's share of a chip-id list in a multi-process run: the
    strided slice ``cids[i::n]``.  Each process runs the normal pipeline
    on its share on its own card; the keyed store upserts make the union
    of the processes' writes a one-process run's.  Single-process runs
    return the list unchanged."""
    n = dist.process_count()
    if n <= 1:
        return cids
    i = dist.process_index()
    logger("change-detection").info(
        "multi-host: process %d/%d takes %d of %d chips",
        i, n, len(cids[i::n]), len(cids))
    return cids[i::n]


def run_device(device=None) -> torch.device:
    """The run's device: ``device`` as given, else this process's card in
    a multi-process run (``dist.local_device``), else CUDA; raises without
    a card unless the caller names the CPU."""
    if device is None and dist.process_count() > 1:
        device = dist.local_device()
    return kernel.resolve_device(device)


def build_kernels(dev: torch.device, cfg: Config, log) -> None:
    """Build the CUDA kernels a float32 run on a card launches (nothing for
    the CPU or float64), before the ops surface comes up: a short
    FIREBIRD_STALL_SEC must not be tripped by ``nvcc``.  This is the
    port's warm start (the JAX package's ``warm_compile``): the first
    dispatch then finds every kernel built."""
    if dev.type != "cuda" or cfg.dtype != "float32":
        return
    with tracing.span("warm_compile"), obs_metrics.timer() as tm:
        cuda_ops.build()
    log.info("CUDA kernels built in %.1f s", tm.elapsed)
    obs_metrics.histogram(
        "warm_compile_seconds",
        help="the CUDA kernels' build (nvcc, or the build cache) before "
             "the first dispatch").observe(tm.elapsed)
    obs_metrics.counter("warm_compiles",
                        help="warm-start kernel builds completed").inc()


def robustness_setup(cfg: Config, run_id: str, *, source=None, store=None):
    """The drivers' shared graceful-degradation bring-up (one code path
    for batch, stream and the fleet's detect jobs): the (usually absent)
    fault plan wraps the failure seams, one retry budget and ingest
    circuit breaker are shared by every retry site, the async writer
    retries store writes, and the dead-letter quarantine carries poisoned
    chips across runs.  With FIREBIRD_FAULTS unset the wrap_* calls
    return their argument unchanged — nothing on the hot path.

    Returns (source, store, writer, policy, breaker, quarantine)."""
    plan = faultlib.FaultPlan.from_config(cfg)
    source = faultlib.wrap_source(source or make_source(cfg), plan)
    store = faultlib.wrap_store(
        store or open_store(cfg.store_backend, cfg.store_path,
                            cfg.keyspace()), plan)
    budget = retrylib.RetryBudget(cfg.retry_budget)
    breaker = retrylib.make_breaker(cfg)
    policy = retrylib.RetryPolicy.for_ingest(cfg, budget=budget,
                                             breaker=breaker)
    writer = faultlib.wrap_writer(
        AsyncWriter(store, workers=cfg.writer_threads,
                    retry=retrylib.RetryPolicy.for_store(cfg,
                                                         budget=budget)),
        plan)
    quarantine = qlib.Quarantine.load(qlib.quarantine_path(cfg),
                                      run_id=run_id)
    return source, store, writer, policy, breaker, quarantine


def _pad_target(n_chips: int, use_mesh: bool, n_dev: int) -> int:
    """The batch pad-target rule: the chip count, rounded up to a
    device-count multiple when sharded."""
    return -n_dev * (-n_chips // n_dev) if use_mesh else n_chips


def _pad_batch(packed, target: int):
    """Pad a PackedChips batch to ``target`` chips (repeating the last
    chip); returns (padded, real_count)."""
    C = packed.n_chips
    if C >= target:
        return packed, C
    pad = target - C
    rep = lambda a: np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
    return PackedChips(cids=rep(packed.cids), dates=rep(packed.dates),
                       spectra=rep(packed.spectra), qas=rep(packed.qas),
                       n_obs=rep(packed.n_obs), sensor=packed.sensor), C


def _mesh_devices(sharding: str, device: torch.device) -> list | None:
    """The cards a batch shards over: every visible card when there are
    more than one and ``sharding`` is 'auto' on CUDA, else None.  A
    process of a multi-process run shards over its own card only, so
    never (parallel/mesh.py)."""
    if (sharding == "off" or device.type != "cuda"
            or torch.cuda.device_count() < 2 or dist.process_count() > 1):
        return None
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def estimate_obs(acquired: str, cfg: Config) -> int:
    """Conservative observation-count estimate for an acquired range:
    two-satellite 8-day effective cadence over the span, bucketed and
    capped by the packer's own capacity rule (max_obs=0 is uncapped)."""
    lo, hi = dt.acquired_range(acquired)
    t = (max(hi - lo, 0) // 8) + 8
    return bucket_capacity(t, max(cfg.obs_bucket, 1), cfg.max_obs)


def auto_chips_per_batch(cfg: Config, acquired: str, device=None) -> int:
    """Size the batch from the card's free memory: 60% of
    ``torch.cuda.mem_get_info``'s free bytes against
    ``kernel.working_set_bytes`` per chip, plus the result buffers that
    each further in-flight batch (``pipeline_depth - 1``) pins until its
    drain.  A device that reports no memory (the CPU) takes the static
    default, as in the JAX package."""
    dev = kernel.resolve_device(device)
    fallback = Config.chips_per_batch
    if dev.type != "cuda":
        return fallback
    free, _total = torch.cuda.mem_get_info(dev)
    t_est = estimate_obs(acquired, cfg)
    dtype_bytes = 4 if cfg.dtype == "float32" else 8
    per = kernel.working_set_bytes(t_est, dtype_bytes=dtype_bytes)
    per += (max(cfg.pipeline_depth, 1) - 1) * kernel.result_bytes(
        t_est, dtype_bytes=dtype_bytes)
    n = max(int(free * 0.6 / per), 1)
    logger("change-detection").info(
        "auto chips_per_batch: T~%d, %.2f GB/chip (incl. depth-%d "
        "in-flight results) against %.1f GB free -> %d chips/batch",
        t_est, per / 1e9, cfg.pipeline_depth, free / 1e9, n)
    return n


def resolve_batching(cfg: Config, acquired: str, device=None) -> Config:
    """``cfg`` with chips_per_batch resolved (<= 0 means auto-size)."""
    if cfg.chips_per_batch > 0:
        return cfg
    return dataclasses.replace(
        cfg, chips_per_batch=auto_chips_per_batch(cfg, acquired, device))


# ---------------------------------------------------------------------------
# Stage, dispatch, drain
# ---------------------------------------------------------------------------

_COPY_STREAMS: dict = {}
_COPY_LOCK = threading.Lock()


def _side_stream(device: torch.device, role: str) -> torch.cuda.Stream:
    """One side stream per (device, role, thread): the prefetch thread's
    copy stream, the drain thread's stream."""
    key = (device, role, threading.get_ident())
    with _COPY_LOCK:
        s = _COPY_STREAMS.get(key)
        if s is None:
            s = _COPY_STREAMS[key] = torch.cuda.Stream(device)
        return s


@dataclasses.dataclass
class StagedBatch:
    """A staged input batch (the prefetch thread's product): the wire
    tuple on the card (``args``; None when sharded: the sharded dispatch
    stages each shard itself), the padded host PackedChips the recompute
    path still needs, the real chip count, the shards' devices
    (``devices``; None unsharded), and on CUDA the copy's event
    (``ready``) and the pinned host buffers the copies read (``pinned``,
    kept alive until the event completes)."""

    packed: object
    args: tuple | None
    n_real: int
    device: torch.device
    devices: list | None = None
    ready: object = None
    pinned: tuple = ()


def stage_batch(packed, dtype, sharding: str = "auto",
                device=None) -> StagedBatch:
    """Pad one batch to a card-count multiple when sharded (repeating its
    last chip) and move its integer wire to the card — the H2D half
    of :func:`detect_batch`, run on the prefetch thread so that batch
    i+1's copy overlaps batch i's compute.  On CUDA the wire goes through
    pinned host buffers and ``non_blocking`` copies on this thread's copy
    stream, and the returned batch carries the event recorded after them;
    the call does not wait for the copies.  Records
    ``pipeline_stage_seconds``, ``wire_h2d_bytes`` and the ``stage`` span
    with the h2d ``transfer`` leg."""
    dev = kernel.resolve_device(device)
    kernel.float_dtype(dtype)
    devices = _mesh_devices(sharding, dev)
    n_dev = len(devices) if devices else 1
    padded, real = _pad_batch(
        packed, _pad_target(packed.n_chips, devices is not None, n_dev))
    wire = kernel.wire_args(padded)
    # The `transfer` span's h2d leg (its d2h twin wraps the drain's bulk
    # fetch): on CUDA it times the enqueue of the copies, not the copies.
    with tracing.span("stage", chips=real), obs_metrics.timer() as tm, \
            tracing.span("transfer", leg="h2d", chips=real):
        if devices is not None:
            staged = StagedBatch(padded, None, real, dev, devices)
        elif dev.type == "cuda":
            pinned = tuple(torch.from_numpy(np.ascontiguousarray(a))
                           .pin_memory() for a in wire)
            stream = _side_stream(dev, "copy")
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                args = tuple(h.to(dev, non_blocking=True) for h in pinned)
                ready = torch.cuda.Event()
                ready.record(stream)
            staged = StagedBatch(padded, args, real, dev, None, ready,
                                 pinned)
        else:
            staged = StagedBatch(padded, kernel.stage_packed(padded, dev),
                                 real, dev)
    obs_metrics.histogram("pipeline_stage_seconds").observe(tm.elapsed)
    obs_metrics.counter(
        "wire_h2d_bytes",
        help="bytes staged host->device (all-integer packed inputs)").inc(
        int(sum(a.nbytes for a in wire)))
    return staged


def detect_batch(packed, dtype, sharding: str = "auto",
                 check_capacity: bool = False,
                 max_segments: int | None = None,
                 staged: StagedBatch | None = None,
                 compact: bool | None = None, device=None):
    """Run the detector over a packed batch on the card (``device``,
    default CUDA) -> (ChipSegments, real chip count).

    With more than one visible card and ``sharding`` 'auto', the chip
    axis is sharded over them (``parallel.detect_sharded``); otherwise one
    ``kernel.detect_packed`` dispatch.  A sharded batch is padded to a
    card-count multiple (:func:`stage_batch`); the caller drops the
    padded results by the real count.  The kernels compile nothing per
    shape, so no batch is padded for a shape's sake.

    With ``staged`` (:func:`stage_batch`) the wire is already on the card:
    the compute stream waits on the copy's event and the staged tensors
    are recorded onto it before the dispatch.  ``check_capacity=False``
    (the driver's default) runs the batch once at ``max_segments``; the
    drain thread checks the capacity (:func:`drain_batch`)."""
    kw = dict(check_capacity=check_capacity, compact=compact, dtype=dtype)
    if max_segments is not None:
        kw["max_segments"] = max_segments
    if staged is None:
        staged = stage_batch(packed, dtype, sharding, device)
    if staged.devices is not None:
        return (detect_sharded(staged.packed, staged.devices, **kw),
                staged.n_real)
    if staged.ready is not None:
        compute = torch.cuda.current_stream(staged.device)
        compute.wait_event(staged.ready)
        for t in staged.args:
            t.record_stream(compute)
    return (kernel.detect_packed(staged.packed, device=staged.device,
                                 staged=staged.args, **kw), staged.n_real)


def _to_host(payload: dict, stream) -> dict:
    """One D2H sweep of a dict of tensors into pinned buffers on
    ``stream`` (None: the CPU), then the buffers as numpy arrays."""
    if stream is None:
        return {k: (v.numpy() if torch.is_tensor(v) else v)
                for k, v in payload.items()}
    out = {}
    with torch.cuda.stream(stream):
        for k, v in payload.items():
            if v is None:
                out[k] = None
                continue
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host.copy_(v, non_blocking=True)
            out[k] = host
    stream.synchronize()
    return {k: (None if v is None else v.numpy()) for k, v in out.items()}


def fetch_results(seg, worst: int | None = None, stream=None):
    """The one bulk device -> host fetch of a batch's result, on
    ``stream`` (the drain thread's; None on the CPU).  A float32 result is
    packed on the card into int-coded tables cut to the batch's deepest
    segment count (``kernel.pack_egress``), copied, and decoded on the
    host (``format.decode_egress``): the host arrays the raw drain would
    give, in fewer bytes.  A float64 result has no int coding and drains
    raw.  ``worst`` is the caller's capacity probe (the most segments a
    pixel closed) where it already paid that sync.  Records
    ``pipeline_d2h_seconds``, ``wire_d2h_bytes`` and the ``d2h`` span
    with the d2h ``transfer`` leg; returns a host ChipSegments."""
    with obs_metrics.timer() as tm:
        if seg.seg_meta.dtype == torch.float32:
            if worst is None:
                worst = int(seg.n_segments.max())
            s_eff = kernel.egress_bucket(worst, seg.seg_meta.shape[-2])
            if stream is not None:
                with torch.cuda.stream(stream):
                    payload = kernel.pack_egress(seg, s_eff)
            else:
                payload = kernel.pack_egress(seg, s_eff)
            nbytes = sum(v.nbytes for v in payload.values())
            with tracing.span("d2h", bytes=nbytes), \
                    tracing.span("transfer", leg="d2h", bytes=nbytes):
                got = _to_host(payload, stream)
            host = ccdformat.decode_egress(got, seg.mask.shape[-1])
        else:
            fields = {f.name: getattr(seg, f.name)
                      for f in dataclasses.fields(seg)}
            nbytes = sum(v.nbytes for v in fields.values() if v is not None)
            with tracing.span("d2h", bytes=nbytes), \
                    tracing.span("transfer", leg="d2h", bytes=nbytes):
                host = kernel.ChipSegments(**_to_host(fields, stream))
    obs_metrics.histogram("pipeline_d2h_seconds").observe(tm.elapsed)
    obs_metrics.counter(
        "wire_d2h_bytes",
        help="bytes fetched device->host (batch results, int-coded and "
             "depth-sliced for float32)").inc(int(nbytes))
    return host


def write_batch_frames(packed, host_seg, n_real, *, writer, counters=None):
    """Format + queue one drained batch's frames: ``format.batch_frames``
    builds the three tables across the chip axis in one numpy pass, split
    back into keyed per-chip writes, so a chip's segment frame lands last
    (the resume invariant)."""
    P = host_seg.n_segments.shape[1]
    for c, (cid, frames) in enumerate(
            ccdformat.batch_frames(packed, host_seg, n_real)):
        for table in ("chip", "pixel", "segment"):
            writer.write(table, frames[table], key=cid)
        if counters is not None:
            counters.add("chips")
            counters.add("pixels", P)
            counters.add("segments", int(host_seg.n_segments[c].sum()))


def drain_batch(seg, packed, n_real, *, writer, counters, dtype=None,
                sharding: str = "auto", compact: bool | None = None,
                done=None, ctx=None):
    """Fetch one batch's result to the host, format it and queue its
    writes (:func:`fetch_results`, :func:`write_batch_frames`), on the
    drain thread.  ``done`` is the event recorded on the compute stream
    after the batch's dispatch: on CUDA the drain runs on a stream of its
    own that waits on it.  ``ctx`` is the batch's TraceContext: this runs
    on the drain executor, so the context crosses the thread hop
    explicitly, and the drain's spans, queued writes and log lines parent
    to it.  A drained batch beats the watchdog (``batch_done``).

    Also the capacity backstop of the driver's one-shot dispatch: the
    capacity probe (``n_segments`` alone) runs before the bulk fetch, and
    where a pixel closed more segments than the buffers hold, the batch is
    recomputed through :func:`detect_batch` with the capacity check on,
    starting at twice the capacity."""
    with tracing.activate(ctx):
        _drain(seg, packed, n_real, writer=writer, counters=counters,
               dtype=dtype, sharding=sharding, compact=compact, done=done)
    obs_server.batch_done(n_real)


def _drain(seg, packed, n_real, *, writer, counters, dtype, sharding,
           compact, done):
    cap = seg.seg_meta.shape[-2]
    dev = seg.n_segments.device
    stream = None
    if dev.type == "cuda":
        stream = _side_stream(dev, "drain")
        if done is not None:
            stream.wait_event(done)
        else:
            stream.wait_stream(torch.cuda.current_stream(dev))
    with tracing.span("drain", chips=n_real), obs_metrics.timer() as tm:
        if stream is not None:
            with torch.cuda.stream(stream):
                worst = int(seg.n_segments.max())
        else:
            worst = int(seg.n_segments.max())
        if worst > cap:
            logger("pyccd").info(
                "segment capacity %d overflowed on drain (deepest pixel "
                "closed %d); recomputing the batch", cap, worst)
            obs_metrics.counter("capacity_redispatches").inc()
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                seg, _ = detect_batch(
                    packed, dtype or seg.seg_meta.dtype, sharding,
                    check_capacity=True, compact=compact,
                    max_segments=min(2 * cap, kernel.capacity_bound(packed)),
                    device=dev)
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))
            worst = None
        host = fetch_results(seg, worst=worst, stream=stream)
        # Occupancy telemetry: the event loop's per-round lane capture
        # feeds kernel_round_active_fraction and the compaction counters.
        kernel.record_occupancy(host)
        write_batch_frames(packed, host, n_real, writer=writer,
                           counters=counters)
    obs_metrics.histogram("pipeline_drain_seconds").observe(tm.elapsed)
    logger("change-detection").debug("batch drained: %d chips in %.3fs",
                                     n_real, tm.elapsed)


def detect_chunk(cids, *, source, writer, acquired, cfg, counters, log,
                 policy=None, quarantine=None, device=None):
    """Change detection for one chunk of chip ids: ingest -> pack -> stage
    -> detect -> chip / pixel / segment writes.

    The prefetch thread fetches (over the ``cfg.input_parallelism`` chip
    pool), packs and stages batch i+1 while batch i computes; the main
    thread only dispatches; the drain thread fetches, formats and queues
    batch i-1's results.  At most ``cfg.pipeline_depth`` batches are in
    flight.  A chip that exhausts its fetch retries is dead-lettered to
    ``quarantine`` and dropped from its batch; the others go on.  A
    ragged last batch runs at its own size.  One TraceContext a batch,
    carried explicitly across the thread hops (prefetch, dispatch, drain,
    writer), parents the batch's spans, log lines and exemplars.  Returns
    the chip ids processed."""
    log.info("finding ccd segments for %d chips", len(cids))
    dev = kernel.resolve_device(device)
    dtype = _DTYPES[cfg.dtype]
    batches = list(partition_all(cfg.chips_per_batch, cids))
    depth = max(cfg.pipeline_depth, 1)
    run_id = jsonlog.get_run_context().get("run_id")
    ctxs = [tracing.TraceContext(tracing.new_batch_id(run_id),
                                 run_id=run_id) for _ in batches]

    with cf.ThreadPoolExecutor(
            max_workers=max(cfg.input_parallelism, 1)) as chips_ex, \
            cf.ThreadPoolExecutor(max_workers=1) as prefetch_ex, \
            cf.ThreadPoolExecutor(max_workers=1) as drain_ex:

        def fetch_one(xy, ctx):
            with tracing.activate(ctx):
                try:
                    with obs_metrics.timer() as tm:
                        chip = with_retries(
                            cfg, log, f"chip ({xy[0]},{xy[1]}) fetch",
                            lambda: source.chip(xy[0], xy[1], acquired),
                            policy=policy)
                except Exception as e:
                    log.error(
                        "chip (%s,%s) failed after retries (%s: %s); "
                        "quarantined — its chunk continues without it",
                        xy[0], xy[1], type(e).__name__, e)
                    if quarantine is not None:
                        quarantine.record(xy, e,
                                          attempts=cfg.fetch_retries + 1)
                    return None
                obs_metrics.histogram("ingest_chip_seconds").observe(
                    tm.elapsed)
                return chip

        def prepare_batch(bids, ctx):
            """fetch -> pack -> stage on the prefetch thread.  Returns
            (surviving chip ids, StagedBatch), or None when every chip of
            the batch was quarantined."""
            with tracing.activate(ctx):
                with tracing.span("fetch", chips=len(bids)), \
                        obs_metrics.timer() as tm:
                    chips = list(chips_ex.map(
                        lambda xy: fetch_one(xy, ctx), bids))
                obs_metrics.histogram("pipeline_fetch_seconds").observe(
                    tm.elapsed)
                keep = [(cid, ch) for cid, ch in zip(bids, chips)
                        if ch is not None]
                if not keep:
                    return None
                with tracing.span("pack", chips=len(keep)), \
                        obs_metrics.timer() as tm:
                    packed = pack([ch for _, ch in keep],
                                  bucket=cfg.obs_bucket, max_obs=cfg.max_obs)
                obs_metrics.histogram("pipeline_pack_seconds").observe(
                    tm.elapsed)
                return [cid for cid, _ in keep], stage_batch(
                    packed, dtype, cfg.device_sharding, device=dev)

        nxt = prefetch_ex.submit(prepare_batch, batches[0], ctxs[0]) \
            if batches else None
        drains: list[cf.Future] = []
        processed: list = []
        for i in range(len(batches)):
            # A NonRetryable error pending in the writer means every
            # further write will reject: stop paying for batches whose
            # output cannot land.
            err = getattr(writer, "peek_error", lambda: None)()
            if isinstance(err, retrylib.NonRetryable):
                raise err
            obs_server.set_stage("fetch")
            prep = nxt.result()
            nxt = (prefetch_ex.submit(prepare_batch, batches[i + 1],
                                      ctxs[i + 1])
                   if i + 1 < len(batches) else None)
            if prep is None:
                continue                 # whole batch quarantined
            kept, staged = prep
            obs_server.set_stage("dispatch")
            obs_server.dispatch_starting()
            with tracing.activate(ctxs[i]):
                with tracing.span("dispatch", chips=staged.n_real), \
                        obs_metrics.timer() as tm:
                    seg, n_real = detect_batch(staged.packed, dtype,
                                               cfg.device_sharding,
                                               staged=staged,
                                               compact=cfg.compact,
                                               device=dev)
                    done = None
                    if seg.n_segments.device.type == "cuda":
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(
                            seg.n_segments.device))
                obs_metrics.histogram("pipeline_dispatch_seconds").observe(
                    tm.elapsed)
            # /readyz flips here: the first batch is dispatched.
            obs_server.batch_dispatched()
            drains.append(drain_ex.submit(
                drain_batch, seg, staged.packed, n_real, writer=writer,
                counters=counters, dtype=dtype,
                sharding=cfg.device_sharding, compact=cfg.compact,
                done=done, ctx=ctxs[i]))
            del seg, staged
            processed.extend(kept)
            while len(drains) > depth - 1:
                drains.pop(0).result()
        for f in drains:
            f.result()
    return processed


def run_chunk(chunk, *, source, writer, acquired, cfg, counters, log,
              policy=None, quarantine=None, reraise=False, device=None):
    """One chunk end to end — detect, flush, redeem dead letters — with the
    chunk-level failure backstop.  ``reraise=False`` swallows the chunk's
    failure after dead-lettering its chips (later chunks continue);
    ``reraise=True`` re-raises it.  A ``NonRetryable`` error always
    propagates without dead-lettering.  Returns the chip ids processed
    ([] on a swallowed failure)."""
    try:
        processed = detect_chunk(
            chunk, source=source, writer=writer, acquired=acquired,
            cfg=cfg, counters=counters, log=log, policy=policy,
            quarantine=quarantine, device=device)
        obs_server.set_stage("flush")
        writer.flush()  # a chunk counts once its rows landed
        if quarantine is not None:
            quarantine.discard_many(processed)  # redeemed letters
        return processed
    except retrylib.NonRetryable:
        raise
    except Exception as e:
        obs_metrics.counter("chunk_failures").inc()
        log.error("chunk failed (%d chips): %s", len(chunk), e)
        if quarantine is not None:
            held = quarantine.chip_ids()
            quarantine.record_many(
                [c for c in chunk
                 if tuple(int(v) for v in c) not in held],
                e, attempts=1, stage="chunk")
        if reraise:
            raise
        traceback.print_exc()
        return []


# The last run's artifact paths in this process ({"trace", "report",
# "report_shard", "run_id"}: what finish_run wrote), for the command line's
# summary line.
last_run_artifacts: dict = {}


def changedetection(x, y, acquired: str | None = None, number: int = 2500,
                    chunk_size: int = 2500, cfg: Config | None = None,
                    source=None, store=None, resume: bool = False,
                    device=None, counters: Counters | None = None):
    """Run change detection for a tile and save the results.

    The arguments follow the JAX package's ``changedetection``: the tile
    point (x, y), the ISO8601 acquired range, the number of chips and the
    chunk size (the failure-isolation unit).  ``resume=True`` skips chips
    whose segments are already stored (the segment table is written last
    per chip) and drains the quarantine first; ``run_manifest.json``
    makes it refuse a different acquired range and warn on a changed
    config fingerprint.  ``device`` is the card (default CUDA, or this
    process's card in a multi-process run; "cpu" runs the plain versions
    on the CPU).  The kernels are built before the first batch and before
    the ops surface comes up, and their build seconds logged.
    ``counters`` (a fresh one unless given) counts the run's chips, pixels
    and segments.  In a multi-process run (``parallel.dist``) this
    process takes its share of the chips (:func:`host_shard`).

    Returns the tuple of chip ids processed successfully (the skipped ones
    first)."""
    cfg = cfg or Config.from_env()
    refuse_not_ported(cfg)
    dev = run_device(device)
    acquired = acquired or dt.default_acquired()
    cfg = resolve_batching(cfg, acquired, dev)
    log = logger("change-detection")
    counters = Counters() if counters is None else counters
    # One id for the whole launch, in the log lines from here on.
    run_id = fleet_run_id()
    jsonlog.set_run_context(run_id=run_id)
    obs_metrics.reset_registry()
    build_kernels(dev, cfg, log)

    if resume:
        qlib.check_resume(cfg, acquired=acquired, log=log)

    source, store, writer, policy, breaker, quarantine = robustness_setup(
        cfg, run_id, source=source, store=store)

    tile = grid.tile(x=x, y=y)
    cids = host_shard(list(take(number, grid.chips(tile))))
    skipped: tuple = ()
    if resume:
        have = store.chip_ids("segment")
        quarantine.discard_many(have)
        todo = [c for c in cids if c not in have]
        skipped = tuple(c for c in cids if c in have)
        qids = quarantine.chip_ids()
        todo.sort(key=lambda c: tuple(int(v) for v in c) not in qids)
        cids = todo
        log.info("resume: %d chips already stored, %d to do (%d draining "
                 "from quarantine first)", len(skipped), len(cids),
                 len(qids))
    else:
        qlib.write_manifest(cfg, acquired=acquired, run_id=run_id,
                            tile=tile)
    chunks = list(partition_all(chunk_size, cids))
    log.info("tile h=%s v=%s: %d chips in %d chunks (acquired %s) on %s",
             tile["h"], tile["v"], len(cids), len(chunks), acquired, dev)

    run_block = dict(kind="changedetection", run_id=run_id,
                     host=jsonlog.HOST, process_id=_process_index(),
                     tile_h=tile["h"], tile_v=tile["v"], acquired=acquired,
                     chips=len(cids), chunks=len(chunks),
                     resumed=len(skipped), device=str(dev))
    _, ops_srv, watchdog = start_ops(
        cfg, run_id, "changedetection", chips_total=len(cids),
        counters=counters, run_block=run_block, quarantine=quarantine,
        breaker=breaker)
    tracer = tracing.start(run_id=run_id) \
        if tracing.wants_trace(cfg.trace) else None
    # The whole-run device capture (FIREBIRD_PROFILE_DIR).
    capture = obs_profiling.RunCapture(cfg.profile_dir).start()
    done: list = []
    counters.start()
    try:
        for chunk in chunks:
            done.extend(run_chunk(
                chunk, source=source, writer=writer, acquired=acquired,
                cfg=cfg, counters=counters, log=log, policy=policy,
                quarantine=quarantine, device=dev))
    finally:
        capture.stop()
        obs_server.set_stage("finalize")
        writer.close()
        snap = counters.snapshot()
        log.info("change-detection complete: %s", snap)
        if len(quarantine):
            run_block["chips_quarantined"] = len(quarantine)
            log.warning(
                "%d chips in quarantine (%s) — rerun with resume to drain "
                "them once the cause clears", len(quarantine),
                quarantine.path or "in-memory: memory store backend")
        if tracer is not None:
            tracing.stop()
        paths = obs_report.finish_run(
            cfg, tracer=tracer, run_counters=snap, run=run_block)
        if paths:
            log.info("observability artifacts: %s", paths)
        last_run_artifacts.clear()
        last_run_artifacts.update(paths, run_id=run_id)
        # The server goes down last, so /progress and /report serve the
        # final state for as long as the process allows.
        obs_server.set_stage("done")
        stop_ops(ops_srv, watchdog)
    return tuple(skipped) + tuple(done)


def classification(x, y, msday: int, meday: int, acquired: str | None = None,
                   cfg: Config | None = None, aux_source=None, store=None,
                   device=None, counters: Counters | None = None):
    """Train on the 3x3 tile neighborhood, classify the tile, persist
    predictions + the trained model (ref core.classification,
    core.py:156-251, including the predict/save path the reference left
    commented out), with the forest on ``device`` (default CUDA; "cpu"
    runs it on the CPU).  The metrics registry starts afresh, so
    ``rf.pipeline.classification_stage_seconds`` reads this run's stages.
    Returns the trained model, or None when no training features exist."""
    from firebird_tpu_torch.rf import pipeline as rf_pipeline

    cfg = cfg or Config.from_env()
    refuse_not_ported(cfg)
    dev = kernel.resolve_device(device)
    obs_metrics.reset_registry()
    acquired = acquired or dt.default_acquired()
    store = store or open_store(cfg.store_backend, cfg.store_path,
                                cfg.keyspace())
    # The fault plan's ingest/aux scopes reach the AUX fetches (the
    # stage's only source reads).
    aux_source = faultlib.wrap_source(aux_source or make_aux_source(cfg),
                                      faultlib.FaultPlan.from_config(cfg))
    return rf_pipeline.classify_tile(
        x=x, y=y, msday=msday, meday=meday, acquired=acquired,
        aux_source=aux_source, store=store, device=dev, counters=counters)


def stage_seconds() -> dict:
    """The current run's per-stage seconds from the metrics registry:
    fetch, pack, stage, dispatch, drain (each the sum over its batches),
    d2h (inside drain) and the writer's store writes."""
    snap = obs_metrics.get_registry().snapshot()["histograms"]
    names = dict(fetch="pipeline_fetch_seconds", pack="pipeline_pack_seconds",
                 stage="pipeline_stage_seconds",
                 dispatch="pipeline_dispatch_seconds",
                 drain="pipeline_drain_seconds", d2h="pipeline_d2h_seconds",
                 write="store_write_seconds")
    return {k: snap.get(v, {}).get("sum", 0.0) for k, v in names.items()}


__all__ = ["fetch", "make_source", "make_aux_source", "robustness_setup", "estimate_obs",
           "auto_chips_per_batch", "resolve_batching", "StagedBatch",
           "stage_batch", "detect_batch", "fetch_results",
           "write_batch_frames", "drain_batch", "detect_chunk", "run_chunk",
           "changedetection", "classification", "refuse_not_ported",
           "stage_seconds", "fleet_run_id", "host_shard", "start_ops",
           "stop_ops", "record_topology_metrics", "run_device",
           "build_kernels", "last_run_artifacts"]

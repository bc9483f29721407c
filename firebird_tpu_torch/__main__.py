"""Command line of the PyTorch port.

    python -m firebird_tpu_torch changedetection -x X -y Y [-a ACQUIRED] \\
        [-n NUMBER] [-c CHUNK_SIZE] [--resume] [--device cuda] \\
        [--trace T] [--ops-port P] [--profile S] [--slo SPEC]
    python -m firebird_tpu_torch stream -x X -y Y [-a ACQUIRED] [-n NUMBER] \\
        [--device cuda] [--trace T] [--ops-port P] [--profile S] [--slo SPEC]
    torchrun --nproc-per-node N -m firebird_tpu_torch changedetection ...
    python -m firebird_tpu_torch classification -x X -y Y -s MSDAY -e MEDAY \\
        [-a ACQUIRED] [--device cuda]
    python -m firebird_tpu_torch save -b X,Y [-b X,Y ...] -p NAME [-p ...] \\
        -d DATE [-d ...] [-a ACQUIRED] [--clip] [--device cuda]
    python -m firebird_tpu_torch detect --chips N --start 1985-01-01 \\
        --end 2017-12-31 [--seed S] [--sensor landsat-ard] [--device cuda] \\
        [--fused {0,1,mon}] [--pallas ROUTE] [--compact {0,1}] [--mixed {0,1}] \\
        [--shards N]
    python -m firebird_tpu_torch fleet enqueue -t X,Y [-t X,Y ...] \
        [-a ACQUIRED] [-n NUMBER] [-c CHUNK_SIZE] [-s MSDAY -e MEDAY] \
        [-p NAME ... -d DATE ...] [--max-attempts N]
    python -m firebird_tpu_torch fleet work [--until-drained | --forever | \
        --hold-idle] [--drain-on-term] [--max-jobs N] [--poll S] [--ops-port P]
    python -m firebird_tpu_torch fleet supervise [--min N] [--max N] \
        [--until-drained] [--tick S] [--grace S] [--log-dir D] [--ops-port P]
    python -m firebird_tpu_torch fleet status
    python -m firebird_tpu_torch fleet requeue [JOB_ID | --dead]
    python -m firebird_tpu_torch trace collect [-d DIR] [-o OUT]
    python -m firebird_tpu_torch products
    python -m firebird_tpu_torch tiles -b X,Y [-b X,Y ...] [-s I/N]
    python -m firebird_tpu_torch validate [-x X -y Y] [-a ACQUIRED] \
        [-n N_PIXELS] [--dtype {float32,float64}] [--seed S] [--device cuda]
    python -m firebird_tpu_torch status [-x X -y Y]
    python -m firebird_tpu_torch top [-i INTERVAL] [-n ITERATIONS]
    python -m firebird_tpu_torch slo [-b SPEC] [--fast S] [--slow S] \
        [--burn R] [--record | --no-record]
    python -m firebird_tpu_torch fetch -x X -y Y -o OUTDIR [-a ACQUIRED] \
        [-n NUMBER] [--aux]
    python -m firebird_tpu_torch watch -x X -y Y [-n NUMBER] \
        [--acquired-start DATE] [-i INTERVAL] [--once] [--ops-port P]
    python -m firebird_tpu_torch objectstore scrub [--grace S] [--dry-run]
    python -m firebird_tpu_torch objectstore census
    python -m firebird_tpu_torch export -b X,Y [-b X,Y ...] -p NAME [-p ...] \
        -d DATE [-d ...] -o OUTDIR [-f {envi,npy}] [-s SENSOR]
    python -m firebird_tpu_torch serve [--port P] [--host H] \
        [--cache-entries N] [--cache-dir D] [--no-compute] [--read-only] \
        [--replica-id ID] [--pyramid-dir D]
    python -m firebird_tpu_torch pyramid build -b X,Y [-b X,Y ...] \
        -p NAME [-p ...] -d DATE [-d ...] [-l LEVELS] [--refresh] \
        [--no-compute] [--enqueue]
    python -m firebird_tpu_torch probe [--serve-url URL] [--landing DIR \
        -x X -y Y] [--chip-offset N] [--chips N] [-i INTERVAL] \
        [--timeout S] [-n CYCLES] [--pyramid-product NAME]
    python -m firebird_tpu_torch schema [-k KEYSPACE] [-r REPLICATION]
    python -m firebird_tpu_torch lint [--json PATH] [--rules R] \
        [--update-baseline] [--no-baseline] [--list-rules] [-q]

``changedetection`` is the JAX package's command of that name: the tile
at the point (x, y), its first ``NUMBER`` chips in chunks of
``CHUNK_SIZE``, through driver.core.changedetection into the store that
FIREBIRD_STORE_BACKEND / FIREBIRD_STORE_PATH name (sqlite rows land in
``<dir of the path>/<stem>.<keyspace>.db``), with the config of
``Config.from_env``.  It prints one JSON summary: chips done, pixels,
segments, pixels a second, the stage seconds, the run id, this process's
index and the process count, and the artifacts the run wrote (``trace``,
``report`` or ``report_shard``).

``--trace``, ``--ops-port``, ``--profile``, ``--slo`` and ``--faults``
override FIREBIRD_TRACE, FIREBIRD_OPS_PORT, FIREBIRD_PROFILE, FIREBIRD_SLO
and FIREBIRD_FAULTS for ``changedetection`` and ``stream``, with the JAX
command line's meaning.
Both commands bring up one process per card first
(``parallel.init_distributed``): launched by torchrun, each process takes
its strided share of the tile's chips on its own card
(``cuda:{LOCAL_RANK % device_count}``), writes its report shard
(``obs_report.host<i>.json``) and trace (``trace.host<i>.json``), and
process 0 merges the shards into ``obs_report.json``.

``stream`` is the JAX package's command of that name: the tile's first
``NUMBER`` chips through driver.stream.stream (a chip without a checkpoint
bootstraps, one with a checkpoint applies the acquisitions past its
horizon, publishes its tail rows, appends its confirmed breaks to the
alert log and schedules repair jobs), with the config of
``Config.from_env``.  It prints one JSON line: the stream summary and the
stage seconds.

``classification`` is the JAX package's command of that name: a random
forest trained on the stored segments of the 3x3 tile neighbourhood of
(x, y) whose segments lie inside [MSDAY, MEDAY] (proleptic ordinals), the
model stored in the tile table, and every real segment of the tile scored
into its ``rfrawp``, through driver.core.classification with the config
of ``Config.from_env``.  The forest is the JAX package's (500 trees, depth
8, 64 bins, seed 0).  It prints one JSON summary: the training
rows, the classes, the chips classified, the segment rows written and
the real ones scored, and the stage seconds
(rf.pipeline.classification_stage_seconds).

``save`` is the JAX package's command of that name: product rasters
(products.available(): seglength, ccd, curveqa, cover) at each DATE for
every chip the bounds points cover, into the store's product table
(``--clip`` masks pixels outside the points' polygon).  With ``-a``,
chips with no stored segments are detected over ACQUIRED first.  It
prints one JSON summary: the rasters written, as [name, date, cx, cy].

``detect`` runs SyntheticSource -> pack -> detect_packed -> batch_frames
on the device (CUDA unless ``--device cpu``) and prints one JSON summary:
chips, pixels, segments, rounds (the most any chip ran) and seconds.
``--sensor sentinel2`` runs the 12-band layout (300 x 300-pixel chips);
its results have no table frames (the store's schema is Landsat's).
``--pallas`` picks the kernels (kernel.pallas_components: "1", a component
list such as ``lasso,monitor,tmask``, or ``mega``); without it
FIREBIRD_PALLAS decides.  ``--fused`` picks the round route
(kernel.fused_mode); without it FIREBIRD_FUSED_FIT decides.  ``--compact``
turns active-lane compaction on or off (kernel.compact_mode); without it
FIREBIRD_COMPACT decides (unset: on).  ``--mixed 1`` runs the fitting
kernels' mixed-precision Gram (kernel.pallas_components); without it
FIREBIRD_MIXED_PRECISION decides (unset: off).  ``--shards N`` runs
parallel.detect_sharded over N shards laid round-robin over the visible
cards (N shards on the CPU with ``--device cpu``); FIREBIRD_REBALANCE
turns its rebalancing ring on.

``fleet`` is the JAX package's command group of that name, on the JAX
package's queue schema (``fleet.db`` next to the store, or
FIREBIRD_FLEET_DB): ``enqueue`` writes a dependency-ordered plan (detect
chunk jobs, then a classify job and product jobs per tile) and prints
the job ids; ``work`` drains the queue on this process's card (CUDA: a
worker has no CPU mode on the command line; the tests run
``fleet.FleetWorker(..., device="cpu")`` in-process) and prints its
summary, exiting 4 when the queue is wedged behind dead jobs;
``supervise`` spawns and retires ``fleet work`` children from the
queue's pressure (FIREBIRD_FLEET_MIN_WORKERS / _MAX_WORKERS), runs on the
host only and never initialises CUDA, exits 4 on a wedged queue and 3
when another supervisor is live; ``status`` prints the queue's state
(exit 3 on an unreadable queue) and ``requeue`` revives dead jobs.
``fleet work`` and ``fleet supervise`` spool their spans, marks and
metric snapshots to ``telemetry/`` next to the store
(FIREBIRD_TELEMETRY*, obs/spool.py); ``trace collect`` merges a spool
directory into one Chrome trace with critical paths and merged metrics
(obs/collect.py), written to ``telemetry_collect.json`` there unless
``-o`` names a path.

The read-side commands answer as the JAX package's commands of their
names do (same output, same JSON keys, same exit codes), on the host only:
none initialises CUDA.  ``products`` lists the product names; ``tiles``
prints the tiles covering the bounds points as CSV (``-s i/n`` a strided
shard; a bad shard exits 2); ``status`` prints the store's tables and
chips, quarantine, the fleet queue, the alert log, the stream checkpoint
store and the acquisition watcher's cursor, the serving view (the
changefeed's replicas with their cursor lag, the pyramid's tile census),
the object tier's census (with FIREBIRD_OBJECT_ROOT), the error budgets
and, with ``-x/-y``, one tile's progress; ``top``
renders the queue, the alert log, the spools' merged metrics and the
series store's sparklines; ``slo`` ingests the spools into the series
store (``series/`` in the spool directory) and prints the error budgets'
verdict, recording state changes in ``slo_events.jsonl`` unless
``--no-record``, and exits 0 (every budget ok or without data), 1 (one
burning or exhausted) or 2 (no series store).  ``validate`` runs the
detector over one chip at ``--dtype`` (default float64) on the card
(``--device cpu`` runs the plain versions; without a card it raises),
replays ``-n`` sampled pixels through ``ccd/reference.py`` and prints the
agreement report, exiting 2 when the structure does not agree 100 %.

The ingest and object-tier commands answer as the JAX package's do, on
the host only.  ``fetch`` mirrors the tile's first ``NUMBER`` chips from
the configured source into a ``FileSource`` archive in OUTDIR (with
``--aux`` their AUX layers too), dead-letters the chips that exhaust their
retries to ``OUTDIR/quarantine.json`` and exits 3 when one failed.
``watch`` polls the configured source's acquisition manifest
(``list_acquisitions``: the synthetic and file sources) and keeps the
fleet queue fed: each new scene becomes at most one open ``stream`` job a
chip of the tile at (x, y), behind a ``detect`` bootstrap job where the
chip has no stream checkpoint yet; scene ids dedupe against the durable
cursor ``watcher.db`` next to the store (or FIREBIRD_WATCH_DB).  With
``--once`` it polls once and prints the poll's summary; without, it polls
every ``--interval`` seconds until signalled, with the ops surface
(``/progress`` gains a ``streamops`` block; this loads torch, never
CUDA, as ``fleet supervise`` does) and prints the watcher's status.  The
jobs run on the card of the ``fleet work`` process that claims them.
``objectstore census`` prints the key, manifest, chunk and orphan counts
of FIREBIRD_OBJECT_ROOT; ``objectstore scrub`` reclaims the orphaned
chunks older than ``--grace`` seconds (FIREBIRD_OBJECT_SCRUB_GRACE_SEC),
reporting without deleting under ``--dry-run``.  Both exit 1 without an
object root.  ``fetch``, ``watch --once`` and the ``objectstore``
commands load neither torch nor the detector.

The serving commands answer as the JAX package's do, on the host only:
they load neither torch nor the detector (the rows they serve are the
ones the card wrote).  ``export`` mosaics the stored product rows over
the bounds area into one georeferenced raster per (product, date)
(``envi``: .dat + .hdr; ``npy``: .npy + .json) and prints each path.
``serve`` runs the query API (``/v1/segments``, ``/v1/pixel``,
``/v1/product/<name>``, ``/v1/tile/<name>``,
``/v1/pyramid/<name>/<z>/<x>/<y>``, ``/healthz``, ``/metrics``) until
SIGINT/SIGTERM: a cold product computes once per key (single-flight) and
persists; answers carry strong ETags; a changefeed consumer tails the
alert log and the product_writes feed (``changefeed.db`` next to the
store, or FIREBIRD_CHANGEFEED_DB) so N replicas and a live writer stay
coherent.  Where the store has an alert log (``alerts.db`` next to the
store, or FIREBIRD_ALERT_DB), ``serve`` mounts the change-alert feed:
``/v1/alerts`` (cursor pull), ``/v1/alerts/stream`` (SSE push) and
``/v1/alerts/webhooks`` (registration, listing), with the flat webhook
deliverer on a background thread and, when FIREBIRD_FANOUT is on, the
fanout coordinator enqueueing one ``fanout`` fleet job per quadkey shard
(a ``fleet work`` process drains them); an unavailable log or queue
degrades with a warning.  ``pyramid build`` materializes the quadkey
tiles over the bounds area, base upward, and prints the per-level
summary; with ``--enqueue`` it enqueues a fleet ``pyramid`` job instead.

``probe`` is the JAX package's black-box canary (obs/prober.py), on the
host only: every ``-i`` seconds (FIREBIRD_PROBE_SEC) it GETs the serve
replica's ``/v1/pixel`` and ``/v1/pyramid`` with ETag revalidation and,
with ``--landing`` and ``-x/-y``, drives synthetic scenes for the probe
chips (``--chip-offset``, ``--chips`` of the watched tile's chip list)
through the landing zone, the watcher, the fleet's jobs on the card and
the alert log to the SSE stream and a local webhook sink; it spools its
``probe_*`` metrics under role ``prober`` and prints its status when it
stops (after ``-n`` cycles, or on SIGINT/SIGTERM).  A bad combination of
options exits 2.

``schema`` prints the JAX command's Cassandra DDL byte for byte: one CQL
statement a line (keyspace, then each result table), the keyspace
``Config.from_env().keyspace()`` unless ``-k`` names one.  ``lint`` is
the port's firebird-lint (``analysis/``): the knob-registry,
metrics-contract and thread-ownership families over
``firebird_tpu_torch/`` against the port's registries and its baseline
``analysis/lint_baseline.json``, every option passed through (``lint
--help``); ``--rules jax-hotpath`` exits 2 (not ported: the port has no
jitted code).  Both load neither torch nor the detector.
"""

from __future__ import annotations

import argparse
import json
import time

# Each command imports what it runs: the fleet's queue commands and
# ``trace collect`` start without torch or the detector.


def _run_config(args):
    """``Config.from_env`` with the command line's ops overrides (None:
    no override), after bringing up one process per card."""
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.parallel import init_distributed

    init_distributed()
    overrides = {k: v for k, v in
                 (("trace", args.trace), ("ops_port", args.ops_port),
                  ("profile", args.profile), ("slo", args.slo),
                  ("faults", args.faults))
                 if v is not None}
    return Config.from_env(**overrides)


def _run_identity() -> dict:
    """The run id, the process's index and count, and the artifacts the
    run wrote (driver.core.last_run_artifacts)."""
    from firebird_tpu_torch.driver import core
    from firebird_tpu_torch.parallel import dist

    art = dict(core.last_run_artifacts)
    return dict(run_id=art.pop("run_id", None),
                process_index=dist.process_index(),
                process_count=dist.process_count(), artifacts=art)


def changedetection(args) -> dict:
    from firebird_tpu_torch.driver import core
    from firebird_tpu_torch.obs import Counters

    cfg = _run_config(args)
    counters = Counters()
    t0 = time.perf_counter()
    done = core.changedetection(
        x=args.x, y=args.y, acquired=args.acquired, number=args.number,
        chunk_size=args.chunk_size, cfg=cfg, resume=args.resume,
        device=args.device, counters=counters)
    wall = time.perf_counter() - t0
    snap = counters.snapshot()
    return dict(chips_done=len(done), chips_detected=snap.get("chips", 0),
                pixels=snap.get("pixels", 0),
                segments=snap.get("segments", 0),
                pixels_per_sec=snap.get("pixels_per_sec", 0.0),
                seconds=dict(core.stage_seconds(), total=wall),
                **_run_identity())


def stream(args) -> dict:
    from firebird_tpu_torch.driver import stream as sdrv

    cfg = _run_config(args)
    t0 = time.perf_counter()
    summary = sdrv.stream(x=args.x, y=args.y, acquired=args.acquired,
                          number=args.number, cfg=cfg, device=args.device)
    return dict(summary, seconds=dict(sdrv.stream_stage_seconds(),
                                      total=time.perf_counter() - t0),
                **_run_identity())


def _ops_options(p) -> None:
    """The ops flags of ``changedetection`` and ``stream`` (the JAX
    command line's)."""
    p.add_argument("-t", "--trace", default=None,
                   help="host span tracer output (Chrome-trace JSON, opens "
                        "in Perfetto): '1' writes trace.json next to the "
                        "store, a path writes there; overrides "
                        "FIREBIRD_TRACE")
    p.add_argument("--ops-port", default=None, type=int,
                   help="serve the live ops endpoints (/healthz /readyz "
                        "/metrics /progress /report) on this port for the "
                        "duration of the run; overrides FIREBIRD_OPS_PORT "
                        "— off (no port bound) when neither is set")
    p.add_argument("--profile", default=None, type=float,
                   help="capture ONE automatic device-profile window of "
                        "this many seconds starting at the first dispatch "
                        "(artifact under <store dir>/device_profile/; "
                        "further windows via POST /profile on the ops "
                        "endpoint); overrides FIREBIRD_PROFILE")
    p.add_argument("--slo", default=None,
                   help="SLO spec 'name=target;...' evaluated at /slo and "
                        "in the obs report (objectives: batch_p95, "
                        "serve_p99, freshness; '0' disables); overrides "
                        "FIREBIRD_SLO")
    p.add_argument("--faults", default=None,
                   help="deterministic fault-injection plan for chaos "
                        "drills, e.g. 'ingest:p=0.05,seed=7;store:after=40,"
                        "brownout=3' (faults.py); overrides FIREBIRD_FAULTS "
                        "— off (no injection, no proxies) when neither is "
                        "set")


def classification(args) -> dict:
    from firebird_tpu_torch.driver import core
    from firebird_tpu_torch.obs import Counters
    from firebird_tpu_torch.rf import pipeline

    counters = Counters()
    t0 = time.perf_counter()
    model = core.classification(
        x=args.x, y=args.y, msday=args.msday, meday=args.meday,
        acquired=args.acquired, device=args.device, counters=counters)
    wall = time.perf_counter() - t0
    snap = counters.snapshot()
    return dict(trained=model is not None,
                training_rows=snap.get("training_rows", 0),
                classes=None if model is None else model.classes.tolist(),
                chips_classified=snap.get("chips", 0),
                segments=snap.get("segments", 0),
                segments_scored=snap.get("segments_scored", 0),
                seconds=dict(pipeline.classification_stage_seconds(),
                             total=wall))


def save(args) -> dict:
    from firebird_tpu_torch import products

    bounds = [tuple(float(v) for v in b.split(",")) for b in args.bounds]
    t0 = time.perf_counter()
    written = products.save(bounds=bounds, products=args.products,
                            product_dates=args.product_dates,
                            acquired=args.acquired, clip=args.clip,
                            device=args.device)
    return dict(rasters=len(written), written=[list(w) for w in written],
                seconds=time.perf_counter() - t0)


def detect(args) -> dict:
    import torch

    from firebird_tpu_torch.ccd import format as fmt
    from firebird_tpu_torch.ccd import kernel, params
    from firebird_tpu_torch.ccd.sensor import SENSORS
    from firebird_tpu_torch.ingest import SyntheticSource, pack
    from firebird_tpu_torch.parallel import detect_sharded

    dev = kernel.resolve_device(args.device)
    src = SyntheticSource(args.seed, start=args.start, end=args.end,
                          sensor=SENSORS[args.sensor])
    t0 = time.perf_counter()
    packed = pack([src.chip(3000 * c, 0) for c in range(args.chips)])
    t_pack = time.perf_counter()
    fused = None if args.fused is None else {"0": 0, "1": 1,
                                             "mon": "mon"}[args.fused]
    route = kernel.pallas_components(
        args.pallas, mixed=None if args.mixed is None else args.mixed == "1")
    compact = None if args.compact is None else args.compact == "1"
    if args.shards:
        devices = ([dev] * args.shards if dev.type == "cpu" else
                   [f"cuda:{i % torch.cuda.device_count()}"
                    for i in range(args.shards)])
        seg = detect_sharded(packed, devices, fused=fused, ops=route,
                             compact=compact)
    else:
        seg = kernel.detect_packed(packed, device=dev, fused=fused, ops=route,
                                   compact=compact)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_det = time.perf_counter()
    # The table frames are the reference's Landsat segment schema
    # (format.batch_frames refuses another band layout): a Sentinel-2 run
    # reports no segment rows.
    landsat = packed.sensor.band_names == params.BAND_NAMES
    frames = fmt.batch_frames(packed, seg) if landsat else None
    t_end = time.perf_counter()
    return dict(
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        route=kernel.fused_mode(fused),
        pallas=list(route.components), mixed=route.mixed,
        compact=kernel.compact_mode(compact), shards=args.shards or 1,
        lanes_migrated=(None if seg.lanes_migrated is None
                        else int(seg.lanes_migrated.sum())),
        chips=args.chips, pixels=int(seg.n_segments.numel()),
        T=int(packed.spectra.shape[-1]),
        segments=int(seg.n_segments.sum()), rounds=int(seg.rounds.max()),
        sensor=packed.sensor.name,
        segment_rows=(sum(len(f["segment"]["sday"]) for _, f in frames)
                      if landsat else None),
        seconds=dict(source_pack=t_pack - t0, detect=t_det - t_pack,
                     frames=t_end - t_det, total=t_end - t0))


def _sensor(name: str) -> str:
    from firebird_tpu_torch.ccd.sensor import SENSORS

    if name not in SENSORS:
        raise argparse.ArgumentTypeError(
            f"invalid choice: {name!r} (choose from {sorted(SENSORS)})")
    return name


def _parse_points(points) -> list[tuple[float, float]]:
    out = []
    for b in points:
        x, y = b.split(",")
        out.append((float(x), float(y)))
    return out


def fleet_enqueue(args) -> dict:
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.fleet import enqueue_tile_plan, make_queue
    from firebird_tpu_torch.utils import dates

    cfg = Config.from_env()
    queue = make_queue(cfg)
    try:
        summary = enqueue_tile_plan(
            queue, _parse_points(args.tiles),
            acquired=args.acquired or dates.default_acquired(),
            number=args.number, chunk_size=args.chunk_size,
            msday=args.msday, meday=args.meday, products=args.products,
            product_dates=args.product_dates,
            max_attempts=args.max_attempts or cfg.fleet_max_attempts)
        return {"queue": queue.path, **summary}
    finally:
        queue.close()


def fleet_work(args) -> None:
    """One fleet worker on this process's card, until the queue drains
    (or as the flags say); prints its summary and exits 4 (WEDGED_EXIT)
    on a wedged queue."""
    import signal
    import threading

    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.driver import core
    from firebird_tpu_torch.fleet import WEDGED_EXIT, FleetWorker, make_queue
    from firebird_tpu_torch.obs import spool as obs_spool

    if sum((args.forever, args.until_drained, args.hold_idle)) > 1:
        raise SystemExit("--forever, --until-drained and --hold-idle are "
                         "exclusive")
    overrides = {"ops_port": args.ops_port} \
        if args.ops_port is not None else {}
    cfg = Config.from_env(**overrides)
    queue = make_queue(cfg)
    worker = FleetWorker(cfg, queue, poll_sec=args.poll,
                         kind="stream" if args.forever else "batch")
    obs_spool.arm(cfg, "worker", worker.run_id)
    stop = threading.Event()
    _, srv, wd = worker.start_ops()
    # After the ops surface: a retiring supervisor's SIGTERM is this
    # worker's graceful drain, not a crash, so the flight recorder's
    # SIGTERM dump (armed by start_ops) does not take it.
    if args.forever or args.hold_idle or args.drain_on_term:
        signal.signal(signal.SIGINT, lambda *_: stop.set())
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        summary = worker.run(max_jobs=args.max_jobs,
                             until_drained=args.until_drained,
                             forever=args.forever or args.hold_idle,
                             stop=stop)
    finally:
        obs_spool.disarm()
        core.stop_ops(srv, wd)
        queue.close()
    print(json.dumps(summary, indent=1))
    if summary.get("wedged"):
        raise SystemExit(WEDGED_EXIT)


def fleet_supervise(args) -> None:
    """The autoscaling supervisor over the config's queue; host only (its
    ops surface asks nothing of CUDA, so the card stays the workers').
    Prints its summary; exits 4 on a wedged queue, 3 when another
    supervisor is live on the queue."""
    import os
    import signal
    import sys
    import threading

    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.driver import core
    from firebird_tpu_torch.fleet import WEDGED_EXIT, Supervisor, make_queue
    from firebird_tpu_torch.obs import Counters, jsonlog
    from firebird_tpu_torch.obs import spool as obs_spool

    overrides = {k: v for k, v in
                 (("fleet_min_workers", args.min_workers),
                  ("fleet_max_workers", args.max_workers),
                  ("fleet_grace_sec", args.grace),
                  ("ops_port", args.ops_port)) if v is not None}
    cfg = Config.from_env(**overrides)
    queue = make_queue(cfg)
    sup = Supervisor(
        cfg, queue, tick_sec=args.tick, grace_sec=cfg.fleet_grace_sec,
        log_dir=args.log_dir or os.path.join(
            os.path.dirname(os.path.abspath(queue.path)), "worker_logs"))
    run_block = {"kind": "fleet-supervisor", "run_id": sup.run_id,
                 "host": jsonlog.HOST, "queue": queue.path}
    _, srv, wd = core.start_ops(cfg, sup.run_id, "fleet-supervisor",
                                chips_total=0, counters=Counters(),
                                run_block=run_block, fleet=sup.fleet_block,
                                host_only=True)
    obs_spool.arm(cfg, "supervisor", sup.run_id)
    # After the ops surface, as in fleet_work: SIGTERM is the operator's
    # graceful stop (retire the workers, then exit), not a crash dump.
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        summary = sup.run(until_drained=args.until_drained, stop=stop)
        if stop.is_set() and not sup.drain_out(
                timeout=cfg.fleet_grace_sec + 10.0):
            print("warning: workers still draining at supervisor exit "
                  f"(pids {sorted(sup.workers)})", file=sys.stderr)
    except RuntimeError as e:
        # The succession guard: a LIVE supervisor already runs here.
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(3)
    finally:
        obs_spool.disarm()
        core.stop_ops(srv, wd)
        queue.close()
    print(json.dumps(summary, indent=1))
    if summary.get("wedged"):
        raise SystemExit(WEDGED_EXIT)


def fleet_status(args) -> None:
    """The queue's state; an unreadable queue prints an error document
    and exits 3."""
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.fleet import make_queue, queue_path

    cfg = Config.from_env()
    try:
        queue = make_queue(cfg)
        try:
            print(json.dumps(queue.status(), indent=1))
        finally:
            queue.close()
    except Exception as e:
        try:
            path = queue_path(cfg)
        except ValueError:
            path = None
        print(json.dumps({"path": path, "error": f"{type(e).__name__}: {e}"},
                         indent=1))
        raise SystemExit(3)


def fleet_requeue(args) -> None:
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.fleet import make_queue

    if (args.job_id is None) == (not args.dead):
        raise SystemExit("pass a JOB_ID or --dead (not both)")
    queue = make_queue(Config.from_env())
    try:
        n = queue.requeue(args.job_id)
    finally:
        queue.close()
    print(f"{n} job(s) requeued")


def trace_collect(args) -> dict:
    import os

    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.obs import collect as obs_collect
    from firebird_tpu_torch.obs import spool as obs_spool

    cfg = Config.from_env()
    directory = args.directory or obs_spool.spool_dir(cfg)
    if directory is None:
        raise SystemExit(
            "no spool directory: pass --dir or set FIREBIRD_TELEMETRY_DIR "
            "(the memory store backend has no 'next to the store' default)")
    doc = obs_collect.collect(directory)
    path = obs_collect.write(
        doc, args.out or os.path.join(directory, "telemetry_collect.json"))
    return {"spool_dir": directory, "out": path,
            "processes": [f"{p['role']}:{p['pid']}"
                          for p in doc["processes"]],
            "trace_events": len(doc["trace"]["traceEvents"]),
            "critical_paths": len(doc["critical_paths"])}


class _UsageError(Exception):
    """A command's refusal of its arguments: exit 2 with the usage line,
    as the JAX command line's ``click.BadParameter``."""


def products_cmd(args) -> None:
    """The products that can be run, one name a line."""
    from firebird_tpu_torch import products

    for name in products.available():
        print(name)


def tiles(args) -> None:
    """The tiles covering the bounds points as h,v,ulx,uly,lrx,lry CSV
    rows, optionally the i-th of n strided shards."""
    from firebird_tpu_torch import grid

    recs = grid.tiles_for_bounds(_parse_points(args.bounds))
    if args.shard is not None:
        try:
            i, n = (int(v) for v in args.shard.split("/"))
        except ValueError as e:
            raise _UsageError("shard must be i/n with 0 <= i < n") from e
        if not 0 <= i < n:
            raise _UsageError("shard must be i/n with 0 <= i < n")
        recs = recs[i::n]
    print("h,v,ulx,uly,lrx,lry")
    for r in recs:
        print(f"{r['h']},{r['v']},{r['ulx']:.0f},{r['uly']:.0f},"
              f"{r['lrx']:.0f},{r['lry']:.0f}")


def validate_cmd(args) -> None:
    """The parity audit of one chip (validate.validate); exits 2 when the
    structure does not agree 100 %."""
    from firebird_tpu_torch import validate

    report = validate.validate(x=args.x, y=args.y, acquired=args.acquired,
                               n_pixels=args.n_pixels, dtype=args.dtype,
                               seed=args.seed, device=args.device)
    print(json.dumps(report, indent=1))
    if not report["structural_agreement"]:
        raise SystemExit(2)


def _status_doc(cfg, x=None, y=None) -> dict:
    """The ``status`` document: the store's tables and chips, quarantine,
    the fleet queue, the alert log, the stream checkpoint store, the
    serving view (changefeed replicas, pyramid census), the error budgets,
    the watcher's cursor, the object root's census and (with x, y) one
    tile's progress — the JAX command's sections, each guarded so a
    broken one degrades alone."""
    import collections
    import os

    from firebird_tpu_torch import grid
    from firebird_tpu_torch.driver import quarantine as _quarantine
    from firebird_tpu_torch.store import TABLES, open_store

    store = open_store(cfg.store_backend, cfg.store_path, cfg.keyspace())
    done = store.chip_ids("segment")
    out = {
        "backend": cfg.store_backend,
        "path": cfg.store_path,
        "keyspace": cfg.keyspace(),
        "tables": {t: store.count(t) for t in TABLES},
        "chips_with_segments": len(done),
    }
    qpath = _quarantine.quarantine_path(cfg)
    if qpath is not None and os.path.exists(qpath):
        q = _quarantine.Quarantine.load(qpath)
        errors = collections.Counter(
            e.get("error", "unknown") for e in q.snapshot()["chips"].values())
        out["quarantine"] = {"path": qpath, "chips": len(q),
                             "errors": dict(sorted(errors.items()))}
    else:
        out["quarantine"] = {"path": qpath, "chips": 0, "errors": {}}
    try:
        from firebird_tpu_torch.fleet import FleetQueue, queue_path

        fpath = queue_path(cfg)
    except ValueError:
        fpath = None            # memory backend without FIREBIRD_FLEET_DB
    if fpath is not None and os.path.exists(fpath):
        try:
            fq = FleetQueue(fpath, lease_sec=cfg.fleet_lease_sec)
            try:
                s = fq.status()
            finally:
                fq.close()
            sup = s.get("supervisor")
            out["fleet"] = {
                "path": fpath,
                "jobs": s["jobs"],
                "by_type": s["by_type"],
                "blocked": s["blocked"],
                "leases": s["leases"],
                "workers": s.get("workers", []),
                "supervisor": None if sup is None else {
                    k: sup.get(k) for k in
                    ("pid", "host", "target", "live", "retiring", "min",
                     "max", "adopted_total", "parks", "drain_eta_sec",
                     "last_decision", "beat_age_sec")},
                "dead": len(s["dead"]),
                "dead_errors": s["dead_errors"],
                "fence_rejects": s["fence_rejects"],
            }
        except Exception as e:
            out["fleet"] = {"path": fpath,
                            "error": f"{type(e).__name__}: {e}"}
    from firebird_tpu_torch.alerts import AlertLog, alert_db_path

    apath = alert_db_path(cfg)
    if apath is not None and os.path.exists(apath):
        try:
            al = AlertLog(apath)
            try:
                s = al.status()
            finally:
                al.close()
            by_type = (out.get("fleet") or {}).get("by_type") or {}
            rep = by_type.get("repair", {})
            fan = by_type.get("fanout", {})
            out["alerts"] = {
                "path": apath,
                "depth": s["depth"],
                "latest_cursor": s["latest_cursor"],
                "subscribers": s["subscribers"],
                "open_repair_jobs": int(rep.get("pending", 0))
                + int(rep.get("leased", 0)),
                "fanout": dict(s.get("fanout") or {},
                               open_jobs=int(fan.get("pending", 0))
                               + int(fan.get("leased", 0))),
            }
        except Exception as e:
            out["alerts"] = {"path": apath,
                             "error": f"{type(e).__name__}: {e}"}
    try:
        from firebird_tpu_torch.streamops import open_statestore

        sstore = open_statestore(cfg)
        try:
            scan = sstore.scan() if hasattr(sstore, "scan") \
                else sstore.status()
        finally:
            sstore.close()
        out["streamops"] = {"statestore": scan}
        from firebird_tpu_torch.streamops.watcher import (SceneCursor,
                                                          watch_db_path)
        try:
            wpath = watch_db_path(cfg)
        except ValueError:
            wpath = None
        if wpath is not None and os.path.exists(wpath):
            cur = SceneCursor(wpath)
            try:
                out["streamops"]["watcher"] = cur.status()
            finally:
                cur.close()
    except Exception as e:
        out["streamops"] = {"error": f"{type(e).__name__}: {e}"}
    # Serving view: the replica fleet as the shared changefeed db sees it
    # and the pyramid's tile census by level, guarded like the others.
    try:
        from firebird_tpu_torch.serve import changefeed as _cflib
        from firebird_tpu_torch.serve import pyramid as _pyrlib

        serving: dict = {}
        fpath = _cflib.changefeed_db_path(cfg)
        if fpath is not None and os.path.exists(fpath):
            pw = _cflib.ProductWrites(fpath)
            try:
                reps = pw.replicas()
                serving["changefeed"] = {
                    "path": fpath,
                    "latest_cursor": pw.latest_cursor(),
                    "replicas_seen": len(reps),
                    "replicas": reps,
                }
            finally:
                pw.close()
        proot = _pyrlib.pyramid_root(cfg)
        pstorage = None if proot is None \
            else _pyrlib.pyramid_storage(cfg, proot)
        if pstorage is not None or (proot is not None
                                    and os.path.isdir(proot)):
            serving["pyramid"] = _pyrlib.TilePyramid(
                proot, storage=pstorage).status()
        if serving:
            out["serving"] = serving
    except Exception as e:
        out["serving"] = {"error": f"{type(e).__name__}: {e}"}
    # Object-tier view: the census of the configured object root, which
    # never raises; anything else degrades this section alone.
    if cfg.object_root:
        try:
            from firebird_tpu_torch.store import open_object_root

            ostore = open_object_root(cfg=cfg)
            try:
                out["object"] = {"backend": "local-dir", **ostore.census()}
            finally:
                ostore.close()
        except Exception as e:
            out["object"] = {"root": cfg.object_root,
                             "error": f"{type(e).__name__}: {e}"}
    # Error-budget view: the multi-window burn verdict over the durable
    # metric series next to the telemetry spools — read-only here (no
    # event recording; that belongs to `slo` and the ops endpoint).
    try:
        from firebird_tpu_torch.obs import series as _series
        from firebird_tpu_torch.obs import slo as _slo

        sstore = _series.open_store(cfg)
        if sstore is not None:
            try:
                sstore.ingest_spools()
                v = _slo.evaluate_budgets(
                    sstore.dir, cfg.slo_budget or None,
                    fast_sec=cfg.slo_fast_sec, slow_sec=cfg.slo_slow_sec,
                    burn_threshold=cfg.slo_burn)
            finally:
                sstore.close()
            out["budgets"] = {
                "ok": v["ok"], "violations": v["violations"],
                "budgets": {b["name"]: {
                    "ok": b["ok"], "budget_spent": b["budget_spent"],
                    "exhausted": b["exhausted"], "burning": b["burning"],
                    "fast_burn": b["fast_burn"],
                    "slow_burn": b["slow_burn"],
                    "empty_windows": b["empty_windows"],
                } for b in v["budgets"]},
            }
    except Exception as e:
        out["budgets"] = {"error": f"{type(e).__name__}: {e}"}
    if x is not None:
        tile = grid.tile(x, y)
        cids = [tuple(int(v) for v in c) for c in grid.chips(tile)]
        out["tile"] = {
            "h": tile["h"], "v": tile["v"],
            "chips_done": sum(1 for c in cids if c in done),
            "chips_total": len(cids),
        }
    return out


def status(args) -> None:
    from firebird_tpu_torch.config import Config

    if (args.x is None) != (args.y is None):
        raise _UsageError("tile progress needs both -x and -y")
    print(json.dumps(_status_doc(Config.from_env(), args.x, args.y),
                     indent=1))


def _top_frame(cfg) -> dict:
    """One ``top`` sample: queue + alert + telemetry views, each guarded
    (a locked db or empty spool degrades its section, never the frame)."""
    import os

    from firebird_tpu_torch.obs import collect as obs_collect
    from firebird_tpu_torch.obs import spool as obs_spool

    frame: dict = {}
    try:
        from firebird_tpu_torch.fleet import make_queue

        queue = make_queue(cfg)
        try:
            frame["fleet"] = queue.status()
        finally:
            queue.close()
    except Exception as e:
        frame["fleet"] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from firebird_tpu_torch.alerts import AlertLog, alert_db_path

        apath = alert_db_path(cfg)
        if apath is not None and os.path.exists(apath):
            al = AlertLog(apath)
            try:
                frame["alerts"] = al.status()
            finally:
                al.close()
    except Exception as e:
        frame["alerts"] = {"error": f"{type(e).__name__}: {e}"}
    d = obs_spool.spool_dir(cfg)
    if d is not None and os.path.isdir(d):
        try:
            events = obs_collect.read_events(d)
            snaps = obs_collect.latest_snapshots(events)
            frame["telemetry"] = {
                "spool_dir": d,
                "snapshots": snaps,
                "metrics": obs_collect.merge_snapshots(snaps),
            }
        except Exception as e:
            frame["telemetry"] = {"error": f"{type(e).__name__}: {e}"}
    # Durable history (obs/series.py): ingest the spools into the series
    # store and pull the busiest metrics' last ~30 fine-resolution buckets
    # for sparklines.  No section when telemetry or the store is off.
    try:
        from firebird_tpu_torch.obs import series as obs_series

        sstore = obs_series.open_store(cfg)
        if sstore is not None:
            try:
                sstore.ingest_spools()
                res = sstore.resolutions[0]
                now = time.time()
                pts = sstore.points(res, now - 30 * res, now)
            finally:
                sstore.close()
            names: dict = {}
            for p in pts:
                m = p.get("m") or {}
                for n in (m.get("counters") or {}):
                    names.setdefault(n, "counter")
                for n in (m.get("histograms") or {}):
                    names.setdefault(n, "histogram")
            spark = {}
            for n, kind in names.items():
                vals = [v for _, v in
                        obs_series.bucket_series(pts, n, kind, res)]
                if any(v > 0 for v in vals):
                    spark[n] = {"kind": kind, "values": vals}
            frame["series"] = {
                "res_sec": res,
                "sparklines": dict(sorted(
                    spark.items(),
                    key=lambda kv: -sum(kv[1]["values"]))[:8]),
            }
    except Exception as e:
        frame["series"] = {"error": f"{type(e).__name__}: {e}"}
    return frame


_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def _sparkline(values) -> str:
    """Unicode block sparkline, scaled to the window's max (pure)."""
    if not values:
        return ""
    hi = max(values)
    if hi <= 0:
        return _SPARK_GLYPHS[0] * len(values)
    top = len(_SPARK_GLYPHS) - 1
    return "".join(
        _SPARK_GLYPHS[min(int(v / hi * top + 0.5), top)] for v in values)


def _render_top(frame: dict) -> list[str]:
    """One top frame as terminal lines (pure)."""
    lines = [f"firebird top — {time.strftime('%H:%M:%S')}"]
    fl = frame.get("fleet") or {}
    if "error" in fl:
        lines.append(f"fleet: unavailable ({fl['error']})")
    elif fl:
        jobs = fl.get("jobs") or {}
        lines.append(
            "fleet: " + " ".join(f"{k}={jobs.get(k, 0)}" for k in
                                 ("pending", "leased", "done", "dead"))
            + f" workers={len(fl.get('workers') or [])}"
            + f" leases={len(fl.get('leases') or [])}")
        sup = fl.get("supervisor")
        if sup:
            lines.append(
                f"supervisor: target={sup.get('target')} "
                f"live={sup.get('live')} "
                f"last={sup.get('last_decision')}")
    al = frame.get("alerts") or {}
    if "error" in al:
        lines.append(f"alerts: unavailable ({al['error']})")
    elif al:
        subs = al.get("subscribers") or []
        lag = max((s["lag"] for s in subs), default=0)
        lines.append(f"alerts: depth={al.get('depth')} "
                     f"cursor={al.get('latest_cursor')} "
                     f"subscribers={len(subs)} max_lag={lag}")
    tel = frame.get("telemetry") or {}
    if "error" in tel:
        lines.append(f"telemetry: unavailable ({tel['error']})")
    elif tel:
        now = time.time()
        for key in sorted(tel.get("snapshots") or {}):
            s = tel["snapshots"][key]
            lines.append(f"  {key:<24} snap {now - s['t']:5.1f}s ago")
        m = tel.get("metrics") or {}
        for n, v in sorted((m.get("counters") or {}).items()):
            lines.append(f"  {n:<40} {v:g}")
        for n, h in sorted((m.get("histograms") or {}).items()):
            if h.get("count"):
                lines.append(
                    f"  {n:<40} n={h['count']} p50={h['p50']:.3g}s "
                    f"p95={h['p95']:.3g}s max={h['max']:.3g}s")
    sr = frame.get("series") or {}
    if "error" in sr:
        lines.append(f"history: unavailable ({sr['error']})")
    elif sr.get("sparklines"):
        lines.append(f"history ({sr['res_sec']:g}s buckets, "
                     "rate per bucket):")
        for n, s in sorted(sr["sparklines"].items()):
            lines.append(f"  {n:<40} {_sparkline(s['values'])} "
                         f"max={max(s['values']):g}")
    if len(lines) == 1:
        lines.append("(no fleet, alert, or telemetry state found)")
    return lines


def top(args) -> None:
    """The live fleet console: ``--iterations`` frames (0: until ctrl-c)
    of the queue, the alert log, the spools and the series store."""
    from firebird_tpu_torch.config import Config

    cfg = Config.from_env()
    n = 0
    while True:
        print("\n".join(_render_top(_top_frame(cfg))), flush=True)
        n += 1
        if args.iterations and n >= args.iterations:
            break
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            break
        print("")


def slo(args) -> None:
    """The error budgets over the durable metric series: prints the
    verdict; exits 0 when every budget is ok (or has no data), 1 when one
    burns or is exhausted, 2 when the series store is disabled."""
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.obs import series as obs_series
    from firebird_tpu_torch.obs import slo as obs_slo

    cfg = Config.from_env()
    store = obs_series.open_store(cfg)
    if store is None:
        print(json.dumps(
            {"disabled": True,
             "reason": "series store off (FIREBIRD_TELEMETRY / "
                       "FIREBIRD_SERIES / no spool home)"}))
        raise SystemExit(2)
    try:
        store.ingest_spools()
        kw = dict(
            fast_sec=args.fast if args.fast is not None else cfg.slo_fast_sec,
            slow_sec=args.slow if args.slow is not None else cfg.slo_slow_sec,
            burn_threshold=(args.burn if args.burn is not None
                            else cfg.slo_burn))
        spec = args.budget if args.budget is not None \
            else (cfg.slo_budget or None)
        verdict = obs_slo.evaluate_and_record(store.dir, spec, **kw) \
            if args.record else obs_slo.evaluate_budgets(store.dir, spec, **kw)
    finally:
        store.close()
    print(json.dumps(verdict, indent=1))
    if not verdict.get("ok", True):
        raise SystemExit(1)


def fetch_cmd(args) -> None:
    """Mirror a tile's chips into a FileSource archive (driver.fetch);
    exits 3 when a chip failed permanently."""
    import sys

    from firebird_tpu_torch.driver import fetch as dfetch

    n, attempted = dfetch.fetch(x=args.x, y=args.y, outdir=args.outdir,
                                acquired=args.acquired, number=args.number,
                                aux=args.aux)
    print(f"{n} chips written to {args.outdir}")
    if n < attempted:
        print(f"WARNING: {attempted - n} chips failed permanently — the "
              "archive is incomplete", file=sys.stderr)
        raise SystemExit(3)


def watch(args) -> None:
    """The acquisition watcher over the tile at (x, y): one poll with
    ``--once``, else a standing loop until SIGINT/SIGTERM."""
    import signal
    import threading

    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.obs import spool as obs_spool
    from firebird_tpu_torch.streamops import AcquisitionWatcher

    overrides = {"ops_port": args.ops_port} \
        if args.ops_port is not None else {}
    cfg = Config.from_env(**overrides)
    watcher = AcquisitionWatcher(cfg, args.x, args.y, number=args.number,
                                 acquired_start=args.acquired_start)
    if args.once:
        obs_spool.arm(cfg, "watcher")
        try:
            summary = watcher.poll_once()
        finally:
            obs_spool.disarm()
            watcher.close()
        print(json.dumps(summary, indent=1))
        return
    # The standing loop's ops surface is the driver's, host only (no
    # CUDA query, no device profiler), as the supervisor's is.
    from firebird_tpu_torch.driver import core
    from firebird_tpu_torch.obs import Counters, jsonlog

    run_id = jsonlog.new_run_id()
    run_block = {"kind": "watcher", "run_id": run_id,
                 "host": jsonlog.HOST, "tile_h": watcher.tile["h"],
                 "tile_v": watcher.tile["v"]}
    _, srv, wd = core.start_ops(cfg, run_id, "watcher", chips_total=0,
                                counters=Counters(), run_block=run_block,
                                streamops=watcher.status, host_only=True)
    obs_spool.arm(cfg, "watcher", run_id)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        summary = watcher.run(interval=args.interval, stop=stop)
    finally:
        obs_spool.disarm()
        core.stop_ops(srv, wd)
        watcher.close()
    print(json.dumps(summary, indent=1))


def _object_root_or_die():
    """(config, the wired object root); exits 1 without
    FIREBIRD_OBJECT_ROOT, as the JAX command does."""
    import sys

    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.store import open_object_root

    cfg = Config.from_env()
    if not cfg.object_root:
        print("Error: no object root: set FIREBIRD_OBJECT_ROOT",
              file=sys.stderr)
        raise SystemExit(1)
    return cfg, open_object_root(cfg=cfg)


def objectstore_scrub(args) -> None:
    """Reclaim orphaned chunks (no retained manifest references them)
    older than the grace; referenced chunks and manifests are never
    touched, so it is safe against a live fleet."""
    cfg, store = _object_root_or_die()
    try:
        rep = store.scrub(
            grace_sec=cfg.object_scrub_grace_sec if args.grace is None
            else args.grace, dry_run=args.dry_run)
    finally:
        store.close()
    print(json.dumps(rep, indent=1))


def objectstore_census(args) -> None:
    """Key, manifest, chunk and orphan counts over the object root."""
    _cfg, store = _object_root_or_die()
    try:
        print(json.dumps(store.census(), indent=1))
    finally:
        store.close()


def export_cmd(args) -> None:
    """Mosaic stored product rows over the bounds area into one
    georeferenced raster per (product, date) (export.export); prints each
    path written."""
    from firebird_tpu_torch import export
    from firebird_tpu_torch.ccd.sensor import SENSORS

    for p in export.export(args.products, args.product_dates,
                           _parse_points(args.bounds), args.outdir,
                           fmt=args.format, sensor=SENSORS[args.sensor]):
        print(p)


def serve(args) -> None:
    """The query API over the configured results store, with the quadkey
    pyramid, the changefeed consumer, the alert feed and its webhook
    deliverer, and the fanout coordinator, until SIGINT/SIGTERM."""
    import signal
    import sys
    import threading

    from firebird_tpu_torch.alerts import AlertFeed, AlertLog, alert_db_path
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.obs import spool as obs_spool
    from firebird_tpu_torch.serve import api as serve_api
    from firebird_tpu_torch.serve import changefeed as cflib
    from firebird_tpu_torch.serve import pyramid as pyrlib
    from firebird_tpu_torch.store import open_store

    overrides = {k: v for k, v in
                 (("serve_port", args.port), ("serve_host", args.host),
                  ("serve_cache_entries", args.cache_entries),
                  ("serve_cache_dir", args.cache_dir),
                  ("serve_replica", args.replica_id),
                  ("serve_pyramid_dir", args.pyramid_dir)) if v is not None}
    # --port 0 means "ephemeral bind", which Config rejects as a
    # deploy-time port; thread it past validation separately.
    bind_port = overrides.pop("serve_port", None)
    cfg = Config.from_env(**overrides)
    if bind_port is None:
        bind_port = cfg.serve_port
    store = open_store(cfg.store_backend, cfg.store_path, cfg.keyspace(),
                       read_only=args.read_only)
    # Mount the alert feed where this store has an alert log behind it:
    # /v1/alerts endpoints + background webhook delivery.  An unavailable
    # or corrupt log degrades to a serve layer without alerts, not a dead
    # server.
    feed = None
    alog = None
    if cfg.alerts_enabled:
        apath = alert_db_path(cfg)
        if apath is not None:
            try:
                alog = AlertLog(apath)
                feed = AlertFeed(alog, cfg)
                feed.deliverer.start()
            except Exception as e:
                print(f"WARNING: alert log {apath} unavailable "
                      f"({type(e).__name__}: {e}); serving without "
                      "/v1/alerts", file=sys.stderr)
                feed = alog = None
    # The fanout rollup coordinator: poll the alert log, enqueue
    # per-shard ``fanout`` fleet jobs that delivery workers drain.  Without
    # a fleet queue (or with FIREBIRD_FANOUT=0) the serve layer degrades to
    # the flat in-process deliverer only.
    coordinator = None
    if alog is not None and cfg.fanout_enabled:
        try:
            from firebird_tpu_torch.alerts.fanout import FanoutCoordinator
            from firebird_tpu_torch.fleet.worker import make_queue

            coordinator = FanoutCoordinator(
                alog, make_queue(cfg), cfg).start()
        except Exception as e:
            print(f"WARNING: fanout rollup unavailable "
                  f"({type(e).__name__}: {e}); webhook delivery runs "
                  "unsharded", file=sys.stderr)
    proot = pyrlib.pyramid_root(cfg)
    pyr = pyrlib.TilePyramid(
        proot, storage=pyrlib.pyramid_storage(cfg, proot)) \
        if proot else None
    consumer = None
    service = serve_api.ServeService(
        store, cfg, compute_on_miss=not args.no_compute
        and not args.read_only, alerts=feed, pyramid=pyr)
    try:
        fpath = cflib.changefeed_db_path(cfg)
        wfeed = cflib.ProductWrites(fpath) if fpath else None
        if wfeed is not None or alog is not None:
            consumer = cflib.ChangefeedConsumer(
                service.gens, feed=wfeed, alerts=alog,
                replica=cflib.default_replica_id(cfg),
                poll_sec=cfg.serve_feed_poll_sec).start()
            service.changefeed = consumer
    except Exception as e:
        print(f"WARNING: changefeed unavailable ({type(e).__name__}: {e}); "
              "serving with in-process invalidation only", file=sys.stderr)
    obs_spool.arm(cfg, "serve")
    srv = serve_api.start_serve_server(bind_port, service,
                                       host=cfg.serve_host)
    print(f"serving {cfg.store_backend}:{cfg.store_path} "
          f"[{cfg.keyspace()}] on port {srv.port} (ctrl-c to stop)",
          flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        obs_spool.disarm()
        srv.close()
        if coordinator is not None:
            coordinator.stop()
            coordinator.queue.close()
        if consumer is not None:
            consumer.stop()
        if feed is not None:
            feed.close()
        store.close()


def pyramid_build(args) -> None:
    """Materialize pyramid tiles over the bounds area, bottom-up (or
    enqueue a fleet ``pyramid`` job with ``--enqueue``); prints the
    build's summary as JSON."""
    from firebird_tpu_torch import products as prodlib
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.serve import pyramid as pyrlib
    from firebird_tpu_torch.store import open_store

    for p in args.products:
        if p not in prodlib.PRODUCTS:
            raise _UsageError(
                f"unknown product {p!r}; available: {prodlib.PRODUCTS}")
    cfg = Config.from_env()
    bounds = _parse_points(args.bounds)
    if args.enqueue:
        from firebird_tpu_torch.fleet import make_queue

        queue = make_queue(cfg)
        try:
            jid = queue.enqueue("pyramid", {
                "bounds": [list(b) for b in bounds],
                "products": list(args.products),
                "product_dates": list(args.product_dates),
                "levels": int(args.levels), "refresh": bool(args.refresh),
                "compute": not args.no_compute,
            }, max_attempts=cfg.fleet_max_attempts)
            print(json.dumps({"queue": queue.path, "job": jid}))
        finally:
            queue.close()
        return
    root = pyrlib.pyramid_root(cfg)
    if root is None:
        import sys

        print("Error: no pyramid root: set FIREBIRD_SERVE_PYRAMID_DIR (or "
              "use a file-backed store for the next-to-store default)",
              file=sys.stderr)
        raise SystemExit(1)
    store = open_store(cfg.store_backend, cfg.store_path, cfg.keyspace())
    try:
        pyr = pyrlib.TilePyramid(
            root, pyrlib.store_read_chip(store, compute=not args.no_compute),
            storage=pyrlib.pyramid_storage(cfg, root))
        summary = pyr.build_area(list(args.products),
                                 list(args.product_dates), bounds,
                                 levels=args.levels, refresh=args.refresh)
    finally:
        store.close()
    print(json.dumps({"root": root, **summary}, indent=1))


def probe(args) -> None:
    """The black-box canary over a serve replica and a landing zone until
    ``-n`` cycles or SIGINT/SIGTERM; prints the prober's status as JSON.
    Host only (obs/prober.py)."""
    import signal
    import threading

    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.obs import prober as obs_prober

    cfg = Config.from_env()
    try:
        p = obs_prober.CanaryProber(
            cfg, serve_url=args.serve_url, landing=args.landing, x=args.x,
            y=args.y, chip_offset=args.chip_offset, chips=args.chips,
            interval=args.interval, timeout=args.timeout,
            pyramid_product=args.pyramid_product)
    except ValueError as e:
        raise _UsageError(str(e)) from e
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    p.arm()
    try:
        p.run(stop=stop, cycles=args.cycles or None)
    finally:
        p.close()
        print(json.dumps(p.status()), flush=True)


def _serve_parsers(sub) -> None:
    """``export``, ``serve``, the ``pyramid`` group and ``probe`` (the JAX
    command line's options)."""
    x = sub.add_parser("export", help="export stored product rasters as "
                       "georeferenced files")
    x.add_argument("-b", "--bounds", action="append", required=True,
                   help="x,y projection point; repeat to extend the area")
    x.add_argument("-p", "--products", action="append", required=True,
                   help="product name; repeat for several")
    x.add_argument("-d", "--product_dates", action="append", required=True,
                   help="ISO query date; repeat for several")
    x.add_argument("-o", "--outdir", required=True,
                   help="directory for the raster files")
    x.add_argument("-f", "--format", default="envi", choices=("envi", "npy"),
                   help="envi: .dat+.hdr (opens in QGIS/GDAL); npy: "
                        ".npy+.json")
    x.add_argument("-s", "--sensor", default="landsat-ard", type=_sensor,
                   help="campaign sensor spec (chip/pixel geometry)")
    s = sub.add_parser("serve", help="serve the query API over the "
                       "configured results store")
    s.add_argument("-p", "--port", type=int, default=None,
                   help="listen port; overrides FIREBIRD_SERVE_PORT "
                        "(default 8080); 0 binds an ephemeral port")
    s.add_argument("--host", default=None,
                   help="bind address; overrides FIREBIRD_SERVE_HOST")
    s.add_argument("--cache-entries", type=int, default=None,
                   help="in-memory cache bound (entries); overrides "
                        "FIREBIRD_SERVE_CACHE_ENTRIES")
    s.add_argument("--cache-dir", default=None,
                   help="disk spill tier for evicted cache entries; "
                        "overrides FIREBIRD_SERVE_CACHE_DIR")
    s.add_argument("--no-compute", action="store_true",
                   help="disable compute-on-miss: absent product rows "
                        "answer 404")
    s.add_argument("--read-only", action="store_true",
                   help="open the store as a read-only replica connection; "
                        "implies --no-compute")
    s.add_argument("--replica-id", default=None,
                   help="stable changefeed replica id (cursor resume "
                        "across restarts); overrides FIREBIRD_SERVE_REPLICA")
    s.add_argument("--pyramid-dir", default=None,
                   help="quadkey tile-pyramid root for /v1/pyramid; "
                        "overrides FIREBIRD_SERVE_PYRAMID_DIR")
    py = sub.add_parser("pyramid", help="quadkey tile-pyramid precompute")
    psub = py.add_subparsers(dest="pyramid_cmd", required=True)
    b = psub.add_parser("build", help="materialize pyramid tiles over an "
                        "area, bottom-up")
    b.add_argument("-b", "--bounds", action="append", required=True,
                   help="x,y projection point; repeat to extend the area")
    b.add_argument("-p", "--products", action="append", required=True,
                   help="product name; repeat for several")
    b.add_argument("-d", "--product_dates", action="append", required=True,
                   help="ISO query date; repeat for several")
    b.add_argument("-l", "--levels", type=int, default=2,
                   help="pyramid levels to materialize, base upward "
                        "(1 = base tiles only)")
    b.add_argument("--refresh", action="store_true",
                   help="rebuild fresh tiles too (default: skip them)")
    b.add_argument("--no-compute", action="store_true",
                   help="render only stored product rows; chips without one "
                        "render as fill")
    b.add_argument("--enqueue", action="store_true",
                   help="enqueue a fleet `pyramid` job instead of building "
                        "inline")
    pr = sub.add_parser("probe", help="black-box canary prober over a serve "
                        "replica and a landing zone")
    pr.add_argument("--serve-url", default=None,
                    help="serve base URL to probe from outside "
                         "(e.g. http://127.0.0.1:8080)")
    pr.add_argument("--landing", default=None,
                    help="FileSource landing zone directory: arms the "
                         "end-to-end alert probe (synthetic scenes through "
                         "the real watcher/fleet/alert path)")
    pr.add_argument("-x", "--x", type=float, default=None,
                    help="watched tile x (required with --landing)")
    pr.add_argument("-y", "--y", type=float, default=None,
                    help="watched tile y (required with --landing)")
    pr.add_argument("--chip-offset", type=int, default=8,
                    help="first probe chip's index in the tile chip list: "
                         "reserve probe chips inside the watcher's -n "
                         "window but past the production chips")
    pr.add_argument("--chips", type=int, default=24,
                    help="probe-chip reserve (each end-to-end alert probe "
                         "consumes one; the prober stops attempting when "
                         "spent)")
    pr.add_argument("-i", "--interval", type=float, default=None,
                    help="seconds between probe cycles (default "
                         "FIREBIRD_PROBE_SEC)")
    pr.add_argument("--timeout", type=float, default=None,
                    help="per-request timeout seconds (default "
                         "FIREBIRD_PROBE_TIMEOUT)")
    pr.add_argument("-n", "--cycles", type=int, default=0,
                    help="probe cycles before exiting (0 = until "
                         "SIGTERM/ctrl-c)")
    pr.add_argument("--pyramid-product", default="ccd",
                    help="product name for the pyramid tile probe")


SERVE = dict(export=export_cmd, serve=serve, probe=probe)


def _ingest_parsers(sub) -> None:
    """``fetch``, ``watch`` and the ``objectstore`` group (the JAX command
    line's options)."""
    f = sub.add_parser("fetch", help="mirror a tile's chips into a local "
                       "file archive")
    f.add_argument("-x", "--x", type=float, required=True)
    f.add_argument("-y", "--y", type=float, required=True)
    f.add_argument("-a", "--acquired", default=None)
    f.add_argument("-n", "--number", type=int, default=2500)
    f.add_argument("-o", "--outdir", required=True,
                   help="directory for the .npz chip archive")
    f.add_argument("--aux", action="store_true",
                   help="also mirror the AUX layers (training inputs)")
    w = sub.add_parser("watch", help="watch the source's acquisition "
                       "manifest and keep the fleet queue fed")
    w.add_argument("-x", "--x", type=float, required=True)
    w.add_argument("-y", "--y", type=float, required=True)
    w.add_argument("-n", "--number", type=int, default=2500,
                   help="chips of the tile the watcher covers (testing)")
    w.add_argument("--acquired-start", default="1982-01-01",
                   help="archive start date for the jobs' acquired ranges "
                        "(ends derive from each scene's date, half-open)")
    w.add_argument("-i", "--interval", type=float, default=None,
                   help="manifest poll interval seconds; overrides "
                        "FIREBIRD_WATCH_INTERVAL")
    w.add_argument("--once", action="store_true",
                   help="one poll, print its summary JSON, exit (the "
                        "cron/test mode; the default is a standing loop)")
    w.add_argument("--ops-port", type=int, default=None,
                   help="live ops endpoints for the watcher (adds a "
                        "`streamops` block to /progress); overrides "
                        "FIREBIRD_OPS_PORT")
    o = sub.add_parser("objectstore", help="chunked object-tier "
                       "maintenance over FIREBIRD_OBJECT_ROOT")
    osub = o.add_subparsers(dest="objectstore_cmd", required=True)
    sc = osub.add_parser("scrub", help="reclaim orphaned chunks")
    sc.add_argument("--grace", type=float, default=None,
                    help="minimum orphan age in seconds before reclaim "
                         "(default: FIREBIRD_OBJECT_SCRUB_GRACE_SEC)")
    sc.add_argument("--dry-run", action="store_true",
                    help="report what would be reclaimed without deleting")
    osub.add_parser("census", help="key/manifest/chunk/orphan counts over "
                    "the object root")


INGEST = dict(fetch=fetch_cmd, watch=watch)
OBJECTSTORE = dict(scrub=objectstore_scrub, census=objectstore_census)


def _read_parsers(sub) -> None:
    """The read-side commands (the JAX command line's options)."""
    sub.add_parser("products", help="list the products that can be run")
    t = sub.add_parser("tiles", help="enumerate the tiles covering an area "
                       "as h,v,ulx,uly,lrx,lry CSV rows")
    t.add_argument("-b", "--bounds", action="append", required=True,
                   help="x,y projection point; repeat to extend the area")
    t.add_argument("-s", "--shard", default=None,
                   help="i/n: print only the i-th of n strided shards, for "
                        "splitting a fleet launch across workers")
    v = sub.add_parser("validate", help="audit kernel-vs-oracle parity on "
                       "one chip's sampled pixels")
    v.add_argument("-x", "--x", type=float, default=None)
    v.add_argument("-y", "--y", type=float, default=None)
    v.add_argument("-a", "--acquired", default=None)
    v.add_argument("-n", "--n_pixels", type=int, default=100)
    v.add_argument("--dtype", default="float64",
                   choices=("float32", "float64"))
    v.add_argument("--seed", type=int, default=0)
    v.add_argument("--device", default=None,
                   help="torch device (default cuda, this process's card; "
                        "'cpu' runs the plain PyTorch versions)")
    s = sub.add_parser("status", help="inspect the store, quarantine, the "
                       "fleet queue, the alert log and the error budgets")
    s.add_argument("-x", "--x", type=float, default=None,
                   help="with -y: also report this tile's chip progress")
    s.add_argument("-y", "--y", type=float, default=None)
    p = sub.add_parser("top", help="live fleet console over the queue, the "
                       "alert log, the spools and the series store")
    p.add_argument("-i", "--interval", type=float, default=2.0,
                   help="refresh interval, seconds")
    p.add_argument("-n", "--iterations", type=int, default=0,
                   help="frames to render before exiting (0 = until "
                        "ctrl-c)")
    o = sub.add_parser("slo", help="evaluate the error budgets over the "
                       "durable metric series")
    o.add_argument("-b", "--budget", default=None,
                   help="objective spec override ('name[<thr]@target/"
                        "window;...'); default FIREBIRD_SLO_BUDGET, else the "
                        "built-in spec; '0' disables")
    o.add_argument("--fast", type=float, default=None,
                   help="fast burn window seconds (default "
                        "FIREBIRD_SLO_FAST_SEC)")
    o.add_argument("--slow", type=float, default=None,
                   help="slow burn window seconds (default "
                        "FIREBIRD_SLO_SLOW_SEC)")
    o.add_argument("--burn", type=float, default=None,
                   help="paging burn-rate threshold (default "
                        "FIREBIRD_SLO_BURN)")
    o.add_argument("--record", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="append budget state transitions to the durable "
                        "event log (slo_events.jsonl); --no-record is a "
                        "pure read")


READ = dict(products=products_cmd, tiles=tiles, validate=validate_cmd,
            status=status, top=top, slo=slo)


def _fleet_parsers(sub) -> None:
    """The ``fleet`` and ``trace`` command groups (the JAX command line's
    options)."""
    fl = sub.add_parser("fleet", help="crash-tolerant work queue: enqueue "
                        "a plan, drain it with workers, supervise them")
    fsub = fl.add_subparsers(dest="fleet_cmd", required=True)
    e = fsub.add_parser("enqueue", help="enqueue a dependency-ordered "
                        "multi-tile plan on the shared queue")
    e.add_argument("-t", "--tile", dest="tiles", action="append",
                   required=True,
                   help="x,y projection point inside a tile; repeat for a "
                        "multi-tile plan")
    e.add_argument("-a", "--acquired", default=None)
    e.add_argument("-n", "--number", type=int, default=2500,
                   help="chips per tile")
    e.add_argument("-c", "--chunk-size", type=int, default=500,
                   help="chips per detect job — the re-delivery "
                        "granularity: a dead worker forfeits at most one "
                        "chunk")
    e.add_argument("-s", "--msday", type=int, default=None,
                   help="with --meday: also enqueue a classify job per "
                        "tile, blocked on that tile's detection")
    e.add_argument("-e", "--meday", type=int, default=None)
    e.add_argument("-p", "--products", action="append", default=[],
                   help="with --product-dates: enqueue product jobs per "
                        "tile, blocked on the latest upstream stage")
    e.add_argument("-d", "--product-dates", action="append", default=[])
    e.add_argument("--max-attempts", type=int, default=None,
                   help="per-job attempt budget before dead-lettering; "
                        "overrides FIREBIRD_FLEET_MAX_ATTEMPTS")
    w = fsub.add_parser("work", help="run one fleet worker on this "
                        "process's card against the shared queue")
    w.add_argument("--max-jobs", type=int, default=None,
                   help="exit after this many executed jobs")
    w.add_argument("--until-drained", action="store_true",
                   help="poll until every job is done or dead (default: "
                        "exit when nothing is claimable)")
    w.add_argument("--forever", action="store_true",
                   help="standing worker: keep polling through an empty "
                        "queue until signalled")
    w.add_argument("--hold-idle", action="store_true",
                   help="batch worker that polls through an empty queue "
                        "instead of exiting (how `fleet supervise` holds a "
                        "min-workers floor; retired by SIGTERM)")
    w.add_argument("--drain-on-term", action="store_true",
                   help="graceful drain: SIGTERM finishes the current lease "
                        "then exits cleanly")
    w.add_argument("--poll", type=float, default=1.0,
                   help="idle claim-poll interval, seconds")
    w.add_argument("--ops-port", type=int, default=None,
                   help="live ops endpoints for this worker; overrides "
                        "FIREBIRD_OPS_PORT")
    v = fsub.add_parser("supervise", help="autoscale a local worker fleet "
                        "from queue pressure")
    v.add_argument("--min", dest="min_workers", type=int, default=None,
                   help="worker floor (0 = scale-to-zero); overrides "
                        "FIREBIRD_FLEET_MIN_WORKERS")
    v.add_argument("--max", dest="max_workers", type=int, default=None,
                   help="worker ceiling; overrides FIREBIRD_FLEET_MAX_WORKERS")
    v.add_argument("--until-drained", action="store_true",
                   help="exit once every batch job is done or dead AND the "
                        "fleet has scaled back to zero")
    v.add_argument("--tick", type=float, default=1.0,
                   help="control-loop interval, seconds")
    v.add_argument("--grace", type=float, default=None,
                   help="retiring worker SIGTERM->SIGKILL deadline, seconds; "
                        "overrides FIREBIRD_FLEET_GRACE_SEC")
    v.add_argument("--log-dir", default=None,
                   help="directory for spawned workers' stdout logs "
                        "(default: worker_logs/ next to the queue db)")
    v.add_argument("--ops-port", type=int, default=None,
                   help="live ops endpoints for the supervisor; overrides "
                        "FIREBIRD_OPS_PORT")
    fsub.add_parser("status", help="inspect the shared queue")
    r = fsub.add_parser("requeue", help="return dead-lettered jobs to the "
                        "queue with a fresh attempt budget")
    r.add_argument("job_id", nargs="?", type=int, default=None)
    r.add_argument("--dead", action="store_true",
                   help="requeue every dead-lettered job")
    tr = sub.add_parser("trace", help="the fleet telemetry plane's read "
                        "side")
    tsub = tr.add_subparsers(dest="trace_cmd", required=True)
    c = tsub.add_parser("collect", help="merge every process's telemetry "
                        "spool into one artifact")
    c.add_argument("-d", "--dir", dest="directory", default=None,
                   help="spool directory (default: FIREBIRD_TELEMETRY_DIR, "
                        "else telemetry/ next to the store)")
    c.add_argument("-o", "--out", default=None,
                   help="artifact path (default: telemetry_collect.json in "
                        "the spool directory)")


FLEET = dict(enqueue=fleet_enqueue, work=fleet_work,
             supervise=fleet_supervise, status=fleet_status,
             requeue=fleet_requeue)


# The options whose value is an x,y projection point: a point west of the
# grid's origin starts with '-', which argparse would take for an option.
_POINT_OPTIONS = ("-b", "--bounds", "-t", "--tile")


def schema_cmd(args) -> None:
    """``schema``: the Cassandra DDL of the result tables as CQL, one
    statement a line with its ``;`` (the JAX command's output; pipe it to
    cqlsh).  Host only: it loads neither torch nor the detector."""
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.store.backends import cassandra_ddl

    keyspace = args.keyspace
    if keyspace is None:
        keyspace = Config.from_env().keyspace()
    for stmt in cassandra_ddl(keyspace, args.replication):
        print(stmt + ";")


def lint(argv: list) -> int:
    """``lint``: the port's firebird-lint over ``firebird_tpu_torch/``
    (``analysis.main``; every option passes through, as the JAX command's
    do).  Host only: it loads neither torch nor the detector."""
    from firebird_tpu_torch.analysis import main as lint_main

    return lint_main(argv)


def _attach_points(argv: list) -> list:
    """``argv`` with each point option's value attached (``-b=-543585,...``)
    so a negative x parses as the JAX command line's does."""
    out = []
    for tok in argv:
        if out and out[-1] in _POINT_OPTIONS and tok.startswith("-") \
                and "," in tok:
            out[-1] = f"{out[-1]}={tok}"
        else:
            out.append(tok)
    return out


def main(argv=None) -> None:
    import sys

    ap = argparse.ArgumentParser(prog="python -m firebird_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("changedetection",
                       help="change detection for a tile into the store")
    c.add_argument("-x", "--x", type=float, required=True)
    c.add_argument("-y", "--y", type=float, required=True)
    c.add_argument("-a", "--acquired", default=None,
                   help="ISO8601 range start/end (default: the JAX "
                        "package's default acquired range)")
    c.add_argument("-n", "--number", type=int, default=2500)
    c.add_argument("-c", "--chunk_size", type=int, default=2500)
    c.add_argument("-r", "--resume", action="store_true",
                   help="skip chips whose segments are already stored")
    c.add_argument("--device", default=None,
                   help="torch device (default cuda, this process's card "
                        "under torchrun; 'cpu' runs the plain PyTorch "
                        "versions)")
    _ops_options(c)
    s = sub.add_parser("stream", help="streaming change detection for a "
                       "tile: bootstrap, then new acquisitions only")
    s.add_argument("-x", "--x", type=float, required=True)
    s.add_argument("-y", "--y", type=float, required=True)
    s.add_argument("-a", "--acquired", default=None,
                   help="ISO8601 range start/end (default: the JAX "
                        "package's default acquired range)")
    s.add_argument("-n", "--number", type=int, default=2500)
    s.add_argument("--device", default=None,
                   help="torch device (default cuda, this process's card "
                        "under torchrun; 'cpu' runs the plain PyTorch "
                        "versions)")
    _ops_options(s)
    k = sub.add_parser("classification", help="train the tile's random "
                       "forest and classify its stored segments")
    k.add_argument("-x", "--x", type=float, required=True)
    k.add_argument("-y", "--y", type=float, required=True)
    k.add_argument("-s", "--msday", type=int, required=True,
                   help="training window start (proleptic ordinal)")
    k.add_argument("-e", "--meday", type=int, required=True,
                   help="training window end (proleptic ordinal)")
    k.add_argument("-a", "--acquired", default=None,
                   help="ISO8601 range start/end (default: the JAX "
                        "package's default acquired range)")
    k.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the forest "
                        "on the CPU)")
    v = sub.add_parser("save", help="compute and save product rasters")
    v.add_argument("-b", "--bounds", action="append", required=True,
                   help="x,y projection point; repeat to extend the area")
    v.add_argument("-p", "--products", action="append", required=True,
                   help="product name; repeat for several")
    v.add_argument("-d", "--product_dates", action="append", required=True,
                   help="ISO query date; repeat for several")
    v.add_argument("-a", "--acquired", default=None,
                   help="ISO8601 range; chips lacking stored segments are "
                        "detected over it first")
    v.add_argument("--clip", action="store_true",
                   help="mask pixels outside the bounds polygon")
    v.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs detection "
                        "on the CPU)")
    d = sub.add_parser("detect", help="change detection on synthetic chips")
    d.add_argument("--chips", type=int, default=1)
    d.add_argument("--start", default="1985-01-01")
    d.add_argument("--end", default="2017-12-31")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--sensor", default="landsat-ard", type=_sensor,
                   help="sensor layout (ccd.sensor.SENSORS: landsat-ard, "
                        "landsat-ard-tiny, sentinel2)")
    d.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions)")
    d.add_argument("--fused", default=None, choices=("0", "1", "mon"),
                   help="round route: 0 separate monitor/close/refit, 1 "
                        "fused close+refit, mon the whole round fused "
                        "(default: FIREBIRD_FUSED_FIT, unset = 0)")
    d.add_argument("--pallas", default=None,
                   help="kernels: 1 (fit,score,init), a component list "
                        "(lasso,monitor,tmask), or mega, the whole loop in "
                        "one launch (default: FIREBIRD_PALLAS, unset = 1)")
    d.add_argument("--compact", default=None, choices=("0", "1"),
                   help="active-lane compaction (default: FIREBIRD_COMPACT, "
                        "unset = 1)")
    d.add_argument("--mixed", default=None, choices=("0", "1"),
                   help="the fitting kernels' mixed-precision Gram (default: "
                        "FIREBIRD_MIXED_PRECISION, unset = 0)")
    d.add_argument("--shards", type=int, default=0,
                   help="shard the chips over N shards, round-robin over the "
                        "visible cards (FIREBIRD_REBALANCE=1 turns on the "
                        "rebalancing ring)")
    sc = sub.add_parser("schema", help="print the Cassandra DDL for the "
                        "result tables as CQL")
    sc.add_argument("-k", "--keyspace", default=None,
                    help="keyspace name; defaults to Config.keyspace() "
                         "(derived from input URLs + version)")
    sc.add_argument("-r", "--replication", type=int, default=1)
    sub.add_parser("lint", add_help=False,
                   help="the static contract checker over "
                        "firebird_tpu_torch/ (options: lint --help)")
    _fleet_parsers(sub)
    _read_parsers(sub)
    _ingest_parsers(sub)
    _serve_parsers(sub)
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["lint"]:
        # Every option passes through to the linter's own parser.
        raise SystemExit(lint(argv[1:]))
    args = ap.parse_args(_attach_points(argv))
    if args.cmd == "fleet":
        run = FLEET[args.fleet_cmd]
    elif args.cmd == "trace":
        run = trace_collect
    elif args.cmd in READ:
        run = READ[args.cmd]
    elif args.cmd == "objectstore":
        run = OBJECTSTORE[args.objectstore_cmd]
    elif args.cmd in INGEST:
        run = INGEST[args.cmd]
    elif args.cmd == "pyramid":
        run = pyramid_build
    elif args.cmd in SERVE:
        run = SERVE[args.cmd]
    elif args.cmd == "schema":
        run = schema_cmd
    else:
        run = dict(changedetection=changedetection, stream=stream,
                   classification=classification, save=save,
                   detect=detect)[args.cmd]
    try:
        out = run(args)
    except _UsageError as e:
        ap.error(f"{args.cmd}: {e}")
    if out is not None:
        print(json.dumps(out))


if __name__ == "__main__":
    main()

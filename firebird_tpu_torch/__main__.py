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

``changedetection`` is the JAX package's command of that name: the tile
at the point (x, y), its first ``NUMBER`` chips in chunks of
``CHUNK_SIZE``, through driver.core.changedetection into the store that
FIREBIRD_STORE_BACKEND / FIREBIRD_STORE_PATH name (sqlite rows land in
``<dir of the path>/<stem>.<keyspace>.db``), with the config of
``Config.from_env``.  It prints one JSON summary: chips done, pixels,
segments, pixels a second, the stage seconds, the run id, this process's
index and the process count, and the artifacts the run wrote (``trace``,
``report`` or ``report_shard``).

``--trace``, ``--ops-port``, ``--profile`` and ``--slo`` override
FIREBIRD_TRACE, FIREBIRD_OPS_PORT, FIREBIRD_PROFILE and FIREBIRD_SLO for
``changedetection`` and ``stream``, with the JAX command line's meaning.
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
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from firebird_tpu_torch.ccd import format as fmt
from firebird_tpu_torch.ccd import kernel, params
from firebird_tpu_torch.ccd.sensor import SENSORS
from firebird_tpu_torch.ingest import SyntheticSource, pack
from firebird_tpu_torch.obs import Counters
from firebird_tpu_torch.parallel import detect_sharded


def _run_config(args):
    """``Config.from_env`` with the command line's ops overrides (None:
    no override), after bringing up one process per card."""
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.parallel import init_distributed

    init_distributed()
    overrides = {k: v for k, v in
                 (("trace", args.trace), ("ops_port", args.ops_port),
                  ("profile", args.profile), ("slo", args.slo))
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


def classification(args) -> dict:
    from firebird_tpu_torch.driver import core
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


def main(argv=None) -> None:
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
    d.add_argument("--sensor", default="landsat-ard", choices=sorted(SENSORS))
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
    args = ap.parse_args(argv)
    run = dict(changedetection=changedetection, stream=stream,
               classification=classification, save=save,
               detect=detect)[args.cmd]
    print(json.dumps(run(args)))


if __name__ == "__main__":
    main()

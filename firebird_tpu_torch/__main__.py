"""Command line of the PyTorch port.

    python -m firebird_tpu_torch detect --chips N --start 1985-01-01 \\
        --end 2017-12-31 [--seed S] [--sensor landsat-ard] [--device cuda] \\
        [--fused {0,1,mon}] [--pallas ROUTE] [--compact {0,1}] [--mixed {0,1}] \\
        [--shards N]

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
from firebird_tpu_torch.parallel import detect_sharded


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
    print(json.dumps(detect(args)))


if __name__ == "__main__":
    main()

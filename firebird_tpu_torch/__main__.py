"""Command line of the PyTorch port.

    python -m firebird_tpu_torch detect --chips N --start 1985-01-01 \\
        --end 2017-12-31 [--seed S] [--sensor landsat-ard] [--device cuda] \\
        [--fused {0,1,mon}]

``detect`` runs SyntheticSource -> pack -> detect_packed -> batch_frames
on the device (CUDA unless ``--device cpu``) and prints one JSON summary:
chips, pixels, segments, rounds and seconds.  ``--fused`` picks the round
route (kernel.fused_mode); without it FIREBIRD_FUSED_FIT decides.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from firebird_tpu_torch.ccd import format as fmt
from firebird_tpu_torch.ccd import kernel
from firebird_tpu_torch.ccd.sensor import SENSORS
from firebird_tpu_torch.ingest import SyntheticSource, pack


def detect(args) -> dict:
    dev = kernel.resolve_device(args.device)
    src = SyntheticSource(args.seed, start=args.start, end=args.end,
                          sensor=SENSORS[args.sensor])
    t0 = time.perf_counter()
    packed = pack([src.chip(3000 * c, 0) for c in range(args.chips)])
    t_pack = time.perf_counter()
    fused = None if args.fused is None else {"0": 0, "1": 1,
                                             "mon": "mon"}[args.fused]
    seg = kernel.detect_packed(packed, device=dev, fused=fused)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_det = time.perf_counter()
    frames = fmt.batch_frames(packed, seg)
    t_end = time.perf_counter()
    return dict(
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"),
        route=kernel.fused_mode(fused),
        chips=args.chips, pixels=int(seg.n_segments.numel()),
        T=int(packed.spectra.shape[-1]),
        segments=int(seg.n_segments.sum()), rounds=int(seg.rounds[0]),
        segment_rows=sum(len(f["segment"]["sday"]) for _, f in frames),
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
    args = ap.parse_args(argv)
    print(json.dumps(detect(args)))


if __name__ == "__main__":
    main()

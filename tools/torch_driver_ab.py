"""The batch driver of two checkouts of the PyTorch port on one card, in
turns.

    python tools/torch_driver_ab.py --base DIR [--change DIR] [--order abba]
        [--chips 24] [--seed 0] [--runs 2] [--out chiprun_out/driver_ab.json]

Makes the first ``--chips`` chips of the tile at (542000, 1650000) once
(``SyntheticSource(--seed)``, 1985-2017, the chips of ``chip_smoke.py``'s
``driver_phase``) into ``.npz`` files in a temporary directory, then runs
each checkout (``--base``, and ``--change``, default this tree) in a worker
process of its own, in the order ``--order`` gives (``a`` the base, ``b``
the change).  A worker uses only its checkout's ``firebird_tpu_torch``: it
loads the chips into memory, builds the kernels, and runs
``driver.core.changedetection`` over them ``--runs`` times on the card,
each into a fresh sqlite store (batches of 8, depth 3, ``max_obs=0``, the
default config otherwise: the flight recorder armed where the checkout
has one, no ops port, no trace), keeping each run's pixels a second (over
the wall from the first fetch to the writer's close) and stage seconds.

Writes every worker's numbers, with the card's name and power limit, to
``--out`` and prints one line a worker.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
POINT = (542000, 1650000)
ACQUIRED = "1985-01-01/2017-12-31"


def make_chips(seed: int, n: int, directory: Path) -> list:
    """The tile's first ``n`` chips as ``chip_<cx>_<cy>.npz``; their ids."""
    sys.path.insert(0, str(REPO))
    import numpy as np

    from firebird_tpu_torch import grid
    from firebird_tpu_torch.ingest import SyntheticSource

    directory.mkdir(parents=True, exist_ok=True)
    src = SyntheticSource(seed, start="1985-01-01", end="2017-12-31")
    cids = [tuple(int(v) for v in c)
            for c in grid.chips(grid.tile(*POINT))[:n]]
    for cx, cy in cids:
        ch = src.chip(cx, cy, ACQUIRED)
        np.savez(directory / f"chip_{cx}_{cy}.npz", dates=ch.dates,
                 spectra=ch.spectra, qas=ch.qas)
    return cids


def worker(chip_dir: Path, n: int, runs: int) -> dict:
    """This checkout's driver over the chips in ``chip_dir``."""
    import numpy as np
    import torch

    from firebird_tpu_torch.ccd import cuda_ops
    from firebird_tpu_torch.config import Config
    from firebird_tpu_torch.driver import core
    from firebird_tpu_torch.ingest.packer import ChipData
    from firebird_tpu_torch.obs import Counters

    chips = {}
    for p in sorted(chip_dir.glob("chip_*.npz")):
        cx, cy = (int(v) for v in p.stem.split("_")[1:])
        z = np.load(p)
        chips[(cx, cy)] = ChipData(cx=cx, cy=cy, dates=z["dates"],
                                   spectra=z["spectra"], qas=z["qas"])

    class MemorySource:
        def chip(self, cx, cy, acquired=None):
            return chips[(int(cx), int(cy))]

    t0 = time.perf_counter()
    cuda_ops.build()
    build_s = time.perf_counter() - t0
    out = []
    for _ in range(runs):
        with tempfile.TemporaryDirectory() as tmp:
            cfg = Config(chips_per_batch=8, pipeline_depth=3,
                         store_backend="sqlite", max_obs=0, fetch_retries=0,
                         store_path=str(Path(tmp) / "fb.db"))
            counters = Counters()
            cuda_ops.reset_launches()
            done = core.changedetection(
                *POINT, acquired=ACQUIRED, number=n, chunk_size=n, cfg=cfg,
                source=MemorySource(), device=torch.device("cuda"),
                counters=counters)
            snap = counters.snapshot()
            out.append(dict(chips=len(done), pixels=snap.get("pixels", 0),
                            wall=snap["elapsed_sec"],
                            pixels_per_s=snap.get("pixels_per_sec", 0.0),
                            stage_seconds=core.stage_seconds(),
                            launches={k: v for k, v in
                                      cuda_ops.LAUNCHES.items() if v}))
    return dict(build_seconds=build_s, runs=out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--change", type=Path, default=REPO)
    ap.add_argument("--order", default="abba")
    ap.add_argument("--chips", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=REPO / "chiprun_out" / "driver_ab.json")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--chip-dir", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        res = worker(args.chip_dir, args.chips, args.runs)
        args.worker.write_text(json.dumps(res))
        return
    if args.base is None:
        ap.error("--base is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    chip_dir = Path(tempfile.mkdtemp(prefix="driver_ab_chips_"))
    t0 = time.perf_counter()
    make_chips(args.seed, args.chips, chip_dir)
    print(f"{args.chips} chips made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dirs = {"a": args.base.resolve(), "b": args.change.resolve()}
    runs = []
    try:
        for k, label in enumerate(args.order):
            d = dirs[label]
            tmp = args.out.with_suffix(f".{k}.json").resolve()
            env = dict(os.environ, PYTHONPATH=str(d))
            t0 = time.perf_counter()
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--worker", str(tmp), "--chip-dir", str(chip_dir),
                            "--chips", str(args.chips), "--runs",
                            str(args.runs)], cwd=d, env=env, check=True)
            res = json.loads(tmp.read_text())
            tmp.unlink()
            res.update(label=label, checkout=str(d),
                       worker_seconds=time.perf_counter() - t0)
            runs.append(res)
            print(json.dumps(dict(label=label, pixels_per_s=[
                r["pixels_per_s"] for r in res["runs"]])), flush=True)
    finally:
        for p in chip_dir.glob("*.npz"):
            p.unlink()
        chip_dir.rmdir()
    args.out.write_text(json.dumps(dict(device=smi, order=args.order,
                                        runs=runs), indent=1))
    for label in "ab":
        px = [r["pixels_per_s"] for w in runs if w["label"] == label
              for r in w["runs"]]
        print(f"{label}: px/s {px}", flush=True)
    print(smi)


if __name__ == "__main__":
    main()

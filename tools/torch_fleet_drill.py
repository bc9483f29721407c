"""The fleet's zombie drill of ``chip_smoke.py`` with the freeze pushed
late, on one card.

    python tools/torch_fleet_drill.py [--cases 1:1.0,15:1.0,...] [--seed 0]
        [--out chiprun_out/fleet_drill.json]

Makes the driver tile's chips and runs ``chip_smoke.driver_phase`` once
(the reference rows), then ``chip_smoke.fleet_phase`` once a case.  A case
``W:D`` sets the workers' auto profile window (FIREBIRD_PROFILE) to ``W``
seconds and hides every ``job_claimed`` mark from the drill until ``D``
seconds after it was written (``D`` = ``-``: no delay, the drill as
``chip_smoke.py`` runs it), so that the freeze lands after the frozen
worker's first dispatch has opened its window.  A case passes when every
check of ``fleet_phase`` passes; check (e) wants route 0's three kernels
in each worker's window.

Writes each case's result (the drill's stop and continue times, each
worker's window span and the route 0 kernels in it, the phase's split and
seconds, or the failed check) with the card's name and power limit to
``--out``, and prints one line a case.  Exits 1 if a case without a delay
failed.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
KEEP = ("drill", "workers", "profile_span_seconds", "profile_span_wall",
        "window_kernels", "split", "job_seconds", "seconds")


def parse_cases(text: str) -> list:
    cases = []
    for item in text.split(","):
        w, d = item.split(":")
        cases.append((float(w), None if d == "-" else float(d)))
    return cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="1:1.0,15:1.0,15:0.5,15:1.5,15:-")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/fleet_drill.json")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    import chip_smoke as cs
    from firebird_tpu_torch.ccd import cuda_ops

    if not torch.cuda.is_available():
        sys.exit("torch_fleet_drill: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda_ops.build()
    chips, gen_s = cs.tile_chips(args.seed, cs.DRIVER_CHIPS)
    spool_marks = cs._spool_marks
    rows, failed_plain = [], False
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, cfg = cs.driver_phase(smi, chips, gen_s, dev, tmp)
        print(f"driver phase {time.perf_counter() - t0:.1f} s", flush=True)
        for window, delay in parse_cases(args.cases):
            def marks(directory, delay=delay):
                got = spool_marks(directory)
                if delay is None:
                    return got
                now = time.time()
                return [m for m in got if m["name"] != "job_claimed"
                        or m["t"] + delay <= now]

            cs._spool_marks = marks
            cs.FLEET_PROFILE_S = window
            row = dict(window_s=window, delay_s=delay)
            t0 = time.perf_counter()
            try:
                rep = cs.fleet_phase(smi, chips, cfg,
                                     tempfile.mkdtemp(dir=tmp), args.seed)
                row.update(ok=True, **{k: rep[k] for k in KEEP})
            except AssertionError as e:
                row.update(ok=False, error=str(e)[-2000:])
                failed_plain |= delay is None
            row["wall_s"] = time.perf_counter() - t0
            print(json.dumps(row, default=str)[:3000], flush=True)
            rows.append(row)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=smi, cases=rows), indent=1,
                              default=str))
    return 1 if failed_plain else 0


if __name__ == "__main__":
    sys.exit(main())

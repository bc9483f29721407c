"""Where the time of one ``ring_remote_copy`` hop goes, on the card.

    python tools/ring_copy_bench.py [--seed 0] [--reps 50]
        [--out chiprun_out/ring_copy_bench.json]

On chip_smoke.py's ring hop (two shards of four 100x100 chips at the
2048-lane bucket, 23 tensors a shard, 382.4 MB a hop), the median of
``--reps`` CUDA-event-timed runs of:

- ``public``: the wrapper ``cuda_ops.ring_remote_copy(payloads, 1)``, as
  chip_smoke.py times it (allocation, plan lookup, launches and the
  receive views included);
- ``kernel``: the two kernel launches alone, on buffers and tables made
  beforehand (the device's share);
- ``foreach_copy``: one ``torch._foreach_copy_`` over the same tensors
  into buffers allocated beforehand (chip_smoke.py's library yardstick);
- ``memcpy``: two device-to-device ``copy_`` calls of one flat buffer a
  shard (the card's own copy engine path, the same bytes);

and the host's microseconds a ``public`` call spends before it returns.
Each with its rate (bytes read and written over the time).  Prints the
card's name and power limit and writes the numbers to ``--out``.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from firebird_tpu_torch.ccd import cuda_ops  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out")
                    / "ring_copy_bench.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ring_copy_bench: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cuda_ops.build(("ring_remote_copy",))
    row = cs.ring_row(args.seed, 768, dev, {})
    payloads, moved, library = row[1][0], row[6], row[7]["library"]
    plans = [cuda_ops.ring_plan(p) for p in payloads]
    bufs = [torch.empty(pl.total, dtype=torch.uint8, device=dev)
            for pl in plans]
    srcs = [np.asarray([t.data_ptr() for t in p], dtype=np.int64)
            for p in payloads]
    spans = [pl.spans_on(dev) for pl in plans]

    def kernel():
        for pl, buf, src, sp in zip(plans, bufs, srcs, spans):
            cuda_ops._launch("ring_remote_copy",
                             ctypes.c_void_p(src.ctypes.data), len(src),
                             cuda_ops._ptr(sp), len(pl.spans),
                             cuda_ops._ptr(buf))

    flat = [torch.empty(pl.total, dtype=torch.uint8, device=dev)
            for pl in plans]
    flat_dst = [torch.empty_like(f) for f in flat]

    def memcpy():
        for d, s in zip(flat_dst, flat):
            d.copy_(s)

    times = {
        "public": cs.cuda_ms(lambda: cuda_ops.ring_remote_copy(payloads, 1),
                             args.reps),
        "kernel": cs.cuda_ms(kernel, args.reps),
        "foreach_copy": cs.cuda_ms(library, args.reps),
        "memcpy": cs.cuda_ms(memcpy, args.reps),
    }
    torch.cuda.synchronize()
    host = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        cuda_ops.ring_remote_copy(payloads, 1)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    res = dict(device=smi, bytes_moved=moved, spans=[len(p.spans)
                                                     for p in plans],
               host_us_per_call=float(np.median(host)) * 1e6,
               ms=times, tb_per_s={k: moved / v / 1e9
                                   for k, v in times.items()})
    print(json.dumps(res))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    print(smi)


if __name__ == "__main__":
    main()

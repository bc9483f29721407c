"""Where the PyTorch port's detector spends its time on the card.

    python tools/torch_detect_profile.py [--chips 8] [--seed 0] [--out DIR]
        [--fused {0,1,mon}] [--pallas ROUTE] [--compact {0,1}] [--shards N]
        [--sensor {landsat-ard,sentinel2}]

Runs SyntheticSource -> pack -> detect_packed (round route ``--fused``,
default 0; kernels ``--pallas``, default "1": the ``fit,score,init``
route; ``mega`` or a component list such as ``lasso,monitor,tmask``
picks another, kernel.pallas_components; compaction ``--compact``,
default 0) on ``--chips`` full-size Landsat chips (1985-2017, T=768)
once to warm up, once timed by the host clock, then once under
``torch.profiler`` (CPU and CUDA activities).  ``--shards N`` runs
parallel.detect_sharded instead, over N shards on cuda:0 with the
rebalancing ring on, on chip_smoke.py's sharded batch (the last 1/N of
the chips a tenth land); its time includes the host-to-device staging.
``--sensor sentinel2`` runs chip_smoke.py's Sentinel-2 chip instead (one
300x300 chip of 12 bands, 2019-2020, T=64; ``--chips`` and ``--seed`` are
its own).  Prints and writes the wall times of the plain and the profiled
run, the summed device time of every kernel by name (the hand-written
kernels and PyTorch's own), and the device's busy share of the profiled
wall time, to ``DIR/torch_detect_profile[_ROUTE].json`` (suffixed for
routes and sensors other than the default).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from firebird_tpu_torch.ccd import cuda_ops, kernel  # noqa: E402
from firebird_tpu_torch.ingest import SyntheticSource, pack  # noqa: E402
from firebird_tpu_torch.parallel import detect_sharded  # noqa: E402


GROUPS = (                      # (group, substrings of the kernel name)
    ("monitor_chain_scored", ("monitor_kernel",)),
    ("lasso_fit", ("lasso_fit_kernel",)),
    ("init_window", ("init_kernel",)),
    ("fused_fit_close", ("fused_fit_close_kernel",)),
    ("fused_round", ("fused_round_kernel",)),
    ("lasso_cd", ("lasso_cd_kernel",)),
    ("monitor_chain", ("monitor_plane_kernel",)),
    ("tmask_bad", ("tmask_kernel",)),
    ("detect_mega", ("mega_kernel",)),
    ("ring_remote_copy", ("ring_copy_kernel",)),
    ("sorts", ("Sort",)),
    ("reductions", ("reduce_kernel",)),
    ("gathers and scatters", ("scatter_gather", "index")),
    ("scans", ("scan",)),
    ("memcpy/memset", ("Memcpy", "Memset")),
)


def group(rows) -> dict:
    """Device milliseconds of the profile's rows summed by kind; what no
    group names is PyTorch's elementwise glue."""
    out = {g: 0.0 for g, _ in GROUPS}
    out["elementwise"] = 0.0
    for r in rows:
        g = next((g for g, keys in GROUPS
                  if any(k in r["name"] for k in keys)), "elementwise")
        out[g] += r["device_ms"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--fused", default="0", choices=("0", "1", "mon"))
    ap.add_argument("--pallas", default="1")
    ap.add_argument("--compact", default="0", choices=("0", "1"))
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--sensor", default="landsat-ard",
                    choices=("landsat-ard", "sentinel2"))
    args = ap.parse_args(argv)
    fused = {"0": 0, "1": 1, "mon": "mon"}[args.fused]
    ops = kernel.pallas_components(args.pallas)
    route = ("mega" if ops.mega
             else "+".join(ops.components) + f"/fused={args.fused}")
    route += f"/compact={args.compact}" + (f"/shards={args.shards}"
                                           if args.shards else "")
    kw = dict(fused=fused, ops=ops, compact=args.compact == "1")
    if not torch.cuda.is_available():
        sys.exit("torch_detect_profile: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    if args.sensor == "sentinel2":
        from chip_smoke import S2_SOURCE

        packed = pack([SyntheticSource(**S2_SOURCE).chip(100, 200)],
                      bucket=64)
        route += "/sentinel2"
    else:
        src = SyntheticSource(args.seed, start="1985-01-01",
                              end="2017-12-31")
        packed = pack([src.chip(1000 * c, 2000) for c in range(args.chips)],
                      bucket=64)
    staged = kernel.stage_packed(packed)
    if args.shards:
        from chip_smoke import SHARDS, ragged_batch

        assert args.shards == SHARDS, f"the sharded batch is cut for {SHARDS}"
        ragged = ragged_batch(packed)
        run = lambda: detect_sharded(ragged, ["cuda:0"] * args.shards,
                                     rebalance=True, **kw)
    else:
        run = lambda: kernel.detect_packed(packed, staged=staged, **kw)
    cuda_ops.build()
    run()                                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda_ops.reset_launches()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        seg = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Only the device-side entries (kernels, memcpy, memset): an operator's
    # host-side entry carries its kernels' time again.
    rows = [dict(name=ev.key, calls=ev.count,
                 device_ms=ev.self_device_time_total / 1e3)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows) / 1e3
    out = dict(device=smi, route=route, chips=packed.n_chips,
               pixels=int(seg.n_segments.numel()),
               T=int(packed.spectra.shape[-1]), rounds=seg.rounds.tolist(),
               round_counts=seg.round_counts.tolist(),
               compactions=(None if seg.compactions is None
                            else int(seg.compactions.sum())),
               lanes_migrated=(None if seg.lanes_migrated is None
                               else seg.lanes_migrated.tolist()),
               launches=dict(cuda_ops.LAUNCHES), wall_s=wall,
               wall_unprofiled_s=wall_plain,
               pixels_per_s=seg.n_segments.numel() / wall_plain,
               device_busy_s=busy, device_busy_share=busy / wall,
               groups=group(rows), kernels=rows)
    print(f"{smi}: route {route}, {packed.n_chips} chips, wall {wall:.3f} s "
          f"profiled "
          f"({wall_plain:.3f} s not: {out['pixels_per_s']:.0f} px/s), "
          f"device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}% of the profiled wall)")
    for r in rows[:20]:
        print(f"  {r['device_ms']:10.3f} ms  {r['calls']:6d}  {r['name'][:90]}")
    Path(args.out).mkdir(parents=True, exist_ok=True)
    suffix = "".join(f"_{v}" for v, default in ((args.fused, "0"),
                                                  (args.pallas, "1"))
                     if v != default).replace(",", "-")
    suffix += ("_compact" if args.compact == "1" else "") + (
        f"_shards{args.shards}" if args.shards else "") + (
        "_sentinel2" if args.sensor == "sentinel2" else "")
    (Path(args.out) / f"torch_detect_profile{suffix}.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

"""Two checkouts of the PyTorch port on one card, in turns.

    python tools/torch_ab.py --base DIR [--change DIR] [--order abba]
        [--chips 8] [--seed 0] [--reps 20] [--runs 2] [--mixed]
        [--out chiprun_out/torch_ab.json]

Runs each checkout (``--base``, and ``--change``, default this tree) in a
worker process of its own, in the order ``--order`` gives (``a`` the base,
``b`` the change; default ``abba``), so that both are measured on the same
card in one call.  A worker uses only its checkout's own code: its
``chip_smoke.py`` makes the batch (``--chips`` full-size Landsat chips,
1985-2017, T=768) and the kernel phase's round states, and its
``firebird_tpu_torch`` runs:

- ``fused_round`` on chip_smoke.py's full-width round (its events and INIT
  handoff from the plain monitor and ``init_window``), ``fused_fit_close``
  on the same round (chip_smoke.py's ``fused_rows``), and ``lasso_fit``
  and ``monitor_chain_scored`` on the kernel phase's inputs: the median of
  ``--reps`` CUDA-event-timed launches each; ``detect_mega`` on the
  batch's prologue state (chip_smoke.py's ``mega_row``), the median of 5;
- ``init_window`` on the kernel phase's inputs and on a late round's (the
  same inputs with ``in_init`` thinned by the seed to about 2 % of the
  pixels), ``tmask_bad`` on the kernel phase's gathered windows;
- the registers, stack and spills (``-Xptxas -v``) of ``fused_round``,
  ``fused_fit_close``, ``detect_mega``, ``init_window`` and ``tmask_bad``,
  and the shared memory and blocks an SM that the CUDA runtime reports
  where the checkout's ``kernel_geometry`` gives them;
- ``ring_remote_copy`` on chip_smoke.py's ring hop (two shards of four
  chips at the 2048-lane bucket), and one ``torch._foreach_copy_`` over
  the same tensors;
- the wall of every route's main path (routes 0, 1, "mon", mega, the
  component route, "0+compact" and, where the checkout has them, the
  "+mixed" routes: ``detect_packed`` ``--runs`` times, every run's wall
  kept, and a SHA-1 digest of the result fields, compared across the
  workers at the end for the routes they share), and of the sharded path
  (``detect_sharded``, two shards on the card, the ring on) with its peak
  device memory;
- on chip_smoke.py's Sentinel-2 chip (one 300x300 chip of 12 bands,
  2019-2020, T=64): ``init_window`` and ``tmask_bad`` on its kernel
  phase's states as above, and the walls of routes 0, 1, "mon", mega and
  the component route.

``--mixed`` times the fitting kernels' mixed-precision instances
(``lasso_fit``, ``init_window``, ``fused_fit_close``, ``fused_round``,
``detect_mega``) and every route with ``mixed=True`` instead (both
checkouts must have them).

Writes every worker's numbers, with the card's name and power limit, to
``--out`` and prints one line a worker.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
RESULT_FIELDS = ("n_segments", "seg_meta", "seg_rmse", "seg_mag", "seg_coef",
                 "mask", "procedure", "rounds", "round_counts", "vario")


def digest(seg) -> str:
    """SHA-1 of a ChipSegments' result fields, their bytes in order."""
    h = hashlib.sha1()
    for f in RESULT_FIELDS:
        h.update(getattr(seg, f).contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def init_times(cs, cuda_ops, inp, sensor, seed, reps, mx):
    """``init_window`` on the kernel phase's state ``inp`` and on a late
    round's (``in_init`` thinned by the seed to about 2 %), ``tmask_bad``
    on the state's gathered windows: median milliseconds (``mx`` the
    fitting kernels' precision keyword)."""
    import numpy as np
    import torch

    a = (inp["alive"], inp["cur_i"], inp["in_init"], inp["t"], inp["X"],
         inp["Xt"], inp["Yt"], inp["vario"])
    kw = dict(W=inp["W"], sensor=sensor, **mx)
    # chip_smoke.thin_init's rule, kept here: a base checkout's chip_smoke
    # may predate it.
    rng = np.random.default_rng(seed + 3)
    keep = torch.from_numpy(rng.random(tuple(inp["in_init"].shape))
                            < 0.02 / 0.6).to(inp["in_init"].device)
    late = a[:2] + (inp["in_init"] & keep,) + a[3:]
    win = cuda_ops.init_window_gather(*a[:7], W=inp["W"])
    tm = cuda_ops.tmask_args(win, inp["vario"], sensor)
    return dict(
        init_window_ms=cs.cuda_ms(lambda: cuda_ops.init_window(*a, **kw),
                                  reps),
        init_window_late_ms=cs.cuda_ms(
            lambda: cuda_ops.init_window(*late, **kw), reps),
        tmask_bad_ms=cs.cuda_ms(lambda: cuda_ops.tmask_bad(*tm), reps))


def routes(cs, mx):
    """The routes a worker times: chip_smoke.py's ROUTES, or with the
    precision keyword ``mx`` each route but the "+mixed" ones with it."""
    if not mx:
        return {name: kw for name, (kw, _) in cs.ROUTES.items()}
    return {name: dict(kw, **mx) for name, (kw, _) in cs.ROUTES.items()
            if not name.endswith("+mixed")}


def sentinel2(cs, cuda_ops, kernel, reps, runs, mx):
    """The Sentinel-2 chip's ``init_window`` and ``tmask_bad`` times and
    the walls of its routes (chip_smoke.py's S2_SOURCE and S2_ROUTES)."""
    import torch

    from firebird_tpu_torch.ingest import SyntheticSource, pack

    src = SyntheticSource(**cs.S2_SOURCE)
    packed = pack([src.chip(100, 200)], bucket=64)
    staged = kernel.stage_packed(packed, torch.device("cuda"))
    inp = cs.kernel_inputs(cs.S2_SOURCE["seed"], staged,
                           kernel.window_cap(packed), cs.SENTINEL2)
    out = init_times(cs, cuda_ops, inp, cs.SENTINEL2, cs.S2_SOURCE["seed"],
                     reps, mx)
    del inp
    torch.cuda.empty_cache()
    walls = {}
    kws = routes(cs, mx)
    for name in cs.S2_ROUTES:
        if name not in kws:
            continue
        walls[name] = []
        for _ in range(runs):
            t0 = time.perf_counter()
            kernel.detect_packed(packed, staged=staged, **kws[name])
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    out["walls_s"] = walls
    return out


def worker(seed: int, chips: int, reps: int, runs: int,
           mixed: bool = False) -> dict:
    """The measurements of the checkout on ``sys.path[0]`` (``mixed``: of
    the fitting kernels' mixed instances and the routes in mixed)."""
    import torch

    import chip_smoke as cs
    from firebird_tpu_torch.ccd import cuda_ops, kernel
    from firebird_tpu_torch.parallel import detect_sharded

    here = Path.cwd().resolve()
    for mod in (cs, cuda_ops):
        if not Path(mod.__file__).resolve().is_relative_to(here):
            raise RuntimeError(f"{mod.__name__} from {mod.__file__}, not "
                               f"from the checkout {here}")
    dev = torch.device("cuda")
    mx = dict(mixed=True) if mixed else {}
    cuda_ops.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    packed, staged, _ = cs.make_batch(seed, chips, dev)
    inp = cs.kernel_inputs(seed, staged, kernel.window_cap(packed))
    kw = dict(zip(("change_thr", "outlier_thr"), cs.chi2_thresholds(5)))
    init = cuda_ops.init_window_plain(
        inp["alive"], inp["cur_i"], inp["in_init"], inp["t"], inp["X"],
        inp["Xt"], inp["Yt"], inp["vario"], W=inp["W"], sensor=cs.LANDSAT_ARD)
    args = (inp["Yt"], inp["X"], inp["t"], inp["alive"], inp["included"],
            inp["cur_k"], inp["n_last_fit"], inp["in_mon"], inp["coefs"],
            inp["rmse"], inp["vario"], init["init_ok"], init["w_stab"],
            init["n_ok"], inp["first_seg"], inp["nseg"])
    bufs = tuple(b.clone() for b in inp["bufs"])
    out = dict(fused_round_ms=cs.cuda_ms(
        lambda: cuda_ops.fused_round(*args, bufs, **kw, **mx), reps))
    fit = (inp["Yt"], inp["w"], inp["X"], inp["coefmask"])
    out["lasso_fit_ms"] = cs.cuda_ms(lambda: cuda_ops.lasso_fit(*fit, **mx),
                                     reps)
    mon = (inp["Yd"], inp["coefs_d"], inp["dden"], inp["X"], inp["alive"],
           inp["included"], inp["cur_k"], inp["n_last_fit"], inp["in_mon"])
    out["monitor_chain_scored_ms"] = cs.cuda_ms(
        lambda: cuda_ops.monitor_chain_scored(*mon, **kw), reps)
    plain_mon = cuda_ops.monitor_chain_scored_plain(*mon, **kw)
    rows = {r[0]: r for r in cs.fused_rows(
        inp, plain_mon, init, kw, {"disagreeing_pixels": {}})}
    ffc = rows["fused_fit_close"][1]
    out["fused_fit_close_ms"] = cs.cuda_ms(
        lambda: cuda_ops.fused_fit_close(*ffc, **mx), reps)
    out.update(init_times(cs, cuda_ops, inp, cs.LANDSAT_ARD, seed, reps, mx))
    W = inp["W"]
    del inp, init, args, bufs, fit, mon, plain_mon, rows, ffc
    torch.cuda.empty_cache()
    mega = cs.mega_row(staged, W, kw, {"disagreeing_pixels": {}, "mixed": {}},
                       cs.LANDSAT_ARD, **mx)
    out["detect_mega_ms"] = cs.cuda_ms(
        lambda: cuda_ops.detect_mega(*mega[1], **mega[2]), 5)
    del mega
    out["ptxas"] = {n: cs.ptxas_summary(n)
                    for n in ("fused_round", "fused_fit_close", "detect_mega",
                              "init_window", "tmask_bad")}
    geo = cuda_ops.kernel_geometry(packed.spectra.shape[-1])
    out["geometry"] = {n: geo[n] for n in ("fused_round", "fused_fit_close",
                                           "detect_mega", "init_window",
                                           "tmask_bad") if n in geo}
    _, ring_args, *_, timing = cs.ring_row(seed, packed.spectra.shape[-1],
                                           dev, {})
    out["ring_remote_copy_ms"] = cs.cuda_ms(
        lambda: cuda_ops.ring_remote_copy(*ring_args), reps)
    out["foreach_copy_ms"] = cs.cuda_ms(timing["library"], reps)
    del ring_args, timing
    torch.cuda.empty_cache()
    walls, digests = {}, {}
    for name, kw_route in routes(cs, mx).items():
        walls[name] = []
        for _ in range(runs):
            t0 = time.perf_counter()
            seg = kernel.detect_packed(packed, staged=staged, **kw_route)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
        digests[name] = digest(seg)
        del seg
    out["digests"] = digests
    torch.cuda.empty_cache()
    ragged = cs.ragged_batch(packed)
    devices = ["cuda:0"] * cs.SHARDS
    walls["sharded"] = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(runs):
        t0 = time.perf_counter()
        detect_sharded(ragged, devices, rebalance=True, **cs.SHARDED, **mx)
        torch.cuda.synchronize()
        walls["sharded"].append(time.perf_counter() - t0)
    out["sharded_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["walls_s"] = walls
    del packed, staged, ragged
    torch.cuda.empty_cache()
    out["sentinel2"] = sentinel2(cs, cuda_ops, kernel, reps, runs, mx)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--change", type=Path, default=REPO)
    ap.add_argument("--order", default="abba")
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=REPO / "chiprun_out" / "torch_ab.json")
    ap.add_argument("--mixed", action="store_true")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        res = worker(args.seed, args.chips, args.reps, args.runs, args.mixed)
        args.worker.write_text(json.dumps(res))
        return
    if args.base is None:
        ap.error("--base is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dirs = {"a": args.base.resolve(), "b": args.change.resolve()}
    runs = []
    for k, label in enumerate(args.order):
        d = dirs[label]
        tmp = args.out.with_suffix(f".{k}.json")
        tmp.parent.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, PYTHONPATH=str(d))
        t0 = time.perf_counter()
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--worker", str(tmp.resolve()), "--seed",
                        str(args.seed), "--chips", str(args.chips), "--reps",
                        str(args.reps), "--runs", str(args.runs)]
                       + (["--mixed"] if args.mixed else []), cwd=d,
                       env=env, check=True)
        res = json.loads(tmp.read_text())
        tmp.unlink()
        res.update(label=label, checkout=str(d),
                   worker_seconds=time.perf_counter() - t0)
        runs.append(res)
        print(json.dumps(res), flush=True)
    shared = set.intersection(*(set(r["digests"]) for r in runs))
    same = {n: len({r["digests"][n] for r in runs}) == 1
            for n in sorted(shared)}
    print(f"result digests equal across the workers: {same}", flush=True)
    args.out.write_text(json.dumps(dict(device=smi, order=args.order,
                                        mixed=args.mixed, runs=runs,
                                        digests_equal=same), indent=1))
    print(smi)


if __name__ == "__main__":
    main()

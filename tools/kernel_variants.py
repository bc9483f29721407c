"""What holds the tile kernels: variants timed on one card.

    python tools/kernel_variants.py [--chips 8] [--seed 0] [--reps 20]
        [--only lasso_fit,...] [--out chiprun_out/kernel_variants.json]

Builds variants of ``csrc/lasso_fit.cu``, ``csrc/monitor_chain_scored.cu``,
``csrc/fused_fit_close.cu``, ``csrc/detect_mega.cu``, ``csrc/init_window.cu``,
``csrc/tmask_bad.cu``, ``csrc/lasso_cd.cu`` and ``csrc/monitor_chain.cu``
(``--only``: of those sources alone) by text substitution into copies of
``firebird_tpu_torch/csrc`` under ``build/kernel_variants/`` (the blocks an
SM the launch bounds ask for, which set the register cap; lasso_fit without
its coordinate-descent loop; detect_mega with its INIT body out of line;
lasso_cd dividing every soft-thresholded coordinate, zeros too;
monitor_chain without each of its steps), and ``--base DIR``: each source
as another checkout has it (``base_<source>``, built from that checkout's
csrc), and times each with CUDA events on chip_smoke.py's kernel-phase inputs (``--chips`` full-size Landsat chips,
1985-2017, T=768): lasso_fit with and without its RMSE pass, the monitor and
init_window as they are called, tmask_bad on the kernel phase's gathered
windows, fused_fit_close on the kernel phase's round (``fused_rows``),
detect_mega on the batch's prologue state (``mega_row``; the median of 5),
lasso_cd on the kernel phase's systems (``chip_smoke.cd_args``), on a late
round's (a tenth of the pixels fitting) and on the Sentinel-2 chip's
(``chip_smoke.S2_SOURCE``, 12 bands), monitor_chain on the kernel phase's
score plane (its outputs through ``cuda_ops.monitoring_only``).
``--init-shares 0.6,0.02,0`` also times the shipped init_window and each of
its variants by the profiler's device time on the kernel phase's state with
``in_init`` thinned by the seed to each share of the pixels (a late round's
INIT).  Each variant but the one without the
CD loop (and the ablations) must give the shipped kernel's outputs bit for
bit.  Prints and
writes each variant's median milliseconds, its registers and spills
(``-Xptxas -v``, the Landsat instances) and the card's name and power
limit; lasso_cd's variants list every band instance's registers, and
lasso_cd's and monitor_chain's also their device time by the profiler.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from firebird_tpu_torch.ccd import cuda_ops, kernel  # noqa: E402

OUT_DIR = REPO / "build" / "kernel_variants"
MIN_BLOCKS = re.compile(r"constexpr int MIN_BLOCKS = \d+;")
CD = "    cd_loop<1>(Gr, &cb[s], diag, mask, &beta[s]);"
NO_CD = "    for (int k = 0; k < K; ++k) beta[s][k] = cb[s][k];"
# lasso_cd with every soft-thresholded coordinate divided, zeros too.
CD_DIVIDE_ZERO = [(r"if \(bj != 0.f \|\| !positive\) bj = bj / diag\[j\];",
                   "bj = bj / diag[j];")]
MIN_WARPS = re.compile(r"constexpr int MIN_WARPS = 32;")
# Ablations of monitor_chain's steps, for the time each takes (their
# outputs differ): no event pass on warp 0, no partition planes written, no
# score read.
MON_ABLATIONS = {
    "no_event": [(r"if \(mon\)\n      e = word_event", "if (false)\n"
                  "      e = word_event")],
    "no_partition": [(r"for \(int j = j0; j < j1; \+\+j\) \{\n      const "
                      r"size_t at = col", "for (int j = j0; j < j0; ++j) {\n"
                      "      const size_t at = col")],
    "no_scores": [(r"if \(__any_sync\(~0u, r != 0\)\)",
                   "if (false && __any_sync(~0u, r != 0))")],
}
MEGA_INIT = "__device__ __forceinline__ fb::InitOut mega_init("
MEGA_INIT_OUT_OF_LINE = "__device__ __noinline__ fb::InitOut mega_init("
# Ablations of the warp Tmask screen (csrc/tmask_warp.cuh) and of
# init_window's phases, for the time each part takes (their outputs differ).
TM_ABLATIONS = {
    "no_median": [(r"warp_median2<WMAX>\(r0, r1, memb, n, A, lane, "
                   r"med0, med1\);", "med0 = med1 = 0.f;"),
                  (r"warp_mad2<WMAX>\(A, m, med0, med1, ",
                   "mad0 = mad1 = 1.f; "
                   "if (0) warp_mad2<WMAX>(A, m, med0, med1, ")],
    "no_chol": [(r"chol_solve5\(G, cc, beta\);",
                 "for (int i = 0; i < NT; ++i) beta[i] = cc[i] * 1e-3f;")],
    "no_sums": [(r"for \(uint32_t m = memb\[k\]; m; m &= m - 1u\) \{",
                 "for (uint32_t m = 0; m; m &= m - 1u) {")],
    "one_solve": [(r"for \(int it = 0; it <= TM_ITERS; \+\+it\) \{",
                   "for (int it = 0; it <= 0; ++it) {")],
}
INIT_ABLATIONS = {
    "no_screen": [(r"for \(int g = warp; g < n_tm; g \+= NWARP\) \{",
                   "for (int g = warp; g < 0; g += NWARP) {")],
    "no_fit": [(r"if \(n_fit > 0\) \{", "if (n_fit > TILE) {")],
}


# The device function names of the kernels timed by the profiler too.
DEVICE_NAMES = {"lasso_cd": "lasso_cd_kernel",
                "monitor_chain": "monitor_plane_kernel"}


def variants():
    """name -> (source, substitutions [(file, pattern, replacement)],
    whether it must equal the shipped kernel)."""
    out = {}
    for src, key in (("lasso_fit", "lf"), ("monitor_chain_scored", "mc")):
        for blocks in (3, 4, 5):
            out[f"{key}_blocks{blocks}"] = (src, [(
                f"{src}.cu", MIN_BLOCKS,
                f"constexpr int MIN_BLOCKS = {blocks};")], True)
    out["lf_blocks4_no_cd"] = ("lasso_fit", [
        ("lasso_fit.cu", MIN_BLOCKS, "constexpr int MIN_BLOCKS = 4;"),
        ("dense_fit.cuh", re.compile(re.escape(CD)), NO_CD)], False)
    for blocks in (3, 4, 5):
        out[f"ffc_blocks{blocks}"] = ("fused_fit_close", [(
            "fused_fit_close.cu", MIN_BLOCKS,
            f"constexpr int MIN_BLOCKS = {blocks};")], True)
    for src, key, choices in (("init_window", "iw", (3, 4, 5)),
                              ("tmask_bad", "tb", (4, 5, 6))):
        for blocks in choices:
            out[f"{key}_blocks{blocks}"] = (src, [(
                f"{src}.cu", MIN_BLOCKS,
                f"constexpr int MIN_BLOCKS = {blocks};")], True)
    for name, subs in TM_ABLATIONS.items():
        out[f"tb_{name}"] = ("tmask_bad", [
            ("tmask_warp.cuh", re.compile(pat), rep) for pat, rep in subs],
            False)
    for name, subs in INIT_ABLATIONS.items():
        out[f"iw_{name}"] = ("init_window", [
            ("init_window.cu", re.compile(pat), rep) for pat, rep in subs],
            False)
    # lasso_cd: resident warps an SM (the register cap).
    for warps in (16, 48):
        out[f"cd_warps{warps}"] = ("lasso_cd", [(
            "lasso_cd.cu", MIN_WARPS, f"constexpr int MIN_WARPS = {warps};")],
            True)
    out["cd_divide_zero"] = ("lasso_cd", [
        ("lasso_cd.cu", re.compile(pat), rep) for pat, rep in CD_DIVIDE_ZERO],
        True)
    for blocks in (4, 6, 8):
        out[f"mon_blocks{blocks}"] = ("monitor_chain", [(
            "monitor_chain.cu", MIN_BLOCKS,
            f"constexpr int MIN_BLOCKS = {blocks};")], True)
    for name, subs in MON_ABLATIONS.items():
        out[f"mon_{name}"] = ("monitor_chain", [
            ("monitor_chain.cu", re.compile(pat), rep) for pat, rep in subs],
            False)
    for blocks in (2, 3):
        out[f"dm_blocks{blocks}"] = ("detect_mega", [(
            "detect_mega.cu", MIN_BLOCKS,
            f"constexpr int MIN_BLOCKS = {blocks};")], True)
        out[f"dm_blocks{blocks}_noinline_init"] = ("detect_mega", [
            ("detect_mega.cu", MIN_BLOCKS,
             f"constexpr int MIN_BLOCKS = {blocks};"),
            ("detect_mega.cu", re.compile(re.escape(MEGA_INIT)),
             MEGA_INIT_OUT_OF_LINE)], True)
    return out


def build(name, spec, csrc=cuda_ops.CSRC):
    src, subs, _ = spec
    d = OUT_DIR / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    for fname, pat, rep in subs:
        f = d / fname
        text, n = pat.subn(rep, f.read_text())
        if n != 1:
            raise RuntimeError(f"{name}: {pat.pattern!r} matched {n} times "
                               f"in {fname}")
        f.write_text(text)
    so = d / f"{src}.so"
    r = subprocess.run([cuda_ops._nvcc(), *cuda_ops.NVCC_FLAGS, "-o", str(so),
                        str(d / f"{src}.cu")], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{r.stderr}")
    ptxas = {}
    for chunk in (r.stdout + r.stderr).split("Compiling entry function '")[1:]:
        fn = chunk.split("'", 1)[0]
        if "_kernel" not in fn or ("ILi12E" in fn and src != "lasso_cd"):
            continue                        # the Landsat instances only
        grab = lambda pat: int((re.search(pat, chunk) or [0, 0])[1])
        ptxas[",".join(re.findall(r"Li(\d+)E", fn)) or "-"] = dict(
            registers=grab(r"Used (\d+) registers"),
            stack_bytes=grab(r"(\d+) bytes stack frame"),
            spill_stores=grab(r"(\d+) bytes spill stores"))
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f"fb_{src}")
    fn.argtypes = cuda_ops._ARGTYPES[f"fb_{src}"]
    fn.restype = ctypes.c_int
    return lib, ptxas


def device_ms(fn, kernel_name, reps):
    """The mean device milliseconds a call of ``fn`` spends in kernels
    whose name holds ``kernel_name`` (torch.profiler), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if kernel_name in e.key) / 1e3 / reps


def sentinel2_inputs(dev):
    """The kernel phase's inputs on chip_smoke.py's Sentinel-2 chip (12
    bands, T=64)."""
    src = cs.SyntheticSource(**cs.S2_SOURCE)
    packed = cs.pack([src.chip(100, 200)], bucket=64)
    staged = kernel.stage_packed(packed, dev)
    return cs.kernel_inputs(cs.S2_SOURCE["seed"], staged,
                            kernel.window_cap(packed), cs.SENTINEL2)


def score_plane(inp):
    """monitor_chain's inputs: the score plane of ``inp``'s monitor state,
    then its planes and vectors."""
    return (cuda_ops.score_plain(inp["Yd"], inp["coefs_d"], inp["dden"],
                                 inp["X"]), inp["alive"], inp["included"],
            inp["cur_k"], inp["n_last_fit"], inp["in_mon"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="comma list of the sources whose variants to run")
    ap.add_argument("--init-shares", default="",
                    help="comma list of initializing shares for init_window")
    ap.add_argument("--base", type=Path,
                    help="another checkout: its version of each source too")
    ap.add_argument("--out", type=Path,
                    default=REPO / "chiprun_out" / "kernel_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    specs = variants()
    if args.only:
        keep = set(args.only.split(","))
        specs = {n: v for n, v in specs.items() if v[0] in keep}
    sources = sorted({v[0] for v in specs.values()})
    csrcs = {n: cuda_ops.CSRC for n in specs}
    if args.base is not None:
        for src in sources:
            specs[f"base_{src}"] = (src, [], True)
            csrcs[f"base_{src}"] = (args.base.resolve() / "firebird_tpu_torch"
                                    / "csrc")
    cuda_ops.build(tuple(sources))
    with ThreadPoolExecutor(len(specs)) as ex:
        built = dict(zip(specs, ex.map(build, specs, specs.values(),
                                       [csrcs[n] for n in specs])))
    packed, staged, _ = cs.make_batch(args.seed, args.chips, dev)
    inp = cs.kernel_inputs(args.seed, staged, kernel.window_cap(packed))
    kw = dict(zip(("change_thr", "outlier_thr"), cs.chi2_thresholds(5)))
    fit = (inp["Yt"], inp["w"], inp["X"], inp["coefmask"])
    mon = (inp["Yd"], inp["coefs_d"], inp["dden"], inp["X"], inp["alive"],
           inp["included"], inp["cur_k"], inp["n_last_fit"], inp["in_mon"])
    ia = (inp["alive"], inp["cur_i"], inp["in_init"], inp["t"], inp["X"],
          inp["Xt"], inp["Yt"], inp["vario"])
    kw_init = dict(W=inp["W"], sensor=cs.LANDSAT_ARD)
    calls = {"lasso_fit": (lambda: cuda_ops.lasso_fit(*fit),
                           lambda: cuda_ops.lasso_fit(*fit, with_rmse=False)),
             "monitor_chain_scored": (
                 lambda: cuda_ops.monitor_chain_scored(*mon, **kw), None),
             "init_window": (lambda: cuda_ops.init_window(*ia, **kw_init),
                             None)}
    if "fused_fit_close" in sources:
        init = cuda_ops.init_window_plain(*ia, **kw_init)
        ffc = {r[0]: r for r in cs.fused_rows(
            inp, cuda_ops.monitor_chain_scored_plain(*mon, **kw), init, kw,
            {"disagreeing_pixels": {}})}["fused_fit_close"][1]
        calls["fused_fit_close"] = (lambda: cuda_ops.fused_fit_close(*ffc),
                                    None)
    if "detect_mega" in sources:
        mega = cs.mega_row(staged, inp["W"], kw, {"disagreeing_pixels": {}},
                           cs.LANDSAT_ARD)
        calls["detect_mega"] = (
            lambda: cuda_ops.detect_mega(*mega[1], **mega[2]), None)
    if "tmask_bad" in sources:
        tm = cuda_ops.tmask_args(
            cuda_ops.init_window_gather(*ia[:7], W=inp["W"]), inp["vario"],
            cs.LANDSAT_ARD)
        calls["tmask_bad"] = (lambda: (cuda_ops.tmask_bad(*tm),), None)
    flat = lambda out: (list(out.values()) if isinstance(out, dict)
                        else [x for v in out for x in
                              (v if isinstance(v, tuple) else (v,))])
    # Each source's further calls, held to the shipped kernel's outputs
    # too: name -> (call, the shipped outputs).
    extra = {}
    if {"lasso_cd", "monitor_chain"} & set(sources):
        s2 = sentinel2_inputs(dev)
    if "lasso_cd" in sources:
        cd = cs.cd_args(inp, args.seed)
        cd_late = cs.cd_args(inp, args.seed, share=0.1)
        cd_s2 = cs.cd_args(s2, cs.S2_SOURCE["seed"])
        calls["lasso_cd"] = (lambda: (cuda_ops.lasso_cd(*cd),), None)
        extra["lasso_cd"] = {
            "ms_late_round": lambda: (cuda_ops.lasso_cd(*cd_late),),
            "ms_sentinel2": lambda: (cuda_ops.lasso_cd(*cd_s2),)}
    if "monitor_chain" in sources:
        plane, plane_s2 = score_plane(inp), score_plane(s2)
        calls["monitor_chain"] = (lambda: cuda_ops.monitoring_only(
            cuda_ops.monitor_chain(*plane, **kw), inp["in_mon"]), None)
        extra["monitor_chain"] = {
            "ms_sentinel2": lambda: cuda_ops.monitoring_only(
                cuda_ops.monitor_chain(*plane_s2, **kw), s2["in_mon"])}
    extra = {src: {key: (fn, [x.clone() for x in flat(fn())])
                   for key, fn in calls_of.items()}
             for src, calls_of in extra.items()}
    reps = {"detect_mega": 5}
    shares = [float(x) for x in args.init_shares.split(",") if x]

    def init_at(share):
        """init_window on the state with ``in_init`` thinned to ``share``."""
        st = ia[:2] + (cs.thin_init(inp, args.seed, share),) + ia[3:]
        return lambda: cuda_ops.init_window(*st, **kw_init)

    res = {"shipped_init_window_by_share": {
        sh: device_ms(init_at(sh), "init_kernel", args.reps) for sh in shares}}
    if shares:
        print(f"shipped init_window device ms by share on {smi}: "
              f"{res['shipped_init_window_by_share']}", flush=True)
    # The fused kernels write their result buffers in place (the same rows
    # at every call): the shipped outputs are copied.
    shipped = {src: [x.clone() for x in flat(calls[src][0]())]
               for src in {v[0] for v in specs.values()}}
    for name, (lib, ptxas) in built.items():
        src, _, must_equal = specs[name]
        saved = cuda_ops._LIBS[src]
        cuda_ops._LIBS[src] = lib
        try:
            full, no_rmse = calls[src]
            got = flat(full())
            same = all(torch.equal(a, b) for a, b in zip(got, shipped[src]))
            if must_equal and not same:
                raise AssertionError(f"{name} differs from the shipped "
                                     f"{src}")
            res[name] = dict(ptxas=ptxas, equal_to_shipped=same,
                             ms=cs.cuda_ms(full, reps.get(src, args.reps)))
            if no_rmse is not None:
                res[name]["ms_without_rmse"] = cs.cuda_ms(no_rmse, args.reps)
            if src in DEVICE_NAMES:
                # The kernel alone (the wrapper's and monitoring_only's ops
                # left out).
                res[name]["device_ms"] = device_ms(full, DEVICE_NAMES[src],
                                                   args.reps)
            for key, (fn, want) in extra.get(src, {}).items():
                same = all(torch.equal(a, b) for a, b in zip(flat(fn()), want))
                res[name][f"equal_to_shipped_{key[3:]}"] = same
                if must_equal and not same:
                    raise AssertionError(f"{name} differs from the shipped "
                                         f"{src} ({key[3:]})")
                res[name][key] = cs.cuda_ms(fn, args.reps)
                if src in DEVICE_NAMES:
                    res[name][f"device_{key}"] = device_ms(
                        fn, DEVICE_NAMES[src], args.reps)
            if src == "init_window" and shares:
                res[name]["device_ms_by_share"] = {
                    sh: device_ms(init_at(sh), "init_kernel", args.reps)
                    for sh in shares}
        finally:
            cuda_ops._LIBS[src] = saved
        print(f"{name} on {smi}: {res[name]}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, variants=res), indent=1))
    print(smi)


if __name__ == "__main__":
    main()

"""What holds lasso_fit and monitor_chain_scored: variants timed on one card.

    python tools/kernel_variants.py [--chips 8] [--seed 0] [--reps 20]
        [--out chiprun_out/kernel_variants.json]

Builds variants of ``csrc/lasso_fit.cu`` and ``csrc/monitor_chain_scored.cu``
by text substitution into copies of ``firebird_tpu_torch/csrc`` under
``build/kernel_variants/`` (the blocks an SM the launch bounds ask for,
which set the register cap; lasso_fit without its coordinate-descent loop),
and times each with CUDA events on chip_smoke.py's kernel-phase inputs
(``--chips`` full-size Landsat chips, 1985-2017, T=768): lasso_fit with and
without its RMSE pass, the monitor as it is called.  Each variant but the
one without the CD loop must give the shipped kernel's outputs bit for bit.
Prints and writes each variant's median milliseconds, its registers and
spills (``-Xptxas -v``) and the card's name and power limit.  Needs a CUDA
device.
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
    return out


def build(name, spec):
    src, subs, _ = spec
    d = OUT_DIR / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(cuda_ops.CSRC, d)
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
        if "ILi12E" in chunk.split("'", 1)[0]:
            continue                        # the Landsat instance only
        grab = lambda pat: int((re.search(pat, chunk) or [0, 0])[1])
        ptxas = dict(registers=grab(r"Used (\d+) registers"),
                     stack_bytes=grab(r"(\d+) bytes stack frame"),
                     spill_stores=grab(r"(\d+) bytes spill stores"))
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, f"fb_{src}")
    fn.argtypes = cuda_ops._ARGTYPES[f"fb_{src}"]
    fn.restype = ctypes.c_int
    return lib, ptxas


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
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
    cuda_ops.build(("lasso_fit", "monitor_chain_scored"))
    specs = variants()
    with ThreadPoolExecutor(len(specs)) as ex:
        built = dict(zip(specs, ex.map(build, specs, specs.values())))
    packed, staged, _ = cs.make_batch(args.seed, args.chips, dev)
    inp = cs.kernel_inputs(args.seed, staged, kernel.window_cap(packed))
    kw = dict(zip(("change_thr", "outlier_thr"), cs.chi2_thresholds(5)))
    fit = (inp["Yt"], inp["w"], inp["X"], inp["coefmask"])
    mon = (inp["Yd"], inp["coefs_d"], inp["dden"], inp["X"], inp["alive"],
           inp["included"], inp["cur_k"], inp["n_last_fit"], inp["in_mon"])
    calls = {"lasso_fit": (lambda: cuda_ops.lasso_fit(*fit),
                           lambda: cuda_ops.lasso_fit(*fit, with_rmse=False)),
             "monitor_chain_scored": (
                 lambda: cuda_ops.monitor_chain_scored(*mon, **kw), None)}
    flat = lambda out: list(out.values()) if isinstance(out, dict) else out
    shipped = {src: flat(c[0]()) for src, c in calls.items()}
    res = {}
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
            res[name] = dict(ptxas, ms=cs.cuda_ms(full, args.reps),
                             equal_to_shipped=same)
            if no_rmse is not None:
                res[name]["ms_without_rmse"] = cs.cuda_ms(no_rmse, args.reps)
        finally:
            cuda_ops._LIBS[src] = saved
        print(f"{name} on {smi}: {res[name]}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(device=smi, variants=res), indent=1))
    print(smi)


if __name__ == "__main__":
    main()

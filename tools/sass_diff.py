"""Compare the SASS of the kernels' build units between two checkouts.

    python tools/sass_diff.py --base .ab_base [--units lasso_fit,init_window]

Builds each unit (default: the f32 instances of the fitting kernels,
``cuda_ops.MIXED_SOURCES``) from this checkout's ``firebird_tpu_torch/csrc``
and from the base checkout's, with this checkout's nvcc flags for the unit,
into ``build/sass_diff/``; disassembles both with ``cuobjdump -sass``,
drops the lines that name the source file and strips the hashes of the
anonymous-namespace names; prints for each unit whether the two are
identical (else the first lines that differ) and the count of HMMA
(tensor-core mma) instructions in each.  Also counts HMMA in the mixed
instances of this checkout.  Writes ``chiprun_out/sass_diff.json``.
Needs nvcc and cuobjdump (a machine with the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from firebird_tpu_torch.ccd import cuda_ops  # noqa: E402

OUT = REPO / "build" / "sass_diff"
ANON = re.compile(r"_GLOBAL__N__[0-9a-fA-F_]+")


def cuobjdump() -> str:
    for p in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if p and Path(p).exists():
            return p
    raise SystemExit("sass_diff: cuobjdump not found")


def build(unit: str, csrc: Path, tag: str) -> Path:
    d = OUT / tag
    d.mkdir(parents=True, exist_ok=True)
    so = d / f"{unit}.so"
    cmd = [cuda_ops._nvcc(), *cuda_ops._flags(unit), "-o", str(so),
           str(csrc / f"{cuda_ops.source_of(unit)}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {unit} ({tag}):\n{r.stderr}")
    return so


def sass(so: Path) -> list[str]:
    text = subprocess.run([cuobjdump(), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    return [ANON.sub("_GLOBAL__N__", line) for line in text.splitlines()
            if "identifier" not in line]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="the base checkout (git archive of the parent)")
    ap.add_argument("--units", default=",".join(cuda_ops.MIXED_SOURCES))
    args = ap.parse_args(argv)
    units = args.units.split(",")
    mixed = [cuda_ops.unit_of(u, True) for u in cuda_ops.MIXED_SOURCES]
    base_csrc = Path(args.base).resolve() / "firebird_tpu_torch" / "csrc"
    jobs = ([(u, base_csrc, "base") for u in units]
            + [(u, cuda_ops.CSRC, "head") for u in units + mixed])
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(((u, t) for u, _, t in jobs),
                        ex.map(lambda j: build(*j), jobs)))
    out = {}
    for u in units:
        a, b = sass(libs[u, "base"]), sass(libs[u, "head"])
        diff = [(i, x, y) for i, (x, y) in enumerate(zip(a, b)) if x != y]
        same = not diff and len(a) == len(b)
        out[u] = dict(identical=same, lines=(len(a), len(b)),
                      hmma=(sum("HMMA" in x for x in a),
                            sum("HMMA" in y for y in b)),
                      first_differences=diff[:5])
        print(f"{u}: SASS identical to the base {same} ({len(a)} / {len(b)} "
              f"lines), HMMA {out[u]['hmma']}", flush=True)
        for i, x, y in diff[:5]:
            print(f"  line {i}: base {x.strip()!r}\n          head {y.strip()!r}")
    for u in mixed:
        n = sum("HMMA" in x for x in sass(libs[u, "head"]))
        out[u] = dict(hmma=n)
        print(f"{u}: HMMA {n}", flush=True)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/sass_diff.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

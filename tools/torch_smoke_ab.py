"""Run ``chip_smoke.py`` from two checkouts in turn on one card, and time
each phase.

    python tools/torch_smoke_ab.py --base .ab_base --change .smoke_checkout \
        [--order ab] [--timeout 1200]

``--base`` and ``--change`` are checkouts of two commits (``git archive``
into a directory ``.gitignore`` lists).  Each run is ``python3
chip_smoke.py`` with the checkout as its working directory, in the order
``--order`` gives (``a`` the base, ``b`` the change; ``abba`` runs four).
Every line a run prints is stamped with the seconds since its start as it
arrives; the run's stdout (stamped), stderr and ``chip_smoke.json`` go to
``chiprun_out/smoke_<i>_<a|b>.{out,err,json}``.  A phase's seconds are the
time between its summary line and the previous phase's (the lines named in
``MARKERS``), so each includes the work the script does between phases;
``reported`` is the phase's own ``phase N s`` where it prints one.  Prints
one JSON line: for each run its exit code, its total (``chip_smoke: N s in
all``), the marks and the phases, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

# The first line each phase prints when it ends, in the script's order.
MARKERS = (("build", "build: "), ("kernels", "route '0' vs "),
           ("sentinel2", "sentinel2 route 'lasso"),
           ("driver", "driver: "), ("ops", "ops: "), ("fleet", "fleet: "),
           ("history", "history: "), ("classify", "classify: "),
           ("mp_ring", "mp_ring: "), ("serve", "serve: "), ("stream", "stream on "), ("ingest", "ingest on "),
           ("alert", "alert on "),
           ("f64", "f64 route: "), ("validate", "roofline, "),
           ("end", "chip_smoke: "))
PHASE_RE = re.compile(r"phase ([0-9.]+) s")
TOTAL_RE = re.compile(r"^chip_smoke: ([0-9.]+) s in all")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def run_one(checkout: Path, out: Path, label: str, timeout: float) -> dict:
    """One chip_smoke run in ``checkout``; its stamped lines to
    ``label``.out, stderr to ``label``.err."""
    t0 = time.monotonic()
    stamped = []
    with open(out / f"{label}.err", "w") as err:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"],
                                cwd=checkout, stdout=subprocess.PIPE,
                                stderr=err, text=True, bufsize=1)
        timer = threading.Timer(timeout, proc.kill)
        timer.start()
        try:
            for line in proc.stdout:
                stamped.append((time.monotonic() - t0, line.rstrip("\n")))
            rc = proc.wait()
        finally:
            timer.cancel()
    wall = time.monotonic() - t0
    (out / f"{label}.out").write_text("".join(
        f"[{t:8.1f}] {ln}\n" for t, ln in stamped))
    report = checkout / "chiprun_out" / "chip_smoke.json"
    if report.exists():
        (out / f"{label}.json").write_text(report.read_text())
    marks, reported, total = {}, {}, None
    for t, ln in stamped:
        for name, prefix in MARKERS:
            if name not in marks and ln.startswith(prefix):
                marks[name] = t
                m = PHASE_RE.search(ln)
                if m:
                    reported[name] = float(m.group(1))
        m = TOTAL_RE.match(ln)
        if m:
            total = float(m.group(1))
    phases, prev = {}, 0.0
    for name, _ in MARKERS:
        if name in marks:
            phases[name] = marks[name] - prev
            prev = marks[name]
    return dict(label=label, rc=rc, wall=wall, total=total, marks=marks,
                phases=phases, reported=reported,
                last_line=stamped[-1][1] if stamped else None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--change", required=True, type=Path)
    ap.add_argument("--order", default="ab")
    ap.add_argument("--timeout", type=float, default=1200.0)
    args = ap.parse_args(argv)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    smi = _smi()
    runs = []
    for i, which in enumerate(args.order):
        checkout = args.base if which == "a" else args.change
        r = run_one(checkout.resolve(), out, f"smoke_{i}_{which}",
                    args.timeout)
        runs.append(r)
        print(json.dumps({k: r[k] for k in ("label", "rc", "total",
                                            "wall")}), flush=True)
    summary = dict(device=smi, runs=runs)
    (out / "smoke_ab.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()

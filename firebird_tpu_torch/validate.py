"""Kernel-vs-oracle parity audit on live data.

The port's own copy of the JAX package's ``validate.py``: the same audit,
the same report keys with the same meaning.  The framework's correctness
claim is *bit-identical break dates* against the per-pixel CPU reference
implementation; the test suite pins that on fixtures, and this module
makes it an operational check a user can run against any chip —
synthetic, file-backed, or a real Chipmunk endpoint — and either dtype:

    python -m firebird_tpu_torch validate -x 542000 -y 1650000 -n 200

runs the detector over the chip on the card (``--device cpu`` runs the
plain versions on the CPU), replays ``n`` sampled pixels through the
float64 NumPy oracle (ccd/reference.py), and prints a JSON agreement
report.  Exit status is non-zero when structural agreement (procedures,
model counts, break/start/end days, processing masks) is not 100%, so
the command slots into smoke suites as-is.
"""

from __future__ import annotations

import numpy as np

from firebird_tpu_torch.ccd import kernel
from firebird_tpu_torch.ccd.reference import detect_sensor
from firebird_tpu_torch.config import Config
from firebird_tpu_torch.ingest import pack
from firebird_tpu_torch.obs import logger

log = logger("validate")

STRUCTURAL = ("procedure", "n_models", "break_day", "start_day", "end_day",
              "processing_mask", "curve_qa", "observation_count")


def _rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-9)


def oracle(task) -> dict:
    """One pixel through the float64 oracle: ``task`` is the
    ``(dates, spectra [B, T], qas, sensor)`` of
    ``ccd.reference.detect_sensor`` (a replay's unit of work)."""
    return detect_sensor(*task)


def validate_chip(packed, n_pixels: int = 100, dtype="float64",
                  seed: int = 0, device=None, replay=None) -> dict:
    """Audit one packed chip: the detector at ``dtype`` on ``device``
    (default CUDA; raises without a card unless the caller names the CPU)
    vs the float64 oracle on ``n_pixels`` sampled pixels.  ``replay``
    maps a list of :func:`oracle` tasks to their results; None runs them
    in this process, as the JAX package does (a caller with a pool of
    spawned processes passes its own map; never fork a process that holds
    a CUDA context).  Returns the report dict."""
    if n_pixels <= 0:
        raise ValueError("n_pixels must be positive — auditing zero pixels "
                         "would report vacuous agreement")
    dtype = kernel.float_dtype(dtype)
    seg = kernel.detect_packed(packed, device=device, dtype=dtype)
    one = kernel.chip_slice(seg, 0, to_host=True)
    T = int(packed.n_obs[0])
    dates = packed.dates[0][:T]

    P = one.n_segments.shape[0]
    rng = np.random.default_rng(seed)
    pix = rng.permutation(P)[: min(n_pixels, P)]

    mismatch = {f: 0 for f in STRUCTURAL}
    chprob_max = 0.0
    numeric = {"coefficients": 0.0, "intercept": 0.0, "rmse": 0.0,
               "magnitude": 0.0}
    bands_checked = 0
    # the sensor-generic oracle, so non-Landsat sources audit too
    tasks = [(dates, packed.spectra[0, :, int(p_), :T],
              packed.qas[0, int(p_), :T], packed.sensor) for p_ in pix]
    results = (replay or (lambda ts: [oracle(t) for t in ts]))(tasks)
    for p_, o in zip(pix, results):
        k = kernel.segments_to_records(one, dates, int(p_),
                                       sensor=packed.sensor)
        if k["procedure"] != o["procedure"]:
            mismatch["procedure"] += 1
            continue
        if k["processing_mask"] != o["processing_mask"]:
            mismatch["processing_mask"] += 1
        om_, km_ = o["change_models"], k["change_models"]
        if len(om_) != len(km_):
            mismatch["n_models"] += 1
            continue
        pixel_bad = set()
        for om, km in zip(om_, km_):
            for f in ("break_day", "start_day", "end_day", "curve_qa",
                      "observation_count"):
                if om[f] != km[f]:
                    pixel_bad.add(f)
            chprob_max = max(chprob_max, abs(om["change_probability"]
                                             - km["change_probability"]))
            for name in packed.sensor.band_names:
                bands_checked += 1
                numeric["rmse"] = max(numeric["rmse"],
                                      _rel_err(om[name]["rmse"],
                                               km[name]["rmse"]))
                numeric["magnitude"] = max(numeric["magnitude"],
                                           _rel_err(om[name]["magnitude"],
                                                    km[name]["magnitude"]))
                numeric["intercept"] = max(numeric["intercept"],
                                           _rel_err(om[name]["intercept"],
                                                    km[name]["intercept"]))
                for a, b in zip(om[name]["coefficients"],
                                km[name]["coefficients"]):
                    numeric["coefficients"] = max(numeric["coefficients"],
                                                  _rel_err(a, b))
        for f in pixel_bad:  # count mismatching *pixels*, not models —
            mismatch[f] += 1  # the agreement ratio denominator is pixels

    n = int(len(pix))
    structural_ok = not any(mismatch.values())
    return {
        "pixels_audited": n,
        "dtype": str(dtype).removeprefix("torch."),
        "obs_per_pixel": int(packed.n_obs[0]),
        "structural_agreement": structural_ok,
        "mismatches": mismatch,
        "break_day_agreement": (n - mismatch["procedure"]
                                - mismatch["n_models"]
                                - mismatch["break_day"]) / max(n, 1),
        "change_probability_max_abs_err": chprob_max,
        "numeric_max_rel_err": numeric,
        "band_segments_checked": bands_checked,
    }


def validate(x=None, y=None, acquired: str | None = None,
             n_pixels: int = 100, dtype: str = "float64", seed: int = 0,
             cfg: Config | None = None, source=None, device=None,
             replay=None) -> dict:
    """Fetch one chip (the chip containing (x, y), or a default synthetic
    chip) and audit it on ``device`` (``driver.core.run_device``: this
    process's card unless the caller names the CPU).  See
    :func:`validate_chip`."""
    from firebird_tpu_torch import grid
    from firebird_tpu_torch.driver.core import make_source, run_device
    from firebird_tpu_torch.utils import dates as dt

    cfg = cfg or Config.from_env()
    if (x is None) != (y is None):
        raise ValueError("validate needs both x and y (or neither, for "
                         "the default synthetic chip)")
    dev = run_device(device)
    if x is None and source is None:
        # No location given: audit the documented default *synthetic* chip
        # regardless of the configured source — chip (100, 200) is not a
        # grid-aligned id a real endpoint could serve.
        from firebird_tpu_torch.ingest import SyntheticSource

        source = SyntheticSource(seed=0)
    source = source or make_source(cfg)
    if x is None:
        cx, cy = 100, 200
    else:
        cx, cy = (int(v) for v in
                  grid.snap(float(x), float(y))["chip"]["proj-pt"])
    acquired = acquired or dt.default_acquired()
    log.info("validate: chip (%d, %d), %d pixels, dtype %s, device %s",
             cx, cy, n_pixels, dtype, dev)
    packed = pack([source.chip(cx, cy, acquired)], bucket=cfg.obs_bucket,
                  max_obs=cfg.max_obs)
    report = validate_chip(packed, n_pixels=n_pixels, dtype=dtype, seed=seed,
                           device=dev, replay=replay)
    report["chip"] = [cx, cy]
    return report


"""Closed-form FLOP / HBM-traffic model of the CCDC kernel.

The port's own copy of the JAX package's ``ccd/flops.py``: the closed
forms are the JAX package's, term for term, so both packages model the
same dispatch with the same numbers.  The event-horizon loop does the
same algebra every round, so its arithmetic is computable in closed form
from the dispatch shape: P pixels, T observations, W window cap, and the
sensor's band counts, times the measured round count.  Multiplied by a
measured pixel rate it gives the achieved FLOP/s and bytes/s, and against
the card's peaks (:data:`PEAKS`: the H100's) the roofline shares.

Conventions:
- one multiply-add = 2 FLOPs;
- formulas mirror the JAX package's kernel.py line by line (cited per
  term), so a change that shifts the arithmetic is a model bug you can
  grep for;
- elementwise [P,T] bookkeeping (masks, cumsum/cummin, selects) is
  counted in the *bytes* model, not the FLOP model — those ops are
  bandwidth work and never the FLOP bottleneck.

The model is an estimate of *useful* arithmetic, not a count of what the
card finally executes (masked lanes still burn cycles — that's the point
of counting them: the dense batched formulation pays for masked work, and
utilization against the dense count is the honest number).
"""

from __future__ import annotations

import dataclasses

from firebird_tpu_torch.ccd import params
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD

K = params.MAX_COEFS            # 8 design columns
NT = params.TMASK_COEFS         # 5 Tmask columns


def _lasso_fit_flops(P: int, T: int, B: int, with_rmse: bool) -> float:
    """One batched Lasso fit (kernel._fit_lasso_coefs / _fit_lasso).

    Gram:  w @ XX            [P,T]x[T,K^2]        (kernel.py:174)
    corr:  (Y*w) einsum X    [P,B,T]x[T,K] + the Y*w mult (kernel.py:175)
    CD:    LASSO_ITERS x K coordinate updates, each an einsum
           G[:,j,:] . b over [P,B,K] (kernel.py:195-205)
    rmse:  pred einsum [P,B,T]x? + residual reduction (kernel.py:220-223)
    """
    gram = 2.0 * P * T * K * K
    corr = 2.0 * P * B * T * K + P * B * T
    cd = params.LASSO_ITERS * K * (2.0 * P * B * K + 4.0 * P * B)
    f = gram + corr + cd
    if with_rmse:
        f += 2.0 * P * B * T * K + 4.0 * P * B * T
    return f


def _tmask_flops(P: int, W: int, nb: int) -> float:
    """One Tmask IRLS screen over the compacted window (kernel._tmask_bad).

    One-time XtXt outer products [P,W,NT^2], then (1 + TMASK_IRLS_ITERS)
    weighted SPD solves, each: flat Gram dot [P,nb,W]x[P,W,NT^2], corr
    dot, unrolled 5x5 Cholesky (kernel._tmask_bad/_chol_solve_small);
    per-iteration residual einsum + two masked medians over W (bitonic
    network).
    """
    solves = 1 + params.TMASK_IRLS_ITERS
    xtxt = P * W * NT * NT                       # outer products, once
    per_solve = (2.0 * P * nb * W * NT * NT      # flat Gram dot
                 + 2.0 * P * nb * W * NT         # cc (incl. Y2*wt mult)
                 + P * nb * (NT ** 3 / 3 + 2 * NT * NT))   # unrolled chol
    resid = 2.0 * P * nb * W * NT + 2.0 * P * nb * W
    med = 2 * _sort_flops(P * nb, W)             # med + mad networks
    return xtxt + solves * per_solve \
        + (params.TMASK_IRLS_ITERS + 1) * resid \
        + params.TMASK_IRLS_ITERS * med


def _sort_flops(rows: float, n: int) -> float:
    """Bitonic network over a length-n axis: log2^2 stages of compare /
    select (kernel._bitonic_sort_last) — ~3 elementwise ops per element
    per stage."""
    if n <= 1:
        return 0.0
    lg = max(1, (n - 1).bit_length())
    stages = lg * (lg + 1) / 2
    return 3.0 * rows * n * stages


def round_flops(P: int, T: int, W: int, sensor=LANDSAT_ARD,
                mixed: bool = False) -> dict:
    """FLOPs of one event-horizon round over P pixels (kernel.body).

    Terms are grouped by the cond gate that executes them (kernel
    _detect_batch_impl): ``init`` only runs on rounds with an
    initializing pixel, ``close`` on rounds closing a segment, ``refit``
    on rounds fitting a model, ``monitor`` every round.  ``total`` is
    the ungated (every-round) sum — the pre-gating upper bound.

    ``mixed`` (FIREBIRD_MIXED_PRECISION) adds a ``mixed`` sub-dict
    modeling the bf16 split-dot gram (pallas_ops._gram_cd_core): the
    useful arithmetic is UNCHANGED (total stays comparable across
    rungs), but the Gram/corr dots execute 2 and 3 bf16 MXU passes
    instead of f32-"highest"'s 6, with bf16 (half-width) operands —
    bench_detail turns that into the mixed compute ceiling.
    """
    B = sensor.n_bands
    D = len(sensor.detection_bands)
    nb = len(sensor.tmask_bands)
    init_fit = _lasso_fit_flops(P, T, B, with_rmse=False)   # c4 stability
    init_resid = 2.0 * P * B * W * K + 6.0 * P * B * W      # r_w + rmse4
    tmask = _tmask_flops(P, W, nb)
    # One-hot window selections (the scatter-free MXU formulation):
    # Yw7 [P,B,T]x[P,W,T], XW [P,W,T]x[T,K+NT] (kernel._init_block; these
    # replaced serialized per-lane gathers).
    onehot_w = (2.0 * P * B * W * T               # Yw7
                + 2.0 * P * W * T * (K + NT))     # XW
    monitor = (2.0 * P * D * T * K      # pred_d
               + 4.0 * P * D * T)       # score s
    # Segment-close work (kernel._close_block): PEEK-run one-hot
    # selections + break-magnitude medians.
    close = (2.0 * P * params.PEEK_SIZE * T * (K + B)        # X_run + Y_run
             + 2.0 * P * B * params.PEEK_SIZE * K            # pred_run
             + _sort_flops(P * B, params.PEEK_SIZE))         # mags median
    refit = _lasso_fit_flops(P, T, B, with_rmse=True)       # cfull
    init = init_fit + init_resid + tmask + onehot_w
    out = {"init_fit": init_fit, "init_resid": init_resid,
           "tmask": tmask, "onehot": onehot_w, "monitor": monitor,
           "close": close, "refit": refit, "init": init,
           "total": init + monitor + close + refit}
    if mixed:
        # Per firing fit (the INIT stability fit and the shared refit
        # each contain one Gram + one corr): the useful dot FLOPs that
        # move from the f32-"highest" MXU schedule (6 bf16 passes per
        # dot) to the split-dot schedule (Gram 2 — 0/1 weights are
        # bf16-exact; corr 3 — lo·lo dropped).  Everything else (CD
        # loop, RMSE, monitor, Tmask, medians) stays f32: the decision
        # envelope.
        gram_dot = 2.0 * P * T * K * K
        corr_dot = 2.0 * P * B * T * K
        out["mixed"] = {
            "gram_dot_flops": gram_dot, "corr_dot_flops": corr_dot,
            "mxu_passes_f32": 6, "mxu_passes_gram": 2,
            "mxu_passes_corr": 3,
            "gram_operand_bytes_ratio": 0.5,    # bf16 vs f32 operands
            "dot_stage_speedup_model": round(
                6.0 * (gram_dot + corr_dot)
                / (2.0 * gram_dot + 3.0 * corr_dot), 2),
        }
    return out


def setup_flops(P: int, T: int, sensor=LANDSAT_ARD) -> float:
    """One-time work outside the round loop: QA triage, variogram (sorted
    successive diffs, kernel._variogram), the alt-procedure fit, XX outer
    products."""
    B = sensor.n_bands
    triage = 12.0 * P * T
    vario = P * B * T + _sort_flops(P * B, T - 1)
    alt = _lasso_fit_flops(P, T, B, with_rmse=True)
    xx = T * K * K
    return triage + vario + alt + xx


def detect_flops(P: int, T: int, W: int, rounds: float,
                 sensor=LANDSAT_ARD,
                 phase_rounds: tuple | None = None,
                 mixed: bool = False) -> dict:
    """Total kernel FLOPs for one dispatch and the per-pixel figure.

    ``phase_rounds`` = (init_rounds, fit_rounds, close_rounds) — the
    measured cond-gate execution counts (ChipSegments.round_counts).
    None models the ungated loop (every block every round)."""
    r = round_flops(P, T, W, sensor, mixed=mixed)
    ir, fr, cr = phase_rounds if phase_rounds is not None \
        else (rounds, rounds, rounds)
    total = (r["monitor"] * rounds + r["init"] * ir + r["refit"] * fr
             + r["close"] * cr + setup_flops(P, T, sensor))
    return {"per_round": r, "rounds": rounds, "total": total,
            "per_pixel": total / max(P, 1)}


def round_bytes(P: int, T: int, W: int, S: int, dtype_bytes: int,
                sensor=LANDSAT_ARD,
                rounds: float = 1.0,
                phase_rounds: tuple | None = None,
                pallas: frozenset | set | tuple = (),
                wire_bytes: int = 2, mixed: bool = False) -> float:
    """Estimated HBM traffic (read+write) over the event loop.

    ``mixed`` (FIREBIRD_MIXED_PRECISION): the HBM model is mixed-
    INVARIANT on every route the knob actually reaches — the Pallas fit
    kernels stream the wire int16 spectra either way, and the bf16 gram
    operands live at the VMEM→MXU boundary, not in HBM (their halved
    bytes are modeled in round_flops' ``mixed`` block and fold into
    bench_detail's mixed compute ceiling).  The parameter is accepted so
    call sites can pass the picked config through uniformly; it changes
    no HBM term by design, and this docstring is the written argument.

    Per-phase apportionment mirrors the kernel's cond gates
    (_detect_batch_impl): the score-group spectra read, the [P,T]
    temporaries, and the carried state move every round; the one-hot
    window tensors + stability-fit spectra read only on INIT rounds; the
    refit spectra read on fit rounds; the PEEK-run tensors + result-
    buffer rewrite on close rounds.  ``phase_rounds`` = (init, fit,
    close) counts; None models every block every round.

    ``pallas`` names the route's kernels (:func:`modeled_components` of a
    ``kernel.pallas_components`` route): a component's term is then
    modeled from its kernel's actual streams (known exactly, unlike the
    plain ops' estimate) instead of the plain path's materializations.
    The names are the JAX package's switches, each the port's kernel of
    that name: 'score' is ``monitor_chain_scored``, 'init'
    ``init_window``, 'fit' ``lasso_fit``, 'fused' the fused round routes
    (``fused_fit_close`` and ``fused_round``: ``kernel.fused_mode`` 1 or
    "mon"), 'mega' ``detect_mega``.  The component route's names
    ('lasso', 'monitor', 'tmask') model as the plain path, as the JAX
    package's XLA path around its component kernels:

    - 'score': the monitor round streams the [D,T,P] *wire-dtype*
      spectra once and 4 [T,P] i32 planes (alive/included in, inc/rem_q
      out); the [P,D,T] prediction einsum, the f32 score plane and the
      rank planes never exist in HBM (pallas_ops._monitor_scored_block).
    - 'init': the INIT round streams the [B,T,P] wire spectra + ~3
      [T,P] i32 planes (alive in/out, w_stab out); the [P,W,T] one-hot
      tensors and the stability fit's float Y re-read never exist
      (pallas_ops._init_window_block).
    - 'fit': the refit streams the [B,T,P] wire spectra + the [T,P]
      window plane; Gram/corr/CD/RMSE stay in VMEM
      (pallas_ops._fit_block).
    - 'fused': the FIREBIRD_FUSED_FIT gram→CD→close kernel
      (pallas_ops._fused_fit_close_block) — the close + shared-fit pair
      runs on ONE wire-spectra residency per fit round, and the close's
      buffer rewrite crosses the kernel boundary once instead of
      round-tripping the [P,S*k] planes plus the PEEK-run one-hot
      tensors.  Close-only rounds (the shared tail close) still pay one
      buffer boundary; the rare break round adds kernel._close_mags'
      spectra read, modeled under the close term.
    """
    B = sensor.n_bands
    D = len(sensor.detection_bands)
    ir, fr, cr = phase_rounds if phase_rounds is not None \
        else (rounds, rounds, rounds)
    pallas = frozenset(pallas)
    if "mega" in pallas:
        # Whole-loop kernel (pallas_ops._detect_mega_block): the event
        # loop's HBM traffic is ROUND-INDEPENDENT — one [B,T,P] wire
        # read, the start-state planes in (alive + phase/cursor vectors),
        # and the result-buffer/final-alive boundary out.  Matches the
        # mega pallas_call's in/out BlockSpecs term by term.
        return (P * B * T * wire_bytes          # wire spectra, once
                + 2 * 4.0 * P * T               # alive0 in + alive out
                + 8.0 * P                        # i32 state vectors
                + 2.0 * P * S * (6 + 2 * B + B * K) * dtype_bytes)
    # carried loop state: alive/included bool planes + coefs, read+written
    carry = 2 * (2.0 * P * T + P * B * K * dtype_bytes)
    if "score" in pallas:
        # wire spectra once + 4 i32 planes through the kernel boundary
        every = P * D * T * wire_bytes + 16.0 * P * T + carry
    else:
        # score-group read [P,D,T] + ~10 [P,T] temporaries (bufs counted
        # on close rounds — unchanged cond pass-through aliases in place)
        every = (1.0 * P * D * T * dtype_bytes
                 + 10.0 * P * T * dtype_bytes + 6.0 * P * T + carry)
    if "init" in pallas:
        init = P * B * T * wire_bytes + 12.0 * P * T
    else:
        # oh_w bool written+read + float view read by the two selection
        # matmuls + window members/XtXt + the c4 fit's Y read
        init = (3.0 * P * W * T
                + 3.0 * P * W * T * dtype_bytes
                + 2.0 * P * W * (NT + B + NT * NT) * dtype_bytes
                + P * B * T * dtype_bytes)
    if "fused" in pallas:
        # The fused kernel reads the wire spectra once per firing round
        # and serves BOTH the fit and the close row write from it; the
        # buffer planes stream through the kernel boundary (in + out)
        # instead of the XLA path's oh_run tensors + cond round-trips.
        # The pre-fusion model charged the spectra twice (fit + close
        # oh_run) — the satellite bugfix this branch exists for: an
        # unfused byte model here overstated the fused path's traffic
        # and understated its intensity/MFU.
        fit = P * B * T * wire_bytes + 5.0 * P * T
        close = 2.0 * P * S * (6 + 2 * B + B * K) * dtype_bytes + 8.0 * P
    else:
        if "fit" in pallas:
            fit = P * B * T * wire_bytes + 5.0 * P * T
        else:
            fit = P * B * T * dtype_bytes         # cfull Gram corr Y read
        close = (2.0 * P * params.PEEK_SIZE * T * dtype_bytes    # oh_run
                 + 2.0 * P * S * (6 + 2 * B + B * K) * dtype_bytes)  # bufs
    return every * rounds + init * ir + fit * fr + close * cr


# ---------------------------------------------------------------------------
# Occupancy-weighted lane-round model (active-lane compaction).
# The dense batched loop pays every padded lane every round; compaction
# (kernel._detect_batch_impl) makes the paid set track the ACTIVE set:
# dense-prefix permutation clusters dead lanes into whole trailing
# blocks the Pallas kernels skip, and the bucketed re-entry shrinks the
# lane width itself for the long tail.  The kernel captures per-round
# (active, paid) lane counts per chip (ChipSegments.occupancy); this
# model turns the capture into the padded-vs-effective accounting the
# bench artifact and the obs counters report.
# ---------------------------------------------------------------------------

# A report that embeds occupancy_detail's per_round list verbatim must
# stay one readable JSON line: cap it, since a deep-round dispatch runs
# ~2T+8 rounds.
PER_ROUND_CAP = 128


def occupancy_detail(occupancy, rounds, lanes: int) -> dict:
    """Padded vs effective lane-rounds from the kernel's per-round
    occupancy capture.

    Args:
        occupancy: [C, R_max, 2] int (active_lanes, paid_lanes) per chip
            per executed round (ChipSegments.occupancy, host array).
        rounds: [C] executed round counts (ChipSegments.rounds).
        lanes: padded lanes per chip (P).

    Returns a dict with ``padded_lane_rounds`` (lanes x rounds — what the
    uncompacted loop pays), ``effective_lane_rounds`` (paid lanes summed:
    blocks containing a working pixel, at the bucket width after
    re-entry), ``active_lane_rounds`` (lanes with a working pixel — the
    lower bound any compaction scheme can reach), ``wasted_lane_rounds``
    (effective - active), ``occupancy_savings`` (padded / effective), a
    ``per_round`` list of {round, active, paid} summed over chips
    (bounded at PER_ROUND_CAP rows so a deep-round artifact cannot
    regrow the oversized-JSON-line failure the bench satellites fixed;
    ``per_round_dropped`` counts rows past the cap — totals always
    cover every round), and ``_fractions`` (active/lanes per
    chip-round, consumed by kernel.record_occupancy's histogram).

    Vectorized: this runs on the driver's drain thread per batch, and a
    deep time series executes ~2T+8 rounds per chip — a python loop over
    chip-rounds there competes with egress."""
    import numpy as np

    occ = np.asarray(occupancy)
    rds = np.asarray(rounds).reshape(-1)
    C, R_max = occ.shape[0], occ.shape[1]
    r_c = rds[np.minimum(np.arange(C), rds.size - 1)].astype(np.int64)
    mask = np.arange(R_max)[None, :] < np.minimum(r_c, R_max)[:, None]
    act = np.where(mask, occ[..., 0], 0)
    paid = np.where(mask, occ[..., 1], 0)
    padded = int(lanes) * int(mask.sum())
    active = int(act.sum())
    effective = int(paid.sum())
    # Per-round sums over chips; executed rounds form a dense prefix per
    # chip, so the used rounds are 0..max(r_c)-1.
    n_rows = int(mask.any(0).sum())
    a_r, p_r = act.sum(0), paid.sum(0)
    fractions = occ[..., 0][mask] / max(lanes, 1)   # row-major: (c, r)
    return {
        "padded_lane_rounds": padded,
        "effective_lane_rounds": effective,
        "active_lane_rounds": active,
        "wasted_lane_rounds": effective - active,
        "occupancy_savings": round(padded / max(effective, 1), 3),
        "mean_active_fraction": round(
            float(fractions.mean()) if fractions.size else 0.0, 4),
        "per_round": [{"round": r, "active": int(a_r[r]),
                       "paid": int(p_r[r])}
                      for r in range(min(n_rows, PER_ROUND_CAP))],
        **({"per_round_dropped": n_rows - PER_ROUND_CAP}
           if n_rows > PER_ROUND_CAP else {}),
        "_fractions": fractions,
    }


def expected_compaction_speedup(mean_active_fraction: float,
                                lane_block: int = 512,
                                lanes: int = 10000) -> float:
    """The occupancy model's closed-form ceiling for the event loop's
    per-round cost under compaction: with mean active fraction a, the
    compacted loop pays ~ceil(a*P/B)*B of P lanes per round, so the
    loop-cost speedup approaches P / (ceil(a*P/B)*B) — e.g. a=0.5 -> ~2x,
    a=0.125 with bucketed re-entry -> ~8x.  Deviation from the measured
    wall ratio quantifies the non-lane-proportional terms (chip-shared
    design work, cond-gate overhead, the compaction sweeps themselves);
    docs/ROOFLINE.md "Occupancy" holds the written argument."""
    a = min(max(mean_active_fraction, 0.0), 1.0)
    paid = -lane_block * (-max(a * lanes, 1.0) // lane_block)
    return lanes / max(paid, 1.0)


def rebalance_detail(rounds_by_shard, wall_seconds: float,
                     lanes_migrated: int = 0) -> dict:
    """Straggler-idle model for the cross-device rebalancing ring
    (parallel.mesh; docs/ROOFLINE.md "Fused fit").

    In SPMD each device runs its own event loop and the dispatch ends at
    the SLOWEST device, so per-device round counts bound the idle:
    a device executing r_d rounds of a max-R dispatch idles
    ~(R - r_d)/R of the wall.  ``rounds_by_shard`` is the per-device
    executed round count (one value per shard — under sharding every
    chip of a shard reports its loop's count, so callers pass one per
    device); the model reports the idle seconds a perfect balancer
    could reclaim and the balance ratio (mean/max rounds, 1.0 = no
    straggler).  ``lanes_migrated`` (the kernel counter) rides along so
    the bench artifact pairs the model with what the ring actually
    moved."""
    import numpy as np

    r = np.asarray(rounds_by_shard, np.float64).reshape(-1)
    r = r[r > 0] if (r > 0).any() else r
    if r.size == 0:
        return {"straggler_idle_seconds_saved_model": 0.0,
                "balance_ratio": 1.0, "lanes_migrated": int(lanes_migrated)}
    mx = float(r.max())
    ratio = float(r.mean()) / max(mx, 1.0)
    idle = (1.0 - ratio) * float(wall_seconds)
    return {"straggler_idle_seconds_saved_model": round(idle, 4),
            "balance_ratio": round(ratio, 4),
            "rounds_by_shard": [int(x) for x in r[:64]],
            "lanes_migrated": int(lanes_migrated)}


# ---------------------------------------------------------------------------
# Device peaks (per card).  Source: NVIDIA's H100 data sheet, SXM part,
# dense rates at the full 700 W power limit; matched by substring of
# torch.cuda.get_device_name.  The detector computes in float32 outside
# the tensor cores, so utilization is reported against BOTH the float32
# rate and the bf16 tensor-core rate (the mixed Gram's).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Peak:
    name: str
    bf16_flops: float          # peak dense tensor-core FLOP/s, bf16
    f32_flops: float           # float32 FLOP/s outside the tensor cores
    hbm_bytes: float           # device memory bandwidth, bytes/s


PEAKS = (
    Peak("H100", 989e12, 67e12, 3.35e12),
)


def peak_for(device_kind: str) -> Peak | None:
    dk = device_kind.lower()
    for p in PEAKS:
        if p.name.lower() in dk:
            return p
    return None


def modeled_components(route, fused=0) -> frozenset:
    """The :func:`round_bytes` component set of a
    ``kernel.pallas_components`` route run on round route ``fused``
    (``kernel.fused_mode``: 0, 1 or "mon"): the route's component names,
    and 'fused' where the round route is a fused one (the mega route has
    no round route)."""
    comps = set(route.components)
    if fused and "mega" not in comps:
        comps.add("fused")
    return frozenset(comps)


def bench_detail(pixels_per_sec: float, P: int, T: int, W: int, S: int,
                 rounds: float, device_kind: str, dtype_bytes: int = 4,
                 sensor=LANDSAT_ARD, phase_rounds: tuple | None = None,
                 pallas: frozenset | set | tuple = (),
                 wire_bytes: int = 2, mixed: bool = False) -> dict:
    """The roofline block of one dispatch (``chip_smoke.py`` prints it for
    route 0 beside its per-kernel bounds).

    ``phase_rounds`` = measured (init, fit, close) cond-gate counts
    (ChipSegments.round_counts) — makes the model reflect what the
    phase-gated loop actually executed instead of the ungated bound.
    ``pallas`` = the enabled component set (see round_bytes) so the byte
    model reflects the picked config's actual streams.  ``mixed`` = the
    picked config runs the bf16 split-dot gram: the model's MFU numbers
    stay against the SAME useful-arithmetic count (comparable across
    rungs), and a ``mixed`` block reports the dot-stage pass/operand
    model plus the raised compute ceiling — with
    ``mfu_pct_vs_bf16_peak`` the headline utilization figure for the
    picked config, since the dots then run on the bf16 MXU path."""
    fl = detect_flops(P, T, W, rounds, sensor, phase_rounds=phase_rounds,
                      mixed=mixed)
    by = round_bytes(P, T, W, S, dtype_bytes, sensor, rounds=rounds,
                     phase_rounds=phase_rounds, pallas=pallas,
                     wire_bytes=wire_bytes, mixed=mixed) / max(P, 1)
    achieved = pixels_per_sec * fl["per_pixel"]
    hbm_rate = pixels_per_sec * by
    out = {
        "model_flops_per_pixel": round(fl["per_pixel"], 1),
        "model_bytes_per_pixel": round(by, 1),
        "arithmetic_intensity": round(fl["per_pixel"] / max(by, 1.0), 2),
        "achieved_tflops": round(achieved / 1e12, 4),
        "achieved_hbm_gbps": round(hbm_rate / 1e9, 2),
        "rounds": round(float(rounds), 1),
        "device_kind": device_kind,
    }
    if phase_rounds is not None:
        out["phase_rounds"] = {"init": round(float(phase_rounds[0]), 1),
                               "fit": round(float(phase_rounds[1]), 1),
                               "close": round(float(phase_rounds[2]), 1)}
    if pallas:
        out["pallas_modeled"] = sorted(pallas)
    pk = peak_for(device_kind)
    if pk is not None:
        out["mfu_pct_vs_f32_peak"] = round(100 * achieved / pk.f32_flops, 2)
        out["mfu_pct_vs_bf16_peak"] = round(100 * achieved / pk.bf16_flops, 2)
        out["hbm_util_pct"] = round(100 * hbm_rate / pk.hbm_bytes, 2)
        # roofline-implied ceilings for this dispatch shape
        out["compute_bound_pixels_per_sec"] = round(
            pk.f32_flops / fl["per_pixel"], 1)
        out["hbm_bound_pixels_per_sec"] = round(pk.hbm_bytes / max(by, 1.0), 1)
    if mixed:
        r = fl["per_round"]
        md = dict(r["mixed"])
        if pk is not None and phase_rounds is not None:
            # Mixed compute ceiling: the Gram/corr dots fire on init +
            # fit rounds and run pass-counted at the bf16 peak; the rest
            # of the useful arithmetic stays at the f32 peak.  Per
            # pixel, over the dispatch:
            ir, frr, _ = phase_rounds
            dots = (md["gram_dot_flops"] + md["corr_dot_flops"]) \
                * (ir + frr) / max(P, 1)
            rest = max(fl["per_pixel"] - dots, 0.0)
            t_mixed = (md["mxu_passes_gram"] * md["gram_dot_flops"]
                       + md["mxu_passes_corr"] * md["corr_dot_flops"]) \
                * (ir + frr) / max(P, 1) / pk.bf16_flops \
                + rest / pk.f32_flops
            md["mixed_compute_bound_pixels_per_sec"] = round(
                1.0 / max(t_mixed, 1e-30), 1)
        out["mixed"] = md
    return out

"""The CCDC change detector over whole chips, in PyTorch.

The counterpart of ``firebird_tpu/ccd/kernel.py`` on its wire-resident
Pallas routes: every pixel of every chip of a batch runs in lockstep
through an event-horizon loop.  Each round advances every pixel to its
next model event:

- INIT pixels find their initialization window, screen it with the Tmask
  IRLS and test the stability of a 4-coefficient fit
  (``cuda_ops.init_window``);
- MONITOR pixels score all remaining observations against their model and
  locate the first break, refit point or the series tail
  (``cuda_ops.monitor_chain_scored``);
- closed segments are written into fixed-capacity buffers, and the pixels
  that initialized or reached a refit point get a new Lasso fit
  (``cuda_ops.lasso_fit``).

The rounds run as a Python ``while`` loop; each round's phase blocks are
gated by host-side tests of whether any pixel needs them (one device sync
per gate).  The chip axis ``C`` is a batch dimension of every tensor.

Layouts: the wire spectra arrive as ``[C,B,P,T]`` int16 (the packer's
layout) and stay resident as ``[C,B,T,P]``; per-pixel time planes are
``[C,T,P]``; results use the JAX package's ``ChipSegments`` layout
(``[C,P,...]``, mask ``[C,P,T]``).  The kernels of a round come from the
JAX package's FIREBIRD_PALLAS (:func:`pallas_components`): the route
above (``fit,score,init``, the default), the component route
(``lasso,monitor,tmask``: a PyTorch Gram around the ``lasso_cd`` kernel, a
PyTorch score plane before the ``monitor_chain`` kernel, a PyTorch INIT
block around the ``tmask_bad`` kernel) or any mix of the two, or the
whole loop as one ``cuda_ops.detect_mega`` launch (``mega``, where
``cuda_ops.mega_fits`` takes the batch's shape; else the round loop runs).
After INIT a round runs one of three routes, as FIREBIRD_FUSED_FIT selects them
(:func:`fused_mode`): the separate monitor / close / refit steps (0, the
default), the close and refit as one ``cuda_ops.fused_fit_close`` launch
(1), or the whole post-INIT round as one ``cuda_ops.fused_round`` launch
("mon").  Active-lane compaction (FIREBIRD_COMPACT, on by default as in
the JAX package; :func:`compact_mode`) permutes the per-pixel state so the
working pixels form a dense prefix and finishes the long tail in a narrower
bucketed loop (:class:`BatchLoop`); it applies to every route but mega and
leaves the results unchanged.  Mixed precision (FIREBIRD_MIXED_PRECISION,
off by default; :func:`use_mixed_precision`) runs the Gram and
correlations of every fit made by a fitting kernel (``lasso_fit``,
``init_window``, ``fused_fit_close``, ``fused_round``, ``detect_mega``) as
split bf16 dots with f32 accumulation, as the JAX package's Pallas fit
routes do; the component route's PyTorch Gram stays f32, as JAX's XLA
Gram does (:func:`pallas_components`).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import os
import types

import numpy as np
import torch

from firebird_tpu_torch.ccd import cuda_ops, harmonic, params
from firebird_tpu_torch.ccd.compact import (PIXEL_KEYS, compact_state,
                                            paid_lanes, pixel_axis,
                                            slice_pixels, unpermute)
from firebird_tpu_torch.ccd.primitives import (coefmask_for, dedup_first,
                                               fdiv, first_at_or_after,
                                               last_true, masked_median,
                                               take_t, variogram)
from firebird_tpu_torch.ccd.round_state import (PHASE_DONE, PHASE_INIT,
                                                 PHASE_MONITOR, init_zeros,
                                                 next_state)
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, chi2_thresholds

log = logging.getLogger(__name__)

MAX_SEGMENTS = 10

PROC_STANDARD, PROC_SNOW, PROC_INSUF, PROC_NODATA = 0, 1, 2, 3


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


# The JAX package's knob for the fused round routes.
FUSED_ENV = "FIREBIRD_FUSED_FIT"


def fused_mode(fused=None):
    """The round route: 0 (monitor, close and refit as separate steps), 1
    (close and refit as one ``fused_fit_close`` launch, byte-identical to
    0) or "mon" (the whole post-INIT round as one ``fused_round`` launch;
    decision-exact, with seg_mag inside the f32 envelope) —
    kernel.fused_mode and its ``fused=`` resolution.  ``None`` reads
    FIREBIRD_FUSED_FIT ("" or "0" -> 0, "mon" or "2" -> "mon", any other
    value -> 1); an explicit value maps "mon" and 2 to "mon", other true
    values to 1, false ones to 0."""
    if fused is None:
        v = os.environ.get(FUSED_ENV, "")
        if v in ("", "0"):
            return 0
        return "mon" if v in ("2", "mon") else 1
    if fused in ("mon", 2):
        return "mon"
    return 1 if fused else 0


# The JAX package's knob for the mixed-precision Gram.
MIXED_ENV = "FIREBIRD_MIXED_PRECISION"


def use_mixed_precision() -> bool:
    """Whether the fitting kernels take the mixed-precision Gram:
    FIREBIRD_MIXED_PRECISION, "" or "0" (the default) off, any other value
    on — kernel.use_mixed_precision."""
    return os.environ.get(MIXED_ENV, "") not in ("", "0")


# The JAX package's knob for the Pallas component routes, and the
# components it names.
PALLAS_ENV = "FIREBIRD_PALLAS"
COMPONENTS = ("fit", "score", "init", "lasso", "monitor", "tmask", "mega")


# The compute dtypes of the detector: float32 (the kernels' and the JAX
# package's production dtype) and float64 (the reference's, run on the plain
# versions).
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def float_dtype(dtype=None) -> torch.dtype:
    """The detector's compute dtype from ``dtype``: None means float32; a
    torch dtype or its name ("float32", "float64"); anything else raises."""
    if dtype is None:
        return torch.float32
    d = DTYPES.get(dtype, dtype) if isinstance(dtype, str) else dtype
    if d not in DTYPES.values():
        raise ValueError(f"dtype {dtype!r}: the detector computes in "
                         f"{', '.join(DTYPES)}")
    return d


def pallas_components(pallas=None, ops=None, mixed=None,
                      dtype=None) -> types.SimpleNamespace:
    """The route's functions, as FIREBIRD_PALLAS names them —
    kernel.use_pallas and its supersession rules.

    ``pallas`` (None reads FIREBIRD_PALLAS; unset means "1") is "1" (every
    per-component kernel: ``fit``, ``score`` and ``init``, which supersede
    ``lasso``, ``monitor`` and ``tmask``) or a comma list of components.
    Each of the fit, the monitor and the INIT block takes its fused kernel
    where the list names it (``fit``, ``score``, ``init``) and its
    component kernel where only that is named (``lasso``, ``monitor``,
    ``tmask``).  ``mega`` supersedes every other component and the fused
    round routes: the whole loop is one ``detect_mega`` launch after the
    prologue, whose one-shot fit stays on ``lasso_fit``.  The mega route
    carries ``fallback``, the round-loop route that a batch takes where
    ``cuda_ops.mega_fits`` refuses its shape (:class:`BatchLoop`; JAX's
    refused mega takes its loop with the components the list names
    beside ``mega``): the list's other components, and for the fit, the
    monitor or the INIT block that it leaves without one, the kernel of
    route "1" (this package has no XLA loop).  A value that
    leaves the fit, the monitor or the INIT block with no kernel ("0", "",
    or a list without either name) raises ValueError: this package has no
    XLA route, and runs plain versions only where the caller passes
    ``ops=cuda_ops.PLAIN``.

    ``mixed`` (None reads FIREBIRD_MIXED_PRECISION,
    :func:`use_mixed_precision`) binds ``mixed=True`` to the route's
    fitting kernels — kernel._detect_batch_impl's ``mixed_on``: the
    ``fit`` kernel (``lasso_fit``, which also fits the ``tmask`` route's
    INIT block and the mega route's prologue), ``init_window``,
    ``fused_fit_close``, ``fused_round`` and ``detect_mega``, and the
    refused mega route's fallback loop.  It leaves the ``lasso`` route's
    fit f32: its PyTorch Gram around ``lasso_cd`` is XLA's f32 Gram in the
    JAX package.

    ``dtype`` (:func:`float_dtype`; None means float32) is the route's
    compute dtype.  A float64 route runs the plain versions
    (:data:`cuda_ops.PLAIN`) on any device and no kernel, whatever ``ops``
    names: the JAX package's Pallas kernels are float32 only (its
    ``f32_ok`` gate, "Mosaic cannot lower float64"), so its float64 route
    is the XLA program these versions follow.  ``mixed`` is inert there,
    as JAX's ``mixed_on`` is off the float32 dtype: the route records
    ``mixed=False``.

    ``ops`` (default :data:`cuda_ops.KERNELS`) supplies the functions; a
    route this function returned comes back as it is (``pallas`` must then
    be None, ``mixed`` None or the route's, ``dtype`` None or the
    route's), so an entry point resolves the route once and hands it down.
    Returns a namespace with the round functions :class:`BatchLoop` calls
    (``lasso_fit``, ``monitor_chain_scored``, ``init_window``,
    ``fused_fit_close``, ``fused_round``; ``detect_mega`` on the mega
    route), the rebalancing ring's hop ``ring_remote_copy``, ``mega``,
    ``components`` (the resolved names), ``mixed`` and ``dtype``."""
    if hasattr(ops, "components"):
        if pallas is not None:
            raise ValueError(f"pallas={pallas!r} with a resolved route: "
                             f"pass one of the two")
        if mixed is not None and bool(mixed) != ops.mixed:
            raise ValueError(f"mixed={mixed!r} with a route resolved with "
                             f"mixed={ops.mixed}: pass one of the two")
        if dtype is not None and float_dtype(dtype) != ops.dtype:
            raise ValueError(f"dtype={dtype!r} with a route resolved with "
                             f"dtype={ops.dtype}: pass one of the two")
        return ops
    dtype = float_dtype(dtype)
    mixed = ((use_mixed_precision() if mixed is None else bool(mixed))
             and dtype == torch.float32)
    v = os.environ.get(PALLAS_ENV) if pallas is None else str(pallas)
    v = "1" if v is None else v.strip()
    if v == "1":
        names = set(COMPONENTS) - {"mega"}
    else:
        names = {c.strip() for c in v.split(",") if c.strip() not in ("", "0")}
        unknown = names - set(COMPONENTS)
        if unknown:
            raise ValueError(f"{PALLAS_ENV}={v!r}: unknown component(s) "
                             f"{sorted(unknown)}; known: {', '.join(COMPONENTS)}")
    base = cuda_ops.KERNELS if ops is None else ops
    if dtype == torch.float64:
        base = cuda_ops.PLAIN
    fits = functools.partial(_with_precision, mixed=mixed)
    if "mega" in names:
        fallback = _loop_route(names - {"mega"}, base, v, mixed, dtype,
                               default=True)
        return types.SimpleNamespace(components=("mega",), mega=True,
                                     mixed=mixed, dtype=dtype,
                                     lasso_fit=fits(base.lasso_fit),
                                     detect_mega=fits(base.detect_mega),
                                     ring_remote_copy=base.ring_remote_copy,
                                     fallback=fallback)
    return _loop_route(names, base, v, mixed, dtype)


def _with_precision(fn, mixed):
    """A fitting kernel ``fn`` with ``mixed=True`` bound where ``mixed``
    (else ``fn`` itself: the f32 route calls what it always called)."""
    return functools.partial(fn, mixed=True) if mixed else fn


def _loop_route(names, base, v, mixed, dtype,
                default=False) -> types.SimpleNamespace:
    """The round loop's route from the component ``names`` (FIREBIRD_PALLAS
    value ``v``) over the functions of ``base``: each of the fit, the
    monitor and the INIT block takes its fused kernel where named, else its
    component kernel where named, else (with ``default``) its fused
    kernel, else raises.  ``mixed`` binds to the fitting kernels
    (:func:`pallas_components`); ``dtype`` is recorded."""

    def pick(fused, component, what):
        for c in (fused, component):
            if c in names:
                return c
        if default:
            return fused
        raise ValueError(
            f"{PALLAS_ENV}={v!r} leaves the {what} without a kernel: name "
            f"{fused!r} or {component!r} (this package has no XLA route; "
            f"ops=cuda_ops.PLAIN runs the plain versions)")

    comps = (pick("fit", "lasso", "fit"), pick("score", "monitor", "monitor"),
             pick("init", "tmask", "INIT block"))
    # On the component routes the Gram and RMSE around lasso_cd, the score
    # plane before monitor_chain and the INIT block around tmask_bad are
    # PyTorch ops on the card: the JAX package computes them in XLA,
    # outside any Pallas kernel, on those routes.  They are that route's
    # program, not plain versions standing in for a kernel.
    fits = functools.partial(_with_precision, mixed=mixed)
    fit = (fits(base.lasso_fit) if comps[0] == "fit"
           else functools.partial(cuda_ops.lasso_fit_plain, cd=base.lasso_cd))
    mon = (base.monitor_chain_scored if comps[1] == "score"
           else functools.partial(cuda_ops.monitor_chain_scored_plain,
                                  chain=base.monitor_chain))
    init = (fits(base.init_window) if comps[2] == "init"
            else functools.partial(cuda_ops.init_window_plain, fit=fit,
                                   tmask=base.tmask_bad))
    return types.SimpleNamespace(
        components=comps, mega=False, mixed=mixed, dtype=dtype,
        lasso_fit=fit,
        monitor_chain_scored=mon, init_window=init,
        fused_fit_close=fits(base.fused_fit_close),
        fused_round=fits(base.fused_round),
        ring_remote_copy=base.ring_remote_copy)


# The JAX package's compaction and rebalancing knobs (config.py), with its
# defaults and clamps (params.compact_*), read at each dispatch.
COMPACT_ENV = "FIREBIRD_COMPACT"
COMPACT_EVERY_ENV = "FIREBIRD_COMPACT_EVERY"
COMPACT_MIN_LANES_ENV = "FIREBIRD_COMPACT_MIN_LANES"
COMPACT_FLOOR_ENV = "FIREBIRD_COMPACT_FLOOR"
REBALANCE_ENV = "FIREBIRD_REBALANCE"
REBALANCE_THRESHOLD_ENV = "FIREBIRD_REBALANCE_THRESHOLD"


def compact_mode(compact=None) -> bool:
    """Whether the loop compacts: an explicit value, or FIREBIRD_COMPACT
    (default "1"; "" and "0" turn it off) — params.compact_default."""
    if compact is None:
        return os.environ.get(COMPACT_ENV, "1") not in ("", "0")
    return bool(compact)


def compact_every() -> int:
    """Rounds between compaction checks (FIREBIRD_COMPACT_EVERY, default
    4, at least 1)."""
    return max(int(os.environ.get(COMPACT_EVERY_ENV, "4")), 1)


def compact_min_lanes() -> int:
    """The least pixel count that takes the bucketed tail
    (FIREBIRD_COMPACT_MIN_LANES, default 1024, at least 1)."""
    return max(int(os.environ.get(COMPACT_MIN_LANES_ENV, "1024")), 1)


def compact_floor() -> float:
    """The bucket's share of the batch width (FIREBIRD_COMPACT_FLOOR,
    default 0.125, clamped to [0, 1]; 0 turns the bucketed tail off)."""
    return min(max(float(os.environ.get(COMPACT_FLOOR_ENV, "0.125")), 0.0),
               1.0)


def tail_bucket(P: int, floor: float) -> int:
    """The stage-2 bucket: floor * P lanes rounded up to a power of two, at
    least 8 (P when ``floor`` is 0) — kernel._detect_batch_impl's."""
    if floor <= 0:
        return P
    return 1 << max(int(max(P * floor, 1) - 1).bit_length(), 3)


def rebalance_mode(rebalance=None) -> bool:
    """Whether a sharded dispatch runs the rebalancing ring: an explicit
    value, or FIREBIRD_REBALANCE (default "0")."""
    if rebalance is None:
        return os.environ.get(REBALANCE_ENV, "0") not in ("", "0")
    return bool(rebalance)


def rebalance_threshold() -> float:
    """The ring's donation threshold (FIREBIRD_REBALANCE_THRESHOLD, default
    0.25): the alive-count gap, as a share of a shard's stage-2 lanes,
    beyond which a shard sheds half the gap to its right neighbour."""
    return float(os.environ.get(REBALANCE_THRESHOLD_ENV, "0.25"))


def _exact_f32() -> None:
    # The plain versions' Gram and correlation products must run in full
    # float32: TF32 would round the matmul operands to 10 mantissa bits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# Results container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChipSegments:
    """Fixed-capacity per-pixel segment results (tensors or host arrays).

    Leading axes are [C, P] (a batch) or [P] (one chip).
    seg_meta fields: sday, eday, bday, chprob, curqa, nobs.
    seg_coef holds *internal* coefficients [.., 7 bands, 8]; convert with
    harmonic.to_pyccd_convention(anchor=first series date).
    """

    n_segments: torch.Tensor     # [.., P] int32
    seg_meta: torch.Tensor       # [.., P, S, 6] the run's float dtype
    seg_rmse: torch.Tensor       # [.., P, S, B]
    seg_mag: torch.Tensor        # [.., P, S, B]
    seg_coef: torch.Tensor       # [.., P, S, B, 8]
    mask: torch.Tensor           # [.., P, T] bool — processing mask
    procedure: torch.Tensor      # [.., P] int32
    rounds: torch.Tensor | None = None        # [..] int32 loop rounds
    vario: torch.Tensor | None = None         # [.., P, B] variogram
    round_counts: torch.Tensor | None = None  # [.., 3] int32: rounds that
    # ran the INIT block / the shared fit / the segment close
    occupancy: torch.Tensor | None = None     # [.., 2*T+8, 2] int32: per
    # round, the lanes entering it still working and the lanes the per-block
    # skip guards would pay for (paid_lanes; the full width with
    # compaction off); rows past ``rounds`` are zero; None on the mega route
    compactions: torch.Tensor | None = None   # [..] int32: the loop's
    # compactions, on each loop's first chip row (zero elsewhere: the chip
    # sum is the batch total, also when shards run loops of their own)
    lanes_migrated: torch.Tensor | None = None  # [..] int32: lanes each chip
    # donated to its right neighbour through the rebalancing ring; None
    # unless the dispatch ran with the ring on


def chip_slice(seg: ChipSegments, c: int, to_host: bool = False) -> ChipSegments:
    """One chip's view of a batched ChipSegments ([C, ...] -> [...]);
    ``to_host`` fetches the slices as numpy arrays."""
    out = []
    for f in dataclasses.fields(seg):
        v = getattr(seg, f.name)
        if v is not None:
            v = v[c]
            if to_host:
                v = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        out.append(v)
    return ChipSegments(*out)


def segments_to_numpy(seg: ChipSegments) -> ChipSegments:
    """Every field fetched to the host as a numpy array."""
    return ChipSegments(*[
        (v.cpu().numpy() if torch.is_tensor(v) else v)
        for v in (getattr(seg, f.name) for f in dataclasses.fields(seg))])


def record_first_call(key: tuple, fn):
    """The first call of each dispatch shape of a run, timed: the JAX
    package's per-shape first-call capture (its wall is the XLA compile
    there; here the kernels are built before the run, so it is the first
    batch's host wall).  Seen keys live on the metrics registry, so every
    run's report records a ``kernel_first_call_seconds`` entry per shape
    it dispatched.  Adds no synchronisation with the card."""
    import time

    from firebird_tpu_torch.obs import metrics, tracing

    reg = metrics.get_registry()
    if not reg.once(("kernel_dispatch",) + tuple(key)):
        return fn()
    t0 = time.perf_counter()
    with tracing.span("first_dispatch", key=str(key)):
        out = fn()
    reg.histogram("kernel_first_call_seconds").observe(
        time.perf_counter() - t0)
    reg.counter("kernel_dispatch_shapes").inc()
    return out


# Histogram buckets for kernel_round_active_fraction (a 0..1 fraction,
# not a latency; sixteenths resolve the tail the compaction targets).
FRACTION_BUCKETS = tuple(i / 16 for i in range(1, 17))


def record_occupancy(seg) -> dict | None:
    """Feed a host-fetched result's occupancy capture into the metrics
    registry (the stream bootstrap calls this after its bulk fetch).  Per
    executed round and chip, ``kernel_round_active_fraction`` observes
    the working lanes over the chip's lanes; the counters add the active
    and the wasted (paid - active) lane-rounds, the compactions and the
    lanes the ring migrated.  Returns the totals, or None when the result
    carries no capture (the mega route)."""
    from firebird_tpu_torch.obs import metrics as obs_metrics

    occ = getattr(seg, "occupancy", None)
    if occ is None:
        return None
    occ = np.asarray(occ)
    rds = np.asarray(seg.rounds).reshape(-1)
    C, R_max = occ.shape[0], occ.shape[1]
    lanes = int(seg.mask.shape[-2])
    r_c = rds[np.minimum(np.arange(C), rds.size - 1)].astype(np.int64)
    ran = np.arange(R_max)[None, :] < np.minimum(r_c, R_max)[:, None]
    active = int(np.where(ran, occ[..., 0], 0).sum())
    paid = int(np.where(ran, occ[..., 1], 0).sum())
    fractions = occ[..., 0][ran] / max(lanes, 1)
    obs_metrics.histogram(
        "kernel_round_active_fraction", buckets=FRACTION_BUCKETS,
        help="active-lane fraction per event-loop round per chip"
    ).observe_many(fractions)
    obs_metrics.counter(
        "kernel_active_lane_rounds",
        help="lane-rounds with a working pixel").inc(active)
    obs_metrics.counter(
        "kernel_wasted_lane_rounds",
        help="paid lane-rounds with no working pixel "
             "(effective - active)").inc(paid - active)
    out = dict(padded_lane_rounds=lanes * int(ran.sum()),
               effective_lane_rounds=paid, active_lane_rounds=active,
               wasted_lane_rounds=paid - active,
               mean_active_fraction=float(fractions.mean())
               if fractions.size else 0.0)
    comp = getattr(seg, "compactions", None)
    if comp is not None:
        out["compactions"] = int(np.asarray(comp).sum())
        obs_metrics.counter(
            "kernel_compactions",
            help="dense-prefix lane compactions").inc(out["compactions"])
    lm = getattr(seg, "lanes_migrated", None)
    if lm is not None:
        out["lanes_migrated"] = moved = int(np.asarray(lm).sum())
        obs_metrics.counter(
            "kernel_lanes_migrated",
            help="straggler lanes migrated to a neighbor device by the "
                 "rebalancing ring").inc(moved)
        if moved:
            obs_metrics.counter(
                "rebalance_migrations",
                help="dispatches in which the rebalancing ring moved "
                     "lanes").inc()
    return out


# ---------------------------------------------------------------------------
# Host-side batch preparation
# ---------------------------------------------------------------------------

def window_cap(packed) -> int:
    """A rigorous bound on initialization-window member count: a window
    closes on MEOW_SIZE members or on the INIT_DAYS span, so the densest
    INIT_DAYS stretch of the chip-shared date grid plus one bounds it.
    Rounded up to a multiple of 8."""
    cap = params.MEOW_SIZE
    for c in range(packed.n_chips):
        d = np.asarray(packed.dates[c][: int(packed.n_obs[c])], np.int64)
        if d.size:
            hi = np.searchsorted(d, d + params.INIT_DAYS, side="right")
            cap = max(cap, int((hi - np.arange(d.size)).max()) + 1)
    T = packed.spectra.shape[-1]
    return min(-8 * (-cap // 8), T)


def capacity_bound(packed) -> int:
    """An upper bound on segments any pixel can close: closed segments
    hold disjoint sets of at least MEOW_SIZE observations."""
    T = packed.spectra.shape[-1]
    return max(T // params.MEOW_SIZE, 1)


def capacity_retry(dispatch, read_worst, S: int, bound: int):
    """Run ``dispatch(S)``; while some pixel closed more segments than S
    (``read_worst``), double S (capped at ``bound``) and run again."""
    S = max(S, 1)
    while True:
        seg = dispatch(S)
        if S >= bound:
            return seg
        worst = read_worst(seg)
        if worst <= S:
            return seg
        log.info("segment capacity %d overflowed (deepest pixel closed %d); "
                 "re-dispatching at %d", S, worst, min(2 * S, bound))
        S = min(2 * S, bound)


def working_set_bytes(T: int, S: int = MAX_SEGMENTS, sensor=LANDSAT_ARD,
                      dtype_bytes: int = 4) -> int:
    """Estimated peak device bytes of one chip in a :func:`detect_packed`
    dispatch, counted from the tensors this package's round loop holds:

    - the staged wire (int16 spectra, uint8 QA, int32 days);
    - the residents: the [B,T,P] int16 spectra, their detection bands and
      the int32 QA plane;
    - the result buffers (meta, rmse, mag, coef) at ``S`` slots, twice (a
      compaction gathers a copy);
    - the larger of the prologue's temporaries (the spectra widened to
      the run's dtype for the variogram, a band's differences and sort
      with its int64 indices, some twenty bool and byte planes) and a
      round's (the alive / included / window / include / remove planes,
      the fit weights, and a compaction's copy of the residents).

    At T=768 this counts 1.0 GB a Landsat chip in float32.  chip_smoke.py's
    driver phase prints the card's peak beside it: with batches in flight,
    the peak is a batch's count plus the next batch's staged wire and the
    results awaiting their drain (:func:`result_bytes`).
    """
    P, B, K = sensor.pixels, sensor.n_bands, params.MAX_COEFS
    nb = len(sensor.detection_bands)
    f = dtype_bytes
    wire = P * T * (2 * B + 1) + 4 * T
    resident = P * T * (2 * B + 2 * nb + 4)
    bufs = 2 * P * S * (6 + 2 * B + B * K) * f
    prologue = P * T * (f * (B + 6) + 8 + 20)
    rounds = P * T * (8 + f + 2 * B + 2 * nb)
    return int(wire + resident + bufs + max(prologue, rounds))


def result_bytes(T: int, S: int = MAX_SEGMENTS, sensor=LANDSAT_ARD,
                 dtype_bytes: int = 4) -> int:
    """Device bytes one chip's ChipSegments pins until its drain: the
    result buffers at ``S`` slots, the [P,T] mask, the variogram and the
    per-pixel ints."""
    P, B, K = sensor.pixels, sensor.n_bands, params.MAX_COEFS
    per_px = S * (6 + 2 * B + B * K) * dtype_bytes
    per_px += T + B * dtype_bytes + 2 * 4
    return int(P * per_px)


def wire_args(packed) -> tuple:
    """The all-integer wire of a PackedChips batch (numpy): day ordinals
    int32 [C,T], n_obs int32 [C], spectra int16 [C,B,P,T], QA uint8
    [C,P,T] (the QA triage reads bits 0-5 only)."""
    return (np.asarray(packed.dates, np.int32),
            np.asarray(packed.n_obs, np.int32),
            np.asarray(packed.spectra, np.int16),
            np.asarray(packed.qas).astype(np.uint8))


def stage_packed(packed, device=None, dtype=None) -> tuple:
    """Host -> device copy of the wire tuple.  The wire is integer in every
    compute dtype: ``dtype`` (:func:`float_dtype`) is only checked."""
    float_dtype(dtype)
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in wire_args(packed))


def device_designs(days, n_obs, dtype=torch.float32):
    """The harmonic design matrices, built on the device from the int32
    wire — kernel.device_designs.

    ``days`` [C,T] int32 (0 past ``n_obs``) -> (X [C,T,8], Xt [C,T,5],
    t [C,T] ``dtype``, valid [C,T] bool).  The phase uses the exact integer
    reduction ``t mod 365.25 == ((4t) mod 1461) / 4``, so its argument is
    exact in either dtype; only the trig runs in ``dtype``."""
    C, T = days.shape
    dev = days.device
    days = days.to(torch.int32)
    valid = torch.arange(T, device=dev)[None, :] < n_obs[:, None]
    quarter = torch.remainder(4 * days, 1461)
    omega = torch.tensor(params.OMEGA, dtype=dtype, device=dev)
    ph = omega * (quarter.to(dtype) * 0.25)
    anchor = torch.where(n_obs > 0, days[:, 0], torch.zeros_like(n_obs))
    yr = fdiv((days - anchor[:, None]).to(dtype), 365.25)
    one = torch.ones_like(yr)
    c1, s1 = torch.cos(ph), torch.sin(ph)
    c2, s2 = torch.cos(2 * ph), torch.sin(2 * ph)
    c3, s3 = torch.cos(3 * ph), torch.sin(3 * ph)
    X = torch.stack([one, yr, c1, s1, c2, s2, c3, s3], -1)
    Xt = torch.stack([one, c1, s1, c2, s2], -1)
    X = torch.where(valid[..., None], X, torch.zeros_like(X))
    Xt = torch.where(valid[..., None], Xt, torch.zeros_like(Xt))
    return X.contiguous(), Xt.contiguous(), days.to(dtype), valid


# ---------------------------------------------------------------------------
# The detector's blocks (all chips at once)
# ---------------------------------------------------------------------------

def _qa_bit(qa, bit):
    return ((qa >> bit) & 1) == 1


def _prologue(X, Xt, t, valid, Yt, qa, *, sensor, S, variogram_mode, ops):
    """Pre-loop work for all chips: QA triage, usable sets, the one-shot
    snow / insufficient-clear fit, variogram and the standard procedure's
    start state — kernel._prologue in its wire-resident form.

    ``Yt`` [C,B,T,P] int16, ``qa`` [C,T,P]; the designs' dtype is the
    run's.  Returns (res, state)."""
    C, B, T, P = Yt.shape
    dev = Yt.device
    fdt = X.dtype
    det = list(sensor.detection_bands)
    Yd = Yt[:, det].contiguous()                                # [C,nb,T,P]
    res = dict(X=X, Xt=Xt, t=t, Yt=Yt, Yd=Yd)

    # ---------------- QA triage ----------------
    fill = _qa_bit(qa, params.QA_FILL_BIT) | ~valid[:, :, None]
    clear = ((_qa_bit(qa, params.QA_CLEAR_BIT) | _qa_bit(qa, params.QA_WATER_BIT))
             & ~fill)
    snow = _qa_bit(qa, params.QA_SNOW_BIT) & ~fill
    n_nonfill = (~fill).sum(1)
    n_clear = clear.sum(1)
    n_snow = snow.sum(1)
    clear_pct = n_clear.to(fdt) / n_nonfill.clamp_min(1).to(fdt)
    snow_pct = n_snow.to(fdt) / (n_clear + n_snow).clamp_min(1).to(fdt)

    rng_ok = torch.ones(C, T, P, dtype=torch.bool, device=dev)
    for b in sensor.optical_bands:
        rng_ok &= (Yt[:, b] > params.OPTICAL_MIN) & (Yt[:, b] < params.OPTICAL_MAX)
    for b in sensor.thermal_bands:
        rng_ok &= (Yt[:, b] > params.THERMAL_MIN) & (Yt[:, b] < params.THERMAL_MAX)

    procedure = torch.where(
        n_nonfill == 0, PROC_NODATA,
        torch.where(clear_pct >= params.CLEAR_PCT_THRESHOLD, PROC_STANDARD,
                    torch.where(snow_pct > params.SNOW_PCT_THRESHOLD,
                                PROC_SNOW, PROC_INSUF))).to(torch.int32)

    same_prev = torch.cat([torch.zeros(C, 1, dtype=torch.bool, device=dev),
                           t[:, 1:] == t[:, :-1]], 1)
    usable_std = dedup_first(clear & rng_ok, same_prev)
    usable_snow = dedup_first((clear | snow) & rng_ok, same_prev)
    cand_ins = ~fill & rng_ok
    yblue = Yt[:, sensor.blue_band].to(fdt)
    blue_med = masked_median(yblue, cand_ins, dim=1)
    cand_ins = cand_ins & (yblue < blue_med[:, None, :]
                           + params.INSUF_CLEAR_BLUE_DELTA)
    usable_ins = dedup_first(cand_ins, same_prev)

    # ---------------- result buffers ----------------
    nseg0 = torch.zeros(C, P, dtype=torch.int32, device=dev)
    bufs = (torch.zeros(C, P, S, 6, dtype=fdt, device=dev),
            torch.zeros(C, P, S, B, dtype=fdt, device=dev),
            torch.zeros(C, P, S, B, dtype=fdt, device=dev),
            torch.zeros(C, P, S, B, params.MAX_COEFS, dtype=fdt, device=dev))

    # ---------------- snow / insufficient-clear: one fit ----------------
    is_snow = procedure == PROC_SNOW
    alt_usable = torch.where(is_snow[:, None, :], usable_snow, usable_ins)
    is_alt = is_snow | (procedure == PROC_INSUF)
    alt_n = alt_usable.sum(1)
    alt_fit = is_alt & (alt_n >= params.MEOW_SIZE)
    alt_mask = alt_usable & alt_fit[:, None, :]
    alt_coefs, alt_rmse = ops.lasso_fit(Yt, alt_mask.to(fdt), X,
                                        coefmask_for(alt_n), with_rmse=True)
    _, first_i = first_at_or_after(alt_usable, torch.zeros_like(alt_n))
    last_i = last_true(alt_usable)
    alt_meta = torch.stack([
        take_t(t, first_i), take_t(t, last_i), take_t(t, last_i),
        torch.zeros(C, P, dtype=fdt, device=dev),
        torch.where(is_snow, float(params.CURVE_QA_PERSIST_SNOW),
                    float(params.CURVE_QA_INSUF_CLEAR)).to(fdt),
        alt_n.to(fdt)], -1)
    bufs, nseg = cuda_ops.write_slot(
        bufs, nseg0, alt_fit,
        (alt_meta, alt_rmse, torch.zeros(C, P, B, dtype=fdt, device=dev),
         alt_coefs))

    # ---------------- standard procedure state ----------------
    is_std = procedure == PROC_STANDARD
    alive0 = usable_std & is_std[:, None, :]
    vario = variogram(Yt.to(fdt), alive0, t,
                      adjusted=(variogram_mode == "adjusted")).contiguous()
    ex0, i0 = first_at_or_after(alive0, torch.zeros_like(alt_n))
    phase0 = torch.where(is_std & ex0, PHASE_INIT, PHASE_DONE).to(torch.int32)

    res.update(vario=vario, is_std=is_std, is_alt=is_alt, alt_mask=alt_mask,
               procedure=procedure)
    state = dict(
        phase=phase0, cur_i=i0.to(torch.int32),
        cur_k=torch.zeros(C, P, dtype=torch.int32, device=dev),
        alive=alive0,
        included=torch.zeros(C, T, P, dtype=torch.bool, device=dev),
        coefs=torch.zeros(C, P, B, params.MAX_COEFS, dtype=fdt, device=dev),
        rmse=torch.ones(C, P, B, dtype=fdt, device=dev),
        n_last_fit=torch.ones(C, P, dtype=torch.int32, device=dev),
        first_seg=torch.ones(C, P, dtype=torch.bool, device=dev),
        nseg=nseg, bufs=bufs)
    return res, state


def _mon_block(res, st, *, sensor, change_thr, outlier_thr, ops):
    """The MONITOR block: score and event chain, then the include/remove
    updates of the monitoring pixels — kernel._mon_block."""
    det = list(sensor.detection_bands)
    alive, included = st["alive"], st["included"]
    in_mon = st["phase"] == PHASE_MONITOR
    dden = torch.maximum(st["rmse"], res["vario"])[:, :, det].contiguous()
    mon = ops.monitor_chain_scored(
        res["Yd"], st["coefs"][:, :, det].contiguous(), dden, res["X"], alive,
        included, st["cur_k"], st["n_last_fit"], in_mon,
        change_thr=change_thr, outlier_thr=outlier_thr)
    inc_abs = mon["inc_q"] & in_mon[:, None, :]
    rem_abs = mon["rem_q"] & in_mon[:, None, :]
    return dict(mon, included_mon=included | inc_abs,
                alive_mon=alive & ~rem_abs)


def _mon_zeros(st):
    zb = torch.zeros_like(st["cur_i"], dtype=torch.bool)
    zi = torch.zeros_like(st["cur_i"])
    return dict(m=zi, is_tail=zb, is_brk=zb, is_refit=zb, ev_rank=zi,
                pos_ev=zi, n_exceed=zi, n_rf=zi,
                included_mon=st["included"], alive_mon=st["alive"])


def _close_mags(res, st, mon):
    """Break magnitudes: the median full-band residual over the PEEK_SIZE
    run at the break — kernel._close_mags (cuda_ops.peek_run_mags)."""
    return cuda_ops.peek_run_mags(res["Yt"], res["X"], st["alive"],
                                  st["coefs"], mon["ev_rank"], mon["m"])


def _close_block(res, st, mon):
    """Segment close: break magnitudes and the segment row write for the
    pixels whose monitoring ended in a tail or a break —
    kernel._close_block."""
    is_tail, is_brk = mon["is_tail"], mon["is_brk"]
    mags = _close_mags(res, st, mon)
    meta_new = cuda_ops.close_meta(res["t"], mon["included_mon"], is_brk,
                                   mon["pos_ev"], mon["n_exceed"],
                                   st["first_seg"])
    mag_new = torch.where(is_brk[..., None], mags, torch.zeros_like(mags))
    return cuda_ops.write_slot(st["bufs"], st["nseg"], is_tail | is_brk,
                               (meta_new, st["rmse"], mag_new, st["coefs"]))


def _round_zeros(st):
    """fused_round's outputs on a round where no pixel monitors or
    initialized: state passed through, no events (kernel._skip_round)."""
    zb = torch.zeros_like(st["cur_i"], dtype=torch.bool)
    zi = torch.zeros_like(st["cur_i"])
    return (st["bufs"], st["nseg"], st["coefs"], st["rmse"],
            dict(is_tail=zb, is_brk=zb, is_refit=zb, pos_ev=zi, do_fit=zb,
                 n_full=zi, included_mon=st["included"],
                 alive_mon=st["alive"]))


def _segments(res, nseg, bufs, alive, rounds, counts):
    """The batch's ChipSegments from the loop's final state: the
    standard procedure's processing mask is its final alive plane, the
    alternate procedures' their fit window."""
    meta_b, rmse_b, mag_b, coef_b = bufs
    is_std, is_alt = res["is_std"], res["is_alt"]
    final_mask = torch.where(
        is_std[:, None, :], alive,
        torch.where(is_alt[:, None, :], res["alt_mask"], False))
    return ChipSegments(
        n_segments=nseg, seg_meta=meta_b, seg_rmse=rmse_b, seg_mag=mag_b,
        seg_coef=coef_b, mask=final_mask.transpose(1, 2).contiguous(),
        procedure=res["procedure"], rounds=rounds, vario=res["vario"],
        round_counts=counts)


def resident_keys(fused) -> tuple:
    """The per-pixel residents a round reads, carried in the loop state and
    permuted with it (kernel._detect_batch_impl's ``resp_keys``): the
    variogram and the resident spectra on every route, and the
    detection-band spectra where a separate monitor reads them (every
    round route but "mon", whose fused_round reads ``Yt``).  A block
    reads the per-pixel tensors only from the carried dict, so a resident
    missing here fails with a KeyError instead of reading the unpermuted
    original."""
    return ("vario", "Yt") + (() if fused == "mon" else ("Yd",))


class BatchLoop:
    """A chip batch's event loop (every chip at once, on one device), in
    the steps that the sharded dispatch interleaves with the rebalancing
    ring — kernel._detect_batch_impl:

    - :meth:`stage1` runs the loop at the batch's full width.  With
      compaction on, every ``compact_every()`` rounds it permutes the
      per-pixel state so each chip's working lanes form a dense prefix,
      once 1/16 of the width has died since the last compaction.  With
      the bucketed tail on (compaction, a bucket narrower than the batch,
      at least ``compact_min_lanes()`` pixels), the loop ends, after a
      forced compaction, once every chip's working lanes fit the bucket,
      and :meth:`stage1` returns the stage-2 carry: each per-pixel carry's
      first ``bucket`` lanes.
    - :meth:`tail` runs the same loop over a stage-2 carry.
    - :meth:`result` merges the carry back, inverts the permutation and
      returns the ChipSegments.

    :meth:`run` takes the three steps in turn (an unsharded dispatch).

    The loop tensors' pixel axes are :func:`pixel_axis`'s.  On
    the mega route :meth:`stage1` makes the one ``detect_mega`` call and
    nothing compacts.  A mega route whose shape ``cuda_ops.mega_fits``
    refuses takes its ``fallback`` route instead, decided here before any
    launch (kernel._detect_batch_impl's mega decision): the loop then runs
    with ``fused`` and ``compact`` as given (and the route's precision),
    and the refusal is counted in ``cuda_ops.REFUSED`` and logged.

    ``ops`` is a route (:func:`pallas_components`, which resolves it here
    where given the functions themselves); ``mixed`` None keeps the
    route's precision, and a value other than the route's raises."""

    def __init__(self, X, Xt, t, valid, Yt, qa, *, W, sensor, max_segments,
                 variogram_mode, ops, fused=0, compact=False, mixed=None):
        C, B, T, P = Yt.shape
        ops = pallas_components(ops=ops, mixed=mixed)
        if ops.mega and not cuda_ops.mega_fits(T, W):
            cuda_ops.REFUSED["detect_mega"] += 1
            log.warning("detect_mega refuses T=%d, W=%d (%d bytes of shared "
                        "memory a block): the batch runs the round loop "
                        "(components %s)", T, W,
                        cuda_ops.detect_mega_smem_bytes(T),
                        ",".join(ops.fallback.components))
            ops = ops.fallback
        self.C, self.P, self.W, self.sensor = C, P, W, sensor
        self.ops, self.fused = ops, fused
        self.thr = chi2_thresholds(len(sensor.detection_bands))
        self.res, st = _prologue(X, Xt, t, valid, Yt, qa, sensor=sensor,
                                 S=max_segments,
                                 variogram_mode=variogram_mode, ops=ops)
        self.max_rounds = 2 * T + 8
        self.rounds, self.counts, self.occ = 0, [0, 0, 0], []
        self.ncomp, self.at_tail, self.mega_out = 0, False, None
        self.compact = bool(compact) and not ops.mega
        self.every = compact_every()
        self.bucket = tail_bucket(P, compact_floor() if self.compact else 0.0)
        self.cascade = (self.compact and 0 < self.bucket < P
                        and P >= compact_min_lanes())
        self.shared = {k: self.res[k] for k in ("X", "Xt", "t")}
        st["resp"] = {k: self.res[k] for k in resident_keys(fused)}
        if self.compact:
            # The running permutation (current lane -> original pixel) and
            # the alive count at the last compaction, from the full width:
            # the lanes DONE from round 0 count toward the first one.
            st["perm"] = torch.arange(P, device=Yt.device).expand(
                C, P).contiguous()
            st["base_alive"] = torch.full((C,), P, dtype=torch.int32,
                                          device=Yt.device)
        self.st = st

    # ---- the steps ----

    def run(self) -> ChipSegments:
        st2 = self.stage1()
        return self.result(None if st2 is None else self.tail(st2))

    def stage1(self):
        """The loop at full width; returns the stage-2 carry, or None when
        the bucketed tail is off (the loop then ran to its end)."""
        if self.ops.mega:
            st, res = self.st, self.res
            change_thr, outlier_thr = self.thr
            self.mega_out = self.ops.detect_mega(
                res["Yt"], st["phase"], st["cur_i"], st["alive"], st["nseg"],
                st["bufs"], res["t"], res["X"], res["Xt"], res["vario"],
                W=self.W, change_thr=change_thr, outlier_thr=outlier_thr,
                sensor=self.sensor)
            return None
        self.st = self._run(self.st, cascade_exit=self.cascade)
        if not self.cascade:
            return None
        st, b = self.st, self.bucket
        st2 = {k: slice_pixels(st[k], b, pixel_axis(k))
               for k in PIXEL_KEYS}
        st2["bufs"] = tuple(slice_pixels(x, b, 1) for x in st["bufs"])
        st2["resp"] = {k: slice_pixels(v, b, pixel_axis(k))
                       for k, v in st["resp"].items()}
        st2["perm"] = slice_pixels(st["perm"], b, 1)
        st2["base_alive"] = (st2["phase"] != PHASE_DONE).sum(
            -1, dtype=torch.int32)
        return st2

    def tail(self, st2, shared=None, pinned=False):
        """The loop over the stage-2 carry ``st2``.  The rebalancing ring
        passes its own + guest chips (``shared``: their designs) with
        ``pinned``: lane positions stay put (the ring's merge back is
        positional) and the guest chips' occupancy rows fold into their
        hosts'."""
        self.at_tail = False
        return self._run(st2, shared=shared, allow_compact=not pinned,
                         occ_fold=self.C if pinned else None)

    def result(self, st2=None) -> ChipSegments:
        """The batch's ChipSegments, with the stage-2 carry ``st2`` merged
        into the first ``bucket`` lanes and every per-pixel output back in
        original pixel order."""
        res, C, dev = self.res, self.C, self.res["t"].device
        if self.mega_out is not None:
            out = self.mega_out
            return _segments(res, out["nseg"],
                             (out["meta"], out["rmse"], out["mag"],
                              out["coef"]),
                             out["alive"], out["rounds"], out["counts"])
        st = self.st
        if st2 is not None:
            b, P = self.bucket, self.P
            merge = lambda full, part, ax: torch.cat(
                [part, full.narrow(ax % full.ndim, b, P - b)], ax)
            st = dict(st, nseg=merge(st["nseg"], st2["nseg"], 1),
                      alive=merge(st["alive"], st2["alive"], -1),
                      perm=merge(st["perm"], st2["perm"], 1),
                      bufs=tuple(merge(f, p, 1)
                                 for f, p in zip(st["bufs"], st2["bufs"])))
        nseg, bufs, alive = st["nseg"], st["bufs"], st["alive"]
        if self.compact:
            perm = st["perm"]
            nseg = unpermute(nseg, perm, 1)
            alive = unpermute(alive, perm, -1)
            bufs = tuple(unpermute(x, perm, 1) for x in bufs)
        seg = _segments(
            res, nseg, bufs, alive,
            torch.full((C,), self.rounds, dtype=torch.int32, device=dev),
            torch.tensor(self.counts, dtype=torch.int32, device=dev).expand(
                C, 3).contiguous())
        occ = torch.zeros(C, self.max_rounds, 2, dtype=torch.int32,
                          device=dev)
        if self.occ:
            occ[:, :len(self.occ)] = torch.stack(self.occ, 1)
        seg.occupancy = occ
        seg.compactions = torch.where(
            torch.arange(C, device=dev) == 0, self.ncomp, 0).to(torch.int32)
        return seg

    # ---- the loop ----

    def _run(self, st, *, shared=None, allow_compact=True, cascade_exit=False,
             occ_fold=None):
        shared = self.shared if shared is None else shared
        while (self.rounds < self.max_rounds and not self.at_tail
               and bool((st["phase"] != PHASE_DONE).any())):
            self._capture(st["phase"], occ_fold)
            st = self._round(st, dict(shared, **st["resp"]))
            if self.compact and allow_compact:
                st = self._maybe_compact(st, cascade_exit)
            self.rounds += 1
        return st

    def _capture(self, phase, fold):
        """The round's occupancy row: working lanes and paid lanes per
        chip, a rebalanced tail's guest rows folded into their hosts'."""
        active = (phase != PHASE_DONE).sum(-1, dtype=torch.int32)
        paid = (paid_lanes(phase) if self.compact
                else torch.full_like(active, phase.shape[1]))
        if fold is not None:
            active = active[:fold] + active[fold:]
            paid = paid[:fold] + paid[fold:]
        self.occ.append(torch.stack([active, paid], -1))

    def _maybe_compact(self, st, cascade_exit):
        """Compact when 1/16 of the current width died since the last
        compaction (every ``every`` rounds), or on entering the bucket;
        entering it ends stage 1."""
        check_round = (self.rounds + 1) % self.every == 0
        if not (check_round or cascade_exit):
            return st
        n_alive = (st["phase"] != PHASE_DONE).sum(-1, dtype=torch.int32)
        width = st["phase"].shape[1]
        dead, most = torch.stack([(st["base_alive"] - n_alive).max(),
                                  n_alive.max()]).tolist()
        periodic = check_round and dead >= max(width // 16, 1)
        ready = cascade_exit and most <= self.bucket
        if periodic or ready:
            st = dict(compact_state(st), base_alive=n_alive)
            self.ncomp += 1
        self.at_tail = ready
        return st

    def _round(self, st, r):
        """One round of the loop body over the state ``st``; ``r`` holds the
        designs and the carried residents.  Returns the next state."""
        ops, fused, sensor = self.ops, self.fused, self.sensor
        change_thr, outlier_thr = self.thr
        phase = st["phase"]
        in_init = phase == PHASE_INIT
        in_mon = phase == PHASE_MONITOR

        any_init = bool(in_init.any())
        if any_init:
            init = ops.init_window(st["alive"], st["cur_i"], in_init, r["t"],
                                   r["X"], r["Xt"], r["Yt"], r["vario"],
                                   W=self.W, sensor=sensor)
        else:
            init = init_zeros(st)
        init_ok = init["init_ok"]

        if fused == "mon":
            # Monitor, close and refit as one launch; INIT stays outside
            # and hands its fit window over.  The results come back
            # merged, the events in ``mon``.
            if bool((in_mon | init_ok).any()):
                bufs, nseg, coefs_n, rmse_n, mon = ops.fused_round(
                    r["Yt"], r["X"], r["t"], st["alive"], st["included"],
                    st["cur_k"], st["n_last_fit"], in_mon, st["coefs"],
                    st["rmse"], r["vario"], init_ok, init["w_stab"],
                    init["n_ok"], st["first_seg"], st["nseg"], st["bufs"],
                    change_thr=change_thr, outlier_thr=outlier_thr,
                    sensor=sensor)
            else:
                bufs, nseg, coefs_n, rmse_n, mon = _round_zeros(st)
            is_tail, is_brk = mon["is_tail"], mon["is_brk"]
            close = is_tail | is_brk
            do_fit, n_full = mon["do_fit"], mon["n_full"]
            any_close, any_fit = (bool(v) for v in torch.stack(
                [close.any(), do_fit.any()]).tolist())
        else:
            if bool(in_mon.any()):
                mon = _mon_block(r, st, sensor=sensor, change_thr=change_thr,
                                 outlier_thr=outlier_thr, ops=ops)
            else:
                mon = _mon_zeros(st)
            is_tail, is_brk = mon["is_tail"], mon["is_brk"]
            close = is_tail | is_brk
            any_close = bool(close.any())
            do_fit = init_ok | mon["is_refit"]
            any_fit = bool(do_fit.any())
            n_full = torch.where(init_ok, init["n_ok"], mon["n_rf"])
            w_fit = lambda: torch.where(
                init_ok[:, None, :], init["w_stab"],
                mon["included_mon"] & mon["is_refit"][:, None, :]).to(
                    r["X"].dtype)

        if fused == "mon":
            pass                      # merged in ops.fused_round above
        elif fused and (any_close or any_fit):
            # Close and refit as one launch.  The break magnitudes stay on
            # the program route 0 runs, so the two routes' results are
            # byte-identical.
            mags = (_close_mags(r, st, mon) if bool(is_brk.any())
                    else torch.zeros_like(st["rmse"]))
            bufs, nseg, coefs_n, rmse_n = ops.fused_fit_close(
                r["Yt"], r["X"], r["t"], w_fit(), do_fit, n_full,
                mon["included_mon"], st["coefs"], st["rmse"], mags, is_tail,
                is_brk, mon["pos_ev"], mon["n_exceed"], st["first_seg"],
                st["nseg"], st["bufs"])
        elif fused:
            bufs, nseg = st["bufs"], st["nseg"]
            coefs_n, rmse_n = st["coefs"], st["rmse"]
        else:
            if any_close:
                bufs, nseg = _close_block(r, st, mon)
            else:
                bufs, nseg = st["bufs"], st["nseg"]
            if any_fit:
                cfull, rfull = ops.lasso_fit(r["Yt"], w_fit(), r["X"],
                                             coefmask_for(n_full))
                coefs_n = torch.where(do_fit[..., None, None], cfull,
                                      st["coefs"])
                rmse_n = torch.where(do_fit[..., None], rfull, st["rmse"])
            else:
                coefs_n, rmse_n = st["coefs"], st["rmse"]

        self.counts = [self.counts[0] + any_init, self.counts[1] + any_fit,
                       self.counts[2] + any_close]
        return dict(st, **next_state(
            st, init, dict(mon, do_fit=do_fit, n_full=n_full), coefs_n,
            rmse_n, nseg, bufs))


def staged_loop(days, n_obs, spectra, qa, *, W, sensor=LANDSAT_ARD,
                max_segments=MAX_SEGMENTS,
                variogram_mode=params.VARIOGRAM_DEFAULT, ops=None,
                fused=None, pallas=None, compact=None,
                mixed=None, dtype=None) -> BatchLoop:
    """The :class:`BatchLoop` of a staged integer wire on its device:
    ``days`` [C,T] int32, ``n_obs`` [C] int32, ``spectra`` [C,B,P,T] int16,
    ``qa`` [C,P,T] uint8.  The designs are built on the device, the
    spectra are made resident as [C,B,T,P] and the prologue runs.
    ``pallas`` picks the kernels (:func:`pallas_components`, from ``ops``,
    or ``ops`` is a route it already resolved), ``fused`` the round route
    (:func:`fused_mode`), ``compact`` the compaction (:func:`compact_mode`),
    ``mixed`` the precision of the fitting kernels and ``dtype`` the compute
    dtype (:func:`pallas_components`).  Run it under ``torch.no_grad()``."""
    _exact_f32()
    ops = pallas_components(pallas, ops, mixed, dtype)
    if variogram_mode not in ("adjusted", "plain"):
        raise ValueError(f"variogram_mode {variogram_mode!r}: 'adjusted' or "
                         f"'plain'")
    X, Xt, t, valid = device_designs(days, n_obs, ops.dtype)
    Yt = spectra.transpose(2, 3).contiguous()                   # [C,B,T,P]
    qa_t = qa.transpose(1, 2).contiguous().to(torch.int32)      # [C,T,P]
    return BatchLoop(X, Xt, t, valid, Yt, qa_t, W=W, sensor=sensor,
                     max_segments=max_segments,
                     variogram_mode=variogram_mode, ops=ops,
                     fused=fused_mode(fused), compact=compact_mode(compact))


def detect_staged(days, n_obs, spectra, qa, *, W, sensor=LANDSAT_ARD,
                  max_segments=MAX_SEGMENTS,
                  variogram_mode=params.VARIOGRAM_DEFAULT, ops=None,
                  fused=None, pallas=None, compact=None, mixed=None,
                  dtype=None):
    """Detect from the staged integer wire on its device (the arguments
    of :func:`staged_loop`) -> ChipSegments."""
    with torch.no_grad():
        return staged_loop(days, n_obs, spectra, qa, W=W, sensor=sensor,
                           max_segments=max_segments,
                           variogram_mode=variogram_mode, ops=ops,
                           fused=fused, pallas=pallas, compact=compact,
                           mixed=mixed, dtype=dtype).run()


def detect_packed(packed, *, device=None, max_segments: int = MAX_SEGMENTS,
                  check_capacity: bool = True, staged: tuple | None = None,
                  variogram_mode: str = params.VARIOGRAM_DEFAULT,
                  ops=None, fused=None, pallas=None, compact=None,
                  mixed=None, dtype=None) -> ChipSegments:
    """Run the detector over a PackedChips batch -> ChipSegments with
    leading chip axis [C, P, ...], on ``device`` (default CUDA).

    The segment buffers start at ``max_segments``; when some pixel closes
    more segments than that, the batch runs again with doubled capacity
    (``check_capacity=False`` skips the check).  ``staged`` takes the
    device wire tuple of :func:`stage_packed`.  ``variogram_mode`` is
    "adjusted" (default) or "plain".  ``ops`` supplies the functions:
    :data:`cuda_ops.KERNELS` (default; the CUDA kernels on a CUDA device,
    their plain versions on the CPU) or :data:`cuda_ops.PLAIN` (the plain
    versions wherever the tensors are).  ``pallas`` picks the kernels of
    the route: None defers to FIREBIRD_PALLAS (unset: "1", the
    ``fit,score,init`` route), else "1", a component list or "mega"
    (:func:`pallas_components`; ``ops`` may be a route it resolved).
    ``fused`` picks the round route: None defers to FIREBIRD_FUSED_FIT
    (unset: route 0), else 0, 1 or "mon" (:func:`fused_mode`); the mega
    route has none.  ``compact`` turns active-lane compaction on or off:
    None defers to FIREBIRD_COMPACT (unset: on; :func:`compact_mode`);
    the mega route never compacts.  ``mixed`` turns the fitting kernels'
    mixed-precision Gram on or off: None defers to
    FIREBIRD_MIXED_PRECISION (unset: off; :func:`use_mixed_precision`), or
    to the route's where ``ops`` is a resolved route.  ``dtype`` is the
    compute dtype: float32 (None, the default, or the resolved route's) or
    float64, which runs the plain versions and no kernel, and takes no
    mixed precision (:func:`pallas_components`).  The result's floats are
    in that dtype."""
    dev = resolve_device(device)
    route = pallas_components(pallas, ops, mixed, dtype)  # refuses a bad route
    args = staged if staged is not None else stage_packed(packed, dev)
    sensor = getattr(packed, "sensor", LANDSAT_ARD)
    W = window_cap(packed)
    fused, compact = fused_mode(fused), compact_mode(compact)
    dispatch = lambda S: record_first_call(
        ("single", tuple(packed.spectra.shape), str(route.dtype), W,
         sensor.name, S, compact, fused, route.mixed),
        lambda: detect_staged(*args, W=W, sensor=sensor, max_segments=S,
                              variogram_mode=variogram_mode, ops=route,
                              fused=fused, compact=compact))
    if not check_capacity:
        return dispatch(max(max_segments, 1))
    return capacity_retry(dispatch, lambda seg: int(seg.n_segments.max()),
                          max_segments, capacity_bound(packed))


# ---------------------------------------------------------------------------
# Int-coded egress
# ---------------------------------------------------------------------------

def egress_bucket(worst: int, S: int) -> int:
    """The packed egress segment depth: the deepest pixel's close count
    rounded up to a power of two, capped at the capacity ``S``."""
    w = max(int(worst), 1)
    return min(1 << (w - 1).bit_length(), S)


def packbits(mask):
    """numpy.packbits along the last axis (big-endian bit order) of a
    bool tensor, on its device: [..., T] -> [..., ceil(T/8)] uint8."""
    T = mask.shape[-1]
    pad = -T % 8
    m = torch.nn.functional.pad(mask.to(torch.uint8), (0, pad))
    m = m.reshape(*mask.shape[:-1], (T + pad) // 8, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=mask.device)
    return (m * weights).sum(-1, dtype=torch.uint8)


# The integer result fields that pass through the egress as they are.
EGRESS_INTS = ("rounds", "round_counts", "occupancy", "compactions",
               "lanes_migrated")


def pack_egress(seg: ChipSegments, s_eff: int) -> dict:
    """Device-side egress packing of a batched float32 ChipSegments —
    kernel.pack_egress: integer meta columns rint-coded (chprob coded as
    ``rint(chprob * PEEK_SIZE)``), float planes bitcast to int32, the mask
    bitpacked along T, segment planes cut to ``s_eff`` slots.  A float64
    result has no int coding (JAX's egress is float32 only): it raises."""
    if seg.seg_meta.dtype != torch.float32:
        raise TypeError(f"pack_egress codes float32 results; this one is "
                        f"{seg.seg_meta.dtype} (fetch it raw)")
    sl = lambda a: a[:, :, :s_eff].contiguous()
    bc = lambda a: a.contiguous().view(torch.int32)
    meta = sl(seg.seg_meta)
    meta_i = torch.round(meta).to(torch.int32)
    meta_i[..., 3] = torch.round(meta[..., 3] * params.PEEK_SIZE).to(torch.int32)
    out = dict(n_segments=seg.n_segments, procedure=seg.procedure,
               meta=meta_i, rmse=bc(sl(seg.seg_rmse)), mag=bc(sl(seg.seg_mag)),
               coef=bc(sl(seg.seg_coef)), mask=packbits(seg.mask))
    for f in EGRESS_INTS:
        v = getattr(seg, f)
        if v is not None:
            out[f] = v
    if seg.vario is not None:
        out["vario"] = bc(seg.vario)
    return out


def segments_to_records(seg: ChipSegments, dates: np.ndarray, pixel: int,
                        sensor=LANDSAT_ARD) -> dict:
    """One pixel's result as the pyccd result dict (change_models +
    processing_mask).  ``seg`` is single-chip ([P, ...]) host arrays."""
    anchor = float(dates[0]) if len(dates) else 0.0
    n = min(int(seg.n_segments[pixel]), seg.seg_meta.shape[-2])
    models = []
    for k in range(n):
        meta = np.asarray(seg.seg_meta[pixel, k], np.float64)
        coefs = np.asarray(seg.seg_coef[pixel, k], np.float64)
        coefs7, intercept = harmonic.to_pyccd_convention(coefs, anchor)
        rec = {
            "start_day": int(round(meta[0])), "end_day": int(round(meta[1])),
            "break_day": int(round(meta[2])),
            "observation_count": int(round(meta[5])),
            "change_probability": float(meta[3]),
            "curve_qa": int(round(meta[4])),
        }
        for b, name in enumerate(sensor.band_names):
            rec[name] = {
                "magnitude": float(seg.seg_mag[pixel, k, b]),
                "rmse": float(seg.seg_rmse[pixel, k, b]),
                "coefficients": tuple(float(x) for x in coefs7[b]),
                "intercept": float(intercept[b]),
            }
        models.append(rec)
    T = len(dates)
    return {"change_models": models,
            "processing_mask": [int(x) for x in np.asarray(seg.mask[pixel][:T])],
            "procedure": ["standard", "permanent-snow", "insufficient-clear",
                          "no-data"][int(seg.procedure[pixel])]}

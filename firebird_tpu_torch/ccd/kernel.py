"""The CCDC change detector over whole chips, in PyTorch.

The counterpart of ``firebird_tpu/ccd/kernel.py`` on its wire-resident
per-component route: every pixel of every chip of a batch runs in
lockstep through an event-horizon loop.  Each round advances every pixel
to its next model event:

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
(``[C,P,...]``, mask ``[C,P,T]``).  After INIT a round runs one of three
routes, as the JAX package's FIREBIRD_FUSED_FIT selects them
(:func:`fused_mode`): the separate monitor / close / refit steps above
(0, the default), the close and refit as one ``cuda_ops.fused_fit_close``
launch (1), or the whole post-INIT round as one ``cuda_ops.fused_round``
launch ("mon").  Compaction and mixed precision are not part of this
package; its results equal the JAX package's with compaction off, which
are row-identical to compaction on.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from firebird_tpu_torch.ccd import cuda_ops, harmonic, params
from firebird_tpu_torch.ccd.primitives import (coefmask_for, dedup_first,
                                               fdiv, first_at_or_after,
                                               last_true, masked_median,
                                               take_t, variogram)
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, chi2_thresholds

log = logging.getLogger(__name__)

MAX_SEGMENTS = 10

PHASE_INIT, PHASE_MONITOR, PHASE_DONE = 0, 1, 2
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
    seg_meta: torch.Tensor       # [.., P, S, 6] float32
    seg_rmse: torch.Tensor       # [.., P, S, B]
    seg_mag: torch.Tensor        # [.., P, S, B]
    seg_coef: torch.Tensor       # [.., P, S, B, 8]
    mask: torch.Tensor           # [.., P, T] bool — processing mask
    procedure: torch.Tensor      # [.., P] int32
    rounds: torch.Tensor | None = None        # [..] int32 loop rounds
    vario: torch.Tensor | None = None         # [.., P, B] variogram
    round_counts: torch.Tensor | None = None  # [.., 3] int32: rounds that
    # ran the INIT block / the shared fit / the segment close


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


def wire_args(packed) -> tuple:
    """The all-integer wire of a PackedChips batch (numpy): day ordinals
    int32 [C,T], n_obs int32 [C], spectra int16 [C,B,P,T], QA uint8
    [C,P,T] (the QA triage reads bits 0-5 only)."""
    return (np.asarray(packed.dates, np.int32),
            np.asarray(packed.n_obs, np.int32),
            np.asarray(packed.spectra, np.int16),
            np.asarray(packed.qas).astype(np.uint8))


def stage_packed(packed, device=None) -> tuple:
    """Host -> device copy of the wire tuple."""
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in wire_args(packed))


def device_designs(days, n_obs):
    """The harmonic design matrices, built on the device from the int32
    wire — kernel.device_designs.

    ``days`` [C,T] int32 (0 past ``n_obs``) -> (X [C,T,8], Xt [C,T,5],
    t [C,T] float32, valid [C,T] bool).  The phase uses the exact integer
    reduction ``t mod 365.25 == ((4t) mod 1461) / 4``; only the trig runs
    in float32."""
    C, T = days.shape
    dev = days.device
    days = days.to(torch.int32)
    valid = torch.arange(T, device=dev)[None, :] < n_obs[:, None]
    quarter = torch.remainder(4 * days, 1461)
    omega = torch.tensor(params.OMEGA, dtype=torch.float32, device=dev)
    ph = omega * (quarter.float() * 0.25)
    anchor = torch.where(n_obs > 0, days[:, 0], torch.zeros_like(n_obs))
    yr = fdiv((days - anchor[:, None]).float(), 365.25)
    one = torch.ones_like(yr)
    c1, s1 = torch.cos(ph), torch.sin(ph)
    c2, s2 = torch.cos(2 * ph), torch.sin(2 * ph)
    c3, s3 = torch.cos(3 * ph), torch.sin(3 * ph)
    X = torch.stack([one, yr, c1, s1, c2, s2, c3, s3], -1)
    Xt = torch.stack([one, c1, s1, c2, s2], -1)
    X = torch.where(valid[..., None], X, torch.zeros_like(X))
    Xt = torch.where(valid[..., None], Xt, torch.zeros_like(Xt))
    return X.contiguous(), Xt.contiguous(), days.float(), valid


# ---------------------------------------------------------------------------
# The detector's blocks (all chips at once)
# ---------------------------------------------------------------------------

def _qa_bit(qa, bit):
    return ((qa >> bit) & 1) == 1


def _prologue(X, Xt, t, valid, Yt, qa, *, sensor, S, variogram_mode, ops):
    """Pre-loop work for all chips: QA triage, usable sets, the one-shot
    snow / insufficient-clear fit, variogram and the standard procedure's
    start state — kernel._prologue in its wire-resident form.

    ``Yt`` [C,B,T,P] int16, ``qa`` [C,T,P].  Returns (res, state)."""
    C, B, T, P = Yt.shape
    dev = Yt.device
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
    clear_pct = n_clear / n_nonfill.clamp_min(1)
    snow_pct = n_snow / (n_clear + n_snow).clamp_min(1)

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
    yblue = Yt[:, sensor.blue_band].float()
    blue_med = masked_median(yblue, cand_ins, dim=1)
    cand_ins = cand_ins & (yblue < blue_med[:, None, :]
                           + params.INSUF_CLEAR_BLUE_DELTA)
    usable_ins = dedup_first(cand_ins, same_prev)

    # ---------------- result buffers ----------------
    f32 = torch.float32
    nseg0 = torch.zeros(C, P, dtype=torch.int32, device=dev)
    bufs = (torch.zeros(C, P, S, 6, dtype=f32, device=dev),
            torch.zeros(C, P, S, B, dtype=f32, device=dev),
            torch.zeros(C, P, S, B, dtype=f32, device=dev),
            torch.zeros(C, P, S, B, params.MAX_COEFS, dtype=f32, device=dev))

    # ---------------- snow / insufficient-clear: one fit ----------------
    is_snow = procedure == PROC_SNOW
    alt_usable = torch.where(is_snow[:, None, :], usable_snow, usable_ins)
    is_alt = is_snow | (procedure == PROC_INSUF)
    alt_n = alt_usable.sum(1)
    alt_fit = is_alt & (alt_n >= params.MEOW_SIZE)
    alt_mask = alt_usable & alt_fit[:, None, :]
    alt_coefs, alt_rmse = ops.lasso_fit(Yt, alt_mask.float(), X,
                                        coefmask_for(alt_n), with_rmse=True)
    _, first_i = first_at_or_after(alt_usable, torch.zeros_like(alt_n))
    last_i = last_true(alt_usable)
    alt_meta = torch.stack([
        take_t(t, first_i), take_t(t, last_i), take_t(t, last_i),
        torch.zeros(C, P, dtype=f32, device=dev),
        torch.where(is_snow, float(params.CURVE_QA_PERSIST_SNOW),
                    float(params.CURVE_QA_INSUF_CLEAR)).to(f32),
        alt_n.to(f32)], -1)
    bufs, nseg = cuda_ops.write_slot(
        bufs, nseg0, alt_fit,
        (alt_meta, alt_rmse, torch.zeros(C, P, B, dtype=f32, device=dev),
         alt_coefs))

    # ---------------- standard procedure state ----------------
    is_std = procedure == PROC_STANDARD
    alive0 = usable_std & is_std[:, None, :]
    vario = variogram(Yt.float(), alive0, t,
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
        coefs=torch.zeros(C, P, B, params.MAX_COEFS, dtype=f32, device=dev),
        rmse=torch.ones(C, P, B, dtype=f32, device=dev),
        n_last_fit=torch.ones(C, P, dtype=torch.int32, device=dev),
        first_seg=torch.ones(C, P, dtype=torch.bool, device=dev),
        nseg=nseg, bufs=bufs)
    return res, state


def _init_zeros(st):
    """The INIT block's outputs on a round where no pixel initializes
    (every consumer masks on in_init-derived flags)."""
    zb = torch.zeros_like(st["cur_i"], dtype=torch.bool)
    zi = torch.zeros_like(st["cur_i"])
    return dict(init_nowin=zb, init_tm=zb, init_ok=zb, init_bad=zb,
                has_adv=zb, i_next_tm=zi, i_adv=zi, j=zi,
                w_stab=torch.zeros_like(st["alive"]), n_ok=zi,
                alive_init=st["alive"])


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


def _detect_batch(X, Xt, t, valid, Yt, qa, *, W, sensor, max_segments,
                  variogram_mode, ops, fused=0):
    """A chip batch: designs [C,T,*], resident spectra ``Yt`` [C,B,T,P]
    int16, ``qa`` [C,T,P] -> ChipSegments with [C, ...] leading axes —
    kernel._detect_batch_impl with compaction and mixed precision left
    out.  ``fused`` picks what runs after INIT (see :func:`fused_mode`):
    0 the monitor, close and refit as separate steps, 1 the close and
    refit as one ``ops.fused_fit_close`` call, "mon" the whole post-INIT
    round as one ``ops.fused_round`` call."""
    C, B, T, P = Yt.shape
    det = list(sensor.detection_bands)
    change_thr, outlier_thr = chi2_thresholds(len(det))
    res, st = _prologue(X, Xt, t, valid, Yt, qa, sensor=sensor,
                        S=max_segments, variogram_mode=variogram_mode,
                        ops=ops)
    max_rounds = 2 * T + 8
    rounds = 0
    counts = [0, 0, 0]
    while rounds < max_rounds and bool((st["phase"] != PHASE_DONE).any()):
        phase = st["phase"]
        in_init = phase == PHASE_INIT
        in_mon = phase == PHASE_MONITOR

        any_init = bool(in_init.any())
        if any_init:
            init = ops.init_window(st["alive"], st["cur_i"], in_init, t, X, Xt,
                                   Yt, res["vario"], W=W, sensor=sensor)
        else:
            init = _init_zeros(st)
        init_ok = init["init_ok"]

        if fused == "mon":
            # Monitor, close and refit as one launch; INIT stays outside
            # and hands its fit window over.  The results come back
            # merged, the events in ``mon``.
            if bool((in_mon | init_ok).any()):
                bufs, nseg, coefs_n, rmse_n, mon = ops.fused_round(
                    Yt, X, t, st["alive"], st["included"], st["cur_k"],
                    st["n_last_fit"], in_mon, st["coefs"], st["rmse"],
                    res["vario"], init_ok, init["w_stab"], init["n_ok"],
                    st["first_seg"], st["nseg"], st["bufs"],
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
                mon = _mon_block(res, st, sensor=sensor, change_thr=change_thr,
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
                mon["included_mon"] & mon["is_refit"][:, None, :]).float()

        if fused == "mon":
            pass                      # merged in ops.fused_round above
        elif fused and (any_close or any_fit):
            # Close and refit as one launch.  The break magnitudes stay on
            # the program route 0 runs, so the two routes' results are
            # byte-identical.
            mags = (_close_mags(res, st, mon) if bool(is_brk.any())
                    else torch.zeros_like(st["rmse"]))
            bufs, nseg, coefs_n, rmse_n = ops.fused_fit_close(
                Yt, X, t, w_fit(), do_fit, n_full, mon["included_mon"],
                st["coefs"], st["rmse"], mags, is_tail, is_brk,
                mon["pos_ev"], mon["n_exceed"], st["first_seg"], st["nseg"],
                st["bufs"])
        elif fused:
            bufs, nseg = st["bufs"], st["nseg"]
            coefs_n, rmse_n = st["coefs"], st["rmse"]
        else:
            if any_close:
                bufs, nseg = _close_block(res, st, mon)
            else:
                bufs, nseg = st["bufs"], st["nseg"]
            if any_fit:
                cfull, rfull = ops.lasso_fit(Yt, w_fit(), X,
                                             coefmask_for(n_full))
                coefs_n = torch.where(do_fit[..., None, None], cfull,
                                      st["coefs"])
                rmse_n = torch.where(do_fit[..., None], rfull, st["rmse"])
            else:
                coefs_n, rmse_n = st["coefs"], st["rmse"]

        # ---------------- next state ----------------
        is_refit = mon["is_refit"]
        done = init["init_nowin"] | (init["init_bad"] & ~init["has_adv"])
        phase_n = torch.where(
            done, PHASE_DONE,
            torch.where(init_ok, PHASE_MONITOR,
                        torch.where(is_tail, PHASE_DONE,
                                    torch.where(is_brk, PHASE_INIT, phase))))
        cur_i_n = torch.where(
            init["init_tm"], init["i_next_tm"],
            torch.where(init["init_bad"] & init["has_adv"], init["i_adv"],
                        torch.where(is_brk, mon["pos_ev"], st["cur_i"])))
        cur_k_n = torch.where(init_ok, init["j"] + 1,
                              torch.where(is_refit, mon["pos_ev"] + 1,
                                          st["cur_k"]))
        alive_n = torch.where(in_init[:, None, :], init["alive_init"],
                              torch.where(in_mon[:, None, :],
                                          mon["alive_mon"], st["alive"]))
        included_n = torch.where(
            init_ok[:, None, :], init["w_stab"],
            torch.where(is_brk[:, None, :], False,
                        torch.where(in_mon[:, None, :], mon["included_mon"],
                                    st["included"])))
        nlast_n = torch.where(do_fit, n_full, st["n_last_fit"])
        i32 = torch.int32
        st = dict(phase=phase_n.to(i32), cur_i=cur_i_n.to(i32),
                  cur_k=cur_k_n.to(i32), alive=alive_n, included=included_n,
                  coefs=coefs_n, rmse=rmse_n, n_last_fit=nlast_n.to(i32),
                  first_seg=st["first_seg"] & ~is_brk, nseg=nseg, bufs=bufs)
        counts = [counts[0] + any_init, counts[1] + any_fit,
                  counts[2] + any_close]
        rounds += 1

    meta_b, rmse_b, mag_b, coef_b = st["bufs"]
    is_std, is_alt = res["is_std"], res["is_alt"]
    final_mask = torch.where(
        is_std[:, None, :], st["alive"],
        torch.where(is_alt[:, None, :], res["alt_mask"], False))
    dev = Yt.device
    return ChipSegments(
        n_segments=st["nseg"], seg_meta=meta_b, seg_rmse=rmse_b,
        seg_mag=mag_b, seg_coef=coef_b,
        mask=final_mask.transpose(1, 2).contiguous(),
        procedure=res["procedure"],
        rounds=torch.full((C,), rounds, dtype=torch.int32, device=dev),
        vario=res["vario"],
        round_counts=torch.tensor(counts, dtype=torch.int32,
                                  device=dev).expand(C, 3).contiguous())


def detect_staged(days, n_obs, spectra, qa, *, W, sensor=LANDSAT_ARD,
                  max_segments=MAX_SEGMENTS,
                  variogram_mode=params.VARIOGRAM_DEFAULT, ops=None,
                  fused=None):
    """Detect from the staged integer wire on its device: ``days`` [C,T]
    int32, ``n_obs`` [C] int32, ``spectra`` [C,B,P,T] int16, ``qa``
    [C,P,T] uint8.  The designs are built on the device, the spectra are
    made resident as [C,B,T,P].  ``fused`` picks the round route
    (:func:`fused_mode`)."""
    _exact_f32()
    ops = cuda_ops.KERNELS if ops is None else ops
    if variogram_mode not in ("adjusted", "plain"):
        raise ValueError(f"variogram_mode {variogram_mode!r}: 'adjusted' or "
                         f"'plain'")
    X, Xt, t, valid = device_designs(days, n_obs)
    Yt = spectra.transpose(2, 3).contiguous()                   # [C,B,T,P]
    qa_t = qa.transpose(1, 2).contiguous().to(torch.int32)      # [C,T,P]
    with torch.no_grad():
        return _detect_batch(X, Xt, t, valid, Yt, qa_t, W=W, sensor=sensor,
                             max_segments=max_segments,
                             variogram_mode=variogram_mode, ops=ops,
                             fused=fused_mode(fused))


def detect_packed(packed, *, device=None, max_segments: int = MAX_SEGMENTS,
                  check_capacity: bool = True, staged: tuple | None = None,
                  variogram_mode: str = params.VARIOGRAM_DEFAULT,
                  ops=None, fused=None) -> ChipSegments:
    """Run the detector over a PackedChips batch -> ChipSegments with
    leading chip axis [C, P, ...], on ``device`` (default CUDA).

    The segment buffers start at ``max_segments``; when some pixel closes
    more segments than that, the batch runs again with doubled capacity
    (``check_capacity=False`` skips the check).  ``staged`` takes the
    device wire tuple of :func:`stage_packed`.  ``variogram_mode`` is
    "adjusted" (default) or "plain".  ``ops`` names the three round
    functions: :data:`cuda_ops.KERNELS` (default; the CUDA kernels on a
    CUDA device, their plain versions on the CPU) or
    :data:`cuda_ops.PLAIN` (the plain versions wherever the tensors are).
    ``fused`` picks the round route: None defers to FIREBIRD_FUSED_FIT
    (unset: route 0), else 0, 1 or "mon" (:func:`fused_mode`)."""
    dev = resolve_device(device)
    args = staged if staged is not None else stage_packed(packed, dev)
    sensor = getattr(packed, "sensor", LANDSAT_ARD)
    W = window_cap(packed)
    fused = fused_mode(fused)
    dispatch = lambda S: detect_staged(*args, W=W, sensor=sensor,
                                       max_segments=S,
                                       variogram_mode=variogram_mode, ops=ops,
                                       fused=fused)
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


def pack_egress(seg: ChipSegments, s_eff: int) -> dict:
    """Device-side egress packing of a batched float32 ChipSegments —
    kernel.pack_egress: integer meta columns rint-coded (chprob coded as
    ``rint(chprob * PEEK_SIZE)``), float planes bitcast to int32, the mask
    bitpacked along T, segment planes cut to ``s_eff`` slots."""
    sl = lambda a: a[:, :, :s_eff].contiguous()
    bc = lambda a: a.contiguous().view(torch.int32)
    meta = sl(seg.seg_meta)
    meta_i = torch.round(meta).to(torch.int32)
    meta_i[..., 3] = torch.round(meta[..., 3] * params.PEEK_SIZE).to(torch.int32)
    out = dict(n_segments=seg.n_segments, procedure=seg.procedure,
               meta=meta_i, rmse=bc(sl(seg.seg_rmse)), mag=bc(sl(seg.seg_mag)),
               coef=bc(sl(seg.seg_coef)), mask=packbits(seg.mask))
    for f in ("rounds", "round_counts"):
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

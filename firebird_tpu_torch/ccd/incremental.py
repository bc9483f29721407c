"""Streaming incremental CCDC: append observations, re-test change only.

The port's counterpart of the JAX package's ``ccd/incremental.py``.  The
batch detector fits the whole archive; operationally a few new Landsat
acquisitions arrive per pixel each month, and refitting 35 years for each
is wasteful.  So each pixel keeps its *open tail segment* (the fitted
harmonic model, RMSE, variogram and trailing exceed count) as a
:class:`StreamState`, and every new observation runs the batch detector's
tail rules on it: QA triage, the score against max(rmse, vario) over the
detection bands, absorb or count an exceedance, and a break confirmed
after PEEK_SIZE consecutive exceeding observations.  One ``[P]``-wide
:func:`step` an acquisition, in plain torch ops on the state's device.
Pixels whose tail broke (``needs_batch``) wait for a batch rerun, the cold
path, which re-initializes a segment after the break.

A streamed observation is always at the series end, so an exceeding one is
counted, never absorbed; the batch detector, seeing later clean data, may
absorb an isolated exceedance retroactively.  Streaming under-counts nobs
by such observations until the next batch rerun.

The score's arithmetic is the JAX step's on the CPU: each prediction a
fused multiply-add chain over the 8 design columns (``primitives.fma``),
the band terms of the score added left to right, each square rounded.  So
every field of a step equals the JAX package's (its XLA CPU loop sums the
last vector block of a thread's range with fused adds: a pixel there can
score an ulp apart there: an envelope of the reference).  Every operation
is a correctly rounded IEEE one, so the card and the CPU give the same
bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from firebird_tpu_torch.ccd import harmonic, kernel, params
from firebird_tpu_torch.ccd.primitives import fma
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD, chi2_thresholds

STATE_FIELDS = ("coefs", "rmse", "vario", "nobs", "n_exceed", "end_day",
                "exceed_day0", "break_day", "active")


@dataclasses.dataclass
class StreamState:
    """Per-pixel open-segment state, tensors with leading axis [P] or
    [C, P].  A pixel is ``active`` when its last batch segment ran to the
    series end under the standard procedure (CURVE_QA_END set): only those
    have a model whose change probability can be extended."""

    coefs: torch.Tensor        # [.., P, B, 8] internal-convention coefs
    rmse: torch.Tensor         # [.., P, B]
    vario: torch.Tensor        # [.., P, B]
    nobs: torch.Tensor         # [.., P] int32 obs in the open segment
    n_exceed: torch.Tensor     # [.., P] int32 trailing exceeding run
    end_day: torch.Tensor      # [.., P] ordinal of the last absorbed obs
    exceed_day0: torch.Tensor  # [.., P] first day of the current exceed
    #   run (0 when none, or unknown for a run begun before seeding)
    break_day: torch.Tensor    # [.., P] ordinal of a confirmed break (0 none)
    active: torch.Tensor       # [.., P] bool

    @classmethod
    def from_chip(cls, seg: kernel.ChipSegments, device=None) -> "StreamState":
        """Seed the state from one chip's batch result ([P, ...] tensors or
        host arrays) on ``device`` (CUDA unless given)."""
        if seg.vario is None:
            raise ValueError("batch result lacks vario; rerun the kernel")
        dev = kernel.resolve_device(device)
        t = lambda a: (a if torch.is_tensor(a)
                       else torch.tensor(np.asarray(a))).to(dev)
        nseg, meta = t(seg.n_segments), t(seg.seg_meta)
        P = nseg.shape[0]
        # clip to the buffer capacity: guards a raw check_capacity=False
        # result
        last = (nseg.long() - 1).clamp(0, meta.shape[-2] - 1)
        ar = torch.arange(P, device=dev)
        m = meta[ar, last]                                      # [P, 6]
        curqa = m[:, 4].to(torch.int32)
        active = ((t(seg.procedure) == 0) & (nseg >= 1)
                  & ((curqa & params.CURVE_QA_END) > 0))
        return cls(
            coefs=t(seg.seg_coef)[ar, last].clone(),
            rmse=t(seg.seg_rmse)[ar, last].clone(),
            vario=t(seg.vario).clone(),
            nobs=m[:, 5].to(torch.int32),
            # chprob on an END segment is n_exceed / PEEK_SIZE
            n_exceed=torch.round(m[:, 3] * params.PEEK_SIZE).to(torch.int32),
            end_day=m[:, 1].clone(),
            exceed_day0=torch.zeros(P, dtype=m.dtype, device=dev),
            break_day=torch.zeros(P, dtype=m.dtype, device=dev),
            active=active)

    @property
    def needs_batch(self) -> torch.Tensor:
        """Pixels whose tail broke: only a batch rerun re-initializes a
        segment after the break."""
        return self.break_day > 0

    def to(self, device) -> "StreamState":
        return StreamState(*(getattr(self, f).to(device)
                             for f in STATE_FIELDS))


def design_row(t_new: float, anchor: float, dtype=np.float32) -> np.ndarray:
    """The [8] design row of a new acquisition (float64 phases, the batch
    designs' convention; harmonic.design_matrix)."""
    return harmonic.design_matrix(
        np.array([t_new]), anchor, params.MAX_COEFS)[0].astype(dtype)


def step(state: StreamState, x_row, y_new, qa_new, t_new, *,
         sensor=LANDSAT_ARD) -> StreamState:
    """Advance every pixel's open segment by one acquisition.

    Args:
        state: StreamState [P, ...].
        x_row: [8] design row for t_new (:func:`design_row`), a tensor on
            the state's device or an array.
        y_new: [P, B] new spectral values (the detector's band order).
        qa_new: [P] int32 bit-packed QA.
        t_new: the ordinal day (a float, or a 0-d tensor on the device).
        sensor: the band roles and the chi2 threshold's dof.

    Tail rules as the batch detector's monitor: clear and in-range
    observations only; score = sum over detection bands of
    (residual / max(rmse, vario))^2; a score above CHANGE_THRESHOLD
    extends the exceed run (PEEK_SIZE in a row confirm a break dated at the
    run's first exceeding day); anything else is absorbed and resets the
    run.  Returns the new StreamState; ``state`` is left as it was."""
    det = list(sensor.detection_bands)
    change_thr, _ = chi2_thresholds(len(det))
    fd = state.rmse.dtype
    dev = state.rmse.device
    y = torch.as_tensor(y_new, device=dev).to(fd)
    qa = torch.as_tensor(qa_new, device=dev)
    x = torch.as_tensor(x_row, device=dev).to(fd)
    t = (t_new.to(fd) if torch.is_tensor(t_new)
         else torch.full_like(state.end_day, float(t_new)))
    bit = lambda b: ((qa >> b) & 1) == 1
    fill = bit(params.QA_FILL_BIT)
    clear = (bit(params.QA_CLEAR_BIT) | bit(params.QA_WATER_BIT)) & ~fill
    opt = list(sensor.optical_bands)
    rng_ok = ((y[:, opt] > params.OPTICAL_MIN)
              & (y[:, opt] < params.OPTICAL_MAX)).all(1)
    if sensor.thermal_bands:
        th = list(sensor.thermal_bands)
        rng_ok &= ((y[:, th] > params.THERMAL_MIN)
                   & (y[:, th] < params.THERMAL_MAX)).all(1)
    usable = clear & rng_ok & state.active & ~state.needs_batch

    c = state.coefs[:, det]                                    # [P, nd, 8]
    pred = c[..., 0] * x[0]
    for k in range(1, c.shape[-1]):
        pred = fma(c[..., k], x[k].expand_as(pred), pred)
    q = (y[:, det] - pred) / torch.maximum(state.rmse, state.vario)[:, det]
    s = q[:, 0] * q[:, 0]
    for b in range(1, q.shape[1]):
        s = s + q[:, b] * q[:, b]

    # Batch tail semantics: any score above CHANGE_THRESHOLD (the far
    # outlier tail included) counts toward the exceed run; everything else
    # is absorbed and resets it.
    exceed = usable & (s > change_thr)
    absorb = usable & ~exceed
    zero_i = torch.zeros_like(state.n_exceed)
    n_exceed = torch.where(exceed, state.n_exceed + 1,
                           torch.where(absorb, zero_i, state.n_exceed))
    run_starts = exceed & (state.n_exceed == 0)
    zero_f = torch.zeros_like(state.exceed_day0)
    exceed_day0 = torch.where(run_starts, t,
                              torch.where(absorb, zero_f, state.exceed_day0))
    broke = usable & (n_exceed >= params.PEEK_SIZE) & ~state.needs_batch
    # A run already in progress at seed time has no recorded start day
    # (exceed_day0 == 0): the confirmation day is the honest fallback.
    bday = torch.where(exceed_day0 > 0, exceed_day0, t)
    return StreamState(
        coefs=state.coefs, rmse=state.rmse, vario=state.vario,
        nobs=state.nobs + absorb.to(torch.int32),
        n_exceed=n_exceed,
        end_day=torch.where(absorb, t, state.end_day),
        exceed_day0=exceed_day0,
        break_day=torch.where(broke, bday, state.break_day),
        active=state.active)


__all__ = ["STATE_FIELDS", "StreamState", "design_row", "step"]

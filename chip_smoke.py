"""Smoke run of the PyTorch/CUDA detector on one GPU.

    python3 chip_smoke.py [--seed N] [--chips 8] [--reps 20]

From the root of a checkout, on a machine with a CUDA card:

1. prints the card (nvidia-smi name and power limit) and the torch / CUDA
   versions;
2. builds the nine CUDA kernels from ``firebird_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and times the build;
3. kernel phase: runs each kernel's wrapper at the main path's full width
   (``--chips`` chips of 100x100 pixels from ``SyntheticSource(--seed)``,
   1985-2017, T=768, the archive's window cap) on round states drawn from
   the seed with numpy (the fused kernels' events come from the plain
   monitor and INIT on those states; ``detect_mega`` starts from the
   batch's own prologue state), holds the result against the kernel's
   plain PyTorch version on the same inputs, and times both with CUDA
   events;
4. main paths, one for each route: the round routes ``fused`` 0, 1 and
   "mon", the whole-loop route ``pallas="mega"`` and the component route
   ``pallas="lasso,monitor,tmask"``.  Each is ``SyntheticSource`` ->
   ``pack`` -> ``detect_packed`` on the card for the same full-size
   Landsat chips, with the launch counters set to 0 just before and read
   just after, and held to the route's set of kernels (the mega route to
   one ``detect_mega`` launch per dispatch); the same batch through the
   route's plain versions on the card, and the fraction of pixels whose
   decision fields agree.  Route 1 must equal route 0 byte for byte, route
   "mon" in every field but seg_mag (held to rtol 5e-3, atol 1e-2), the
   mega route route "mon" in every field but the per-chip rounds and
   round_counts (their maximum over chips is route 0's rounds), the
   component route route 0 in the decisions of at least 0.999 of the
   pixels.  On route 0, egress packing and decoding and the store's table
   frames for one chip;
5. a small input (two 10x10 chips) through the card and through the plain
   versions on the CPU, decision fields compared.

Any failed check raises before the result.  The last three lines are the
kernels' JSON summary, the card's name and power limit as nvidia-smi gives
them, and the device JSON.  A longer report goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from firebird_tpu_torch.ccd import cuda_ops, format as fmt, kernel, params
from firebird_tpu_torch.ccd.primitives import (coefmask_for,
                                               first_at_or_after, variogram)
from firebird_tpu_torch.ccd.sensor import (LANDSAT_ARD, LANDSAT_ARD_TINY,
                                           chi2_thresholds)
from firebird_tpu_torch.ingest import SyntheticSource, pack

HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
F32_FLOPS_S = 67e12            # H100 SXM float32 outside the tensor cores
START, END = "1985-01-01", "2017-12-31"
PALLAS = "firebird_tpu/ccd/pallas_ops.py"
KERNEL_INFO = {
    "lasso_fit": f"{PALLAS}:375",
    "monitor_chain_scored": f"{PALLAS}:706",
    "init_window": f"{PALLAS}:976",
    "fused_fit_close": f"{PALLAS}:1426",
    "fused_round": f"{PALLAS}:1727",
    "lasso_cd": f"{PALLAS}:170",
    "monitor_chain": f"{PALLAS}:652",
    "tmask_bad": f"{PALLAS}:1225",
    "detect_mega": f"{PALLAS}:2283",
}
COMPONENTS = "lasso,monitor,tmask"
# Each main path: its detect_packed arguments and the kernels it launches
# (the routes after "0" fit the prologue's snow / insufficient-clear
# pixels with lasso_fit; the component route with lasso_cd).
ROUTES = {
    "0": (dict(pallas="1", fused=0),
          {"lasso_fit", "monitor_chain_scored", "init_window"}),
    "1": (dict(pallas="1", fused=1),
          {"lasso_fit", "monitor_chain_scored", "init_window",
           "fused_fit_close"}),
    "mon": (dict(pallas="1", fused="mon"),
            {"lasso_fit", "init_window", "fused_round"}),
    "mega": (dict(pallas="mega"), {"lasso_fit", "detect_mega"}),
    COMPONENTS: (dict(pallas=COMPONENTS, fused=0),
                 {"lasso_cd", "monitor_chain", "tmask_bad"}),
}
# The route whose main-path launches a kernel's JSON row reports.
HOME_ROUTE = {"lasso_fit": "0", "monitor_chain_scored": "0",
              "init_window": "0", "fused_fit_close": "1",
              "fused_round": "mon", "lasso_cd": COMPONENTS,
              "monitor_chain": COMPONENTS, "tmask_bad": COMPONENTS,
              "detect_mega": "mega"}
SEGMENT_FIELDS = ("n_segments", "seg_meta", "seg_rmse", "seg_mag",
                  "seg_coef", "mask", "procedure", "rounds", "vario",
                  "round_counts")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps, warm=1):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def bound(nbytes, flops):
    b_ms, f_ms = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS_S * 1e3
    return (b_ms, "bytes") if b_ms >= f_ms else (f_ms, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Kernel phase
# ---------------------------------------------------------------------------

def kernel_inputs(seed, staged, W):
    """Full-width kernel inputs: the main path's staged batch (spectra,
    dates, QA) and round states drawn from the seed — alive sets from the
    QA's clear observations, a model fitted by the plain Lasso over them,
    random cursors, phases, segment counts and result buffers."""
    rng = np.random.default_rng(seed + 1)
    days, n_obs, spectra, qa = staged
    dev = spectra.device
    C, B, P, T = spectra.shape
    X, Xt, t, valid = kernel.device_designs(days, n_obs)
    Yt = spectra.transpose(2, 3).contiguous()
    g = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    clear = (((qa >> params.QA_CLEAR_BIT) & 1) == 1).transpose(1, 2).contiguous()
    alive = clear & valid[:, :, None] & g(rng.random((C, T, P)) < 0.95)
    vario = variogram(Yt.float(), alive, t).contiguous()
    coefs, rmse = cuda_ops.lasso_fit_plain(
        Yt, alive.float(), X, torch.ones(C, P, 8, dtype=torch.bool, device=dev))
    det = list(LANDSAT_ARD.detection_bands)
    cut = g(rng.integers(T // 8, T // 2, (C, P)).astype(np.int32))
    ar = torch.arange(T, device=dev)[None, :, None]
    included = alive & (ar < cut[:, None, :])
    # Half the pixels were last fit on their included count (they reach a
    # refit point), half on more than the series holds (they end in a
    # tail or a break).
    n_last_fit = torch.where(g(rng.random((C, P)) < 0.5),
                             included.sum(1, dtype=torch.int32).clamp_min(1),
                             4 * T)
    S = kernel.MAX_SEGMENTS
    bufs = tuple(g(rng.standard_normal((C, P, S) + k).astype(np.float32))
                 for k in ((6,), (B,), (B,), (B, 8)))
    return dict(
        coefs=coefs, rmse=rmse, bufs=bufs,
        first_seg=g(rng.random((C, P)) < 0.5),
        nseg=g(rng.integers(0, S + 1, (C, P)).astype(np.int32)),
        T=T, W=W, X=X, Xt=Xt, t=t, Yt=Yt, vario=vario, alive=alive,
        w=(alive & (ar < g(rng.integers(T // 4, T, (C, P)))[:, None, :])).float(),
        coefmask=coefmask_for(g(rng.integers(12, 30, (C, P)))),
        Yd=Yt[:, det].contiguous(),
        coefs_d=coefs[:, :, det].contiguous(),
        dden=torch.maximum(rmse, vario)[:, :, det].contiguous(),
        included=included, cur_k=cut,
        n_last_fit=n_last_fit,
        in_mon=g(rng.random((C, P)) < 0.7),
        cur_i=g(rng.integers(0, T // 2, (C, P)).astype(np.int32)),
        in_init=g(rng.random((C, P)) < 0.6))


def window_sizes(inp):
    """Members of each pixel's initialization window ([C,P], 0 where the
    pixel is not initializing or has no window)."""
    alive, t = inp["alive"], inp["t"]
    T = alive.shape[1]
    ar = torch.arange(T, device=alive.device)[None, :, None]
    has_i, i = first_at_or_after(alive, inp["cur_i"])
    t_i = torch.gather(t, 1, i)
    cnt = torch.cumsum(alive & (ar >= i[:, None, :]), 1)
    okj = (alive & (ar >= i[:, None, :]) & (cnt >= params.MEOW_SIZE)
           & (t[:, :, None] - t_i[:, None, :] >= params.INIT_DAYS))
    has_w, j = first_at_or_after(okj, torch.zeros_like(i))
    n = torch.gather(cnt, 1, j[:, None, :])[:, 0]
    return torch.where(has_i & has_w & inp["in_init"], n, torch.zeros_like(n))


def kernel_phase(inp, staged, reps):
    C, B, T, P = inp["Yt"].shape
    rows, report = [], {}
    kw_mon = dict(zip(("change_thr", "outlier_thr"),
                      chi2_thresholds(5)))

    # ---- lasso_fit ----
    a = (inp["Yt"], inp["w"], inp["X"], inp["coefmask"])
    got = cuda_ops.lasso_fit(*a)
    want = cuda_ops.lasso_fit_plain(*a)
    torch.cuda.synchronize()
    err = max(float((got[i] - want[i]).abs().max()) for i in range(2))
    rel = max(float((got[i] - want[i]).abs().max() / want[i].abs().max())
              for i in range(2))
    for i, nm in enumerate(("coefs", "rmse")):
        torch.testing.assert_close(got[i], want[i], rtol=1e-2, atol=1e-2,
                                   msg=lambda m: f"lasso_fit {nm}: {m}")
    nnz = float(inp["w"].sum())
    fl = nnz * (36 * 2 + B * 17 + 1) + C * P * B * 50 * 8 * 20 \
        + nnz * B * 19
    by = nnz * B * 2 + nbytes(inp["w"], inp["X"], inp["coefmask"], *got)
    rows.append(("lasso_fit", a, {}, err, rel, fl, by))

    # ---- monitor_chain_scored ----
    a = (inp["Yd"], inp["coefs_d"], inp["dden"], inp["X"], inp["alive"],
         inp["included"], inp["cur_k"], inp["n_last_fit"], inp["in_mon"])
    got = cuda_ops.monitor_chain_scored(*a, **kw_mon)
    want = mon = cuda_ops.monitor_chain_scored_plain(*a, **kw_mon)
    torch.cuda.synchronize()
    for k in want:
        n_diff = int((got[k] != want[k]).sum())
        check(n_diff == 0, f"monitor_chain_scored {k}: {n_diff} differ")
    # The detection bands at the monitoring pixels' alive observations.
    n_alive = float((inp["alive"] & inp["in_mon"][:, None, :]).sum())
    fl = n_alive * 5 * 19
    by = n_alive * 5 * 2 + nbytes(*a[1:], *got.values())
    rows.append(("monitor_chain_scored", a, kw_mon, 0.0, 0.0, fl, by))

    # ---- init_window ----
    a = (inp["alive"], inp["cur_i"], inp["in_init"], inp["t"], inp["X"],
         inp["Xt"], inp["Yt"], inp["vario"])
    kw_init = dict(W=inp["W"], sensor=LANDSAT_ARD)
    got = cuda_ops.init_window(*a, **kw_init)
    want = init = cuda_ops.init_window_plain(*a, **kw_init)
    torch.cuda.synchronize()
    for k in ("init_nowin", "init_tm", "has_adv", "i_next_tm", "i_adv", "j",
              "n_ok", "w_stab", "alive_init"):
        n_diff = int((got[k] != want[k]).sum())
        check(n_diff == 0, f"init_window {k}: {n_diff} differ")
    dis = {k: float((got[k] != want[k]).float().mean())
           for k in ("init_ok", "init_bad")}
    check(max(dis.values()) <= 1e-3, f"init_window stability verdicts: {dis}")
    report["init_window_verdict_disagreement"] = dis
    err = max(float((got[k].int() - want[k].int()).abs().max()) for k in want)
    n = window_sizes(inp).double()
    nz = n[n > 0]
    fl = init_flops(nz)
    by = float(nz.sum()) * 5 * 2 + nbytes(*a[:6], inp["vario"],
                                          *got.values())
    rows.append(("init_window", a, kw_init, err, 0.0, fl, by))
    rows += fused_rows(inp, mon, init, kw_mon, report)
    rows += component_rows(inp, kw_mon)
    rows.append(mega_row(staged, inp["W"], kw_mon, report))

    out = {}
    for name, args, kw, err, rel, fl, by, *timing in rows:
        tm = dict(reps=reps, plain_reps=max(reps // 4, 3), plain_warm=1)
        tm.update(*timing)
        ms = cuda_ms(lambda: getattr(cuda_ops.KERNELS, name)(*args, **kw),
                     tm["reps"])
        plain_ms = cuda_ms(lambda: getattr(cuda_ops.PLAIN, name)(*args, **kw),
                           tm["plain_reps"], tm["plain_warm"])
        b_ms, b_by = bound(by, fl)
        out[name] = dict(name=name, route="cuda",
                         source=f"firebird_tpu_torch/csrc/{name}.cu",
                         replaces=KERNEL_INFO[name], max_abs_err=err,
                         max_rel_err=rel, ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, bytes=by, flops=fl)
        print(f"kernel {name}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}), max abs err {err}, max rel err "
              f"{rel}", flush=True)
    return out, report


def tmask_flops(nz):
    """Float operations of the Tmask screen over windows of ``nz`` members:
    12 weighted 5x5 solves (Gram, correlations, Cholesky), 10 residual
    passes with their medians (insertion sorts) and the final flags."""
    lg = torch.log2(nz.clamp_min(2))
    return float((12 * (nz * 42 + 110) + 10 * (nz * 17 + 2 * nz * lg)
                  + 24 * nz).sum())


def init_flops(nz):
    """Float operations of the INIT body over windows of ``nz`` members:
    the Tmask screen, then the stability fit (Gram, 50 CD sweeps of the 5
    detection bands, the window's residuals)."""
    return tmask_flops(nz) + float((nz * 158 + 5 * 50 * 8 * 20
                                    + 5 * nz * 19).sum())


def fit_flops(w, do_fit, B):
    """Float operations of the shared refit over the fitting pixels'
    windows: the Gram, 50 CD sweeps and the RMSE (the lasso_fit count,
    over the fitting pixels only)."""
    nnz = float((w * do_fit[:, None, :]).sum())
    n_fit = float(do_fit.sum())
    return nnz * (36 * 2 + B * 17 + 1) + n_fit * B * 50 * 8 * 20 + nnz * B * 19


def fused_rows(inp, mon, init, kw_mon, report):
    """The fused kernels at full width on one round: the events and the
    INIT handoff come from the plain monitor and init_window results of
    the kernel phase's states.  Buffers are cloned for each call (the
    kernels write them in place)."""
    C, B, T, P = inp["Yt"].shape
    K = 8
    S = inp["bufs"][0].shape[2]
    clone = lambda: tuple(b.clone() for b in inp["bufs"])
    in_mon, init_ok, is_refit = inp["in_mon"], init["init_ok"], mon["is_refit"]
    incm = inp["included"] | (mon["inc_q"] & in_mon[:, None, :])
    do_fit = init_ok | is_refit
    w_fit = torch.where(init_ok[:, None, :], init["w_stab"],
                        incm & is_refit[:, None, :]).float()
    close = mon["is_tail"] | mon["is_brk"]
    n_rows = float((close & (inp["nseg"] < S)).sum())
    row_bytes = (6 + 2 * B + B * K) * 4
    vec_bytes = C * P * (B * K + B) * 4 * 2      # model in and out
    rows = []

    # ---- fused_fit_close ----
    a = (inp["Yt"], inp["X"], inp["t"], w_fit, do_fit,
         torch.where(init_ok, init["n_ok"], mon["n_rf"]), incm, inp["coefs"],
         inp["rmse"], cuda_ops.peek_run_mags(inp["Yt"], inp["X"], inp["alive"],
                                             inp["coefs"], mon["ev_rank"],
                                             mon["m"]),
         mon["is_tail"], mon["is_brk"], mon["pos_ev"], mon["n_exceed"],
         inp["first_seg"], inp["nseg"])
    got = cuda_ops.fused_fit_close(*a, clone())
    want = cuda_ops.fused_fit_close_plain(*a, clone())
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        check(torch.equal(g, w), f"fused_fit_close buffer {i} differs")
    check(torch.equal(got[1], want[1]), "fused_fit_close nseg differs")
    for i, nm in ((2, "coefs"), (3, "rmse")):
        torch.testing.assert_close(got[i], want[i], rtol=1e-2, atol=1e-2,
                                   msg=lambda m: f"fused_fit_close {nm}: {m}")
    err = max(float((got[i] - want[i]).abs().max()) for i in (2, 3))
    rel = max(float((got[i] - want[i]).abs().max() / want[i].abs().max())
              for i in (2, 3))
    # The fitting pixels' window spectra and f32 weight columns, the
    # closing pixels' included columns, the written rows and the rest.
    fl = fit_flops(w_fit, do_fit, B)
    by = (float((w_fit * do_fit[:, None, :]).sum()) * B * 2
          + float(do_fit.sum()) * T * 4 + float(close.sum()) * T
          + n_rows * row_bytes + vec_bytes + C * P * (B * 4 + 4 * 7)
          + nbytes(inp["X"], inp["t"]))
    rows.append(("fused_fit_close", a + (clone(),), {}, err, rel, fl, by))

    # ---- fused_round ----
    a = (inp["Yt"], inp["X"], inp["t"], inp["alive"], inp["included"],
         inp["cur_k"], inp["n_last_fit"], in_mon, inp["coefs"], inp["rmse"],
         inp["vario"], init_ok, init["w_stab"], init["n_ok"],
         inp["first_seg"], inp["nseg"])
    got = cuda_ops.fused_round(*a, clone(), **kw_mon)
    want = cuda_ops.fused_round_plain(*a, clone(), **kw_mon)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        if i == 2:
            torch.testing.assert_close(
                g, w, rtol=5e-3, atol=1e-2,
                msg=lambda m: f"fused_round seg_mag: {m}")
        else:
            check(torch.equal(g, w), f"fused_round buffer {i} differs")
    check(torch.equal(got[1], want[1]), "fused_round nseg differs")
    for k in want[4]:
        n_diff = int((got[4][k] != want[4][k]).sum())
        check(n_diff == 0, f"fused_round {k}: {n_diff} differ")
    for i, nm in ((2, "coefs"), (3, "rmse")):
        torch.testing.assert_close(got[i], want[i], rtol=1e-2, atol=1e-2,
                                   msg=lambda m: f"fused_round {nm}: {m}")
    err = max(float((got[i] - want[i]).abs().max()) for i in (2, 3))
    rel = max(float((got[i] - want[i]).abs().max() / want[i].abs().max())
              for i in (2, 3))
    report["fused_round_seg_mag_max_abs_err"] = float(
        (got[0][2] - want[0][2]).abs().max())
    report["fused_round_events"] = {
        k: int(want[4][k].sum()) for k in ("is_tail", "is_brk", "is_refit",
                                           "do_fit")}
    do_fit_r = want[4]["do_fit"]
    w_round = torch.where(init_ok[:, None, :], init["w_stab"],
                          want[4]["included_mon"]
                          & want[4]["is_refit"][:, None, :])
    fl = fit_flops(w_round.float(), do_fit_r, B)
    # Spectra: the 5 detection bands where the monitor or the fit reads
    # them, the other bands in the fit windows only.  Weights: the init-ok
    # pixels' u8 w_stab columns; a refit reads back its own included_mon
    # output.  Then the alive / included planes in and out, the written
    # rows and the rest.
    mon_obs = inp["alive"] & in_mon[:, None, :]
    fit_obs = w_round & do_fit_r[:, None, :]
    n_alive_mon = float(mon_obs.sum())
    close_r = want[4]["is_tail"] | want[4]["is_brk"]
    n_rows = float((close_r & (inp["nseg"] < S)).sum())
    fl += n_alive_mon * 5 * 19
    by = (2 * (5 * float((mon_obs | fit_obs).sum())
               + (B - 5) * float(fit_obs.sum()))
          + float(init_ok.sum()) * T + 4 * C * T * P + n_rows * row_bytes
          + vec_bytes + C * P * (B * 4 + 4 * 12) + nbytes(inp["X"], inp["t"]))
    rows.append(("fused_round", a + (clone(),), kw_mon, err, rel, fl, by))
    return rows


def component_rows(inp, kw_mon):
    """The component route's kernels at full width: ``lasso_cd`` on the
    Gram of the kernel phase's fit windows, ``monitor_chain`` on the score
    plane of its monitor states, ``tmask_bad`` on the windows of its
    initializing pixels."""
    C, B, T, P = inp["Yt"].shape
    rows = []

    # ---- lasso_cd ----
    G, c, _ = cuda_ops.gram_plain(inp["Yt"], inp["w"], inp["X"])
    diag = torch.diagonal(G, dim1=-2, dim2=-1).clamp_min(1e-12).contiguous()
    a = (G, c, diag, inp["coefmask"])
    got = cuda_ops.lasso_cd(*a)
    want = cuda_ops.lasso_cd_plain(*a)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               msg=lambda m: f"lasso_cd: {m}")
    err = float((got - want).abs().max())
    rows.append(("lasso_cd", a, {}, err, err / float(want.abs().max()),
                 C * P * B * 50 * 8 * 20, nbytes(*a, got)))

    # ---- monitor_chain ----
    s = cuda_ops.score_plain(inp["Yd"], inp["coefs_d"], inp["dden"],
                             inp["X"])
    a = (s, inp["alive"], inp["included"], inp["cur_k"], inp["n_last_fit"],
         inp["in_mon"])
    got = cuda_ops.monitor_chain(*a, **kw_mon)
    want = cuda_ops.monitor_chain_plain(*a, **kw_mon)
    torch.cuda.synchronize()
    for k in want:
        n_diff = int((got[k] != want[k]).sum())
        check(n_diff == 0, f"monitor_chain {k}: {n_diff} differ")
    # The score plane at the monitoring pixels' alive observations.
    # Integer counts and threshold compares only: no float arithmetic.
    n_alive = float((inp["alive"] & inp["in_mon"][:, None, :]).sum())
    rows.append(("monitor_chain", a, kw_mon, 0.0, 0.0, 0.0,
                 n_alive * 4 + nbytes(*a[1:], *got.values())))

    # ---- tmask_bad ----
    win = cuda_ops.init_window_gather(
        inp["alive"], inp["cur_i"], inp["in_init"], inp["t"], inp["X"],
        inp["Xt"], inp["Yt"], W=inp["W"])
    a = cuda_ops.tmask_args(win, inp["vario"])
    got = cuda_ops.tmask_bad(*a)
    want = cuda_ops.tmask_bad_plain(*a)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    check(n_diff == 0, f"tmask_bad: {n_diff} flags differ")
    n = win["n_win"].double()
    # The members' design rows and Tmask-band values, the initializing
    # pixels' slot weights and variograms, and the flags.
    by = (float(win["valid_w"].sum()) * (5 + 2) * 4
          + float((n > 0).sum()) * (inp["W"] + 2) * 4 + nbytes(got))
    rows.append(("tmask_bad", a, {}, 0.0, 0.0, tmask_flops(n[n > 0]), by))
    return rows


def mega_row(staged, W, kw_mon, report):
    """``detect_mega`` at full width: one launch on the prologue state of
    the main path's batch, against its plain lockstep loop (one run: it
    takes seconds).  The kernel sums its fits' Grams in another order than
    the plain einsum, so the two are held to decision agreement >= 0.999
    (printed) and, on the pixels that agree, the float fields to the fit
    envelope.  The operations bound sums the INIT, monitor and fit work of
    the plain run's rounds; the bytes bound counts the spectra and state
    once and the result buffers at the slots written."""
    days, n_obs, spectra, qa = staged
    X, Xt, t, valid = kernel.device_designs(days, n_obs)
    Yt = spectra.transpose(2, 3).contiguous()
    qa_t = qa.transpose(1, 2).contiguous().to(torch.int32)
    S = kernel.MAX_SEGMENTS
    res, st = kernel._prologue(X, Xt, t, valid, Yt, qa_t, sensor=LANDSAT_ARD,
                               S=S, variogram_mode=params.VARIOGRAM_DEFAULT,
                               ops=cuda_ops.KERNELS)
    C, B, T, P = Yt.shape
    clone = lambda: tuple(b.clone() for b in st["bufs"])
    a = (Yt, st["phase"], st["cur_i"], st["alive"], st["nseg"])
    tail = (t, X, Xt, res["vario"])
    kw = dict(W=W, sensor=LANDSAT_ARD, **kw_mon)
    got = cuda_ops.detect_mega(*a, clone(), *tail, **kw)
    work = dict(init=0.0, monitor=0.0, fit=0.0)

    def count(s, init, ev):
        in_init = s["phase"] == kernel.PHASE_INIT
        n = window_sizes(dict(alive=s["alive"], t=t, cur_i=s["cur_i"],
                              in_init=in_init)).double()
        work["init"] += init_flops(n[n > 0])
        in_mon = s["phase"] == kernel.PHASE_MONITOR
        work["monitor"] += float((s["alive"] & in_mon[:, None, :]).sum()) * 5 * 19
        w = torch.where(init["init_ok"][:, None, :], init["w_stab"],
                        ev["included_mon"] & ev["is_refit"][:, None, :])
        work["fit"] += fit_flops(w.float(), ev["do_fit"], B)

    want = cuda_ops.detect_mega_plain(*a, clone(), *tail, **kw,
                                      on_round=count)
    torch.cuda.synchronize()
    view = lambda o: types.SimpleNamespace(
        n_segments=o["nseg"], seg_meta=o["meta"], procedure=res["procedure"],
        mask=o["alive"].transpose(1, 2))
    same = agreeing(view(got), view(want))
    agree, n_dis = float(same.float().mean()), int((~same).sum())
    print(f"detect_mega vs its plain loop: decision agreement {agree} "
          f"({n_dis} pixels differ), rounds {got['rounds'].tolist()} / "
          f"{want['rounds'].tolist()}", flush=True)
    check(agree >= 0.999, f"detect_mega decision agreement {agree} < 0.999")
    err = rel = 0.0
    for k in ("rmse", "mag", "coef"):
        g, w = got[k][same], want[k][same]
        tol = (dict(rtol=5e-3, atol=1e-2) if k == "mag"
               else dict(rtol=1e-2, atol=1e-2))
        torch.testing.assert_close(g, w, **tol,
                                   msg=lambda m: f"detect_mega {k}: {m}")
        e = float((g - w).abs().max())
        err, rel = max(err, e), max(rel, e / float(w.abs().max()))
    report["detect_mega"] = dict(
        decision_agreement=agree, pixels_disagreeing=n_dis,
        rounds=got["rounds"].tolist(), rounds_plain=want["rounds"].tolist(),
        counts=got["counts"].tolist(), counts_plain=want["counts"].tolist(),
        flops=work)
    row_bytes = (6 + 2 * B + B * 8) * 4
    n_rows = float((got["nseg"].clamp_max(S) - st["nseg"].clamp_max(S)).sum())
    by = (nbytes(*a, *tail, got["nseg"], got["rounds"]) + C * T * P
          + n_rows * row_bytes + C * 3 * (2 * T + 8) * 4)
    return ("detect_mega", a + (clone(),) + tail, kw, err, rel,
            sum(work.values()), by,
            dict(reps=3, plain_reps=1, plain_warm=0))


# ---------------------------------------------------------------------------
# Main paths
# ---------------------------------------------------------------------------

def agreeing(a, b):
    """The pixels [C,P] whose decision fields agree in two batched results:
    segment count, procedure, processing mask, and every meta column of
    the closed segments."""
    S = min(a.seg_meta.shape[2], b.seg_meta.shape[2])
    n = a.n_segments
    slot = torch.arange(S, device=n.device) < n[..., None].clamp_max(S)
    meta_eq = ((a.seg_meta[:, :, :S] == b.seg_meta[:, :, :S]).all(-1)
               | ~slot).all(-1)
    return ((a.n_segments == b.n_segments) & (a.procedure == b.procedure)
            & (a.mask == b.mask).all(-1) & meta_eq)


def decision_agreement(a, b):
    """The fraction of pixels whose decision fields agree (:func:`agreeing`)
    and the count of those that do not."""
    agree = agreeing(a, b)
    return float(agree.float().mean()), int((~agree).sum())


def check_result(seg, C, P, T):
    check(seg.n_segments.shape == (C, P), "n_segments shape")
    check(seg.mask.shape == (C, P, T), "mask shape")
    check(seg.seg_meta.shape[:2] == (C, P), "seg_meta shape")
    for f in ("seg_meta", "seg_rmse", "seg_mag", "seg_coef", "vario"):
        check(bool(torch.isfinite(getattr(seg, f)).all()), f"{f} not finite")
    check(int(seg.n_segments.min()) >= 0, "negative segment count")


def make_batch(seed, n_chips, dev):
    """``n_chips`` full-size Landsat ARD chips of a 1985-2017 archive,
    packed and staged on the card."""
    src = SyntheticSource(seed, start=START, end=END)
    t0 = time.perf_counter()
    packed = pack([src.chip(1000 * c, 2000) for c in range(n_chips)],
                  bucket=64)
    gen_s = time.perf_counter() - t0
    staged = kernel.stage_packed(packed, dev)
    torch.cuda.synchronize()
    return packed, staged, gen_s


def route_path(packed, staged, smi, name):
    """One route's main path: ``detect_packed`` on the card with the launch
    counters read around it, then the same route through the plain
    versions on the card."""
    C, B, P, T = packed.spectra.shape
    kw, expect = ROUTES[name]
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    seg = kernel.detect_packed(packed, staged=staged, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # Again, with the allocator's cache warm from the first run (the first
    # route pays the cold start after the kernel phase).
    t0 = time.perf_counter()
    kernel.detect_packed(packed, staged=staged, **kw)
    torch.cuda.synchronize()
    warm_secs = time.perf_counter() - t0
    launched = {k for k, n in launches.items() if n > 0}
    check(launched == expect,
          f"route {name!r} launched {sorted(launched)}, expected "
          f"{sorted(expect)}")
    if name == "mega":
        # One prologue lasso_fit and one detect_mega a dispatch.
        check(launches["detect_mega"] == launches["lasso_fit"],
              f"mega route: {launches['detect_mega']} detect_mega launches "
              f"for {launches['lasso_fit']} dispatches")
    check_result(seg, C, P, T)

    t0 = time.perf_counter()
    ref = kernel.detect_packed(packed, staged=staged, ops=cuda_ops.PLAIN,
                               **kw)
    torch.cuda.synchronize()
    plain_secs = time.perf_counter() - t0
    agree, n_dis = decision_agreement(seg, ref)
    print(f"main path, route {name!r}: {C} chips x {P} px, T={T}: "
          f"{secs:.3f} s, {C * P / secs:.1f} px/s on {smi} (again: "
          f"{warm_secs:.3f} s), rounds {seg.rounds.tolist()}, launches "
          f"{launches}, peak {peak / 2**30:.2f} GiB; plain route "
          f"{plain_secs:.3f} s; decision agreement {agree} ({n_dis} pixels "
          f"differ)", flush=True)
    check(agree >= 0.999, f"route {name!r}: decision agreement {agree} "
          f"< 0.999")
    return seg, dict(route=name, chips=C, pixels=C * P, T=T,
                     seconds=secs, pixels_per_s=C * P / secs,
                     seconds_again=warm_secs,
                     rounds=seg.rounds.tolist(),
                     round_counts=seg.round_counts.tolist(),
                     segments=int(seg.n_segments.sum()), launches=launches,
                     peak_bytes=peak, plain_seconds=plain_secs,
                     decision_agreement=agree, pixels_disagreeing=n_dis)


def compare_routes(seg, base, label, allowed):
    """A route against another on the card: every field equal but those
    in ``allowed``; seg_mag, where allowed to differ, within rtol 5e-3,
    atol 1e-2 (the in-kernel median).  Returns the fields that differ and
    the count of pixels that differ in any per-pixel field."""
    C, P = base.n_segments.shape
    differ = torch.zeros(C, P, dtype=torch.bool, device=base.n_segments.device)
    fields = []
    for f in SEGMENT_FIELDS:
        a, b = getattr(seg, f), getattr(base, f)
        if not torch.equal(a, b):
            fields.append(f)
            if a.shape[:2] == (C, P):
                differ |= (a != b).reshape(C, P, -1).any(-1)
    n_px = int(differ.sum())
    print(f"{label}: fields differing {fields}, {n_px} pixels differ",
          flush=True)
    check(set(fields) <= set(allowed), f"{label}: differs in {fields}")
    out = dict(fields_differing=fields, pixels_differing=n_px)
    if "seg_mag" in fields:
        mag_px = (seg.seg_mag != base.seg_mag).reshape(C, P, -1).any(-1)
        out["seg_mag_pixels"] = torch.nonzero(mag_px)[:20].tolist()
        print(f"{label}: seg_mag differs on {int(mag_px.sum())} pixels, "
              f"first (chip, pixel): {out['seg_mag_pixels']}", flush=True)
        torch.testing.assert_close(seg.seg_mag, base.seg_mag, rtol=5e-3,
                                   atol=1e-2)
    return out


def egress(seg, packed):
    """Egress packing and decoding and the store's table frames of one
    chip."""
    T = packed.spectra.shape[-1]
    P = packed.spectra.shape[2]
    worst = int(seg.n_segments.max())
    s_eff = kernel.egress_bucket(worst, seg.seg_meta.shape[2])
    tables = kernel.pack_egress(seg, s_eff)
    dec = fmt.decode_egress(tables, T)
    host = kernel.segments_to_numpy(seg)
    check(np.array_equal(dec.seg_meta, host.seg_meta[:, :, :s_eff]),
          "egress meta round trip")
    check(np.array_equal(dec.mask, host.mask), "egress mask round trip")
    frames = fmt.batch_frames(packed, dec, n_real=1)
    n_rows = len(frames[0][1]["segment"]["sday"])
    check(n_rows >= P, "segment frame rows")
    return dict(egress_s_eff=s_eff, segment_rows_chip0=n_rows)


def small_input(seed, dev):
    """Two 10x10 chips through the kernels on the card and through the
    plain versions on the CPU (the route the tests hold to the JAX
    package)."""
    src = SyntheticSource(seed, start="1995-01-01", end="1999-06-01",
                          sensor=LANDSAT_ARD_TINY, n_changes=2)
    packed = pack([src.chip(100, 200), src.chip(3100, 200)], bucket=32)
    a = kernel.detect_packed(packed, device=dev)
    b = kernel.detect_packed(packed, device="cpu")
    b = kernel.ChipSegments(*[None if v is None else v.to(dev)
                              for v in vars(b).values()])
    agree, n_dis = decision_agreement(a, b)
    print(f"small input: decision agreement card vs cpu {agree} "
          f"({n_dis} of {a.n_segments.numel()} pixels differ)", flush=True)
    check(agree >= 0.99, f"small-input agreement {agree}")
    return dict(agreement=agree, pixels_disagreeing=n_dis)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    libs = cuda_ops.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({', '.join(p.name for p in libs.values())})",
          flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    packed, staged, gen_s = make_batch(args.seed, args.chips, dev)
    print(f"batch: {packed.spectra.shape} int16 made in {gen_s:.1f} s",
          flush=True)
    inp = kernel_inputs(args.seed, staged, kernel.window_cap(packed))
    kernels, kreport = kernel_phase(inp, staged, args.reps)
    del inp
    torch.cuda.empty_cache()
    paths, segs = {}, {}
    for name in ROUTES:
        segs[name], paths[name] = route_path(packed, staged, smi, name)
    paths["0"].update(egress(segs["0"], packed),
                      chip_generation_seconds=gen_s)
    for name, base, allowed in (
            ("1", "0", ()), ("mon", "0", ("seg_mag",)),
            ("mega", "mon", ("rounds", "round_counts", "seg_mag"))):
        paths[name][f"vs_route_{base}"] = compare_routes(
            segs[name], segs[base], f"route {name!r} vs route {base!r}",
            allowed)
    # The mega route counts rounds per chip: its deepest chip ran as many
    # rounds as the lockstep loop.
    check(int(segs["mega"].rounds.max()) == int(segs["0"].rounds[0]),
          f"mega rounds {segs['mega'].rounds.tolist()} against route 0's "
          f"{int(segs['0'].rounds[0])}")
    agree, n_dis = decision_agreement(segs[COMPONENTS], segs["0"])
    print(f"route {COMPONENTS!r} vs route '0': decision agreement {agree} "
          f"({n_dis} pixels differ)", flush=True)
    check(agree >= 0.999, f"component route vs route 0: decision agreement "
          f"{agree} < 0.999")
    paths[COMPONENTS]["vs_route_0"] = dict(decision_agreement=agree,
                                          pixels_disagreeing=n_dis)
    del segs
    small = small_input(args.seed, dev)
    for name, row in kernels.items():
        row["launches"] = paths[HOME_ROUTE[name]]["launches"][name]

    ptxas = {n: (cuda_ops.BUILD_DIR / f"{n}.ptxas.txt").read_text()
             for n in cuda_ops.SOURCES
             if (cuda_ops.BUILD_DIR / f"{n}.ptxas.txt").exists()}
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        device=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_seconds=build_s, kernels=kernels, kernel_report=kreport,
        main_paths=paths, small_input=small, ptxas=ptxas), indent=1))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "max_rel_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernels.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""The detector's three CUDA kernels, their wrappers and plain versions.

The counterpart of ``firebird_tpu/ccd/pallas_ops.py`` for the route this
package runs (the JAX package's ``FIREBIRD_PALLAS=fit,score,init``):

- :func:`lasso_fit` — Gram + correlation + coordinate-descent Lasso +
  RMSE per pixel (``csrc/lasso_fit.cu``; Pallas ``lasso_fit``).
- :func:`monitor_chain_scored` — the MONITOR round's score and event
  chain (``csrc/monitor_chain_scored.cu``; Pallas
  ``monitor_chain_scored``).
- :func:`init_window` — the INIT round: window search, Tmask IRLS screen
  and stability fit (``csrc/init_window.cu``; Pallas ``init_window``).

Each wrapper checks its tensors' device, dtype, shape and contiguity, then
runs its plain PyTorch version (``*_plain``, same contract) when they lie
on the CPU, and launches its CUDA kernel when they lie on a CUDA device;
nothing else chooses between the two.  The kernels
are compiled with ``nvcc`` for ``sm_90a`` at first use, one shared library
per source under ``build/firebird_tpu_torch/`` next to the package, and
bound through ``ctypes``.  ``LAUNCHES`` counts the kernel launches of each
wrapper.

Layouts (one thread per pixel, the pixel axis fastest): spectra
``[C,B,T,P]`` int16, time planes ``[C,T,P]``, per-pixel vectors ``[C,P]``,
designs ``[C,T,K]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import shutil
import subprocess
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from firebird_tpu_torch.ccd import params
from firebird_tpu_torch.ccd.primitives import (dot_cols, fdiv,
                                               first_at_or_after, take_plane,
                                               take_t, tmask_bad)
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD

K = params.MAX_COEFS
NT = params.TMASK_COEFS

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "firebird_tpu_torch"
SOURCES = ("lasso_fit", "monitor_chain_scored", "init_window")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The largest init window the init_window kernel is instantiated for (its
# register/local arrays are sized by it); window_cap of a 16-day Landsat
# archive is ~32.
W_MAX_CHOICES = (32, 64, 128)

LAUNCHES = {name: 0 for name in SOURCES}
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "fb_lasso_fit": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fb_monitor_chain_scored": [_P] * 12 + [_I, _I, _I, _I, _F, _F, _P],
    "fb_init_window": [_P] * 11 + [_I, _I, _I, _I, _I, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(exe).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc")
    return exe


def _lib_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _compile(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{r.stderr}")
    tmp.replace(out)
    return out


def build(names=SOURCES) -> dict[str, Path]:
    """Compile the kernels' sources (one nvcc per source, all at once) and
    load them; returns the library paths.  Built libraries are reused
    while their sources and flags are unchanged."""
    todo = [n for n in names if n not in _LIBS]
    with ThreadPoolExecutor(max(len(todo), 1)) as ex:
        paths = dict(zip(todo, ex.map(_compile, todo)))
    for n, p in paths.items():
        lib = ctypes.CDLL(str(p))
        fn = getattr(lib, f"fb_{n}")
        fn.argtypes = _ARGTYPES[f"fb_{n}"]
        fn.restype = ctypes.c_int
        _LIBS[n] = lib
    return {n: _lib_path(n) for n in names}


def _launch(name: str, *args) -> None:
    if name not in _LIBS:
        build((name,))
    rc = getattr(_LIBS[name], f"fb_{name}")(
        *args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# lasso_fit
# ---------------------------------------------------------------------------

def lasso_fit_plain(Yt, w, X, coefmask, with_rmse=True):
    """Plain version of :func:`lasso_fit` — kernel._fit_lasso's math.

    Gram ``sum_t w X X^T`` and correlations ``sum_t w y X`` over the time
    axis, both divided by the window count; LASSO_ITERS cyclic
    coordinate-descent sweeps (soft threshold LASSO_ALPHA, intercept
    unpenalized, coordinates outside ``coefmask`` held at zero); then the
    RMSE over the window."""
    C, B, T, P = Yt.shape
    n = w.sum(1).clamp_min(1.0)                                 # [C,P]
    XX = (X[:, :, :, None] * X[:, :, None, :]).reshape(C, T, K * K)
    G = torch.einsum("ctp,ctk->cpk", w, XX) / n[..., None]      # [C,P,64]
    c = torch.stack([torch.einsum("ctp,ctk->cpk", Yt[:, b].float() * w, X)
                     for b in range(B)], 2) / n[:, :, None, None]  # [C,P,B,K]
    tiny = torch.tensor(1e-12, dtype=G.dtype, device=G.device)
    diag = [torch.maximum(G[..., j * K + j], tiny)[..., None] for j in range(K)]
    mask = [coefmask[..., j][..., None] for j in range(K)]
    Gjk = [[G[..., j * K + k][..., None] for k in range(K)] for j in range(K)]
    cj = [c[..., j] for j in range(K)]
    zero = torch.zeros_like(cj[0])
    b = [zero] * K                                              # K x [C,P,B]
    for _ in range(params.LASSO_ITERS):
        for j in range(K):
            acc = Gjk[j][0] * b[0]
            for k in range(1, K):
                acc = acc + Gjk[j][k] * b[k]
            rho = cj[j] - acc + diag[j] * b[j]
            if j == 0:
                bj = rho / diag[0]
            else:
                bj = torch.sign(rho) * (rho.abs() - params.LASSO_ALPHA
                                        ).clamp_min(0.0) / diag[j]
            b[j] = torch.where(mask[j], bj, zero)
    beta = torch.stack(b, -1)                                   # [C,P,B,K]
    if not with_rmse:
        return beta, torch.zeros(C, P, B, dtype=w.dtype, device=w.device)
    rmse = []
    for bb in range(B):
        pred = dot_cols(beta[:, None, :, bb, :], X[:, :, None, :])  # [C,T,P]
        r = Yt[:, bb].float() - pred
        rmse.append(torch.sqrt(((r * r * w).sum(1) / n).clamp_min(0.0)))
    return beta, torch.stack(rmse, -1)


def lasso_fit(Yt, w, X, coefmask, with_rmse=True):
    """Per-pixel weighted Lasso fit of every band, and its RMSE.

    Args:
        Yt: [C,B,T,P] int16 resident spectra.
        w: [C,T,P] float32 0/1 fit-window weights.
        X: [C,T,8] float32 designs.
        coefmask: [C,P,8] bool allowed coefficients.
    Returns:
        (coefs [C,P,B,8], rmse [C,P,B]) float32; rmse is zero when
        ``with_rmse`` is False.
    """
    C, B, T, P = Yt.shape
    dev = Yt.device
    _check(Yt, "Yt", torch.int16, (C, B, T, P), dev)
    _check(w, "w", torch.float32, (C, T, P), dev)
    _check(X, "X", torch.float32, (C, T, K), dev)
    _check(coefmask, "coefmask", torch.bool, (C, P, K), dev)
    if dev.type == "cpu":
        return lasso_fit_plain(Yt, w, X, coefmask, with_rmse)
    if B != 7:
        raise ValueError(f"lasso_fit is built for 7 bands, got {B}")
    coefs = torch.empty(C, P, B, K, dtype=torch.float32, device=dev)
    rmse = torch.empty(C, P, B, dtype=torch.float32, device=dev)
    _launch("lasso_fit", _ptr(Yt), _ptr(w), _ptr(X), _ptr(coefmask),
            _ptr(coefs), _ptr(rmse), C, B, T, P, int(bool(with_rmse)))
    return coefs, rmse


# ---------------------------------------------------------------------------
# monitor_chain_scored
# ---------------------------------------------------------------------------

def score_plain(Yd, coefs_d, dden, X):
    """The chi-square score plane [C,T,P]: sum over detection bands of
    ((y - X beta) / dden)^2, each prediction summed column by column."""
    s = None
    for b in range(Yd.shape[1]):
        pred = dot_cols(coefs_d[:, None, :, b, :], X[:, :, None, :])
        r = (Yd[:, b].float() - pred) / dden[:, None, :, b]
        s = r * r if s is None else s + r * r
    return s


def monitor_chain_plain(s, alive, included, cur_k, n_last_fit, in_mon, *,
                        change_thr, outlier_thr):
    """The MONITOR event logic on a score plane — kernel._monitor_chain.

    All planes [C,T,P]; vectors [C,P].  Ranks count the alive sequence;
    a break needs PEEK_SIZE consecutive exceedances (reverse cummin of the
    next non-exceeding rank), a refit fires where the absorbed count
    crosses REFIT_FACTOR x the last fit's count; then the tail / break /
    refit choice and the include/remove partitions."""
    T = s.shape[1]
    dev = s.device
    ar = torch.arange(T, device=dev)[None, :, None]
    INF = T + 1
    i32 = torch.int32
    rank = torch.cumsum(alive, 1, dtype=i32) - 1
    m = alive.sum(1, dtype=i32)
    kq = (alive & (ar < cur_k[:, None, :])).sum(1, dtype=i32)

    ex = alive & (s > change_thr)
    reset_r = torch.where(alive & ~ex, rank, torch.full_like(rank, INF))
    nrr = torch.flip(torch.cummin(torch.flip(reset_r, [1]), 1).values, [1])
    runlen = torch.minimum(nrr, m[:, None, :]) - rank
    elig = alive & (rank >= kq[:, None, :])
    brk = elig & ex & (runlen >= params.PEEK_SIZE)
    has_brk, b_abs = first_at_or_after(brk, torch.zeros_like(cur_k))

    o = s > outlier_thr
    absq = elig & ~o
    n0 = included.sum(1, dtype=i32)
    n_inc = n0[:, None, :] + torch.cumsum(absq, 1, dtype=i32)
    refit_hit = absq & (n_inc.float() >= params.REFIT_FACTOR
                        * n_last_fit.float()[:, None, :])
    has_refit, f_abs = first_at_or_after(refit_hit, torch.zeros_like(cur_k))

    q_tail = torch.maximum(m - (params.PEEK_SIZE - 1), kq)
    inf = torch.full_like(m, INF)
    b_ev = torch.where(has_brk, take_plane(rank, b_abs), inf)
    f_ev = torch.where(has_refit, take_plane(rank, f_abs), inf)
    is_tail = in_mon & (q_tail <= torch.minimum(b_ev, f_ev))
    is_brk = in_mon & ~is_tail & has_brk & (b_ev <= f_ev)
    is_refit = in_mon & ~is_tail & ~is_brk & has_refit
    ev_rank = torch.where(is_tail, q_tail, torch.where(is_brk, b_ev, f_ev))

    normal_hi = torch.where(is_refit, ev_rank + 1, ev_rank)
    normalq = elig & (rank < normal_hi[:, None, :])
    inc_q = normalq & ~o
    rem_q = normalq & o
    tailq = elig & (rank >= q_tail[:, None, :]) & is_tail[:, None, :]
    tail_ex = tailq & (s > change_thr)
    inc_q = inc_q | (tailq & ~tail_ex)
    rem_q = rem_q | tail_ex
    n_exceed = tail_ex.sum(1, dtype=i32)
    pos_ev = torch.where(is_brk, b_abs, f_abs).to(i32)
    n_rf = take_plane(n_inc, pos_ev)
    return dict(m=m, is_tail=is_tail, is_brk=is_brk, is_refit=is_refit,
                ev_rank=ev_rank.to(i32), pos_ev=pos_ev,
                n_exceed=n_exceed, n_rf=n_rf.to(i32), inc_q=inc_q,
                rem_q=rem_q)


def monitor_chain_scored_plain(Yd, coefs_d, dden, X, alive, included, cur_k,
                               n_last_fit, in_mon, *, change_thr,
                               outlier_thr):
    """Plain version of :func:`monitor_chain_scored`: the score plane,
    then :func:`monitor_chain_plain`."""
    s = score_plain(Yd, coefs_d, dden, X)
    return monitor_chain_plain(s, alive, included, cur_k, n_last_fit, in_mon,
                               change_thr=change_thr,
                               outlier_thr=outlier_thr)


_MON_KEYS = ("m", "is_tail", "is_brk", "is_refit", "ev_rank", "pos_ev",
             "n_exceed", "n_rf")
_MON_BOOL = ("is_tail", "is_brk", "is_refit")


def monitor_chain_scored(Yd, coefs_d, dden, X, alive, included, cur_k,
                         n_last_fit, in_mon, *, change_thr, outlier_thr):
    """The MONITOR round: score every observation against the current
    model and locate each pixel's first event (break / refit / tail).

    Args:
        Yd: [C,nb,T,P] int16 detection-band spectra.
        coefs_d: [C,P,nb,8] float32 current model (detection bands).
        dden: [C,P,nb] float32 score denominators max(rmse, vario).
        X: [C,T,8] float32 designs.
        alive, included: [C,T,P] bool.
        cur_k, n_last_fit: [C,P] int32; in_mon: [C,P] bool.
    Returns:
        kernel._monitor_chain's dict: m, ev_rank, pos_ev, n_exceed, n_rf
        [C,P] int32; is_tail, is_brk, is_refit [C,P] bool; inc_q, rem_q
        [C,T,P] bool.
    """
    C, nb, T, P = Yd.shape
    dev = Yd.device
    _check(Yd, "Yd", torch.int16, (C, nb, T, P), dev)
    _check(coefs_d, "coefs_d", torch.float32, (C, P, nb, K), dev)
    _check(dden, "dden", torch.float32, (C, P, nb), dev)
    _check(X, "X", torch.float32, (C, T, K), dev)
    for nm, v in (("alive", alive), ("included", included)):
        _check(v, nm, torch.bool, (C, T, P), dev)
    for nm, v in (("cur_k", cur_k), ("n_last_fit", n_last_fit)):
        _check(v, nm, torch.int32, (C, P), dev)
    _check(in_mon, "in_mon", torch.bool, (C, P), dev)
    if dev.type == "cpu":
        return monitor_chain_scored_plain(
            Yd, coefs_d, dden, X, alive, included, cur_k, n_last_fit, in_mon,
            change_thr=change_thr, outlier_thr=outlier_thr)
    if nb != 5:
        raise ValueError(f"monitor_chain_scored is built for 5 detection "
                         f"bands, got {nb}")
    out = torch.empty(len(_MON_KEYS), C, P, dtype=torch.int32, device=dev)
    inc_q = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    rem_q = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    _launch("monitor_chain_scored", _ptr(Yd), _ptr(coefs_d), _ptr(dden),
            _ptr(X), _ptr(alive), _ptr(included), _ptr(cur_k),
            _ptr(n_last_fit), _ptr(in_mon), _ptr(out), _ptr(inc_q),
            _ptr(rem_q), C, nb, T, P, float(change_thr), float(outlier_thr))
    d = {k: (out[i] != 0 if k in _MON_BOOL else out[i])
         for i, k in enumerate(_MON_KEYS)}
    return dict(d, inc_q=inc_q, rem_q=rem_q)


# ---------------------------------------------------------------------------
# init_window
# ---------------------------------------------------------------------------

def window_members(alive, i, W):
    """Time positions [C,P,W] (int64) of the alive observations with ranks
    rank(i) .. rank(i)+W-1, and whether each exists.  Window member w of a
    pixel is its w-th alive observation at or after ``i``."""
    acum = torch.cumsum(alive, 1, dtype=torch.int32)            # [C,T,P]
    a_before = take_plane(acum, i) - take_plane(alive, i).to(torch.int32)
    want = (a_before[..., None] + 1
            + torch.arange(W, device=alive.device, dtype=torch.int32))
    acum_p = acum.transpose(1, 2).contiguous()                  # [C,P,T]
    pos = torch.searchsorted(acum_p, want.contiguous(), side="left")
    exists = pos < alive.shape[1]
    return pos.clamp_max(alive.shape[1] - 1), exists, a_before


def init_window_plain(alive, cur_i, in_init, t, X, Xt, Yt, vario, *, W,
                      sensor=LANDSAT_ARD, fit=lasso_fit_plain):
    """Plain version of :func:`init_window` — the XLA body of
    kernel._init_block.

    The window members are gathered by position (each slot holds exactly
    one observation, as the JAX one-hot selection does); ``fit`` runs the
    4-coefficient stability fit."""
    det = list(sensor.detection_bands)
    tmb = list(sensor.tmask_bands)
    C, T, P = alive.shape
    dev = alive.device
    ar = torch.arange(T, device=dev)[None, :, None]
    has_i, i = first_at_or_after(alive, cur_i)
    t_i = take_t(t, i)
    acum = torch.cumsum(alive, 1, dtype=torch.int32)
    pos, exists, a_before = window_members(alive, i, W)
    cnt = acum - a_before[:, None, :]
    okj = (alive & (ar >= i[:, None, :]) & (cnt >= params.MEOW_SIZE)
           & (t[:, :, None] - t_i[:, None, :] >= params.INIT_DAYS))
    has_w_raw, j = first_at_or_after(okj, torch.zeros_like(cur_i))
    has_w = has_i & has_w_raw
    w_init = (alive & (ar >= i[:, None, :]) & (ar <= j[:, None, :])
              & (has_w & in_init)[:, None, :])
    n_win = w_init.sum(1)                                       # [C,P]
    valid_w = torch.arange(W, device=dev) < n_win[..., None]    # [C,P,W]

    ci = torch.arange(C, device=dev)[:, None, None]
    pi = torch.arange(P, device=dev)[None, :, None]
    Yw = torch.stack([Yt[:, b][ci, pos, pi].float()
                      for b in range(Yt.shape[1])], 2)          # [C,P,B,W]
    Yw = torch.where(exists[:, :, None, :], Yw, torch.zeros_like(Yw))
    Xw = torch.cat([X, Xt], -1)[ci, pos]                        # [C,P,W,13]
    Xw = torch.where(exists[..., None], Xw, torch.zeros_like(Xw))
    Xw8, Xt_w = Xw[..., :K], Xw[..., K:]

    bad_w = tmask_bad(Xt_w, Yw[:, :, tmb], valid_w.float(),
                      vario[:, :, tmb])                         # [C,P,W]
    bad = torch.zeros(C, T, P, dtype=torch.int32, device=dev)
    bad.index_put_((ci.expand_as(pos), pos, pi.expand_as(pos)),
                   bad_w.to(torch.int32), accumulate=True)
    bad = bad > 0
    tm_removed = bad_w.any(-1)

    w_stab = w_init & ~tm_removed[:, None, :]
    cm4 = (torch.arange(K, device=dev) < 4).expand(C, P, K)
    c4, _ = fit(Yt, w_stab.float(), X, cm4.contiguous(), with_rmse=False)
    r_w = Yw - dot_cols(c4[:, :, :, None, :], Xw8[:, :, None, :, :])  # [C,P,B,W]
    stab_w = valid_w & ~bad_w
    stab_f = stab_w.float()[:, :, None, :]
    n4 = stab_w.sum(-1).float().clamp_min(1.0)[..., None]
    r2 = r_w * r_w * stab_f
    acc = r2[..., 0]
    for s in range(1, W):
        acc = acc + r2[..., s]
    r4 = torch.sqrt((acc / n4).clamp_min(0.0))                  # [C,P,B]
    r_first = r_w[..., 0]
    last = (n_win - 1).clamp_min(0)[:, :, None]                 # 0 past W
    r_last = torch.gather(r_w, 3, last.clamp_max(W - 1)[..., None].expand(
        C, P, r_w.shape[2], 1))[..., 0]
    r_last = torch.where(last < W, r_last, torch.zeros_like(r_last))
    span = take_t(t, j) - t_i
    denom = params.STABILITY_FACTOR * torch.maximum(r4, vario)
    slope_day = fdiv(c4[..., 1], 365.25)
    band_ok = (((slope_day * span[..., None]).abs() <= denom)
               & (r_first.abs() <= denom) & (r_last.abs() <= denom))
    stable = band_ok[..., det].all(-1)

    init_nowin = in_init & ~has_w
    init_tm = in_init & has_w & tm_removed
    init_ok = in_init & has_w & ~tm_removed & stable
    init_bad = in_init & has_w & ~tm_removed & ~stable
    ex_tm, i_next_tm = first_at_or_after(alive & ~bad, i)
    i_next_tm = torch.where(ex_tm, i_next_tm, torch.full_like(i_next_tm, T))
    has_adv, i_adv = first_at_or_after(alive, i + 1)
    i32 = torch.int32
    return dict(init_nowin=init_nowin, init_tm=init_tm, init_ok=init_ok,
                init_bad=init_bad, has_adv=has_adv, i_next_tm=i_next_tm.to(i32),
                i_adv=i_adv.to(i32), j=j.to(i32), w_stab=w_stab,
                n_ok=w_stab.sum(1, dtype=i32), alive_init=alive & ~bad)


_INIT_KEYS = ("init_nowin", "init_tm", "init_ok", "init_bad", "has_adv",
              "i_next_tm", "i_adv", "j", "n_ok")
_INIT_BOOL = ("init_nowin", "init_tm", "init_ok", "init_bad", "has_adv")


def _check_landsat_roles(sensor) -> None:
    if (sensor.n_bands != 7 or tuple(sensor.detection_bands) != (1, 2, 3, 4, 5)
            or tuple(sensor.tmask_bands) != (1, 4)):
        raise ValueError(f"the CUDA kernels are built for the Landsat band "
                         f"layout; sensor {sensor.name!r} differs")


def init_window(alive, cur_i, in_init, t, X, Xt, Yt, vario, *, W,
                sensor=LANDSAT_ARD):
    """The INIT round per pixel: find the initialization window (MEOW_SIZE
    alive observations spanning INIT_DAYS from the cursor), screen it with
    the Tmask IRLS, test the 4-coefficient fit's stability, and advance the
    cursor.

    Args:
        alive: [C,T,P] bool; cur_i: [C,P] int32; in_init: [C,P] bool.
        t: [C,T] float32 ordinal days; X: [C,T,8], Xt: [C,T,5] designs.
        Yt: [C,B,T,P] int16 spectra; vario: [C,P,B] float32.
        W: bound on the window's member count (kernel.window_cap).
    Returns:
        kernel._init_block's dict: init_nowin, init_tm, init_ok, init_bad,
        has_adv [C,P] bool; i_next_tm, i_adv, j, n_ok [C,P] int32;
        w_stab, alive_init [C,T,P] bool.
    """
    C, T, P = alive.shape
    B = Yt.shape[1]
    dev = alive.device
    _check(alive, "alive", torch.bool, (C, T, P), dev)
    _check(cur_i, "cur_i", torch.int32, (C, P), dev)
    _check(in_init, "in_init", torch.bool, (C, P), dev)
    _check(t, "t", torch.float32, (C, T), dev)
    _check(X, "X", torch.float32, (C, T, K), dev)
    _check(Xt, "Xt", torch.float32, (C, T, NT), dev)
    _check(Yt, "Yt", torch.int16, (C, B, T, P), dev)
    _check(vario, "vario", torch.float32, (C, P, B), dev)
    if dev.type == "cpu":
        return init_window_plain(alive, cur_i, in_init, t, X, Xt, Yt, vario,
                                 W=W, sensor=sensor)
    _check_landsat_roles(sensor)
    w_max = next((m for m in W_MAX_CHOICES if m >= W), None)
    if w_max is None:
        raise ValueError(f"window cap {W} exceeds the largest init_window "
                         f"instance ({W_MAX_CHOICES[-1]})")
    out = torch.empty(len(_INIT_KEYS), C, P, dtype=torch.int32, device=dev)
    w_stab = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    alive_init = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    _launch("init_window", _ptr(alive), _ptr(cur_i), _ptr(in_init), _ptr(t),
            _ptr(X), _ptr(Xt), _ptr(Yt), _ptr(vario), _ptr(out),
            _ptr(w_stab), _ptr(alive_init), C, T, P, W, w_max)
    d = {k: (out[i] != 0 if k in _INIT_BOOL else out[i])
         for i, k in enumerate(_INIT_KEYS)}
    return dict(d, w_stab=w_stab, alive_init=alive_init)


# The three functions the detector's rounds call, as kernels (the
# wrappers above) or as their plain versions; kernel.detect_packed takes
# either.
KERNELS = types.SimpleNamespace(lasso_fit=lasso_fit,
                                monitor_chain_scored=monitor_chain_scored,
                                init_window=init_window)
PLAIN = types.SimpleNamespace(lasso_fit=lasso_fit_plain,
                              monitor_chain_scored=monitor_chain_scored_plain,
                              init_window=init_window_plain)

"""The detector's CUDA kernels, their wrappers and plain versions.

The counterpart of ``firebird_tpu/ccd/pallas_ops.py`` for the routes this
package runs (the JAX package's ``FIREBIRD_PALLAS`` routes
``fit,score,init``, ``lasso,monitor,tmask`` and ``mega``, with
``FIREBIRD_FUSED_FIT`` off, ``1`` or ``mon``; kernel.pallas_components):

- :func:`lasso_fit` — Gram + correlation + coordinate-descent Lasso +
  RMSE per pixel (``csrc/lasso_fit.cu``; Pallas ``lasso_fit``).
- :func:`lasso_cd` — the coordinate-descent loop alone on a precomputed
  Gram (``csrc/lasso_cd.cu``; Pallas ``lasso_cd``).
- :func:`monitor_chain_scored` — the MONITOR round's score and event
  chain (``csrc/monitor_chain_scored.cu``; Pallas
  ``monitor_chain_scored``).
- :func:`monitor_chain` — the event chain alone on a precomputed score
  plane (``csrc/monitor_chain.cu``; Pallas ``monitor_chain``).
- :func:`init_window` — the INIT round: window search, Tmask IRLS screen
  and stability fit (``csrc/init_window.cu``, its screen
  ``csrc/tmask_warp.cuh``; Pallas ``init_window``).
- :func:`tmask_bad` — the Tmask IRLS screen alone on gathered windows
  (``csrc/tmask_bad.cu``, the same ``tmask_warp.cuh``; Pallas
  ``tmask_bad``).
- :func:`fused_fit_close` — a round's segment close and shared refit in
  one launch (``csrc/fused_fit_close.cu``; Pallas ``fused_fit_close``).
- :func:`fused_round` — the whole post-INIT round, monitor + close +
  refit, in one launch (``csrc/fused_round.cu``; Pallas ``fused_round``).
- :func:`detect_mega` — every pixel's whole event loop in one launch
  (``csrc/detect_mega.cu``; Pallas ``detect_mega``).
- :func:`ring_remote_copy` — one hop of the rebalancing ring: each
  shard's payload copied into buffers on its ring neighbour's device
  (``csrc/ring_remote_copy.cu``; Pallas ``ring_remote_copy``).

Each wrapper checks its tensors' device, dtype, shape and contiguity, then
runs its plain PyTorch version (``*_plain``, same contract) when they lie
on the CPU, and launches its CUDA kernel when they lie on a CUDA device;
nothing else chooses between the two.  The kernels
are compiled with ``nvcc`` for ``sm_90a`` at first use, one shared library
per source under ``build/firebird_tpu_torch/`` next to the package, and
bound through ``ctypes``.  ``LAUNCHES`` counts the kernel launches of each
wrapper.

Layouts (the pixel axis fastest): spectra ``[C,B,T,P]`` int16, time planes
``[C,T,P]``, per-pixel vectors ``[C,P]``, designs ``[C,T,K]``, segment
result buffers ``[C,P,S,k]``.  The fused kernels (and their plain versions)
update the result buffers in place.  The kernels over a pixel's whole
spectra are built for B in NB_CHOICES (Landsat ARD's 7 bands, Sentinel-2's
12); those that take a sensor read its detection and Tmask bands from
:func:`band_roles`.  ``lasso_fit``, ``monitor_chain_scored``,
``init_window``, ``tmask_bad``, ``fused_fit_close``, ``fused_round`` and
``detect_mega`` run TILE pixels a block (csrc/tile.cuh), the others one
thread a pixel.

The five kernels that fit (``lasso_fit``, ``init_window``,
``fused_fit_close``, ``fused_round``, ``detect_mega``) take ``mixed``: the
JAX package's FIREBIRD_MIXED_PRECISION, pallas_ops._gram_cd_core's mixed
branch.  Their Gram and correlations are then split bf16 dots with f32
accumulation (:func:`gram_plain` with ``mixed=True``; on the card the
tensor cores, ``csrc/mixed_gram.cuh``), their window count an integer;
everything after the dots stays float32.  Each is built a second time
with ``-DFB_MIXED=1`` into its mixed instance ``<name>_mixed``
(MIXED_SOURCES), launched and counted under that name.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from firebird_tpu_torch.ccd import params
from firebird_tpu_torch.ccd.primitives import (coefmask_for, dot_cols, fdiv,
                                               first_at_or_after, last_true,
                                               masked_median, take_plane,
                                               take_t, tree_sum)
# The plain version of :func:`tmask_bad`.
from firebird_tpu_torch.ccd.primitives import tmask_bad as tmask_bad_plain
from firebird_tpu_torch.ccd.round_state import (PHASE_DONE, PHASE_INIT,
                                                 PHASE_MONITOR, init_zeros,
                                                 next_state)
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD

K = params.MAX_COEFS
NT = params.TMASK_COEFS

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "firebird_tpu_torch"
SOURCES = ("lasso_fit", "monitor_chain_scored", "init_window",
           "fused_fit_close", "fused_round", "lasso_cd", "monitor_chain",
           "tmask_bad", "detect_mega", "ring_remote_copy")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# The sources built a second time as mixed-precision instances (FB_MIXED:
# the tensor-core Gram of csrc/mixed_gram.cuh), each a unit "<name>_mixed";
# UNITS are every library the kernels build into.
MIXED_SOURCES = ("lasso_fit", "init_window", "fused_fit_close",
                 "fused_round", "detect_mega")
MIXED_SUFFIX = "_mixed"
UNITS = SOURCES + tuple(n + MIXED_SUFFIX for n in MIXED_SOURCES)
# The window sizes the init_window, tmask_bad and detect_mega kernels are
# instantiated for (their shared-memory window rows, lanes' slots and
# detect_mega's local arrays are sized by it);
# window_cap of a 1985-2017 Landsat archive is 24, inside the 32 instance.
W_MAX_CHOICES = (32, 64, 128)
# The band counts the kernels over a pixel's whole spectra are instantiated
# for (fb::with_nb): Landsat ARD's 7 and Sentinel-2's 12.
NB_CHOICES = (7, 12)

LAUNCHES = {name: 0 for name in UNITS}
# Requests for a kernel refused from their shape before any launch, by
# kernel: ``detect_mega``'s route falls back to the round loop where
# :func:`mega_fits` refuses (kernel.BatchLoop).
REFUSED = {"detect_mega": 0}
_LIBS: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    "fb_lasso_fit": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "fb_monitor_chain_scored": [_P] * 12 + [_I, _I, _I, _I, _F, _F, _P],
    "fb_init_window": [_P] * 13 + [_I] * 6 + [_P],
    "fb_fused_fit_close": [_P] * 23 + [_I] * 5 + [_P],
    "fb_fused_round": [_P] * 27 + [_I] * 5 + [_F, _F, _P],
    "fb_lasso_cd": [_P] * 5 + [_I] * 2 + [_P],
    "fb_monitor_chain": [_P] * 9 + [_I] * 3 + [_F, _F, _P],
    "fb_tmask_bad": [_P] * 5 + [_I] * 3 + [_P],
    "fb_detect_mega": [_P] * 19 + [_I] * 8 + [_F, _F, _P],
    "fb_ring_remote_copy": [_P, _I, _P, _I, _P, _P],
}


def reset_launches() -> None:
    """Sets every launch count, and every refusal count, to 0."""
    for counts in (LAUNCHES, REFUSED):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(exe).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc")
    return exe


def source_of(unit: str) -> str:
    """The kernel source of a build unit: ``name`` for ``name`` and for its
    mixed instance ``name_mixed``."""
    return unit.removesuffix(MIXED_SUFFIX)


def unit_of(name: str, mixed: bool) -> str:
    """The build unit that runs kernel ``name`` (its mixed instance where
    ``mixed``)."""
    return name + MIXED_SUFFIX if mixed else name


def _flags(unit: str) -> tuple:
    return NVCC_FLAGS + (("-DFB_MIXED=1",) if unit != source_of(unit)
                         else ())


def _lib_path(unit: str) -> Path:
    h = hashlib.sha1(" ".join(_flags(unit)).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{source_of(unit)}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{unit}-{h.hexdigest()[:12]}.so"


def _compile(unit: str) -> Path:
    """Build one unit's library unless it exists.  Safe under several
    processes on one ``build/`` (one process per card): the build holds an
    exclusive lock on ``<unit>.lock`` and looks for the library again once
    it has the lock, so one process builds and the others load its file;
    ``nvcc`` writes to a name of this process's own, and the library and
    its ``.ptxas.txt`` land by an atomic rename."""
    out = _lib_path(unit)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{unit}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        pid = os.getpid()
        tmp = out.with_suffix(f".{pid}.tmp.so")
        src = CSRC / f"{source_of(unit)}.cu"
        cmd = [_nvcc(), *_flags(unit), "-o", str(tmp), str(src)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log = BUILD_DIR / f"{unit}.ptxas.txt"
        log_tmp = log.with_suffix(f".{pid}.tmp")
        log_tmp.write_text(r.stdout + r.stderr)
        log_tmp.replace(log)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {unit} ({src.name}):\n{r.stderr}")
        tmp.replace(out)
    return out


def build(names=UNITS) -> dict[str, Path]:
    """Compile the kernels' build units (one nvcc per unit, all at once)
    and load them; returns the library paths.  Built libraries are reused
    while their sources and flags are unchanged."""
    todo = [n for n in names if n not in _LIBS]
    with ThreadPoolExecutor(max(len(todo), 1)) as ex:
        paths = dict(zip(todo, ex.map(_compile, todo)))
    for n, p in paths.items():
        lib = ctypes.CDLL(str(p))
        sym = f"fb_{source_of(n)}"
        fn = getattr(lib, sym)
        fn.argtypes = _ARGTYPES[sym]
        fn.restype = ctypes.c_int
        _LIBS[n] = lib
    return {n: _lib_path(n) for n in names}


def _launch(unit: str, *args) -> None:
    if unit not in _LIBS:
        build((unit,))
    rc = getattr(_LIBS[unit], f"fb_{source_of(unit)}")(
        *args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{unit} kernel launch failed: CUDA error {rc}")
    LAUNCHES[unit] += 1


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


def _nb_instance(B: int, name: str) -> None:
    """Refuses a band count that kernel ``name`` is not instantiated for
    (NB_CHOICES)."""
    if B not in NB_CHOICES:
        raise ValueError(f"{name} is built for {NB_CHOICES} bands, got {B}")


def band_roles(sensor, B: int, name: str):
    """The sensor's band roles as the kernels take them (fb::Roles): the
    five detection bands' spectra indices, then the two Tmask bands'
    positions among the detection bands, as a pointer to a ctypes int
    array (and the array).  Refuses
    what no kernel instance holds: a band count outside NB_CHOICES, a
    layout without 5 detection and 2 Tmask bands, or a Tmask band that is
    not a detection band."""
    _nb_instance(B, name)
    det, tm = tuple(sensor.detection_bands), tuple(sensor.tmask_bands)
    if len(det) != 5 or len(tm) != 2 or not set(tm) <= set(det):
        raise ValueError(f"{name} takes 5 detection bands and 2 Tmask bands "
                         f"among them; sensor {sensor.name!r} has {det} and "
                         f"{tm}")
    if max(det) >= B:
        raise ValueError(f"sensor {sensor.name!r}: detection bands {det} "
                         f"outside {B} bands")
    # The array is returned beside its pointer: it must outlive the launch.
    arr = (ctypes.c_int * 7)(*det, *(det.index(b) for b in tm))
    return ctypes.cast(arr, _P), arr


def _w_instance(W: int, name: str) -> int:
    """The smallest W_MAX_CHOICES instance of kernel ``name`` that holds a
    window of ``W`` members; raises past the largest (there is no other
    route to fall back to)."""
    w_max = next((m for m in W_MAX_CHOICES if m >= W), None)
    if w_max is None:
        raise ValueError(f"window cap {W} exceeds the largest {name} "
                         f"instance ({W_MAX_CHOICES[-1]})")
    return w_max


# ---------------------------------------------------------------------------
# The tile kernels' launch (csrc/tile.cuh): fused_round, lasso_fit,
# monitor_chain_scored, fused_fit_close, detect_mega, lasso_cd and
# monitor_chain
# ---------------------------------------------------------------------------

# TILE pixels a block of FUSED_ROUND_THREADS threads; each kernel's dynamic
# shared memory grows with T.  fused_round runs at least
# FUSED_ROUND_MIN_BLOCKS blocks an SM (so at most FUSED_ROUND_REGS registers
# a thread).
TILE = 32
FUSED_ROUND_THREADS = 256
FUSED_ROUND_MIN_BLOCKS = 3
FUSED_ROUND_REGS = 80
# H100: the most shared memory one block may use, the SM's, and the
# registers and threads an SM holds.
SMEM_BLOCK_MAX = 227 * 1024
SMEM_SM = 228 * 1024
SMEM_RESERVED = 1024            # the runtime's share of each block
REGS_SM = 65536
THREADS_SM = 2048


def lasso_fit_smem_bytes(T: int) -> int:
    """The dynamic shared memory of one lasso_fit block at ``T``: X, a Gram
    a pixel, one weight mask of ceil(T/32) words a pixel, two ints a pixel
    and four more."""
    W = -(-T // 32)
    return 4 * (8 * T + TILE * (K * K + 1) + W * TILE + 2 * TILE + 4)


def monitor_chain_scored_smem_bytes(T: int) -> int:
    """The dynamic shared memory of one monitor_chain_scored block at
    ``T``: X, four bit masks of ceil(T/32) words a pixel and two ints a
    pixel."""
    W = -(-T // 32)
    return 4 * (8 * T + 4 * W * TILE + 2 * TILE)


def monitor_chain_smem_bytes(T: int) -> int:
    """The dynamic shared memory of one monitor_chain block at ``T``: four
    bit masks of ceil(T/32) words a pixel and two ints a pixel."""
    W = -(-T // 32)
    return 4 * (4 * W * TILE + 2 * TILE)


def lasso_cd_smem_bytes() -> int:
    """The dynamic shared memory of one lasso_cd block (any band count): a
    Gram a pixel of the tile (64 floats and 4 of padding), the queue of
    pixels with a chain to run (two tiles of ints) and its length, and a
    flag a pixel of the tile (bytes)."""
    return 4 * (TILE * (K * K + 4) + 2 * TILE + 1) + TILE


def fused_fit_close_smem_bytes(T: int) -> int:
    """The dynamic shared memory of one fused_fit_close block at ``T``: X
    and t, a Gram a pixel, the weight and included masks of ceil(T/32)
    words a pixel, three ints a pixel and four more."""
    W = -(-T // 32)
    return 4 * (9 * T + TILE * (K * K + 1) + 2 * W * TILE + 3 * TILE + 4)


def detect_mega_smem_bytes(T: int) -> int:
    """The dynamic shared memory of one detect_mega block at ``T``: X, t
    and Xt, then fused_round's tile round (a Gram a pixel, five bit masks
    of ceil(T/32) words a pixel, five ints a pixel and four more) and three
    ints a pixel of round state."""
    W = -(-T // 32)
    return 4 * ((K + 1 + NT) * T + TILE * (K * K + 1) + 5 * W * TILE
                + 5 * TILE + 4 + 3 * TILE)


# The longest series the kernels index (time steps are int16 in the INIT
# window's member positions).
T_MAX = 32767
# init_window's and tmask_bad's warps a block (one listed pixel each), and
# a warp's window area (csrc/tmask_warp.cuh's TmaskArea): the design's NT
# rows, two weights, two weighted values, ones and two ranked, then 16
# floats.
INIT_WARPS = FUSED_ROUND_THREADS // 32
TM_ROWS = NT + 7
TM_SCRATCH = 16


def init_window_smem_bytes(T: int, w_max: int) -> int:
    """The dynamic shared memory of one init_window block of the ``w_max``
    instance at ``T``: the alive words (ceil(T/32) a pixel), eight ints a
    pixel and four more, the fits' 4-coefficient rows and rmse (5 x 9 floats
    a pixel), then each warp's window area (TM_ROWS rows of w_max + 1
    floats, TM_SCRATCH more, w_max member steps), which the fit's Grams (65
    floats a pixel) alias.  It fits the card's 227 KB up to T_MAX at the
    largest instance (the kernel refuses no shape the one-thread kernel
    took)."""
    W = -(-T // 32)
    areas = INIT_WARPS * (TM_ROWS * (w_max + 1) + TM_SCRATCH + w_max)
    return 4 * (W * TILE + 8 * TILE + 4 + TILE * 5 * (K + 1)
                + max(areas, TILE * (K * K + 1)))


def tmask_bad_smem_bytes(w_max: int) -> int:
    """The dynamic shared memory of one tmask_bad block of the ``w_max``
    instance: each warp's window area (TM_ROWS rows of w_max + 1 floats and
    TM_SCRATCH more).  A warp reads its pixel's window straight from the
    gathered planes."""
    return 4 * INIT_WARPS * (TM_ROWS * (w_max + 1) + TM_SCRATCH)


def mega_fits(T: int, W: int) -> bool:
    """Whether ``detect_mega`` takes a batch of ``T`` time steps and window
    cap ``W`` on the card — the port's counterpart of pallas_ops.mega_fits:
    a window instance holds W (W_MAX_CHOICES), a block's shared memory at T
    fits the card's 227 KB (:func:`detect_mega_smem_bytes`), and T is at
    most T_MAX.  Decided from the shape alone, before any launch;
    kernel.BatchLoop sends a refused mega request down the round loop."""
    return (W <= W_MAX_CHOICES[-1] and T <= T_MAX
            and detect_mega_smem_bytes(T) <= SMEM_BLOCK_MAX)


def _check_smem(name: str, smem: int) -> None:
    """Refuses a block whose shared memory exceeds the card's 227 KB (the
    tile kernels have no other route)."""
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"{name} needs {smem} bytes of shared memory a "
                         f"block, more than {SMEM_BLOCK_MAX}")


# ---------------------------------------------------------------------------
# lasso_fit
# ---------------------------------------------------------------------------

def split_bf16(x):
    """The hi/lo bf16 split of a float32 tensor, each half rounded to
    nearest even and returned as float32: ``hi`` is x in bf16, ``lo`` the
    bf16 of the residual x - hi — pallas_ops._split_bf16.  An int16 value
    splits exactly (hi + lo == x)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi.float(), lo.float()


def gram_plain(Yt, w, X, mixed=False):
    """The weighted Gram ``sum_t w X X^T`` [C,P,8,8] and correlations
    ``sum_t w y X`` [C,P,B,8] over the time axis, both divided by the
    window count n = max(sum_t w, 1) [C,P] — kernel._fit_lasso_coefs'
    Gram.  Returns (G, c, n).

    ``mixed`` is pallas_ops._gram_cd_core's mixed branch: n the integer
    count of the 0/1 weights; G = (XXh.w + XXl.w) / n and c_b = ((th.yh +
    th.yl) + tl.yh) / n, with (XXh, XXl), (th, tl) and (yh, yl) the
    :func:`split_bf16` of XX = X_i X_j, of X and of y w.  Each split
    product is exact in float32, so every dot is a float32 sum over time
    (each its own einsum, as the f32 Gram), the terms added afterwards in
    that order."""
    C, B, T, P = Yt.shape
    XX = (X[:, :, :, None] * X[:, :, None, :]).reshape(C, T, K * K)
    dot = lambda a, b: torch.einsum("ctp,ctk->cpk", a, b)
    if not mixed:
        n = w.sum(1).clamp_min(1.0)                             # [C,P]
        G = dot(w, XX) / n[..., None]                           # [C,P,64]
        c = torch.stack([dot(Yt[:, b].to(w.dtype) * w, X)
                         for b in range(B)],
                        2) / n[:, :, None, None]                # [C,P,B,K]
        return G.reshape(C, P, K, K).contiguous(), c.contiguous(), n
    n = w.to(torch.int32).sum(1, dtype=torch.int32).clamp_min(1).to(w.dtype)
    xxh, xxl = split_bf16(XX)
    G = (dot(w, xxh) + dot(w, xxl)) / n[..., None]
    th, tl = split_bf16(X)
    cs = []
    for b in range(B):
        yh, yl = split_bf16(Yt[:, b].float() * w)
        cs.append(((dot(yh, th) + dot(yl, th)) + dot(yh, tl))
                  / n[..., None])
    return (G.reshape(C, P, K, K).contiguous(),
            torch.stack(cs, 2).contiguous(), n)


def lasso_cd_plain(G, c, diag, coefmask):
    """Plain version of :func:`lasso_cd` — kernel._lasso_cd_lax: LASSO_ITERS
    cyclic coordinate-descent sweeps (soft threshold LASSO_ALPHA, intercept
    unpenalized, coordinates outside ``coefmask`` held at zero), each
    coordinate's dot over the Gram row summed column by column."""
    diag = [diag[..., j][..., None] for j in range(K)]
    mask = [coefmask[..., j][..., None] for j in range(K)]
    Gjk = [[G[..., j, k][..., None] for k in range(K)] for j in range(K)]
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
    return torch.stack(b, -1)                                   # [C,P,B,K]


def rmse_plain(Yt, w, X, beta, n):
    """The windowed RMSE [C,P,B] of the model ``beta`` [C,P,B,8] over the
    weights ``w`` [C,T,P] with window count ``n`` [C,P], each prediction
    summed column by column and the squares over time in a fixed pairwise
    order (:func:`tree_sum`)."""
    rmse = []
    for bb in range(Yt.shape[1]):
        pred = dot_cols(beta[:, None, :, bb, :], X[:, :, None, :])  # [C,T,P]
        r = Yt[:, bb].to(pred.dtype) - pred
        rmse.append(torch.sqrt((tree_sum(r * r * w) / n).clamp_min(0.0)))
    return torch.stack(rmse, -1)


def lasso_fit_plain(Yt, w, X, coefmask, with_rmse=True, *, mixed=False,
                    cd=None):
    """Plain version of :func:`lasso_fit` — kernel._fit_lasso's math:
    :func:`gram_plain` (its mixed branch where ``mixed``), the CD loop
    ``cd`` on the Gram with its diagonal floored at 1e-12
    (:func:`lasso_cd_plain` unless given), then :func:`rmse_plain`.

    ``cd`` is how the ``lasso`` component route fits: kernel.pallas_components
    passes the :func:`lasso_cd` kernel, and the Gram and the RMSE around
    it are PyTorch ops on the card, as XLA computes them around the Pallas
    CD kernel in the JAX package (kernel._fit_lasso_coefs)."""
    cd = lasso_cd_plain if cd is None else cd
    C, B, T, P = Yt.shape
    G, c, n = gram_plain(Yt, w, X, mixed)
    tiny = torch.tensor(1e-12, dtype=G.dtype, device=G.device)
    diag = torch.maximum(torch.diagonal(G, dim1=-2, dim2=-1), tiny)
    beta = cd(G, c, diag.contiguous(), coefmask)
    if not with_rmse:
        return beta, torch.zeros(C, P, B, dtype=w.dtype, device=w.device)
    return beta, rmse_plain(Yt, w, X, beta, n)


def lasso_fit(Yt, w, X, coefmask, with_rmse=True, mixed=False):
    """Per-pixel weighted Lasso fit of every band, and its RMSE.

    Args:
        Yt: [C,B,T,P] int16 resident spectra.
        w: [C,T,P] float32 0/1 fit-window weights.
        X: [C,T,8] float32 designs.
        coefmask: [C,P,8] bool allowed coefficients.
        mixed: the mixed-precision Gram (the ``lasso_fit_mixed`` instance).
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
        return lasso_fit_plain(Yt, w, X, coefmask, with_rmse, mixed=mixed)
    _nb_instance(B, "lasso_fit")
    _check_smem("lasso_fit", lasso_fit_smem_bytes(T))
    coefs = torch.empty(C, P, B, K, dtype=torch.float32, device=dev)
    rmse = torch.empty(C, P, B, dtype=torch.float32, device=dev)
    _launch(unit_of("lasso_fit", mixed), _ptr(Yt), _ptr(w), _ptr(X),
            _ptr(coefmask), _ptr(coefs), _ptr(rmse), C, B, T, P,
            int(bool(with_rmse)))
    return coefs, rmse


def lasso_cd(G, c, diag, coefmask):
    """The Lasso coordinate-descent loop on precomputed Gram systems, per
    pixel and band: LASSO_ITERS cyclic sweeps, soft threshold LASSO_ALPHA,
    intercept unpenalized, coordinates outside ``coefmask`` held at zero.
    The kernel runs a band a lane and gives a band whose correlations are
    all zero, on a finite Gram with a positive finite diagonal, +0 without
    its sweeps: the sweeps give exactly that.

    Args:
        G: [C,P,8,8] float32 normalised Grams.
        c: [C,P,B,8] float32 normalised correlations per band.
        diag: [C,P,8] float32 Gram diagonals, floored.
        coefmask: [C,P,8] bool allowed coefficients.
    Returns:
        beta [C,P,B,8] float32.
    """
    C, P, B = c.shape[:3]
    dev = c.device
    _check(G, "G", torch.float32, (C, P, K, K), dev)
    _check(c, "c", torch.float32, (C, P, B, K), dev)
    _check(diag, "diag", torch.float32, (C, P, K), dev)
    _check(coefmask, "coefmask", torch.bool, (C, P, K), dev)
    if dev.type == "cpu":
        return lasso_cd_plain(G, c, diag, coefmask)
    _nb_instance(B, "lasso_cd")
    for nm, v in (("G", G), ("c", c), ("diag", diag)):
        if v.data_ptr() % 16:
            raise ValueError(f"lasso_cd reads {nm} in 16-byte loads: it must "
                             f"start on a 16-byte boundary")
    beta = torch.empty(C, P, B, K, dtype=torch.float32, device=dev)
    _launch("lasso_cd", _ptr(G), _ptr(c), _ptr(diag), _ptr(coefmask),
            _ptr(beta), C * P, B)
    return beta


# ---------------------------------------------------------------------------
# monitor_chain_scored
# ---------------------------------------------------------------------------

def score_plain(Yd, coefs_d, dden, X):
    """The chi-square score plane [C,T,P]: sum over detection bands of
    ((y - X beta) / dden)^2, each prediction summed column by column."""
    s = None
    for b in range(Yd.shape[1]):
        pred = dot_cols(coefs_d[:, None, :, b, :], X[:, :, None, :])
        r = (Yd[:, b].to(pred.dtype) - pred) / dden[:, None, :, b]
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
    refit_hit = absq & (n_inc.to(s.dtype) >= params.REFIT_FACTOR
                        * n_last_fit.to(s.dtype)[:, None, :])
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
                               outlier_thr, chain=None):
    """Plain version of :func:`monitor_chain_scored`: the score plane
    (:func:`score_plain`), then the event chain ``chain``
    (:func:`monitor_chain_plain` unless given).

    ``chain`` is how the ``monitor`` component route scores:
    kernel.pallas_components passes the :func:`monitor_chain` kernel, and
    the score plane is PyTorch ops on the card, as XLA computes it before
    the Pallas chain kernel in the JAX package (kernel._mon_block)."""
    chain = monitor_chain_plain if chain is None else chain
    s = score_plain(Yd, coefs_d, dden, X)
    return chain(s, alive, included, cur_k, n_last_fit, in_mon,
                 change_thr=change_thr, outlier_thr=outlier_thr)


_MON_KEYS = ("m", "is_tail", "is_brk", "is_refit", "ev_rank", "pos_ev",
             "n_exceed", "n_rf")
_MON_BOOL = ("is_tail", "is_brk", "is_refit")


def monitoring_only(mon, in_mon):
    """A monitor dict (:func:`monitor_chain_scored`'s) with every field of
    the pixels that do not monitor set to zero — what the kernel returns
    for them, and all that any consumer reads of them."""
    plane = in_mon[:, None, :]
    return {k: (v & plane if k in ("inc_q", "rem_q")
                else torch.where(in_mon, v, torch.zeros_like(v)))
            for k, v in mon.items()}


def _mon_outputs(out, inc_q, rem_q):
    d = {k: (out[i] != 0 if k in _MON_BOOL else out[i])
         for i, k in enumerate(_MON_KEYS)}
    return dict(d, inc_q=inc_q, rem_q=rem_q)


def monitor_chain(s, alive, included, cur_k, n_last_fit, in_mon, *,
                  change_thr, outlier_thr):
    """The MONITOR event logic on a precomputed score plane: locate each
    pixel's first event (break / refit / tail) and partition the
    observations before it.

    Args:
        s: [C,T,P] float32 score plane.
        alive, included: [C,T,P] bool.
        cur_k, n_last_fit: [C,P] int32; in_mon: [C,P] bool.
    Returns:
        :func:`monitor_chain_scored`'s dict.  The alive ranks are counted
        inside (the Pallas kernel takes them as an input plane).  As
        :func:`monitor_chain_scored`, a pixel that does not monitor gets
        zeros from the kernel and, from the plain version, what the Pallas
        kernel gives it (:func:`monitoring_only`).
    """
    C, T, P = s.shape
    dev = s.device
    _check(s, "s", torch.float32, (C, T, P), dev)
    for nm, v in (("alive", alive), ("included", included)):
        _check(v, nm, torch.bool, (C, T, P), dev)
    for nm, v in (("cur_k", cur_k), ("n_last_fit", n_last_fit)):
        _check(v, nm, torch.int32, (C, P), dev)
    _check(in_mon, "in_mon", torch.bool, (C, P), dev)
    if dev.type == "cpu":
        return monitor_chain_plain(s, alive, included, cur_k, n_last_fit,
                                   in_mon, change_thr=change_thr,
                                   outlier_thr=outlier_thr)
    _check_smem("monitor_chain", monitor_chain_smem_bytes(T))
    out = torch.empty(len(_MON_KEYS), C, P, dtype=torch.int32, device=dev)
    inc_q = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    rem_q = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    _launch("monitor_chain", _ptr(s), _ptr(alive), _ptr(included),
            _ptr(cur_k), _ptr(n_last_fit), _ptr(in_mon), _ptr(out),
            _ptr(inc_q), _ptr(rem_q), C, T, P, float(change_thr),
            float(outlier_thr))
    return _mon_outputs(out, inc_q, rem_q)


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
        [C,T,P] bool.  A pixel that does not monitor gets zeros from the
        kernel (kernel._mon_zeros; it scores nothing for it) and, from the
        plain version, what the Pallas kernel gives it: every consumer
        masks it on ``in_mon`` (:func:`monitoring_only`).
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
    _check_smem("monitor_chain_scored", monitor_chain_scored_smem_bytes(T))
    out = torch.empty(len(_MON_KEYS), C, P, dtype=torch.int32, device=dev)
    inc_q = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    rem_q = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    _launch("monitor_chain_scored", _ptr(Yd), _ptr(coefs_d), _ptr(dden),
            _ptr(X), _ptr(alive), _ptr(included), _ptr(cur_k),
            _ptr(n_last_fit), _ptr(in_mon), _ptr(out), _ptr(inc_q),
            _ptr(rem_q), C, nb, T, P, float(change_thr), float(outlier_thr))
    return _mon_outputs(out, inc_q, rem_q)


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


def init_window_gather(alive, cur_i, in_init, t, X, Xt, Yt, *, W):
    """The INIT block's window, gathered by position — the first half of
    kernel._init_block: the first alive observation ``i`` at or after the
    cursor, the window end ``j`` (MEOW_SIZE alive observations spanning
    INIT_DAYS), the window plane ``w_init`` [C,T,P] of the initializing
    pixels, and the members' values ``Yw`` [C,P,B,W] and design rows
    ``Xw8`` [C,P,W,8], ``Xt_w`` [C,P,W,5] with their validity ``valid_w``
    [C,P,W] (each slot holds exactly one observation, as the JAX one-hot
    selection does)."""
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
    Yw = torch.stack([Yt[:, b][ci, pos, pi].to(X.dtype)
                      for b in range(Yt.shape[1])], 2)          # [C,P,B,W]
    Yw = torch.where(exists[:, :, None, :], Yw, torch.zeros_like(Yw))
    Xw = torch.cat([X, Xt], -1)[ci, pos]                        # [C,P,W,13]
    Xw = torch.where(exists[..., None], Xw, torch.zeros_like(Xw))
    return dict(i=i, t_i=t_i, j=j, has_w=has_w, w_init=w_init, n_win=n_win,
                valid_w=valid_w, pos=pos, Yw=Yw, Xw8=Xw[..., :K],
                Xt_w=Xw[..., K:])


def tmask_args(win, vario, sensor=LANDSAT_ARD):
    """The Tmask screen's inputs from a gathered window
    (:func:`init_window_gather`): (Xtw [C,P,W,5], Y2 [C,P,2,W], w [C,P,W],
    vario2 [C,P,2]) — kernel._init_block's call of _tmask_bad."""
    tmb = list(sensor.tmask_bands)
    return (win["Xt_w"].contiguous(), win["Yw"][:, :, tmb],
            win["valid_w"].to(vario.dtype), vario[:, :, tmb])


def init_window_plain(alive, cur_i, in_init, t, X, Xt, Yt, vario, *, W,
                      sensor=LANDSAT_ARD, mixed=False, fit=None, tmask=None):
    """Plain version of :func:`init_window` — the XLA body of
    kernel._init_block: :func:`init_window_gather`, the Tmask screen
    ``tmask`` (:func:`tmask_bad_plain` unless given), the 4-coefficient
    stability fit ``fit`` (:func:`lasso_fit_plain`, with the mixed Gram
    where ``mixed``, unless given), the stability test and the cursor
    advances.

    ``fit`` and ``tmask`` are how the ``tmask`` component route
    initializes: kernel.pallas_components passes the :func:`tmask_bad`
    kernel and the route's fit (which carries the route's precision, so
    ``mixed`` must then stay False), and the rest of the block is PyTorch
    ops on the card, as it is XLA around the Pallas Tmask kernel in the
    JAX package (kernel._init_block)."""
    if fit is None:
        fit = functools.partial(lasso_fit_plain, mixed=mixed)
    elif mixed:
        raise ValueError("init_window_plain: a given fit carries its own "
                         "precision; pass mixed=False")
    tmask = tmask_bad_plain if tmask is None else tmask
    det = list(sensor.detection_bands)
    C, T, P = alive.shape
    dev = alive.device
    win = init_window_gather(alive, cur_i, in_init, t, X, Xt, Yt, W=W)
    i, t_i, j, has_w = win["i"], win["t_i"], win["j"], win["has_w"]
    w_init, n_win, valid_w = win["w_init"], win["n_win"], win["valid_w"]
    pos, Yw, Xw8 = win["pos"], win["Yw"], win["Xw8"]

    bad_w = tmask(*tmask_args(win, vario, sensor))              # [C,P,W]
    ci = torch.arange(C, device=dev)[:, None, None]
    pi = torch.arange(P, device=dev)[None, :, None]
    bad = torch.zeros(C, T, P, dtype=torch.int32, device=dev)
    bad.index_put_((ci.expand_as(pos), pos, pi.expand_as(pos)),
                   bad_w.to(torch.int32), accumulate=True)
    bad = bad > 0
    tm_removed = bad_w.any(-1)

    w_stab = w_init & ~tm_removed[:, None, :]
    cm4 = (torch.arange(K, device=dev) < 4).expand(C, P, K)
    c4, _ = fit(Yt, w_stab.to(X.dtype), X, cm4.contiguous(),
                with_rmse=False)
    r_w = Yw - dot_cols(c4[:, :, :, None, :], Xw8[:, :, None, :, :])  # [C,P,B,W]
    stab_w = valid_w & ~bad_w
    stab_f = stab_w.to(X.dtype)[:, :, None, :]
    n4 = stab_w.sum(-1).to(X.dtype).clamp_min(1.0)[..., None]
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


def init_window(alive, cur_i, in_init, t, X, Xt, Yt, vario, *, W,
                sensor=LANDSAT_ARD, mixed=False):
    """The INIT round per pixel: find the initialization window (MEOW_SIZE
    alive observations spanning INIT_DAYS from the cursor), screen it with
    the Tmask IRLS, test the 4-coefficient fit's stability, and advance the
    cursor.

    Args:
        alive: [C,T,P] bool; cur_i: [C,P] int32; in_init: [C,P] bool.
        t: [C,T] float32 ordinal days; X: [C,T,8], Xt: [C,T,5] designs.
        Yt: [C,B,T,P] int16 spectra; vario: [C,P,B] float32.
        W: bound on the window's member count (kernel.window_cap).
        mixed: the stability fit's mixed-precision Gram (the
            ``init_window_mixed`` instance).
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
                                 W=W, sensor=sensor, mixed=mixed)
    roles, _keep = band_roles(sensor, B, "init_window")
    w_max = _w_instance(W, "init_window")
    flags = torch.empty(len(_INIT_BOOL), C, P, dtype=torch.bool, device=dev)
    out = torch.empty(len(_INIT_KEYS) - len(_INIT_BOOL), C, P,
                      dtype=torch.int32, device=dev)
    w_stab = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    alive_init = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    _launch(unit_of("init_window", mixed), _ptr(alive), _ptr(cur_i),
            _ptr(in_init), _ptr(t), _ptr(X), _ptr(Xt), _ptr(Yt), _ptr(vario),
            _ptr(flags), _ptr(out), _ptr(w_stab), _ptr(alive_init), roles, C,
            B, T, P, W, w_max)
    d = dict(zip(_INIT_KEYS, (*flags, *out)))
    return dict(d, w_stab=w_stab, alive_init=alive_init)


# ---------------------------------------------------------------------------
# tmask_bad
# ---------------------------------------------------------------------------

def tmask_bad(Xtw, Y2, w, vario2):
    """The Tmask IRLS screen on gathered windows (kernel._tmask_bad):
    TMASK_IRLS_ITERS Huber reweightings of a 5x5 SPD solve per Tmask band,
    MAD sigma, a flag where the final residual exceeds TMASK_CONST x the
    band's variogram.  Slots with weight 0 are no members.

    Args:
        Xtw: [C,P,W,5] float32 no-trend design rows of the window members.
        Y2: [C,P,2,W] float32 Tmask-band values.
        w: [C,P,W] float32 0/1 slot validity.
        vario2: [C,P,2] float32 the Tmask bands' variogram.
    Returns:
        [C,P,W] bool flags.
    """
    C, P, W = w.shape
    dev = w.device
    _check(Xtw, "Xtw", torch.float32, (C, P, W, NT), dev)
    _check(Y2, "Y2", torch.float32, (C, P, 2, W), dev)
    _check(w, "w", torch.float32, (C, P, W), dev)
    _check(vario2, "vario2", torch.float32, (C, P, 2), dev)
    if dev.type == "cpu":
        return tmask_bad_plain(Xtw, Y2, w, vario2)
    w_max = _w_instance(W, "tmask_bad")
    bad = torch.empty(C, P, W, dtype=torch.bool, device=dev)
    _launch("tmask_bad", _ptr(Xtw), _ptr(Y2), _ptr(w), _ptr(vario2),
            _ptr(bad), C * P, W, w_max)
    return bad


# ---------------------------------------------------------------------------
# The segment close (shared by the round loop and the fused kernels' plain
# versions)
# ---------------------------------------------------------------------------

def peek_run_mags(Yt, X, alive, coefs, ev_rank, m):
    """Break magnitudes [C,P,B]: per band, the median residual of the
    closing model over the PEEK run, the alive observations of ranks
    ``ev_rank`` .. ``ev_rank + PEEK_SIZE - 1`` below ``m`` —
    kernel._close_mags in its wire-resident form.  The run members are
    gathered by position from the int16 spectra (each member is one
    observation, as the JAX one-hot selection is)."""
    C, T, P = alive.shape
    dev = alive.device
    acum = torch.cumsum(alive, 1, dtype=torch.int32).transpose(1, 2).contiguous()
    relk = ev_rank[..., None] + torch.arange(
        params.PEEK_SIZE, device=dev, dtype=torch.int32)        # [C,P,K]
    run_ok = relk < m[..., None]
    pos = torch.searchsorted(acum, (relk + 1).contiguous(), side="left")
    exists = pos < T
    pos = pos.clamp_max(T - 1)
    ci = torch.arange(C, device=dev)[:, None, None]
    pi = torch.arange(P, device=dev)[None, :, None]
    X_run = X[ci, pos]                                          # [C,P,K,8]
    X_run = torch.where(exists[..., None], X_run, torch.zeros_like(X_run))
    Y_run = torch.stack([Yt[:, b][ci, pos, pi].to(X.dtype)
                         for b in range(Yt.shape[1])], 2)       # [C,P,B,K]
    Y_run = torch.where(exists[:, :, None, :], Y_run, torch.zeros_like(Y_run))
    pred_run = dot_cols(coefs[:, :, :, None, :], X_run[:, :, None])
    return masked_median(Y_run - pred_run, run_ok[:, :, None, :])


def close_meta(t, included_mon, is_brk, pos_ev, n_exceed, first_seg):
    """The closing segments' meta rows [C,P,6] (sday, eday, bday, chprob,
    curqa, nobs) — kernel._close_block's meta_new.  The segment spans the
    round's included observations (first -> 0, last -> T-1 where none)."""
    last_inc = last_true(included_mon)
    _, first_inc = first_at_or_after(included_mon, torch.zeros_like(pos_ev))
    end_day = take_t(t, last_inc)
    qa_tail = params.CURVE_QA_END + torch.where(
        first_seg, params.CURVE_QA_START, 0)
    qa_brk = torch.where(first_seg, params.CURVE_QA_START,
                         params.CURVE_QA_INSIDE)
    # The tail's change probability is an int32 count over PEEK_SIZE, a
    # float32 division in the JAX package whatever the run's dtype (its
    # int32 true division), widened after.
    chprob = fdiv(n_exceed.to(torch.float32), params.PEEK_SIZE).to(t.dtype)
    return torch.stack([
        take_t(t, first_inc), end_day,
        torch.where(is_brk, take_t(t, pos_ev), end_day),
        torch.where(is_brk, torch.ones_like(end_day), chprob),
        torch.where(is_brk, qa_brk, qa_tail).to(t.dtype),
        included_mon.sum(1).to(t.dtype)], -1)


def write_slot(bufs, nseg, close, rows):
    """Append one row per closing pixel at its slot ``nseg`` of the
    [C,P,S,k] buffers, in place — kernel._write_seg.  The one slot writer
    of the port: the prologue's alternate-procedure segment, route 0's
    close block and the fused kernels' plain versions all use it.
    ``rows`` are (meta [C,P,6], rmse [C,P,B], mag [C,P,B], coef
    [C,P,B,K]).  Rows past the capacity S are dropped, but ``nseg`` counts
    every close (the contract kernel.capacity_retry relies on).  Returns
    (bufs, nseg')."""
    S = bufs[0].shape[2]
    ci, pi = torch.nonzero(close & (nseg < S), as_tuple=True)
    si = nseg[ci, pi].long()
    for buf, row in zip(bufs, rows):
        buf[ci, pi, si] = row[ci, pi]
    return bufs, nseg + close.to(torch.int32)


def _check_bufs(bufs, C, P, B, dev):
    S = bufs[0].shape[2] if bufs[0].dim() == 4 else -1
    for nm, v, k in zip(("meta", "rmse_b", "mag_b", "coef_b"), bufs,
                        ((6,), (B,), (B,), (B, K))):
        _check(v, nm, torch.float32, (C, P, S) + k, dev)
    return S


# ---------------------------------------------------------------------------
# fused_fit_close
# ---------------------------------------------------------------------------

def fused_fit_close_plain(Yt, X, t, w_fit, do_fit, n_full, included_mon,
                          coefs, rmse, mags, is_tail, is_brk, pos_ev,
                          n_exceed, first_seg, nseg, bufs, mixed=False):
    """Plain version of :func:`fused_fit_close`: the close row write
    (kernel._close_block with the given magnitudes), the Lasso fit of
    :func:`lasso_fit_plain` over ``w_fit`` (the mixed Gram where
    ``mixed``), and the ``do_fit`` merge."""
    meta = close_meta(t, included_mon, is_brk, pos_ev, n_exceed, first_seg)
    mag_new = torch.where(is_brk[..., None], mags, torch.zeros_like(mags))
    bufs, nseg_n = write_slot(bufs, nseg, is_tail | is_brk,
                              (meta, rmse, mag_new, coefs))
    return (bufs, nseg_n) + _refit(Yt, w_fit, X, n_full, do_fit, coefs, rmse,
                                   mixed)


def _refit(Yt, w, X, n_full, do_fit, coefs, rmse, mixed):
    """The shared fit's do_fit merge: a new :func:`lasso_fit_plain` model
    where ``do_fit``, the current one elsewhere (no fit at all when no
    pixel fits)."""
    if not bool(do_fit.any()):
        return coefs, rmse
    cfull, rfull = lasso_fit_plain(Yt, w, X, coefmask_for(n_full),
                                   mixed=mixed)
    return (torch.where(do_fit[..., None, None], cfull, coefs),
            torch.where(do_fit[..., None], rfull, rmse))


def fused_fit_close(Yt, X, t, w_fit, do_fit, n_full, included_mon, coefs,
                    rmse, mags, is_tail, is_brk, pos_ev, n_exceed, first_seg,
                    nseg, bufs, mixed=False):
    """One round's segment close and shared Lasso refit in one launch.

    The closing pixels (``is_tail | is_brk``) append their segment — the
    meta row, the current model's rmse and coefficients, the break
    magnitudes ``mags`` where ``is_brk`` — at slot ``nseg``; the pixels
    with ``do_fit`` get a new fit over ``w_fit`` with the 4/6/8
    coefficients that ``n_full`` allows, the others keep their model.

    Args:
        Yt: [C,B,T,P] int16 resident spectra; X: [C,T,8], t: [C,T] f32.
        w_fit: [C,T,P] float32 0/1 fit windows.
        do_fit: [C,P] bool; n_full: [C,P] int32 the fit's count.
        included_mon: [C,T,P] bool the round's included plane.
        coefs [C,P,B,8], rmse [C,P,B]: the current model (it closes the
            segment); mags [C,P,B] break magnitudes (kernel._close_mags).
        is_tail, is_brk, first_seg: [C,P] bool; pos_ev, n_exceed, nseg:
            [C,P] int32.
        bufs: (meta [C,P,S,6], rmse [C,P,S,B], mag [C,P,S,B],
            coef [C,P,S,B,8]) float32, updated in place.
        mixed: the refit's mixed-precision Gram (the
            ``fused_fit_close_mixed`` instance).
    Returns:
        (bufs, nseg' [C,P] int32, coefs' [C,P,B,8], rmse' [C,P,B]).
    """
    C, B, T, P = Yt.shape
    dev = Yt.device
    _check(Yt, "Yt", torch.int16, (C, B, T, P), dev)
    _check(X, "X", torch.float32, (C, T, K), dev)
    _check(t, "t", torch.float32, (C, T), dev)
    _check(w_fit, "w_fit", torch.float32, (C, T, P), dev)
    _check(included_mon, "included_mon", torch.bool, (C, T, P), dev)
    _check(coefs, "coefs", torch.float32, (C, P, B, K), dev)
    for nm, v in (("rmse", rmse), ("mags", mags)):
        _check(v, nm, torch.float32, (C, P, B), dev)
    for nm, v in (("do_fit", do_fit), ("is_tail", is_tail),
                  ("is_brk", is_brk), ("first_seg", first_seg)):
        _check(v, nm, torch.bool, (C, P), dev)
    for nm, v in (("n_full", n_full), ("pos_ev", pos_ev),
                  ("n_exceed", n_exceed), ("nseg", nseg)):
        _check(v, nm, torch.int32, (C, P), dev)
    S = _check_bufs(bufs, C, P, B, dev)
    if dev.type == "cpu":
        return fused_fit_close_plain(Yt, X, t, w_fit, do_fit, n_full,
                                     included_mon, coefs, rmse, mags, is_tail,
                                     is_brk, pos_ev, n_exceed, first_seg,
                                     nseg, bufs, mixed)
    _nb_instance(B, "fused_fit_close")
    _check_smem("fused_fit_close", fused_fit_close_smem_bytes(T))
    nseg_o = torch.empty_like(nseg)
    coefs_o = torch.empty_like(coefs)
    rmse_o = torch.empty_like(rmse)
    _launch(unit_of("fused_fit_close", mixed), *map(_ptr, (
        Yt, X, t, w_fit, do_fit, n_full, included_mon, coefs, rmse, mags,
        is_tail, is_brk, pos_ev, n_exceed, first_seg, nseg, *bufs, nseg_o,
        coefs_o, rmse_o)), C, B, T, P, S)
    return bufs, nseg_o, coefs_o, rmse_o


# ---------------------------------------------------------------------------
# fused_round
# ---------------------------------------------------------------------------

def fused_round_smem_bytes(T: int) -> int:
    """The dynamic shared memory of one fused_round block at ``T``: X and
    t, a Gram a pixel (65 floats), five bit masks of ceil(T/32) words a
    pixel and five ints a pixel."""
    W = -(-T // 32)
    return 4 * (9 * T + TILE * (K * K + 1) + 5 * W * TILE + 5 * TILE + 4)


def fused_round_geometry(T: int) -> dict:
    """The fused_round launch at ``T``: its shared memory and the blocks
    and warps resident on one SM (the fewer that the register cap and the
    shared memory allow).  Raises where a block's shared memory exceeds
    the card's 227 KB (the kernel has no other route)."""
    smem = fused_round_smem_bytes(T)
    _check_smem("fused_round", smem)
    thr = FUSED_ROUND_THREADS
    blocks = min(THREADS_SM // thr, REGS_SM // (FUSED_ROUND_REGS * thr),
                 SMEM_SM // (smem + SMEM_RESERVED))
    return dict(smem_bytes=smem, blocks_per_sm=blocks,
                warps_per_sm=blocks * thr // 32)


def _geometry(unit: str, *args) -> dict:
    """A built tile kernel's launch geometry (its source's
    ``fb_<name>_geometry``): dynamic shared memory, resident blocks an SM,
    registers and local bytes a thread."""
    out = (ctypes.c_int * 4)()
    fn = getattr(_LIBS[unit], f"fb_{source_of(unit)}_geometry")
    fn.argtypes, fn.restype = [_I] * len(args) + [_P], ctypes.c_int
    rc = fn(*args, ctypes.cast(out, _P))
    if rc != 0:
        raise RuntimeError(f"{unit} geometry: CUDA error {rc}")
    return dict(smem_bytes=out[0], blocks_per_sm=out[1], registers=out[2],
                local_bytes=out[3])


def init_window_geometry(T: int, mixed: bool = False) -> dict:
    """Each window instance of init_window (its mixed instance where
    ``mixed``) at ``T``, as the CUDA runtime reports it (shared memory,
    resident blocks an SM, registers and local bytes a thread), by
    instance."""
    unit = unit_of("init_window", mixed)
    build((unit,))
    return {w: _geometry(unit, w, T) for w in W_MAX_CHOICES}


def kernel_geometry(T: int, nb: int = 7, mixed: bool = False) -> dict:
    """The built kernels' launch geometry on the current card, as the CUDA
    runtime reports it: the shared memory, resident blocks an SM,
    registers and local bytes a thread at ``T`` of fused_round's,
    fused_fit_close's and each window instance of detect_mega's
    ``nb``-band instance (detect_mega by its window instance), of each
    window instance of init_window at ``T``, of tmask_bad, of lasso_cd's
    ``nb``-band instance and of monitor_chain at ``T``; ring_remote_copy's
    resident blocks an SM.  ``mixed``: the fitting kernels' mixed
    instances."""
    u = functools.partial(unit_of, mixed=mixed)
    build((u("fused_round"), u("fused_fit_close"), u("detect_mega"),
           "ring_remote_copy", u("init_window"), "tmask_bad", "lasso_cd",
           "monitor_chain"))
    blocks = ctypes.c_int()
    fn = _LIBS["ring_remote_copy"].fb_ring_remote_copy_blocks_per_sm
    fn.argtypes, fn.restype = [_P], ctypes.c_int
    rc = fn(ctypes.cast(ctypes.byref(blocks), _P))
    if rc != 0:
        raise RuntimeError(f"ring_remote_copy geometry: CUDA error {rc}")
    return dict(fused_round=_geometry(u("fused_round"), nb, T),
                fused_fit_close=_geometry(u("fused_fit_close"), nb, T),
                detect_mega={w: _geometry(u("detect_mega"), nb, w, T)
                             for w in W_MAX_CHOICES},
                init_window=init_window_geometry(T, mixed),
                tmask_bad={w: _geometry("tmask_bad", w)
                           for w in W_MAX_CHOICES},
                lasso_cd=_geometry("lasso_cd", nb),
                monitor_chain=_geometry("monitor_chain", T),
                ring_remote_copy=dict(blocks_per_sm=blocks.value))


_EV_KEYS = ("is_tail", "is_brk", "is_refit", "pos_ev", "do_fit", "n_full")
_EV_BOOL = ("is_tail", "is_brk", "is_refit", "do_fit")


def fused_round_plain(Yt, X, t, alive, included, cur_k, n_last_fit, in_mon,
                      coefs, rmse, vario, init_ok, w_stab, n_ok, first_seg,
                      nseg, bufs, *, change_thr, outlier_thr,
                      sensor=LANDSAT_ARD, mixed=False):
    """Plain version of :func:`fused_round`: :func:`monitor_chain_scored_plain`
    with the event outputs zeroed where a pixel does not monitor
    (kernel._mon_zeros), the include/remove update, the PEEK-run close
    (:func:`peek_run_mags`, :func:`close_meta`, :func:`write_slot`), then
    :func:`lasso_fit_plain` on the init-ok / refit windows (the mixed
    Gram where ``mixed``)."""
    det = list(sensor.detection_bands)
    dden = torch.maximum(rmse, vario)[:, :, det].contiguous()
    mon = monitor_chain_scored_plain(
        Yt[:, det].contiguous(), coefs[:, :, det].contiguous(), dden, X,
        alive, included, cur_k, n_last_fit, in_mon, change_thr=change_thr,
        outlier_thr=outlier_thr)
    zero = lambda v: torch.where(in_mon, v, torch.zeros_like(v))
    is_tail, is_brk, is_refit = mon["is_tail"], mon["is_brk"], mon["is_refit"]
    pos_ev, n_rf = zero(mon["pos_ev"]), zero(mon["n_rf"])
    included_mon = included | (mon["inc_q"] & in_mon[:, None, :])
    alive_mon = alive & ~(mon["rem_q"] & in_mon[:, None, :])

    mags = torch.zeros_like(rmse)
    if bool(is_brk.any()):
        mags = torch.where(is_brk[..., None], peek_run_mags(
            Yt, X, alive, coefs, mon["ev_rank"], mon["m"]), mags)
    meta = close_meta(t, included_mon, is_brk, pos_ev, mon["n_exceed"],
                      first_seg)
    bufs, nseg_n = write_slot(bufs, nseg, is_tail | is_brk,
                              (meta, rmse, mags, coefs))

    do_fit = init_ok | is_refit
    n_full = torch.where(init_ok, n_ok, n_rf)
    w = torch.where(init_ok[:, None, :], w_stab,
                    included_mon & is_refit[:, None, :])
    coefs_n, rmse_n = _refit(Yt, w.to(X.dtype), X, n_full, do_fit, coefs,
                             rmse, mixed)
    ev = dict(is_tail=is_tail, is_brk=is_brk, is_refit=is_refit,
              pos_ev=pos_ev, do_fit=do_fit, n_full=n_full,
              included_mon=included_mon, alive_mon=alive_mon)
    return bufs, nseg_n, coefs_n, rmse_n, ev


def fused_round(Yt, X, t, alive, included, cur_k, n_last_fit, in_mon, coefs,
                rmse, vario, init_ok, w_stab, n_ok, first_seg, nseg, bufs, *,
                change_thr, outlier_thr, sensor=LANDSAT_ARD, mixed=False):
    """The whole post-INIT round in one launch: the monitoring pixels'
    score and event chain, the segment close of the pixels that end in a
    tail or a break (magnitudes from the PEEK run), and the shared Lasso
    refit of the init-ok pixels (over ``w_stab``) and the refitting ones
    (over the round's included observations).

    Args:
        Yt: [C,B,T,P] int16 resident spectra; X: [C,T,8], t: [C,T] f32.
        alive, included: [C,T,P] bool state planes.
        cur_k, n_last_fit: [C,P] int32; in_mon: [C,P] bool.
        coefs [C,P,B,8], rmse [C,P,B]: the current model; vario [C,P,B].
        init_ok: [C,P] bool, w_stab: [C,T,P] bool, n_ok: [C,P] int32 —
            the INIT block's fit handoff.
        first_seg: [C,P] bool; nseg: [C,P] int32.
        bufs: the four [C,P,S,k] result buffers, updated in place.
        mixed: the refit's mixed-precision Gram (the ``fused_round_mixed``
            instance).
    Returns:
        (bufs, nseg', coefs', rmse', ev): ``ev`` holds is_tail, is_brk,
        is_refit, do_fit [C,P] bool, pos_ev, n_full [C,P] int32 (0 for a
        pixel that neither monitors nor initialized) and included_mon,
        alive_mon [C,T,P] bool.
    """
    C, B, T, P = Yt.shape
    dev = Yt.device
    _check(Yt, "Yt", torch.int16, (C, B, T, P), dev)
    _check(X, "X", torch.float32, (C, T, K), dev)
    _check(t, "t", torch.float32, (C, T), dev)
    for nm, v in (("alive", alive), ("included", included),
                  ("w_stab", w_stab)):
        _check(v, nm, torch.bool, (C, T, P), dev)
    for nm, v in (("cur_k", cur_k), ("n_last_fit", n_last_fit),
                  ("n_ok", n_ok), ("nseg", nseg)):
        _check(v, nm, torch.int32, (C, P), dev)
    for nm, v in (("in_mon", in_mon), ("init_ok", init_ok),
                  ("first_seg", first_seg)):
        _check(v, nm, torch.bool, (C, P), dev)
    _check(coefs, "coefs", torch.float32, (C, P, B, K), dev)
    for nm, v in (("rmse", rmse), ("vario", vario)):
        _check(v, nm, torch.float32, (C, P, B), dev)
    S = _check_bufs(bufs, C, P, B, dev)
    if dev.type == "cpu":
        return fused_round_plain(
            Yt, X, t, alive, included, cur_k, n_last_fit, in_mon, coefs,
            rmse, vario, init_ok, w_stab, n_ok, first_seg, nseg, bufs,
            change_thr=change_thr, outlier_thr=outlier_thr, sensor=sensor,
            mixed=mixed)
    roles, _keep = band_roles(sensor, B, "fused_round")
    fused_round_geometry(T)             # refuses a T whose block won't fit
    nseg_o = torch.empty_like(nseg)
    coefs_o = torch.empty_like(coefs)
    rmse_o = torch.empty_like(rmse)
    ev = torch.empty(len(_EV_KEYS), C, P, dtype=torch.int32, device=dev)
    incm = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    alm = torch.empty(C, T, P, dtype=torch.bool, device=dev)
    _launch(unit_of("fused_round", mixed), *map(_ptr, (
        Yt, X, t, alive, included, cur_k, n_last_fit, in_mon, coefs, rmse,
        vario, init_ok, w_stab, n_ok, first_seg, nseg, *bufs, nseg_o,
        coefs_o, rmse_o, ev, incm, alm)), roles, C, B, T, P, S,
        float(change_thr), float(outlier_thr))
    d = {k: (ev[i] != 0 if k in _EV_BOOL else ev[i])
         for i, k in enumerate(_EV_KEYS)}
    return bufs, nseg_o, coefs_o, rmse_o, dict(d, included_mon=incm,
                                               alive_mon=alm)


# ---------------------------------------------------------------------------
# detect_mega
# ---------------------------------------------------------------------------

def detect_mega_plain(Yt, phase0, cur_i0, alive0, nseg0, bufs, t, X, Xt,
                      vario, *, W, change_thr, outlier_thr,
                      sensor=LANDSAT_ARD, mixed=False, on_round=None):
    """Plain version of :func:`detect_mega`: the lockstep round loop over
    :func:`init_window_plain` and :func:`fused_round_plain` (with
    round_state.next_state), all pixels of the batch at once, until every
    pixel is DONE or the loop reaches 2T+8 rounds.  A chip's ``rounds``
    counts the rounds in which any of its pixels was not DONE, its
    ``counts`` the rounds in which any of them ran INIT, a fit or a close.
    ``mixed`` runs both with the mixed-precision Gram.
    ``on_round(st, init, ev)``, when given, sees each round's start state,
    INIT outputs and events (``chip_smoke.py`` counts the work with it).
    The buffers are updated in place."""
    C, B, T, P = Yt.shape
    dev = Yt.device
    i32 = torch.int32
    st = dict(phase=phase0, cur_i=cur_i0,
              cur_k=torch.zeros(C, P, dtype=i32, device=dev), alive=alive0,
              included=torch.zeros(C, T, P, dtype=torch.bool, device=dev),
              coefs=torch.zeros(C, P, B, K, dtype=X.dtype, device=dev),
              rmse=torch.ones(C, P, B, dtype=X.dtype, device=dev),
              n_last_fit=torch.ones(C, P, dtype=i32, device=dev),
              first_seg=torch.ones(C, P, dtype=torch.bool, device=dev),
              nseg=nseg0, bufs=bufs)
    rounds = torch.zeros(C, dtype=i32, device=dev)
    counts = torch.zeros(C, 3, dtype=i32, device=dev)
    for _ in range(2 * T + 8):
        active = st["phase"] != PHASE_DONE
        if not bool(active.any()):
            break
        in_init = st["phase"] == PHASE_INIT
        in_mon = st["phase"] == PHASE_MONITOR
        init = (init_window_plain(st["alive"], st["cur_i"], in_init, t, X,
                                  Xt, Yt, vario, W=W, sensor=sensor,
                                  mixed=mixed)
                if bool(in_init.any()) else init_zeros(st))
        bufs, nseg, coefs_n, rmse_n, ev = fused_round_plain(
            Yt, X, t, st["alive"], st["included"], st["cur_k"],
            st["n_last_fit"], in_mon, st["coefs"], st["rmse"], vario,
            init["init_ok"], init["w_stab"], init["n_ok"], st["first_seg"],
            st["nseg"], st["bufs"], change_thr=change_thr,
            outlier_thr=outlier_thr, sensor=sensor, mixed=mixed)
        rounds += active.any(1).to(i32)
        counts += torch.stack([in_init.any(1), ev["do_fit"].any(1),
                               (ev["is_tail"] | ev["is_brk"]).any(1)],
                              1).to(i32)
        if on_round is not None:
            on_round(st, init, ev)
        st = next_state(st, init, ev, coefs_n, rmse_n, nseg, bufs)
    meta, rmse_b, mag, coef = st["bufs"]
    return dict(meta=meta, rmse=rmse_b, mag=mag, coef=coef, nseg=st["nseg"],
                alive=st["alive"], rounds=rounds, counts=counts)


def detect_mega(Yt, phase0, cur_i0, alive0, nseg0, bufs, t, X, Xt, vario, *,
                W, change_thr, outlier_thr, sensor=LANDSAT_ARD, mixed=False):
    """The whole event loop of every pixel in one launch: from the
    prologue's start state, each pixel runs its rounds (INIT, monitor,
    close, refit) until it is DONE or the loop reaches 2T+8 rounds.

    Args:
        Yt: [C,B,T,P] int16 resident spectra.
        phase0, cur_i0, nseg0: [C,P] int32 start state (kernel._prologue).
        alive0: [C,T,P] bool start alive plane.
        bufs: (meta [C,P,S,6], rmse [C,P,S,B], mag [C,P,S,B], coef
            [C,P,S,B,8]) float32 result buffers, holding the prologue's
            rows; updated in place.
        t: [C,T] float32; X: [C,T,8], Xt: [C,T,5] designs; vario: [C,P,B].
        W: bound on the init window's member count (kernel.window_cap);
            past the largest W_MAX_CHOICES instance this raises, as it
            does for a T that :func:`mega_fits` refuses.
        mixed: every fit's mixed-precision Gram (the ``detect_mega_mixed``
            instance).
    Returns:
        pallas_ops.detect_mega's dict in this package's layouts: meta,
        rmse, mag, coef (the buffers), nseg [C,P] int32, alive [C,T,P]
        bool (the final plane), rounds [C] int32 (the most rounds a pixel
        of the chip ran), counts [C,3] int32 (rounds in which some pixel of
        the chip ran INIT / a fit / a close).
    """
    C, B, T, P = Yt.shape
    dev = Yt.device
    _check(Yt, "Yt", torch.int16, (C, B, T, P), dev)
    for nm, v in (("phase0", phase0), ("cur_i0", cur_i0), ("nseg0", nseg0)):
        _check(v, nm, torch.int32, (C, P), dev)
    _check(alive0, "alive0", torch.bool, (C, T, P), dev)
    _check(t, "t", torch.float32, (C, T), dev)
    _check(X, "X", torch.float32, (C, T, K), dev)
    _check(Xt, "Xt", torch.float32, (C, T, NT), dev)
    _check(vario, "vario", torch.float32, (C, P, B), dev)
    S = _check_bufs(bufs, C, P, B, dev)
    if dev.type == "cpu":
        return detect_mega_plain(Yt, phase0, cur_i0, alive0, nseg0, bufs, t,
                                 X, Xt, vario, W=W, change_thr=change_thr,
                                 outlier_thr=outlier_thr, sensor=sensor,
                                 mixed=mixed)
    roles, _keep = band_roles(sensor, B, "detect_mega")
    w_max = _w_instance(W, "detect_mega")
    if not mega_fits(T, W):
        raise ValueError(f"detect_mega does not take T={T} (a block needs "
                         f"{detect_mega_smem_bytes(T)} bytes of shared "
                         f"memory, the card {SMEM_BLOCK_MAX}; at most "
                         f"T={T_MAX})")
    max_rounds = 2 * T + 8
    i32, f32 = torch.int32, torch.float32
    alive = alive0.clone()
    coefs = torch.zeros(C, P, B, K, dtype=f32, device=dev)
    rmse = torch.ones(C, P, B, dtype=f32, device=dev)
    nseg = torch.empty_like(nseg0)
    rounds = torch.zeros(C, dtype=i32, device=dev)
    flags = torch.zeros(C, 3, max_rounds, dtype=i32, device=dev)
    _launch(unit_of("detect_mega", mixed), *map(_ptr, (
        Yt, t, X, Xt, vario, phase0, cur_i0, nseg0, *bufs, alive, coefs,
        rmse, nseg, rounds, flags)), roles, C, B, T, P, S, W, w_max,
        max_rounds, float(change_thr), float(outlier_thr))
    meta, rmse_b, mag, coef = bufs
    return dict(meta=meta, rmse=rmse_b, mag=mag, coef=coef, nseg=nseg,
                alive=alive, rounds=rounds, counts=flags.sum(-1, dtype=i32))


# ---------------------------------------------------------------------------
# ring_remote_copy
# ---------------------------------------------------------------------------

# The most leaves one launch carries (csrc/ring_remote_copy.cu).
RING_MAX_LEAVES = 128
# Each leaf's place in the flat receive buffer is aligned to this many
# bytes; the payload is cut into spans of at most RING_SPAN bytes.
RING_ALIGN = 256
RING_SPAN = 1 << 16
_PEERS: set = set()
_RING_PLANS: dict = {}


@dataclasses.dataclass(eq=False)
class RingPlan:
    """How one payload signature (the leaves' shapes and dtypes, in order)
    lies in a flat receive buffer: ``offsets[k]`` the byte offset of leaf
    ``k`` (a multiple of RING_ALIGN), ``nbytes[k]`` its size, ``total`` the
    buffer's bytes (a multiple of RING_ALIGN), and ``spans`` the copy's
    table [n, 4] int64 of (destination offset, offset in the leaf, bytes,
    leaf): the payload cut into RING_SPAN-byte spans, each inside one leaf.
    ``views`` holds each leaf's (index into ``view_dtypes``, shape, strides,
    element offset) for :func:`ring_views`; ``device_spans`` caches the
    table on each source device."""

    offsets: tuple
    nbytes: tuple
    total: int
    spans: np.ndarray
    view_dtypes: tuple
    views: tuple
    device_spans: dict = dataclasses.field(default_factory=dict)

    def spans_on(self, dev: torch.device) -> torch.Tensor:
        t = self.device_spans.get(dev)
        if t is None:
            t = self.device_spans[dev] = torch.from_numpy(self.spans).to(dev)
        return t


def ring_plan(leaves) -> RingPlan:
    """The :class:`RingPlan` of a payload, built once per signature and
    reused (the ring's hops repeat the same leaves every dispatch)."""
    sig = tuple((t.shape, t.dtype) for t in leaves)
    plan = _RING_PLANS.get(sig)
    if plan is not None:
        return plan
    offsets, sizes, rows, off = [], [], [], 0
    for k, (shape, dtype) in enumerate(sig):
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        offsets.append(off)
        sizes.append(n)
        rows += [(off + b, b, min(RING_SPAN, n - b), k)
                 for b in range(0, n, RING_SPAN)]
        off += -(-n // RING_ALIGN) * RING_ALIGN
    shapes = tuple(tuple(s) for s, _ in sig)
    dtypes = tuple(d for _, d in sig)
    view_dtypes = tuple(dict.fromkeys(dtypes))
    views = tuple(
        (view_dtypes.index(d), shape,
         tuple(int(x) for x in np.cumprod((1,) + shape[:0:-1])[::-1])
         if shape else (), o // d.itemsize)
        for shape, d, o in zip(shapes, dtypes, offsets))
    plan = RingPlan(offsets=tuple(offsets),
                    nbytes=tuple(sizes), total=max(off, RING_ALIGN),
                    spans=np.asarray(rows, dtype=np.int64).reshape(-1, 4),
                    view_dtypes=view_dtypes, views=views)
    _RING_PLANS[sig] = plan
    return plan


def ring_views(buf: torch.Tensor, plan: RingPlan) -> list:
    """The leaves carved out of a flat uint8 buffer of ``plan.total``
    bytes: contiguous views with the leaves' shapes and dtypes, at the
    plan's offsets."""
    typed = [buf.view(d) for d in plan.view_dtypes]
    return [typed[i].as_strided(shape, stride, off)
            for i, shape, stride, off in plan.views]


def _shard_device(leaves, i) -> torch.device:
    if not leaves:
        raise ValueError(f"ring_remote_copy: shard {i} has no tensors")
    dev = leaves[0].device
    for k, t in enumerate(leaves):
        if t.device != dev:
            raise ValueError(f"ring_remote_copy: shard {i} tensor {k} is on "
                             f"{t.device}, the shard's first on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"ring_remote_copy: shard {i} tensor {k} must "
                             f"be contiguous")
    return dev


def ring_remote_copy_plain(payloads, shift):
    """Plain version of :func:`ring_remote_copy`: ``dst.copy_(src)`` for
    each tensor, into a buffer allocated on the receiver's device."""
    n = len(payloads)
    devs = [_shard_device(p, i) for i, p in enumerate(payloads)]
    out = [None] * n
    for i, leaves in enumerate(payloads):
        j = (i + shift) % n
        out[j] = [torch.empty(t.shape, dtype=t.dtype, device=devs[j]).copy_(t)
                  for t in leaves]
    return out


def _enable_peer(device: int, peer: int) -> None:
    """Let ``device`` write into ``peer``'s memory (once per pair); raises
    where the pair has no peer access."""
    if (device, peer) in _PEERS:
        return
    build(("ring_remote_copy",))
    fn = _LIBS["ring_remote_copy"].fb_ring_enable_peer
    fn.argtypes, fn.restype = [_I, _I], ctypes.c_int
    rc = fn(device, peer)
    if rc != 0:
        raise RuntimeError(f"ring_remote_copy: cuda:{device} cannot write "
                           f"to cuda:{peer} (no peer access, CUDA error "
                           f"{rc}); the ring has no other path")
    _PEERS.add((device, peer))


def _ring_launch(leaves, plan, buf, src):
    """One launch copying ``leaves`` into ``buf`` by ``plan``'s spans, on
    the current stream of ``src`` (the current device)."""
    if len(plan.spans):
        srcs = np.fromiter((t.data_ptr() for t in leaves), dtype=np.int64,
                           count=len(leaves))
        _launch("ring_remote_copy", ctypes.c_void_p(srcs.ctypes.data),
                len(leaves), _ptr(plan.spans_on(src)), len(plan.spans),
                _ptr(buf))


def ring_remote_copy(payloads, shift):
    """One hop of the rebalancing ring: every shard sends its payload to
    the shard ``shift`` places along the ring and receives the payload of
    the shard ``shift`` places back — ``lax.ppermute`` with the pairs
    ``(i, (i+shift) % n)``, as the Pallas ``ring_remote_copy`` realizes it
    with remote DMAs.

    Args:
        payloads: one list of contiguous tensors per shard, every tensor
            of a shard on that shard's device (several shards may share a
            device).
        shift: the ring offset (+1 rightward, -1 leftward).
    Returns:
        A list whose entry ``(i+shift) % n`` holds shard ``i``'s tensors,
        copied into new buffers on the receiving shard's device (views of
        one flat buffer a shard, :func:`ring_views`).

    On CUDA shards, one launch per source shard writes every tensor into
    the receiver's buffer, on the source device's current stream; the
    receiver's current stream waits on an event recorded after it.  Across
    two devices the source must have peer access to the receiver, or the
    call raises."""
    n = len(payloads)
    devs = [_shard_device(p, i) for i, p in enumerate(payloads)]
    if all(d.type == "cpu" for d in devs):
        return ring_remote_copy_plain(payloads, shift)
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"ring_remote_copy: shards on {devs}: all on the "
                         f"CPU or all on CUDA devices")
    out, received = [None] * n, []
    for i, leaves in enumerate(payloads):
        j = (i + shift) % n
        src, dst_dev = devs[i], devs[j]
        if len(leaves) > RING_MAX_LEAVES:
            raise ValueError(f"ring_remote_copy: {len(leaves)} tensors in a "
                             f"payload, at most {RING_MAX_LEAVES}")
        if src != dst_dev:
            _enable_peer(src.index, dst_dev.index)
        plan = ring_plan(leaves)
        buf = torch.empty(plan.total, dtype=torch.uint8, device=dst_dev)
        if src == dst_dev and src.index == torch.cuda.current_device():
            # One device: the copy runs on its current stream, in order.
            _ring_launch(leaves, plan, buf, src)
        else:
            recv = torch.cuda.current_stream(dst_dev)
            with torch.cuda.device(src):
                send = torch.cuda.current_stream(src)
                if send != recv:
                    # The receiver's buffer was allocated in its stream
                    # order.
                    ready = torch.cuda.Event()
                    ready.record(recv)
                    send.wait_event(ready)
                _ring_launch(leaves, plan, buf, src)
                if send != recv:
                    done = torch.cuda.Event()
                    done.record(send)
                    recv.wait_event(done)
                    buf.record_stream(send)
        received.append((j, buf, plan))
    # The receive views, carved while the copies run.
    for j, buf, plan in received:
        out[j] = ring_views(buf, plan)
    return out


# The functions the detector's routes call, as kernels (the wrappers above)
# or as their plain versions; kernel.pallas_components builds a route from
# either.
KERNELS = types.SimpleNamespace(lasso_fit=lasso_fit,
                                monitor_chain_scored=monitor_chain_scored,
                                init_window=init_window,
                                fused_fit_close=fused_fit_close,
                                fused_round=fused_round, lasso_cd=lasso_cd,
                                monitor_chain=monitor_chain,
                                tmask_bad=tmask_bad, detect_mega=detect_mega,
                                ring_remote_copy=ring_remote_copy)
PLAIN = types.SimpleNamespace(lasso_fit=lasso_fit_plain,
                              monitor_chain_scored=monitor_chain_scored_plain,
                              init_window=init_window_plain,
                              fused_fit_close=fused_fit_close_plain,
                              fused_round=fused_round_plain,
                              lasso_cd=lasso_cd_plain,
                              monitor_chain=monitor_chain_plain,
                              tmask_bad=tmask_bad_plain,
                              detect_mega=detect_mega_plain,
                              ring_remote_copy=ring_remote_copy_plain)

"""Small batched primitives of the detector, in plain PyTorch.

Layout: per-pixel time planes are ``[C, T, P]`` (chips, time, pixels), the
pixel axis fastest, as the CUDA kernels read them; per-pixel vectors are
``[C, P]``.  The reductions here take the axis they run over as an
argument where a caller needs another.

Each function states the JAX function of ``firebird_tpu/ccd/kernel.py`` it
reproduces.  Arithmetic is float32 throughout, in the order the JAX code
and the CUDA kernels use wherever the order is cheap to fix (sums over the
8 design columns, the 5 Tmask columns and the window slots run left to
right); long sums over time are left to ``torch``.
"""

from __future__ import annotations

import torch

from firebird_tpu_torch.ccd import params


def masked_median(x, m, dim=-1):
    """Median of ``x`` where ``m`` along ``dim`` (numpy's even-count
    average; 0 where nothing is masked in) — kernel._masked_median.

    The JAX version sorts with a min/max network, so a NaN among the
    masked-in values poisons the whole row; ``torch.sort`` would sort it
    last instead.  The row is set to NaN explicitly to keep that contract
    (the Tmask screen relies on it: a non-PD Gram flags nothing)."""
    m = m.expand_as(x)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    s = torch.sort(torch.where(m, x, inf), dim=dim).values
    n = m.sum(dim, keepdim=True)
    lo = torch.gather(s, dim, ((n - 1) // 2).clamp_min(0))
    hi = torch.gather(s, dim, (n // 2).clamp_min(0).clamp_max(x.shape[dim] - 1))
    med = 0.5 * (lo + hi)
    med = torch.where(n > 0, med, torch.zeros_like(med))
    poisoned = (torch.isnan(x) & m).any(dim, keepdim=True)
    med = torch.where(poisoned, torch.full_like(med, float("nan")), med)
    return med.squeeze(dim)


def first_at_or_after(mask, i):
    """First True position ``>= i`` along T of ``mask`` [C,T,P]; ``i``
    [C,P].  Returns (exists [C,P], index [C,P] int64, 0 where none) —
    kernel._first_at_or_after (argmax semantics)."""
    T = mask.shape[1]
    ar = torch.arange(T, device=mask.device)[None, :, None]
    m = mask & (ar >= i[:, None, :])
    big = torch.full_like(ar.expand_as(m), T)
    idx = torch.where(m, ar.expand_as(m), big).amin(1)
    ex = m.any(1)
    return ex, torch.where(ex, idx, torch.zeros_like(idx))


def last_true(mask):
    """Last True position along T of ``mask`` [C,T,P], T-1 where none
    (``T - 1 - argmax(mask[::-1])``)."""
    T = mask.shape[1]
    ar = torch.arange(T, device=mask.device)[None, :, None]
    idx = torch.where(mask, ar.expand_as(mask),
                      torch.full_like(ar.expand_as(mask), -1)).amax(1)
    return torch.where(idx >= 0, idx, torch.full_like(idx, T - 1))


def take_t(v, idx):
    """``v`` [C,T] chip-shared, gathered at per-pixel indices [C,P]."""
    return torch.gather(v, 1, idx.long())


def take_plane(plane, idx):
    """``plane`` [C,T,P] gathered at per-pixel time indices [C,P]."""
    return torch.gather(plane, 1, idx.long()[:, None, :])[:, 0, :]


def dedup_first(cand, same_prev):
    """Keep the first candidate per equal-date group — kernel._dedup_first.

    ``cand`` [C,T,P]; ``same_prev`` [C,T] marks t[k] == t[k-1].  Written
    as a group-first selection: a candidate is kept when no candidate
    precedes it inside its group."""
    T = cand.shape[1]
    ar = torch.arange(T, device=cand.device)[None, :]
    start = torch.where(same_prev, torch.zeros_like(ar), ar).cummax(1).values
    c = cand.to(torch.int32)
    before = torch.cumsum(c, 1, dtype=torch.int32) - c          # [C,T,P]
    before_start = torch.gather(
        before, 1, start[:, :, None].expand_as(before))
    return cand & (before == before_start)


def variogram(Y, usable, t, adjusted=True):
    """[C,P,B] median |successive difference| over usable observations,
    floor 1e-6 — kernel._variogram.

    ``Y`` [C,B,T,P] float, ``usable`` [C,T,P], ``t`` [C,T].  The previous
    usable observation of each step comes from a ``cummax`` over masked
    indices (JAX: an associative last-valid scan).  ``adjusted`` keeps
    only pairs more than VARIOGRAM_GAP_DAYS apart, falling back per pixel
    to the plain pairs when none clears the gap."""
    C, B, T, P = Y.shape
    ar = torch.arange(T, device=Y.device)[None, :, None]
    last = torch.where(usable, ar, torch.full_like(ar, -1)).cummax(1).values
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    prev_f = prev >= 0
    prev_c = prev.clamp_min(0)
    pair_ok = usable & prev_f
    if adjusted:
        tb = t[:, :, None].expand(C, T, P)
        prev_t = torch.where(prev_f, torch.gather(tb, 1, prev_c),
                             torch.zeros_like(tb))
        sel = pair_ok & ((tb - prev_t) > params.VARIOGRAM_GAP_DAYS)
        pair_ok = torch.where(sel.any(1, keepdim=True), sel, pair_ok)
    v = []
    for b in range(B):                      # one band at a time: [C,T,P] sorts
        yb = Y[:, b]
        prev_v = torch.where(prev_f, torch.gather(yb, 1, prev_c),
                             torch.zeros_like(yb))
        v.append(masked_median((yb - prev_v).abs(), pair_ok, dim=1))
    v = torch.stack(v, -1)                                      # [C,P,B]
    m = usable.sum(1)
    return torch.where((m >= 2)[..., None], v.clamp_min(1e-6),
                       torch.ones_like(v))


def coefmask_for(n):
    """[C,P,8] allowed-coefficient mask from observation counts (4/6/8) —
    kernel._coefmask_for."""
    nc = torch.where(n >= params.MAX_COEFS * params.NUM_OBS_FACTOR, 8,
                     torch.where(n >= params.MID_COEFS * params.NUM_OBS_FACTOR,
                                 6, 4))
    ar = torch.arange(params.MAX_COEFS, device=n.device)
    return ar < nc[..., None]


def fdiv(x, s: float):
    """x / s as a true float32 division: dividing by a Python scalar lets
    PyTorch's CUDA path multiply by the reciprocal instead (one ulp off the
    kernels' and the JAX package's division)."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def dot_cols(coefs, Xc):
    """sum_k coefs[..., k] * Xc[..., k], left to right (no fused
    multiply-add), broadcasting the leading axes."""
    acc = coefs[..., 0] * Xc[..., 0]
    for k in range(1, coefs.shape[-1]):
        acc = acc + coefs[..., k] * Xc[..., k]
    return acc


def chol_solve_small(G, c):
    """Solve G x = c for SPD ``G`` [..., n*n] (row-major flat), ``c``
    [..., n]: unrolled Cholesky and two substitutions —
    kernel._chol_solve_small.  A pivot <= 0 (numerically not PD) returns
    NaN for the whole system, as jnp.linalg.cholesky does."""
    n = c.shape[-1]
    tiny = torch.tensor(1e-30, dtype=G.dtype, device=G.device)
    ok = None
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = G[..., i * n + j]
            for q in range(j):
                s = s - L[i][q] * L[j][q]
            if i == j:
                pos = s > 0
                ok = pos if ok is None else ok & pos
                L[i][j] = torch.sqrt(torch.maximum(s, tiny))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = c[..., i]
        for q in range(i):
            s = s - L[i][q] * y[q]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for q in range(i + 1, n):
            s = s - L[q][i] * x[q]
        x[i] = s / L[i][i]
    out = torch.stack(x, -1)
    return torch.where(ok[..., None], out, torch.full_like(out, float("nan")))


def tmask_bad(Xtw, Y2, w, vario2):
    """The Tmask IRLS screen on a compacted window — kernel._tmask_bad.

    ``Xtw`` [..., W, 5] no-trend design rows of the window members, ``Y2``
    [..., 2, W] Tmask-band observations, ``w`` [..., W] 0/1 slot validity,
    ``vario2`` [..., 2].  TMASK_IRLS_ITERS Huber reweightings of a 5x5
    SPD solve (sums over the window run slot by slot, in order), MAD
    sigma; an observation is flagged when its final residual exceeds
    TMASK_CONST x the variogram in either band.  Returns [..., W] bool."""
    k = params.HUBER_K
    nt = Xtw.shape[-1]
    W = Xtw.shape[-2]
    X = [Xtw[..., None, :, c] for c in range(nt)]               # [...,1,W]
    xx = {(i, j): X[i] * X[j] for i in range(nt) for j in range(i + 1)}

    def wsum(a):                      # sum over the window slots, in order
        acc = a[..., 0]
        for s in range(1, W):
            acc = acc + a[..., s]
        return acc

    def solve(wt):                                              # [...,2,W]
        G = [None] * (nt * nt)
        for i in range(nt):
            for j in range(i + 1):
                g = wsum(wt * xx[(i, j)])
                if i == j:
                    g = g + 1e-9
                G[i * nt + j] = g
                G[j * nt + i] = g
        cc = [wsum((Y2 * wt) * X[i]) for i in range(nt)]
        return chol_solve_small(torch.stack(G, -1), torch.stack(cc, -1))

    def pred(beta):                                             # [...,2,nt]
        acc = beta[..., 0:1] * X[0]
        for c in range(1, nt):
            acc = acc + beta[..., c:c + 1] * X[c]
        return acc

    w2 = w[..., None, :].expand_as(Y2).to(Y2.dtype)
    mask = w2 > 0
    beta = solve(w2)
    mad_scale = torch.tensor(0.6745, dtype=Y2.dtype, device=Y2.device)
    floor_s = torch.tensor(1e-6, dtype=Y2.dtype, device=Y2.device)
    floor_a = torch.tensor(1e-12, dtype=Y2.dtype, device=Y2.device)
    for _ in range(params.TMASK_IRLS_ITERS):
        r = Y2 - pred(beta)
        med = masked_median(r, mask)
        mad = masked_median((r - med[..., None]).abs(), mask)
        sigma = torch.maximum(mad / mad_scale, floor_s)
        a = r.abs() / (k * sigma[..., None])
        huber = torch.where(a <= 1.0, torch.ones_like(a),
                            1.0 / torch.maximum(a, floor_a))
        beta = solve(w2 * huber)
    r = (Y2 - pred(beta)).abs()
    bad = (r > params.TMASK_CONST * vario2[..., None]) & mask
    return bad.any(-2)

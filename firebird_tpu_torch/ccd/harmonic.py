"""Harmonic regression primitives (NumPy spec).

These define the exact numerics both CCD implementations must follow.  The
JAX kernel re-implements the same operations with lax control flow; parity
tests compare against these float64 versions.

Design matrix convention (the framework spec — chosen for float32/TPU
conditioning, see kernel docs):

    X = [1, yr, cos(wt), sin(wt), cos(2wt), sin(2wt), cos(3wt), sin(3wt)]

where ``yr = (t - anchor) / 365.25`` (years since the fit window's first
observation) and the harmonic phase uses the absolute ordinal day *modulo
365.25* computed in float64 (mathematically identical to absolute t, but
exact in float32).  Output coefficients are converted to the pyccd
convention: slope per ordinal day, intercept at ordinal day 0
(ccdc/pyccd.py:132-145 stores coefficients and intercept separately).
"""

from __future__ import annotations

import numpy as np

from firebird_tpu_torch.ccd import params


def day_phase(t: np.ndarray) -> np.ndarray:
    """Ordinal days -> phase angle in [0, 2*pi), computed in float64."""
    return params.OMEGA * np.mod(np.asarray(t, dtype=np.float64), 365.25)


def design_matrix(t: np.ndarray, anchor: float, ncoef: int = params.MAX_COEFS) -> np.ndarray:
    """Build the [n, ncoef] harmonic design matrix."""
    t = np.asarray(t, dtype=np.float64)
    ph = day_phase(t)
    yr = (t - anchor) / 365.25
    cols = [np.ones_like(yr), yr,
            np.cos(ph), np.sin(ph),
            np.cos(2 * ph), np.sin(2 * ph),
            np.cos(3 * ph), np.sin(3 * ph)]
    return np.stack(cols[:ncoef], axis=1)


def lasso_cd(X: np.ndarray, y: np.ndarray,
             alpha: float = params.LASSO_ALPHA,
             iters: int = params.LASSO_ITERS) -> np.ndarray:
    """Lasso by cyclic coordinate descent with a fixed iteration count.

    Objective: 1/(2n) ||y - X b||^2 + alpha * sum_{j>=1} |b_j|  (intercept,
    column 0, unpenalized).  Operates on the Gram matrix so the TPU kernel
    can run the identical update from incrementally accumulated G = X'X/n
    and c = X'y/n.
    """
    n, p = X.shape
    G = X.T @ X / n
    c = X.T @ y / n
    return lasso_cd_gram(G, c, alpha=alpha, iters=iters)


def lasso_cd_gram(G: np.ndarray, c: np.ndarray,
                  alpha: float = params.LASSO_ALPHA,
                  iters: int = params.LASSO_ITERS) -> np.ndarray:
    """Coordinate descent on precomputed G = X'X/n, c = X'y/n.

    Update for coordinate j:  rho = c_j - sum_{k != j} G_jk b_k
    b_j = soft(rho, alpha_j) / G_jj   with alpha_0 = 0 (intercept).
    """
    p = G.shape[0]
    b = np.zeros(p, dtype=np.float64)
    diag = np.maximum(np.diag(G), 1e-12)
    for _ in range(iters):
        for j in range(p):
            rho = c[j] - G[j] @ b + diag[j] * b[j]
            if j == 0:
                b[j] = rho / diag[j]
            else:
                b[j] = np.sign(rho) * max(abs(rho) - alpha, 0.0) / diag[j]
    return b


def fit_bands(t: np.ndarray, Y: np.ndarray, ncoef: int, anchor: float,
              alpha: float = params.LASSO_ALPHA) -> tuple[np.ndarray, np.ndarray]:
    """Fit all bands at once.

    Args:
        t: [n] ordinal days of the fit window.
        Y: [nbands, n] observations.
        ncoef: number of design columns (4, 6 or 8).
        anchor: design anchor (ordinal day).  The spec anchors ALL fits of a
            pixel at the series' first observation (a global anchor), so the
            TPU kernel can precompute one design matrix per chip and the
            Lasso operates on identical Gram matrices in both
            implementations.

    Returns:
        (coefs [nbands, MAX_COEFS] zero-padded in the internal
        parametrization, rmse [nbands]).
    """
    X = design_matrix(t, anchor, ncoef)
    nb = Y.shape[0]
    coefs = np.zeros((nb, params.MAX_COEFS), dtype=np.float64)
    rmse = np.zeros(nb, dtype=np.float64)
    for b in range(nb):
        beta = lasso_cd(X, Y[b].astype(np.float64), alpha=alpha)
        coefs[b, :ncoef] = beta
        r = Y[b] - X @ beta
        rmse[b] = np.sqrt(np.mean(r * r))
    return coefs, rmse


def predict(t: np.ndarray, coefs: np.ndarray, anchor: float) -> np.ndarray:
    """Evaluate fitted models at times t.

    Args:
        t: [n] ordinal days.
        coefs: [nbands, MAX_COEFS] internal-parametrization coefficients.
        anchor: the fit window anchor the coefficients were fit with.

    Returns:
        [nbands, n] predictions.
    """
    X = design_matrix(t, anchor, params.MAX_COEFS)
    return coefs @ X.T


def to_pyccd_convention(coefs: np.ndarray, anchor: float) -> tuple[np.ndarray, np.ndarray]:
    """Convert internal coefficients to the pyccd output convention.

    Returns (coefficients [nbands, 7], intercept [nbands]) where
    coefficients[:, 0] is slope per ordinal day, columns 1..6 are the
    annual/semiannual/trimodal cos/sin pairs, and intercept is the value of
    the trend line at ordinal day 0 (absolute-t intercept).
    """
    coefs = np.asarray(coefs)
    slope_per_day = coefs[..., 1] / 365.25
    intercept = coefs[..., 0] - slope_per_day * anchor
    out = np.concatenate([slope_per_day[..., None], coefs[..., 2:]], axis=-1)
    return out, intercept


def irls_huber(X: np.ndarray, y: np.ndarray,
               iters: int = params.TMASK_IRLS_ITERS,
               k: float = params.HUBER_K) -> np.ndarray:
    """Robust linear fit via IRLS with Huber weights, fixed iterations.

    Used by the Tmask screen.  Scale is the MAD-based robust sigma,
    re-estimated each iteration.
    """
    n, p = X.shape
    beta = np.linalg.lstsq(X, y, rcond=None)[0]
    for _ in range(iters):
        r = y - X @ beta
        sigma = np.median(np.abs(r - np.median(r))) / 0.6745
        sigma = max(sigma, 1e-6)
        a = np.abs(r) / (k * sigma)
        w = np.where(a <= 1.0, 1.0, 1.0 / np.maximum(a, 1e-12))
        Xw = X * w[:, None]
        beta = np.linalg.lstsq(Xw.T @ X + 1e-9 * np.eye(p), Xw.T @ y, rcond=None)[0]
    return beta

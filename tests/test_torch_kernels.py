"""The port's three kernel modules against the JAX package, on the CPU.

Each case makes its inputs from a seed with numpy and runs them through
the JAX function (Pallas in interpret mode, or its XLA reference) and
through the port's wrapper with CPU tensors, which runs the plain PyTorch
version.  The kernels themselves are held against these plain versions on
the card by tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import harmonic, kernel, pallas_ops, params
from firebird_tpu.ccd.sensor import LANDSAT_ARD, SENTINEL2
from firebird_tpu_torch.ccd import cuda_ops
from firebird_tpu_torch.ccd import primitives as tprim
from firebird_tpu_torch.ccd.sensor import SENTINEL2 as T_S2

CHANGE_THR, OUTLIER_THR = 11.07, 15.09


@pytest.fixture(autouse=True)
def _clear_pallas_env(monkeypatch):
    # The JAX references must trace their default XLA paths.
    monkeypatch.delenv("FIREBIRD_PALLAS", raising=False)


def _design(rng, T):
    t = np.sort(rng.integers(729000, 730500, T)).astype(np.float64)
    X = harmonic.design_matrix(t, t[0], params.MAX_COEFS).astype(np.float32)
    Xt_full = harmonic.design_matrix(t, t[0], params.TMASK_COEFS + 1)
    Xt = np.concatenate([Xt_full[:, :1], Xt_full[:, 2:]], 1).astype(np.float32)
    return t, X, Xt


def _t(a, dtype=None):
    a = torch.from_numpy(np.ascontiguousarray(a))
    return a if dtype is None else a.to(dtype)


# ---------------------------------------------------------------------------
# lasso_fit
# ---------------------------------------------------------------------------

def _fit_inputs(seed=3, P=141, B=7, T=60):
    rng = np.random.default_rng(seed)
    _, X, _ = _design(rng, T)
    Yi = rng.integers(0, 8000, (P, B, T)).astype(np.int16)
    w = (rng.random((P, T)) < 0.8).astype(np.float32)
    nc = rng.choice([4, 6, 8], P)
    mask = np.arange(8)[None, :] < nc[:, None]
    return X, Yi, w, mask


def _port_fit_args(X, Yi, w, mask):
    return (_t(Yi.transpose(1, 2, 0)[None]), _t(w.T[None]), _t(X[None]),
            _t(mask[None]))


def test_lasso_fit_plain_matches_pallas_fit():
    X, Yi, w, mask = _fit_inputs()
    want_b, want_r = pallas_ops.lasso_fit(
        jnp.asarray(Yi.transpose(1, 2, 0)), jnp.asarray(w), jnp.asarray(X),
        jnp.asarray(mask), with_rmse=True, interpret=True)
    got_b, got_r = cuda_ops.lasso_fit(*_port_fit_args(X, Yi, w, mask))
    # The Gram sums run in another order than the Pallas dot; 50 CD sweeps
    # amplify the f32 ulps (the JAX tests' own fit envelope).
    np.testing.assert_allclose(got_b[0].numpy(), np.asarray(want_b),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got_r[0].numpy(), np.asarray(want_r),
                               rtol=1e-2, atol=1e-2)
    nb, nr = cuda_ops.lasso_fit(*_port_fit_args(X, Yi, w, mask),
                                with_rmse=False)
    np.testing.assert_array_equal(nb.numpy(), got_b.numpy())
    assert not nr.any()


def test_lasso_fit_plain_matches_xla_fit():
    X, Yi, w, mask = _fit_inputs(seed=4)
    want_b, want_r = kernel._fit_lasso(
        jnp.asarray(X), jnp.asarray(Yi, jnp.float32), jnp.asarray(w),
        jnp.asarray(mask))
    got_b, got_r = cuda_ops.lasso_fit(*_port_fit_args(X, Yi, w, mask))
    np.testing.assert_allclose(got_b[0].numpy(), np.asarray(want_b),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got_r[0].numpy(), np.asarray(want_r),
                               rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# monitor_chain_scored
# ---------------------------------------------------------------------------

def _mon_inputs(rng, P=137, T=96, nb=5):
    _, X, _ = _design(rng, T)
    Yd = rng.integers(0, 8000, (nb, T, P)).astype(np.int16)
    coefs = (rng.normal(0, 1, (P, nb, 8)) * 100).astype(np.float32)
    dden = (np.abs(rng.normal(150, 40, (P, nb))) + 1).astype(np.float32)
    alive = rng.random((P, T)) < 0.8
    included = (rng.random((P, T)) < 0.4) & alive
    cur_k = rng.integers(0, T, P).astype(np.int32)
    n_last_fit = rng.integers(1, 40, P).astype(np.int32)
    in_mon = rng.random(P) < 0.7
    return X, Yd, coefs, dden, alive, included, cur_k, n_last_fit, in_mon


def _port_mon_args(X, Yd, coefs, dden, alive, included, cur_k, nlf, in_mon):
    return (_t(Yd[None]), _t(coefs[None]), _t(dden[None]), _t(X[None]),
            _t(alive.T[None]), _t(included.T[None]), _t(cur_k[None]),
            _t(nlf[None]), _t(in_mon[None]))


def _mon_compare(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k][0].numpy()
        if k in ("inc_q", "rem_q"):
            g = g.T
        np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("trial", range(3))
def test_monitor_chain_scored_plain_matches_pallas(trial):
    rng = np.random.default_rng(11 + trial)
    args = _mon_inputs(rng)
    X, Yd, coefs, dden, alive, included, cur_k, nlf, in_mon = args
    want = pallas_ops.monitor_chain_scored(
        jnp.asarray(Yd), jnp.asarray(coefs), jnp.asarray(dden),
        jnp.asarray(X), jnp.asarray(alive), jnp.asarray(included),
        jnp.asarray(cur_k), jnp.asarray(nlf), jnp.asarray(in_mon),
        change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR, interpret=True)
    got = cuda_ops.monitor_chain_scored(
        *_port_mon_args(*args), change_thr=CHANGE_THR,
        outlier_thr=OUTLIER_THR)
    _mon_compare(got, want)


def test_monitor_chain_plain_matches_jnp_chain():
    """The event chain alone on a given score plane, against
    kernel._monitor_chain (argmax defaults and INF sentinels included)."""
    rng = np.random.default_rng(5)
    P, T = 137, 96
    alive = rng.random((P, T)) < 0.8
    s = rng.gamma(2.0, 6.0, (P, T)).astype(np.float32)
    included = (rng.random((P, T)) < 0.4) & alive
    cur_k = rng.integers(0, T, P).astype(np.int32)
    nlf = rng.integers(1, 40, P).astype(np.int32)
    in_mon = rng.random(P) < 0.7
    rank = jnp.cumsum(jnp.asarray(alive), -1) - 1
    want = kernel._monitor_chain(
        jnp.asarray(s), jnp.asarray(alive), jnp.asarray(included), rank,
        jnp.asarray(cur_k), jnp.asarray(nlf), jnp.asarray(in_mon),
        change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)
    got = cuda_ops.monitor_chain_plain(
        _t(s.T[None]), _t(alive.T[None]), _t(included.T[None]),
        _t(cur_k[None]), _t(nlf[None]), _t(in_mon[None]),
        change_thr=CHANGE_THR, outlier_thr=OUTLIER_THR)
    _mon_compare(got, want)


# ---------------------------------------------------------------------------
# init_window and the Tmask screen
# ---------------------------------------------------------------------------

def _init_inputs(seed=17, P=137, B=7, T=96):
    rng = np.random.default_rng(seed)
    t, X, Xt = _design(rng, T)
    Yi = rng.integers(0, 8000, (B, P, T)).astype(np.int16)
    vario = (np.abs(rng.normal(100, 30, (P, B))) + 1).astype(np.float32)
    alive = rng.random((P, T)) < 0.7
    cur_i = rng.integers(0, T // 2, P).astype(np.int32)
    phase = rng.choice([kernel.PHASE_INIT, kernel.PHASE_MONITOR,
                        kernel.PHASE_DONE], P, p=[0.6, 0.2, 0.2]).astype(np.int32)
    return t, X, Xt, Yi, vario, alive, cur_i, phase


def _jax_init(t, X, Xt, Yi, vario, alive, cur_i, phase, W):
    T = t.shape[0]
    Xj = jnp.asarray(X)
    res = dict(X=Xj, Xt=jnp.asarray(Xt), t=jnp.asarray(t, jnp.float32),
               Y=jnp.asarray(Yi.transpose(1, 0, 2), jnp.float32),
               Yt=jnp.asarray(Yi.transpose(0, 2, 1)),
               XX=(Xj[:, :, None] * Xj[:, None, :]).reshape(T, -1),
               vario=jnp.asarray(vario))
    st = dict(alive=jnp.asarray(alive), cur_i=jnp.asarray(cur_i),
              phase=jnp.asarray(phase))
    fit = functools.partial(kernel._fit_chip, fit_pallas=False, on_tpu=False)
    init = jax.jit(functools.partial(kernel._init_block, sensor=LANDSAT_ARD,
                                     W=W, fdtype=jnp.float32, fit=fit,
                                     f32_ok=True))
    return init(res, st)


def _port_init_args(t, X, Xt, Yi, vario, alive, cur_i, phase):
    return (_t(alive.T[None]), _t(cur_i[None]),
            _t((phase == kernel.PHASE_INIT)[None]), _t(t[None], torch.float32),
            _t(X[None]), _t(Xt[None]), _t(Yi.transpose(0, 2, 1)[None]),
            _t(vario[None]))


_INIT_EXACT = ["init_nowin", "init_tm", "has_adv", "i_next_tm", "i_adv", "j",
               "alive_init", "w_stab", "n_ok"]


def _init_compare(got, want, frac):
    assert set(got) == set(want)
    g = {k: v[0].numpy() for k, v in got.items()}
    for k in ("w_stab", "alive_init"):
        g[k] = g[k].T
    for k in _INIT_EXACT:
        np.testing.assert_array_equal(g[k], np.asarray(want[k]), err_msg=k)
    # The stability verdict rests on an f32 fit summed in another order.
    for k in ("init_ok", "init_bad"):
        diff = np.mean(g[k] != np.asarray(want[k]))
        assert diff <= frac, (k, diff)


def test_init_window_plain_matches_xla_init_block():
    inputs = _init_inputs()
    want = _jax_init(*inputs, W=24)
    got = cuda_ops.init_window(*_port_init_args(*inputs), W=24)
    _init_compare(got, want, 0.02)


def test_init_window_plain_matches_pallas_init_window_sentinel2():
    """The 12-band layout at P=16 (detection bands 2, 3, 7, 10, 11, Tmask
    bands 2 and 10), W=16 to keep the W-unrolled Pallas kernel's interpret
    run short; the stability verdicts must agree on every pixel."""
    inputs = _init_inputs(seed=23, P=16, B=12, T=64)
    t, X, Xt, Yi, vario, alive, cur_i, phase = inputs
    want = pallas_ops.init_window(
        jnp.asarray(alive), jnp.asarray(cur_i),
        jnp.asarray(phase == kernel.PHASE_INIT), jnp.asarray(t, jnp.float32),
        jnp.asarray(X), jnp.asarray(Xt), jnp.asarray(Yi.transpose(0, 2, 1)),
        jnp.asarray(vario), W=16, sensor=SENTINEL2, interpret=True)
    got = cuda_ops.init_window(*_port_init_args(*inputs), W=16,
                               sensor=T_S2)
    assert np.asarray(want["init_tm"] | want["init_ok"]
                      | want["init_bad"]).any()
    _init_compare(got, want, 0.0)


@pytest.mark.slow  # the W-unrolled Pallas kernel takes ~60 s in interpret mode
def test_init_window_plain_matches_pallas_init_window():
    inputs = _init_inputs()
    t, X, Xt, Yi, vario, alive, cur_i, phase = inputs
    want = pallas_ops.init_window(
        jnp.asarray(alive), jnp.asarray(cur_i),
        jnp.asarray(phase == kernel.PHASE_INIT), jnp.asarray(t, jnp.float32),
        jnp.asarray(X), jnp.asarray(Xt), jnp.asarray(Yi.transpose(0, 2, 1)),
        jnp.asarray(vario), W=24, sensor=LANDSAT_ARD, interpret=True)
    got = cuda_ops.init_window(*_port_init_args(*inputs), W=24)
    _init_compare(got, want, 0.02)


def _tmask_inputs(seed=9, P=153, W=24, nt=5):
    rng = np.random.default_rng(seed)
    Xtw = rng.normal(0, 1, (P, W, nt)).astype(np.float32)
    Xtw[:, :, 0] = 1.0
    Y2 = (400 + 80 * rng.normal(0, 1, (P, 2, W))).astype(np.float32)
    Y2[rng.random((P, 2, W)) < 0.05] += 900
    nwin = rng.integers(0, W + 1, P)
    w = (np.arange(W)[None, :] < nwin[:, None]).astype(np.float32)
    vario2 = np.abs(rng.normal(40, 10, (P, 2))).astype(np.float32)
    Y2[7] = 444.0                      # constant series -> singular Gram
    return Xtw, Y2, w, vario2


def test_tmask_plain_matches_jnp_tmask():
    """The plain IRLS screen against kernel._tmask_bad, with empty windows
    and a constant series (a non-PD Gram gives NaN betas and flags
    nothing)."""
    Xtw, Y2, w, vario2 = _tmask_inputs()
    want = np.asarray(jax.jit(kernel._tmask_bad)(
        jnp.asarray(Xtw), jnp.asarray(Y2), jnp.asarray(w),
        jnp.asarray(vario2)))
    got = tprim.tmask_bad(_t(Xtw), _t(Y2), _t(w), _t(vario2)).numpy()
    assert want.any() and not want.all()
    assert not got[7].any()
    np.testing.assert_array_equal(got, want)


def test_chol_solve_nan_on_non_pd():
    G = np.eye(5, dtype=np.float32).reshape(1, 25).repeat(2, 0)
    G[1, 0] = 0.0                                   # first pivot 0
    c = np.ones((2, 5), np.float32)
    got = tprim.chol_solve_small(_t(G), _t(c)).numpy()
    want = np.asarray(kernel._chol_solve_small(jnp.asarray(G), jnp.asarray(c)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[0], want[0])
    assert np.isnan(got[1]).all()

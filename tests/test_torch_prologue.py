"""The port's designs, primitives and prologue against the JAX package.

Inputs come from a seed (numpy) or the synthetic source, go through the
JAX function and the port's counterpart (CPU tensors), and are compared
field by field.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firebird_tpu.ccd import kernel as jk
from firebird_tpu.ccd.sensor import LANDSAT_ARD_TINY
from firebird_tpu.ingest import SyntheticSource, pack
from firebird_tpu_torch.ccd import cuda_ops, convert
from firebird_tpu_torch.ccd import kernel as tk
from firebird_tpu_torch.ccd import primitives as tprim
from firebird_tpu_torch.ccd.sensor import LANDSAT_ARD_TINY as T_TINY


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


@pytest.fixture(autouse=True)
def _clear_env(monkeypatch):
    monkeypatch.delenv("FIREBIRD_PALLAS", raising=False)
    monkeypatch.delenv("FIREBIRD_VARIOGRAM", raising=False)


def test_device_designs_match_jax():
    rng = np.random.default_rng(0)
    C, T = 3, 90
    days = np.sort(rng.integers(724000, 737000, (C, T)), 1).astype(np.int32)
    n_obs = np.array([T, 61, 0], np.int32)
    days[1, 61:] = 0
    days[2] = 0
    want = jk.device_designs(jnp.asarray(days), jnp.asarray(n_obs),
                             jnp.float32)
    got = tk.device_designs(_t(days), _t(n_obs))
    X_w, Xt_w, t_w, v_w = (np.asarray(a) for a in want)
    X_g, Xt_g, t_g, v_g = (a.numpy() for a in got)
    np.testing.assert_array_equal(v_g, v_w)
    np.testing.assert_array_equal(t_g, t_w)
    np.testing.assert_array_equal(X_g[..., :2], X_w[..., :2])  # 1 and years
    # Only the trig differs: float32 cos/sin of a bit-identical phase.
    np.testing.assert_allclose(X_g, X_w, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(Xt_g, Xt_w, rtol=1e-6, atol=1e-6)


def test_dedup_first_matches_jax():
    rng = np.random.default_rng(1)
    P, T = 29, 70
    t = np.sort(rng.integers(0, 40, T))
    same_prev = np.concatenate([[False], t[1:] == t[:-1]])
    cand = rng.random((P, T)) < 0.6
    want = np.asarray(jk._dedup_first(jnp.asarray(cand),
                                      jnp.asarray(same_prev)))
    got = tprim.dedup_first(_t(cand.T[None]), _t(same_prev[None]))
    np.testing.assert_array_equal(got[0].numpy().T, want)


@pytest.mark.parametrize("adjusted", [False, True])
def test_variogram_matches_jax(adjusted):
    rng = np.random.default_rng(2)
    P, B, T = 41, 7, 80
    t = np.sort(rng.integers(729000, 730500, T)).astype(np.float32)
    t[10:14] = t[10]                                  # near-coincident pairs
    Y = rng.integers(0, 5000, (P, B, T)).astype(np.float32)
    usable = rng.random((P, T)) < 0.7
    usable[3] = False                                 # no usable obs
    usable[4] = False
    usable[4, 5] = True                               # a single one
    want = np.asarray(jk._variogram(jnp.asarray(Y), jnp.asarray(usable),
                                    t=jnp.asarray(t), adjusted=adjusted))
    got = tprim.variogram(_t(Y.transpose(1, 2, 0)[None]), _t(usable.T[None]),
                          _t(t[None]), adjusted=adjusted)
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("W", [5, 6, 8, 13])
def test_masked_median_matches_jax(W):
    rng = np.random.default_rng(W)
    R = 40
    x = rng.normal(0, 100, (R, W)).astype(np.float32)
    m = rng.random((R, W)) < 0.6
    m[0] = False                                      # empty row -> 0
    m[1] = True                                       # full (even / odd W)
    x[2, 0] = np.nan                                  # NaN masked in
    m[2, 0] = True
    x[3, 1] = np.nan                                  # NaN masked out
    m[3, 1] = False
    want = np.asarray(jk._masked_median(jnp.asarray(x), jnp.asarray(m)))
    got = tprim.masked_median(_t(x), _t(m)).numpy()
    assert np.isnan(got[2]) and np.isnan(want[2]) and got[0] == 0
    np.testing.assert_array_equal(got, want)


def _tiny_chip(seed=7, snow_rows=True):
    src = SyntheticSource(seed=seed, start="1995-01-01", end="1998-06-01",
                          cloud_frac=0.15, sensor=LANDSAT_ARD_TINY)
    p = pack([src.chip(100, 200)], bucket=32)
    if snow_rows:
        qas = p.qas.copy()
        qas[0, :10] = (qas[0, :10] & ~np.uint16(0b110)) | np.uint16(1 << 4)
        qas[0, 10:20, ::3] = 1 << 5                   # mostly cloud
        qas[0, 10:20] = np.where(qas[0, 10:20] == (1 << 5), qas[0, 10:20], 0)
        qas[0, 20, :] = 1                             # all fill -> no data
        p.qas[:] = qas
    return p


def test_prologue_matches_jax():
    p = _tiny_chip()
    days, n_obs, spectra, qa = jk.wire_args(p)
    Xs, Xts, ts, valids = jk.device_designs(jnp.asarray(days),
                                            jnp.asarray(n_obs), jnp.float32)
    fit = functools.partial(jk._fit_chip, fit_pallas=False, on_tpu=False)
    prologue = jax.jit(functools.partial(
        jk._prologue, sensor=LANDSAT_ARD_TINY, S=4, fdtype=jnp.float32,
        fit=fit))
    res_w, st_w = prologue(Xs[0], Xts[0], ts[0], valids[0],
                           jnp.asarray(spectra[0]),
                           jnp.asarray(qa[0], jnp.int32))
    # The port's prologue on the JAX designs (the designs have their own
    # test), so the comparison isolates the prologue.
    Yt = _t(spectra.transpose(0, 1, 3, 2))
    res_g, st_g = tk._prologue(
        _t(np.asarray(Xs)), _t(np.asarray(Xts)), _t(np.asarray(ts)),
        _t(np.asarray(valids)), Yt, _t(qa.transpose(0, 2, 1)).to(torch.int32),
        sensor=T_TINY, S=4, variogram_mode="adjusted", ops=cuda_ops.KERNELS)
    procedure = res_g["procedure"][0].numpy()
    assert {0, 1, 2, 3} <= set(procedure.tolist())    # every procedure runs
    np.testing.assert_array_equal(procedure, np.asarray(res_w["procedure"]))
    for k in ("is_std", "is_alt"):
        np.testing.assert_array_equal(res_g[k][0].numpy(), np.asarray(res_w[k]))
    np.testing.assert_array_equal(res_g["alt_mask"][0].numpy().T,
                                  np.asarray(res_w["alt_mask"]))
    np.testing.assert_array_equal(res_g["vario"][0].numpy(),
                                  np.asarray(res_w["vario"]))
    for k in ("phase", "cur_i", "cur_k", "n_last_fit", "first_seg", "nseg"):
        np.testing.assert_array_equal(st_g[k][0].numpy(), np.asarray(st_w[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(st_g["alive"][0].numpy().T,
                                  np.asarray(st_w["alive"]))
    # The alternate procedures' one-shot fit: meta exact, fit envelope.
    _, st_n = convert.round_state_to_numpy({}, st_g)
    meta_g, rmse_g, _, coef_g = st_n["bufs"]
    meta_w, rmse_w, _, coef_w = (np.asarray(b) for b in st_w["bufs"])
    np.testing.assert_array_equal(meta_g[0], meta_w)
    np.testing.assert_allclose(rmse_g[0], rmse_w, rtol=1e-4, atol=1e-3)
    scale = np.maximum(np.abs(coef_w).reshape(coef_w.shape[0], -1, 8)
                       .max(-1, keepdims=True), 1)
    err = np.abs(coef_g[0] - coef_w).reshape(scale.shape[0], -1, 8) / scale
    assert err.max() <= 1e-4
